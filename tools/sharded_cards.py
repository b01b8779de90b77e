#!/usr/bin/env python3
"""The block-sharded fix loop with its blocks on distinct cards, and the
flash kernel on every card.

    python3 tools/sharded_cards.py            # needs >= 2 CUDA cards
    python3 tools/sharded_cards.py --nyx 128 --climate 180x360
    python3 tools/sharded_cards.py --flash-only

First, on every visible card in turn (cuda:0 staying the current
device), the flash kernel against its plain version on that card, f32
and bf16, causal and not, at a ragged shape and at hymba's 25/5 heads of
64; the output must lie on the inputs' card and each call must count one
launch. Then a 2-layer smollm-135m ``make_prefill`` in f32 on that card
against the CPU on the same weights: last logits and KV cache within
1e-4, one flash launch a layer. ``--flash-only`` stops there.

On the main path's inputs (nyx and climate: f_hat from the Lorenzo
kernel and its inverse, the original's topology) the dense solo loop on
cuda:0 is the reference; then ``fused_fix(mesh=m)`` on a 4-block chain
and a (2, 2) block mesh, overlap off and on, worklist off and on, once
with every block on cuda:0 and once with the blocks spread round robin
over the visible cards (a peer copy for every face between cards). Each
leg must give the solo g bitwise and the solo iteration count, with
extrema = fixpass launches as the plan says and, with the worklist off,
the copied halo bytes = ``halo_plan`` x iterations; its seconds (all
cards synchronized on both sides) and the peak bytes of every card are
recorded. A climate round trip through the spread (2, 2) mesh must give
the solo call's bytes. JSON records on stdout; the last line is
``{"ok": true, ...}``; any disagreement raises.

    python3 tools/sharded_cards.py --ep --ranks 4

``--ep`` and ``--ranks N`` run their legs alone (either or both). ``--ep``:
``layers.moe_ffn_ep`` at chip_smoke's phase-10a shapes (``EP_LAYER``, on
its ``EP_MESHES`` (1, 4) and (2, 4), E 128 top-8 and E 2 top-2), once
with every shard on cuda:0 and once with model shard j of every data row
on cuda:j (the exchanges between shards are peer copies): y and aux
bitwise equal. ``--ranks N``: N processes, a card each, one NCCL group
(``launch.mesh.init_distributed`` on a free localhost port); each rank
draws the same N pods' gradient trees (smollm-135m's parameter shapes,
f32, seeded on its card), all-reduces its own pod's with
``compressed_all_reduce_tree`` (int16 and int8 codes) and must get
``compressed_psum_tree`` over the N trees in one process, bit for bit;
the seconds of each and of an f32 NCCL all-reduce of the same elements,
and the bytes each rank moves.

    python3 tools/sharded_cards.py --train --ranks 4

``--train --ranks N``: chip_smoke's 11b model (smollm-135m at full width,
2 layers, f32, seeded) trained 3 steps by ``make_train_step(mesh=)`` on a
(2, N / 2) ``("data", "model")`` mesh twice: in this process with
position i on cuda:i, then over N processes, a card and a position each,
one NCCL group. Every rank's losses and gathered params go beside the
one-process run's, with the largest difference and whether they are
bitwise equal, and each rank's step seconds. Then chip_smoke's 11e cell
(granite-8b at full width, 8 layers, bf16, 4 x 2048 tokens a step, 3
steps; ``chip_smoke.TP_TRAIN``) on a (1, N) mesh, the tensor-parallel
step: in this process with position i on cuda:i, over N ranks, and on
the 1 x 1 mesh of one card. Each rank's losses and the sha1 of each of
its param shards must equal the one-process run's position's; each
rank's matmul FLOPs of its first step (``FlopCounterMode``) must equal
``train.sharded.step_matmul_flops`` for one position; the step seconds
of all three runs go in the record. Each rank's collectives of its
first step (``distributed.collectives``: count and bytes by kind, the
bytes ``take_model``, ``gather_rows`` and the gradient sums move across
the NCCL ranks) must equal those a dry rank (``launch.mesh.dry_rank``,
on ``meta``) counts at its position of the same cell and mesh. Then the same three runs of
chip_smoke's 11f xLSTM cell (xlstm-1.3b at full width, 8 layers, bf16,
2 x 1024 tokens a step, 3 steps; ``chip_smoke.RECURRENT_TP["xlstm"]``),
whose mLSTM and sLSTM blocks split over the ranks.

    python3 tools/sharded_cards.py --train --ranks 4 --cell qwen3-moe
    python3 tools/sharded_cards.py --train --ranks 4 --cell qwen3-moe \
        --tree build/parent

``--cell qwen3-moe`` runs the MoE rows' cell alone (``MOE_FULL``:
qwen3-moe-235b-a22b at its published widths, 2 layers, bf16, 4 x 2048
tokens a step on (2, N / 2)): the one-process mesh with position i on
cuda:i, then N ranks, which must be bitwise the one-process run; each
rank's matmul FLOPs the reckoning of its position (its row's 2
sequences, every MoE layer routing all 4), each card's peak bytes.
``--tree`` runs another checkout's ``src/`` (ranks too): a parent
unpacked with ``git archive`` under ``build/``, run beside this tree in
one call, gives the parent-against-change numbers (its FLOPs are
recorded, not reckoned, where its ``step_matmul_flops`` lacks the cell).

    python3 tools/sharded_cards.py --train --ep --ranks 4 --cell qwen3-moe

``--ep`` with ``--train --cell qwen3-moe``: the cell under
``layers.MOE_EP_MODE`` with its mesh ambient (``chip_smoke.
expert_parallel``), on (2, N / 2) and on (1, N): each position routes
its row's tokens through its own experts and exchanges them over
``model`` (peer copies in one process, NCCL all-to-alls over the
ranks). Each run records the EP bodies run, the expert leaves built
whole (none), the bytes exchanged a layer (``placement.EXCHANGED``)
beside the rest; the ranks must be bitwise the one-process run and
each rank's FLOPs its position's reckoning
(``step_matmul_flops(..., ep_rows=dp)``). A tree whose ranks refuse EP
(``NotImplementedError``) has the refusal recorded instead of its ranks.

    python3 tools/sharded_cards.py --serve --ranks 4

``--serve --ranks N``: serving at the reference's dry-run partition
(``serve.sharded``) on (1, N) and (2, N / 2): chip_smoke's 11j cell
(granite-8b at its published widths, 4 layers, bf16, 4 x 20,480-token
prompts into a 32,768-position cache, 16 decode steps) and qwen3-moe at
its published widths (2 layers, bf16, under ``MOE_EP_MODE``, a 4 x 2048
prefill, 4 decode steps), each in this process with position i on
cuda:i and over N NCCL ranks; then chip_smoke's 11k whisper-base and
hymba-1.5b cells (``SERVE_FAMILIES``: whisper's encoder memory split over
its frames, hymba's rings over their slots and SSM states over Dh). The
ranks' tokens, last logits and every shard of the serving state must be
the one-process run's, bit for bit, and each position's resident bytes
``specs.shard_bytes`` of the state under ``cache_shardings``, and each
rank's collectives in the prefill and the first decode step (the cache
writes' all-to-alls among them) those of the dry rank at its position;
prefill seconds, decode ms a step and each card's peak bytes are
recorded.
``--cell whisper,hymba`` runs those cells alone.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _timed(fn):
    _sync_all()
    t0 = time.perf_counter()
    out = fn()
    _sync_all()
    return out, time.perf_counter() - t0


#: (B, S, T, H, Hk, Dh) of the flash leg: ragged, S != T, hymba's heads
FLASH_SHAPES = ((2, 130, 130, 9, 3, 64), (2, 80, 200, 6, 2, 32),
                (2, 256, 256, 25, 5, 64))


def flash_leg(cards: int) -> None:
    """The flash kernel and a 2-layer smollm prefill on each card."""
    import dataclasses
    import torch
    from chip_smoke import FLASH_TOL, emit, max_abs_diff, within_flash_tol
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.kernels import flash as kfl
    from repro_torch.models import init_params
    from repro_torch.serve import make_prefill
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2,
                              dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 128)).astype(np.int32))
    want_cache, want_last = make_prefill(cfg, 136)(cpu, {"tokens": prompt})
    gen = torch.Generator().manual_seed(0)
    for i in range(cards):
        dev = torch.device("cuda", i)
        errs = []
        for B, S, T, H, Hk, Dh in FLASH_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                           for shape in ((B, S, H, Dh), (B, T, Hk, Dh),
                                         (B, T, Hk, Dh)))
                for causal in (True, False):
                    before = kfl.launches
                    got = kfl.flash_attention(q, k, v, causal=causal)
                    want = kfl.flash_attention_plain(q, k, v, causal=causal)
                    tag = f"flash cuda:{i} {(B, S, T, H, Hk, Dh)} {dtype}"
                    if kfl.launches != before + 1 or got.device != dev:
                        raise AssertionError(f"{tag}: launches or device")
                    if not within_flash_tol(got, want):
                        raise AssertionError(f"{tag}: differs from the "
                                             "plain version")
                    errs.append(max_abs_diff([got], [want]))
        gpu = params_from_numpy(params_to_numpy(cpu), cfg, dev)
        before = kfl.launches
        cache, last = make_prefill(cfg, 136)(gpu, {"tokens": prompt.to(dev)})
        launches = kfl.launches - before
        if launches != cfg.n_layers:
            raise AssertionError(f"prefill cuda:{i}: {launches} flash "
                                 "launches")
        prefill_err = max_abs_diff([last.cpu(), cache["k"].cpu(),
                                    cache["v"].cpu()],
                                   [want_last, want_cache["k"],
                                    want_cache["v"]])
        for t, w in ((last, want_last), (cache["k"], want_cache["k"]),
                     (cache["v"], want_cache["v"])):
            if not torch.allclose(t.cpu(), w, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"prefill cuda:{i}: differs from the "
                                     f"CPU by {prefill_err}")
        emit({"phase": "flash_cards", "device": str(dev),
              "current_device": torch.cuda.current_device(),
              "kernel_max_abs_err": max(errs), "rtol_atol": FLASH_TOL,
              "prefill_model": cfg.name, "prefill_layers": cfg.n_layers,
              "prefill_flash_launches": launches,
              "prefill_max_abs_err": prefill_err, "tol": 1e-4})
        del gpu, cache, last


def ep_leg(cards: int) -> None:
    """``moe_ffn_ep`` with model shard j on cuda:j against every shard on
    cuda:0: bitwise."""
    import torch
    from chip_smoke import (EP_LAYER, EP_MESHES, emit, ep_inputs, ep_mesh)
    from repro_torch.models import layers
    d, E0, K0, ff, tokens, cf = EP_LAYER
    spread = [f"cuda:{j}" for j in range(min(cards, 4))]
    for E, K in ((E0, K0), (2, 2)):
        x, p = ep_inputs(E, d, ff, tokens, 9 + E)
        x, p = x.cuda(), {k: v.cuda() for k, v in p.items()}
        for shape in EP_MESHES:
            outs, secs, peaks = {}, {}, {}
            for where, devs in (("one_card", ["cuda:0"]), ("spread", spread)):
                for i in range(cards):
                    torch.cuda.reset_peak_memory_stats(i)
                with ep_mesh(shape, devs):
                    outs[where], secs[where] = _timed(
                        lambda: layers.moe_ffn_ep(x, p, E, K, cf))
                peaks[where] = [torch.cuda.max_memory_allocated(i)
                                for i in range(cards)]
            a, b = outs["one_card"], outs["spread"]
            bitwise = bool(torch.equal(a.y, b.y)
                           and torch.equal(a.aux_loss, b.aux_loss))
            if not bitwise:
                raise AssertionError(f"moe_ep E {E} mesh {shape}: cards "
                                     "disagree with one card")
            emit({"phase": "moe_ep_cards", "mesh": list(shape),
                  "experts": E, "top_k": K, "tokens": list(tokens),
                  "capacity_factor": cf, "spread": spread,
                  "bitwise": bitwise, "seconds": secs, "peak_bytes": peaks})


def rank_worker(rank: int, world: int, addr: str) -> int:
    """One rank of ``--ranks``: prints its JSON record."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import (
        compressed_all_reduce_tree, compressed_psum_tree)
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.launch.specs import param_structs
    if not init_distributed(coordinator_address=addr, num_processes=world,
                            process_id=rank, backend="nccl"):
        raise RuntimeError("init_distributed did not start a group")
    dev = torch.device("cuda", torch.cuda.current_device())
    shapes = [tuple(t.shape) for t in
              tree.leaves(param_structs(get_config("smollm-135m")))]

    def note(what):
        print(f"rank {rank}: {what}", file=sys.stderr, flush=True)

    note(f"in the group on {dev}")

    def pod_tree(pod):
        gen = torch.Generator(device=dev).manual_seed(100 + pod)
        return [torch.randn(sh, generator=gen, device=dev) * 1e-2
                for sh in shapes]
    pods = [pod_tree(p) for p in range(world)]
    n = sum(t.numel() for t in pods[0])

    def timed(fn):
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    rec = {"rank": rank, "device": str(dev), "elements": n}
    for bits in (16, 8):
        note(f"int{bits}")
        compressed_all_reduce_tree(pods[rank], bits=bits)       # warm up
        got, secs = timed(lambda: compressed_all_reduce_tree(pods[rank],
                                                             bits=bits))
        want = compressed_psum_tree(pods, bits=bits, device=dev)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        wire = n * bits // 8
        rec[f"int{bits}"] = {
            "bitwise": same, "seconds": secs,
            "collective": "all_gather" if bits == 16 else "all_reduce",
            "bytes_received_per_rank": (world - 1) * wire if bits == 16
            else 2 * (world - 1) * wire // world}
    note("f32")
    flat = torch.cat([t.reshape(-1) for t in pods[rank]])
    dist.all_reduce(flat.clone())
    _, secs = timed(lambda: dist.all_reduce(flat))
    rec["f32_all_reduce"] = {"seconds": secs, "bytes_received_per_rank":
                             2 * (world - 1) * 4 * n // world}
    print(json.dumps(rec), flush=True)
    dist.destroy_process_group()
    return 0 if rec["int16"]["bitwise"] and rec["int8"]["bitwise"] else 1


#: the seed of 11b's weights and batches
TRAIN_SEED = 11


def _train_setup(seed: int):
    """chip_smoke's 11b model, its seeded CPU weights, and its batches."""
    import dataclasses
    import torch
    from chip_smoke import SHARDED_PARITY, _train_inputs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2,
                              dtype="float32")
    k = SHARDED_PARITY
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    batches = [_train_inputs(cfg, k["batch"], k["seq"], i, seed)
               for i in range(k["steps"])]
    return cfg, params, batches


def train_on_mesh(mesh, dev, seed: int) -> dict:
    """3 steps of ``make_train_step(mesh=)`` from 11b's weights: the
    losses, each step's seconds and the gathered params (on the CPU)."""
    import torch
    from chip_smoke import TRAIN_OPT
    from repro_torch import tree
    from repro_torch.distributed import placement
    from repro_torch.launch import specs
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   adamw_init, make_train_step)
    cfg, params, batches = _train_setup(seed)
    params = tree.tree_map(lambda t: t.to(dev), params)
    state = placement.place_tree(
        TrainState(params, adamw_init(params)),
        TrainState(specs.param_shardings(cfg, mesh),
                   specs.opt_state_shardings(cfg, mesh, zero1=True)))
    del params
    step = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**TRAIN_OPT),
                           mesh=mesh)
    count = _counter()
    sync = (lambda: torch.cuda.synchronize(dev)) if mesh.multi_process \
        else _sync_all
    losses, secs, counted = [], [], None
    for b in batches:
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        sync()
        t0 = time.perf_counter()
        count.reset()
        state, m = step(state, b)
        counted = counted or count.stats()
        losses.append(float(m["loss"]))
        sync()
        secs.append(time.perf_counter() - t0)
    whole = placement.gather_tree(state.params)
    return {"losses": losses, "step_seconds": secs, "collectives": counted,
            "params": {k: v.cpu() for k, v in tree.flatten_with_path(whole)}}


class _NoCounter:
    """The tally of a checkout without ``distributed.collectives`` (a
    parent's): nothing counted."""

    @staticmethod
    def reset():
        pass

    @staticmethod
    def stats():
        return None


def _counter():
    """The running package's collectives tally
    (``distributed.collectives``), or ``_NoCounter``."""
    try:
        from repro_torch.distributed import collectives
    except ImportError:
        return _NoCounter
    return collectives


def dry_counts(shape, run) -> list:
    """Each position's collectives as a dry rank counts them
    (``launch.mesh.dry_rank``: the position on ``meta``, nothing
    issued): ``run(mesh)``'s {what: ``collectives.stats()``} at every
    position of a ``("data", "model")`` mesh of ``shape``, in rank
    order."""
    from repro_torch.launch.mesh import dry_rank
    return [run(dry_rank(shape, ("data", "model"), r))
            for r in range(int(np.prod(shape)))]


def dry_train(cfg, batch: dict, ep: bool = False):
    """``dry_counts``' ``run`` of one train step of ``cfg`` on the
    batch's shapes (numpy arrays), the state placed as the cells place
    it, under ``chip_smoke.expert_parallel`` with ``ep``."""
    import torch
    from chip_smoke import TRAIN_OPT, expert_parallel
    from repro_torch.distributed import collectives, placement
    from repro_torch.launch import specs
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   make_train_step)

    def run(mesh):
        state = placement.place_tree(
            TrainState(specs.param_structs(cfg), specs.opt_state_structs(cfg)),
            TrainState(specs.param_shardings(cfg, mesh),
                       specs.opt_state_shardings(cfg, mesh,
                                                 zero1=mesh.size > 1)))
        b = {k: torch.from_numpy(v).to("meta") for k, v in batch.items()}
        step = make_train_step(cfg, TrainStepConfig(),
                               AdamWConfig(**TRAIN_OPT), mesh=mesh)
        with (expert_parallel(mesh) if ep else contextlib.nullcontext()):
            collectives.reset()
            step(state, b)
        return {"step": collectives.stats()}
    return run


def check_counts(tag: str, ranks: list, dry: list) -> None:
    """Raise unless each rank's counted collectives (``ranks[r]``'s
    "collectives", {what: stats}) are its position's dry rank's."""
    for r, (got, want) in enumerate(zip(ranks, dry)):
        if got != want:
            raise AssertionError(f"{tag}: rank {r} counted {got}, its dry "
                                 f"rank {want}")


def count_summary(stats: dict) -> dict:
    """A collectives record cut to the kinds that ran: {kind: [count,
    bytes]} and the total bytes."""
    return {**{k: [v["count"], v["bytes"]] for k, v in stats.items()
               if isinstance(v, dict) and v["count"]},
            "total_bytes": stats["total_bytes"]}


#: the seed of each tensor-parallel cell's weights and batches (11e's,
#: 11f's, 11h's)
TP_SEED = {"tp": 13, "xlstm": 14, "qwen3-moe": 16}

#: the MoE rows' full-width cell: qwen3-moe-235b-a22b at its published
#: widths (d 4096, 64/4 heads of 128, 128 experts top-8, expert d_ff
#: 1536, vocab 151936), 2 of 94 layers (6.2 B parameters), bf16, 3 steps
#: of 4 x 2048 tokens on (2, N / 2): each data row attends its 2
#: sequences and every MoE layer routes all 4
MOE_FULL = dict(arch="qwen3-moe-235b-a22b", n_layers=2, batch=4, seq=2048,
                steps=3)


def tp_cell_of(cell: str) -> dict:
    """The sharded cell ``cell``: "tp" (11e's granite,
    ``chip_smoke.TP_TRAIN``), "xlstm" (11f's,
    ``chip_smoke.RECURRENT_TP``) or "qwen3-moe" (``MOE_FULL``)."""
    from chip_smoke import RECURRENT_TP, TP_TRAIN
    if cell == "qwen3-moe":
        return MOE_FULL
    return TP_TRAIN if cell == "tp" else RECURRENT_TP[cell]


def cell_shape(cell: str, world: int) -> tuple:
    """The mesh of ``cell`` over ``world`` positions: (2, N / 2) for the
    MoE rows, (1, N) for the tensor-parallel cells."""
    return (2, world // 2) if cell == "qwen3-moe" else (1, world)


def tp_on_mesh(mesh, dev, cell: str, ep: bool = False) -> dict:
    """``tp_cell_of(cell)``'s steps on ``mesh`` from weights drawn on
    ``dev`` (with ``ep`` under ``chip_smoke.expert_parallel``): the
    losses, each step's seconds, the matmul FLOPs counted in this
    process over the first step, and the sha1 of every param shard this
    process holds, by position; with ``ep`` the EP bodies run, the
    expert leaves built whole and the bytes exchanged a step and
    layer."""
    import dataclasses
    import hashlib
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from chip_smoke import TRAIN_OPT, _train_inputs, expert_parallel
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import placement
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   make_train_step)
    from repro_torch.train.optimizer import AdamWState
    count = _counter()
    k, seed = tp_cell_of(cell), TP_SEED[cell]
    cfg = dataclasses.replace(get_config(k["arch"]), n_layers=k["n_layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    # the moments placed from zeros that hold no storage: whole f32
    # moments of the MoE cell (50 GB) would not fit the card
    def zeros(p):
        return torch.zeros((), dtype=torch.float32, device=dev).expand(
            p.shape)
    opt = AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                     tree.tree_map(zeros, params),
                     tree.tree_map(zeros, params))
    state = placement.place_tree(
        TrainState(params, opt),
        TrainState(specs.param_shardings(cfg, mesh),
                   specs.opt_state_shardings(cfg, mesh,
                                             zero1=mesh.size > 1)))
    del params, opt
    step = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**TRAIN_OPT),
                           mesh=mesh)
    sync = (lambda: torch.cuda.synchronize(dev)) if mesh.multi_process \
        else _sync_all
    cards = [dev] if mesh.multi_process else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    losses, secs, flops, counted = [], [], None, None
    exchanged = getattr(placement, "EXCHANGED", {})
    exchanged["bytes"] = 0
    with (expert_parallel(mesh) if ep else contextlib.nullcontext()) as seen:
        for i in range(k["steps"]):
            b = {n: torch.from_numpy(v).to(dev) for n, v in
                 _train_inputs(cfg, k["batch"], k["seq"], i, seed).items()}
            sync()
            t0 = time.perf_counter()
            if i == 0:
                count.reset()
                with FlopCounterMode(display=False) as fc:
                    state, m = step(state, b)
                flops = fc.get_total_flops()
                counted = count.stats()
            else:
                state, m = step(state, b)
            losses.append(float(m["loss"]))
            sync()
            secs.append(time.perf_counter() - t0)
    sha = {}
    for s in tree.leaves(state.params):
        for q, t in s.local.items():
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            sha.setdefault(q, []).append(
                hashlib.sha1(t.numpy().tobytes()).hexdigest())
    del state
    torch.cuda.empty_cache()
    out = {"losses": losses, "step_seconds": secs, "matmul_flops": flops,
           "collectives": counted, "shard_sha1": sha,
           "peak_bytes": {str(c): torch.cuda.max_memory_allocated(c)
                          for c in cards}}
    if ep:
        out.update(ep_bodies=seen["bodies"], expert_leaves_built=seen["built"],
                   exchanged_bytes_per_step_layer=exchanged.get("bytes", 0)
                   / k["steps"] / cfg.n_layers)
    return out


def train_rank_worker(rank: int, world: int, addr: str, out: str,
                      cell: str, shape=None, ep: bool = False) -> int:
    """One rank of ``--train --ranks``: saves its run of ``cell``
    ("smollm" on (2, N / 2), "tp" or "xlstm" on (1, N), "qwen3-moe" on
    ``shape``, by default (2, N / 2)) to ``out``."""
    import torch
    from repro_torch.launch.mesh import init_distributed, make_mesh
    if not init_distributed(coordinator_address=addr, num_processes=world,
                            process_id=rank, backend="nccl"):
        raise RuntimeError("init_distributed did not start a group")
    dev = torch.device("cuda", torch.cuda.current_device())
    if cell != "smollm":
        rec = tp_on_mesh(make_mesh(shape or cell_shape(cell, world),
                                   ("data", "model")), dev, cell, ep=ep)
    else:
        rec = train_on_mesh(make_mesh((2, world // 2), ("data", "model")),
                            dev, TRAIN_SEED)
    rec.update(rank=rank, device=str(dev))
    torch.save(rec, out)
    torch.distributed.destroy_process_group()
    return 0


def _checkout() -> Path:
    """The root of the checkout whose ``repro_torch`` this process runs."""
    import repro_torch
    return Path(repro_torch.__file__).resolve().parents[2]


def _spawn(world: int, extra, timeout: float = 600) -> list:
    """``world`` worker processes of this script on a free localhost
    port; returns each one's (exit code, stdout, stderr). Past
    ``timeout`` seconds every rank is stopped and each one's stderr
    tail reported (a rank that fails early leaves the others waiting in
    the rendezvous or a collective)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ranks",
         str(world), "--rank", str(r), "--rendezvous", f"localhost:{port}",
         "--tree", str(_checkout())]
        + extra(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            tails = [f"rank {i} (exit {q.poll()}): "
                     f"{q.communicate()[1][-1500:]}"
                     for i, q in enumerate(procs) if i >= r]
            raise AssertionError(
                f"rank {r} did not finish in {timeout} s; earlier ranks: "
                f"{[(rc, e[-1500:]) for rc, _, e in outs]}; "
                + " | ".join(tails)) from None
        outs.append((p.returncode, out, err))
    for r, (rc, _, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"rank {r} exited {rc}: {err[-3000:]}")
    return outs


def ranks_train_leg(world: int) -> None:
    """``--train --ranks``: the one-process card mesh, then ``world``
    NCCL ranks, a position each."""
    import torch
    from chip_smoke import emit
    from repro_torch.launch.mesh import make_mesh
    if torch.cuda.device_count() < world or world % 2:
        raise AssertionError(f"--train --ranks {world} needs {world} cards "
                             "and an even count")
    mesh = make_mesh((2, world // 2), ("data", "model"),
                     devices=[f"cuda:{i}" for i in range(world)])
    want = train_on_mesh(mesh, torch.device("cuda", 0), TRAIN_SEED)
    work = ROOT / "build" / "train_ranks"
    work.mkdir(parents=True, exist_ok=True)
    _spawn(world, lambda r: ["--train", "--cell", "smollm", "--out",
                             str(work / f"r{r}.pt")])
    cfg, _, batches = _train_setup(TRAIN_SEED)
    dry = (dry_counts(mesh.devices.shape, dry_train(cfg, batches[0]))
           if _checkout() == ROOT else None)
    ranks, counted = [], []
    for r in range(world):
        got = torch.load(work / f"r{r}.pt", weights_only=False)
        counted.append({"step": got["collectives"]})
        err = max(float((got["params"][k] - v).abs().max())
                  for k, v in want["params"].items())
        same = all(torch.equal(got["params"][k], v)
                   for k, v in want["params"].items())
        ranks.append({"rank": r, "device": got["device"],
                      "losses": got["losses"],
                      "max_rel_loss_diff": max(
                          abs(a - b) / abs(b) for a, b in
                          zip(got["losses"], want["losses"])),
                      "param_max_abs_diff": err, "params_bitwise": same,
                      "step_seconds": got["step_seconds"],
                      "collectives": count_summary(got["collectives"])})
    if dry is not None:
        check_counts("smollm train ranks", counted, dry)
    emit({"phase": "sharded_train_ranks", "world": world,
          "collectives_equal_dry_ranks": dry is not None,
          "mesh": mesh.shape, "backend": "nccl",
          "one_process": {"losses": want["losses"],
                          "step_seconds": want["step_seconds"]},
          "ranks": ranks,
          "param_max_abs_diff": max(r["param_max_abs_diff"] for r in ranks),
          "all_bitwise": all(r["params_bitwise"] for r in ranks)})
    for cell in ("tp", "xlstm"):
        tp_ranks_leg(world, work, cell)


def tp_ranks_leg(world: int, work: Path, cell: str, shape=None,
                 ep: bool = False) -> None:
    """A sharded cell (``tp_on_mesh``) on its ``cell_shape`` mesh with
    position i on cuda:i in this process, over ``world`` NCCL ranks,
    and (but for the MoE cell, whose 6.2 B parameters and moments do not
    fit one card) on the 1 x 1 mesh of cuda:0: the ranks bitwise the
    one-process run (losses and every shard's sha1), each rank's FLOPs
    the reckoned count of its own position (where the checkout's
    ``step_matmul_flops`` reckons the cell: a parent's may not), each
    card's peak bytes. ``shape`` overrides the cell's mesh; ``ep`` runs
    it expert-parallel (see the module's docstring)."""
    import dataclasses
    import torch
    from chip_smoke import emit
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.sharding import tp_split
    from repro_torch.train.sharded import step_matmul_flops
    k = tp_cell_of(cell)
    cfg = dataclasses.replace(get_config(k["arch"]), n_layers=k["n_layers"])
    shape = tuple(shape or cell_shape(cell, world))
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[f"cuda:{i}" for i in range(world)])
    tag = f"{cell}{'-ep' if ep else ''}-{shape[0]}x{shape[1]}"
    extra = ["--mesh", f"{shape[0]}x{shape[1]}"] + (["--ep"] if ep else [])
    rec = {"phase": "sharded_train_tp_ranks", "cell": cell, "world": world,
           "model": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           **k, "mesh": mesh.shape, "backend": "nccl", "ep": ep,
           "package": str(_checkout()),
           "tp_split": tp_split(cfg, mesh.shape)}
    other = ep and _checkout() != ROOT      # a parent's EP is recorded
    try:
        one = tp_on_mesh(mesh, torch.device("cuda", 0), cell, ep=ep)
    except Exception as e:                   # noqa: BLE001
        if not other:
            raise
        rec["one_process_failed"] = f"{type(e).__name__}: {str(e)[-400:]}"
        one = None
        torch.cuda.empty_cache()
    if one is not None:
        rec["one_process"] = {n: v for n, v in one.items()
                              if n not in ("shard_sha1", "collectives")}
    try:
        _spawn(world, lambda r: ["--train", "--cell", cell, "--out",
                                 str(work / f"{tag}{r}.pt")] + extra)
    except AssertionError as e:
        if not other:
            raise
        emit({**rec, "ranks_refused": str(e)[-600:]})
        return
    if one is None:
        raise AssertionError(f"{tag}: the ranks ran where one process "
                             f"failed: {rec['one_process_failed']}")
    try:
        kw = (dict(ep_rows=shape[0]) if ep else dict(moe_rows=k["batch"]))
        per_position = [step_matmul_flops(
            cfg, k["batch"] // shape[0], k["seq"], shape[1],
            position=mesh.coords(r)["model"], device="cuda", **kw)
            for r in range(world)]
    except (NotImplementedError, TypeError):    # a parent's reckoning
        per_position = None
    ranks = []
    for r in range(world):
        got = torch.load(work / f"{tag}{r}.pt", weights_only=False)
        same = (got["losses"] == one["losses"]
                and got["shard_sha1"][r] == one["shard_sha1"][r])
        ranks.append({"rank": r, "bitwise": same,
                      **{n: v for n, v in got.items()
                         if n not in ("shard_sha1", "rank")}})
    # the dry ranks of this checkout (a parent's package may lack them)
    dry = None
    if _checkout() == ROOT:
        from chip_smoke import _train_inputs
        dry = dry_counts(shape, dry_train(cfg, _train_inputs(
            cfg, k["batch"], k["seq"], 0, TP_SEED[cell]), ep=ep))
        check_counts(tag, [{"step": r["collectives"]} for r in ranks], dry)
        for r in ranks:
            r["collectives"] = count_summary(r["collectives"])
    host = None
    if cell != "qwen3-moe":
        run = tp_on_mesh(make_host_mesh("cuda:0"), torch.device("cuda", 0),
                         cell)
        host = {n: run[n] for n in ("losses", "step_seconds",
                                    "matmul_flops", "peak_bytes")}
    emit({**rec, "ranks": ranks, "one_card_1x1": host,
          "collectives_equal_dry_ranks": dry is not None,
          "matmul_flops_reckoned_per_position": per_position,
          "all_bitwise": all(r["bitwise"] for r in ranks)})
    if ep and _checkout() == ROOT and (not one["ep_bodies"]
                                       or one["expert_leaves_built"]):
        raise AssertionError(f"EP: {one['ep_bodies']} bodies, expert "
                             f"leaves built whole {one['expert_leaves_built']}")
    if not all(r["bitwise"] for r in ranks):
        raise AssertionError("the ranks' sharded steps are not the "
                             "one-process mesh's")
    if per_position is not None and any(
            r["matmul_flops"] != per_position[r["rank"]] for r in ranks):
        raise AssertionError(f"rank FLOPs {[r['matmul_flops'] for r in ranks]}"
                             f", {per_position} reckoned a position")


#: the seed of each serving cell's weights and prompts (``--serve``)
SERVE_SEED = {"granite": 18, "qwen3-moe": 20, "whisper": 19, "hymba": 19}
#: ``--serve``'s cells, in the order a run takes them
SERVE_CELLS = ("granite", "qwen3-moe", "whisper", "hymba")
#: ``--serve``'s MoE cell: qwen3-moe at its published widths (``MOE_FULL``'s
#: 2 of 94 layers), bf16, under ``MOE_EP_MODE``: a prefill of 4 x 2048
#: (EP engages at 8,192 tokens) into a cache of 2,064 positions, then 4
#: greedy decode steps (the dense dispatch at 4 tokens a step)
SERVE_MOE_FULL = dict(arch="qwen3-moe-235b-a22b", n_layers=2, batch=4,
                      prompt=2048, max_len=2064, steps=4)


def serve_cell_of(cell: str) -> dict:
    """``--serve``'s cells: "granite" (chip_smoke's 11j,
    ``SERVE_SHARDED``), "qwen3-moe" (``SERVE_MOE_FULL``), "whisper" and
    "hymba" (11k's, ``chip_smoke.SERVE_FAMILIES``: whisper-base whole,
    8 x (1,500 frames, 32 tokens) into 448 positions; hymba-1.5b at 4
    layers, 8 x 2048 into 32,768; 16 steps each)."""
    from chip_smoke import SERVE_FAMILIES, SERVE_SHARDED
    return {"granite": SERVE_SHARDED, "qwen3-moe": SERVE_MOE_FULL,
            **SERVE_FAMILIES}[cell]


def serve_cfg(k: dict):
    """A serving cell's config: its arch cut to ``k["n_layers"]`` (None:
    whole)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(k["arch"])
    return dataclasses.replace(cfg, n_layers=k["n_layers"]) \
        if k["n_layers"] else cfg


def serve_on_mesh(mesh, dev, cell: str) -> dict:
    """``serve.sharded``'s prefill and greedy decode steps of
    ``serve_cell_of(cell)`` on ``mesh`` from weights drawn whole on
    ``dev`` (the MoE cell under ``chip_smoke.expert_parallel``): the
    tokens (whole), the sha1 of the prefill's last logits (whole) and of
    each cache shard this process holds, by position; the prefill
    seconds, each step's ms, each card's peak bytes, each position's
    resident cache bytes, and the collectives this process counted
    (``distributed.collectives``) in the prefill and the first decode
    step. Whisper's batch holds seeded frame embeddings
    (``serve_batch``)."""
    import hashlib
    import torch
    from chip_smoke import expert_parallel
    from repro_torch import tree
    from repro_torch.distributed import placement
    from repro_torch.models import init_params
    from repro_torch.serve import sharded as SS
    k, seed = serve_cell_of(cell), SERVE_SEED[cell]
    cfg = serve_cfg(k)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    placed = placement.place_tree(params, SS.serve_param_shardings(cfg,
                                                                   mesh))
    del params
    batch = serve_batch(cell, dev)
    count = _counter()
    sync = (lambda: torch.cuda.synchronize(dev)) if mesh.multi_process \
        else _sync_all
    cards = [dev] if mesh.multi_process else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)

    def sha(t):
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return hashlib.sha1(t.numpy().tobytes()).hexdigest()
    with (expert_parallel(mesh) if cell == "qwen3-moe"
          else contextlib.nullcontext()) as seen:
        sync()
        t0 = time.perf_counter()
        count.reset()
        cache, last = SS.make_sharded_prefill(cfg, mesh, k["max_len"])(
            placed, batch)
        counted = {"prefill": count.stats()}
        sync()
        prefill_s = time.perf_counter() - t0
        tok = SS.sharded_argmax(cfg, last)
        toks, ms = [placement.gather(tok)], []
        step = SS.make_sharded_serve_step(cfg, mesh)
        for i in range(k["steps"]):
            sync()
            t0 = time.perf_counter()
            count.reset()
            tok, _, cache = step(placed, cache, tok, k["prompt"] + i)
            counted.setdefault("decode", count.stats())
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(placement.gather(tok))
    out = {"tokens": torch.cat(toks, 1).cpu(),
           "last_sha1": sha(placement.gather(last)),
           "cache_sha1": {q: [sha(leaf.local[q])
                              for leaf in tree.leaves(cache)]
                          for q in tree.leaves(cache)[0].local},
           "prefill_s": prefill_s, "decode_ms": ms,
           "decode_ms_median": float(np.median(ms)),
           "collectives": counted,
           "resident_cache_bytes": placement.resident_bytes(cache),
           "peak_bytes": {str(c): torch.cuda.max_memory_allocated(c)
                          for c in cards}}
    if seen is not None:
        out.update(ep_bodies=seen["bodies"],
                   expert_leaves_built=seen["built"])
    del cache, placed, last
    torch.cuda.empty_cache()
    return out


def serve_batch(cell: str, dev) -> dict:
    """A serving cell's seeded batch on ``dev``: its prompts, with
    whisper's frame embeddings (``chip_smoke.family_inputs``'s)."""
    import torch
    from chip_smoke import family_inputs
    k, seed = serve_cell_of(cell), SERVE_SEED[cell]
    cfg = serve_cfg(k)
    if cfg.family in ("dense", "moe"):
        rng = np.random.default_rng(seed)
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (k["batch"], k["prompt"])).astype(np.int32))
            .to(dev)}
    with torch.cuda.device(dev):
        prompt, extra = family_inputs(cfg, k["batch"], k["prompt"], seed)
    return {"tokens": prompt.to(dev),
            **{n: v.to(dev) for n, v in extra.items()}}


def dry_serve(cell: str):
    """``dry_counts``' ``run`` of a serving cell: its prefill, and the
    first decode step from the prefill's argmax, on its batch's shapes
    (under ``chip_smoke.expert_parallel`` for the MoE cell)."""
    import torch
    from chip_smoke import expert_parallel
    from repro_torch import tree
    from repro_torch.distributed import collectives, placement
    from repro_torch.launch import specs
    from repro_torch.serve import sharded as SS
    k = serve_cell_of(cell)
    cfg = serve_cfg(k)
    batch = tree.tree_map(lambda t: t.to("meta"),
                          serve_batch(cell, torch.device("cuda", 0)))

    def run(mesh):
        placed = placement.place_tree(specs.param_structs(cfg),
                                      SS.serve_param_shardings(cfg, mesh))
        with (expert_parallel(mesh) if cell == "qwen3-moe"
              else contextlib.nullcontext()):
            collectives.reset()
            cache, last = SS.make_sharded_prefill(cfg, mesh, k["max_len"])(
                placed, batch)
            out = {"prefill": collectives.stats()}
            tok = SS.sharded_argmax(cfg, last)
            collectives.reset()
            SS.make_sharded_serve_step(cfg, mesh)(placed, cache, tok,
                                                  k["prompt"])
            out["decode"] = collectives.stats()
        return out
    return run


def serve_rank_worker(rank: int, world: int, addr: str, out: str,
                      cell: str, shape) -> int:
    """One rank of ``--serve --ranks``: saves its run of ``cell`` on
    ``shape`` to ``out``."""
    import torch
    from repro_torch.launch.mesh import init_distributed, make_mesh
    if not init_distributed(coordinator_address=addr, num_processes=world,
                            process_id=rank, backend="nccl"):
        raise RuntimeError("init_distributed did not start a group")
    dev = torch.device("cuda", torch.cuda.current_device())
    rec = serve_on_mesh(make_mesh(shape, ("data", "model")), dev, cell)
    rec.update(rank=rank, device=str(dev))
    torch.save(rec, out)
    torch.distributed.destroy_process_group()
    return 0


def serve_ranks_leg(world: int, work: Path, cells=SERVE_CELLS) -> None:
    """``--serve --ranks``: each serving cell on (1, N) and (2, N / 2),
    once in this process with position i on cuda:i and once over
    ``world`` NCCL ranks, a card and a position each: every rank's
    tokens, last logits and cache shards bitwise the one-process run's
    (sha1), each position's resident cache bytes ``specs.shard_bytes``
    of the cache under ``cache_shardings``; the prefill seconds, the
    decode ms a step and each card's peak bytes beside them."""
    import torch
    from chip_smoke import emit
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import sharded as SS
    for cell in cells:
        k = serve_cell_of(cell)
        cfg = serve_cfg(k)
        for shape in ((1, world), (2, world // 2)):
            mesh = make_mesh(shape, ("data", "model"),
                             devices=[f"cuda:{i}" for i in range(world)])
            one = serve_on_mesh(mesh, torch.device("cuda", 0), cell)
            tag = f"serve-{cell}-{shape[0]}x{shape[1]}"
            _spawn(world, lambda r: ["--serve", "--cell", cell, "--mesh",
                                     f"{shape[0]}x{shape[1]}", "--out",
                                     str(work / f"{tag}{r}.pt")],
                   timeout=300)
            sshape = SS.serve_shape(k["batch"], k["max_len"])
            want = specs.shard_bytes(specs.cache_structs(cfg, sshape),
                                     specs.cache_shardings(cfg, sshape, mesh))
            got_all = [torch.load(work / f"{tag}{r}.pt", weights_only=False)
                       for r in range(world)]
            dry = None
            if _checkout() == ROOT:
                dry = dry_counts(shape, dry_serve(cell))
                check_counts(tag, [g["collectives"] for g in got_all], dry)
            ranks = []
            for r, got in enumerate(got_all):
                same = (torch.equal(got["tokens"], one["tokens"])
                        and got["last_sha1"] == one["last_sha1"]
                        and got["cache_sha1"][r] == one["cache_sha1"][r])
                ranks.append({"rank": r, "bitwise": same,
                              "device": got["device"],
                              "prefill_s": got["prefill_s"],
                              "decode_ms_median": got["decode_ms_median"],
                              "resident_cache_bytes":
                                  got["resident_cache_bytes"],
                              "collectives": {
                                  n: count_summary(v) for n, v in
                                  (got["collectives"] or {}).items()},
                              "peak_bytes": got["peak_bytes"]})
            rec = {"phase": "sharded_serving_ranks", "cell": cell,
                   "world": world, "model": cfg.name,
                   "n_layers": cfg.n_layers, "dtype": cfg.dtype, **k,
                   "mesh": mesh.shape, "backend": "nccl",
                   "cache_bytes_per_position": want,
                   "one_process": {n: v for n, v in one.items() if n not in
                                   ("tokens", "cache_sha1", "last_sha1",
                                    "collectives")},
                   "collectives_equal_dry_ranks": dry is not None,
                   "ranks": ranks,
                   "all_bitwise": all(r["bitwise"] for r in ranks)}
            emit(rec)
            if not rec["all_bitwise"]:
                raise AssertionError(f"{tag}: the ranks are not the "
                                     "one-process run")
            if any(set(r["resident_cache_bytes"].values()) != {want}
                   for r in ranks) or set(
                       one["resident_cache_bytes"].values()) != {want}:
                raise AssertionError(f"{tag}: resident cache bytes, "
                                     f"{want} by cache_shardings")


def ranks_leg(world: int) -> None:
    """``--ranks``: ``world`` worker processes, one NCCL group."""
    import torch
    from chip_smoke import emit
    if torch.cuda.device_count() < world:
        raise AssertionError(f"--ranks {world} needs {world} cards")
    outs = _spawn(world, lambda r: [])
    recs = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    emit({"phase": "compressed_all_reduce_ranks", "world": world,
          "backend": "nccl", "ranks": recs})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nyx", type=int, default=512)
    ap.add_argument("--climate", default="1800x3600")
    ap.add_argument("--flash-only", action="store_true",
                    help="run the flash leg alone")
    ap.add_argument("--ep", action="store_true",
                    help="run the expert-parallel MoE leg")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run the compressed all-reduce over this many "
                         "processes, a card each")
    ap.add_argument("--train", action="store_true",
                    help="with --ranks: the sharded train step over the "
                         "ranks' (2, N / 2) mesh instead")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cell", default=None,
                    help="with --train --ranks: run this cell alone "
                         "(qwen3-moe: the MoE rows at full width); with "
                         "--serve --ranks: these cells (comma-separated) of "
                         "granite, qwen3-moe, whisper, hymba")
    ap.add_argument("--serve", action="store_true",
                    help="with --ranks: serving at the dry-run partition "
                         "(11j's granite cell, qwen3-moe under EP, 11k's "
                         "whisper and hymba cells)")
    ap.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=None,
                    help="run the package of another checkout (its src/), "
                         "such as a parent unpacked under build/")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.tree or ROOT).resolve() / "src"))
    if args.rank is not None:
        if args.serve:
            shape = tuple(int(n) for n in args.mesh.split("x"))
            return serve_rank_worker(args.rank, args.ranks, args.rendezvous,
                                     args.out, args.cell, shape)
        if args.train:
            shape = (tuple(int(n) for n in args.mesh.split("x"))
                     if args.mesh else None)
            return train_rank_worker(args.rank, args.ranks, args.rendezvous,
                                     args.out, args.cell or "smollm", shape,
                                     args.ep)
        return rank_worker(args.rank, args.ranks, args.rendezvous)
    if torch.cuda.device_count() < 2:
        print("sharded_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    from chip_smoke import (COUNTERS, SHARDED_LEGS, emit, read_launches,
                            reset_launches, same_artifact,
                            sharded_launch_bound)
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_preserving_mss, szlike)
    from repro_torch.core import fixes
    from repro_torch.core.backend import CudaBackend
    from repro_torch.data import synthetic_field
    from repro_torch.distributed import shardfix as sf
    from repro_torch.kernels import _build
    from repro_torch.kernels import lorenzo as kl
    from repro_torch.launch.mesh import make_block_mesh, make_data_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    cards = torch.cuda.device_count()
    if args.ep or args.ranks:
        emit({"phase": "cards", "count": cards, "smi": smi})
        if args.serve:
            _build.build_all(("flash",))
        cell_ep = args.ep and args.train and args.cell
        if args.ep and not cell_ep:
            ep_leg(cards)
        if args.ranks and args.serve:
            work = ROOT / "build" / "serve_ranks"
            work.mkdir(parents=True, exist_ok=True)
            serve_ranks_leg(args.ranks, work, *(
                [tuple(args.cell.split(","))] if args.cell else []))
        elif args.ranks and args.train and args.cell:
            work = ROOT / "build" / "train_ranks"
            work.mkdir(parents=True, exist_ok=True)
            w = args.ranks
            for shape in ([(2, w // 2), (1, w)] if cell_ep else [None]):
                tp_ranks_leg(w, work, args.cell, shape, ep=bool(cell_ep))
        elif args.ranks:
            (ranks_train_leg if args.train else ranks_leg)(args.ranks)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}), flush=True)
        return 0
    emit({"phase": "cards", "count": cards, "smi": smi,
          "build_s": _build.build_all(("extrema", "fixpass", "lorenzo",
                                       "pack", "flash"))})
    flash_leg(cards)
    if args.flash_only:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}), flush=True)
        return 0
    spread = [f"cuda:{i % cards}" for i in range(4)]
    placements = {"one_card": ["cuda:0"] * 4, "spread": spread}
    climate_shape = tuple(int(s) for s in args.climate.split("x"))
    for label, shape in (("nyx", (args.nyx,) * 3),
                         ("climate", climate_shape)):
        f_np = synthetic_field(label, shape)
        xi = 1e-3 * float(np.ptp(f_np))
        f = torch.from_numpy(f_np).cuda()
        step = torch.tensor(szlike.effective_step(f_np, xi), dtype=f.dtype,
                            device="cuda")
        f_hat = szlike.sz_inverse(kl.lorenzo_quant(f, step), step)
        topo = fixes.field_topology(f, xi)
        (g_ref, it_ref, _), t_solo = _timed(lambda: fixes.fused_fix(
            f_hat, topo, backend=CudaBackend(worklist=False)))
        legs = []
        for where, devs in placements.items():
            for name, mshape, overlap, worklist in SHARDED_LEGS:
                mesh = (make_data_mesh(4, devices=devs)
                        if isinstance(mshape, int)
                        else make_block_mesh(mshape, devices=devs))
                be = sf.ShardedBackend(mesh=mesh, overlap=overlap,
                                       worklist=worklist)
                plan = sf.plan_blocks(shape, mesh)
                ov, wl = sf._resolve_modes(plan, overlap, worklist)
                for i in range(cards):
                    torch.cuda.reset_peak_memory_stats(i)
                reset_launches()
                sf.reset_halo_bytes()
                (g, iters, ok), secs = _timed(lambda: fixes.fused_fix(
                    f_hat, topo, backend=be))
                launches = read_launches()
                tag = f"{label} {where} {name} overlap={ov} worklist={wl}"
                if not (ok and iters == it_ref and torch.equal(g, g_ref)):
                    raise AssertionError(f"{tag}: g or iterations differ "
                                         "from the solo loop")
                most = 4 * iters * sharded_launch_bound(plan, ov)
                ext = launches["extrema"]
                if ext != launches["fixpass"] or (
                        ext != most if not wl else ext > most):
                    raise AssertionError(f"{tag}: launches {launches}")
                want = {k: v * iters for k, v in sf.halo_plan(
                    shape, np.float32, mesh, overlap=ov,
                    worklist=wl).items()}
                if not wl and sf.halo_bytes != want:
                    raise AssertionError(f"{tag}: halo bytes "
                                         f"{sf.halo_bytes} != {want}")
                legs.append(dict(
                    placement=where, devices=devs, mesh=name,
                    overlap=ov, worklist=wl, iters=iters, seconds=secs,
                    extrema=ext, halo_bytes=dict(sf.halo_bytes),
                    peak_bytes=[torch.cuda.max_memory_allocated(i)
                                for i in range(cards)], g_identical=True))
                del g
        emit({"phase": "sharded_cards", "field": label, "shape": list(shape),
              "iters": it_ref, "solo_dense_seconds": t_solo, "legs": legs})
        del f, f_hat, topo, g_ref
        torch.cuda.empty_cache()

    f_np = synthetic_field("climate", climate_shape)
    xi = 1e-3 * float(np.ptp(f_np))
    mesh = make_block_mesh((2, 2), devices=spread)
    for entropy in ("deflate", "device-pack"):
        solo = compress_preserving_mss(f_np, xi, entropy=entropy)
        reset_launches()
        art, secs = _timed(lambda: compress_preserving_mss(
            f_np, xi, entropy=entropy, mesh=mesh))
        launches = read_launches()
        g = decompress_preserving_mss(art, mesh=mesh)
        if not (same_artifact(art, solo) and np.array_equal(
                g, decompress_preserving_mss(solo))):
            raise AssertionError(f"climate {entropy} on {spread}: artifact "
                                 "or g differs from the solo call")
        emit({"phase": "sharded_cards_round_trip", "entropy": entropy,
              "devices": spread, "seconds_compress": secs,
              "launches": {k: launches[k] for k in COUNTERS},
              "artifacts_identical": True, "g_identical": True})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
