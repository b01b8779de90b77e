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
of all three runs go in the record.
"""
from __future__ import annotations

import argparse
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
    sync = (lambda: torch.cuda.synchronize(dev)) if mesh.multi_process \
        else _sync_all
    losses, secs = [], []
    for b in batches:
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        sync()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        sync()
        secs.append(time.perf_counter() - t0)
    whole = placement.gather_tree(state.params)
    return {"losses": losses, "step_seconds": secs,
            "params": {k: v.cpu() for k, v in tree.flatten_with_path(whole)}}


#: the seed of the tensor-parallel cell's weights and batches (11e's)
TP_SEED = 13


def tp_on_mesh(mesh, dev, seed: int) -> dict:
    """``chip_smoke.TP_TRAIN``'s steps on ``mesh`` from weights drawn on
    ``dev``: the losses, each step's seconds, the matmul FLOPs counted
    in this process over the first step, and the sha1 of every param
    shard this process holds, by position."""
    import dataclasses
    import hashlib
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from chip_smoke import TP_TRAIN, TRAIN_OPT, _train_inputs
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import placement
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   adamw_init, make_train_step)
    k = TP_TRAIN
    cfg = dataclasses.replace(get_config(k["arch"]), n_layers=k["n_layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    state = placement.place_tree(
        TrainState(params, adamw_init(params)),
        TrainState(specs.param_shardings(cfg, mesh),
                   specs.opt_state_shardings(cfg, mesh,
                                             zero1=mesh.size > 1)))
    del params
    step = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**TRAIN_OPT),
                           mesh=mesh)
    sync = (lambda: torch.cuda.synchronize(dev)) if mesh.multi_process \
        else _sync_all
    losses, secs, flops = [], [], None
    for i in range(k["steps"]):
        b = {n: torch.from_numpy(v).to(dev) for n, v in
             _train_inputs(cfg, k["batch"], k["seq"], i, seed).items()}
        sync()
        t0 = time.perf_counter()
        if i == 0:
            with FlopCounterMode(display=False) as fc:
                state, m = step(state, b)
            flops = fc.get_total_flops()
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
    return {"losses": losses, "step_seconds": secs, "matmul_flops": flops,
            "shard_sha1": sha}


def train_rank_worker(rank: int, world: int, addr: str, out: str,
                      cell: str) -> int:
    """One rank of ``--train --ranks``: saves its run of ``cell``
    ("smollm" on (2, N / 2), "tp" on (1, N)) to ``out``."""
    import torch
    from repro_torch.launch.mesh import init_distributed, make_mesh
    if not init_distributed(coordinator_address=addr, num_processes=world,
                            process_id=rank, backend="nccl"):
        raise RuntimeError("init_distributed did not start a group")
    dev = torch.device("cuda", torch.cuda.current_device())
    if cell == "tp":
        rec = tp_on_mesh(make_mesh((1, world), ("data", "model")), dev,
                         TP_SEED)
    else:
        rec = train_on_mesh(make_mesh((2, world // 2), ("data", "model")),
                            dev, TRAIN_SEED)
    rec.update(rank=rank, device=str(dev))
    torch.save(rec, out)
    torch.distributed.destroy_process_group()
    return 0


def _spawn(world: int, extra) -> list:
    """``world`` worker processes of this script on a free localhost
    port; returns each one's (exit code, stdout, stderr)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ranks",
         str(world), "--rank", str(r), "--rendezvous", f"localhost:{port}"]
        + extra(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    deadline = time.monotonic() + 600
    outs = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            raise AssertionError(f"rank {r} did not finish in 600 s; its "
                                 f"stderr: {err[-3000:]}") from None
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
    ranks = []
    for r in range(world):
        got = torch.load(work / f"r{r}.pt", weights_only=False)
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
                      "step_seconds": got["step_seconds"]})
    emit({"phase": "sharded_train_ranks", "world": world,
          "mesh": mesh.shape, "backend": "nccl",
          "one_process": {"losses": want["losses"],
                          "step_seconds": want["step_seconds"]},
          "ranks": ranks,
          "param_max_abs_diff": max(r["param_max_abs_diff"] for r in ranks),
          "all_bitwise": all(r["params_bitwise"] for r in ranks)})
    tp_ranks_leg(world, work)


def tp_ranks_leg(world: int, work: Path) -> None:
    """The tensor-parallel cell (``tp_on_mesh``) on a (1, ``world``) mesh
    with position i on cuda:i in this process, over ``world`` NCCL
    ranks, and on the 1 x 1 mesh of cuda:0: the ranks bitwise the
    one-process run (losses and every shard's sha1), each rank's FLOPs
    the reckoned count of one position."""
    import dataclasses
    import torch
    from chip_smoke import TP_TRAIN, emit
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.sharding import tp_split
    from repro_torch.train.sharded import step_matmul_flops
    k = TP_TRAIN
    cfg = dataclasses.replace(get_config(k["arch"]), n_layers=k["n_layers"])
    mesh = make_mesh((1, world), ("data", "model"),
                     devices=[f"cuda:{i}" for i in range(world)])
    one = tp_on_mesh(mesh, torch.device("cuda", 0), TP_SEED)
    _spawn(world, lambda r: ["--train", "--cell", "tp", "--out",
                             str(work / f"tp{r}.pt")])
    per_position = step_matmul_flops(cfg, k["batch"], k["seq"], world,
                                     device="cuda")
    ranks = []
    for r in range(world):
        got = torch.load(work / f"tp{r}.pt", weights_only=False)
        same = (got["losses"] == one["losses"]
                and got["shard_sha1"][r] == one["shard_sha1"][r])
        ranks.append({"rank": r, "device": got["device"],
                      "losses": got["losses"], "bitwise": same,
                      "matmul_flops": got["matmul_flops"],
                      "step_seconds": got["step_seconds"]})
    host = tp_on_mesh(make_host_mesh("cuda:0"), torch.device("cuda", 0),
                      TP_SEED)
    emit({"phase": "sharded_train_tp_ranks", "world": world,
          "model": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          **k, "mesh": mesh.shape, "backend": "nccl",
          "tp_split": tp_split(cfg, mesh.shape),
          "one_process": {"losses": one["losses"],
                          "step_seconds": one["step_seconds"],
                          "matmul_flops": one["matmul_flops"]},
          "ranks": ranks, "one_card_1x1": {
              "losses": host["losses"], "step_seconds": host["step_seconds"],
              "matmul_flops": host["matmul_flops"]},
          "matmul_flops_reckoned_per_position": per_position,
          "all_bitwise": all(r["bitwise"] for r in ranks)})
    if not all(r["bitwise"] for r in ranks):
        raise AssertionError("the ranks' tensor-parallel steps are not the "
                             "one-process mesh's")
    if any(r["matmul_flops"] != per_position for r in ranks):
        raise AssertionError(f"rank FLOPs {[r['matmul_flops'] for r in ranks]}"
                             f", {per_position} reckoned a position")


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
    ap.add_argument("--cell", default="smollm", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    if args.rank is not None:
        if args.train:
            return train_rank_worker(args.rank, args.ranks, args.rendezvous,
                                     args.out, args.cell)
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
        if args.ep:
            ep_leg(cards)
        if args.ranks:
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
