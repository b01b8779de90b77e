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
"""
from __future__ import annotations

import argparse
import json
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nyx", type=int, default=512)
    ap.add_argument("--climate", default="1800x3600")
    ap.add_argument("--flash-only", action="store_true",
                    help="run the flash leg alone")
    args = ap.parse_args(argv)
    import torch
    if torch.cuda.device_count() < 2:
        print("sharded_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
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
