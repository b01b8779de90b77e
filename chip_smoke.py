#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each asserting (any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit; the matmul precision flags
   (TF32 off, bf16 GEMMs reduce in f32); build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a) into ``build/``,
   one nvcc per source, all at once; count the tensor-core (HMMA)
   instructions of the flash library's bf16 variants with ``cuobjdump``
   (none fails the run) beside ptxas's registers and spills.
2. kernels against their plain PyTorch versions on the card: 2D and 3D,
   float32 and float64, ragged shapes, a tie-heavy field and a tile with
   a non-zero origin, all bitwise; the fix pass on dense adversarial
   inputs (every pull direction busy, degenerate planes, shapes off its
   tile, tiles at a non-zero origin); the extrema and Lorenzo kernels
   over the same shapes and tiles on constant, quarter-rounded and
   random fields, on inputs one element off a 16-byte boundary (their
   one-vertex path), and Lorenzo at the device path's range limit; the
   pack/unpack kernels on adversarial code arrays, 10^6 full-range
   random codes, 2^17 chunks of widths 0, 1, 31 and 32 (many waves of
   blocks through the look-back), one chunk, one code, n one off a
   multiple of 1024, codes and words one element off a 16-byte
   boundary, and the four bad streams, each of which must raise
   ValueError with the card decoding a good stream after it; then each
   kernel at the main-path shapes (its inputs taken from the real first
   fix iteration, the real residual codes and their packed stream),
   compared bitwise and timed with CUDA events beside its plain version
   (pack and unpack also as the kernel entry alone, launched back to
   back, and every timed call checked bitwise against the first). The
   flash
   kernel against its plain version in f32 and bf16, causal and not,
   ragged S, S != T, head widths 16..128 and the head layouts of
   qwen3-moe (64/4 of 128) and llava (56/8 of 128), and whisper's
   cross-attention layout at a ragged S (33 against T 1500, non-causal),
   within a stated tolerance (bf16: one ulp, rtol 2^-7); (2c) in f32 and
   bf16 at every shape phase 7 gives it, taken from ``LM_FAMILIES``
   (whisper's encoder 8 x 1500 x 1500, decoder 8 x 32 causal and
   cross-attention S 32 and 1 against T 1500; the qwen3-moe and llava
   4 x 2048 prefills; hymba's global layers, 8 x 2048 with 25/5 heads of
   64); (2b) then at the prefill
   shapes (8 x 2048 and 1 x 32768 of smollm-135m's 9/3 heads of 64), at
   granite-8b's heads of 128 (2 x 4096), at the 4 x 2048 prefills of
   qwen3-moe and llava and at hymba's 8 x 2048 (25/5 heads of 64),
   timed beside its plain version and
   ``scaled_dot_product_attention`` (timed only; the port never calls
   it), whose bf16 rounding of p must fail that tolerance at the prefill
   shapes.
3. the main path at full size: ``compress_preserving_mss`` ->
   ``decompress_preserving_mss`` -> ``verify_preservation`` on the nyx
   512^3 float32 field and the climate 1800x3600 field, once with
   ``entropy="deflate"`` and once with ``entropy="device-pack"``, with
   the launch counts set to 0 just before each run and read just after.
   The fix loop takes the dirty-slab worklist there (>= 64 slabs): one
   extrema and one fix-pass launch a span of running slab groups, so
   extrema = fixpass = the loop's span count, between the iteration
   count and iterations x groups.
3b. fix-loop strategies on the main path's inputs at both sizes: the
   dense loop, the "auto" worklist (through ``fused_fix`` and through
   ``fused_fix_worklist``), ``cuda_worklist`` (groups of 4) and
   ``cuda_tiled`` (tiles of 8, worklist off) give the same g bitwise
   and the same iterations; each timed, its launches and skipped slabs
   counted.
3s. the block-sharded fix loop (``mesh=``) on one card, every block on
   cuda:0: (a) on the main path's nyx 512^3 and climate inputs,
   ``fused_fix(mesh=m)`` on a 4-block slab chain and a (2, 2) block
   mesh, overlap off and on, worklist off and on: g bitwise the dense
   loop's, the same iterations, extrema = fixpass = block-iterations
   (x (1 + 2 x sharded axes) under the overlap schedule's interior pass
   and shells; exactly that with the worklist off, at most with it on),
   copied halo bytes = ``halo_plan`` x iterations with the worklist
   off, seconds beside the dense loop's and the peak bytes, and the
   overlap schedule's parts (``time_step_parts``); after 3c, (b) climate
   round trips on the (2, 2) mesh under both codecs, payloads equal to
   the main path's solo artifacts, g the solo decode, preserved, 4
   Lorenzo launches a compress; (c) a (2, 1, 2) mesh (``data_x`` = 2) on
   nyx 128^3 and 130x127x129, artifacts equal to the solo ones; (d) a
   ``CompressionService`` over the (2, 2) mesh on 4 climate timesteps,
   artifacts equal to 3c's solo ones, shard halo bytes = ``halo_plan`` x
   each member's iterations, ``shard_timings``; (e) the launcher with
   ``--devices 4`` on the one card (blocks round robin); (f) with two or
   more cards, the (2, 2) mesh on distinct cards (otherwise a record
   that it did not run).
3c. batches: ``compress_preserving_mss_batch`` of 8 climate timesteps
   (seeds 3-10) under both codecs and of 4 nyx 128^3 members with one
   bound each (so they converge at different iterations); every artifact
   byte-identical to its solo call, ``decompress_artifact_batch``
   bitwise the solo decode, ``verify_preservation_batch`` preserved and
   in bound; the nyx members also through ``derive_edits_batch`` under
   "compact" (every 2) and "fused", bitwise the solo ``derive_edits``.
   Launches counted from 0 around each batch call.
3d. the host path: ``device_path=False`` on climate (f32) and nyx 128^3
   (f64) gives the device path's bytes; climate x 1e6 in f64 with xi
   1e-3 (outside the int32 device range) takes the host path under
   "auto" and decodes with its MSS preserved.
3e. zfplike (``codec="zfplike"``) round trips on climate 1800x3600 in
   f32 and f64 and nyx 256^3 (cut from 512^3 for time): the host ZFJ2
   codec, the fix loop on the card (extrema = fixpass = worklist spans,
   lorenzo = pack = 0), the host MSE1 encode, each stage timed; MSS
   preserved and bound held; at 64^3 the ``cuda`` and ``reference``
   backends give the same artifact bytes.
3f. paper mode (``mode="paper"``) round trips on nyx 128^3 and climate
   1800x3600: no kernel launch, MSS preserved; the paper loop timed
   beside the fused loop on the same (f, f_hat); ``derive_edits(mode=
   "paper")`` gives the same g and iterations on the card and on the CPU
   at 32^3 and 60x70.
3g. the service: one ``CompressionService(window=8, max_batch=4)`` takes
   the 8 climate timesteps under deflate, then under device-pack, the 4
   nyx 128^3 members with their bounds and 2 zfplike climate requests,
   then decompresses every artifact; each artifact byte-identical to its
   solo call and each g to the solo decode; the stream's wall time
   beside the solo loop's, its stats, the calibration record and the
   launches of each kernel (each MSS kernel at least once).
3h. the launcher: ``repro_torch.launch.serve.main(["--smoke"])`` and
   ``["--fields", "16", "--shape", "128,128,128", "--verify"]``.
3i. the guards: a device-pack stream batch under ``MSZ_SANITIZERS=1``
   completes with the solo bytes; the pipelined device stage under
   ``no_transfers`` completes with its audited crossings counted; an
   untracked ``.item()`` and ``torch.tensor(..., device="cuda")`` raise
   inside the guard; another thread's d2h during it does not.
4. whole-path parity at 128^3: the ``cuda`` and ``reference`` backends on
   the card give the same payload bytes, fix-iteration count and g, for
   both entropy codecs; the host codecs agree with the device path; the
   device unpack decodes what the host decoder and the DEFLATE artifact
   decode; both codecs carry the same edit bytes.
5. LM serving at full width: smollm-135m (30 layers, bf16, seeded random
   weights), 8 requests of 2048-token prompts through
   ``serve.make_prefill`` and 32 greedy ``make_serve_step`` calls, with
   the launch counts set to 0 just before and read just after: the flash
   kernel runs once per layer of the prefill, no other kernel runs.
6. LM parity, card against CPU: smollm-135m at 2 layers in f32, the same
   weights on both; prefill and 8 decode steps agree within 1e-4 and
   give the same greedy tokens.
7. The other transformer families at their published widths, bf16,
   seeded random weights, through ``make_prefill`` and 16 (whisper: 32)
   ``make_serve_step`` calls, the launch counts set to 0 just before
   each model and read just after: qwen3-moe-235b-a22b (8 of 94 layers,
   4 x 2048-token prompts; 8 flash launches), gemma2-9b (all 42 layers,
   2 x 8192 tokens, past its 4096 window; 0: the softcap sends its
   attention to the chunked torch path), llava-next-34b (8 of 60
   layers, 4 x (576 image embeddings + 1472 tokens); 8) and whisper-base
   (8 x 1500 frame embeddings, 32-token decoder prompts; 18 in the
   prefill and 6 a decode step, 210), and at full depth xlstm-1.3b (48
   layers, 8 x 2048 tokens; 0: its scans are plain torch) and hymba-1.5b
   (32 layers, 8 x 2048 tokens, past its 1024 window; 3, its global
   layers; the sliding layers take the chunked torch path); every flash
   call's shape is one that phase 2c checked. Logits finite; each
   model's prefill seconds, decode ms, tokens/s, peak bytes (of the init
   too), ``n_params``, (MoE) the router's aux loss (summed over layers,
   and a layer's mean), each layer's share of assignments dropped at
   capacity and its busiest expert's load, and (xLSTM, hymba) the
   seconds of the mLSTM, sLSTM and SSM scans inside the prefill (host
   clock, card synchronized around each call); each model freed before
   the next.
8. family parity, card against CPU in f32, equal greedy tokens and
   logits within 1e-4: qwen3-moe at 2 layers (128 experts, top-8, 64/4
   heads of 128, d_model 512), with two card prefills bitwise equal and
   a zero router (every probability tied) picking the CPU's experts;
   gemma2 at 2 layers (window 64 under 128-token prompts, softcaps,
   d_model 512); whisper-base at full width with 2 + 2 layers over 1500
   frames; xlstm-1.3b at full width with 2 layers (one mLSTM, one sLSTM
   block), each card decode step from the CPU's state (its bf16 matrix
   memory amplifies one-ulp differences step after step); hymba-1.5b at
   full width with 4 layers, window 64 under 128-token prompts (the
   sliding layer masks, its ring wraps); both also through
   ``greedy_generate`` with equal tokens.
9. training, the launch counts set to 0 just before each leg and read
   just after. (9a) smollm-135m at full width and depth (bf16, seeded
   weights) through ``repro_torch.launch.train.main`` with ``--steps 12
   --batch 8 --seq 2048 --ckpt-every 6`` (remat, lr 3e-4 after its
   warmup): each step's seconds, tokens/s, peak bytes, the first and
   last loss (``improved`` must be true), flash launches exactly 60 a
   step (30 layers: the forward and the remat recompute; the backward
   is the oracle's gradient, no kernel), each checkpoint's seconds and
   bytes; then ``--resume`` from the step-6 checkpoint alone: the
   restored tensors bitwise the saved ones (sha1), steps 7-12's losses
   within 1e-2 relative of the first run's (a card's sums need not
   repeat bit for bit from run to run). (9b) smollm at full width with 2
   layers in f32, one set of weights on the card and the CPU: the first
   batch's gradients (each leaf within 1e-4 of its largest |g|; wq, wk,
   wv non-zero), the compressed sync over two pods on cuda:0 within one
   quantization step an element, and 3 train steps (losses within 1e-5
   relative, params within 1e-4 but for one element in 10^5, which
   AdamW may step the other way). (9c) one train step of each family's
   smoke config in f32 (dense, gemma2, MoE, llava, whisper, xLSTM,
   hymba), card against CPU within the same tolerances, flash launches
   exactly two per plain attention a step.

10. the sharded LM layer. (10a) ``layers.moe_ffn_ep`` in f32 at d 512,
   128 experts top-8 and expert ff 256, 4 x 2048 tokens, capacity 1.25,
   on (1, 4) and (2, 4) ``("data", "model")`` meshes with every shard on
   cuda:0, against the CPU meshes of the same shapes on the same inputs
   (tokens and router on a dyadic grid, so both sides route alike), and
   at 2 experts top-2 (virtual experts): y within 1e-5 of max|y|, aux
   within 1e-6 relative, a second card run bitwise the first, no kernel
   launch. (10b) qwen3-moe-235b-a22b at phase 7's cut (8 of 94 layers),
   bf16, seeded weights, 4 x 2048 prompts through ``make_prefill`` in
   turns: dense, twice under ``MOE_EP_MODE`` on a (1, 4) mesh with its
   model shards on cuda:0, dense again; launches counted from 0 around
   each EP prefill: flash exactly 8, logits finite, the two EP prefills
   bitwise equal; seconds and peak bytes beside the dense prefills',
   layer 0's dropped share beside dense's. (10c) ``launch.dryrun.run_cell`` on smollm-135m train_4k
   (one pod) and qwen3-moe decode_32k (two pods) on meta tensors, each
   "ok", with their seconds; ``make_production_mesh()`` raises on one
   card.
11. the launchers' sharded execution, the launch counts set to 0 just
   before each leg and read just after. (11a) ``launch.train.main`` on
   smollm-135m at full width and depth (bf16, seeded weights, ``--steps
   4 --batch 8 --seq 2048``) on a (2, 2) ``("data", "model")`` mesh
   with every position on cuda:0, then on the 1 x 1 host mesh with the
   same seed: step seconds, tokens/s, peak bytes, each position's
   resident bytes equal to ``specs.shard_bytes``, flash exactly 60 x dp
   a step (120 on (2, 2): each data row's forward and remat recompute;
   the model axis adds none), the losses within 1e-2 relative. (11b)
   smollm at full width with 2 layers in f32: 3 sharded steps on the
   (2, 2) card mesh against the one-device CPU step on the same weights
   (9b's tolerances), flash 24; the mesh's checkpoint restored on 1 x 1
   bitwise (sha1). (11c) ``launch.serve_lm.main`` on smollm at full
   width, 8 requests, on the (2, 2) mesh against the 1 x 1 host mesh:
   equal tokens at 2 layers in f32; both runs' seconds at full depth in
   bf16. (11d) with two or more cards, 11b and 11c with the positions
   spread over them; otherwise a record that it did not run. (11e) the
   tensor-parallel step: granite-8b at its published widths (d 4096,
   32/8 heads of 128, d_ff 14336, vocab 49152, bf16, seeded weights)
   cut to 8 of 36 layers, 3 steps of 4 x 2048 tokens on a (1, 4) mesh
   with every position on cuda:0, then on 1 x 1: step seconds, tokens/s,
   peak bytes, flash exactly 64 a step on (1, 4) (each of the 4 shards'
   8/2 heads, forward and remat) against 16, the process's matmul FLOPs
   of the first step (``FlopCounterMode``) equal to
   ``train.sharded.step_matmul_flops`` and each position's reckoned
   beside 1 x 1's, the losses within 1e-2 relative; then granite's
   widths at 2 layers in f32, 3 steps of 2 x 128 on a (1, 2) card mesh
   against the CPU's one-device step (9b's tolerances), flash 24. The
   ``sharded_train`` records carry ``tp_split``, the split and the
   gathered leaves. Phase 2b checks and times flash at the shard shape
   (4, 2048, 8, 2, 128).

Phases 3e-3i run after phase 4. Stdout carries JSON records, then the
script's total seconds; the line before the last is the per-kernel
summary, and the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA GPU, or without the repository around it, the script exits non-zero
and prints no result. Options shrink the sizes for a quick check.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: where the phases of the service and the guards put their tensors
DEVICE = "cuda"
#: where the sharded phase's one-card meshes put every block
MESH_DEVICE = "cuda:0"

#: H100 SXM data-sheet peaks: HBM3 bandwidth, dense FP32 and bf16 rates
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

#: the Pallas calls the kernels replace
REPLACES = {
    "extrema": "src/repro/kernels/extrema.py:317",
    "fixpass": "src/repro/kernels/fixpass.py:127",
    "lorenzo": "src/repro/kernels/lorenzo.py:95",
    "pack": "src/repro/kernels/pack.py:264",
    "unpack": "src/repro/kernels/pack.py:302",
    "flash": "src/repro/kernels/flash.py:102",
}

#: kernel name -> (module under repro_torch.kernels, its launch counter)
COUNTERS = {
    "extrema": ("extrema", "launches"),
    "fixpass": ("fixpass", "launches"),
    "lorenzo": ("lorenzo", "launches"),
    "pack": ("pack", "pack_launches"),
    "unpack": ("pack", "unpack_launches"),
    "flash": ("flash", "launches"),
}

#: the CUDA source of each kernel
SOURCE = {"extrema": "extrema", "fixpass": "fixpass", "lorenzo": "lorenzo",
          "pack": "pack", "unpack": "pack", "flash": "flash"}


def _kernel_module(name: str):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{COUNTERS[name][0]}")


def reset_launches() -> None:
    for name, (_, attr) in COUNTERS.items():
        setattr(_kernel_module(name), attr, 0)


def read_launches() -> dict:
    return {name: getattr(_kernel_module(name), attr)
            for name, (_, attr) in COUNTERS.items()}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_time_checked_ms(fn, same, reps: int) -> float:
    """Median milliseconds of ``reps`` CUDA-event-timed ``fn()`` calls
    after one warm-up call, each call's result checked with
    ``same(result)`` after its timed span (a race shows as a
    difference)."""
    import torch
    fn()
    times = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        if not same(out):
            raise AssertionError(f"timed call {i} differs from the first")
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(fn, launches: int) -> float:
    """Milliseconds per call of ``launches`` back-to-back ``fn()`` calls
    between two CUDA events (one warm-up call first): the device time of
    a launch whenever the host enqueues faster than the card runs."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / launches


def max_abs_diff(xs, ys) -> float:
    """Largest |x - y| over pairs of tensors, as a float."""
    return max(float((x.double() - y.double()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(xs, ys))


def assert_equal(what: str, xs, ys) -> None:
    import torch
    for i, (x, y) in enumerate(zip(xs, ys)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: output {i} differs from the "
                                 f"plain version")


# ---------------------------------------------------------------------------
# phase 2: kernels against plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(f, xi: float, g):
    """Extrema/fix-pass inputs of the first fix iteration: the original
    field's topology and the masks of ``g``, all on the card."""
    from repro_torch.core import fixes
    from repro_torch.kernels import extrema as kx
    topo = fixes.field_topology(f, xi)
    geo = kx.geometry(tuple(g.shape))
    masks = kx.extrema_masks_plain(g, topo.M, topo.m, topo.is_max,
                                   topo.is_min, geo)
    return topo, masks


def tile_of(shape, tile) -> tuple:
    """(slices, kernel tile arguments) of ``tile`` = (z0, z1, y0, y1, x0,
    x1) of a field of ``shape`` (2D fields ignore y0, y1)."""
    z0, z1, y0, y1, x0, x1 = tile
    if len(shape) == 3:
        return ((slice(z0, z1), slice(y0, y1), slice(x0, x1)),
                dict(slab_lo=z0, row_lo=y0, col_lo=x0,
                     n_slabs_total=shape[0], n_rows_total=shape[1],
                     n_cols_total=shape[2]))
    return ((slice(z0, z1), slice(x0, x1)),
            dict(slab_lo=z0, col_lo=x0, n_slabs_total=shape[0],
                 n_cols_total=shape[1]))


def tile_geometry(shape, tkw: dict):
    """The kernels' geometry of a tensor of ``shape`` placed by ``tkw``."""
    from repro_torch.kernels import stencil
    return stencil.geometry(tuple(shape), tkw.get("slab_lo", 0),
                            tkw.get("row_lo", 0), tkw.get("col_lo", 0),
                            tkw.get("n_slabs_total"),
                            tkw.get("n_rows_total"),
                            tkw.get("n_cols_total"))


def check_stencil(label: str, f, ext, tkw: dict, step: float) -> None:
    """extrema and lorenzo against their plain versions, bitwise, on one
    input placed by ``tkw``: ``ext`` the extrema inputs, ``f`` the field
    the Lorenzo kernel quantizes with ``step``."""
    import torch
    from repro_torch.kernels import extrema as kx, lorenzo as kl
    geo = tile_geometry(ext[0].shape, tkw)
    assert_equal(f"extrema {label}", kx.extrema_masks(*ext, **tkw),
                 kx.extrema_masks_plain(*ext, geo))
    lo = tkw.get("slab_lo", 0)
    step_t = torch.tensor(step, dtype=f.dtype, device=f.device)
    want = kl.lorenzo_quant_plain(f, step_t, kl.geometry(tuple(f.shape), lo))
    assert_equal(f"lorenzo {label}",
                 [kl.lorenzo_quant(f, step_t, slab_lo=lo)], [want])


def check_case(label: str, f, xi: float, g, tile=None) -> None:
    """All three kernels against their plain versions on one input;
    ``tile`` = (z0, z1, y0, y1, x0, x1) runs them on a tile of it placed
    at a non-zero origin."""
    import torch
    from repro_torch.kernels import fixpass as kf
    topo, masks = kernel_inputs(f, xi, g)
    ext = (g, topo.M, topo.m, topo.is_max, topo.is_min)
    fix = (g, topo.lower, masks[2], masks[3], masks[4], masks[0], topo.dn_c)
    tkw = {}
    if tile is not None:
        sl, tkw = tile_of(tuple(g.shape), tile)
        f = f[sl].contiguous()
        ext = tuple(t[sl].contiguous() for t in ext)
        fix = tuple(t[sl].contiguous() for t in fix)
    check_stencil(label, f, ext, tkw, 2 * xi)
    geo = tile_geometry(fix[0].shape, tkw)
    got = kf.fix_pass(*fix, **tkw)
    assert_equal(f"fixpass {label}", got, kf.fix_pass_plain(*fix, geo))
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "case": label,
          "shape": list(ext[0].shape), "dtype": str(f.dtype).split(".")[-1],
          "bitwise": True})


def phase_kernels_small(seed: int) -> None:
    import torch
    from repro_torch.data import synthetic_field
    rng = np.random.default_rng(seed)
    for shape, name in (((37, 45, 61), "nyx"), ((123, 257), "climate")):
        base = synthetic_field(name, shape)
        for dtype in (np.float32, np.float64):
            for kind in ("synthetic", "ties"):
                f = base.astype(dtype)
                if kind == "ties":
                    f = np.round(f * 4) / 4
                xi = 1e-2 * float(np.ptp(f)) + 1e-3
                g = f + rng.uniform(-xi, xi, size=shape).astype(dtype)
                ft = torch.from_numpy(np.ascontiguousarray(f)).cuda()
                gt = torch.from_numpy(np.ascontiguousarray(g)).cuda()
                label = f"{len(shape)}d-{kind}"
                check_case(label, ft, xi, gt)
                tile = ((5, 30, 7, 40, 3, 50) if len(shape) == 3
                        else (17, 90, 0, 0, 33, 200))
                check_case(label + "-tile", ft, xi, gt, tile)


#: shapes of the dense fix-pass cases: degenerate planes, shapes that are
#: not multiples of the kernel's tile, and rows whose width is a multiple
#: of 4 (its 16-byte path), in 3D, in 3D with one-row planes, and in 2D
FIX_DENSE_SHAPES = ((3, 1, 5), (2, 2, 2), (37, 45, 61), (16, 33, 128),
                    (9, 1, 64), (1, 7), (5, 4), (123, 257), (45, 1028))

#: (field shape, tile) of the dense cases placed at a non-zero origin on
#: every axis; the second of each pair has rows of a multiple of 4
FIX_DENSE_TILES = (((37, 45, 61), (5, 30, 7, 40, 3, 50)),
                   ((20, 40, 136), (3, 17, 5, 38, 4, 132)),
                   ((123, 257), (17, 90, 0, 0, 33, 200)),
                   ((60, 1032), (7, 50, 0, 0, 8, 1024)))


def dense_fix_inputs(shape, dtype, rng) -> list:
    """Fix-pass inputs on the card with every pull direction busy:
    self_edit, demote_src and promote_src 0/1 at 50 %, codes uniform in
    [-1, K), and lower above g at about a sixth of the vertices."""
    import torch
    n_dirs = 14 if len(shape) == 3 else 6
    g = rng.normal(size=shape).astype(dtype)
    lower = (g + rng.uniform(-1.0, 0.2, size=shape)).astype(dtype)
    masks = [(rng.random(shape) < 0.5).astype(np.int32) for _ in range(3)]
    codes = [rng.integers(-1, n_dirs, size=shape).astype(np.int32)
             for _ in range(2)]
    return [torch.from_numpy(x).cuda() for x in (g, lower, *masks, *codes)]


def phase_fixpass_dense(seed: int) -> None:
    """The fix-pass kernel against its plain version, bitwise, on dense
    adversarial inputs, whole and as tiles at a non-zero origin."""
    import torch
    from repro_torch.kernels import fixpass as kf
    rng = np.random.default_rng(seed)
    cases = [(shape, None) for shape in FIX_DENSE_SHAPES]
    cases += list(FIX_DENSE_TILES)
    for dtype in (np.float32, np.float64):
        for shape, tile in cases:
            ins = dense_fix_inputs(shape, dtype, rng)
            tkw = {}
            if tile is not None:
                sl, tkw = tile_of(shape, tile)
                ins = [t[sl].contiguous() for t in ins]
            geo = tile_geometry(ins[0].shape, tkw)
            label = f"fixpass dense {shape}" + (f" tile {tile}" if tile
                                                 else "")
            got = kf.fix_pass(*ins, **tkw)
            assert_equal(label, got, kf.fix_pass_plain(*ins, geo))
            torch.cuda.synchronize()
            emit({"phase": "kernels_vs_plain", "case": label,
                  "shape": list(ins[0].shape),
                  "dtype": str(np.dtype(dtype)), "targets": int(got[2].sum()),
                  "bitwise": True})


#: field kinds of the dense extrema and Lorenzo cases: every value equal,
#: values on a quarter grid (plateaus and ties everywhere), and random
STENCIL_KINDS = ("constant", "quarter", "random")


def dense_stencil_inputs(shape, dtype, kind: str, rng) -> tuple:
    """(f, extrema inputs) on the card for one dense case: g of ``kind``,
    labels M_f/m_f drawn from {0, 1, 2} (so a winner's label matches its
    vertex's about a third of the time) and the extremum masks at 50 %;
    f is g's kind too, for the Lorenzo kernel."""
    import torch
    if kind == "constant":
        f = np.full(shape, 1.25)
        g = np.full(shape, -0.25)
    else:
        f, g = rng.normal(size=shape) * 8, rng.normal(size=shape)
        if kind == "quarter":
            f, g = np.round(f * 4) / 4, np.round(g * 4) / 4
    labels = [rng.integers(0, 3, size=shape).astype(np.int32)
              for _ in range(2)]
    masks = [rng.random(shape) < 0.5 for _ in range(2)]
    ext = [torch.from_numpy(x).cuda()
           for x in (g.astype(dtype), *labels, *masks)]
    return torch.from_numpy(f.astype(dtype)).cuda(), ext


def offset_copy(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary, so the kernels refuse their 16-byte path."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_stencil_dense(seed: int) -> None:
    """The extrema and Lorenzo kernels against their plain versions,
    bitwise, over the dense fix-pass shapes and tiles in f32 and f64, on
    tie-heavy and random fields; inputs one element off a 16-byte
    boundary (the one-vertex path); Lorenzo at the device path's range
    limit."""
    import torch
    from repro_torch.compress import szlike
    from repro_torch.kernels import lorenzo as kl
    rng = np.random.default_rng(seed)
    cases = [(shape, None) for shape in FIX_DENSE_SHAPES]
    cases += list(FIX_DENSE_TILES)
    for dtype in (np.float32, np.float64):
        for shape, tile in cases:
            for kind in STENCIL_KINDS:
                f, ext = dense_stencil_inputs(shape, dtype, kind, rng)
                tkw = {}
                if tile is not None:
                    sl, tkw = tile_of(shape, tile)
                    f = f[sl].contiguous()
                    ext = [t[sl].contiguous() for t in ext]
                label = f"dense {kind} {shape}" + (f" tile {tile}" if tile
                                                   else "")
                # quarter-grid values over 0.5 round half to even at odd
                # quarters
                check_stencil(label, f, ext, tkw, 0.5)
            torch.cuda.synchronize()
            emit({"phase": "kernels_vs_plain",
                  "case": f"extrema+lorenzo dense {shape}"
                          + (f" tile {tile}" if tile else ""),
                  "shape": list(ext[0].shape), "dtype": str(np.dtype(dtype)),
                  "kinds": list(STENCIL_KINDS), "bitwise": True})
        for shape in ((16, 33, 128), (45, 1028)):
            f, ext = dense_stencil_inputs(shape, dtype, "quarter", rng)
            f, ext = offset_copy(f), [offset_copy(t) for t in ext]
            check_stencil(f"offset {shape}", f, ext, {}, 0.5)
            torch.cuda.synchronize()
            emit({"phase": "kernels_vs_plain",
                  "case": f"extrema+lorenzo off 16-byte alignment {shape}",
                  "shape": list(shape), "dtype": str(np.dtype(dtype)),
                  "bitwise": True})
        for shape in ((37, 45, 61), (123, 257)):
            # max|f| / xi just under the range limit, reached at one vertex
            xi = 0.75
            amax = 0.999 * szlike.device_range_limit(dtype) * xi
            f_np = rng.uniform(-amax, amax, size=shape).astype(dtype)
            f_np.reshape(-1)[rng.integers(f_np.size)] = -amax
            szlike.check_int32_range(f_np, xi)
            f = torch.from_numpy(f_np).cuda()
            step = torch.tensor(szlike.effective_step(f_np, xi),
                                dtype=f.dtype, device="cuda")
            got = kl.lorenzo_quant(f, step)
            want = kl.lorenzo_quant_plain(f, step,
                                          kl.geometry(tuple(shape)))
            assert_equal(f"lorenzo range limit {shape}", [got], [want])
            emit({"phase": "kernels_vs_plain",
                  "case": f"lorenzo range limit {shape}",
                  "shape": list(shape), "dtype": str(np.dtype(dtype)),
                  "max_abs_residual": int(got.abs().max()),
                  "bitwise": True})


def adversarial_codes(seed: int) -> dict:
    """Code arrays that stress the bitplane layout (the reference's
    ``tests/test_entropy.py`` cases) and 10^6 full-range random codes."""
    rng = np.random.default_rng(seed)
    C = 1024
    lo, hi = np.int32(-2 ** 31), np.int32(2 ** 31 - 1)
    return {
        "empty": np.zeros(0, np.int32),
        "zeros": np.zeros(3 * C + 11, np.int32),
        "ones": np.ones(C - 1, np.int32),
        "minus_one": np.full(C + 1, -1, np.int32),
        "int32_min": np.full(17, lo, np.int32),
        "int32_extremes": np.array([lo, hi, 0, -1, 1, lo + 1, hi - 1],
                                   np.int32),
        "small": rng.integers(-5, 6, size=C // 2).astype(np.int32),
        "mixed_chunks": np.concatenate([
            rng.integers(-3, 4, size=C), rng.integers(-2**20, 2**20, size=C),
            np.zeros(C, np.int32), rng.integers(-2**30, 2**30, size=37),
        ]).astype(np.int32),
        "chunk_exact": rng.integers(-1000, 1000, size=2 * C).astype(np.int32),
        "powers": np.array([-(2**k) for k in range(31)] +
                           [2**k for k in range(31)], np.int32),
        "full_range": rng.integers(-2**31, 2**31, size=10**6,
                                   dtype=np.int64).astype(np.int32),
    }


def check_pack(label: str, r) -> tuple:
    """pack and unpack on the card against their plain versions, bitwise,
    and the round trip back to ``r``; returns the kernel's stream and
    the largest difference from the plain versions (0 when bitwise)."""
    import torch
    from repro_torch.kernels import pack as kp
    words, bits, n_words = kp.pack_codes(r)
    w_p, b_p, n_p = kp.pack_codes_plain(r)
    if n_words != n_p:
        raise AssertionError(f"pack {label}: n_words {n_words} != {n_p}")
    assert_equal(f"pack {label}", [words, bits], [w_p, b_p])
    back = kp.unpack_codes(words, bits, tuple(r.shape))
    back_p = kp.unpack_codes_plain(words, bits, tuple(r.shape))
    assert_equal(f"unpack {label}", [back], [back_p])
    if not torch.equal(back, r):
        raise AssertionError(f"pack {label}: the round trip lost codes")
    torch.cuda.synchronize()
    err = {"pack": max_abs_diff([words, bits], [w_p, b_p]),
           "unpack": max_abs_diff([back], [back_p])}
    return words, bits, n_words, err


def mixed_width_codes(n: int, seed: int):
    """``n`` int32 codes on the card whose chunks take widths drawn from
    {0, 1, 31, 32}, and those widths: each chunk's zigzag values are
    uniform below 2^b, with bit b - 1 set in its first code so that its
    width is exactly b."""
    import torch
    from repro_torch.kernels import pack as kp
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_chunks = -(-n // kp.CHUNK)
    choice = torch.tensor([0, 1, 31, 32], device="cuda")
    b = choice[torch.randint(0, 4, (n_chunks,), generator=gen,
                             device="cuda")]
    u = torch.randint(0, 2 ** 32, (n_chunks, kp.CHUNK), generator=gen,
                      dtype=torch.int64, device="cuda")
    one = torch.ones_like(b)
    u &= ((one << b) - 1)[:, None]
    u[:, 0] |= torch.where(b > 0, one << (b - 1).clamp(min=0), 0)
    return kp.unzigzag(u.reshape(-1)[:n]), b.to(torch.int32)


def check_bad_streams(seed: int) -> list:
    """The four bad streams of ``tests/test_torch_pack.py`` (a width table
    one chunk short, a width of 33, one word short, 32 words over) must
    raise ValueError on the card, and the card must decode a good
    stream bitwise after each."""
    import torch
    from repro_torch.kernels import pack as kp
    codes = torch.from_numpy(adversarial_codes(seed)["mixed_chunks"]).cuda()
    words, bits, _ = kp.pack_codes(codes)
    wide = bits.clone()
    wide[1] = 33
    bad = {"n_chunks": (words, bits[:-1]),
           "width": (words, wide),
           "short": (words[:-1].clone(), bits),
           "long": (torch.cat([words, torch.zeros(32, dtype=torch.int32,
                                                  device="cuda")]), bits)}
    raised = []
    for label, (w, b) in bad.items():
        try:
            kp.unpack_codes(w, b, tuple(codes.shape))
        except ValueError:
            raised.append(label)
        else:
            raise AssertionError(f"unpack: the {label!r} bad stream decoded")
        torch.cuda.synchronize()
        if not torch.equal(kp.unpack_codes(words, bits, tuple(codes.shape)),
                           codes):
            raise AssertionError(f"unpack after the {label!r} bad stream: "
                                 "the card no longer decodes")
    return raised


def phase_pack_small(seed: int) -> None:
    import torch
    from repro_torch.kernels import pack as kp
    for label, codes in adversarial_codes(seed).items():
        r = torch.from_numpy(codes).cuda()
        _, _, n_words, _ = check_pack(label, r)
        emit({"phase": "kernels_vs_plain", "case": f"pack-{label}",
              "shape": list(codes.shape), "dtype": "int32",
              "n_words": n_words, "bitwise": True})
    # many waves of blocks (2^17 chunks, the last one ragged), one chunk,
    # one code, and n one off a multiple of CHUNK on either side
    C = kp.CHUNK
    for label, n in (("multi-wave", 2 ** 17 * C - 5), ("one-chunk", C),
                     ("one-code", 1), ("chunks-minus-one", 4096 * C - 1),
                     ("chunks-plus-one", 4096 * C + 1)):
        r, widths = mixed_width_codes(n, seed + n)
        _, bits, n_words, _ = check_pack(label, r)
        if not torch.equal(bits, widths):
            raise AssertionError(f"pack {label}: widths differ from the "
                                 "drawn ones")
        emit({"phase": "kernels_vs_plain", "case": f"pack-{label}",
              "shape": [n], "dtype": "int32", "n_chunks": int(bits.numel()),
              "widths": sorted(set(bits.tolist())), "n_words": n_words,
              "bitwise": True})
        del r, bits, widths
        torch.cuda.empty_cache()
    # codes and words one element off a 16-byte boundary (the kernels'
    # 4-byte paths)
    for label, n in (("mixed_chunks", 0), ("chunks-plus-one", 4096 * C + 1)):
        r = (torch.from_numpy(adversarial_codes(seed)[label]).cuda() if not n
             else mixed_width_codes(n, seed + n)[0])
        words, bits, n_words, _ = check_pack(f"offset {label}",
                                             offset_copy(r))
        back = kp.unpack_codes(offset_copy(words), bits, tuple(r.shape))
        if not torch.equal(back, r):
            raise AssertionError(f"unpack offset {label}: differs")
        emit({"phase": "kernels_vs_plain",
              "case": f"pack+unpack off 16-byte alignment {label}",
              "shape": list(r.shape), "dtype": "int32", "n_words": n_words,
              "bitwise": True})
    emit({"phase": "kernels_vs_plain", "case": "unpack bad streams",
          "raised_value_error": check_bad_streams(seed)})


def pack_bound(n: int, n_words: int) -> tuple:
    """(pack bound_ms, unpack bound_ms): bytes over the HBM rate. pack
    reads 4 B a code and writes the words and the int32 widths; unpack
    reads the words and the int32 widths and writes 4 B a code."""
    n_chunks = -(-n // 1024)
    pack_b = 4 * n + 4 * n_words + 4 * n_chunks
    unpack_b = 4 * n_words + 4 * n_chunks + 4 * n
    return (pack_b / HBM_BYTES_PER_S * 1e3, unpack_b / HBM_BYTES_PER_S * 1e3)


def phase_pack_main(f_np, xi: float, reps: int) -> dict:
    """pack and unpack at a main-path shape: the field's real residual
    codes and their packed stream, bitwise against the plain versions,
    then timed: whole wrapper calls (``kernel_ms``), each checked
    bitwise against the first, and the kernel entry alone on
    preallocated buffers, 5 x ``reps`` launches back to back
    (``device_ms``)."""
    import torch
    from repro_torch.compress import szlike
    from repro_torch.kernels import lorenzo as kl, pack as kp
    f = torch.from_numpy(f_np).cuda()
    step = torch.tensor(szlike.effective_step(f_np, xi), dtype=f.dtype,
                        device="cuda")
    r = kl.lorenzo_quant(f, step)
    del f
    words, bits, n_words, err = check_pack(f"main-path {tuple(r.shape)}",
                                           r)
    words = words.clone()
    shape = tuple(r.shape)
    bounds = dict(zip(("pack", "unpack"), pack_bound(r.numel(), n_words)))
    n_chunks = bits.numel()
    w_buf = torch.empty(n_chunks * kp.CHUNK, dtype=torch.int32,
                        device="cuda")
    b_buf = torch.empty_like(bits)
    scratch = torch.empty(kp.scratch_size(n_chunks), dtype=torch.int64,
                          device="cuda")
    out = torch.empty_like(r)
    calls = {
        "pack": (lambda: kp.pack_codes(r),
                 lambda o: o[2] == n_words and torch.equal(o[0], words)
                 and torch.equal(o[1], bits),
                 lambda: kp.launch_pack(r, w_buf, b_buf, scratch),
                 lambda: torch.equal(w_buf[:n_words], words)
                 and torch.equal(b_buf, bits),
                 lambda: kp.pack_codes_plain(r)),
        "unpack": (lambda: kp.unpack_codes(words, bits, shape),
                   lambda o: torch.equal(o, r),
                   lambda: kp.launch_unpack(words, bits, out, scratch),
                   lambda: torch.equal(out, r),
                   lambda: kp.unpack_codes_plain(words, bits, shape)),
    }
    results = {}
    for name, (kern, same, entry, entry_ok, plain) in calls.items():
        ms = cuda_time_checked_ms(kern, same, reps)
        device_ms = back_to_back_ms(entry, 5 * reps)
        if not entry_ok():
            raise AssertionError(f"{name} {shape}: the kernel entry's "
                                 "output differs from the wrapper's")
        plain_ms = cuda_time_ms(plain, max(reps // 2, 3), warmup=1)
        results[name] = dict(max_abs_err=err[name], ms=ms,
                             device_ms=device_ms, plain_ms=plain_ms,
                             bound_ms=bounds[name], bound_by="bytes")
        emit({"phase": "kernel_timing", "kernel": name,
              "shape": list(shape), "dtype": "int32", "bitwise": True,
              "timed_calls_bitwise": reps,
              "n_words": n_words, "n_chunks": n_chunks,
              "kernel_ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
              "bound_ms": bounds[name], "bound_by": "bytes"})
    del r, words, bits, w_buf, b_buf, scratch, out
    torch.cuda.empty_cache()
    return results


def bound_record(name: str, shape, itemsize: int) -> tuple:
    """(bound_ms, bound_by) for one launch on a field of ``shape``: the
    larger of bytes over HBM rate and operations over the f32 rate."""
    n, nz = int(np.prod(shape)), shape[0]
    k = 14 if len(shape) == 3 else 6     # stencil neighbors
    if name == "extrema":
        nbytes = n * (itemsize + 4 + 4 + 1 + 1 + 5 * 4)
        ops = n * (2 * k * 3 + 12)       # two SoS scans + the predicates
    elif name == "fixpass":
        nbytes = n * (2 * itemsize + 5 * 4 + itemsize) + 2 * 4 * nz
        ops = n * (k * 4 + 4)            # pulled sources + the halving
    else:
        nbytes = n * (itemsize + 4) + itemsize
        ops = n * (8 * 2 + 8)            # 8 divide+round, 8 signed adds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels_main(f_np, xi: float, reps: int) -> dict:
    """Each kernel at a main-path shape, on the first fix iteration's
    inputs: bitwise against its plain version, then timed."""
    import torch
    from repro_torch.compress import szlike
    from repro_torch.kernels import extrema as kx, fixpass as kf
    from repro_torch.kernels import lorenzo as kl
    f = torch.from_numpy(f_np).cuda()
    step = torch.tensor(szlike.effective_step(f_np, xi), dtype=f.dtype,
                        device="cuda")
    r = kl.lorenzo_quant(f, step)
    r_plain = kl.lorenzo_quant_plain(f, step, kl.geometry(tuple(f.shape)))
    f_hat = szlike.sz_inverse(r, step)
    topo, masks = kernel_inputs(f, xi, f_hat)
    geo = kx.geometry(tuple(f.shape))
    ext = (f_hat, topo.M, topo.m, topo.is_max, topo.is_min)
    fix = (f_hat, topo.lower, masks[2], masks[3], masks[4], masks[0],
           topo.dn_c)
    results = {}
    calls = {
        "extrema": (lambda: kx.extrema_masks(*ext),
                    lambda: kx.extrema_masks_plain(*ext, geo)),
        "fixpass": (lambda: kf.fix_pass(*fix),
                    lambda: kf.fix_pass_plain(*fix, geo)),
        "lorenzo": (lambda: kl.lorenzo_quant(f, step),
                    lambda: kl.lorenzo_quant_plain(f, step, geo)),
    }
    firsts = {"extrema": (kx.extrema_masks(*ext), masks),
              "fixpass": (kf.fix_pass(*fix), kf.fix_pass_plain(*fix, geo)),
              "lorenzo": ((r,), (r_plain,))}
    for name, (kern, plain) in calls.items():
        got, want = firsts[name]
        assert_equal(f"{name} main-path {tuple(f.shape)}", got, want)
        err = max_abs_diff(got, want)
        ms = cuda_time_ms(kern, reps)
        plain_ms = cuda_time_ms(plain, max(reps // 2, 3), warmup=1)
        bound_ms, bound_by = bound_record(name, tuple(f.shape),
                                          f.element_size())
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "kernel_timing", "kernel": name,
              "shape": list(f.shape), "dtype": str(np.dtype(f_np.dtype)),
              "bitwise": True, "kernel_ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by})
    del ext, fix, topo, masks, r, r_plain, f_hat, f
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def n_groups(shape, group: int = 8) -> int:
    """Slab groups of the worklist on a field of ``shape``."""
    return -(-shape[0] // group)


def check_fix_launches(label: str, launches: dict, iters: int, shape,
                       spans: int) -> None:
    """The fix loop's launches under the worklist: one extrema and one
    fix-pass launch a span, at least one span an iteration and at most
    one a group."""
    ext, fix = launches["extrema"], launches["fixpass"]
    if not (ext == fix == spans
            and iters <= ext <= iters * n_groups(shape)):
        raise AssertionError(
            f"{label}: extrema {ext}, fixpass {fix}, spans {spans} for "
            f"{iters} iterations of {n_groups(shape)} groups")


#: (field, entropy) -> (artifact, g or None) of the main-path runs, for
#: the sharded phase to hold its artifacts to
MAIN_ARTS: dict = {}


def phase_main_path(label: str, f, xi: float, entropy: str) -> dict:
    import torch
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_preserving_mss,
                                      overall_compression_ratio)
    from repro_torch.core import backend, verify_preservation
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    backend.worklist_spans = 0
    stages = {}
    t0 = time.perf_counter()
    art = compress_preserving_mss(f, xi, entropy=entropy, timings=stages)
    t1 = time.perf_counter()
    g = decompress_preserving_mss(art)
    t2 = time.perf_counter()
    report = verify_preservation(f, g, xi)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_launches()
    spans = backend.worklist_spans
    if not (report["mss_preserved"] and report["bound_ok"]):
        raise AssertionError(f"{label}: MSS not preserved: {report}")
    check_fix_launches(label, launches, art.fix_iters, f.shape, spans)
    packed = int(entropy == "device-pack")
    want = {"lorenzo": 1, "pack": packed, "unpack": packed, "flash": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if art.entropy != entropy or art.path != "device":
        raise AssertionError(f"{label}: artifact records entropy "
                             f"{art.entropy!r} on path {art.path!r}")
    stages.update(compress=t1 - t0, decompress=t2 - t1, verify=t3 - t2)
    MAIN_ARTS[(label, entropy)] = (art, g if f.size <= 1 << 24 else None)
    emit({"phase": "main_path", "field": label, "entropy": entropy,
          "base_magic": art.base_magic, "shape": list(f.shape),
          "dtype": str(f.dtype), "xi": xi, "fix_iters": art.fix_iters,
          "edits": int(round(art.edit_ratio * f.size)),
          "edit_ratio": art.edit_ratio,
          "compression_ratio": overall_compression_ratio(f, art),
          "payload_bytes": len(art.base_payload),
          "edit_bytes": len(art.edit_payload),
          "mss_preserved": report["mss_preserved"],
          "bound_ok": report["bound_ok"],
          "max_abs_err": report["max_abs_err"], "launches": launches,
          "worklist_spans": spans, "worklist_groups": n_groups(f.shape),
          "seconds": stages,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    return launches


# ---------------------------------------------------------------------------
# phases 3b-3d: fix-loop strategies, batches, the host path
# ---------------------------------------------------------------------------

def timed(fn):
    """(result, seconds) of ``fn()``, the card synced on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fixloop_strategies(label: str, f_np, xi: float) -> None:
    """The fix loop of the main path's inputs (f_hat from the Lorenzo
    kernel and its inverse, the original's topology) under the dense
    loop, the "auto" worklist (``fused_fix`` on ``cuda``, and
    ``fused_fix_worklist`` on the same backend), ``cuda_worklist``
    (groups of 4) and ``cuda_tiled`` (tiles of 8, worklist off): equal g
    bitwise and equal iterations; each strategy timed and its launches
    counted."""
    import dataclasses
    import torch
    from repro_torch.compress import szlike
    from repro_torch.core import backend, fixes
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels import lorenzo as kl
    f = torch.from_numpy(f_np).cuda()
    step = torch.tensor(szlike.effective_step(f_np, xi), dtype=f.dtype,
                        device="cuda")
    f_hat = szlike.sz_inverse(kl.lorenzo_quant(f, step), step)
    topo = fixes.field_topology(f, xi)
    dense_be = dataclasses.replace(get_backend("cuda"), worklist=False)
    tiled_be = dataclasses.replace(get_backend("cuda_tiled"), worklist=False)
    runs = {
        "dense": lambda: fixes.fused_fix(f_hat, topo, backend=dense_be)
        + (None,),
        "auto": lambda: fixes.fused_fix(f_hat, topo, backend="cuda")
        + (None,),
        "auto_worklist": lambda: fixes.fused_fix_worklist(f_hat, topo,
                                                          backend="cuda"),
        "cuda_worklist": lambda: fixes.fused_fix_worklist(
            f_hat, topo, backend="cuda_worklist"),
        "cuda_tiled": lambda: fixes.fused_fix(f_hat, topo, backend=tiled_be)
        + (None,),
    }
    records, g_dense = {}, None
    for name, run in runs.items():
        reset_launches()
        backend.worklist_spans = 0
        (g, iters, ok, skipped), secs = timed(run)
        launches = read_launches()
        if g_dense is None:
            g_dense, it_dense = g, iters
        elif not (torch.equal(g, g_dense) and iters == it_dense):
            raise AssertionError(f"fixloop {label} {name}: g or iterations "
                                 "differ from the dense loop")
        if not ok:
            raise AssertionError(f"fixloop {label} {name}: not converged")
        records[name] = dict(seconds=secs, iters=iters,
                             extrema=launches["extrema"],
                             fixpass=launches["fixpass"],
                             spans=backend.worklist_spans,
                             skipped_slabs=skipped)
    r = records
    if not (r["dense"]["extrema"] == r["dense"]["fixpass"] == it_dense):
        raise AssertionError(f"fixloop {label}: dense launches {r['dense']}")
    tiles = -(-f_np.shape[0] // 8)
    if not (r["cuda_tiled"]["extrema"] == r["cuda_tiled"]["fixpass"]
            == it_dense * tiles):
        raise AssertionError(f"fixloop {label}: tiled launches "
                             f"{r['cuda_tiled']}")
    for name in ("auto", "auto_worklist"):
        check_fix_launches(f"fixloop {label} {name}",
                           r[name], it_dense, f_np.shape, r[name]["spans"])
    if r["auto"]["spans"] != r["auto_worklist"]["spans"]:
        raise AssertionError(f"fixloop {label}: the two worklist routes "
                             "ran different spans")
    emit({"phase": "fixloop_strategies", "field": label,
          "shape": list(f_np.shape), "xi": xi, "iters": it_dense,
          "groups": n_groups(f_np.shape), "g_identical": True,
          "strategies": records})
    del f, g
    return dict(f_hat=f_hat, topo=topo, g=g_dense, iters=it_dense,
                seconds={k: r[k]["seconds"] for k in ("dense", "auto")})


# ---------------------------------------------------------------------------
# phase 3s: the block-sharded fix loop (mesh=) on one card
# ---------------------------------------------------------------------------

#: the sharded phase's mesh legs: (name, mesh shape, overlap, worklist)
SHARDED_LEGS = (("chain4", 4, None, False), ("chain4", 4, None, None),
                ("block2x2", (2, 2), False, False),
                ("block2x2", (2, 2), False, None),
                ("block2x2", (2, 2), True, False),
                ("block2x2", (2, 2), True, None))


def one_card_mesh(shape):
    """A chain (int) or block mesh (tuple) with every block on
    ``MESH_DEVICE``."""
    from repro_torch.launch.mesh import make_block_mesh, make_data_mesh
    if isinstance(shape, int):
        return make_data_mesh(shape, devices=[MESH_DEVICE] * shape)
    return make_block_mesh(shape,
                           devices=[MESH_DEVICE] * int(np.prod(shape)))


def sharded_launch_bound(plan, overlap: bool) -> int:
    """Extrema (= fix-pass) launches of one block-iteration: one on the
    plain schedule; the interior pass plus a low and a high shell a
    sharded axis on the overlap schedule."""
    return 1 + 2 * len(plan.sharded) if overlap else 1


def phase_sharded_fix(label: str, solo: dict) -> dict:
    """The main path's fix loop (3b's f_hat, topology and dense g)
    through ``fused_fix(mesh=m)`` on a 4-block chain and a (2, 2) block
    mesh, every block on cuda:0, each leg with the launch counts and the
    halo-byte counters set to 0 just before it: g bitwise the dense
    loop's, the same iterations, the launches and (worklist off) the
    copied halo bytes as the plan says; seconds and peak bytes beside
    the dense loop's; the overlap schedule's parts timed on the block
    mesh."""
    import torch
    from repro_torch.core import fixes
    from repro_torch.distributed import shardfix as sf
    f_hat, topo, g_ref, it_ref = (solo[k] for k in ("f_hat", "topo", "g",
                                                    "iters"))
    shape = tuple(f_hat.shape)
    meshes = {}
    legs, totals = [], dict.fromkeys(COUNTERS, 0)
    for name, mshape, overlap, worklist in SHARDED_LEGS:
        mesh = meshes.setdefault(name, one_card_mesh(mshape))
        be = sf.ShardedBackend(mesh=mesh, overlap=overlap, worklist=worklist)
        plan = sf.plan_blocks(shape, mesh)
        ov, wl = sf._resolve_modes(plan, overlap, worklist)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sf.reset_halo_bytes()
        (g, iters, ok), secs = timed(lambda: fixes.fused_fix(
            f_hat, topo, backend=be, mesh=mesh))
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        halo = dict(sf.halo_bytes)
        tag = f"sharded {label} {name} overlap={ov} worklist={wl}"
        if not (ok and iters == it_ref and torch.equal(g, g_ref)):
            raise AssertionError(f"{tag}: g or iterations ({iters}) differ "
                                 f"from the dense loop ({it_ref})")
        per = sharded_launch_bound(plan, ov)
        most = len(sf._Layout(plan, mesh).ids) * iters * per
        ext, fix = launches["extrema"], launches["fixpass"]
        if ext != fix or (ext != most if not wl else not
                          per * iters <= ext <= most):
            raise AssertionError(f"{tag}: extrema {ext}, fixpass {fix}, "
                                 f"want {'' if not wl else '<= '}{most}")
        want = {k: v * iters for k, v in sf.halo_plan(
            shape, np.float32, mesh, overlap=ov, worklist=wl).items()}
        if not wl and halo != want:
            raise AssertionError(f"{tag}: copied halo bytes {halo} != "
                                 f"halo_plan x iterations {want}")
        for k, v in launches.items():
            totals[k] += v
        legs.append(dict(mesh=name, mesh_shape=mesh.shape, overlap=ov,
                         worklist=wl, iters=iters, seconds=secs,
                         launches=launches, launches_max=most,
                         halo_bytes=halo,
                         halo_bytes_per_iter=sf.halo_plan(
                             shape, np.float32, mesh, overlap=ov,
                             worklist=wl),
                         peak_device_bytes=peak, g_identical=True))
        del g
    parts = sf.time_step_parts(solo["f_hat"], topo, meshes["block2x2"],
                               reps=3)
    emit({"phase": "sharded_fix", "field": label, "shape": list(shape),
          "iters": it_ref, "devices": [MESH_DEVICE] * 4,
          "solo_seconds": solo["seconds"], "legs": legs,
          "step_parts_block2x2": parts})
    torch.cuda.empty_cache()
    return totals


def phase_sharded_paths(climate, steps, nyx_edge: int,
                        launcher_shape: str) -> dict:
    """(b) climate round trips on the (2, 2) mesh under both codecs
    against the main path's solo artifacts and g; (c) a (2, 1, 2) mesh
    on nyx ``nyx_edge``^3 and 130x127x129 against solo artifacts; (d) a
    ``CompressionService`` over the (2, 2) mesh on 4 climate timesteps
    against the batch phase's solo artifacts, with its shard stats and
    ``shard_timings``; (e) the launcher with ``--devices 4``; (f) the
    (2, 2) mesh on distinct cards when there are two or more. Launches
    counted from 0 around each leg."""
    import contextlib
    import io
    import torch
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_preserving_mss)
    from repro_torch.core import fixes, verify_preservation
    from repro_torch.data import synthetic_field
    from repro_torch.distributed import shardfix as sf
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_block_mesh
    from repro_torch.serve import CompressionService, ServiceConfig
    totals = dict.fromkeys(COUNTERS, 0)

    def count(launches):
        for k, v in launches.items():
            totals[k] += v

    block = one_card_mesh((2, 2))
    xi = 1e-3 * float(np.ptp(climate))
    round_trips = {}
    for entropy in ("deflate", "device-pack"):
        solo, g_solo = MAIN_ARTS[("climate", entropy)]
        reset_launches()
        art, t_c = timed(lambda: compress_preserving_mss(
            climate, xi, entropy=entropy, mesh=block, device=DEVICE))
        lc = read_launches()
        reset_launches()
        g, t_d = timed(lambda: decompress_preserving_mss(art, mesh=block,
                                                         device=DEVICE))
        ld = read_launches()
        count(lc)
        count(ld)
        tag = f"sharded climate {entropy}"
        if not (same_artifact(art, solo) and art.backend == "sharded"):
            raise AssertionError(f"{tag}: artifact differs from the main "
                                 "path's solo artifact")
        if not np.array_equal(g, g_solo):
            raise AssertionError(f"{tag}: g differs from the solo decode")
        rep = verify_preservation(climate, g, xi, device=DEVICE)
        if not (rep["mss_preserved"] and rep["bound_ok"]):
            raise AssertionError(f"{tag}: MSS not preserved: {rep}")
        packed = int(entropy == "device-pack")
        if (lc["lorenzo"], lc["pack"], ld["unpack"]) != (4, packed, packed):
            raise AssertionError(f"{tag}: launches {lc} / {ld}")
        round_trips[entropy] = dict(seconds_compress=t_c,
                                    seconds_decompress=t_d,
                                    fix_iters=art.fix_iters,
                                    launches_compress=lc,
                                    launches_decompress=ld)
    emit({"phase": "sharded_round_trip", "field": "climate",
          "mesh": block.shape, "artifacts_identical": True,
          "g_identical": True, "mss_preserved": True,
          "runs": round_trips})

    mesh3 = one_card_mesh((2, 1, 2))
    three = {}
    for shape in ((nyx_edge,) * 3, (130, 127, 129)):
        f = synthetic_field("nyx", shape)
        xf = 1e-3 * float(np.ptp(f))
        solo = compress_preserving_mss(f, xf, device=DEVICE)
        reset_launches()
        art, secs = timed(lambda: compress_preserving_mss(
            f, xf, mesh=mesh3, device=DEVICE))
        count(read_launches())
        g = decompress_preserving_mss(art, mesh=mesh3, device=DEVICE)
        if not (same_artifact(art, solo) and np.array_equal(
                g, decompress_preserving_mss(solo, device=DEVICE))):
            raise AssertionError(f"sharded {shape} on {mesh3.shape}: "
                                 "artifact or g differs from the solo one")
        three["x".join(map(str, shape))] = dict(seconds=secs,
                                                fix_iters=art.fix_iters)
    emit({"phase": "sharded_three_axis", "mesh": mesh3.shape,
          "artifacts_identical": True, "g_identical": True, "runs": three})

    solo = BATCH_SOLO[("climate", "deflate")][:len(steps)]
    xis = [1e-3 * float(np.ptp(f)) for f in steps]
    reset_launches()
    with CompressionService(ServiceConfig(window=8, max_batch=4,
                                          mesh=block, device=DEVICE)) as svc:
        arts, t_svc = timed(lambda: [fut.result() for fut in [
            svc.submit_compress(f, x) for f, x in zip(steps, xis)]])
        st = svc.stats()["compress"]
        probe = svc.shard_timings(refresh=True)
    count(read_launches())
    for i, (a, b) in enumerate(zip(arts, solo)):
        if not same_artifact(a, b):
            raise AssertionError(f"sharded service request {i}: artifact "
                                 "differs from the solo call")
    plan = sf.halo_plan(steps[0].shape, np.float32, block)
    iters = sum(a.fix_iters for a in arts)
    want = {k: v * iters for k, v in plan.items()}
    if st["shard"]["halo_bytes_by_axis"] != want:
        raise AssertionError(f"sharded service: shard stats {st['shard']} "
                             f"!= halo_plan x iterations {want}")
    if not probe or not {"t_interior_s", "t_exchange_s",
                         "t_full_s"} <= set(probe):
        raise AssertionError(f"sharded service: shard_timings {probe}")
    emit({"phase": "sharded_service", "requests": len(arts),
          "artifacts_identical": True, "seconds": t_svc,
          "shard": st["shard"], "fix_modes": st["fix_modes"],
          "padded_members": st["padded_members"], "shard_timings": probe})

    argv = ["--devices", "4", "--fields", "16", "--shape", launcher_shape,
            "--verify"]
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, secs = timed(lambda: serve.main(argv, device=DEVICE))
    count(read_launches())
    lines = buf.getvalue().strip().splitlines()
    if not (lines and lines[-1] == "OK"
            and any(ln.startswith("# verified") for ln in lines)
            and any("serving over 4 blocks" in ln for ln in lines)
            and all(a.backend == "sharded" for a in out)):
        raise AssertionError(f"sharded launcher {argv}: {lines}")
    emit({"phase": "sharded_launcher", "argv": argv, "seconds": secs,
          "verified": True, "printout": lines})

    cards = torch.cuda.device_count()
    if cards >= 2:
        f = synthetic_field("nyx", (nyx_edge,) * 3)
        xf = 1e-3 * float(np.ptp(f))
        ft = torch.from_numpy(f).cuda()
        topo = fixes.field_topology(ft, xf)
        f_hat = ft + 0.5 * xf * torch.sin(ft)
        g_ref, it_ref, _ = fixes.fused_fix(f_hat, topo, backend="cuda")
        spread = make_block_mesh((2, 2), devices=[f"cuda:{i % cards}"
                                                  for i in range(4)])
        for ov in (False, True):
            reset_launches()
            g, it, ok = fixes.fused_fix(
                f_hat, topo, mesh=spread,
                backend=sf.ShardedBackend(mesh=spread, overlap=ov))
            count(read_launches())
            if not (ok and it == it_ref and torch.equal(g, g_ref)):
                raise AssertionError(f"sharded on {cards} cards overlap={ov}:"
                                     " g or iterations differ")
        emit({"phase": "sharded_multi_card", "ran": True, "cards": cards,
              "g_identical": True})
    else:
        emit({"phase": "sharded_multi_card", "ran": False, "cards": cards,
              "reason": "fewer than two visible cards: the blocks of every "
                        "other leg share one card"})
    torch.cuda.empty_cache()
    return totals


#: (field, entropy) -> the batch phase's solo artifacts
BATCH_SOLO: dict = {}


def phase_batch(label: str, fields, xis, entropy: str, batchings=()) -> dict:
    """``compress_preserving_mss_batch`` against solo calls (every
    artifact byte-identical), ``decompress_artifact_batch`` against solo
    ``decompress_preserving_mss`` (bitwise), ``verify_preservation_batch``
    (every member preserved and in bound); launches counted from 0 around
    each batch call. ``batchings``: ``derive_edits_batch`` options run
    on the members' (f, f_hat) pairs, each member bitwise its solo
    ``derive_edits``."""
    import torch
    from repro_torch.compress import (compress_preserving_mss,
                                      compress_preserving_mss_batch,
                                      decompress_artifact_batch,
                                      decompress_preserving_mss)
    from repro_torch.core import (derive_edits, derive_edits_batch,
                                  verify_preservation_batch)
    B = len(fields)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    arts, t_batch = timed(lambda: compress_preserving_mss_batch(
        fields, xis, entropy=entropy))
    launches_c = read_launches()
    peak = torch.cuda.max_memory_allocated()
    solo, t_solo = timed(lambda: [
        compress_preserving_mss(f, x, entropy=entropy)
        for f, x in zip(fields, xis)])
    BATCH_SOLO[(label, entropy)] = solo
    for i, (a, b) in enumerate(zip(arts, solo)):
        for k in ("base_payload", "edit_payload", "fix_iters", "edit_ratio",
                  "path", "entropy", "base_magic"):
            if getattr(a, k) != getattr(b, k):
                raise AssertionError(f"batch {label} {entropy} member {i}: "
                                     f"{k} differs from the solo call")
    iters = [a.fix_iters for a in arts]
    packed = B if entropy == "device-pack" else 0
    want = {"extrema": sum(iters), "fixpass": sum(iters), "lorenzo": B,
            "pack": packed, "unpack": 0, "flash": 0}
    if launches_c != want:
        raise AssertionError(f"batch {label} {entropy}: compress launches "
                             f"{launches_c} != {want}")
    reset_launches()
    gs, t_dec = timed(lambda: decompress_artifact_batch(arts))
    launches_d = read_launches()
    if launches_d["unpack"] != packed:
        raise AssertionError(f"batch {label} {entropy}: decompress launches "
                             f"{launches_d}")
    g_solo, t_dec_solo = timed(lambda: [decompress_preserving_mss(a)
                                        for a in arts])
    for i, (x, y) in enumerate(zip(gs, g_solo)):
        if not np.array_equal(x, y):
            raise AssertionError(f"batch {label} {entropy} member {i}: "
                                 "batch decode differs from the solo one")
    verdicts = verify_preservation_batch(np.stack(fields), np.stack(gs), xis)
    if not all(v["mss_preserved"] and v["bound_ok"] for v in verdicts):
        raise AssertionError(f"batch {label} {entropy}: {verdicts}")
    strategies = {}
    if batchings:
        from repro_torch.compress import sz_decompress
        f_hats = np.stack([sz_decompress(a.base_payload) for a in arts])
        solo_res = [derive_edits(f, fh, x)
                    for f, fh, x in zip(fields, f_hats, xis)]
        for kw in batchings:
            reset_launches()
            res, secs = timed(lambda: derive_edits_batch(
                np.stack(fields), f_hats, xis, **kw))
            for i, (r, s_) in enumerate(zip(res, solo_res)):
                if not (np.array_equal(r.g, s_.g) and r.iters == s_.iters
                        and np.array_equal(r.edits_idx, s_.edits_idx)):
                    raise AssertionError(f"batch {label} {kw} member {i}: "
                                         "differs from solo derive_edits")
            strategies[kw["batching"] + str(kw.get("compact_every", ""))] = \
                dict(seconds=secs, extrema=read_launches()["extrema"],
                     iters=[r.iters for r in res])
        if len(set(iters)) < 2:
            raise AssertionError(f"batch {label}: members converged at one "
                                 f"iteration count {iters}")
    emit({"phase": "batch", "field": label, "entropy": entropy,
          "members": B, "shape": list(fields[0].shape),
          "xi": [float(x) for x in xis], "fix_iters": iters,
          "artifacts_identical": True, "g_identical": True,
          "mss_preserved": True, "bound_ok": True,
          "payload_bytes": sum(len(a.base_payload) for a in arts),
          "edit_bytes": sum(len(a.edit_payload) for a in arts),
          "launches_compress": launches_c, "launches_decompress": launches_d,
          "launches_per_member": {k: v / B for k, v in launches_c.items()},
          "seconds": {"compress_batch": t_batch, "compress_solo": t_solo,
                      "decompress_batch": t_dec,
                      "decompress_solo": t_dec_solo},
          "peak_device_bytes": peak, "derive_edits_batch": strategies})
    torch.cuda.empty_cache()
    return launches_c


def phase_host_path(label: str, f, xi: float, over_int32: bool = False
                    ) -> None:
    """The host path: ``device_path=False`` gives the device path's bytes
    (its fix loop still on the card); a field outside the int32 device
    range takes the host path under "auto" and decodes with its MSS
    preserved."""
    import torch
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_preserving_mss)
    from repro_torch.core import verify_preservation
    reset_launches()
    host, secs = timed(lambda: compress_preserving_mss(
        f, xi, device_path="auto" if over_int32 else False))
    launches = read_launches()
    if host.path != "host" or launches["lorenzo"] != 0 \
            or launches["extrema"] < host.fix_iters:
        raise AssertionError(f"host path {label}: path {host.path}, "
                             f"launches {launches}")
    rec = {"phase": "host_path", "field": label, "shape": list(f.shape),
           "dtype": str(f.dtype), "xi": xi, "fix_iters": host.fix_iters,
           "launches": launches, "seconds_host": secs,
           "payload_bytes": len(host.base_payload),
           "edit_bytes": len(host.edit_payload)}
    if over_int32:
        g = decompress_preserving_mss(host)
        v = verify_preservation(f, g, xi)
        if not (v["mss_preserved"] and v["bound_ok"]):
            raise AssertionError(f"host path {label}: {v}")
        rec.update(auto_took_host_path=True, mss_preserved=True,
                   bound_ok=True)
    else:
        dev, secs_dev = timed(lambda: compress_preserving_mss(f, xi))
        if (host.base_payload, host.edit_payload, host.fix_iters) != (
                dev.base_payload, dev.edit_payload, dev.fix_iters):
            raise AssertionError(f"host path {label}: bytes differ from "
                                 "the device path's")
        rec.update(bytes_equal_device_path=True, seconds_device=secs_dev)
    emit(rec)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3e-3i: zfplike, paper mode, the service, its launcher, the guards
# ---------------------------------------------------------------------------

def same_artifact(a, b) -> bool:
    return (a.base_payload, a.edit_payload, a.fix_iters) == (
        b.base_payload, b.edit_payload, b.fix_iters)


def phase_zfplike(label: str, f, xi: float) -> dict:
    """A ``codec="zfplike"`` round trip on the card: the host ZFJ2 codec,
    the fix loop on the card (the worklist at >= 64 slabs), the host MSE1
    encode; MSS preserved and bound held; launches counted from 0."""
    import torch
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_preserving_mss,
                                      overall_compression_ratio)
    from repro_torch.core import backend, verify_preservation
    torch.cuda.synchronize()
    reset_launches()
    backend.worklist_spans = 0
    art, t_comp = timed(lambda: compress_preserving_mss(f, xi,
                                                        codec="zfplike"))
    g, t_dec = timed(lambda: decompress_preserving_mss(art))
    launches = read_launches()
    spans = backend.worklist_spans
    report = verify_preservation(f, g, xi)
    if not (report["mss_preserved"] and report["bound_ok"]):
        raise AssertionError(f"zfplike {label}: {report}")
    if art.base_magic != "ZFJ2" or art.path != "host":
        raise AssertionError(f"zfplike {label}: {art.base_magic} on "
                             f"{art.path}")
    check_fix_launches(f"zfplike {label}", launches, art.fix_iters,
                       f.shape, spans)
    if any(launches[k] for k in ("lorenzo", "pack", "unpack", "flash")):
        raise AssertionError(f"zfplike {label}: launches {launches}")
    emit({"phase": "zfplike", "field": label, "shape": list(f.shape),
          "dtype": str(f.dtype), "xi": xi, "fix_iters": art.fix_iters,
          "edit_ratio": art.edit_ratio,
          "compression_ratio": overall_compression_ratio(f, art),
          "payload_bytes": len(art.base_payload),
          "edit_bytes": len(art.edit_payload),
          "mss_preserved": True, "bound_ok": True,
          "max_abs_err": report["max_abs_err"], "launches": launches,
          "worklist_spans": spans,
          "seconds": {"zfp_round_trip": art.t_base, "fix": art.t_fix,
                      "edit_encode": t_comp - art.t_base - art.t_fix,
                      "compress": t_comp, "decompress": t_dec}})
    torch.cuda.empty_cache()
    return launches


def phase_zfplike_parity(n: int) -> None:
    """zfplike artifacts under the ``cuda`` and ``reference`` backends on
    the card: the same bytes and iterations."""
    from repro_torch.compress import compress_preserving_mss
    from repro_torch.data import synthetic_field
    f = synthetic_field("nyx", (n, n, n))
    xi = 1e-3 * float(np.ptp(f))
    a = compress_preserving_mss(f, xi, codec="zfplike", backend="cuda")
    b = compress_preserving_mss(f, xi, codec="zfplike", backend="reference")
    if not same_artifact(a, b):
        raise AssertionError("zfplike parity: artifacts differ between "
                             "backends")
    emit({"phase": "zfplike_parity", "shape": [n, n, n],
          "fix_iters": a.fix_iters, "bytes_identical": True})


def phase_paper(label: str, f, xi: float) -> dict:
    """``mode="paper"`` round trip on the card, and the paper loop beside
    the fused loop on the same (f, f_hat); launches counted from 0 (the
    paper loop runs on torch ops)."""
    import torch
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_preserving_mss,
                                      sz_decompress)
    from repro_torch.core import derive_edits, verify_preservation
    reset_launches()
    art, t_comp = timed(lambda: compress_preserving_mss(f, xi, mode="paper"))
    g, t_dec = timed(lambda: decompress_preserving_mss(art))
    launches = read_launches()
    report = verify_preservation(f, g, xi)
    if not (report["mss_preserved"] and report["bound_ok"]):
        raise AssertionError(f"paper {label}: {report}")
    if any(launches[k] for k in ("extrema", "fixpass", "lorenzo", "pack",
                                 "flash")):
        raise AssertionError(f"paper {label}: launches {launches}")
    f_hat = sz_decompress(art.base_payload)
    paper, t_paper = timed(lambda: derive_edits(f, f_hat, xi, mode="paper"))
    fused, t_fused = timed(lambda: derive_edits(f, f_hat, xi, mode="fused"))
    if paper.iters != art.fix_iters or not (paper.converged
                                            and fused.converged):
        raise AssertionError(f"paper {label}: {paper.iters} iterations, "
                             f"artifact {art.fix_iters}")
    emit({"phase": "paper_mode", "field": label, "shape": list(f.shape),
          "dtype": str(f.dtype), "xi": xi, "outer_iters": art.fix_iters,
          "fused_iters": fused.iters, "edit_ratio": art.edit_ratio,
          "fused_edit_ratio": fused.edit_ratio,
          "mss_preserved": True, "bound_ok": True, "launches": launches,
          "seconds": {"compress": t_comp, "decompress": t_dec,
                      "paper_loop": t_paper, "fused_loop": t_fused}})
    torch.cuda.empty_cache()
    return launches


def phase_paper_card_vs_cpu() -> None:
    """g, iterations and convergence of ``derive_edits(mode="paper")``
    bitwise the same on the card and on the CPU."""
    from repro_torch.core import derive_edits
    from repro_torch.data import synthetic_field
    out = {}
    for name, shape in (("nyx", (32, 32, 32)), ("climate", (60, 70))):
        f = synthetic_field(name, shape)
        xi = 1e-2 * float(np.ptp(f))
        rng = np.random.default_rng(5)
        f_hat = (f + rng.uniform(-xi, xi, f.shape)).astype(f.dtype)
        f_hat = np.clip(f_hat, f - xi, f + xi)
        card = derive_edits(f, f_hat, xi, mode="paper")
        cpu = derive_edits(f, f_hat, xi, mode="paper", device="cpu")
        if not (np.array_equal(card.g, cpu.g) and card.iters == cpu.iters
                and card.converged == cpu.converged):
            raise AssertionError(f"paper card vs cpu {shape}: differ")
        out["x".join(map(str, shape))] = card.iters
    emit({"phase": "paper_card_vs_cpu", "iters": out, "g_identical": True})


def phase_service(steps, members, member_xis, zfp_fields) -> dict:
    """One ``CompressionService(window=8, max_batch=4)``: the climate
    timesteps under deflate then device-pack, the nyx members with their
    bounds, two zfplike requests, then every artifact decompressed
    through the service. Each artifact byte-identical to its solo call,
    each g equal to the solo decode; the stream's wall time beside the
    solo loop's."""
    import torch
    from repro_torch.compress import (calibrate, compress_preserving_mss,
                                      decompress_preserving_mss, pipeline)
    from repro_torch.core.backend import resolve_backend
    from repro_torch.serve import CompressionService, ServiceConfig
    reqs = ([(f, 1e-3 * float(np.ptp(f)), "szlike", "deflate")
             for f in steps]
            + [(f, 1e-3 * float(np.ptp(f)), "szlike", "device-pack")
               for f in steps]
            + [(f, x, "szlike", "deflate")
               for f, x in zip(members, member_xis)]
            + [(f, 1e-3 * float(np.ptp(f)), "zfplike", "deflate")
               for f in zfp_fields])
    torch.cuda.synchronize()
    reset_launches()
    cfg = ServiceConfig(window=8, max_batch=4)
    with CompressionService(cfg) as svc:
        def run():
            futs = [svc.submit_compress(f, x, codec=c, entropy=e)
                    for f, x, c, e in reqs]
            return [fut.result() for fut in futs]
        arts, t_stream = timed(run)
        gs, t_stream_dec = timed(lambda: [
            fut.result() for fut in
            [svc.submit_decompress(a) for a in arts]])
        svc.flush()
        st = svc.stats()
    launches = read_launches()
    for k in ("extrema", "fixpass", "lorenzo", "pack", "unpack"):
        if launches[k] == 0:
            raise AssertionError(f"service: no {k} launch ({launches})")
    solo, t_solo = timed(lambda: [
        compress_preserving_mss(f, x, codec=c, entropy=e)
        for f, x, c, e in reqs])
    for i, (a, b) in enumerate(zip(arts, solo)):
        if not same_artifact(a, b):
            raise AssertionError(f"service request {i}: artifact differs "
                                 "from the solo call")
    g_solo, t_solo_dec = timed(lambda: [decompress_preserving_mss(a)
                                        for a in solo])
    for i, (x, y) in enumerate(zip(gs, g_solo)):
        if not np.array_equal(x, y):
            raise AssertionError(f"service request {i}: decode differs "
                                 "from the solo decode")
    # the device stage of one 4-member climate batch run solo, in the
    # mode the service's policy picked for it
    be = resolve_backend("auto", steps[0].shape, torch.float32, DEVICE)
    cal = calibrate.fused_fix_threshold(be, np.float32, DEVICE)
    four = steps[:4]
    xi4 = np.asarray([1e-3 * float(np.ptp(f)) for f in four])
    steps4 = [pipeline._device_path_reason(f, x)[1] for f, x in
              zip(four, xi4)]
    stage = (pipeline._device_batch_stage
             if four[0].size <= cal.threshold_voxels
             else pipeline._device_pipelined_stage)
    _, t_stage = timed(lambda: stage(four, xi4, be, 512, steps4,
                                     torch.device(DEVICE)))
    c = st["compress"]
    emit({"phase": "service", "requests": len(reqs),
          "artifacts_identical": True, "g_identical": True,
          "launches": launches,
          "seconds": {"stream_compress": t_stream,
                      "solo_compress": t_solo,
                      "stream_decompress": t_stream_dec,
                      "solo_decompress": t_solo_dec,
                      "stream_device_stage": c["t_device_s"],
                      "stream_encode": c["t_encode_s"],
                      "solo_device_stage_climate_x4": t_stage},
          "stats": {leg: {k: st[leg][k] for k in (
              "fields_per_sec", "batches", "batch_occupancy",
              "padded_members", "fix_modes", "cache", "nbytes_h2d",
              "nbytes_d2h", "entropy_codecs", "straggler",
              "max_in_flight")} for leg in ("compress", "decompress")},
          "calibration": {"threshold_voxels": cal.threshold_voxels,
                          "overhead_s": cal.overhead_s,
                          "solo_voxel_s": cal.solo_voxel_s,
                          "batched_voxel_s": cal.batched_voxel_s,
                          "source": cal.source}})
    torch.cuda.empty_cache()
    return launches


def phase_serve_launcher(shape: str) -> dict:
    """``repro_torch.launch.serve.main`` on the card: ``--smoke``, then
    16 nyx fields of ``shape`` (128,128,128) with ``--verify``; its
    printout kept in the record."""
    import contextlib
    import io
    from repro_torch.launch import serve
    totals = dict.fromkeys(COUNTERS, 0)
    runs = {}
    for argv in (["--smoke"],
                 ["--fields", "16", "--shape", shape, "--verify"]):
        reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            arts, secs = timed(lambda: serve.main(argv))
        lines = buf.getvalue().strip().splitlines()
        if not lines or lines[-1] != "OK" or not any(
                ln.startswith("# verified") for ln in lines):
            raise AssertionError(f"serve launcher {argv}: {lines}")
        launches = read_launches()
        for k, v in launches.items():
            totals[k] += v
        runs[" ".join(argv)] = {"seconds": secs, "artifacts": len(arts),
                                "launches": launches, "printout": lines}
    emit({"phase": "serve_launcher", "runs": runs, "verified": True})
    return totals


def phase_guards(fields) -> dict:
    """The transfer guard on the card: a device-pack stream batch under
    ``MSZ_SANITIZERS=1`` completes with the solo call's bytes; the same
    device stage under ``no_transfers`` in this thread completes with
    its audited crossings counted; an untracked ``.item()`` and a
    ``torch.tensor(..., device="cuda")`` raise inside the guard; another
    thread's d2h during the guard does not."""
    import os
    import threading
    import torch
    from repro_torch.compress import (CompressStream, compress_preserving_mss,
                                      pipeline)
    from repro_torch.core.backend import resolve_backend
    from repro_torch.debug import TransferError, no_transfers
    xis = [1e-3 * float(np.ptp(f)) for f in fields]
    reset_launches()
    os.environ["MSZ_SANITIZERS"] = "1"
    try:
        with CompressStream(window=4, max_batch=4, linger_ms=50) as cs:
            futs = [cs.submit(f, x, entropy="device-pack")
                    for f, x in zip(fields, xis)]
            arts = [fut.result() for fut in futs]
            st = cs.stats()
    finally:
        del os.environ["MSZ_SANITIZERS"]
    launches = read_launches()
    for i, (f, x, a) in enumerate(zip(fields, xis, arts)):
        if not same_artifact(a, compress_preserving_mss(
                f, x, entropy="device-pack")):
            raise AssertionError(f"guards: member {i} differs from solo")
    be = resolve_backend("auto", fields[0].shape, torch.float32, DEVICE)
    steps = [pipeline._device_path_reason(f, x)[1]
             for f, x in zip(fields, xis)]
    with no_transfers() as counts:
        pipeline._device_pipelined_stage(fields, np.asarray(xis), be, 512,
                                         steps, torch.device(DEVICE),
                                         entropy="device-pack")
    t = torch.arange(8.0, device=DEVICE)
    raised = {}
    seen = {}

    def worker():
        seen["d2h"] = t.cpu().sum().item()
    with no_transfers():
        for what, fn in (("item", lambda: t.sum().item()),
                         ("tensor_h2d", lambda: torch.tensor(
                             1.0, device=DEVICE))):
            try:
                fn()
                raised[what] = False
            except TransferError:
                raised[what] = True
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=60)
    if not (all(raised.values()) and seen.get("d2h") == 28.0):
        raise AssertionError(f"guards: raised {raised}, worker {seen}")
    emit({"phase": "guards", "stream_batch_completed": True,
          "artifacts_identical": True, "fix_modes": st["fix_modes"],
          "audited": {"h2d": counts.h2d, "d2h": counts.d2h,
                      "h2d_bytes": counts.h2d_bytes,
                      "d2h_bytes": counts.d2h_bytes},
          "raised": raised, "worker_d2h_ok": True, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 4: whole-path parity
# ---------------------------------------------------------------------------

def phase_parity(n: int) -> None:
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_artifact,
                                      decompress_preserving_mss, sz_compress)
    from repro_torch.data import synthetic_field
    from repro_torch.kernels import pack as kp
    f = synthetic_field("nyx", (n, n, n))
    xi = 1e-3 * float(np.ptp(f))
    g_by = {}
    arts = {}
    for entropy in ("deflate", "device-pack"):
        a = compress_preserving_mss(f, xi, backend="cuda", entropy=entropy)
        b = compress_preserving_mss(f, xi, backend="reference",
                                    entropy=entropy)
        for k in ("base_payload", "edit_payload", "fix_iters", "edit_ratio"):
            if getattr(a, k) != getattr(b, k):
                raise AssertionError(
                    f"parity {entropy}: {k} differs between backends")
        before = kp.unpack_launches
        ga = decompress_preserving_mss(a, backend="cuda")
        unpacked = kp.unpack_launches - before
        if unpacked != int(entropy == "device-pack"):
            raise AssertionError(f"parity {entropy}: {unpacked} unpack "
                                 "launches in the device decode")
        gb = decompress_preserving_mss(b, backend="reference")
        if not np.array_equal(ga, gb):
            raise AssertionError(f"parity {entropy}: g differs between "
                                 "backends")
        if not np.array_equal(ga, decompress_artifact(a)):
            raise AssertionError(f"parity {entropy}: device decode differs "
                                 "from host decode")
        if sz_compress(f, xi, entropy=entropy) != a.base_payload:
            raise AssertionError(f"parity {entropy}: host codec payload "
                                 "differs")
        g_by[entropy], arts[entropy] = ga, a
    if not np.array_equal(g_by["deflate"], g_by["device-pack"]):
        raise AssertionError("parity: the two codecs decode to different g")
    if arts["deflate"].edit_payload != arts["device-pack"].edit_payload:
        raise AssertionError("parity: the two codecs carry different edits")
    emit({"phase": "parity", "shape": [n, n, n],
          "fix_iters": arts["deflate"].fix_iters,
          "entropies": ["deflate", "device-pack"],
          "payload_identical": True, "g_identical": True,
          "host_codec_identical": True, "codecs_same_g": True,
          "codecs_same_edits": True,
          "payload_bytes": {k: len(a.base_payload) for k, a in arts.items()}})


# ---------------------------------------------------------------------------
# phase 2, flash: the attention kernel against its plain version
# ---------------------------------------------------------------------------

#: (B, S, H, Hk, Dh) of the small flash cases: GQA and MHA, one KV head,
#: ragged S, each head width the kernel is built for, and the head
#: layouts of qwen3-moe (64/4 of 128, G 16) and llava (56/8 of 128, G 7)
FLASH_CASES = ((2, 64, 4, 2, 16), (1, 128, 8, 8, 32), (2, 96, 6, 3, 16),
               (1, 64, 2, 1, 64), (2, 1000, 9, 3, 64), (1, 256, 32, 8, 128),
               (2, 130, 64, 4, 128), (2, 130, 56, 8, 128))

#: (B, S, T, H, Hk, Dh, causal) of the cases with S != T: a short query
#: over a longer key range, and whisper's cross-attention layout, 8/8
#: heads of 64 over the 1,500-frame encoder memory, at a ragged query
#: length (S 33; phase 2c holds the shapes phase 7 runs, S 1 and 32)
FLASH_CROSS = ((2, 80, 200, 6, 2, 32, False), (2, 80, 200, 6, 2, 32, True),
               (2, 33, 1500, 8, 8, 64, False))

#: kernel-vs-plain (rtol, atol) by output dtype: both compute in f32 and
#: differ in the order of their sums; in bf16 both round that f32 result
#: once, so they differ by at most one bf16 ulp, 2^-7 of the value (the
#: atol only covers outputs near 0)
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-5)}

#: the prefill shapes of phase 2b: smollm-135m's 8 x 2048 prefill, and one
#: sequence at the repo's prefill_32k length
FLASH_MAIN = ((8, 2048, 9, 3, 64), (1, 32768, 9, 3, 64))

#: a head width of 128, timed beside the prefill shapes: granite-8b's 32/8
#: heads (deepseek-coder-33b's width too) over 2 x 4096 tokens, and the
#: 4 x 2048 prefills of phase 7's qwen3-moe (64/4 heads) and llava (56/8)
FLASH_WIDE = ((2, 4096, 32, 8, 128), (4, 2048, 64, 4, 128),
              (4, 2048, 56, 8, 128))

#: hymba-1.5b's global layers in phase 7: 8 x 2048 tokens, 25/5 heads of
#: 64 (G 5), timed beside the others
FLASH_HYMBA = ((8, 2048, 25, 5, 64),)

#: one model shard's heads of phase 11e's granite-8b step on a (1, 4)
#: mesh: 32/8 heads of 128 split four ways over 4 x 2048 tokens
FLASH_TP = ((4, 2048, 8, 2, 128),)


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def flash_inputs(B, S, T, H, Hk, Dh, dtype, gen):
    """normal(0, 1) q (B, S, H, Dh) and k, v (B, T, Hk, Dh) on the card."""
    import torch

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return draw(B, S, H, Dh), draw(B, T, Hk, Dh), draw(B, T, Hk, Dh)


def within_flash_tol(got, want) -> bool:
    import torch
    rtol, atol = FLASH_TOL[_dtype_name(want.dtype)]
    return torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)


def check_flash(label: str, q, k, v, causal: bool) -> tuple:
    """The kernel against the plain version on one input; returns the
    largest difference and the plain version's output."""
    import torch
    from repro_torch.kernels import flash as kfl
    got = kfl.flash_attention(q, k, v, causal=causal)
    want = kfl.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if got.dtype != q.dtype or got.shape != q.shape:
        raise AssertionError(f"flash {label}: output {got.dtype} "
                             f"{tuple(got.shape)}")
    if not within_flash_tol(got, want):
        raise AssertionError(f"flash {label}: differs from the plain "
                             f"version by {max_abs_diff([got], [want])}")
    return max_abs_diff([got], [want]), want


def phase_flash_small(seed: int) -> None:
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(B, S, S, H, Hk, Dh, c) for (B, S, H, Hk, Dh) in FLASH_CASES
             for c in (True, False)]
    cases += list(FLASH_CROSS)
    for B, S, T, H, Hk, Dh, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(B, S, T, H, Hk, Dh, dtype, gen)
            label = f"{(B, S, T, H, Hk, Dh)} causal={causal}"
            err, _ = check_flash(label, q, k, v, causal)
            emit({"phase": "kernels_vs_plain", "case": f"flash {label}",
                  "shape": [B, S, T, H, Hk, Dh], "causal": causal,
                  "dtype": _dtype_name(dtype), "max_abs_err": err,
                  "rtol_atol": FLASH_TOL[_dtype_name(dtype)]})


def phase_flash_families(seed: int) -> None:
    """Phase 2c: the kernel against its plain version, f32 and bf16, at
    every shape phase 7's serving runs give it (``family_flash_calls`` of
    each of ``LM_FAMILIES``): whisper's encoder, decoder and
    cross-attention, the qwen3-moe and llava prefills."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for arch, _, batch, prompt_len, n_steps in LM_FAMILIES:
        shapes = family_flash_calls(get_config(arch), batch, prompt_len,
                                    n_steps)
        for B, S, T, H, Hk, Dh, causal in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = flash_inputs(B, S, T, H, Hk, Dh, dtype, gen)
                label = f"{(B, S, T, H, Hk, Dh)} causal={causal}"
                err, _ = check_flash(f"{arch} {label}", q, k, v, causal)
                emit({"phase": "kernels_vs_plain",
                      "case": f"flash {arch} {label}", "model": arch,
                      "shape": [B, S, T, H, Hk, Dh], "causal": causal,
                      "dtype": _dtype_name(dtype), "max_abs_err": err,
                      "rtol_atol": FLASH_TOL[_dtype_name(dtype)]})
                del q, k, v
        torch.cuda.empty_cache()


def phase_sass() -> None:
    """The built flash library's SASS: each bf16 variant must issue
    tensor-core instructions (HMMA); the flash and stencil kernels'
    registers and spills beside it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash as kfl
    hmma = _build.sass_counts("flash", "HMMA")
    bf16 = {fn: n for fn, n in hmma.items() if "flash_bf16_mma" in fn}
    emit({"phase": "sass", "source": "flash", "hmma": hmma,
          "ptxas": _build.ptxas_summary(("flash", "fixpass", "extrema",
                                         "lorenzo", "pack"))})
    if len(bf16) != len(kfl.HEAD_DIMS) or not all(bf16.values()):
        raise AssertionError(f"flash: the bf16 variants issue no HMMA: "
                             f"{bf16}")


def flash_bound(B, S, T, H, Hk, Dh, itemsize: int) -> tuple:
    """(bound_ms, bound_by, flops, bytes) of one causal attention forward:
    the larger of the unmasked (q, k) pairs' 4 Dh FLOPs each over the
    bf16 tensor rate and q, k, v read once and o written once over HBM."""
    pairs = sum(min(i + 1, T) for i in range(S))
    flops = 4 * B * H * Dh * pairs
    nbytes = itemsize * (2 * B * S * H * Dh + 2 * B * T * Hk * Dh)
    t_ops = flops / BF16_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = ("operations", t_ops) if t_ops >= t_bytes else ("bytes", t_bytes)
    return by[1], by[0], flops, nbytes


def phase_flash_main(reps: int, seed: int) -> dict:
    """The kernel at the prefill shapes, ``FLASH_WIDE``, ``FLASH_HYMBA``
    and ``FLASH_TP``, bf16 causal: checked against the plain version
    (a ``kernels_vs_plain`` record for ``FLASH_TP``), then timed beside
    it and beside one ``scaled_dot_product_attention`` call (the
    yardstick)."""
    import torch
    from repro_torch.kernels import flash as kfl
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for B, S, H, Hk, Dh in FLASH_MAIN + FLASH_WIDE + FLASH_HYMBA + FLASH_TP:
        q, k, v = flash_inputs(B, S, S, H, Hk, Dh, torch.bfloat16, gen)
        err, want = check_flash(f"main {(B, S, H, Hk, Dh)}", q, k, v, True)
        if (B, S, H, Hk, Dh) in FLASH_TP:
            emit({"phase": "kernels_vs_plain",
                  "case": f"flash tp shard {(B, S, S, H, Hk, Dh)} causal=True",
                  "model": "granite-8b", "shape": [B, S, S, H, Hk, Dh],
                  "causal": True, "dtype": "bfloat16", "max_abs_err": err,
                  "rtol_atol": FLASH_TOL["bfloat16"]})
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib = lib.transpose(1, 2)
        lib_err = max_abs_diff([lib], [want])
        lib_ok = within_flash_tol(lib, want)
        # SDPA rounds p to bf16 before p . v: at the prefill shapes the
        # check must tell it from the kernel, or it could not catch a
        # kernel that did the same
        if lib_ok and (B, S, H, Hk, Dh) in FLASH_MAIN:
            raise AssertionError(f"flash main {(B, S)}: SDPA passes the "
                                 "kernel's tolerance; the check is too weak")
        del lib, want
        ms = cuda_time_ms(lambda: kfl.flash_attention(q, k, v), reps)
        plain_ms = cuda_time_ms(lambda: kfl.flash_attention_plain(q, k, v),
                                max(reps // 2, 3), warmup=1)
        library_ms = cuda_time_ms(
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), reps)
        bound_ms, bound_by, flops, nbytes = flash_bound(B, S, S, H, Hk, Dh,
                                                        2)
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        out[(B, S, H, Hk, Dh)] = rec
        emit({"phase": "kernel_timing", "kernel": "flash",
              "shape": [B, S, H, Hk, Dh], "dtype": "bfloat16",
              "causal": True, "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "flops": flops, "bytes": nbytes,
              "tflops": flops / ms / 1e9, "max_abs_err": err,
              "library_max_abs_err": lib_err, "library_within_tol": lib_ok})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: LM serving
# ---------------------------------------------------------------------------

def serve_run(cfg, params, prompt, n_steps: int, extra=None):
    """``make_prefill`` over ``prompt`` (and the ``extra`` inputs: llava's
    ``image_embeds``, whisper's ``frames``) then ``n_steps`` greedy
    ``make_serve_step`` calls. Returns the logits (prefill's last, then
    each step's), the generated tokens (B, 1 + n_steps), the prefill
    seconds and each step's milliseconds (device synced)."""
    import torch
    from repro_torch.serve import make_prefill, make_serve_step
    B, S = prompt.shape
    S += cfg.n_img_tokens if extra and "image_embeds" in extra else 0
    sync = torch.cuda.synchronize if prompt.is_cuda else (lambda: None)
    prefill = make_prefill(cfg, max_len=S + n_steps)
    step = make_serve_step(cfg)
    sync()
    t0 = time.perf_counter()
    cache, last = prefill(params, {"tokens": prompt, **(extra or {})})
    sync()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
    logits, toks, step_ms = [last], [tok], []
    for i in range(n_steps):
        t1 = time.perf_counter()
        tok, lg, cache = step(params, cache, tok, S + i)
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        logits.append(lg)
        toks.append(tok)
    return logits, torch.cat(toks, dim=1), prefill_s, step_ms


def phase_lm_serve(batch: int, prompt_len: int, n_steps: int,
                   seed: int) -> int:
    """smollm-135m at full width and depth, bf16, through the serving
    entry points; returns the flash launches of the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("smollm-135m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                              .astype(np.int32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, toks, prefill_s, step_ms = serve_run(cfg, params, prompt,
                                                 n_steps)
    launches = read_launches()
    want = dict.fromkeys(COUNTERS, 0)
    want["flash"] = cfg.n_layers
    if launches != want:
        raise AssertionError(f"lm_serve: launches {launches} != {want}")
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    if not finite:
        raise AssertionError("lm_serve: non-finite logits")
    if tuple(logits[0].shape) != (batch, 1, cfg.vocab) or \
            tuple(toks.shape) != (batch, 1 + n_steps):
        raise AssertionError(f"lm_serve: logits {tuple(logits[0].shape)}, "
                             f"tokens {tuple(toks.shape)}")
    decode_s = sum(step_ms) / 1e3
    emit({"phase": "lm_serve", "model": cfg.name, "dtype": cfg.dtype,
          "n_layers": cfg.n_layers, "batch": batch,
          "prompt_len": prompt_len, "decode_steps": n_steps,
          "max_len": prompt_len + n_steps,
          "n_params": sum(t.numel() for v in params.values() for t in
                          (v.values() if isinstance(v, dict) else (v,))),
          "launches": launches, "prefill_s": prefill_s,
          "decode_ms_per_step": statistics.median(step_ms),
          "decode_ms_mean": sum(step_ms) / n_steps,
          "decode_ms_first": step_ms[0],
          "generated_tokens": batch * (1 + n_steps),
          "tokens_per_s": batch * (1 + n_steps) / (prefill_s + decode_s),
          "decode_tokens_per_s": batch * n_steps / decode_s,
          "prefill_tokens_per_s": batch * prompt_len / prefill_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "logits_finite": finite,
          "first_tokens_request0": toks[0, :8].tolist()})
    del params, logits
    torch.cuda.empty_cache()
    return launches["flash"]


def phase_lm_parity(seed: int, batch: int = 2, prompt_len: int = 128,
                    n_steps: int = 8) -> None:
    """smollm-135m at 2 layers in f32, one set of weights: the card (the
    flash kernel) against the CPU (the plain versions)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.kernels import flash as kfl
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2,
                              dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gpu = params_from_numpy(params_to_numpy(cpu), cfg, "cuda")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                              .astype(np.int32))
    before = kfl.launches
    lg_c, tk_c, _, _ = serve_run(cfg, cpu, prompt, n_steps)
    lg_g, tk_g, _, _ = serve_run(cfg, gpu, prompt.cuda(), n_steps)
    if kfl.launches - before != cfg.n_layers:
        raise AssertionError(f"lm_parity: {kfl.launches - before} flash "
                             f"launches on the card, {cfg.n_layers} expected")
    errs = [max_abs_diff([g.cpu()], [c]) for g, c in zip(lg_g, lg_c)]
    for i, (g, c) in enumerate(zip(lg_g, lg_c)):
        if not torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"lm_parity: logits of call {i} differ by "
                                 f"{errs[i]} (tolerance 1e-4)")
    if not torch.equal(tk_g.cpu(), tk_c):
        raise AssertionError("lm_parity: greedy tokens differ")
    emit({"phase": "lm_parity", "model": cfg.name, "n_layers": cfg.n_layers,
          "dtype": cfg.dtype, "batch": batch, "prompt_len": prompt_len,
          "decode_steps": n_steps, "prefill_max_abs_err": errs[0],
          "decode_max_abs_err": max(errs[1:]), "tol": 1e-4,
          "tokens_equal": True, "tokens_request0": tk_c[0].tolist()})


# ---------------------------------------------------------------------------
# phases 7 and 8: the MoE, gemma2, llava and whisper families
# ---------------------------------------------------------------------------

#: phase 7's models: (arch, layers kept (None: all), requests, prompt
#: tokens, decode steps). llava's 1,472 tokens follow 576 image
#: embeddings (2,048 positions); whisper's 32-token decoder prompts
#: attend over 1,500 frame embeddings
LM_FAMILIES = (("qwen3-moe-235b-a22b", 8, 4, 2048, 16),
               ("gemma2-9b", None, 2, 8192, 16),
               ("llava-next-34b", 8, 4, 1472, 16),
               ("whisper-base", None, 8, 32, 32),
               ("xlstm-1.3b", None, 8, 2048, 16),
               ("hymba-1.5b", None, 8, 2048, 16))


def family_flash_calls(cfg, batch: int, prompt_len: int,
                       n_steps: int) -> collections.Counter:
    """The flash calls of one ``serve_run``, as a count of each
    (B, S, T, H, Hk, Dh, causal): every plain causal or full attention of
    the prefill (one a layer; whisper's encoder self-attention over its
    frames, its decoder's causal self-attention and its cross-attention
    over the encoder memory), and whisper's cross-attention at every
    decode step; hymba's layers whose window covers the prompt (its
    global layers), xLSTM none. Decode self-attention (``q_offset`` > 0),
    gemma2's softcapped attention and a window that masks go to the
    chunked torch path."""
    from repro_torch.models import window_schedule
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    calls = collections.Counter()
    if cfg.family == "ssm":
        return calls
    if cfg.family == "hybrid":
        S = prompt_len
        calls[(batch, S, S, H, Hk, Dh, True)] += int(
            (window_schedule(cfg) >= S).sum())
        return calls
    if cfg.enc_dec:
        Te = cfg.enc_positions
        calls[(batch, Te, Te, H, Hk, Dh, False)] += cfg.n_enc_layers
        calls[(batch, prompt_len, prompt_len, H, Hk, Dh, True)] += \
            cfg.n_layers
        calls[(batch, prompt_len, Te, H, Hk, Dh, False)] += cfg.n_layers
        calls[(batch, 1, Te, H, Hk, Dh, False)] += cfg.n_layers * n_steps
    elif cfg.attn_softcap is None:
        S = prompt_len + (cfg.n_img_tokens or 0)
        calls[(batch, S, S, H, Hk, Dh, True)] += cfg.n_layers
    return calls


@contextlib.contextmanager
def recording_flash_calls():
    """Count the (B, S, T, H, Hk, Dh, causal) of every call of the flash
    wrapper made inside the block; the wrapper itself runs unchanged."""
    from repro_torch.kernels import flash as kfl
    calls = collections.Counter()
    wrapper = kfl.flash_attention

    def record(q, k, v, *, causal=True):
        B, S, H, Dh = q.shape
        calls[(B, S, k.shape[1], H, k.shape[2], Dh, bool(causal))] += 1
        return wrapper(q, k, v, causal=causal)
    kfl.flash_attention = record
    try:
        yield calls
    finally:
        kfl.flash_attention = wrapper


@contextlib.contextmanager
def recording_moe_load():
    """For each ``layers.moe_ffn`` call inside the block, the share of
    its N*K assignments dropped at capacity and its busiest expert's load
    over the mean, recounted from the router's top-k; ``moe_ffn`` itself
    runs unchanged."""
    import torch
    from repro_torch.models import layers
    loads = []
    moe_ffn = layers.moe_ffn

    def record(x, p, n_experts, top_k, capacity_factor=1.25):
        N = x.shape[0] * x.shape[1]
        probs = torch.softmax(x.reshape(N, -1).float() @ p["router"].float(),
                              dim=-1)
        ids = layers._top_k(probs, top_k)[1]
        count = torch.bincount(ids.reshape(-1), minlength=n_experts)
        cap = int(np.ceil(N * top_k / n_experts * capacity_factor / 8)) * 8
        mean = N * top_k / n_experts
        loads.append({"dropped_share": float((count - cap).clamp_min(0).sum())
                      / (N * top_k), "max_over_mean": float(count.max())
                      / mean, "cap": cap})
        return moe_ffn(x, p, n_experts, top_k, capacity_factor)
    layers.moe_ffn = record
    try:
        yield loads
    finally:
        layers.moe_ffn = moe_ffn


@contextlib.contextmanager
def timing_scans():
    """Seconds spent in each recurrent scan (``layers.mlstm_scan``,
    ``slstm_scan``, ``ssm_scan``) inside the block, on the host clock with
    the card synchronized on both sides of every call; the scans run
    unchanged."""
    import torch
    from repro_torch.models import layers
    names = ("mlstm_scan", "slstm_scan", "ssm_scan")
    seconds = dict.fromkeys(names, 0.0)
    calls = dict.fromkeys(names, 0)
    real = {name: getattr(layers, name) for name in names}

    def timed_scan(name):
        def scan(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return scan
    for name in names:
        setattr(layers, name, timed_scan(name))
    try:
        yield seconds, calls
    finally:
        for name in names:
            setattr(layers, name, real[name])


def family_inputs(cfg, batch: int, prompt_len: int, seed: int):
    """Seeded prompt tokens on the card, and llava's image embeddings or
    whisper's frame embeddings (normal(0, 1), bf16)."""
    import torch
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                              .astype(np.int32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    extra = {}
    if cfg.n_img_tokens:
        extra["image_embeds"] = torch.randn(
            (batch, cfg.n_img_tokens, cfg.d_model), generator=gen,
            device="cuda").to(torch.bfloat16)
    if cfg.enc_dec:
        extra["frames"] = torch.randn(
            (batch, cfg.enc_positions, cfg.d_model), generator=gen,
            device="cuda").to(torch.bfloat16)
    return prompt, extra


def phase_lm_family(arch: str, n_layers, batch: int, prompt_len: int,
                    n_steps: int, seed: int) -> int:
    """One model at its published widths (depth cut to ``n_layers``),
    bf16 with seeded random weights, through ``make_prefill`` and
    ``make_serve_step``; returns its flash launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    full = get_config(arch)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = [t for v in params.values() for t in
              (v.values() if isinstance(v, dict) else (v,))]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompt, extra = family_inputs(cfg, batch, prompt_len, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with recording_flash_calls() as calls, timing_scans() as (scan_s,
                                                               scan_n):
        logits, toks, prefill_s, step_ms = serve_run(cfg, params, prompt,
                                                     n_steps, extra)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # phase 2c held the kernel against its plain version at exactly the
    # shapes of family_flash_calls: the run must have used no other
    want_calls = family_flash_calls(cfg, batch, prompt_len, n_steps)
    if calls != want_calls:
        raise AssertionError(f"lm_family {cfg.name}: flash calls "
                             f"{dict(calls)} != {dict(want_calls)}")
    want = dict.fromkeys(COUNTERS, 0)
    want["flash"] = sum(want_calls.values())
    if launches != want:
        raise AssertionError(f"lm_family {cfg.name}: launches {launches} "
                             f"!= {want}")
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    if not finite:
        raise AssertionError(f"lm_family {cfg.name}: non-finite logits")
    if tuple(logits[0].shape) != (batch, 1, cfg.vocab) or \
            tuple(toks.shape) != (batch, 1 + n_steps):
        raise AssertionError(f"lm_family {cfg.name}: logits "
                             f"{tuple(logits[0].shape)}, tokens "
                             f"{tuple(toks.shape)}")
    rec = {}
    if cfg.moe is not None:
        # the router's load-balancing loss of the same prompt (a forward
        # outside the counted run: the serving entry points return none)
        with recording_moe_load() as loads:
            aux = forward(cfg, params, {"tokens": prompt, **extra},
                          logits_mode="last").aux_loss
        # the loss is summed over layers; a balanced router gives top_k
        # in each layer
        rec["aux_loss"] = float(aux)
        rec["aux_loss_per_layer"] = float(aux) / cfg.n_layers
        rec["moe_capacity"] = loads[0]["cap"]
        rec["moe_dropped_share"] = [d["dropped_share"] for d in loads]
        rec["moe_max_over_mean"] = [d["max_over_mean"] for d in loads]
        if not np.isfinite(rec["aux_loss"]) or rec["aux_loss"] <= 0:
            raise AssertionError(f"lm_family {cfg.name}: aux_loss "
                                 f"{rec['aux_loss']}")
    if cfg.family in ("ssm", "hybrid"):
        # the scans' seconds inside the prefill (the decode steps run
        # no scan), each beside its share of the prefill
        rec["scan_seconds"] = {k: v for k, v in scan_s.items() if scan_n[k]}
        rec["scan_calls"] = {k: v for k, v in scan_n.items() if v}
        rec["scan_share_of_prefill"] = {k: v / prefill_s for k, v in
                                        rec["scan_seconds"].items()}
        rec["sliding_window"] = cfg.sliding_window
    decode_s = sum(step_ms) / 1e3
    positions = prompt_len + (cfg.n_img_tokens if cfg.n_img_tokens else 0)
    emit({"phase": "lm_family", "model": cfg.name, "family": cfg.family,
          "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "n_layers_published": full.n_layers,
          "n_enc_layers": cfg.n_enc_layers, "batch": batch,
          "prompt_len": prompt_len, "image_tokens": cfg.n_img_tokens,
          "frames": cfg.enc_positions if cfg.enc_dec else 0,
          "cached_positions": positions, "decode_steps": n_steps,
          "n_params": n_params, "param_bytes": param_bytes,
          "init_s": init_s, "init_peak_device_bytes": init_peak,
          "launches": launches, "prefill_s": prefill_s,
          "decode_ms_per_step": statistics.median(step_ms),
          "decode_ms_mean": sum(step_ms) / n_steps,
          "decode_ms_first": step_ms[0],
          "generated_tokens": batch * (1 + n_steps),
          "tokens_per_s": batch * (1 + n_steps) / (prefill_s + decode_s),
          "decode_tokens_per_s": batch * n_steps / decode_s,
          "prefill_tokens_per_s": batch * positions / prefill_s,
          "peak_device_bytes": peak, "logits_finite": finite,
          **rec, "first_tokens_request0": toks[0, :8].tolist()})
    del params, logits, prompt, extra, leaves
    torch.cuda.empty_cache()
    return launches["flash"]


def card_vs_cpu(label: str, cfg, seed: int, batch: int, prompt_len: int,
                n_steps: int, extra_shapes=()) -> dict:
    """``cfg`` in f32, one set of weights on the CPU and on the card,
    through ``serve_run`` on both: equal greedy tokens, logits within
    1e-4, and the card's flash calls exactly ``family_flash_calls``.
    ``extra_shapes`` names the seeded normal(0, 1) inputs beside the
    prompt (``image_embeds``, ``frames``) with their shapes."""
    import torch
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import init_params
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gpu = params_from_numpy(params_to_numpy(cpu), cfg, "cuda")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                              .astype(np.int32))
    extra = {name: torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))
             for name, shape in extra_shapes}
    lg_c, tk_c, _, _ = serve_run(cfg, cpu, prompt, n_steps, extra)
    with recording_flash_calls() as calls:
        lg_g, tk_g, _, _ = serve_run(
            cfg, gpu, prompt.cuda(), n_steps,
            {k: v.cuda() for k, v in extra.items()})
    want_calls = family_flash_calls(cfg, batch, prompt_len, n_steps)
    if calls != want_calls:
        raise AssertionError(f"{label}: flash calls on the card "
                             f"{dict(calls)} != {dict(want_calls)}")
    errs = [max_abs_diff([g.cpu()], [c]) for g, c in zip(lg_g, lg_c)]
    for i, (g, c) in enumerate(zip(lg_g, lg_c)):
        if not torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{label}: logits of call {i} differ by "
                                 f"{errs[i]} (tolerance 1e-4)")
    if not torch.equal(tk_g.cpu(), tk_c):
        raise AssertionError(f"{label}: greedy tokens differ")
    rec = {"model": cfg.name, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "batch": batch, "prompt_len": prompt_len,
           "decode_steps": n_steps, "flash_launches":
           sum(calls.values()), "prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]), "tol": 1e-4,
           "tokens_equal": True, "tokens_request0": tk_c[0].tolist()}
    return dict(rec=rec, cpu=cpu, gpu=gpu, prompt=prompt, rng=rng)


def stepwise_card_vs_cpu(label: str, cfg, seed: int, batch: int,
                         prompt_len: int, n_steps: int) -> dict:
    """``card_vs_cpu`` for xLSTM, whose matrix memory is bf16 whatever
    ``cfg.dtype`` is: an f32 difference of one ulp flips a bf16 rounding
    now and then and the decode amplifies it step after step (the CPU
    against itself, its embedding one ulp away, drifts by 5.6e-4 in 8
    steps at 2 layers of full width). So each card decode step starts
    from the CPU's state (copied over) and is held, logits within 1e-4
    and the same greedy token, to the CPU's step; the prefill is held as
    in ``card_vs_cpu``. No flash call may run."""
    import torch
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import init_params
    from repro_torch.serve import make_prefill, make_serve_step
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gpu = params_from_numpy(params_to_numpy(cpu), cfg, "cuda")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                              .astype(np.int32))
    prefill = make_prefill(cfg, prompt_len + n_steps)
    step = make_serve_step(cfg)
    with recording_flash_calls() as calls:
        cache_c, last_c = prefill(cpu, {"tokens": prompt})
        cache_g, last_g = prefill(gpu, {"tokens": prompt.cuda()})
        pairs = [(last_g, last_c)]
        tok = torch.argmax(last_c[:, -1], dim=-1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(n_steps):
            cache_g = {k: v.cuda() for k, v in cache_c.items()}
            tok_g, lg_g, _ = step(gpu, cache_g, tok.cuda(), prompt_len + i)
            tok, lg_c, cache_c = step(cpu, cache_c, tok, prompt_len + i)
            if not torch.equal(tok_g.cpu(), tok):
                raise AssertionError(f"{label}: greedy tokens of step {i} "
                                     "differ")
            pairs.append((lg_g, lg_c))
            toks.append(tok)
    if calls:
        raise AssertionError(f"{label}: flash calls {dict(calls)}")
    errs = [max_abs_diff([g.cpu()], [c]) for g, c in pairs]
    for i, (g, c) in enumerate(pairs):
        if not torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{label}: logits of call {i} differ by "
                                 f"{errs[i]} (tolerance 1e-4)")
    rec = {"model": cfg.name, "n_layers": cfg.n_layers,
           "slstm_every": cfg.slstm_every, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "batch": batch, "prompt_len": prompt_len,
           "decode_steps": n_steps, "flash_launches": 0,
           "decode_from": "the CPU's state each step",
           "prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]), "tol": 1e-4,
           "tokens_equal": True,
           "tokens_request0": torch.cat(toks, dim=1)[0].tolist()}
    return dict(rec=rec, cpu=cpu, gpu=gpu, prompt=prompt, rng=rng)


def phase_recurrent_parity(seed: int, batch: int = 2, n_steps: int = 8
                           ) -> None:
    """xLSTM and hymba, card against CPU in f32 at their published widths:
    xlstm-1.3b at 2 layers with ``slstm_every`` 2 (one mLSTM block, one
    sLSTM block) and 128-token prompts (``stepwise_card_vs_cpu``); hymba
    at 4 layers (globals 0, 2 and 3, layer 1 sliding) with the window cut
    to 64 under 128-token prompts, so the sliding layer masks in the
    prefill and its 64-slot ring wraps in the decode (``card_vs_cpu``:
    3 flash calls). Then ``greedy_generate`` of ``n_steps`` tokens from
    position 0 on both, the same tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import greedy_generate
    xlstm = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=2,
                                slstm_every=2, dtype="float32")
    hymba = dataclasses.replace(get_config("hymba-1.5b"), n_layers=4,
                                sliding_window=64, dtype="float32")
    for cfg, check in ((xlstm, stepwise_card_vs_cpu), (hymba, card_vs_cpu)):
        run = check("family_parity", cfg, seed, batch, 128, n_steps)
        t0 = time.perf_counter()
        want = greedy_generate(cfg, run["cpu"], run["prompt"], n_steps)
        got = greedy_generate(cfg, run["gpu"], run["prompt"].cuda(),
                              n_steps)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"family_parity {cfg.name}: "
                                 "greedy_generate tokens differ")
        rec = run["rec"]
        if cfg.sliding_window:
            rec["sliding_window"] = cfg.sliding_window
        emit({"phase": "family_parity", **rec,
              "greedy_generate_tokens_equal": True,
              "greedy_generate_s": time.perf_counter() - t0,
              "greedy_request0": want[0].tolist()})
        del run
        torch.cuda.empty_cache()


def phase_moe_parity(seed: int, batch: int = 2, prompt_len: int = 128,
                     n_steps: int = 8) -> None:
    """qwen3-moe at 2 layers in f32 with its 128 experts, top-8, its 64/4
    heads of 128 and its vocabulary, d_model narrowed to 512 and the
    expert d_ff to 256, one set of weights: the card against the CPU
    (``card_vs_cpu``), two card prefills bitwise equal, and on a zero
    router (every probability tied) the card's ``moe_ffn`` picks the
    CPU's experts."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash as kfl
    from repro_torch.models import layers
    from repro_torch.serve import make_prefill
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=2,
                              d_model=512, d_ff=256, dtype="float32")
    run = card_vs_cpu("moe_parity", cfg, seed, batch, prompt_len, n_steps)
    gpu, prompt, rng = run["gpu"], run["prompt"], run["rng"]
    prefill = make_prefill(cfg, prompt_len)
    before = kfl.launches
    (c1, l1), (c2, l2) = (prefill(gpu, {"tokens": prompt.cuda()})
                          for _ in range(2))
    if kfl.launches - before != 2 * cfg.n_layers:
        raise AssertionError(f"moe_parity: {kfl.launches - before} flash "
                             f"launches in two prefills, "
                             f"{2 * cfg.n_layers} expected")
    repeat_equal = bool(torch.equal(l1, l2) and torch.equal(c1["k"], c2["k"])
                        and torch.equal(c1["v"], c2["v"]))
    if not repeat_equal:
        raise AssertionError("moe_parity: two card prefills differ")
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    x = torch.from_numpy(rng.standard_normal((2, 64, 256))
                         .astype(np.float32))
    p = {"router": torch.zeros((256, E)),
         **{k: torch.from_numpy((rng.standard_normal(shape) * 0.06)
                                .astype(np.float32))
            for k, shape in (("w_gate", (E, 256, 64)), ("w_up", (E, 256, 64)),
                             ("w_down", (E, 64, 256)))}}
    y_c = layers.moe_ffn(x, p, E, K).y
    y_g = layers.moe_ffn(x.cuda(), {k: v.cuda() for k, v in p.items()},
                         E, K).y
    ids = layers._top_k(torch.full((4, E), 1.0 / E, device="cuda"), K)[1]
    tie_err = max_abs_diff([y_g.cpu()], [y_c])
    if ids.tolist() != [list(range(K))] * 4 or \
            not torch.allclose(y_g.cpu(), y_c, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"moe_parity: zero router, experts "
                             f"{ids[0].tolist()}, y differs by {tie_err}")
    emit({"phase": "moe_parity", **run["rec"], "experts": E, "top_k": K,
          "repeat_prefill_bitwise": repeat_equal,
          "zero_router_max_abs_err": tie_err})
    del run, gpu, c1, c2
    torch.cuda.empty_cache()


def phase_family_parity(seed: int, batch: int = 2, n_steps: int = 8) -> None:
    """gemma2 and whisper, card against CPU in f32 (``card_vs_cpu``).
    gemma2-9b at 2 layers (one local, one global) with its 16/8 heads of
    256, its softcaps and vocabulary, d_model narrowed to 512, d_ff to
    1024 and the window to 64 under 128-token prompts, so the local layer
    masks; whisper-base at its full width with 2 encoder and 2 decoder
    layers over 1500 frame embeddings and 32-token prompts."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    gemma = dataclasses.replace(get_config("gemma2-9b"), n_layers=2,
                                d_model=512, d_ff=1024, sliding_window=64,
                                dtype="float32")
    whisper = dataclasses.replace(get_config("whisper-base"), n_layers=2,
                                  n_enc_layers=2, dtype="float32")
    for cfg, prompt_len, extra in (
            (gemma, 128, ()),
            (whisper, 32, (("frames", (batch, whisper.enc_positions,
                                       whisper.d_model)),))):
        run = card_vs_cpu("family_parity", cfg, seed, batch, prompt_len,
                          n_steps, extra)
        rec = run["rec"]
        if cfg.sliding_window:
            rec["sliding_window"] = cfg.sliding_window
        emit({"phase": "family_parity", **rec})
        del run
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

#: phase 9b and 9c's AdamW: a one-step warmup, so a few steps move the
#: parameters by up to lr_peak an element a step
TRAIN_OPT = dict(lr_peak=1e-3, warmup_steps=1, decay_steps=10)
#: card against CPU in f32: the loss (relative), each gradient leaf (x its
#: largest |g|; the CPU tests hold the port to the reference at 1e-4
#: too), and the parameters after the steps: within ``param`` (a tenth of
#: lr_peak) but for at most ``param_share`` of the elements, which must
#: stay within 2 lr_peak a step. AdamW moves an element by about lr
#: whatever the size of its gradient, so one whose gradient lies within
#: the card-vs-CPU noise of zero can step the other way (12 of 63.7
#: million at 9b's size on an H100)
TRAIN_TOL = dict(loss=1e-5, grad=1e-4, param=1e-4, param_share=1e-5)
#: phase 9c's families, one smoke config each
TRAIN_FAMILIES = ("smollm-135m", "gemma2-9b", "qwen3-moe-235b-a22b",
                  "llava-next-34b", "whisper-base", "xlstm-1.3b",
                  "hymba-1.5b")


def train_flash_per_step(cfg, seq: int, remat: bool) -> int:
    """The flash launches of one train step of ``cfg`` over ``seq``
    tokens: one for each plain causal or full attention of the forward
    (the prefill's, ``family_flash_calls``), and under remat as many
    again when the backward recomputes each layer. The backward itself
    is the chunked oracle's gradient and launches no kernel."""
    n = sum(family_flash_calls(cfg, 1, seq, 0).values())
    return n * (2 if remat else 1)


def tensor_sha1s(tree_) -> dict:
    """sha1 of each tensor's bytes (bf16 as its 16-bit pattern), by the
    checkpoint's key."""
    import hashlib
    import torch
    from repro_torch import tree
    out = {}
    for key, t in tree.flatten_with_path(tree_):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[key] = hashlib.sha1(t.numpy().tobytes()).hexdigest()
    return out


def checkpoint_sha1s(path: Path) -> dict:
    """sha1 of the bytes of each tensor a checkpoint directory holds,
    decoded from its files."""
    import hashlib
    from repro_torch.checkpoint import manager
    tensors = json.loads((path / "manifest.json").read_text())["tensors"]
    return {k: hashlib.sha1(manager._decode(
        (path / m["file"]).read_bytes(), m).tobytes()).hexdigest()
        for k, m in tensors.items()}


def run_launcher(argv, **kw):
    """``launch.train.main(argv, **kw)`` with its printed lines kept out
    of this script's output; returns its ``TrainRun`` and closing
    JSON."""
    import io
    from repro_torch.launch import train as launcher
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = launcher.main(argv, **kw)
    return run, json.loads(out.getvalue().strip().splitlines()[-1])


def train_step_parts(cfg, state, batch: dict) -> dict:
    """One more train step of ``state`` on ``batch``, split on the host
    clock with the card synced at each boundary: the forward and loss,
    the backward (with the remat recompute of each layer), inside it the
    attention's backward (``layers._KernelAttention.backward``: the
    oracle's gradient recomputed from q, k and v), and the AdamW
    update."""
    import torch
    from repro_torch import tree
    from repro_torch.models import layers
    from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_update
    from repro_torch.train.step import make_loss_fn
    loss_fn = make_loss_fn(cfg, TrainStepConfig())
    real = layers._KernelAttention.backward
    attn = [0.0, 0]

    def timed(ctx, dout):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(ctx, dout)
        torch.cuda.synchronize()
        attn[0] += time.perf_counter() - t
        attn[1] += 1
        return out
    layers._KernelAttention.backward = staticmethod(timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = [p.detach().requires_grad_(True)
                for p in tree.leaves(state.params)]
        total, _ = loss_fn(tree.unflatten(state.params, flat), batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(total, flat)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adamw_update(AdamWConfig(), state.opt, state.params,
                     tree.unflatten(state.params, list(grads)), inplace=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        layers._KernelAttention.backward = staticmethod(real)
    return {"forward_loss_s": t1 - t0, "backward_s": t2 - t1,
            "attention_backward_s": attn[0], "attention_backward_calls":
            attn[1], "adamw_s": t3 - t2, "step_s": t3 - t0}


def phase_train_full(seed: int, steps: int = 12, batch: int = 8,
                     seq: int = 2048, ckpt_every: int = 6) -> int:
    """9a: smollm-135m at full width and depth (bf16, seeded weights)
    through ``python -m repro_torch.launch.train`` (remat, lr 3e-4 with
    its warmup), a checkpoint every ``ckpt_every`` steps; then a
    ``--resume`` from the middle checkpoint alone, which must restore the
    saved tensors bit for bit and repeat the later losses within 1e-2.
    Returns the flash launches of both runs."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    cfg = get_config("smollm-135m")
    work = ROOT / "build" / "train_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--arch", "smollm-135m", "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--ckpt-every", str(ckpt_every),
            "--seed", str(seed), "--log-every", "1"]
    per_step = train_flash_per_step(cfg, seq, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    run, closing = run_launcher(argv + ["--ckpt-dir", str(work / "a")])
    launches = read_launches()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(COUNTERS, 0)
    want["flash"] = per_step * steps
    if launches != want:
        raise AssertionError(f"train 9a: launches {launches} != {want}")
    if not (closing["improved"] and all(np.isfinite(run.losses))
            and len(run.losses) == steps):
        raise AssertionError(f"train 9a: losses {run.losses}")
    # the resume: a directory holding only the middle checkpoint
    mid = f"step_{ckpt_every:010d}"
    shutil.copytree(work / "a" / mid, work / "b" / mid)
    saved = checkpoint_sha1s(work / "b" / mid)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    restored, at = CheckpointManager(work / "b").restore_latest(run.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    restored_bitwise = at == ckpt_every and tensor_sha1s(restored) == saved
    if not restored_bitwise:
        raise AssertionError("train 9a: the restored state is not the "
                             "saved one")
    del restored
    reset_launches()
    again, closing2 = run_launcher(argv + ["--ckpt-dir", str(work / "b"),
                                           "--resume"])
    launches2 = read_launches()
    want["flash"] = per_step * (steps - ckpt_every)
    if launches2 != want or again.start_step != ckpt_every:
        raise AssertionError(f"train 9a resume: launches {launches2}, "
                             f"start {again.start_step}")
    rel = [abs(a - b) / abs(b) for a, b in zip(again.losses,
                                               run.losses[ckpt_every:])]
    if len(rel) != steps - ckpt_every or max(rel) > 1e-2:
        raise AssertionError(f"train 9a resume: losses {again.losses} "
                             f"against {run.losses[ckpt_every:]}")
    median = statistics.median(run.step_seconds[1:])
    from repro_torch.data import TokenPipeline
    pipe = TokenPipeline(vocab_size=cfg.vocab, batch=batch, seq_len=seq,
                         seed=seed)
    parts = train_step_parts(cfg, again.state, _on(pipe.get_batch(steps),
                                                   "cuda"))
    emit({"phase": "train", "leg": "9a full width", "model": cfg.name,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
          "seq": seq, "steps": steps, "remat": True,
          "n_params": sum(t.numel() for t in
                          _leaves(run.state.params)),
          "losses": run.losses, "first_loss": closing["first_loss"],
          "final_loss": closing["final_loss"],
          "improved": closing["improved"],
          "step_seconds": run.step_seconds,
          "step_s_median_after_first": median,
          "tokens_per_s": batch * seq / median,
          "step_parts": parts, "peak_device_bytes": peak,
          "flash_launches_per_step": per_step, "launches": launches,
          "checkpoint_saves": [{"step": s, "seconds": t, "bytes": n}
                               for s, t, n in run.saves],
          "restore_seconds": restore_s,
          "restore_bytes": sum(f.stat().st_size for f in
                               (work / "b" / mid).iterdir()),
          "restored_bitwise": restored_bitwise,
          "resume": {"start_step": again.start_step,
                     "losses": again.losses,
                     "max_rel_loss_diff": max(rel),
                     "launcher_restore_seconds": again.restore_seconds,
                     "step_s_median": statistics.median(again.step_seconds),
                     "launches": launches2},
          "seconds": seconds + time.perf_counter() - t1})
    shutil.rmtree(work, ignore_errors=True)
    del run, again
    torch.cuda.empty_cache()
    return launches["flash"] + launches2["flash"]


def _leaves(tree_):
    from repro_torch import tree
    return tree.leaves(tree_)


def _train_inputs(cfg, batch: int, seq: int, step: int, seed: int) -> dict:
    """The token pipeline's batch (numpy), with llava's image and
    whisper's frame embeddings (seeded normal(0, 1), f32)."""
    from repro_torch.data import synthetic_tokens
    b = synthetic_tokens(cfg.vocab, batch, seq, step, seed)
    rng = np.random.default_rng(seed + step)
    if cfg.n_img_tokens:
        b["image_embeds"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (batch, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return b


def _on(b: dict, dev: str) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _weights_both(cfg, seed: int):
    """One set of seeded weights on the CPU and on the card."""
    import torch
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import init_params
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cpu, params_from_numpy(params_to_numpy(cpu), cfg, "cuda")


def _steps_both(cfg, cpu, gpu, batches, label: str) -> tuple:
    """``make_train_step`` (remat, ``TRAIN_OPT``) on both sides over
    ``batches``; each step's loss within ``TRAIN_TOL["loss"]``, the
    parameters after the last within ``TRAIN_TOL["param"]`` (see
    there). Returns (losses (cpu, card) a step, a record of the
    parameter differences)."""
    from repro_torch.train import (AdamWConfig, TrainState,
                                   TrainStepConfig, adamw_init,
                                   make_train_step)
    fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**TRAIN_OPT))
    sc = TrainState(cpu, adamw_init(cpu))
    sg = TrainState(gpu, adamw_init(gpu))
    losses = []
    for b in batches:
        sc, mc = fn(sc, _on(b, "cpu"))
        sg, mg = fn(sg, _on(b, "cuda"))
        lc, lg = float(mc["loss"]), float(mg["loss"])
        losses.append((lc, lg))
        if not abs(lg - lc) <= TRAIN_TOL["loss"] * abs(lc):
            raise AssertionError(f"{label}: loss {lg} on the card, {lc} on "
                                 f"the CPU")
    over, total, err = 0, 0, 0.0
    for a, b in zip(_leaves(sc.params), _leaves(sg.params)):
        d = (b.cpu() - a).abs()
        over += int((d > TRAIN_TOL["param"]).sum())
        total += d.numel()
        err = max(err, float(d.max()))
    bound = 2 * TRAIN_OPT["lr_peak"] * len(batches)
    if over > TRAIN_TOL["param_share"] * total or err > bound:
        raise AssertionError(f"{label}: {over} of {total} params differ by "
                             f"more than {TRAIN_TOL['param']} after "
                             f"{len(batches)} steps, the most by {err}")
    return losses, {"param_max_abs_err": err, "params_over_tol": over,
                    "params": total, "param_tol": TRAIN_TOL["param"]}


def phase_train_parity(seed: int, batch: int = 2, seq: int = 128,
                       steps: int = 3) -> int:
    """9b: smollm-135m at full width with 2 layers, f32, one set of
    weights on the CPU and on the card: the first batch's gradients
    (each leaf, and wq, wk, wv non-zero on both: what a kernel that cut
    the gradient would fail), the compressed sync with two pods (both on
    cuda:0) within one quantization step an element, then ``steps``
    train steps. Returns the card's flash launches."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash as kfl
    from repro_torch.train import TrainStepConfig
    from repro_torch.train.step import make_grad_fn
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2,
                              dtype="float32")
    cpu, gpu = _weights_both(cfg, seed)
    batches = [_train_inputs(cfg, batch, seq, i, seed) for i in range(steps)]
    per_step = train_flash_per_step(cfg, seq, remat=True)
    before = kfl.launches
    grad = make_grad_fn(cfg, TrainStepConfig())
    g_c, _ = grad(cpu, _on(batches[0], "cpu"))
    g_g, _ = grad(gpu, _on(batches[0], "cuda"))
    grad_rel = {}
    for (key, a), b in zip(tree.flatten_with_path(g_c), _leaves(g_g)):
        scale = float(a.abs().max())
        err = float((b.cpu() - a).abs().max())
        grad_rel[key] = err / scale if scale else err
        if not err <= TRAIN_TOL["grad"] * scale:
            raise AssertionError(f"train 9b: gradient {key} differs by "
                                 f"{err} (largest |g| {scale})")
    qkv_abs = {k: [float(g["blocks"][k].abs().max()) for g in (g_c, g_g)]
               for k in ("wq", "wk", "wv")}
    if not all(min(v) > 0 for v in qkv_abs.values()):
        raise AssertionError(f"train 9b: attention gradients {qkv_abs}")
    # the compressed sync, both pods on cuda:0; its step from the pods'
    # own gradients
    half = {k: [v[:batch // 2], v[batch // 2:]] for k, v in
            batches[0].items()}
    pods = [grad(cpu, _on({k: v[i] for k, v in half.items()}, "cpu"))[0]
            for i in range(2)]
    sync = make_grad_fn(cfg, TrainStepConfig(grad_compress=True, n_pods=2))
    q_c, _ = sync(cpu, _on(batches[0], "cpu"))
    q_g, _ = sync(gpu, _on(batches[0], "cuda"))
    in_steps = 0.0
    for (key, a), b, p0, p1 in zip(tree.flatten_with_path(q_c),
                                   _leaves(q_g), _leaves(pods[0]),
                                   _leaves(pods[1])):
        amax = max(float(p0.abs().max()), float(p1.abs().max()))
        qstep = max(amax * 2e-3, amax / (32767 / 2), 1e-30)
        err = float((b.cpu() - a).abs().max())
        in_steps = max(in_steps, err / qstep)
        if not err <= qstep:
            raise AssertionError(f"train 9b: compressed {key} differs by "
                                 f"{err}, a step is {qstep}")
    losses, param_rec = _steps_both(cfg, cpu, gpu, batches, "train 9b")
    launches = kfl.launches - before
    # grads once, two pods, then the steps
    if launches != per_step * (1 + 2 + steps):
        raise AssertionError(f"train 9b: {launches} flash launches, "
                             f"{per_step * (3 + steps)} expected")
    emit({"phase": "train", "leg": "9b card vs CPU", "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "batch": batch, "seq": seq, "steps": steps,
          "losses_cpu_card": losses, "loss_tol": TRAIN_TOL["loss"],
          "grad_max_rel_err": max(grad_rel.values()),
          "grad_rel_err_attention": {k: grad_rel[f"blocks/{k}"]
                                     for k in ("wq", "wk", "wv")},
          "attention_grad_abs_max_cpu_card": qkv_abs,
          "grad_tol": TRAIN_TOL["grad"],
          "compressed_max_err_in_quant_steps": in_steps, **param_rec,
          "flash_launches": launches})
    del cpu, gpu, g_c, g_g, q_c, q_g
    torch.cuda.empty_cache()
    return launches


def phase_train_families(seed: int, batch: int = 2, seq: int = 16) -> int:
    """9c: one train step of each family's smoke config in f32 on the
    card and on the CPU, one set of weights: the loss and the updated
    parameters within ``TRAIN_TOL``, and the card's flash launches
    exactly ``train_flash_per_step``. Returns them."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash as kfl
    total = 0
    for arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cpu, gpu = _weights_both(cfg, seed)
        before = kfl.launches
        losses, param_rec = _steps_both(
            cfg, cpu, gpu, [_train_inputs(cfg, batch, seq, 0, seed)],
            f"train 9c {cfg.name}")
        launches = kfl.launches - before
        want = train_flash_per_step(cfg, seq, remat=True)
        if launches != want:
            raise AssertionError(f"train 9c {cfg.name}: {launches} flash "
                                 f"launches, {want} expected")
        total += launches
        emit({"phase": "train", "leg": "9c family", "model": cfg.name,
              "family": cfg.family, "dtype": cfg.dtype, "batch": batch,
              "seq": seq, "loss_cpu_card": losses[0],
              "loss_rel_err": abs(losses[0][1] - losses[0][0])
              / abs(losses[0][0]), **param_rec,
              "flash_launches": launches})
    return total



# ---------------------------------------------------------------------------
# phase 10: the sharded LM layer (EP MoE, the meta-device dry-run)
# ---------------------------------------------------------------------------

#: 10a's MoE layer: d, experts, top-k, expert ff, tokens (B, S), capacity
EP_LAYER = (512, 128, 8, 256, (4, 2048), 1.25)
#: 10a's meshes ("data", "model"), each against the CPU mesh of its shape
EP_MESHES = ((1, 4), (2, 4))
#: 10b: qwen3-moe at phase 7's cut, under MOE_EP_MODE on a (1, 4) mesh
EP_MODEL = ("qwen3-moe-235b-a22b", 8, 4, 2048)
#: 10c's dry-run cells: (arch, shape, multi_pod)
DRYRUN_CELLS = (("smollm_135m", "train_4k", False),
                ("qwen3_moe_235b_a22b", "decode_32k", True))


def ep_mesh(shape, devices):
    """A ("data", "model") ``DeviceMesh`` of ``shape``, model shard j of
    every data row on ``devices[j % len(devices)]``."""
    import torch
    from repro_torch.launch.mesh import DeviceMesh
    arr = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        arr[idx] = torch.device(devices[idx[-1] % len(devices)])
    return DeviceMesh(arr, ("data", "model"))


def ep_inputs(E: int, d: int, ff: int, tokens, seed: int):
    """10a's f32 inputs: the tokens and the router on a dyadic grid (x in
    quarters, the router in 64ths), so the router's logits are exact on
    the card and on the CPU and both route every token alike (equal
    logits pick the lower expert on both); the expert weights normal."""
    import torch
    rng = np.random.default_rng(seed)
    x = np.clip(np.round(rng.standard_normal(tokens + (d,)) * 4) / 4, -2, 2)
    router = np.round(rng.standard_normal((d, E)) * d ** -0.5 * 64) / 64
    p = {"router": router}
    for k, shape, fan in (("w_gate", (E, d, ff), d), ("w_up", (E, d, ff), d),
                          ("w_down", (E, ff, d), ff)):
        p[k] = rng.standard_normal(shape) * fan ** -0.5
    return (torch.from_numpy(x.astype(np.float32)),
            {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()})


def ep_dropped_share(x, router, E: int, K: int, mesh_shape,
                     capacity_factor: float) -> float:
    """The share of a ``moe_ffn_ep`` call's N*K*m assignments that model
    shard 0's combine gets no expert output for, recounted from the
    router's top-k: dropped past ``cap_send`` at the first dispatch, or
    past ``cap_loc`` at an expert of the second (shard 0's copies arrive
    first at every shard); ``moe_ffn_ep`` itself runs unchanged."""
    import math
    import torch
    from repro_torch.models import layers
    dp, tp = mesh_shape
    N = x.shape[0] * x.shape[1]
    m = tp // math.gcd(E, tp)
    N_loc, K_eff, E_loc = N // dp, K * m, E * m // tp
    cap_send = max(int(np.ceil(N_loc * K_eff / tp * capacity_factor / 8))
                   * 8, 8)
    cap_loc = max(int(np.ceil(tp * cap_send / E_loc * capacity_factor / 8))
                  * 8, 8)
    probs = torch.softmax(x.reshape(N, -1).float() @ router.float(), dim=-1)
    ids = layers._top_k(probs, K)[1]
    dropped = 0
    for r in range(dp):
        flat = (ids[r * N_loc:(r + 1) * N_loc, :, None] * m
                + torch.arange(m, device=ids.device)).reshape(-1)
        dest = flat // E_loc
        order = torch.argsort(dest, stable=True)
        count = torch.bincount(dest, minlength=tp)
        start = torch.cumsum(count, 0) - count
        pos = torch.arange(flat.numel(), device=flat.device) \
            - start[dest[order]]
        keep = pos < cap_send
        kept = flat[order][keep]
        per_expert = torch.bincount(kept, minlength=E * m)
        dropped += int((~keep).sum()) + int((per_expert - cap_loc)
                                            .clamp_min(0).sum())
    return dropped / (N * K_eff)


def phase_moe_ep_layer(seed: int) -> None:
    """10a: ``moe_ffn_ep`` in f32 on each mesh of ``EP_MESHES`` with every
    shard on cuda:0, against the CPU mesh of the same shape on the same
    inputs (``ep_inputs``), at E 128 / top-8 and at E 2 / top-2 (two
    ff-sliced virtual experts an expert): y within 1e-5 of max|y|, aux
    within 1e-6 relative, a second card run bitwise the first, no kernel
    launch."""
    import torch
    from repro_torch.models import layers
    d, E0, K0, ff, tokens, cf = EP_LAYER
    for E, K in ((E0, K0), (2, 2)):
        x, p = ep_inputs(E, d, ff, tokens, seed + E)
        xg, pg = x.cuda(), {k: v.cuda() for k, v in p.items()}
        for shape in EP_MESHES:
            t0 = time.perf_counter()
            with ep_mesh(shape, ["cpu"]):
                want = layers.moe_ffn_ep(x, p, E, K, cf)
            cpu_s = time.perf_counter() - t0
            reset_launches()
            runs, card_s = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ep_mesh(shape, [MESH_DEVICE]):
                    runs.append(layers.moe_ffn_ep(xg, pg, E, K, cf))
                torch.cuda.synchronize()
                card_s.append(time.perf_counter() - t0)
            launches = read_launches()
            got = runs[0]
            label = f"moe_ep 10a E {E} mesh {shape}"
            if any(launches.values()):
                raise AssertionError(f"{label}: launches {launches}")
            err = max_abs_diff([got.y.cpu()], [want.y])
            scale = float(want.y.abs().max())
            aux_err = abs(float(got.aux_loss) - float(want.aux_loss)) \
                / abs(float(want.aux_loss))
            if not err <= 1e-5 * scale or not aux_err <= 1e-6:
                raise AssertionError(f"{label}: y differs by {err} (max|y| "
                                     f"{scale}), aux by {aux_err} relative")
            bitwise = bool(torch.equal(runs[0].y, runs[1].y)
                           and torch.equal(runs[0].aux_loss,
                                           runs[1].aux_loss))
            if not bitwise:
                raise AssertionError(f"{label}: two card runs differ")
            emit({"phase": "moe_ep", "leg": "10a", "mesh": list(shape),
                  "shard_devices": MESH_DEVICE, "experts": E, "top_k": K,
                  "d_model": d, "expert_ff": ff, "tokens": list(tokens),
                  "capacity_factor": cf, "dtype": "float32",
                  "y_max_abs_err": err, "y_max_abs": scale, "y_tol": 1e-5,
                  "aux_card": float(got.aux_loss),
                  "aux_cpu": float(want.aux_loss), "aux_rel_err": aux_err,
                  "dropped_share": ep_dropped_share(x, p["router"], E, K,
                                                    shape, cf),
                  "repeat_bitwise": bitwise, "card_s": card_s,
                  "cpu_s": cpu_s})
            del runs, got, want
        del xg, pg
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recording_ep_load(mesh_shape):
    """For each ``layers.moe_ffn_ep`` call inside the block, the dropped
    share (``ep_dropped_share``); the call itself runs unchanged."""
    from repro_torch.models import layers
    shares = []
    real = layers.moe_ffn_ep

    def record(x, p, n_experts, top_k, capacity_factor=1.25):
        shares.append(ep_dropped_share(x, p["router"], n_experts, top_k,
                                       mesh_shape, capacity_factor))
        return real(x, p, n_experts, top_k, capacity_factor)
    layers.moe_ffn_ep = record
    try:
        yield shares
    finally:
        layers.moe_ffn_ep = real


def phase_moe_ep_model(seed: int) -> int:
    """10b: qwen3-moe at its published widths, phase 7's depth cut, bf16,
    seeded weights, through ``make_prefill`` of 4 x 2048 prompts (8,192
    tokens: EP engages), in turns: dense, twice under ``MOE_EP_MODE`` on a
    (1, 4) mesh with its four model shards on cuda:0, dense again. Launch
    counts set to 0 just before each EP prefill and read just after:
    flash exactly once a layer. Logits finite, the two EP prefills bitwise
    equal, seconds and peak bytes of each, layer 0's dropped share under
    EP beside dense's. Returns the EP prefills' flash launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, layers
    from repro_torch.serve import make_prefill
    arch, n_layers, batch, prompt_len = EP_MODEL
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    prompt, _ = family_inputs(cfg, batch, prompt_len, seed)
    prefill = make_prefill(cfg, prompt_len)
    shape = (1, 4)

    def timed_prefill():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cache, last = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        return (cache, last, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    with recording_moe_load() as dense_loads:
        _, dense_last, dense_s, dense_peak = timed_prefill()
    runs, total = [], 0
    layers.MOE_EP_MODE = True
    try:
        for _ in range(2):
            reset_launches()
            with ep_mesh(shape, [MESH_DEVICE]), \
                    recording_ep_load(shape) as ep_loads:
                runs.append(timed_prefill())
            launches = read_launches()
            want = dict.fromkeys(COUNTERS, 0)
            want["flash"] = cfg.n_layers
            if launches != want or len(ep_loads) != cfg.n_layers:
                raise AssertionError(f"moe_ep 10b: launches {launches}, "
                                     f"{len(ep_loads)} EP calls")
            total += launches["flash"]
    finally:
        layers.MOE_EP_MODE = False
    _, _, dense_s2, _ = timed_prefill()
    (c1, l1, s1, peak1), (c2, l2, s2, peak2) = runs
    finite = bool(torch.isfinite(l1).all())
    bitwise = bool(torch.equal(l1, l2) and torch.equal(c1["k"], c2["k"])
                   and torch.equal(c1["v"], c2["v"]))
    if not finite or not bitwise:
        raise AssertionError(f"moe_ep 10b: logits finite {finite}, repeat "
                             f"bitwise {bitwise}")
    emit({"phase": "moe_ep", "leg": "10b", "model": cfg.name,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
          "prompt_len": prompt_len, "mesh": list(shape),
          "shard_devices": MESH_DEVICE, "flash_launches": cfg.n_layers,
          "dense_prefill_s": [dense_s, dense_s2], "ep_prefill_s": [s1, s2],
          "dense_peak_device_bytes": dense_peak,
          "ep_peak_device_bytes": [peak1, peak2], "logits_finite": finite,
          "repeat_bitwise": bitwise,
          "layer0_dropped_share_ep": ep_loads[0],
          "layer0_dropped_share_dense": dense_loads[0]["dropped_share"],
          "ep_vs_dense_last_logits_max_abs_diff":
              max_abs_diff([l1.float()], [dense_last.float()])})
    del params, runs, c1, c2, l1, l2, dense_last
    torch.cuda.empty_cache()
    return total


def phase_dryrun() -> None:
    """10c: ``launch.dryrun.run_cell`` on ``DRYRUN_CELLS`` (meta tensors
    on the production meshes: no launch), each status "ok"; and
    ``make_production_mesh()`` without ``devices=`` raises on fewer than
    256 cards."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    import torch
    for arch, shape, multi_pod in DRYRUN_CELLS:
        reset_launches()
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod)
        secs = time.perf_counter() - t0
        launches = read_launches()
        if rec["status"] != "ok" or any(launches.values()):
            raise AssertionError(f"dryrun 10c {arch} {shape}: "
                                 f"{rec.get('error')} launches {launches}")
        emit({"phase": "dryrun", "leg": "10c", "seconds": secs,
              **{k: v for k, v in rec.items()
                 if k not in ("collectives_reason",)}})
    try:
        make_production_mesh()
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError("dryrun 10c: make_production_mesh() did not "
                             f"raise on {torch.cuda.device_count()} card(s)")
    emit({"phase": "dryrun", "leg": "10c production mesh",
          "cards": torch.cuda.device_count(), "raised": raised})


# ---------------------------------------------------------------------------
# phase 11: the launchers' sharded execution over a (data, model) mesh
# ---------------------------------------------------------------------------

#: 11a's launcher run: smollm-135m at full width and depth
SHARDED_TRAIN = dict(steps=4, batch=8, seq=2048)
#: 11b's comparison: 2 layers in f32, 3 steps of 4 x 128 tokens
SHARDED_PARITY = dict(batch=4, seq=128, steps=3)
#: 11c's serving run
SHARDED_SERVE = ["--batch", "8", "--prompt-len", "16", "--new-tokens", "32"]


def lm_mesh(devices, shape=(2, 2)):
    """A single-process ``("data", "model")`` mesh on ``devices``."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), devices=devices)


def state_shard_bytes(cfg, mesh) -> int:
    """``specs.shard_bytes`` of the launcher's train state on ``mesh``:
    params by ``param_spec``, moments by ZeRO-1 past one position."""
    from repro_torch.launch import specs
    from repro_torch.train import TrainState
    return specs.shard_bytes(
        TrainState(specs.param_structs(cfg), specs.opt_state_structs(cfg)),
        TrainState(specs.param_shardings(cfg, mesh),
                   specs.opt_state_shardings(cfg, mesh,
                                             zero1=mesh.size > 1)))


def phase_sharded_train_full(seed: int) -> int:
    """11a: ``launch.train.main`` on smollm-135m at full width and depth
    (bf16, seeded weights) on a (2, 2) mesh with every position on
    cuda:0, then on the 1 x 1 host mesh, the same seed: flash exactly
    ``train_flash_per_step`` x dp a step, each position's resident bytes
    ``specs.shard_bytes``, the losses within 1e-2 relative. Returns the
    flash launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import tp_split
    cfg = get_config("smollm-135m")
    k = SHARDED_TRAIN
    argv = ["--arch", "smollm-135m", "--steps", str(k["steps"]), "--batch",
            str(k["batch"]), "--seq", str(k["seq"]), "--seed", str(seed),
            "--log-every", "1"]
    per_step = train_flash_per_step(cfg, k["seq"], remat=True)
    legs, total = {}, 0
    for name, mesh in (("2x2", lm_mesh([MESH_DEVICE] * 4)),
                       ("1x1", make_host_mesh(MESH_DEVICE))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_launches()
        run, closing = run_launcher(argv, mesh=mesh)
        launches = read_launches()
        seconds = time.perf_counter() - t0
        dp = mesh.shape["data"]
        want = dict.fromkeys(COUNTERS, 0)
        want["flash"] = per_step * dp * k["steps"]
        if launches != want:
            raise AssertionError(f"sharded 11a {name}: launches {launches} "
                                 f"!= {want}")
        shard = state_shard_bytes(cfg, mesh)
        if sorted(run.resident_bytes.values()) != [shard] * mesh.size:
            raise AssertionError(f"sharded 11a {name}: resident bytes "
                                 f"{run.resident_bytes}, specs {shard}")
        if not all(np.isfinite(run.losses)) or \
                len(run.losses) != k["steps"]:
            raise AssertionError(f"sharded 11a {name}: losses {run.losses}")
        median = statistics.median(run.step_seconds[1:])
        legs[name] = {
            "mesh": mesh.shape, "losses": run.losses,
            "improved": closing["improved"],
            "step_seconds": run.step_seconds,
            "step_s_median_after_first": median,
            "tokens_per_s": k["batch"] * k["seq"] / median,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "resident_bytes_per_position": run.resident_bytes,
            "specs_shard_bytes": shard,
            "flash_launches_per_step": per_step * dp,
            "tp_split": tp_split(cfg, mesh.shape),
            "launches": launches, "seconds": seconds}
        total += launches["flash"]
        del run
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in
           zip(legs["2x2"]["losses"], legs["1x1"]["losses"])]
    if max(rel) > 1e-2:
        raise AssertionError(f"sharded 11a: losses {legs['2x2']['losses']} "
                             f"against {legs['1x1']['losses']}")
    emit({"phase": "sharded_train", "leg": "11a full width",
          "model": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          **k, "remat": True, "legs": legs, "max_rel_loss_diff": max(rel)})
    return total


def sharded_parity(seed: int, devices, label: str, arch="smollm-135m",
                   shape=(2, 2), k=None, checkpoint: bool = True) -> dict:
    """3 steps of ``make_train_step(mesh=)`` on a ``shape`` mesh on
    ``devices`` against the one-device CPU step on the same weights
    (``arch`` at full width, 2 layers, f32): losses within
    ``TRAIN_TOL["loss"]``, params within ``TRAIN_TOL["param"]`` but for
    ``param_share``, flash launches as the split says (each model
    shard's where the heads split); then, with ``checkpoint``, the
    mesh's state saved and restored on the 1 x 1 host mesh, bitwise
    (sha1). Returns the record."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import placement
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import heads_split, tp_split
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   adamw_init, make_train_step)
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    k = k or SHARDED_PARITY
    cpu, gpu = _weights_both(cfg, seed)
    mesh = lm_mesh(devices, shape)
    dp, tp = mesh.shape["data"], mesh.shape["model"]

    def shardings(m):
        return TrainState(specs.param_shardings(cfg, m),
                          specs.opt_state_shardings(cfg, m,
                                                    zero1=m.size > 1))
    sc = TrainState(cpu, adamw_init(cpu))
    sg = placement.place_tree(TrainState(gpu, adamw_init(gpu)),
                              shardings(mesh))
    del gpu
    opt = AdamWConfig(**TRAIN_OPT)
    one = make_train_step(cfg, TrainStepConfig(), opt)
    sharded = make_train_step(cfg, TrainStepConfig(), opt, mesh=mesh)
    losses, secs, launches = [], [], 0
    for i in range(k["steps"]):
        b = _train_inputs(cfg, k["batch"], k["seq"], i, seed)
        sc, mc = one(sc, _on(b, "cpu"))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        sg, mg = sharded(sg, _on(b, "cuda"))
        lg = float(mg["loss"])
        secs.append(time.perf_counter() - t0)
        launches += read_launches()["flash"]
        lc = float(mc["loss"])
        losses.append((lc, lg))
        if not abs(lg - lc) <= TRAIN_TOL["loss"] * abs(lc):
            raise AssertionError(f"{label}: loss {lg} on the mesh, {lc} on "
                                 "the CPU")
    want = (train_flash_per_step(cfg, k["seq"], True) * dp
            * (tp if heads_split(cfg, tp) else 1) * k["steps"])
    if launches != want:
        raise AssertionError(f"{label}: {launches} flash launches, {want} "
                             "expected")
    whole = placement.gather_tree(sg)
    over, total, err = 0, 0, 0.0
    for a, b in zip(_leaves(sc.params), _leaves(whole.params)):
        d = (b.cpu() - a).abs()
        over += int((d > TRAIN_TOL["param"]).sum())
        total += d.numel()
        err = max(err, float(d.max()))
    if over > TRAIN_TOL["param_share"] * total or \
            err > 2 * TRAIN_OPT["lr_peak"] * k["steps"]:
        raise AssertionError(f"{label}: {over} of {total} params differ by "
                             f"more than {TRAIN_TOL['param']}, the most by "
                             f"{err}")
    rec = {"model": cfg.name, "n_layers": cfg.n_layers, "d_model":
           cfg.d_model, "dtype": cfg.dtype, "devices": list(devices),
           "mesh": mesh.shape, **k, "tp_split": tp_split(cfg, mesh.shape),
           "losses_cpu_mesh": losses, "loss_tol": TRAIN_TOL["loss"],
           "param_max_abs_err": err, "params_over_tol": over,
           "params": total, "param_tol": TRAIN_TOL["param"],
           "step_seconds": secs, "flash_launches": launches}
    if not checkpoint:
        return rec
    work = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    mgr = CheckpointManager(work, save_every=1)
    t0 = time.perf_counter()
    path = mgr.maybe_save(k["steps"], sg)
    save_s = time.perf_counter() - t0
    host = make_host_mesh(MESH_DEVICE)
    restored, at = mgr.restore_latest(sg, shardings=shardings(host))
    saved = checkpoint_sha1s(path)
    bitwise = (at == k["steps"] and saved == tensor_sha1s(whole)
               and tensor_sha1s(placement.gather_tree(restored)) == saved)
    shutil.rmtree(work, ignore_errors=True)
    if not bitwise:
        raise AssertionError(f"{label}: the 1 x 1 restore is not the "
                             f"{shape} state")
    return {**rec, "checkpoint_save_s": save_s,
            "restored_1x1_bitwise": bitwise}


def phase_sharded_train_parity(seed: int) -> int:
    """11b: ``sharded_parity`` with every position on cuda:0. Returns
    the flash launches."""
    rec = sharded_parity(seed, [MESH_DEVICE] * 4, "sharded 11b")
    emit({"phase": "sharded_train", "leg": "11b mesh vs CPU", **rec})
    return rec["flash_launches"]


def run_serve(argv, cfg, mesh):
    """``launch.serve_lm.main`` for ``cfg`` on ``mesh`` (its printed lines
    kept out of this script's output): (tokens, seconds, launches)."""
    import io
    import torch
    from repro_torch.launch import serve_lm
    real = serve_lm.get_config
    serve_lm.get_config = lambda arch: cfg
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            toks = serve_lm.main(argv, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0, read_launches()
    finally:
        serve_lm.get_config = real


def phase_sharded_serve(seed: int, devices=None) -> dict:
    """11c: ``launch.serve_lm.main`` on smollm-135m at full width, 8
    requests, on a (2, 2) mesh (every position on cuda:0) against the
    1 x 1 host mesh: at 2 layers in f32 the tokens must be equal; at
    full depth in bf16 the seconds of both (and whether the tokens
    agree). No kernel launches (decode steps run plain torch)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    devices = devices or [MESH_DEVICE] * 4
    argv = ["--arch", "smollm-135m", "--seed", str(seed)] + SHARDED_SERVE
    full = get_config("smollm-135m")
    rec = {"phase": "sharded_serve", "argv": argv, "devices": devices}
    for label, cfg in (("f32_2_layers", dataclasses.replace(
            full, n_layers=2, dtype="float32")), ("bf16_full", full)):
        runs = {}
        for name, mesh in (("1x1", make_host_mesh(MESH_DEVICE)),
                           ("2x2", lm_mesh(devices))):
            toks, secs, launches = run_serve(argv, cfg, mesh)
            if any(launches.values()):
                raise AssertionError(f"sharded 11c {label} {name}: "
                                     f"launches {launches}")
            runs[name] = (toks.cpu(), secs)
        same = bool((runs["1x1"][0] == runs["2x2"][0]).all())
        if label.startswith("f32") and not same:
            raise AssertionError("sharded 11c: the (2, 2) tokens are not "
                                 "the 1 x 1 run's")
        rec[label] = {"seconds_1x1": runs["1x1"][1],
                      "seconds_2x2": runs["2x2"][1], "tokens_equal": same,
                      "tokens": list(runs["2x2"][0].shape)}
    emit(rec)
    return rec


def phase_sharded_cards(seed: int) -> int:
    """11d: with two or more cards, 11b and 11c with the (2, 2) mesh's
    positions spread round robin over them; otherwise a record that it
    did not run. Returns the flash launches."""
    import torch
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "sharded_train", "leg": "11d spread", "ran": False,
              "cards": cards, "reason": f"{cards} visible card"})
        return 0
    spread = [f"cuda:{i % cards}" for i in range(4)]
    rec = sharded_parity(seed, spread, "sharded 11d")
    emit({"phase": "sharded_train", "leg": "11d spread", "ran": True,
          "cards": cards, **rec})
    phase_sharded_serve(seed, spread)
    return rec["flash_launches"]


#: 11e: granite-8b at its published widths, cut to 8 of 36 layers (bf16,
#: ~2.15 B parameters, ~35 GB with AdamW on one card), 4 x 2048 tokens a
#: step, on a (1, 4) mesh with every position on cuda:0 beside 1 x 1
TP_TRAIN = dict(arch="granite-8b", n_layers=8, batch=4, seq=2048, steps=3,
                shape=(1, 4))
#: 11e's f32 leg: granite's widths at 2 layers, 2 x 128 tokens, 3 steps on
#: a (1, 2) card mesh against the CPU's one-device step
TP_PARITY = dict(batch=2, seq=128, steps=3)


def tp_cell(cfg, mesh, seed: int, k: dict) -> dict:
    """``k["steps"]`` sharded train steps of ``cfg`` (seeded weights drawn
    on cuda:0, placed on ``mesh``) from seeded token batches: losses,
    each step's seconds and flash launches, the peak bytes, and the
    matmul FLOPs ``FlopCounterMode`` counts in the first step (which
    the median leaves out)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import placement
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   adamw_init, make_train_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=MESH_DEVICE)
                         .manual_seed(seed), MESH_DEVICE)
    state = placement.place_tree(
        TrainState(params, adamw_init(params)),
        TrainState(specs.param_shardings(cfg, mesh),
                   specs.opt_state_shardings(cfg, mesh,
                                             zero1=mesh.size > 1)))
    del params
    step = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**TRAIN_OPT),
                           mesh=mesh)
    losses, secs, flash, flops = [], [], [], None
    for i in range(k["steps"]):
        b = _on(_train_inputs(cfg, k["batch"], k["seq"], i, seed),
                MESH_DEVICE)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        if i == 0:
            with FlopCounterMode(display=False) as fc:
                state, m = step(state, b)
            flops = fc.get_total_flops()
        else:
            state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = read_launches()
        if any(v for name, v in launches.items() if name != "flash"):
            raise AssertionError(f"11e: launches {launches}")
        flash.append(launches["flash"])
    del state
    torch.cuda.empty_cache()
    median = statistics.median(secs[1:])
    return {"mesh": mesh.shape, "losses": losses, "step_seconds": secs,
            "step_s_median_after_first": median,
            "tokens_per_s": k["batch"] * k["seq"] / median,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "flash_launches_per_step": flash,
            "matmul_flops_step_process": flops}


def phase_tp_train(seed: int) -> int:
    """11e, the tensor-parallel step: granite-8b (``TP_TRAIN``) on a
    (1, 4) mesh with every position on cuda:0, then on the 1 x 1 host
    mesh, the same seed: 64 flash launches a step on (1, 4) (8 layers x
    forward and remat x 4 shards' heads) against 16, the losses within
    1e-2 relative, the process's matmul FLOPs equal to
    ``step_matmul_flops`` (every shard of the row; the forward's kernel
    uncounted), each position's reckoned beside 1 x 1's. Then the f32
    leg (``TP_PARITY``): granite's widths at 2 layers on a (1, 2) card
    mesh against the CPU's step within ``TRAIN_TOL``. Returns the flash
    launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import heads_split, tp_split
    from repro_torch.train.sharded import step_matmul_flops
    k = TP_TRAIN
    cfg = dataclasses.replace(get_config(k["arch"]), n_layers=k["n_layers"])
    tp = k["shape"][1]
    if not heads_split(cfg, tp):
        raise AssertionError(f"11e: {cfg.name}'s heads do not split {tp} "
                             "ways")
    legs, total = {}, 0
    for name, mesh in (("1x4", lm_mesh([MESH_DEVICE] * tp, k["shape"])),
                       ("1x1", make_host_mesh(MESH_DEVICE))):
        n = mesh.shape["model"]
        leg = tp_cell(cfg, mesh, seed, k)
        want = train_flash_per_step(cfg, k["seq"], True) * n
        if leg["flash_launches_per_step"] != [want] * k["steps"]:
            raise AssertionError(f"11e {name}: flash launches "
                                 f"{leg['flash_launches_per_step']}, {want} "
                                 "a step expected")
        reckoned = step_matmul_flops(cfg, k["batch"], k["seq"], n, local=n,
                                     device="cuda")
        counted = leg["matmul_flops_step_process"]
        if counted != reckoned:
            raise AssertionError(f"11e {name}: {counted} matmul FLOPs, "
                                 f"{reckoned} reckoned")
        leg["matmul_flops_step_position"] = step_matmul_flops(
            cfg, k["batch"], k["seq"], n, device="cuda")
        leg["tp_split"] = tp_split(cfg, mesh.shape)
        legs[name] = leg
        total += sum(leg["flash_launches_per_step"])
    rel = [abs(a - b) / abs(b) for a, b in
           zip(legs["1x4"]["losses"], legs["1x1"]["losses"])]
    if not all(np.isfinite(legs["1x4"]["losses"])) or max(rel) > 1e-2:
        raise AssertionError(f"11e: losses {legs['1x4']['losses']} against "
                             f"{legs['1x1']['losses']}")
    emit({"phase": "sharded_train", "leg": "11e tensor parallel",
          "model": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, **k, "remat": True,
          "legs": legs, "max_rel_loss_diff": max(rel),
          "position_flops_over_1x1": legs["1x4"]["matmul_flops_step_position"]
          / legs["1x1"]["matmul_flops_step_position"]})
    rec = sharded_parity(seed, [MESH_DEVICE] * 2, "11e f32", arch=k["arch"],
                         shape=(1, 2), k=TP_PARITY, checkpoint=False)
    emit({"phase": "sharded_train", "leg": "11e f32 mesh vs CPU", **rec})
    return total + rec["flash_launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nyx", type=int, default=512,
                    help="edge of the cubic nyx field of phase 3")
    ap.add_argument("--climate", type=str, default="1800x3600",
                    help="shape of the 2D climate field of phase 3")
    ap.add_argument("--parity", type=int, default=128,
                    help="edge of the cubic field of phase 4")
    ap.add_argument("--batch-nyx", type=int, default=128,
                    help="edge of the nyx batch members and the f64 host "
                         "path field")
    ap.add_argument("--zfp-nyx", type=int, default=256,
                    help="edge of the cubic nyx field of the zfplike phase "
                         "(cut from 512 for time)")
    ap.add_argument("--paper-nyx", type=int, default=128,
                    help="edge of the cubic nyx field of the paper phase")
    ap.add_argument("--paper-climate", type=str, default="1800x3600",
                    help="shape of the climate field of the paper phase")
    ap.add_argument("--launcher-shape", type=str, default="128,128,128",
                    help="field shape of the service launcher's verified "
                         "run")
    ap.add_argument("--sharded-nyx", type=int, default=128,
                    help="edge of the cubic nyx field of the sharded "
                         "phase's 3-axis mesh (beside 130x127x129)")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed launches per kernel (median reported)")
    ap.add_argument("--lm-batch", type=int, default=8,
                    help="requests of the phase-5 LM serving run")
    ap.add_argument("--lm-prompt", type=int, default=2048,
                    help="prompt tokens per request (smollm's context)")
    ap.add_argument("--lm-steps", type=int, default=32,
                    help="greedy decode steps after the phase-5 prefill")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import synthetic_field
    from repro_torch.device import full_precision_matmuls
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "matmul_flags", **full_precision_matmuls()})
    build_s = _build.build_all()
    emit({"phase": "build", "seconds": build_s,
          "ptxas": _build.ptxas_summary()})
    phase_sass()

    phase_kernels_small(seed=0)
    phase_fixpass_dense(seed=3)
    phase_stencil_dense(seed=5)
    phase_pack_small(seed=7)
    phase_flash_small(seed=11)
    phase_flash_families(seed=17)
    flash_timing = phase_flash_main(args.reps, seed=13)

    climate_shape = tuple(int(s) for s in args.climate.split("x"))
    fields = [("nyx", synthetic_field("nyx", (args.nyx,) * 3)),
              ("climate", synthetic_field("climate", climate_shape))]
    timing = {}
    for label, f in fields:
        xi = 1e-3 * float(np.ptp(f))
        timing[label] = phase_kernels_main(f, xi, args.reps)
        timing[label].update(phase_pack_main(f, xi, args.reps))

    launches = dict.fromkeys(COUNTERS, 0)
    for entropy in ("deflate", "device-pack"):
        for label, f in fields:
            xi = 1e-3 * float(np.ptp(f))
            for k, v in phase_main_path(label, f, xi, entropy).items():
                launches[k] += v

    t_sharded = 0.0
    for label, f in fields:
        solo = phase_fixloop_strategies(label, f, 1e-3 * float(np.ptp(f)))
        t0 = time.perf_counter()
        for k, v in phase_sharded_fix(label, solo).items():
            launches[k] += v
        t_sharded += time.perf_counter() - t0
        del solo
        torch.cuda.empty_cache()
    steps = [synthetic_field("climate", climate_shape, seed=s)
             for s in range(3, 11)]
    for entropy in ("deflate", "device-pack"):
        phase_batch("climate", steps, [1e-3 * float(np.ptp(f))
                                       for f in steps], entropy)
    t0 = time.perf_counter()
    for k, v in phase_sharded_paths(fields[1][1], steps[:4],
                                    args.sharded_nyx,
                                    args.launcher_shape).items():
        launches[k] += v
    emit({"phase": "sharded_total",
          "seconds": t_sharded + time.perf_counter() - t0})
    members = [synthetic_field("nyx", (args.batch_nyx,) * 3, seed=s)
               for s in range(1, 5)]
    phase_batch("nyx", members,
                [c * float(np.ptp(f)) for c, f in
                 zip((1e-2, 3e-3, 1e-3, 3e-4), members)], "deflate",
                batchings=(dict(batching="compact", compact_every=2),
                           dict(batching="fused")))
    phase_host_path("climate", fields[1][1],
                    1e-3 * float(np.ptp(fields[1][1])))
    f64 = members[0].astype(np.float64)
    phase_host_path("nyx", f64, 1e-3 * float(np.ptp(f64)))
    del f64
    phase_host_path("climate x 1e6", fields[1][1].astype(np.float64) * 1e6,
                    1e-3, over_int32=True)

    phase_parity(args.parity)

    # the paths of the eighth slice, each with its launches counted from 0
    climate = fields[1][1]
    zfp_nyx = synthetic_field("nyx", (args.zfp_nyx,) * 3)
    for label, f in (("climate", climate),
                     ("climate f64", climate.astype(np.float64)),
                     (f"nyx {args.zfp_nyx}", zfp_nyx)):
        for k, v in phase_zfplike(label, f, 1e-3 * float(np.ptp(f))).items():
            launches[k] += v
    del zfp_nyx
    phase_zfplike_parity(64)
    paper_climate = tuple(int(s) for s in args.paper_climate.split("x"))
    for label, f in (
            (f"nyx {args.paper_nyx}",
             synthetic_field("nyx", (args.paper_nyx,) * 3)),
            ("climate", synthetic_field("climate", paper_climate))):
        phase_paper(label, f, 1e-3 * float(np.ptp(f)))
    phase_paper_card_vs_cpu()
    for phase in (
            lambda: phase_service(steps, members,
                                  [c * float(np.ptp(f)) for c, f in
                                   zip((1e-2, 3e-3, 1e-3, 3e-4), members)],
                                  steps[:2]),
            lambda: phase_serve_launcher(args.launcher_shape),
            lambda: phase_guards(steps[:4])):
        for k, v in phase().items():
            launches[k] += v
    del steps, members

    launches["flash"] = phase_lm_serve(args.lm_batch, args.lm_prompt,
                                       args.lm_steps, seed=0)
    phase_lm_parity(seed=1)
    t0 = time.perf_counter()
    for spec in LM_FAMILIES:
        launches["flash"] += phase_lm_family(*spec, seed=2)
    phase_moe_parity(seed=3)
    phase_family_parity(seed=4)
    phase_recurrent_parity(seed=5)
    emit({"phase": "lm_families_total", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    launches["flash"] += phase_train_full(seed=6)
    launches["flash"] += phase_train_parity(seed=7)
    launches["flash"] += phase_train_families(seed=8)
    emit({"phase": "train_total", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    phase_moe_ep_layer(seed=9)
    launches["flash"] += phase_moe_ep_model(seed=2)
    phase_dryrun()
    emit({"phase": "sharded_lm_total", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    launches["flash"] += phase_sharded_train_full(seed=10)
    launches["flash"] += phase_sharded_train_parity(seed=11)
    phase_sharded_serve(seed=12)
    launches["flash"] += phase_sharded_cards(seed=11)
    launches["flash"] += phase_tp_train(seed=13)
    emit({"phase": "sharded_launch_total",
          "seconds": time.perf_counter() - t0})

    # each kernel's row: its times at its main-path shape (nyx for the
    # MSS kernels, the 8 x 2048 prefill for flash), its largest error
    # over every main-path shape it was timed at
    rows = dict(timing["nyx"], flash=flash_timing[FLASH_MAIN[0]])
    errs = {name: [timing[k][name]["max_abs_err"] for k in timing]
            for name in timing["nyx"]}
    errs["flash"] = [flash_timing[s]["max_abs_err"] for s in FLASH_MAIN]
    kernels = []
    for name in COUNTERS:
        t = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCE[name]}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(errs[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "card": smi})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
