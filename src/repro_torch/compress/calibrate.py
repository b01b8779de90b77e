"""One-shot calibration of the stream's fused-vs-pipelined fix policy,
the port of ``repro.compress.calibrate``.

``CompressStream`` runs a coalesced batch's fix loops either as one
batched loop over all members (``pipeline._device_batch_stage``,
``fixes.fused_fix_batch``) or as a solo loop a member behind a shared
transform (``pipeline._device_pipelined_stage``). The crossover is a
property of the machine, so it is measured.

Cost model (per batch member with V voxels, fitted from probe runs):

* pipelined:  ``O + s*V``  — per-call overhead O plus the solo per-voxel
  step cost s (two probe sizes separate O from s);
* fused:      ``sv*V``     — the marginal per-voxel cost of one more
  member inside the batched loop (a B=2 run minus the solo run).

Fusing a member wins while ``O + s*V > sv*V``, i.e. for
``V < O / (sv - s)``; when the batched lane costs no more than the solo
step (``sv <= s``) fusing always wins. The threshold is clamped to
``CLAMP`` (2^9..2^21 voxels) and cached per (backend name, dtype,
device type): calibration runs once per process. The port's
``fused_fix_batch`` steps the active members one by one, so on the card
the batched lane is rarely cheaper than the solo one.

``MSZ_FUSED_FIX_VOXELS`` overrides everything (an integer voxel
threshold), and an explicit ``fused_fix_voxels=<int>`` stream argument
overrides even that.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, _h2d, resolve_device, torch_dtype

ENV_VAR = "MSZ_FUSED_FIX_VOXELS"
CLAMP = (1 << 9, 1 << 21)
#: probe fields: two sizes to separate per-call overhead from per-voxel
#: step cost (both converge in one fix iteration, so timings compare one
#: step plus overhead, never iteration-count noise)
PROBES = ((8, 8, 8), (16, 16, 16))
_REPS = 3

#: number of real measurements taken (not env/cache hits)
measure_count = 0  # guarded-by: _lock


@dataclasses.dataclass(frozen=True)
class FixCalibration:
    """One calibration outcome: the policy threshold plus the fitted
    model terms behind it (zeros when ``source == "env"``)."""
    threshold_voxels: int     # fuse members with V <= this many voxels
    overhead_s: float         # fitted per-call overhead O
    solo_voxel_s: float       # fitted solo per-voxel step cost s
    batched_voxel_s: float    # marginal batched per-voxel cost sv
    source: str               # "env" | "measured"


_cache: Dict[Tuple, FixCalibration] = {}  # guarded-by: _lock
_lock = threading.Lock()


def clear_cache() -> None:
    """Drop every cached measurement (tests; a live process never needs
    this)."""
    with _lock:
        _cache.clear()


def _env_threshold() -> Optional[int]:
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_VAR} must be an integer voxel threshold, got {raw!r}"
        ) from None
    if v < 0:
        raise ValueError(f"{ENV_VAR} must be >= 0, got {v}")
    return v


def _sync(dev: torch.device) -> None:
    """Wait for the card (the port's ``block_until_ready``)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_best(fn, reps: int = _REPS) -> float:
    """Best-of-``reps`` wall time of ``fn`` after one untimed warm-up
    call (which absorbs the kernels' build and load). The timed reps run
    under ``debug.no_recompiles()``: a build inside the measured region
    would corrupt the fitted model, so it fails instead."""
    from ..debug import no_recompiles
    fn()
    best = float("inf")
    with no_recompiles(label="calibrate._time_best"):
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def _measure(be, dtype, dev: torch.device) -> FixCalibration:
    global measure_count
    from ..core import fixes

    with _lock:
        measure_count += 1
    rng = np.random.default_rng(0)
    t_solo = []
    probes = []
    for shape in PROBES:
        f = _h2d(rng.standard_normal(shape).astype(dtype), dev)
        topo = fixes.field_topology(f, 0.1)
        probes.append((f, topo))

        def run(f=f, topo=topo):
            fixes.fused_fix(f, topo, max_iters=8, backend=be)
            _sync(dev)

        t_solo.append(_time_best(run))

    v1, v2 = (int(np.prod(p)) for p in PROBES)
    s = max((t_solo[1] - t_solo[0]) / (v2 - v1), 0.0)
    overhead = max(t_solo[0] - s * v1, 0.0)

    # marginal cost of a second member in the batched loop, at the larger
    # probe (identical members converge together, so the difference is
    # lane cost, not straggler wait)
    f2, topo2 = probes[1]
    g_b = torch.stack([f2, f2])
    topo_b = fixes.FieldTopo(*(torch.stack([x, x]) for x in topo2))

    def run_b2():
        fixes.fused_fix_batch(g_b, topo_b, max_iters=8, backend=be,
                              batching="fused")
        _sync(dev)

    sv = max((_time_best(run_b2) - t_solo[1]) / v2, 0.0)

    if sv <= s:                     # batched lane free or cheaper: fuse
        thr = CLAMP[1]
    else:
        thr = int(overhead / (sv - s))
    thr = max(CLAMP[0], min(CLAMP[1], thr))
    return FixCalibration(threshold_voxels=thr, overhead_s=overhead,
                          solo_voxel_s=s, batched_voxel_s=sv,
                          source="measured")


def fused_fix_threshold(backend, dtype=np.float32,
                        device: DeviceLike = None) -> FixCalibration:
    """The fused-vs-pipelined voxel threshold for ``backend`` on
    ``device`` (``None``: CUDA): the ``MSZ_FUSED_FIX_VOXELS`` override
    when set, else the cached measurement for (backend name, dtype,
    device type), else a fresh probe run. ``backend`` is a resolved
    stencil backend or a registry name."""
    env = _env_threshold()
    if env is not None:
        return FixCalibration(threshold_voxels=env, overhead_s=0.0,
                              solo_voxel_s=0.0, batched_voxel_s=0.0,
                              source="env")
    dev = resolve_device(device)
    dtype = np.dtype(dtype)
    if isinstance(backend, str):
        from ..core.backend import resolve_backend
        backend = resolve_backend(backend, PROBES[0], torch_dtype(dtype),
                                  dev)
    key = (getattr(backend, "name", str(backend)), dtype.str, dev.type)
    with _lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit
    cal = _measure(backend, dtype, dev)
    with _lock:
        return _cache.setdefault(key, cal)
