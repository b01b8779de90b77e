#!/usr/bin/env python3
"""Cells of ``chip_smoke.py``'s phase 11 from one checkout, to compare two
checkouts on one card.

    python3 tools/tp_ab.py .                       # this checkout
    python3 tools/tp_ab.py build/parent 11a,11e    # another one's cells
    python3 tools/tp_ab.py . phase_tp_production   # a phase function

The first argument is the root of a checkout (another commit unpacked
with ``git archive`` into a directory ``.gitignore`` lists, such as
``build/``); that checkout's ``chip_smoke.py`` and ``src/`` run, so the
cells are that commit's. The second is a comma-separated list (default
``11a,11e,11f_hymba,prof_11a``):

* ``11a``: ``phase_sharded_train_full`` (smollm-135m, 8 x 2048, bf16, on
  a (2, 2) mesh of cuda:0 and on 1 x 1);
* ``11e``, ``11f_hymba``: ``tp_legs`` of granite-8b's and hymba-1.5b's
  cells (their f32 legs against the CPU left out);
* ``11h``: ``tp_cell`` of 11h's MoE cell (``MOE_CELL``, defined here
  so that a parent without 11h runs the same cell) on (2, 2) and on
  1 x 1, with the process's matmul FLOPs of the first step;
* ``11i``: the same cell under ``layers.MOE_EP_MODE`` with each mesh
  ambient (``EP_CELL``: capacity factor 4.0, seed 17, as chip_smoke's
  11i), on (2, 2) and on 1 x 1; a checkout whose train step cannot run
  it fails the cell, and the traceback is printed;
* ``prof_11a``: one (2, 2) smollm-135m step after two warm ones under
  ``torch.profiler``: its wall seconds, the kernel launches
  (``cudaLaunchKernel`` calls), the sum of every row's self device time
  (each kernel counts under its op and under its own row, so only a
  ratio between two runs means something) and the rows with the most;
* any ``phase_*`` function of ``chip_smoke.py`` by name, with the seed
  ``chip_smoke.main`` gives it.

Compare two commits in one call, in turns (parent, change, change,
parent), one process each. Prints ``chip_smoke``'s records and, last,
one ``{"tp_ab": ...}`` line with each cell's step seconds (median after
the first, each step, peak bytes) and seconds; exits 1 if a cell
failed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

#: the seeds ``chip_smoke.main`` gives its phase functions
SEEDS = dict(phase_flash_segments=19, phase_sharded_train_full=10,
             phase_sharded_train_parity=11, phase_sharded_serve=12,
             phase_sharded_cards=11, phase_tp_train=13,
             phase_recurrent_tp=14, phase_tp_production=15,
             phase_moe_rows=16)


#: ``chip_smoke.MOE_ROWS``' cell: qwen3-moe at d_model 512 and expert
#: d_ff 256 (its heads, experts, top-k and vocabulary), 4 layers, bf16,
#: 3 steps of 4 x 2048 tokens, seed 16
MOE_CELL = dict(arch="qwen3-moe-235b-a22b", n_layers=4, d_model=512,
                d_ff=256, batch=4, seq=2048, steps=3, seed=16)
#: ``chip_smoke.MOE_EP``' cell: the MoE cell at capacity factor 4.0,
#: seed 17, run expert-parallel
EP_CELL = dict(MOE_CELL, seed=17, capacity_factor=4.0)


def steps(rec: dict) -> dict:
    return {n: (leg["step_s_median_after_first"], leg["step_seconds"],
                leg["peak_device_bytes"]) for n, leg in rec["legs"].items()}


def profile_smollm(C) -> dict:
    """One (2, 2) smollm-135m step (8 x 2048, bf16, remat) under
    ``torch.profiler`` after two warm steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.distributed import placement
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState,
                                   TrainStepConfig, adamw_init,
                                   make_train_step)
    cfg = get_config("smollm-135m")
    mesh = C.lm_mesh([C.MESH_DEVICE] * 4)
    p = init_params(cfg, torch.Generator(device=C.MESH_DEVICE)
                    .manual_seed(0), C.MESH_DEVICE)
    st = placement.place_tree(TrainState(p, adamw_init(p)), TrainState(
        specs.param_shardings(cfg, mesh),
        specs.opt_state_shardings(cfg, mesh, zero1=True)))
    del p
    fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(), mesh=mesh)
    b = C._on(C._train_inputs(cfg, 8, 2048, 0, 10), C.MESH_DEVICE)
    for _ in range(2):
        st, m = fn(st, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, m = fn(st, b)
        float(m["loss"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = prof.key_averages()
    launches = sum(e.count for e in rows if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "launches": launches,
            "device_time_rows_s": sum(e.self_device_time_total
                                      for e in rows) / 1e6,
            "top_device": [(e.key[:80], e.count,
                            e.self_device_time_total / 1e6) for e in top]}


def run_cell(C, cell: str):
    from repro_torch.configs import get_config
    if cell == "11a":
        rec: dict = {}
        real = C.emit
        C.emit = rec.update
        try:
            C.phase_sharded_train_full(seed=SEEDS["phase_sharded_train_full"])
        finally:
            C.emit = real
        return steps(rec)
    if cell in ("11e", "11f_hymba"):
        k = C.TP_TRAIN if cell == "11e" else C.RECURRENT_TP["hymba"]
        cfg = dataclasses.replace(get_config(k["arch"]),
                                  n_layers=k["n_layers"])
        return steps(C.tp_legs(cell, cfg, k, 13 if cell == "11e" else 14))
    if cell in ("11h", "11i"):
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import layers
        k = MOE_CELL if cell == "11h" else EP_CELL
        base = get_config(k["arch"])
        cfg = dataclasses.replace(base, n_layers=k["n_layers"],
                                  d_model=k["d_model"], d_ff=k["d_ff"])
        if cell == "11i":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                base.moe, capacity_factor=k["capacity_factor"]))
        legs = {}
        layers.MOE_EP_MODE = cell == "11i"
        try:
            for name, mesh in (("2x2", C.lm_mesh([C.MESH_DEVICE] * 4)),
                               ("1x1", make_host_mesh(C.MESH_DEVICE))):
                with mesh if cell == "11i" else contextlib.nullcontext():
                    legs[name] = C.tp_cell(cfg, mesh, k["seed"], k,
                                           f"{cell} {name}")
        finally:
            layers.MOE_EP_MODE = False
        return {n: steps({"legs": legs})[n]
                + (leg["matmul_flops_step_process"], leg["losses"])
                for n, leg in legs.items()}
    if cell == "prof_11a":
        return profile_smollm(C)
    return getattr(C, cell)(seed=SEEDS[cell])


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    cells = (sys.argv[2] if len(sys.argv) > 2 else
             "11a,11e,11f_hymba,prof_11a").split(",")
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("tp_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.device import full_precision_matmuls
    from repro_torch.kernels import _build
    full_precision_matmuls()
    _build.build_all(("flash",))
    out = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "failed": []}
    for cell in cells:
        t0 = time.perf_counter()
        try:
            out[cell] = run_cell(C, cell)
        except Exception:
            traceback.print_exc()
            out["failed"].append(cell)
        out[cell + "_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print(json.dumps({"tp_ab": out}), flush=True)
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
