"""Multi-pod dry-run, the port of ``repro.launch.dryrun``: every
(architecture x input shape) on the production meshes, on ``meta``
tensors: the per-device bytes of the cell's arguments under the port's
sharding specs, and the cell's own step run at its global shape as a
shape check of the whole step, with its FLOPs counted.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out experiments/dryrun_torch

The mesh is ``make_production_mesh(multi_pod, devices=["meta"] * n)``:
256 or 512 placements and no device. The step is ``models.forward``
(prefill), ``serve.make_serve_step`` (decode) or ``train.make_train_step``
(train), the counterpart of the reference's ``.lower()``; nothing is
compiled. ``cost.flops`` is ``torch.utils.flop_counter.FlopCounterMode``
over that step: global (the whole mesh's work), counting the matmuls
(the plain attention's tiles among them) and nothing elementwise. XLA's
collective statistics and its temp/peak memory come from the compiled
HLO and have no counterpart here: ``collectives`` is null with that
reason. ``REPRO_MOE_EP=1`` runs the MoE expert-parallel
(``layers.MOE_EP_MODE``), ``REPRO_GRAD_COMPRESS=1`` the compressed
cross-pod gradient sync (``REPRO_GC_BITS``), as in the reference.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path
from typing import Optional

from ..configs import ARCH_IDS, get_config
from ..models import forward as model_forward
from ..models import layers as _layers
from ..models.config import SHAPES, ArchConfig, ShapeConfig, shape_by_name
from ..models.sharding import use_mesh
from ..serve import make_serve_step
from ..train import (AdamWConfig, TrainState, TrainStepConfig,
                     make_train_step)
from . import specs as S
from .mesh import make_production_mesh

#: archs that cannot serve a 524288-token dense-attention context; the
#: shape is defined for sub-quadratic families
FULL_ATTENTION_ARCHS = {
    "llava_next_34b", "grok_1_314b", "qwen3_moe_235b_a22b",
    "deepseek_coder_33b", "smollm_135m", "granite_8b", "gemma2_9b",
    "whisper_base",
}

#: what the FLOP count covers
FLOPS_COUNT = ("global FLOPs of the step's matmuls (attention tiles "
               "included; elementwise work not counted), "
               "torch.utils.flop_counter on meta tensors")

#: why the record has no collective statistics
NO_COLLECTIVES = ("XLA's collective statistics and temp/peak memory come "
                  "from the compiled HLO; the port compiles nothing")


def cell_is_applicable(arch: str, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return False, ("skipped: long_500k requires sub-quadratic decode; "
                       f"{arch} is full-attention (DESIGN.md §4)")
    return True, ""


def _train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(step thunk, per-device bytes of each argument, extra record)."""
    n_pods = S.mesh_shape_dict(mesh).get("pod", 1)
    grad_compress = (os.environ.get("REPRO_GRAD_COMPRESS", "0") == "1"
                     and n_pods > 1)
    tcfg = TrainStepConfig(
        remat=True, n_microbatches=1, grad_compress=grad_compress,
        grad_compress_bits=int(os.environ.get("REPRO_GC_BITS", "16")),
        n_pods=n_pods)
    step_fn = make_train_step(cfg, tcfg, AdamWConfig(), mesh=mesh)
    fsdp = S.needs_fsdp(cfg, mesh)
    params = S.param_structs(cfg)
    opt = S.opt_state_structs(cfg)
    batch = S.batch_spec(cfg, shape, mesh)
    mem = {
        "params": S.shard_bytes(params, S.param_shardings(
            cfg, mesh, zero1=fsdp, data_only=grad_compress,
            replicate_embed=grad_compress)),
        "opt_state": S.shard_bytes(opt, S.opt_state_shardings(cfg, mesh)),
        "batch": S.shard_bytes(batch, S.batch_shardings(batch, cfg, mesh))}
    return (lambda: step_fn(TrainState(params, opt), batch), mem,
            {"fsdp": fsdp})


def _prefill_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    fsdp = S.needs_fsdp(cfg, mesh)
    params = S.param_structs(cfg)
    batch = S.batch_spec(cfg, shape, mesh)
    mem = {"params": S.shard_bytes(params, S.param_shardings(
               cfg, mesh, zero1=fsdp)),
           "batch": S.shard_bytes(batch, S.batch_shardings(batch, cfg,
                                                           mesh))}
    return (lambda: model_forward(cfg, params, batch, logits_mode="last",
                                  return_cache=True), mem, {})


def _serve_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    serve = make_serve_step(cfg)
    params = S.param_structs(cfg)
    cache = S.cache_structs(cfg, shape)
    batch = S.batch_spec(cfg, shape, mesh)
    mem = {"params": S.shard_bytes(params, S.param_shardings(
               cfg, mesh, zero1=False)),
           "cache": S.shard_bytes(cache, S.cache_shardings(cfg, shape,
                                                           mesh)),
           "batch": S.shard_bytes(batch, S.batch_shardings(batch, cfg,
                                                           mesh))}
    # the last position: the step reads the whole cache
    return (lambda: serve(params, cache, batch["tokens"], shape.seq_len - 1),
            mem, {})


_CELLS = {"train": _train_cell, "prefill": _prefill_cell,
          "decode": _serve_cell}


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell's record: status "ok" with ``memory`` (per-device bytes
    of params, opt_state (train), cache (decode) and batch, and their
    sum ``argument_size_bytes`` / ``_gb``), ``cost.flops`` and the step's
    seconds; "skipped" with the reason; or "error" with the exception."""
    from torch.utils.flop_counter import FlopCounterMode
    _layers.MOE_EP_MODE = os.environ.get("REPRO_MOE_EP", "0") == "1"
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    ok, why = cell_is_applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    t0 = time.perf_counter()
    try:
        step, mem, extra = _CELLS[shape.kind](cfg, shape, mesh)
        t_specs = time.perf_counter() - t0
        t0 = time.perf_counter()
        with use_mesh(mesh), FlopCounterMode(display=False) as fc:
            step()
        t_step = time.perf_counter() - t0
        total = sum(mem.values())
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "ok", "moe_ep": _layers.MOE_EP_MODE,
            "t_specs_s": t_specs, "t_step_s": t_step,
            "memory": {**{f"{k}_bytes": v for k, v in mem.items()},
                       "argument_size_bytes": total,
                       "argument_size_gb": round(total / 2**30, 3)},
            "cost": {"flops": fc.get_total_flops(), "counts": FLOPS_COUNT},
            "collectives": None, "collectives_reason": NO_COLLECTIVES,
            **extra,
        }
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    t_all = time.perf_counter()
    for arch in archs:
        for sh in shapes:
            for mp in meshes:
                tag = f"{arch}__{sh}__{'pod2' if mp else 'pod1'}"
                fn = out / f"{tag}.json"
                if fn.exists() and not args.force:
                    print(f"[cached] {tag}")
                    continue
                print(f"[run] {tag} ...", flush=True)
                res = run_cell(arch, sh, mp)
                fn.write_text(json.dumps(res, indent=1))
                status = res["status"]
                extra = ""
                if status == "ok":
                    extra = (f" step={res['t_step_s']:.1f}s "
                             f"flops={res['cost']['flops']:.3g} "
                             f"args={res['memory']['argument_size_gb']}GB")
                elif status == "error":
                    extra = " " + res["error"][:200]
                print(f"[{status}] {tag}{extra}", flush=True)
    print(f"[done] {time.perf_counter() - t_all:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
