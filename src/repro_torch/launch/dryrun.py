"""Multi-pod dry-run, the port of ``repro.launch.dryrun``: every
(architecture x input shape) on the production meshes, each cell run as
one rank of the mesh on ``meta`` tensors: the per-device bytes of its
arguments, of its outputs and at its peak, its FLOPs and every
collective it issues, with their bytes.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out experiments/dryrun_torch

The mesh is ``launch.mesh.dry_rank``: rank p of the (16, 16) or
(2, 16, 16) production mesh with no process group, where p is the first
model index with the most query heads (``sharding.shard_heads``), every
other axis at index 0; the record names it (``position``). The rank
places its arguments (``distributed.placement.place_tree``) by the
reference's shardings and runs the partitioned step that ranks run
across processes, the
counterpart of the reference's ``.lower()`` of its jitted step: train
``make_train_step(mesh=)`` (``train.sharded``, FSDP where
``specs.needs_fsdp`` says, the pods' compressed sync under
``REPRO_GRAD_COMPRESS=1``, ``REPRO_GC_BITS``), prefill
``serve.sharded.make_sharded_prefill``, decode
``make_sharded_serve_step`` at the last position over ``place_cache``.
``REPRO_MOE_EP=1`` runs the MoE expert-parallel
(``layers.MOE_EP_MODE``). Nothing is compiled, and nothing launches.

The record holds ``collectives``, in the keys of the reference's
``collective_stats``: each kind's count and bytes as the rank issued
them (``distributed.collectives``; the reference's byte rule, each
op's larger of operand and result), with ``entry_bytes`` the total and
``body_bytes`` 0 (every collective counted where it runs). ``memory``:
the arguments' bytes (the reference's shard bytes), the outputs' at the
position, and the peak of the live bytes during the step
(``LiveBytes``, the arguments live from the start; temp = peak -
arguments), in bytes and in the reference's ``*_gb``. ``cost.flops``:
``torch.utils.flop_counter.FlopCounterMode`` over the rank's step, the
position's own FLOPs, as the reference's ``cost_analysis`` of its
partitioned program is a device's. The port's partitioned schedule is
its own (an all-gather and an ordered sum where XLA reduce-scatters),
so the numbers are not the reference's HLO's. ``--save-hlo`` has no
counterpart: the port has no HLO.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import tree
from ..configs import ARCH_IDS, get_config
from ..distributed import collectives as C
from ..distributed import placement as PL
from ..models import layers as _layers
from ..models.config import SHAPES, ArchConfig, ShapeConfig, shape_by_name
from ..models.sharding import shard_heads, use_mesh
from ..serve.sharded import (make_sharded_prefill, make_sharded_serve_step,
                             place_cache, prefill_param_shardings,
                             serve_param_shardings)
from ..train import (AdamWConfig, TrainState, TrainStepConfig,
                     make_train_step)
from . import specs as S
from .mesh import dry_rank, production_shape

#: archs that cannot serve a 524288-token dense-attention context; the
#: shape is defined for sub-quadratic families
FULL_ATTENTION_ARCHS = {
    "llava_next_34b", "grok_1_314b", "qwen3_moe_235b_a22b",
    "deepseek_coder_33b", "smollm_135m", "granite_8b", "gemma2_9b",
    "whisper_base",
}

#: what the FLOP count covers
FLOPS_COUNT = ("one position's FLOPs of the step's matmuls (attention "
               "tiles included; elementwise work not counted), "
               "torch.utils.flop_counter over the rank's step on meta "
               "tensors")

#: what the peak counts, and the rule that overstates it
PEAK_COUNTS = ("the most bytes live on the rank during the step: the "
               "arguments' shard bytes from the start, then every storage "
               "the step makes until it is freed; on meta attention runs "
               "the plain version in tiles of at least S / 8 rows (the "
               "chunked oracle in chunks of at least S / 8), whose score "
               "tiles the card's flash kernel never allocates, so the "
               "peak overstates attention's temporaries")


def cell_is_applicable(arch: str, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return False, ("skipped: long_500k requires sub-quadratic decode; "
                       f"{arch} is full-attention (DESIGN.md §4)")
    return True, ""


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages made while it is on that are still
    alive (``live``), and their most (``peak``): each op's new outputs
    (a return without an alias annotation: no view, no in-place) add
    their storage's ``nbytes`` once, and ``weakref.finalize`` takes them
    off when the storage is freed. The stand-ins ``launch.specs`` makes
    (``stand_ins``: shapes only on every device) are not counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        if t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if S.MAKING_STAND_INS.get():
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, o in zip(func._schema.returns, outs):
            if ret.alias_info is not None:
                continue
            for t in (o if isinstance(o, (tuple, list)) else (o,)):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out


def local_bytes(obj: Any) -> int:
    """The bytes of the distinct storages this process holds of a tree
    of tensors and ``placement.Sharded`` leaves (their local shards)."""
    seen: Dict[int, int] = {}
    for leaf in tree.leaves(obj):
        ts = (list(leaf.local.values()) if isinstance(leaf, PL.Sharded)
              else [leaf])
        for t in ts:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[id(st)] = st.nbytes()
    return sum(seen.values())


def measure(step: Callable[[], Any], argument_bytes: int) -> dict:
    """Run ``step`` once under ``FlopCounterMode`` and ``LiveBytes``,
    the collectives' tally zeroed first: its ``collectives``
    (``collectives.stats()``), ``flops``, ``peak_bytes`` (the arguments'
    ``argument_bytes`` plus the step's live peak), ``output_bytes``
    (``local_bytes`` of what it returns) and ``seconds``."""
    from torch.utils.flop_counter import FlopCounterMode
    C.reset()
    # no cyclic collection while it runs: what a cycle holds is freed at
    # the same op on every run
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with FlopCounterMode(display=False) as fc, LiveBytes() as live:
            out = step()
    finally:
        gc.enable()
    secs = time.perf_counter() - t0
    return {"collectives": C.stats(), "flops": fc.get_total_flops(),
            "peak_bytes": argument_bytes + live.peak,
            "output_bytes": local_bytes(out), "seconds": secs}


def _train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(place: () -> the step thunk, placing the arguments; per-device
    bytes of each argument; extra record)."""
    n_pods = S.mesh_shape_dict(mesh).get("pod", 1)
    grad_compress = (os.environ.get("REPRO_GRAD_COMPRESS", "0") == "1"
                     and n_pods > 1)
    tcfg = TrainStepConfig(
        remat=True, n_microbatches=1, grad_compress=grad_compress,
        grad_compress_bits=int(os.environ.get("REPRO_GC_BITS", "16")),
        n_pods=n_pods)
    fsdp = S.needs_fsdp(cfg, mesh)
    params = S.param_structs(cfg)
    opt = S.opt_state_structs(cfg)
    batch = S.batch_spec(cfg, shape, mesh)
    shardings = TrainState(
        S.param_shardings(cfg, mesh, zero1=fsdp, data_only=grad_compress,
                          replicate_embed=grad_compress),
        S.opt_state_shardings(cfg, mesh))
    mem = {
        "params": S.shard_bytes(params, shardings.params),
        "opt_state": S.shard_bytes(opt, shardings.opt),
        "batch": S.shard_bytes(batch, S.batch_shardings(batch, cfg, mesh))}

    def place():
        step_fn = make_train_step(cfg, tcfg, AdamWConfig(), mesh=mesh)
        state = PL.place_tree(TrainState(params, opt), shardings)
        return lambda: step_fn(state, batch)
    return place, mem, {"fsdp": fsdp}


def _prefill_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    params = S.param_structs(cfg)
    batch = S.batch_spec(cfg, shape, mesh)
    p_shard = prefill_param_shardings(cfg, mesh)
    mem = {"params": S.shard_bytes(params, p_shard),
           "batch": S.shard_bytes(batch, S.batch_shardings(batch, cfg,
                                                           mesh))}

    def place():
        prefill = make_sharded_prefill(cfg, mesh, max_len=shape.seq_len)
        placed = PL.place_tree(params, p_shard)
        return lambda: prefill(placed, batch)
    return place, mem, {"fsdp": S.needs_fsdp(cfg, mesh)}


def _serve_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    params = S.param_structs(cfg)
    cache = S.cache_structs(cfg, shape)
    batch = S.batch_spec(cfg, shape, mesh)
    p_shard = serve_param_shardings(cfg, mesh)
    mem = {"params": S.shard_bytes(params, p_shard),
           "cache": S.shard_bytes(cache, S.cache_shardings(cfg, shape,
                                                           mesh)),
           "batch": S.shard_bytes(batch, S.batch_shardings(batch, cfg,
                                                           mesh))}

    def place():
        serve = make_sharded_serve_step(cfg, mesh)
        placed = PL.place_tree(params, p_shard)
        placed_cache = place_cache(cfg, mesh, shape.global_batch,
                                   shape.seq_len)
        # the last position: the step reads the whole cache
        return lambda: serve(placed, placed_cache, batch["tokens"],
                             shape.seq_len - 1)
    return place, mem, {}


_CELLS = {"train": _train_cell, "prefill": _prefill_cell,
          "decode": _serve_cell}


def cell_position(cfg: ArchConfig, multi_pod: bool) -> int:
    """The flat position a cell runs: the first model index with the
    most query heads (``sharding.shard_heads``), every other axis at 0."""
    tp = production_shape(multi_pod)[0][-1]
    heads = [s.q[1] - s.q[0] for s in shard_heads(cfg.n_heads,
                                                  cfg.n_kv_heads, tp)]
    return heads.index(max(heads))


def _gb(n: int) -> float:
    return round(n / 2**30, 3)


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell's record: status "ok" with ``position`` (its mesh
    coordinates), ``memory`` (per-device bytes of params, opt_state
    (train), cache (decode) and batch, their sum
    ``argument_size_bytes``, ``output_size_bytes``, ``peak_bytes``,
    ``temp_size_bytes`` and the reference's four ``*_gb``),
    ``cost.flops``, ``collectives`` and the seconds; "skipped" with the
    reason; or "error" with the exception."""
    _layers.MOE_EP_MODE = os.environ.get("REPRO_MOE_EP", "0") == "1"
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    ok, why = cell_is_applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    pos = cell_position(cfg, multi_pod)
    mesh = dry_rank(*production_shape(multi_pod), pos)
    t0 = time.perf_counter()
    try:
        place, mem, extra = _CELLS[shape.kind](cfg, shape, mesh)
        args = sum(mem.values())
        with use_mesh(mesh):
            step = place()
            t_specs = time.perf_counter() - t0
            got = measure(step, args)
        out, peak = got["output_bytes"], got["peak_bytes"]
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "ok", "moe_ep": _layers.MOE_EP_MODE,
            "position": mesh.coords(pos),
            "t_specs_s": t_specs, "t_step_s": got["seconds"],
            "memory": {**{f"{k}_bytes": v for k, v in mem.items()},
                       "argument_size_bytes": args,
                       "output_size_bytes": out,
                       "temp_size_bytes": peak - args,
                       "peak_bytes": peak,
                       "argument_size_gb": _gb(args),
                       "output_size_gb": _gb(out),
                       "temp_size_gb": _gb(peak - args),
                       "peak_gb": _gb(peak),
                       "peak_counts": PEAK_COUNTS},
            "cost": {"flops": got["flops"], "counts": FLOPS_COUNT},
            "collectives": got["collectives"],
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
                             f"args={res['memory']['argument_size_gb']}GB "
                             f"peak={res['memory']['peak_gb']}GB "
                             f"coll={res['collectives']['total_bytes']:.3g}B")
                elif status == "error":
                    extra = " " + res["error"][:200]
                print(f"[{status}] {tag}{extra}", flush=True)
    print(f"[done] {time.perf_counter() - t_all:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
