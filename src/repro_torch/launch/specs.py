"""Dry-run input specs, the port of ``repro.launch.specs``: meta-tensor
stand-ins for every model input (the shapes and dtypes of the reference's
``ShapeDtypeStruct``s, no storage) and the sharding trees that place
them on the production mesh.

A ``NamedSharding`` is the pair (mesh, ``P``) of the reference's
``jax.sharding.NamedSharding``, with its ``shard_shape``: the per-device
shape of a global shape under the spec, the bytes the dry-run counts a
device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree
from ..models import init_decode_cache, init_params
from ..models.config import ArchConfig, ShapeConfig
from ..models.sharding import (P, MeshAxes, axes_for_mesh, mesh_shape_dict,
                               tree_param_specs)
from ..train.optimizer import AdamWState, adamw_init


class NamedSharding:
    """A ``P`` over the axes of ``mesh`` (a ``launch.mesh.DeviceMesh``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def shard_shape(self, global_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Each dimension divided by the product of the sizes of the mesh
        axes its entry names (a dimension they do not divide raises, as
        the reference's does)."""
        sizes = mesh_shape_dict(self.mesh)
        out = []
        for i, n in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            parts = math.prod(sizes[a] for a in names)
            if n % parts:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} "
                                 f"does not divide over {names} ({parts})")
            out.append(n // parts)
        return tuple(out)

    def __repr__(self) -> str:
        return (f"NamedSharding(mesh={mesh_shape_dict(self.mesh)}, "
                f"spec={self.spec!r})")


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dp_degree(mesh) -> int:
    ms = mesh_shape_dict(mesh)
    return math.prod(v for k, v in ms.items() if k in ("pod", "data"))


def batch_spec(cfg: ArchConfig, shape: ShapeConfig, mesh
               ) -> Dict[str, torch.Tensor]:
    """Meta tensors for one global batch of this (arch x shape)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _struct((B, 1), torch.int32)}
    batch: Dict[str, torch.Tensor] = {}
    s_text = S
    if cfg.n_img_tokens:
        s_text = S - cfg.n_img_tokens
        batch["image_embeds"] = _struct((B, cfg.n_img_tokens, cfg.d_model),
                                        torch.bfloat16)
    if cfg.enc_dec:
        batch["frames"] = _struct((B, cfg.enc_positions, cfg.d_model),
                                  torch.bfloat16)
    batch["tokens"] = _struct((B, s_text), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _struct((B, s_text), torch.int32)
    return batch


def _auto_spec(shape: Tuple[int, ...], ax: MeshAxes, ms: dict,
               batch_dim: Optional[int]) -> P:
    """Shard batch_dim over dp when divisible; then the largest remaining
    dim divisible by tp over model."""
    dp = math.prod(ms.get(a, 1) for a in ax.batch)
    tp = ms.get(ax.model, 1)
    spec: list = [None] * len(shape)
    if batch_dim is not None and shape[batch_dim] % dp == 0 \
            and shape[batch_dim] >= dp:
        spec[batch_dim] = ax.batch if len(ax.batch) > 1 else ax.batch[0]
    cands = [(s, i) for i, s in enumerate(shape)
             if i != batch_dim and s % tp == 0 and s >= tp]
    if cands:
        _, i = max(cands)
        spec[i] = ax.model
    return P(*spec)


def batch_shardings(batch_sds, cfg: ArchConfig, mesh) -> Any:
    ax = axes_for_mesh(mesh)
    dp = _dp_degree(mesh)

    def spec_of(sds):
        s: list = [None] * sds.ndim
        if sds.shape[0] % dp == 0 and sds.shape[0] >= dp:
            s[0] = ax.batch if len(ax.batch) > 1 else ax.batch[0]
        return NamedSharding(mesh, P(*s))
    return tree.tree_map(spec_of, batch_sds)


def param_structs(cfg: ArchConfig) -> Any:
    """The parameter tree on ``meta`` (``init_params(device="meta")``:
    the shapes and dtypes, nothing drawn or allocated)."""
    return init_params(cfg, None, "meta")


def param_shardings(cfg: ArchConfig, mesh, zero1: bool = False,
                    data_only: bool = False,
                    replicate_embed: bool = False) -> Any:
    """data_only: exclude the pod axis from FSDP/ZeRO specs (the
    reference's for a manual pod axis, the compressed cross-pod gradient
    sync). replicate_embed: keep the embedding table unsharded (the
    reference's workaround of an XLA partitioner crash in that sync)."""
    ax = axes_for_mesh(mesh)
    if data_only:
        ax = MeshAxes(batch=("data",), model=ax.model)
    ms = mesh_shape_dict(mesh)
    shapes = param_structs(cfg)
    specs = tree_param_specs(shapes, ax, ms, zero1=zero1)
    if replicate_embed:
        specs = dict(specs)
        specs["embed"] = P(*([None] * shapes["embed"].ndim))
    return tree.tree_map(lambda s: NamedSharding(mesh, s), specs)


def cache_structs(cfg: ArchConfig, shape: ShapeConfig) -> Any:
    return init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")


def cache_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Any:
    ax = axes_for_mesh(mesh)
    ms = mesh_shape_dict(mesh)
    structs = cache_structs(cfg, shape)
    tp = ms.get(ax.model, 1)
    dp = math.prod(ms.get(a, 1) for a in ax.batch)
    dspec = ax.batch if len(ax.batch) > 1 else ax.batch[0]

    def spec_of_path(name, sds):
        nd = sds.ndim
        # mLSTM matrix memory (.., B, H, D_out, D_in): shard D_out (the
        # contraction OUTPUT of C.q) over model, B over data; D_in (the k
        # side) replicated, so the per-step readout is local
        if "mlstm_C" in name:
            spec = [None] * nd
            if sds.shape[nd - 4] % dp == 0 and sds.shape[nd - 4] >= dp:
                spec[nd - 4] = dspec
            if sds.shape[-2] % tp == 0:
                spec[-2] = ax.model
            return NamedSharding(mesh, P(*spec))
        if "mlstm_n" in name or "slstm" in name:
            # batch-sharded, feature dims replicated (k is replicated)
            spec = [None] * nd
            bdim = nd - 3
            if sds.shape[bdim] % dp == 0 and sds.shape[bdim] >= dp:
                spec[bdim] = dspec
            return NamedSharding(mesh, P(*spec))
        # rank>=4 KV caches: (L,B,T,Hk,Dh) or (B,T,Hk,Dh): batch then T
        if name.endswith(("k", "v")) and nd >= 4:
            return NamedSharding(mesh, _auto_spec(sds.shape, ax, ms, nd - 4))
        if "enc_out" in name:
            return NamedSharding(mesh, _auto_spec(sds.shape, ax, ms, 0))
        # recurrent states: the batch dim is the first of the batch's size
        bdim = next((i for i, s in enumerate(sds.shape)
                     if s == shape.global_batch), None)
        return NamedSharding(mesh, _auto_spec(sds.shape, ax, ms, bdim))

    return tree.unflatten(structs, [spec_of_path(name, leaf) for name, leaf
                                    in tree.flatten_with_path(structs)])


def opt_state_structs(cfg: ArchConfig) -> AdamWState:
    """AdamW's state on ``meta``: f32 moments like the parameters, an
    int32 step."""
    return adamw_init(param_structs(cfg))


def opt_state_shardings(cfg: ArchConfig, mesh, zero1: bool = True
                        ) -> AdamWState:
    """ZeRO-1: optimizer moments additionally sharded over the data axes."""
    ax = axes_for_mesh(mesh)
    ms = mesh_shape_dict(mesh)
    mspecs = tree_param_specs(param_structs(cfg), ax, ms, zero1=zero1)
    to_shard = tree.tree_map(lambda s: NamedSharding(mesh, s), mspecs)
    return AdamWState(step=NamedSharding(mesh, P()), m=to_shard,
                      v=tree.tree_map(lambda s: s, to_shard))


def shard_bytes(structs: Any, shardings: Any) -> int:
    """Bytes one device holds of ``structs`` (meta tensors) under
    ``shardings`` (a tree of the same structure): each leaf's shard
    shape times its item size, summed."""
    return sum(math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
               for t, s in zip(tree.leaves(structs), tree.leaves(shardings)))


__all__ = ["NamedSharding", "batch_spec", "batch_shardings", "param_structs",
           "param_shardings", "cache_structs", "cache_shardings",
           "opt_state_structs", "opt_state_shardings", "shard_bytes",
           "MeshAxes", "axes_for_mesh", "mesh_shape_dict"]
