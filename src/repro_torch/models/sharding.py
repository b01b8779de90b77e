"""Mesh-axis conventions and parameter sharding rules, the port of
``repro.models.sharding``.

Mesh axes: single-pod (data, model); multi-pod (pod, data, model). `pod`
joins `data` as a pure data-parallel axis (with the compressed gradient
all-reduce across pods, ``repro_torch.distributed.compression``). TP
shards attention heads, FFN hidden, MoE experts and vocab over `model`.

A mesh is the port's ``launch.mesh.DeviceMesh``; ``with mesh:`` (or
``use_mesh(mesh)``) makes it the ambient mesh that ``ambient_axes`` and
``layers.moe_ffn_ep`` read. ``P`` is the reference's ``PartitionSpec``:
a tuple of per-dimension entries (``None``, an axis name, or a tuple of
names) with the same ``repr``, so specs compare entry by entry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .. import tree
from ..launch import mesh as _mesh


class P:
    """``PartitionSpec(*entries)``: entry i names the mesh axis (or the
    tuple of axes) that dimension i is split over, ``None`` for a
    replicated dimension. Iterates, indexes and compares as the tuple of
    its entries; a tree leaf (not a sequence ``tree`` walks into), as
    the reference's is."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self._entries == other._entries
        return isinstance(other, tuple) and self._entries == other

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    batch: Tuple[str, ...] = ("data",)    # ("pod","data") on multi-pod
    model: str = "model"

    @property
    def dp(self):
        return self.batch if len(self.batch) > 1 else self.batch[0]


def use_mesh(mesh: _mesh.DeviceMesh) -> _mesh.DeviceMesh:
    """Context manager installing ``mesh`` as the ambient mesh: the mesh
    itself (``with use_mesh(mesh):`` is ``with mesh:``)."""
    return mesh


def axes_for_mesh(mesh: _mesh.DeviceMesh) -> MeshAxes:
    """The batch/model logical-axis assignment for ``mesh`` (pods fold
    into the batch axes when present)."""
    if "pod" in mesh.axis_names:
        return MeshAxes(batch=("pod", "data"), model="model")
    return MeshAxes(batch=("data",), model="model")


def constrain(x, spec: P):
    """The reference's ``with_sharding_constraint``: ``x`` unchanged. The
    port has no SPMD partitioner for a hint to steer; a mesh's shards
    are placed by the code that runs them (``layers.moe_ffn_ep``)."""
    return x


def ambient_axes() -> Optional[MeshAxes]:
    """MeshAxes of the ambient mesh (``launch.mesh.active_mesh()``), or
    None without one, or when it lacks a ``model`` axis or a batch axis
    (``pod``/``data``)."""
    am = _mesh.active_mesh()
    if am is None:
        return None
    names = am.axis_names
    batch = tuple(n for n in ("pod", "data") if n in names)
    if not batch or "model" not in names:
        return None
    return MeshAxes(batch=batch, model="model")


def constrain_model_dim(x, dim: int):
    """The reference pins one dim of an activation to the model axis;
    here ``x`` unchanged (see ``constrain``)."""
    return x


def constrain_batch(x, extra_model_dim: Optional[int] = None):
    """The reference pins dim 0 of an activation to the data axes; here
    ``x`` unchanged (see ``constrain``)."""
    return x


def _div(n: int, parts: int) -> bool:
    return parts > 0 and n % parts == 0


def param_spec(path: str, shape: Tuple[int, ...], ax: MeshAxes,
               mesh_shape: dict, zero1: bool = False) -> P:
    """Sharding rule for one parameter, by name suffix.

    Conventions (leading stack dims of the layer stacks get None):
      embed (V, d)            -> (model, None)
      unembed (d, V)          -> (None, model)
      attn wq/wk/wv (d, H*Dh) -> (None, model)   heads sharded
      attn wo (H*Dh, d)       -> (model, None)
      ffn w_gate/w_up (d, ff) -> (None, model)
      ffn w_down (ff, d)      -> (model, None)
      moe (E, d, ff)          -> (model, None, None) if E%tp==0 (EP)
                                 else (None, None, model) (TP inside expert)
      norms / small vectors   -> replicated
    `zero1` additionally shards the first remaining None dim over the data
    axes for optimizer-state pytrees (ZeRO-1).
    """
    tp = mesh_shape.get("model", 1)
    dp = math.prod(mesh_shape.get(a, 1) for a in ax.batch)
    nd = len(shape)
    lead = 0
    base: list = [None] * nd
    name = path.split("/")[-1]

    if name in ("embed",):
        if _div(shape[lead], tp):
            base[lead] = ax.model
    elif name in ("unembed",):
        if _div(shape[-1], tp):
            base[-1] = ax.model
    elif name == "w_down3":              # mLSTM (Dh, H, d): shard Dh
        if _div(shape[-3], tp):
            base[-3] = ax.model
    elif name in ("wv3", "w_z3"):        # mLSTM (d, Dh, H): shard Dh
        if _div(shape[-2], tp):
            base[-2] = ax.model
    elif name in ("wq3", "wk3"):         # mLSTM q/k replicated (small) so
        pass                             # the C.q readout is local
    elif name in ("wq", "wk", "wv", "w_gate", "w_up", "ssm_in", "w_z",
                  "w_zi", "w_zf", "w_zz", "w_zo", "wq_x", "wk_x", "wv_x",
                  "w1"):
        if _div(shape[-1], tp):
            base[-1] = ax.model
    elif name in ("wo", "w_down", "ssm_out", "w_downproj", "wo_x", "w2"):
        if _div(shape[-2], tp):
            base[-2] = ax.model
    elif name == "router":
        pass  # small, replicated
    elif name in ("moe_w_gate", "moe_w_up"):          # (.., E, d, ff)
        if _div(shape[-3], tp):
            base[-3] = ax.model                        # expert parallel
        elif _div(shape[-1], tp):
            base[-1] = ax.model
    elif name == "moe_w_down":                         # (.., E, ff, d)
        if _div(shape[-3], tp):
            base[-3] = ax.model
        elif _div(shape[-2], tp):
            base[-2] = ax.model

    if zero1:
        # shard one remaining large dim over the data axes (ZeRO-1)
        for i, s in enumerate(base):
            if s is None and i < nd and shape[i] >= dp and _div(shape[i], dp):
                base[i] = ax.batch if len(ax.batch) > 1 else ax.batch[0]
                break
    return P(*base)


#: the layer kinds of ``tp_layout``, by parameter name
_KIND = {"embed": "embed", "unembed": "unembed",
         "wq": "attention", "wk": "attention", "wv": "attention",
         "wo": "attention", "wq_x": "cross_attention",
         "wk_x": "cross_attention", "wv_x": "cross_attention",
         "wo_x": "cross_attention", "w_gate": "mlp", "w_up": "mlp",
         "w_down": "mlp", "w1": "mlp", "w2": "mlp",
         "moe_w_gate": "experts", "moe_w_up": "experts",
         "moe_w_down": "experts"}

#: the families whose layers run whole on a model-sharded mesh: their
#: model-sharded weights are gathered a layer at a time
RECURRENT = ("ssm", "hybrid")


def heads_split(cfg, tp: int) -> bool:
    """Whether attention splits over a model axis of ``tp``: whole
    query and KV heads a shard (``param_spec``'s contiguous column split
    of wq/wk/wv then gives shard j the q heads [j H/tp, (j+1) H/tp) and
    the KV heads [j Hk/tp, (j+1) Hk/tp), and the GQA map h -> h // G
    stays inside the shard)."""
    return (tp > 1 and cfg.family not in RECURRENT
            and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0)


def tp_layout(cfg, tp: int) -> dict:
    """How the sharded train step runs each kind of layer of ``cfg`` on
    a model axis of ``tp`` positions: "split" (each shard computes its
    part from its own weights), "expert" (the MoE's experts split over
    the shards), "gather" (its model-sharded weights gathered whole, the
    layer run whole) or "whole" (no weight of it model-sharded). The
    recurrent families' layers gather (``RECURRENT``); attention splits
    where ``heads_split``; the MLPs, the experts and the vocabulary
    split wherever ``param_spec`` split their weights."""
    ax = MeshAxes()
    ms = {"data": 1, "model": tp}
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def sharded(name, shape):
        return tp > 1 and "model" in param_spec(name, shape, ax, ms)

    out = {"embed": "split" if sharded("embed", (V, d)) else "whole",
           "unembed": "split" if sharded("embed", (V, d)) else "whole"}
    if cfg.family == "ssm":
        return {**out, "recurrent": "gather" if tp > 1 else "whole"}
    attn = any(sharded(n, s) for n, s in (("wq", (d, H * Dh)),
                                           ("wk", (d, Hk * Dh))))
    out["attention"] = ("split" if heads_split(cfg, tp) else
                        "gather" if attn else "whole")
    if cfg.enc_dec:
        out["cross_attention"] = out["attention"]
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        spec = param_spec("moe_w_gate", (E, d, ff), ax, ms)
        out["experts"] = ("whole" if tp == 1 or "model" not in spec else
                          "expert" if spec[0] == "model" else "split")
    else:
        out["mlp"] = "split" if sharded("w_up", (d, ff)) else "whole"
    if cfg.family in RECURRENT:
        out = {k: ("gather" if v != "whole" and k not in
                   ("embed", "unembed") else v) for k, v in out.items()}
        out["recurrent"] = "gather" if tp > 1 else "whole"
    return out


def tp_split(cfg, mesh_shape: dict) -> dict:
    """The model-sharded leaves of ``cfg``'s params on a mesh of
    ``mesh_shape``, by how the sharded train step uses them:
    ``{"split": [...], "gathered": [...]}`` (``/``-joined paths, in the
    params' order); ``tp_layout``'s rule."""
    from ..launch.specs import param_structs
    tp = mesh_shape.get("model", 1)
    layout = tp_layout(cfg, tp)
    out = {"split": [], "gathered": []}
    for name, leaf in tree.flatten_with_path(param_structs(cfg)):
        if "model" not in param_spec(name, tuple(leaf.shape), MeshAxes(),
                                     {"data": 1, "model": tp}) or tp == 1:
            continue
        kind = _KIND.get(name.split("/")[-1], "recurrent")
        if cfg.family in RECURRENT and kind not in ("embed", "unembed"):
            kind = "recurrent"
        how = layout.get(kind, "gather")
        out["gathered" if how == "gather" else "split"].append(name)
    return out


def tree_param_specs(params_shape, ax: MeshAxes, mesh_shape: dict,
                     zero1: bool = False):
    """A ``P`` tree matching a params (shape) tree: each leaf's spec from
    its ``/``-joined path (``tree.flatten_with_path``, the reference's
    names and order)."""
    specs = [param_spec(name, tuple(leaf.shape), ax, mesh_shape, zero1)
             for name, leaf in tree.flatten_with_path(params_shape)]
    return tree.unflatten(params_shape, specs)


def mesh_shape_dict(mesh: _mesh.DeviceMesh) -> dict:
    """{axis name: device count} of ``mesh``."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


__all__ = ["P", "MeshAxes", "use_mesh", "axes_for_mesh", "constrain",
           "ambient_axes", "constrain_model_dim", "constrain_batch",
           "param_spec", "tree_param_specs", "mesh_shape_dict",
           "heads_split", "tp_layout", "tp_split", "RECURRENT"]
