"""Trees placed on a mesh, the port's counterpart of ``jax.device_put(x,
NamedSharding)`` and of ``jit``'s ``in_shardings``/``out_shardings``,
and the collectives over one set of mesh axes.

A placed leaf (``Sharded``) keeps its global shape and dtype, its
``launch.specs.NamedSharding``, and the shard of every position this
process holds: every position of a single-process mesh, this rank's one
of a multi-process mesh (``launch.mesh.make_mesh`` under a process
group). Each position holds exactly ``NamedSharding.shard_shape`` of
the leaf, in a tensor of its own on the position's device (replicated
positions hold copies), so an in-place update of one never reaches
another.

``place_tree`` takes whole tensors present in this process and keeps
this process's shards; ``gather_tree`` gives the whole tensors back
(on the first local position's device). The collectives take a dict
{flat position: tensor} of this process's positions and run over the
positions that differ only along ``axes`` (``DeviceMesh.members``), in
position order. In one process they are copies between the positions'
tensors; across processes they run over the mesh's process group of
those axes. Every float sum is an all-gather followed by a local sum in
position order (``axis_sum``), so a one-process and a multi-process run
give the same bits; a native reduce-scatter would move fewer bytes.

``ModelShards`` is one data row's view of a model-sharded leaf: the
shards of the row's positions this process holds, each on its
position's device, and the row (``ModelRow``: the mesh, a position of
the row, the device its replicated activations live on). A layer that
splits over ``model`` computes each local shard's part from that shard
alone, Megatron's layout: ``to_model`` hands a replicated activation to
every local shard (the identity across processes; its backward sums the
shards' gradients over ``model``), ``sum_model`` adds the shards'
partial outputs (its backward hands each shard the gradient), and
``split_model``/``cat_model`` are the pair that slices a replicated
tensor over the shards and concatenates their outputs (no sum). Both
sums follow ``axis_sum``'s rule, an all-gather and an f32 sum in model
order (f64 for f64) cast back to the activation's dtype, so a multi-process run gives
the one-process run's bits. ``full()`` gathers a layer that runs whole
(``cat_model`` over the shards, whose backward hands each shard its
slice of the gradient); ``unbind(0)`` splits a stacked leaf a layer at
a time, so ``models.model`` takes layer i's shards inside the layer's
own (checkpointed) call.
"""
from __future__ import annotations

from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from .. import tree

__all__ = ["Sharded", "ModelShards", "place", "place_tree", "gather",
           "gather_tree", "is_placed", "resident_bytes", "shard_slices",
           "spec_axes", "model_dim", "mixed_radix", "all_gather",
           "axis_sum", "barrier", "ModelRow", "to_model", "sum_model",
           "split_model", "cat_model", "max_model"]


class Sharded:
    """One leaf placed on a mesh (see the module's docstring)."""

    __slots__ = ("sharding", "shape", "dtype", "local")

    def __init__(self, sharding, shape, dtype, local: Dict[int, Any]):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.local = local

    @property
    def mesh(self):
        return self.sharding.mesh

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, "
                f"{self.sharding.spec!r}, positions={sorted(self.local)})")


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` names, in its order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def shard_slices(sharding, shape: Sequence[int], pos: int
                 ) -> Tuple[slice, ...]:
    """The slices of the global ``shape`` that flat position ``pos``
    holds under ``sharding``: along each dimension, the block of the
    mesh coordinates its entry names (the first axis outermost)."""
    mesh = sharding.mesh
    coords = mesh.coords(pos)
    sizes = mesh.shape
    block = sharding.shard_shape(tuple(shape))
    out = []
    for i, n in enumerate(block):
        entry = sharding.spec[i] if i < len(sharding.spec) else None
        idx = mixed_radix(coords, _entry_axes(entry), sizes)
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def place(x: torch.Tensor, sharding) -> Sharded:
    """This process's shards of the whole tensor ``x`` under
    ``sharding``, each a new tensor on its position's device."""
    mesh = sharding.mesh
    local = {}
    for q in mesh.local_positions():
        src = x[shard_slices(sharding, x.shape, q)]
        local[q] = torch.empty(src.shape, dtype=x.dtype,
                               device=mesh.device_at(q)).copy_(src)
    return Sharded(sharding, x.shape, x.dtype, local)


def place_tree(tree_: Any, shardings: Any) -> Any:
    """``place`` over a tree and a tree of shardings of its structure."""
    return tree.tree_map(place, tree_, shardings)


def is_placed(tree_: Any) -> bool:
    leaves = tree.leaves(tree_)
    return isinstance(leaves[0], Sharded) if leaves else False


def _first(mesh) -> int:
    return mesh.local_positions()[0]


def gather(s: Sharded) -> torch.Tensor:
    """The whole tensor of a placed leaf, on the first local position's
    device (the shard itself where no axis splits it)."""
    mesh = s.mesh
    axes = spec_axes(s.sharding.spec)
    at = _first(mesh)
    if not axes:
        return s.local[at]
    parts = all_gather(mesh, s.local, axes, at=[at])[at]
    full = torch.empty(s.shape, dtype=s.dtype, device=mesh.device_at(at))
    for q, part in zip(mesh.members(at, axes), parts):
        full[shard_slices(s.sharding, s.shape, q)] = part
    return full


def gather_tree(placed: Any) -> Any:
    """``gather`` over a tree; plain leaves pass through."""
    return tree.tree_map(
        lambda s: gather(s) if isinstance(s, Sharded) else s, placed)


def resident_bytes(placed: Any) -> Dict[int, int]:
    """{flat position: bytes its shards of ``placed`` hold} for this
    process's positions."""
    out: Dict[int, int] = {}
    for s in tree.leaves(placed):
        for q, t in s.local.items():
            out[q] = out.get(q, 0) + t.numel() * t.element_size()
    return out


# ---------------------------------------------------------------------------
# collectives over mesh axes
# ---------------------------------------------------------------------------

def _wire(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def all_gather(mesh, vals: Dict[int, torch.Tensor], axes: Sequence[str],
               at: Optional[Sequence[int]] = None
               ) -> Dict[int, List[torch.Tensor]]:
    """For each position of ``at`` (default: every key of ``vals``), the
    tensors of ``vals`` at its members over ``axes``, in position order,
    on its device. Across processes ``vals`` holds this rank's position
    and the tensors (of one shape a collective) cross as their bytes."""
    at = list(vals) if at is None else list(at)
    if not mesh.multi_process:
        return {p: [vals[q].to(mesh.device_at(p))
                    for q in mesh.members(p, axes)] for p in at}
    import torch.distributed as dist
    (p,) = at
    x = vals[p]
    n = len(mesh.members(p, axes))
    if n == 1:
        return {p: [x]}
    raw = _wire(x)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=mesh.group(axes))
    return {p: [t.view(x.dtype).reshape(x.shape) for t in parts]}


def axis_sum(mesh, vals: Dict[int, torch.Tensor], axes: Sequence[str],
             dtype: Optional[torch.dtype] = None) -> Dict[int, torch.Tensor]:
    """The sum over ``axes`` at each position of ``vals``: an all-gather
    and a local sum in position order (in ``dtype``, default the
    tensors' own)."""
    out = {}
    for p, parts in all_gather(mesh, vals, axes).items():
        acc = parts[0].to(dtype) if dtype is not None else parts[0]
        for t in parts[1:]:
            acc = acc + (t.to(dtype) if dtype is not None else t)
        out[p] = acc
    return out


def barrier(mesh) -> None:
    """Wait for every rank of a multi-process mesh; nothing in one
    process."""
    if mesh.multi_process:
        import torch.distributed as dist
        dist.barrier()


class ModelRow(NamedTuple):
    """One data row's model positions held by this process: every
    position of the row in one process (in model order), ``pos`` alone
    across processes. ``home`` is the device of the row's replicated
    activations (the first position's)."""
    mesh: Any
    pos: int
    home: torch.device

    @property
    def tp(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def positions(self) -> List[int]:
        if self.mesh.multi_process:
            return [self.pos]
        return self.mesh.members(self.pos, ("model",))

    @property
    def devices(self) -> List[torch.device]:
        return [self.mesh.device_at(q) for q in self.positions]

    @property
    def indices(self) -> List[int]:
        """The model coordinate of each local shard."""
        return [self.mesh.coords(q)["model"] for q in self.positions]


def _model_sum(parts: List[torch.Tensor], dtype: torch.dtype
               ) -> torch.Tensor:
    """``axis_sum``'s arithmetic: a sum in model order in f32 (in f64 for
    f64 parts), cast to ``dtype``."""
    wide = torch.promote_types(dtype, torch.float32)
    acc = parts[0].to(wide)
    for t in parts[1:]:
        acc = acc + t.to(wide)
    return acc.to(dtype)


def _gather_model(row: ModelRow, parts: List[torch.Tensor],
                  at: torch.device) -> List[torch.Tensor]:
    """Every shard's tensor of the row, in model order, on ``at``: the
    local ones moved there in one process, an all-gather over ``model``
    across processes (one local part)."""
    if not row.mesh.multi_process:
        return [p.to(at) for p in parts]
    (p,) = parts
    return all_gather(row.mesh, {row.pos: p}, ("model",))[row.pos]


class _ToModel(torch.autograd.Function):
    """A replicated activation handed to each local shard; the backward
    sums the shards' gradients over ``model`` (f32, model order)."""

    @staticmethod
    def forward(ctx, x, row: ModelRow):
        ctx.row, ctx.like = row, (x.shape, x.dtype, x.device)
        return tuple(x.to(d) for d in row.devices)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        shape, dtype, device = ctx.like
        gs = [torch.zeros(shape, dtype=dtype, device=d) if g is None
              else g for g, d in zip(gs, ctx.row.devices)]
        return _model_sum(_gather_model(ctx.row, gs, device), dtype), None


class _SumModel(torch.autograd.Function):
    """The local shards' partial outputs summed over ``model`` (f32,
    model order) on the row's home device; the backward hands each
    shard the gradient."""

    @staticmethod
    def forward(ctx, row: ModelRow, *parts):
        ctx.row = row
        return _model_sum(_gather_model(row, list(parts), row.home),
                          parts[0].dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (None,) + tuple(g.to(d) for d in ctx.row.devices)


class _SplitModel(torch.autograd.Function):
    """Each local shard's block of a replicated tensor along ``dim``;
    the backward concatenates the shards' gradients over ``model``."""

    @staticmethod
    def forward(ctx, x, row: ModelRow, dim: int):
        n = x.shape[dim] // row.tp
        ctx.row, ctx.dim, ctx.device = row, dim, x.device
        return tuple(x.narrow(dim, i * n, n).to(d).contiguous()
                     for i, d in zip(row.indices, row.devices))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        return (torch.cat(_gather_model(ctx.row, [g.contiguous() for g in gs],
                                        ctx.device), ctx.dim), None, None)


class _CatModel(torch.autograd.Function):
    """The local shards' blocks concatenated along ``dim`` over
    ``model`` on the row's home device (no sum); the backward hands
    each shard its block of the gradient."""

    @staticmethod
    def forward(ctx, row: ModelRow, dim: int, *parts):
        ctx.row, ctx.dim, ctx.size = row, dim, parts[0].shape[dim]
        return torch.cat(_gather_model(row, [p.contiguous() for p in parts],
                                       row.home), dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        n = ctx.size
        return (None, None) + tuple(
            g.narrow(ctx.dim, i * n, n).to(d)
            for i, d in zip(ctx.row.indices, ctx.row.devices))


def to_model(x: torch.Tensor, row: ModelRow) -> List[torch.Tensor]:
    """``x`` (replicated over the row) for each local shard, on its
    device; the gradients sum over ``model``."""
    return list(_ToModel.apply(x, row))


def sum_model(parts: Sequence[torch.Tensor], row: ModelRow
              ) -> torch.Tensor:
    """The sum over ``model`` of the local shards' ``parts`` (one a
    local shard, in ``row.positions`` order) on ``row.home``."""
    return _SumModel.apply(row, *parts)


def split_model(x: torch.Tensor, row: ModelRow, dim: int
                ) -> List[torch.Tensor]:
    """Each local shard's block of ``x`` along ``dim`` (the model
    coordinate's), on its device."""
    return list(_SplitModel.apply(x, row, dim))


def cat_model(parts: Sequence[torch.Tensor], row: ModelRow, dim: int
              ) -> torch.Tensor:
    """The local shards' ``parts`` and every other shard's concatenated
    along ``dim`` in model order, on ``row.home``."""
    return _CatModel.apply(row, dim, *parts)


def max_model(parts: Sequence[torch.Tensor], row: ModelRow
              ) -> torch.Tensor:
    """The elementwise max over ``model`` of the local shards' ``parts``
    on ``row.home``, without a gradient."""
    got = _gather_model(row, [p.detach() for p in parts], row.home)
    out = got[0]
    for t in got[1:]:
        out = torch.maximum(out, t)
    return out


class ModelShards:
    """One data row's model shards of a leaf split along ``dim`` (see
    the module's docstring): ``parts`` every shard of the row in one
    process, in model order, each on its position's device; this rank's
    one across processes. ``row`` is the ``ModelRow`` of ``pos`` with
    its replicated activations on ``home``."""

    __slots__ = ("parts", "dim", "row")

    def __init__(self, parts: List[torch.Tensor], dim: int, mesh, pos: int,
                 home: torch.device):
        self.parts = parts
        self.dim = dim
        self.row = ModelRow(mesh, pos, home)

    def unbind(self, dim: int = 0) -> List["ModelShards"]:
        if dim != 0 or self.dim == 0:
            raise ValueError("ModelShards unbinds a leading stack axis")
        cols = [p.unbind(0) for p in self.parts]
        row = self.row
        return [ModelShards([c[i] for c in cols], self.dim - 1, row.mesh,
                            row.pos, row.home)
                for i in range(len(cols[0]))]

    def full(self) -> torch.Tensor:
        """The whole leaf on ``home``, gathered over ``model``."""
        if self.row.tp == 1:
            return self.parts[0].to(self.row.home)
        return cat_model(self.parts, self.row, self.dim)


def model_dim(spec) -> Optional[int]:
    """The dimension ``spec`` splits over ``model`` (None if none)."""
    for i, e in enumerate(spec):
        if "model" in _entry_axes(e):
            return i
    return None


def mixed_radix(coords: Dict[str, int], axes: Sequence[str],
                sizes: Dict[str, int]) -> int:
    """The index of ``coords`` over ``axes`` (the first outermost)."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx
