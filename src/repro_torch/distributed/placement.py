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
shards of the row's positions this process holds. ``full()`` gathers
the whole leaf over ``model`` through an autograd Function whose
backward hands each shard its slice of the gradient. Every model shard
of a row computes the same forward on the same rows (in one process the
row runs once for all of them), so the reduce-scatter of their equal
gradients over ``model``, divided by their number, is that slice.
``unbind(0)`` splits a stacked leaf a layer at a time, so
``models.model`` gathers layer i inside the layer's own (checkpointed)
call: a layer's whole weights live only while it runs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import tree

__all__ = ["Sharded", "ModelShards", "place", "place_tree", "gather",
           "gather_tree", "is_placed", "resident_bytes", "shard_slices",
           "spec_axes", "model_dim", "mixed_radix", "all_gather",
           "axis_sum", "barrier"]


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


class _GatherModel(torch.autograd.Function):
    """Across processes: this rank's shard gathered over ``model``; the
    backward hands back this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, pos: int, dim: int):
        parts = all_gather(mesh, {pos: x}, ("model",))[pos]
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = mesh.coords(pos)["model"]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None)


class ModelShards:
    """One data row's model shards of a leaf split along ``dim`` (see
    the module's docstring): ``parts`` every shard of the row in one
    process (gathered by a ``torch.cat`` on ``home``, whose backward is
    the slice), or this rank's one across processes."""

    __slots__ = ("parts", "dim", "mesh", "pos", "home")

    def __init__(self, parts: List[torch.Tensor], dim: int, mesh, pos: int,
                 home: torch.device):
        self.parts = parts
        self.dim = dim
        self.mesh = mesh
        self.pos = pos
        self.home = home

    def unbind(self, dim: int = 0) -> List["ModelShards"]:
        if dim != 0 or self.dim == 0:
            raise ValueError("ModelShards unbinds a leading stack axis")
        cols = [p.unbind(0) for p in self.parts]
        return [ModelShards([c[i] for c in cols], self.dim - 1, self.mesh,
                            self.pos, self.home)
                for i in range(len(cols[0]))]

    def full(self) -> torch.Tensor:
        if self.mesh.multi_process and self.mesh.shape.get("model", 1) > 1:
            return _GatherModel.apply(self.parts[0], self.mesh, self.pos,
                                      self.dim)
        if len(self.parts) == 1:
            return self.parts[0].to(self.home)
        return torch.cat([p.to(self.home) for p in self.parts], self.dim)


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
