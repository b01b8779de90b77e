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
own (checkpointed) call. ``take_model`` hands each local shard ranges
of several leaves that may straddle the shards' blocks (attention's
head columns): in one process copies of the pieces, across processes
an all-gather of the leaf narrowed; its backward adds the takers'
gradients into the owners' in f32, in model order.

``BatchRows`` describes the data rows that meet at a MoE layer, and
``gather_rows`` hands each of them every row's activation concatenated
in row order (copies in one process, an all-gather over the batch axes
across processes); its backward sums each row's slice of the copies'
gradients in f32, in row order: a reduce-scatter with ``axis_sum``'s
arithmetic.

For serving at the dry-run partition (``serve.sharded``): ``row_params``
is a data row's view of placed params (``regather`` first rebuilds a
ZeRO-1 leaf at its model split), ``CacheShards`` one layer of a KV cache
as a row's model shards keep it, ``put_model`` writes a tensor held in
pieces over the shards (each shard's KV heads) into the shards that keep
each piece (the cache's positions) by one all-to-all over ``model``, and
``argmax_model`` is the greedy argmax over vocabulary shards.
``StateShards`` is one leaf of the rest of a serving state (whisper's
encoder memory, the recurrent states) as a row's shards keep it;
``regroup_model`` deals a vector's last-dim indices out anew over the
shards (hymba's SSM input and output between its weights' flattened
columns and its state's Dh split) and ``sum_scatter_model`` is a
reduce-scatter in model order (whisper's memory k and v at a d split).
"""
from __future__ import annotations

import math
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from .. import tree

__all__ = ["Sharded", "ModelShards", "place", "place_tree", "gather",
           "gather_tree", "is_placed", "resident_bytes", "shard_slices",
           "spec_axes", "model_dim", "mixed_radix", "all_gather",
           "axis_sum", "barrier", "ModelRow", "to_model", "sum_model",
           "split_model", "cat_model", "max_model", "take_model",
           "take_plan", "BatchRows", "gather_rows", "EXCHANGED",
           "exchange_model", "permute_model", "to_first", "scatter_first",
           "from_first", "mean_rows_model", "argmax_model", "put_model",
           "slice_box", "regather", "row_params", "put_local",
           "CacheShards", "StateShards", "regroup_model",
           "sum_scatter_model"]


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
    """Whether ``tree_``'s leaves are ``Sharded`` (placed by
    ``place_tree``) rather than plain tensors; an empty tree is not."""
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


def regather(s: Sharded, sharding) -> Sharded:
    """``s`` under ``sharding``, which splits over a subset of the axes
    ``s`` splits over (a ZeRO-1 / FSDP leaf, split over the batch axes
    too, back at its model split): each position's shard assembled from
    its members' shards over the axes that drop out (an all-gather over
    them); the whole leaf is never formed."""
    extra = tuple(a for a in spec_axes(s.sharding.spec)
                  if a not in spec_axes(sharding.spec))
    mesh = s.mesh
    if not extra:
        return Sharded(sharding, s.shape, s.dtype, s.local)
    local = {}
    for q, parts in all_gather(mesh, s.local, extra).items():
        outer = slice_box(shard_slices(sharding, s.shape, q))
        out = torch.empty(sharding.shard_shape(s.shape), dtype=s.dtype,
                          device=mesh.device_at(q))
        for q2, part in zip(mesh.members(q, extra), parts):
            out[_within(slice_box(shard_slices(s.sharding, s.shape, q2)),
                        outer)] = part
        local[q] = out
    return Sharded(sharding, s.shape, s.dtype, local)


def row_params(placed: Any, qs: Sequence[int]) -> Any:
    """One data row's view of a placed tree: ``qs`` the row's local
    positions in model order (every position of the row in one process,
    the rank's one across processes). A leaf split over ``model``
    becomes ``ModelShards`` of those positions' shards (the layers then
    split, ``models.blocks``), any other leaf the tensor of ``qs[0]``;
    the row's activations live on ``qs[0]``'s device. A leaf split over
    the batch axes too raises (``regather`` it first)."""
    def view(s: Sharded):
        if s.sharding.spec and any(
                a != "model" for a in spec_axes(s.sharding.spec)):
            raise ValueError(f"row_params: a leaf split over "
                             f"{s.sharding.spec!r}: regather it first")
        k = model_dim(s.sharding.spec)
        if k is None:
            return s.local[qs[0]]
        mesh = s.mesh
        return ModelShards([s.local[q] for q in qs], k, mesh, qs[0],
                           mesh.device_at(qs[0]))
    return tree.tree_map(view, placed)


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


def argmax_model(parts: Sequence[torch.Tensor], row: ModelRow
                 ) -> torch.Tensor:
    """The argmax along the last dim of a tensor split over ``model`` in
    equal blocks along it (``parts`` the local shards', in
    ``row.positions`` order), as global indices (int64) on
    ``row.home``, without a gradient: each shard's max and its first
    index, then the shards in model order, a later one taken only where
    its max is strictly greater, so a tie takes the lowest index, as
    ``torch.argmax`` and ``jnp.argmax`` do. The pairs cross as f64
    (exact for f32 values and for indices below 2^53)."""
    n = parts[0].shape[-1]
    pairs = [torch.stack([p.detach().amax(-1).double(),
                          (p.detach().argmax(-1) + j * n).double()])
             for p, j in zip(parts, row.indices)]
    got = _gather_model(row, pairs, row.home)
    best, idx = got[0][0], got[0][1]
    for t in got[1:]:
        take = t[0] > best
        best = torch.where(take, t[0], best)
        idx = torch.where(take, t[1], idx)
    return idx.long()


def _pieces(lo: int, hi: int, n: int) -> List[Tuple[int, int, int]]:
    """The pieces of the range [lo, hi) held by blocks of ``n``: (block,
    first, last), global indices, in order."""
    if hi <= lo:
        return []
    return [(i, max(lo, i * n), min(hi, (i + 1) * n))
            for i in range(lo // n, -(-hi // n))]


def take_plan(size: int, tp: int, ranges: Sequence[Tuple[int, int]]
              ) -> List[List[Tuple[int, int, int]]]:
    """For each model coordinate j, the pieces (owner, first, last) of
    ``ranges[j]`` along a dimension of ``size`` split in ``tp`` blocks:
    what ``take_model`` hands shard j (its own piece included)."""
    return [_pieces(lo, hi, size // tp) for lo, hi in ranges]


def _take(row: ModelRow, sharded: bool, dim: int, ranges, xs
          ) -> List[torch.Tensor]:
    """``_TakeModel``'s forward for one leaf: each local shard's range,
    from the local parts (one process), the all-gathered parts (across
    processes) or the replicated tensor."""
    n = xs[0].shape[dim]
    srcs = (_gather_model(row, [xs[0].contiguous()], xs[0].device)
            if sharded and row.mesh.multi_process else xs)
    outs = []
    for j, dev in zip(row.indices, row.devices):
        lo, hi = ranges[j]
        pieces = [srcs[i].narrow(dim, a - i * n, b - a).to(dev)
                  for i, a, b in _pieces(lo, hi, n)]
        outs.append(torch.cat(pieces or [srcs[0].narrow(dim, 0, 0).to(dev)],
                              dim))
    return outs


def _take_grads(row: ModelRow, sharded: bool, dim: int, ranges, like,
                gs) -> List[torch.Tensor]:
    """``_TakeModel``'s backward for one leaf: the gradient of each local
    input, every shard's gradient of the range it took added in, in
    model order, in f32 (f64 for f64) from zero."""
    if row.mesh.multi_process:     # every taker's, padded to the widest
        (g,) = gs
        widths = [hi - lo for lo, hi in ranges]
        pad = [0, 0] * (g.dim() - 1 - dim) + [0, max(widths) - g.shape[dim]]
        got = _gather_model(row, [torch.nn.functional.pad(g, pad)
                                  .contiguous()], g.device)
        gs = [t.narrow(dim, 0, w) for t, w in zip(got, widths)]
    starts = ([0] if not sharded else
              [i * like[0][0][dim] for i in row.indices])
    out = []
    for (shape, dtype, device), start in zip(like, starts):
        wide = torch.promote_types(dtype, torch.float32)
        acc = torch.zeros(shape, dtype=wide, device=device)
        for (lo, hi), g in zip(ranges, gs):
            a, b = max(lo, start), min(hi, start + shape[dim])
            if b > a:
                acc.narrow(dim, a - start, b - a).add_(
                    g.narrow(dim, a - lo, b - a).to(device, wide))
        out.append(acc.to(dtype))
    return out


class _TakeModel(torch.autograd.Function):
    """Each local shard's ranges of several leaves (``take_model``): one
    Function for them all, so that its backward (and across processes
    its collectives) runs on every rank once any of its outputs is used
    (a shard with no query head uses only some)."""

    @staticmethod
    def forward(ctx, row: ModelRow, specs, *xs):
        ctx.row, ctx.specs = row, specs
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        outs, i = [], 0
        for sharded, dim, ranges, k in specs:
            outs.extend(_take(row, sharded, dim, ranges, xs[i:i + k]))
            i += k
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        row, out = ctx.row, []
        i = o = 0
        m = len(row.indices)
        for sharded, dim, ranges, k in ctx.specs:
            out.extend(_take_grads(row, sharded, dim, ranges,
                                   ctx.like[i:i + k], gs[o:o + m]))
            i += k
            o += m
        return (None, None) + tuple(out)


def take_model(ws: Sequence[Any], ranges: Sequence[Sequence[Tuple[int,
                                                                  int]]],
               dims: Sequence[int], row: Optional[ModelRow] = None
               ) -> List[List[torch.Tensor]]:
    """For each leaf ``ws[i]`` (a ``ModelShards`` split along
    ``dims[i]``, or a replicated tensor), each local shard's range
    ``ranges[i][j]`` (j its model coordinate, global indices along
    ``dims[i]``), on the shard's device: ``out[i][k]`` for the k-th
    local shard (``row.positions`` order). A range may straddle the
    blocks: in one process each piece is copied from its owner (no leaf
    gathered whole), across processes the leaf is all-gathered over
    ``model`` and narrowed; a replicated tensor is narrowed. The
    backward adds each shard's gradient of its range into the owners'
    (the replicated tensor's whole) gradient, in model order in f32
    (``_model_sum``'s arithmetic), so shards that took the same columns
    (a KV head two shards read) sum into them; across processes the
    gradients cross as one all-gather a leaf, padded to the widest
    range. A leaf whose every range is its shard's own block is its
    parts, untouched (no copy, no Function). ``row`` is that of the
    ``ModelShards`` among ``ws``, given where there is none."""
    row = row or next(w.row for w in ws if isinstance(w, ModelShards))
    tp = row.tp
    out: List[Any] = [None] * len(ws)
    specs, xs, todo = [], [], []
    for i, (w, rg, dim) in enumerate(zip(ws, ranges, dims)):
        rg = [tuple(r) for r in rg]
        if len(rg) != tp:
            raise ValueError(f"take_model: {len(rg)} ranges for {tp} shards")
        if isinstance(w, ModelShards):
            if w.dim != dim:
                raise ValueError(f"take_model: a leaf split along {w.dim} "
                                 f"taken along {dim}")
            n = w.parts[0].shape[dim]
            if rg == [(j * n, (j + 1) * n) for j in range(tp)]:
                out[i] = list(w.parts)
                continue
            specs.append((True, dim, rg, len(w.parts)))
            xs.extend(w.parts)
        else:
            specs.append((False, dim, rg, 1))
            xs.append(w)
        todo.append(i)
    if todo:
        got = _TakeModel.apply(row, tuple(specs), *xs)
        m = len(row.indices)
        for k, i in enumerate(todo):
            out[i] = list(got[k * m:(k + 1) * m])
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
        """``torch.unbind`` over a leading stack axis (a layer stack):
        one ``ModelShards`` an index, each part's slice on its own
        device and the split axis one lower. Only ``dim`` 0 of a leaf
        not split along it."""
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


class BatchRows(NamedTuple):
    """The data rows this process holds that meet at a MoE layer: every
    row of a gather group in one process (in row order), the rank's own
    row across processes. ``positions`` holds each local row's home
    position (its first local position, whose device holds the row's
    activations), ``bounds`` every row's range [lo, hi) of the domain
    batch, in row order over ``axes`` (the rows whose tokens one MoE
    layer routes together). ``shared``: every row holds the whole
    domain batch (a batch that does not divide over the rows; each
    bound is then the whole batch), so nothing is gathered, and under
    expert parallelism each row routes its share of the tokens."""
    mesh: Any
    axes: Tuple[str, ...]
    positions: List[int]
    bounds: List[Tuple[int, int]]
    shared: bool = False

    @property
    def homes(self) -> List[torch.device]:
        return [self.mesh.device_at(q) for q in self.positions]

    @property
    def ranges(self) -> List[Tuple[int, int]]:
        """Each local row's [lo, hi)."""
        return [self.bounds[mixed_radix(self.mesh.coords(q), self.axes,
                                        self.mesh.shape)]
                for q in self.positions]


class _GatherRows(torch.autograd.Function):
    """Every row's tensor concatenated along dim 0 in row order, on each
    local row's home; the backward sums each row's slice of every copy's
    gradient in f32, in row order (``axis_sum``'s arithmetic)."""

    @staticmethod
    def forward(ctx, rows: BatchRows, *xs):
        ctx.rows, ctx.like = rows, [(x.shape, x.dtype) for x in xs]
        if rows.mesh.multi_process:
            (x,) = xs
            (q,) = rows.positions
            return torch.cat(all_gather(rows.mesh, {q: x.contiguous()},
                                        rows.axes)[q], 0)
        return tuple(torch.cat([x.to(h) for x in xs], 0) for h in rows.homes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        rows = ctx.rows
        n = sum(hi - lo for lo, hi in rows.bounds)
        gs = [torch.zeros((n,) + tuple(shape[1:]), dtype=dtype, device=h)
              if g is None else g
              for g, (shape, dtype), h in zip(gs, ctx.like, rows.homes)]
        if rows.mesh.multi_process:
            (q,) = rows.positions
            gs = all_gather(rows.mesh, {q: gs[0].contiguous()},
                            rows.axes)[q]
        out = [_model_sum([g[lo:hi].to(h) for g in gs], dtype)
               for (lo, hi), h, (_, dtype) in zip(rows.ranges, rows.homes,
                                                  ctx.like)]
        return (None,) + tuple(out)


def gather_rows(xs: Sequence[torch.Tensor], rows: BatchRows
                ) -> List[torch.Tensor]:
    """For each local row of ``rows``, the rows' tensors ``xs`` (one a
    local row, each its rows of the domain batch along dim 0, the rows'
    shapes equal) concatenated in row order, on the row's home: copies
    in one process, an all-gather over ``rows.axes`` across processes.
    The backward hands each row its slice of the gradient summed over
    every row's copy in f32, in row order: a reduce-scatter built as an
    all-gather and an ordered local sum, so ranks give one process's
    bits."""
    if len(xs) != len(rows.positions):
        raise ValueError(f"gather_rows: {len(xs)} tensors for "
                         f"{len(rows.positions)} local rows")
    if rows.shared:
        raise ValueError("gather_rows: every shared row holds the batch")
    if len({hi - lo for lo, hi in rows.bounds}) != 1:
        raise ValueError(f"gather_rows: uneven rows {rows.bounds}")
    if not rows.mesh.multi_process and len(xs) != len(rows.bounds):
        raise ValueError("gather_rows: one process holds every row of its "
                         "group")
    out = _GatherRows.apply(rows, *xs)
    return [out] if isinstance(out, torch.Tensor) else list(out)


# ---------------------------------------------------------------------------
# exchanges between the model shards of a row (expert parallelism)
# ---------------------------------------------------------------------------

#: bytes the exchanges (``exchange_model``, ``permute_model``,
#: ``to_first``, ``from_first``, ``scatter_first``) moved between two
#: positions of a row, forward and backward; a counter the caller resets
EXCHANGED = {"bytes": 0}


def _exchange(row: ModelRow, sends: Sequence[Sequence[torch.Tensor]],
              shapes: Sequence[Sequence[Tuple[int, ...]]],
              dtype: torch.dtype) -> List[List[torch.Tensor]]:
    """Each local shard's tensors from every shard of ``row``:
    ``sends[k][j]`` local shard k's tensor for model coordinate j,
    ``shapes[i][j]`` the shape coordinate i sends coordinate j (all of
    ``dtype``). Returns ``out[k][i]``, what local shard k received from
    coordinate i, on its device: copies in one process, one
    ``all_to_all_single`` over ``model`` of the tensors' bytes across
    processes."""
    tp = row.tp
    size = torch.empty((), dtype=dtype).element_size()
    for i in row.indices:
        EXCHANGED["bytes"] += size * sum(
            math.prod(shapes[i][j]) for j in range(tp) if j != i)
    if not row.mesh.multi_process:
        return [[sends[i][j].to(dev) for i in range(tp)]
                for j, dev in zip(row.indices, row.devices)]
    import torch.distributed as dist
    (send,), (me,) = sends, row.indices
    raw = [_wire(t) for t in send]
    out_sizes = [math.prod(shapes[i][me]) * size for i in range(tp)]
    out = torch.empty(sum(out_sizes), dtype=torch.uint8,
                      device=row.devices[0])
    dist.all_to_all_single(out, torch.cat(raw), out_sizes,
                           [r.numel() for r in raw],
                           group=row.mesh.group(("model",)))
    return [[p.view(dtype).reshape(shapes[i][me])
             for i, p in enumerate(out.split(out_sizes))]]


Box = Tuple[Tuple[int, int], ...]


def slice_box(slices: Sequence[slice]) -> Box:
    """``shard_slices``' slices as a box: (first, last) a dimension."""
    return tuple((s.start, s.stop) for s in slices)


def _meet(a: Box, b: Box) -> Box:
    """The intersection of two boxes (empty dims as (lo, lo))."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo = max(a0, b0)
        out.append((lo, max(lo, min(a1, b1))))
    return tuple(out)


def _within(box: Box, outer: Box) -> Tuple[slice, ...]:
    """The slices of ``box`` relative to ``outer``'s first corner."""
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                 zip(box, outer))


def put_model(row: ModelRow, parts: Sequence[torch.Tensor],
              boxes: Sequence[Box], targets: Sequence[Optional[torch.Tensor]],
              dests: Sequence[Box]) -> None:
    """Write the pieces of a tensor held over a row's model shards into
    the shards that keep them: local shard k's ``parts[k]`` holds the
    global box ``boxes[i]`` (i its model coordinate; an empty box where
    it holds nothing) and ``targets[k]`` is the global box ``dests[j]``
    (None or an empty box where it keeps nothing); ``boxes`` and
    ``dests`` list every coordinate's, so each shard knows what it
    receives. Each source sends each keeper the intersection of their
    boxes, nothing else, written in place: copies in one process, one
    ``all_to_all_single`` over ``model`` across processes
    (``_exchange``). The prefill's K/V go from a shard's KV heads to the
    cache's split this way, a decode token's k and v to the shard that
    owns its position. No gradient."""
    tp = row.tp
    meet = [[_meet(boxes[i], dests[j]) for j in range(tp)]
            for i in range(tp)]
    shapes = [[tuple(hi - lo for lo, hi in m) for m in mi] for mi in meet]
    sends = [[parts[k].detach()[_within(meet[i][j], boxes[i])].contiguous()
              for j in range(tp)] for k, i in enumerate(row.indices)]
    got = _exchange(row, sends, shapes, parts[0].dtype)
    for k, j in enumerate(row.indices):
        for i in range(tp):
            if got[k][i].numel():
                targets[k][_within(meet[i][j], dests[j])] = got[k][i]


def put_local(x: torch.Tensor, box: Box,
              targets: Sequence[Optional[torch.Tensor]],
              dests: Sequence[Box], row: ModelRow) -> None:
    """``put_model`` for a tensor every local shard holds whole (``x``,
    the global ``box``, replicated over the row: each rank computed it):
    each local shard copies its own part, nothing crosses."""
    for k, j in enumerate(row.indices):
        m = _meet(box, dests[j])
        if all(hi > lo for lo, hi in m):
            targets[k][_within(m, dests[j])] = x.detach()[_within(m, box)]


class CacheShards(NamedTuple):
    """One layer of a KV cache leaf pair as one data row's model shards
    hold it: ``k[i]``/``v[i]`` local shard i's (B', T', Hk', Dh') slice of
    the layer (None where it keeps none of it: a cache split over the
    layers), ``boxes[j]`` every model coordinate's global (B, T, Hk, Dh)
    box of the layer (T empty where it keeps none), ``kind`` the dim the
    cache splits over ``model`` (``models.layers.CACHE_SPLITS``; None:
    each shard keeps it whole)."""
    row: ModelRow
    kind: Optional[str]
    k: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]
    boxes: List[Box]

    def parts(self) -> list:
        """Each local shard's (k, v, its (T, Hk, Dh) box) or None, as
        ``layers.decode_attention_model`` takes them."""
        return [None if k is None else (k, v, self.boxes[j][1:])
                for k, v, j in zip(self.k, self.v, self.row.indices)]

    def write(self, k, v, t0: int, owned=None) -> None:
        """Write the row's k and v of the positions [t0, t0 + S) into the
        shards that keep them: ``k``/``v`` the row's whole (B', S, Hk, Dh)
        tensors, held alike by each local shard (``put_local``), or with
        ``owned`` (every model coordinate's KV heads [lo, hi)) lists of
        each local shard's (B', S, hi - lo, Dh) heads, sent to their
        keepers (``put_model``: one all-to-all over ``model`` each)."""
        b0, b1 = self.boxes[0][0]
        if owned is None:
            S, Hk, Dh = k.shape[1:]
            box = ((b0, b1), (t0, t0 + S), (0, Hk), (0, Dh))
            put_local(k, box, self.k, self.boxes, self.row)
            put_local(v, box, self.v, self.boxes, self.row)
            return
        S, Dh = k[0].shape[1], k[0].shape[3]
        boxes = [((b0, b1), (t0, t0 + S), tuple(o), (0, Dh)) for o in owned]
        put_model(self.row, k, boxes, self.k, self.boxes)
        put_model(self.row, v, boxes, self.v, self.boxes)


class StateShards(NamedTuple):
    """One leaf of a serving state (whisper's encoder memory, a recurrent
    state) as one data row's model shards hold it: ``parts[k]`` local
    shard k's block (``row.positions`` order; a view into the placed
    leaf, updated in place), ``boxes[j]`` every model coordinate's global
    box, ``dim`` the dim split over ``model`` (None: every shard keeps
    a whole copy)."""
    row: ModelRow
    dim: Optional[int]
    parts: List[torch.Tensor]
    boxes: List[Box]

    def at(self, *idx: int) -> "StateShards":
        """The view at ``idx`` into the leading dims (a layer of a
        stack), which must not be the split one."""
        n = len(idx)
        if self.dim is not None and self.dim < n:
            raise ValueError(f"StateShards.at: dim {self.dim} is split")
        return StateShards(self.row, None if self.dim is None else
                           self.dim - n, [p[idx] for p in self.parts],
                           [b[n:] for b in self.boxes])

    def mine(self) -> List[Box]:
        """Each local shard's box."""
        return [self.boxes[j] for j in self.row.indices]


#: ``regroup_model``'s plans, by (have, want, the row's coordinates,
#: device): each a fixed permutation, built once
_REGROUP: Dict[Any, Any] = {}


def _regroup_plan(have, want, tp: int):
    """``regroup_model``'s plan: for each holder i and taker j, the
    positions in ``have[i]`` of what j takes from i and their positions
    in ``want[j]`` (each index from the lowest coordinate holding it)."""
    src: Dict[int, Tuple[int, int]] = {}
    for i in range(tp):
        for at, c in enumerate(have[i]):
            src.setdefault(c, (i, at))
    plan = [[([], []) for _ in range(tp)] for _ in range(tp)]
    for j in range(tp):
        for at, c in enumerate(want[j]):
            if c not in src:
                raise ValueError(f"regroup_model: no shard holds {c}")
            i, pos = src[c]
            plan[i][j][0].append(pos)
            plan[i][j][1].append(at)
    return plan


def regroup_model(row: ModelRow, parts: Sequence[torch.Tensor],
                  have: Sequence[Sequence[int]],
                  want: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """Indices of the last dim dealt out anew over a row's model shards:
    ``parts[k]`` local shard k's tensor holding the global indices
    ``have[i]`` (i its model coordinate, in that order); returns each
    local shard's indices ``want[j]``, in that order, each taken from
    the lowest coordinate that has it. In one process each taker
    gathers from the shards' tensors by one index; across processes
    one ``all_to_all_single`` over ``model`` (each holder sends each
    taker only what it takes from it). ``EXCHANGED`` counts what crosses
    between two coordinates. No gradient."""
    tp = row.tp
    # mszlint: disable=transfer-discipline -- have/want are host index lists
    have, want = (tuple(tuple(int(c) for c in h) for h in x) for x in (have,
                                                                     want))
    key = (have, want, tuple(row.indices), tuple(map(str, row.devices)))
    if key not in _REGROUP:
        plan = _regroup_plan(have, want, tp)
        offs = [sum(len(h) for h in have[:i]) for i in range(tp)]

        def idx(xs, dev):
            return torch.tensor(xs, dtype=torch.long, device=dev)
        if not row.mesh.multi_process:      # one index into every part
            cat_idx = []
            for j, dev in zip(row.indices, row.devices):
                at_of = [0] * len(want[j])
                for i in range(tp):
                    for pos, at in zip(*plan[i][j]):
                        at_of[at] = offs[i] + pos
                cat_idx.append(idx(at_of, dev))
            _REGROUP[key] = ("one", plan, cat_idx)
        else:
            (k_dev,), (me,) = row.devices, row.indices
            _REGROUP[key] = ("ranks", plan, (
                [idx(plan[me][j][0], k_dev) for j in range(tp)],
                idx([at for i in range(tp) for at in plan[i][me][1]],
                    k_dev)))
    kind, plan, idxs = _REGROUP[key]
    lead = tuple(parts[0].shape[:-1])
    size = parts[0].element_size() * math.prod(lead)
    for j in row.indices:
        EXCHANGED["bytes"] += size * sum(len(plan[i][j][0])
                                         for i in range(tp) if i != j)
    if kind == "one":
        wholes: Dict[torch.device, torch.Tensor] = {}
        out = []
        for dev, ix in zip(row.devices, idxs):
            if dev not in wholes:
                wholes[dev] = torch.cat([p.detach().to(dev) for p in parts],
                                        -1)
            out.append(wholes[dev].index_select(-1, ix))
        return out
    import torch.distributed as dist
    sends, recv = idxs
    (me,) = row.indices
    raw = [_wire(parts[0].detach().index_select(-1, ix)) for ix in sends]
    sizes = [len(plan[i][me][0]) * size for i in range(tp)]
    got = torch.empty(sum(sizes), dtype=torch.uint8, device=row.devices[0])
    dist.all_to_all_single(got, torch.cat(raw), sizes,
                           [r.numel() for r in raw],
                           group=row.mesh.group(("model",)))
    pieces = torch.cat([g.view(parts[0].dtype).reshape(
        lead + (len(plan[i][me][0]),)) for i, g in
        enumerate(got.split(sizes))], -1)
    o = torch.empty(lead + (len(want[me]),), dtype=parts[0].dtype,
                    device=row.devices[0])
    o[..., recv] = pieces
    return [o]


def sum_scatter_model(row: ModelRow, parts: Sequence[torch.Tensor],
                      ranges: Sequence[Tuple[int, int]], dim: int
                      ) -> List[torch.Tensor]:
    """The sum over ``model`` of the local shards' partial tensors
    ``parts`` (equal shapes), each local shard keeping only its range
    ``ranges[j]`` of ``dim`` (j its model coordinate; ranges may overlap
    or be empty): a reduce-scatter, each shard's received pieces summed
    in model order in f32 (``axis_sum``'s arithmetic, so ranks give one
    process's bits) and cast to the parts' dtype. One all-to-all over
    ``model`` across processes. No gradient."""
    tp = row.tp
    shape = list(parts[0].shape)

    def piece(j):
        lo, hi = ranges[j]
        return tuple(shape[:dim % len(shape)] + [hi - lo]
                     + shape[dim % len(shape) + 1:])
    sends = [[p.detach().narrow(dim, ranges[j][0],
                                ranges[j][1] - ranges[j][0]).contiguous()
              for j in range(tp)] for p in parts]
    got = _exchange(row, sends, [[piece(j) for j in range(tp)]
                                 for _ in range(tp)], parts[0].dtype)
    return [_model_sum(g, parts[0].dtype) for g in got]


def _swap(row: ModelRow, blocks: Sequence[torch.Tensor]
          ) -> List[torch.Tensor]:
    """``exchange_model``'s exchange on tensors."""
    shape = tuple(blocks[0].shape[1:])
    got = _exchange(row, [b.unbind(0) for b in blocks],
                    [[shape] * row.tp] * row.tp, blocks[0].dtype)
    return [torch.stack(r) for r in got]


class _ExchangeModel(torch.autograd.Function):
    """``exchange_model`` with a gradient: the backward is the same
    exchange of the gradients (block i of shard j's gradient goes back to
    shard i as its block j)."""

    @staticmethod
    def forward(ctx, row: ModelRow, *blocks):
        ctx.row, ctx.like = row, [(b.shape, b.dtype, b.device)
                                  for b in blocks]
        return tuple(_swap(row, blocks))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dv) if g is None else g
              for g, (s, dt, dv) in zip(gs, ctx.like)]
        return (None,) + tuple(_swap(ctx.row, gs))


def exchange_model(blocks: Sequence[torch.Tensor], row: ModelRow
                   ) -> List[torch.Tensor]:
    """The all-to-all over ``model`` of each local shard's ``(tp, ...)``
    blocks (one tensor a local shard, in ``row.positions`` order, equal
    shapes): block j of every shard goes to model shard j, which
    receives block i from shard i, in shard order
    (``jax.lax.all_to_all(x, "model", 0, 0, tiled=False)``). In one
    process copies between the shards' devices, across processes one
    ``all_to_all_single`` over the row's model group of the blocks'
    bytes. The backward is the reverse exchange; integer blocks (the
    expert ids) cross without a gradient."""
    if len(blocks) != len(row.positions):
        raise ValueError(f"exchange_model: {len(blocks)} blocks for "
                         f"{len(row.positions)} local shards")
    if any(b.shape[0] != row.tp for b in blocks):
        raise ValueError(f"exchange_model: blocks {blocks[0].shape} for "
                         f"{row.tp} shards")
    if not blocks[0].is_floating_point():
        return _swap(row, blocks)
    return list(_ExchangeModel.apply(row, *blocks))


class _PermuteModel(torch.autograd.Function):
    """``permute_model``: the backward hands each taken row's gradient
    back to its owner (every row is taken once: no sum)."""

    @staticmethod
    def forward(ctx, row: ModelRow, plan, *parts):
        ctx.row, ctx.plan = row, plan
        ctx.like = [(p.shape, p.dtype, p.device) for p in parts]
        return tuple(_permute(row, plan, parts))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        row, plan = ctx.row, ctx.plan
        gs = [torch.zeros((len(plan[j]),) + tuple(s[1:]), dtype=dt,
                          device=dv) if g is None else g
              for g, j, (s, dt, dv) in zip(gs, row.indices, ctx.like)]
        tp = row.tp
        back = [[[] for _ in range(tp)] for _ in gs]
        for k, j in enumerate(row.indices):       # taker j's rows, home
            for t, (i, _) in enumerate(plan[j]):
                back[k][i].append(gs[k][t])
        shape = tuple(gs[0].shape[1:])
        sizes = _plan_sizes(plan, tp)
        got = _exchange(row, [[torch.stack(b) if b else
                               gs[k].new_zeros((0,) + shape) for b in bk]
                              for k, bk in enumerate(back)],
                        [[(sizes[i][j],) + shape for i in range(tp)]
                         for j in range(tp)], gs[0].dtype)
        out = []
        for k, i in enumerate(row.indices):       # owner i
            g = torch.empty(ctx.like[k][0], dtype=gs[0].dtype,
                            device=ctx.like[k][2])
            for j in range(tp):
                rows_ = [r for o, r in plan[j] if o == i]
                if rows_:
                    g[rows_] = got[k][j]
            out.append(g)
        return (None, None) + tuple(out)


def _plan_sizes(plan, tp: int) -> List[List[int]]:
    """``sizes[i][j]``: the rows owner i sends taker j under ``plan``."""
    return [[sum(1 for o, _ in plan[j] if o == i) for j in range(tp)]
            for i in range(tp)]


def _permute(row: ModelRow, plan, parts) -> List[torch.Tensor]:
    """``permute_model``'s exchange on tensors."""
    tp = row.tp
    shape = tuple(parts[0].shape[1:])
    sends = [[parts[k][[r for o, r in plan[j] if o == i]]
              for j in range(tp)] for k, i in enumerate(row.indices)]
    sizes = _plan_sizes(plan, tp)
    got = _exchange(row, sends, [[(sizes[i][j],) + shape
                                  for j in range(tp)] for i in range(tp)],
                    parts[0].dtype)
    out = []
    for k, j in enumerate(row.indices):
        owners = [iter(t) for t in got[k]]   # each owner's rows, in order
        out.append(torch.stack([next(owners[i]) for i, _ in plan[j]]))
    return out


def permute_model(parts: Sequence[torch.Tensor], row: ModelRow,
                  plan: Sequence[Sequence[Tuple[int, int]]]
                  ) -> List[torch.Tensor]:
    """Rows of a leaf's model shards dealt out anew: ``parts`` each local
    shard's tensor (rows along dim 0), ``plan[j]`` the (owner coordinate,
    row) pairs model shard j takes, in the order it stacks them; every
    row of every shard is taken exactly once (a permutation). Returns
    each local shard's stacked rows, on its device: copies in one
    process, one ``all_to_all_single`` over ``model`` across processes
    (each owner sends each taker the rows it takes, nothing else). The
    backward sends each row's gradient back to its owner."""
    if len(parts) != len(row.positions) or len(plan) != row.tp:
        raise ValueError("permute_model: one part a local shard and one "
                         "plan a shard")
    taken = sorted(x for p in plan for x in p)
    if taken != [(i, r) for i in range(row.tp)
                 for r in range(parts[0].shape[0])]:
        raise ValueError("permute_model: the plan takes each row once")
    return list(_PermuteModel.apply(row, tuple(tuple(p) for p in plan),
                                    *parts))


def to_first(row: ModelRow, parts: Sequence[torch.Tensor]
             ) -> Optional[List[torch.Tensor]]:
    """Every shard's tensor (``parts`` the local shards', equal shapes)
    sent to model coordinate 0: the list in model order on its device
    where this process holds coordinate 0, else None. No gradient."""
    tp, shape = row.tp, tuple(parts[0].shape)
    empty = (0,) + shape[1:]
    got = _exchange(row, [[p if j == 0 else p[:0] for j in range(tp)]
                          for p in parts],
                    [[shape if j == 0 else empty for j in range(tp)]
                     for _ in range(tp)], parts[0].dtype)
    k = row.indices.index(0) if 0 in row.indices else None
    return None if k is None else got[k]


def scatter_first(row: ModelRow, parts: Optional[Sequence[torch.Tensor]],
                  shape: Tuple[int, ...], dtype: torch.dtype
                  ) -> List[torch.Tensor]:
    """``to_first``'s reverse: ``parts`` (on coordinate 0's process, one
    a model coordinate, each of ``shape``) handed to their shards; each
    local shard's, on its device. No gradient."""
    tp = row.tp
    empty = (0,) + tuple(shape[1:])
    dev = row.devices[0]
    sends = [[parts[j] if i == 0 else torch.empty(empty, dtype=dtype,
                                                   device=dev)
              for j in range(tp)] for i in row.indices]
    got = _exchange(row, sends, [[tuple(shape) if i == 0 else empty
                                  for _ in range(tp)] for i in range(tp)],
                    dtype)
    return [g[0] for g in got]


def from_first(row: ModelRow, x: Optional[torch.Tensor],
               shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """Model coordinate 0's ``x`` on this process's home of the row: the
    tensor itself in one process (coordinate 0's device is the row's
    home), a broadcast over the row's model group across processes (each
    rank's copy on its device; ``x`` None but on coordinate 0). No
    gradient."""
    if not row.mesh.multi_process:
        return x
    (i,) = row.indices
    empty = (0,) + tuple(shape[1:])
    send = x if i == 0 else torch.empty(empty, dtype=dtype,
                                         device=row.devices[0])
    got = _exchange(row, [[send if i == 0 else send[:0]
                           for _ in range(row.tp)]],
                    [[tuple(shape) if a == 0 else empty
                      for _ in range(row.tp)] for a in range(row.tp)],
                    dtype)
    return got[0][0]


class _MeanRowsModel(torch.autograd.Function):
    """``mean_rows_model``: the backward gives each scalar its share of
    the rows' gradients summed in row order (the mean's true gradient),
    divided as autograd divides it: by each axis's size, the last first,
    then by tp."""

    @staticmethod
    def forward(ctx, mesh, axes, homes, *vals):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.devs = [v.device for v in vals]
        table = _gather_table(mesh, axes, vals)
        ctx.save_for_backward(table)
        out = _mean_table(table, mesh, axes)
        return tuple(out.to(h) for h in homes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        (table,) = ctx.saved_tensors
        mesh, axes = ctx.mesh, ctx.axes
        dev = table.device
        gs = [torch.zeros((), dtype=table.dtype, device=dev) if g is None
              else g.to(dev) for g in gs]
        if mesh.multi_process:
            (q,) = mesh.local_positions()
            gs = all_gather(mesh, {q: gs[0].reshape(1)}, axes)[q]
            gs = [g.reshape(()) for g in gs]
        gsum = gs[0]
        for g in gs[1:]:
            gsum = gsum + g
        for a in reversed(axes):          # the mean's divisions, undone
            gsum = gsum / mesh.shape[a]
        grad = gsum / table.shape[1]
        return (None, None, None) + tuple(grad.to(d) for d in ctx.devs)


def _gather_table(mesh, axes, vals) -> torch.Tensor:
    """The (rows, tp) f32 table of every position's scalar, in row and
    model order, on the first local value's device."""
    tp = mesh.shape["model"]
    if not mesh.multi_process:
        return torch.stack([v.to(vals[0].device) for v in vals]
                           ).reshape(-1, tp)
    (q,) = mesh.local_positions()
    got = all_gather(mesh, {q: vals[0].reshape(1)}, axes + ("model",))[q]
    return torch.cat(got).reshape(-1, tp)


def _mean_table(table: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean over ``model`` (each row's scalars summed in model order,
    over tp), then over each axis of ``axes`` in turn (summed in order,
    over its size): the reference's ``pmean``s."""
    acc = table[:, 0]
    for j in range(1, table.shape[1]):
        acc = acc + table[:, j]
    t = (acc / table.shape[1]).reshape([mesh.shape[a] for a in axes])
    for _ in axes:
        s = t[0]
        for i in range(1, t.shape[0]):
            s = s + t[i]
        t = s / t.shape[0]
    return t


def mean_rows_model(vals: Sequence[Sequence[torch.Tensor]], mesh,
                    axes: Sequence[str], homes: Sequence[torch.device]
                    ) -> List[torch.Tensor]:
    """The mean of a 0-d f32 value at every position of the rows over
    ``axes`` and ``model``: over ``model`` first, then over each axis of
    ``axes`` in turn, each an ordered sum over its size (the reference's
    ``pmean`` over ``model`` and then over each batch axis). ``vals[k]``
    local row k's local shards' values in model order: every row's,
    in row order, in one process; the rank's one across processes (the
    rest all-gathered over ``axes`` and ``model``: scalars, no
    all-reduce). Returns the mean on each local row's home ``homes[k]``.
    The backward gives each value the true gradient: the rows'
    gradients summed in row order (all-gathered across processes), over
    the count, so a one-process run and ranks give the same bits."""
    flat = [v for vs in vals for v in vs]
    return list(_MeanRowsModel.apply(mesh, tuple(axes), tuple(homes), *flat))


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
