"""The block-sharded fused fix loop over a device mesh, the PyTorch port
of ``repro.distributed.shardfix``.

A field splits into blocks over a mesh's data axes
(``repro_torch.launch.mesh``): ``data`` shards field axis 0 into a slab
chain; the block axes ``data_z`` / ``data_y`` / ``data_x`` shard field
axes 0 / 1 / 2 (a 2D field is walked as (Y, 1, X), so ``data_z`` shards
its rows and ``data_y`` its columns). Each block is a tensor on its
mesh device. The mesh lives in one process: where the reference's
``shard_map`` exchanges faces with ``ppermute`` and sums with ``psum``,
this module copies faces between the block tensors (peer copies between
cards, device-local copies when blocks share one) and sums the
violation counts on the mesh's first device. Every result is bitwise the
reference's: fields, violation counts and iteration counts.

Halo exchange per fused iteration (overlap OFF, the plain schedule):

  1. extend every block by 1-deep ``g`` faces along every sharded axis
     IN ORDER — a later axis takes its faces from the blocks already
     extended along the earlier ones, so the 26-stencil's edge and
     corner ghosts arrive without diagonal sends (the two-phase face
     exchange);
  2. run the extrema kernel on each extended block in GLOBAL coordinates
     (origin ``index * L - 1`` per sharded axis, the field's extents as
     totals): its interior is exact;
  3. exchange 1-deep faces of the interior masks the same way (one
     stacked exchange of all four mask arrays);
  4. run the fix kernel on each extended block and keep its interior;
  5. count fix sources over each block's real (non-pad) interior and
     sum over blocks: the loop's convergence count.

With overlap ON (default for block meshes whose blocks keep >= 3
vertices a sharded axis) one 2-deep ``g`` exchange replaces both
exchanges: an *interior pass* (extrema and fix on the bare block) needs
no ghost, and a *boundary pass* of thin shells recomputes the ghost
ring's masks from the deep ghosts. On the card the exchange runs on a
side stream of each device while the interior pass runs on the current
stream. Both schedules give the same trajectory bit for bit.

Blocks stay resident for the whole loop: the field and its topology
split once, every iteration runs on the blocks, and g is assembled
once. Non-divisible extents zero-pad at the high end of each sharded
axis; the kernels mask true domain edges in global coordinates, so pad
content never reaches a real vertex. The per-block dirty worklist skips
both kernels on a block when no ``g`` change of the last iteration lay
within 2 vertices of it, with the dirt flags relayed axis by axis like
the halos. An iteration makes one device->host read (``device._d2h``):
the blocks' source counts and dirt flags, gathered on the mesh's first
device.

``ShardedBackend`` is registered as ``"sharded"``; ``resolve_backend(
"auto", ..., mesh=m)`` picks it whenever ``m`` (or the mesh of an
enclosing ``with mesh:``) has >= 2 blocks on its data axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.backend import register_backend
from ..core.fixes import FieldTopo
from ..device import _d2h
from ..launch.mesh import DeviceMesh, active_mesh

DATA_AXIS = "data"
#: block-mesh axis names, by the FIELD axis they shard: data_z -> axis 0
#: (the kernel slab axis), data_y -> axis 1, data_x -> axis 2.
BLOCK_AXES = ("data_z", "data_y", "data_x")
#: every mesh axis name the sharded backend recognizes as a data axis.
ALL_DATA_AXES = (DATA_AXIS,) + BLOCK_AXES

#: face bytes copied between blocks by the fix loops' per-iteration
#: exchanges, per mesh axis name (the topology's one-time exchange is
#: not counted); ``reset_halo_bytes`` zeroes it
halo_bytes: Dict[str, int] = {}

BlockId = Tuple[int, ...]
Blocks = Dict[BlockId, torch.Tensor]


def reset_halo_bytes() -> None:
    """Zero the ``halo_bytes`` counters."""
    halo_bytes.clear()


# ---------------------------------------------------------------------------
# mesh discovery
# ---------------------------------------------------------------------------

def active_data_mesh(axis_name: Optional[str] = None
                     ) -> Optional[DeviceMesh]:
    """The mesh of the innermost ``with mesh:`` if it has ``axis_name``
    (or, when None, any recognized data axis), else None. This is what
    makes ``backend="auto"`` mesh-aware."""
    m = active_mesh()
    if m is None:
        return None
    names = (axis_name,) if axis_name is not None else ALL_DATA_AXES
    if not any(n in m.axis_names for n in names):
        return None
    return m


def data_axis_size(mesh, axis_name: Optional[str] = None) -> int:
    """Blocks on ``axis_name`` (or, when None, the product over every
    recognized data axis present); 0 when the mesh is absent or has no
    such axis."""
    if mesh is None:
        return 0
    names = (axis_name,) if axis_name is not None else ALL_DATA_AXES
    present = [n for n in names if n in mesh.axis_names]
    if not present:
        return 0
    size = 1
    for n in present:
        size *= int(mesh.shape[n])
    return size


# ---------------------------------------------------------------------------
# block decomposition plan
# ---------------------------------------------------------------------------

class BlockAxis(NamedTuple):
    """One sharded field axis of a block plan: field axis ``dim`` splits
    into ``n`` blocks of (padded) extent ``L`` over mesh axis ``name``."""
    dim: int
    name: str
    n: int
    L: int


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """How a field decomposes over a mesh's data axes. ``names`` maps
    each field axis to its mesh axis name (None when unsharded);
    ``sharded`` lists the axes with >= 2 blocks, in field-axis order —
    the two-phase exchange order."""
    shape: Tuple[int, ...]
    names: Tuple[Optional[str], ...]
    sharded: Tuple[BlockAxis, ...]
    legacy: bool

    @property
    def ndim(self) -> int:
        """Field rank (2 or 3)."""
        return len(self.shape)

    def padded_shape(self) -> Tuple[int, ...]:
        """Field shape after padding every sharded axis to ``n * L``."""
        out = list(self.shape)
        for a in self.sharded:
            out[a.dim] = a.n * a.L
        return tuple(out)

    def block_shape(self) -> Tuple[int, ...]:
        """Local block shape (padded extents)."""
        out = list(self.shape)
        for a in self.sharded:
            out[a.dim] = a.L
        return tuple(out)

    def min_block(self) -> int:
        """Smallest sharded block extent (large sentinel when unsharded)."""
        return min([a.L for a in self.sharded], default=1 << 30)


def plan_blocks(shape: Sequence[int], mesh,
                axis_name: Optional[str] = None) -> BlockPlan:
    """The :class:`BlockPlan` of a field ``shape`` on ``mesh``.
    ``axis_name`` forces the legacy single-axis decomposition over that
    mesh axis (field axis 0). Otherwise ``data`` maps to field axis 0,
    or the block axes ``data_z``/``data_y``/``data_x`` to field axes
    0/1/2; mixing ``data`` with block axes is an error, as is a
    >1-block ``data_x`` axis with a 2D field."""
    # mszlint: disable=transfer-discipline -- host planning over a shape tuple
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    if ndim not in (2, 3):
        raise ValueError(f"block decomposition supports 2D/3D, got {shape}")
    names_map: Dict[int, str] = {}
    legacy = True
    if axis_name is not None:
        if axis_name not in mesh.axis_names:
            raise ValueError(
                f"mesh {mesh} has no {axis_name!r} axis to shard over")
        names_map[0] = axis_name
    else:
        block_present = [n for n in BLOCK_AXES if n in mesh.axis_names]
        if DATA_AXIS in mesh.axis_names:
            if block_present:
                raise ValueError(
                    f"mesh mixes the legacy {DATA_AXIS!r} axis with block "
                    f"axes {block_present}; use one naming scheme")
            names_map[0] = DATA_AXIS
        elif block_present:
            legacy = False
            for dim, nm in enumerate(BLOCK_AXES):
                if nm not in mesh.axis_names:
                    continue
                if dim >= ndim:
                    if int(mesh.shape[nm]) > 1:
                        raise ValueError(
                            f"{nm!r} has {int(mesh.shape[nm])} devices but "
                            f"the field is {ndim}D; 2D fields shard over "
                            "('data_y','data_z') only")
                    continue
                names_map[dim] = nm
        else:
            raise ValueError(
                f"mesh axes {mesh.axis_names} include no data axis "
                f"(one of {ALL_DATA_AXES}); build one with "
                "launch.mesh.make_data_mesh / make_block_mesh")
    names = tuple(names_map.get(d) for d in range(ndim))
    sharded = []
    for dim in range(ndim):
        nm = names[dim]
        if nm is None:
            continue
        n = int(mesh.shape[nm])
        if n >= 2:
            sharded.append(BlockAxis(dim, nm, n, -(-shape[dim] // n)))
    return BlockPlan(shape, names, tuple(sharded), legacy)


def _resolve_modes(plan: BlockPlan, overlap: Optional[bool],
                   worklist: Optional[bool]) -> Tuple[bool, bool]:
    """(use_overlap, use_worklist) for a plan. Overlap needs >= 3
    vertices a sharded axis (default on for block meshes, off for
    legacy ``data`` chains); the worklist needs >= 2 (default on)."""
    # mszlint: disable=transfer-discipline -- plan/overlap are host config
    sharded = bool(plan.sharded)
    can_overlap = sharded and plan.min_block() >= 3
    use_overlap = (can_overlap if overlap is None
                   # mszlint: disable=transfer-discipline -- host config
                   else bool(overlap) and can_overlap)
    if overlap is None and plan.legacy:
        use_overlap = False
    can_wl = sharded and plan.min_block() >= 2
    use_wl = (worklist if worklist is not None else True) and can_wl
    return use_overlap, use_wl


# ---------------------------------------------------------------------------
# blocks: placement, split and assembly
# ---------------------------------------------------------------------------

def _sl(plan: BlockPlan, per_axis: Dict[int, slice],
        offset: int = 0) -> Tuple[slice, ...]:
    """A slice tuple: ``per_axis[dim]`` on the listed dims, full slices
    elsewhere; ``offset`` prepends full slices (stacked arrays)."""
    out = [slice(None)] * (plan.ndim + offset)
    for dim, s in per_axis.items():
        out[dim + offset] = s
    return tuple(out)


class _Layout:
    """The blocks of a plan on a mesh: their ids (one index a sharded
    axis), devices, global origins and real extents."""

    def __init__(self, plan: BlockPlan, mesh):
        self.plan = plan
        self.ids: List[BlockId] = list(itertools.product(
            *(range(a.n) for a in plan.sharded)))
        self.first = mesh.devices.reshape(-1)[0]
        self.dev: Dict[BlockId, torch.device] = {}
        for bid in self.ids:
            idx = [0] * len(mesh.axis_names)
            for a, i in zip(plan.sharded, bid):
                idx[mesh.axis_names.index(a.name)] = i
            self.dev[bid] = mesh.devices[tuple(idx)]
        self.cuda = [d for d in dict.fromkeys(self.dev.values())
                     if d.type == "cuda"]

    def origin(self, bid: BlockId) -> List[int]:
        """The block's global origin a field axis."""
        o = [0] * self.plan.ndim
        for a, i in zip(self.plan.sharded, bid):
            o[a.dim] = i * a.L
        return o

    def neighbor(self, bid: BlockId, k: int, step: int
                 ) -> Optional[BlockId]:
        """The block ``step`` places along sharded axis ``k``, or None
        past a chain end (the chain does not wrap)."""
        j = bid[k] + step
        if not 0 <= j < self.plan.sharded[k].n:
            return None
        return bid[:k] + (j,) + bid[k + 1:]

    def real(self, bid: BlockId) -> Tuple[slice, ...]:
        """Block-local slices of the block's real (non-pad) vertices."""
        o = self.origin(bid)
        shp = self.plan.block_shape()
        return tuple(slice(0, max(0, min(shp[d], self.plan.shape[d] - o[d])))
                     for d in range(self.plan.ndim))

    def _global(self, bid: BlockId) -> Tuple[slice, ...]:
        o = self.origin(bid)
        return tuple(slice(o[d], o[d] + r.stop)
                     for d, r in enumerate(self.real(bid)))

    def split(self, x: torch.Tensor) -> Blocks:
        """Copy each block of ``x`` (the global field) to its device,
        zero-padded at the high end of each sharded axis."""
        shp = self.plan.block_shape()
        out = {}
        for bid in self.ids:
            real = self.real(bid)
            padded = any(r.stop != s for r, s in zip(real, shp))
            make = torch.zeros if padded else torch.empty
            blk = make(shp, dtype=x.dtype, device=self.dev[bid])
            blk[real].copy_(x[self._global(bid)])
            out[bid] = blk
        return out

    def assemble(self, blocks: Blocks, device: torch.device) -> torch.Tensor:
        """The global field from the blocks' real vertices, on
        ``device``."""
        b0 = blocks[self.ids[0]]
        out = torch.empty(self.plan.shape, dtype=b0.dtype, device=device)
        for bid in self.ids:
            out[self._global(bid)].copy_(blocks[bid][self.real(bid)])
        return out

    def coords(self, bid: BlockId, start: Sequence[int]) -> dict:
        """Kernel placement kwargs for an array that begins at block
        layer ``start[d]`` along field axis d (negative: inside the
        ghost ring). 2D fields use the slab/col pairs."""
        s = self.plan.shape
        o = [a + b for a, b in zip(self.origin(bid), start)]
        if self.plan.ndim == 3:
            return dict(slab_lo=o[0], n_slabs_total=s[0],
                        row_lo=o[1], n_rows_total=s[1],
                        col_lo=o[2], n_cols_total=s[2])
        return dict(slab_lo=o[0], n_slabs_total=s[0],
                    row_lo=0, n_rows_total=1,
                    col_lo=o[1], n_cols_total=s[1])

    def sharded_start(self, value: int) -> List[int]:
        """``value`` on every sharded field axis, 0 elsewhere."""
        start = [0] * self.plan.ndim
        for a in self.plan.sharded:
            start[a.dim] = value
        return start


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

def halo_exchange(blocks: Blocks, lay: _Layout, k: int, *, axis: int,
                  depth: int = 1, tally: Optional[Dict[str, int]] = None
                  ) -> Dict[BlockId, Tuple[torch.Tensor, torch.Tensor]]:
    """``depth``-layer ghost faces of every block along tensor axis
    ``axis`` from its chain neighbours on sharded axis ``k``: ``(lo,
    hi)``, ``lo`` the previous block's last ``depth`` layers, ``hi`` the
    next block's first, each on the receiving block's device. The chain
    does not wrap: the first block's ``lo`` and the last block's ``hi``
    are zeros built locally (the kernels mask true domain edges
    themselves). ``tally`` adds the bytes of the faces that came from a
    neighbour under the axis's mesh name."""
    name = lay.plan.sharded[k].name
    out = {}
    for bid, x in blocks.items():
        dev = x.device
        faces = []
        for step, at_end in ((-1, True), (1, False)):
            nb = lay.neighbor(bid, k, step)
            if nb is None:
                faces.append(torch.zeros_like(x.narrow(axis, 0, depth)))
                continue
            y = blocks[nb]
            face = y.narrow(axis, y.shape[axis] - depth if at_end else 0,
                            depth).to(dev)
            if tally is not None:
                tally[name] = (tally.get(name, 0)
                               + face.numel() * face.element_size())
            faces.append(face)
        out[bid] = (faces[0], faces[1])
    return out


def with_halo(blocks: Blocks, lay: _Layout) -> Blocks:
    """Extend each block of a 1-axis slab chain by one exchanged ghost
    slab at both ends (the legacy helper; block meshes use
    ``block_halo``)."""
    faces = halo_exchange(blocks, lay, 0, axis=0)
    return {bid: torch.cat([lo, blocks[bid], hi], dim=0)
            for bid, (lo, hi) in faces.items()}


def block_halo(blocks: Blocks, lay: _Layout, depth: int, *,
               axis_offset: int = 0,
               tally: Optional[Dict[str, int]] = None) -> Blocks:
    """The two-phase axis-ordered face exchange: extend every block by
    ``depth`` ghost layers along each sharded axis in field-axis order.
    A later axis takes its faces from the blocks already extended along
    the earlier ones, so after all phases every edge and corner ghost of
    the 26-stencil holds its diagonal neighbour's value without a
    diagonal send. ``axis_offset`` shifts field axes for stacked
    payloads (a leading channel axis)."""
    ext = blocks
    for k, a in enumerate(lay.plan.sharded):
        ax = a.dim + axis_offset
        faces = halo_exchange(ext, lay, k, axis=ax, depth=depth, tally=tally)
        ext = {bid: torch.cat([lo, ext[bid], hi], dim=ax)
               for bid, (lo, hi) in faces.items()}
    return ext


def exchange_tree(leaves: Sequence[Blocks], lay: _Layout, depth: int
                  ) -> List[Blocks]:
    """Halo-extend several field-shaped leaves (each a dict of blocks)
    with ONE stacked exchange per dtype group: leaves of one dtype stack
    along a new leading axis, ride one two-phase exchange, and unstack.
    The fix loop's constant topology (four int32 leaves, two bool
    masks, one float bound) moves in three exchanges instead of
    seven."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf[lay.ids[0]].dtype, []).append(i)
    out: List[Optional[Blocks]] = [None] * len(leaves)
    for idxs in by_dtype.values():
        stacked = {bid: torch.stack([leaves[i][bid] for i in idxs])
                   for bid in lay.ids}
        ext = block_halo(stacked, lay, depth, axis_offset=1)
        for k, i in enumerate(idxs):
            out[i] = {bid: ext[bid][k] for bid in lay.ids}
    return out


# ---------------------------------------------------------------------------
# the block loop
# ---------------------------------------------------------------------------

def _kernels():
    from ..kernels.extrema import extrema_masks
    from ..kernels.fixpass import fix_pass
    return extrema_masks, fix_pass


class _BlockLoop:
    """The state of one sharded fix loop: the blocks of g, the
    halo-extended topology (constant), the schedule flags, the
    per-block source counts, run flags and mask caches."""

    def __init__(self, g0: torch.Tensor, topo, mesh, *,
                 axis_name: Optional[str], overlap: Optional[bool],
                 worklist: Optional[bool]):
        self.plan = plan_blocks(tuple(g0.shape), mesh, axis_name)
        self.lay = lay = _Layout(self.plan, mesh)
        self.overlap, self.worklist = _resolve_modes(self.plan, overlap,
                                                     worklist)
        depth = 2 if self.overlap else 1
        self.g = lay.split(g0)
        ext = exchange_tree([lay.split(x) for x in topo], lay, depth)
        self.topo = {bid: FieldTopo(*(leaf[bid] for leaf in ext))
                     for bid in lay.ids}
        self.run = dict.fromkeys(lay.ids, True)
        self.src = dict.fromkeys(lay.ids, 0)
        self.cache: Blocks = {}
        self.views = ({bid: self._shell_views(bid) for bid in lay.ids}
                      if self.overlap else {})
        self.side = ({d: torch.cuda.Stream(d) for d in lay.cuda}
                     if self.overlap else {})

    # -- per-iteration reports ----------------------------------------
    def _report(self, bid: BlockId, masks: torch.Tensor,
                g2: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """int64 [sources over real vertices, and with the worklist:
        g changed anywhere, then per sharded axis changed within 2
        layers of the low face, of the high face] — on the block's
        device."""
        real = self.lay.real(bid)
        parts = [masks[(slice(0, 3),) + real].sum().reshape(1)]
        if self.worklist:
            ch = (g2 != g)[real]
            parts.append(ch.any().reshape(1))
            for a in self.plan.sharded:
                n = ch.shape[a.dim]
                lo = min(a.L - 2, n)
                parts.append(ch.narrow(a.dim, 0, min(2, n)).any().reshape(1))
                parts.append(ch.narrow(a.dim, lo, n - lo).any().reshape(1))
        return torch.cat([p.to(torch.int64) for p in parts])

    def gather(self, vecs: Dict[BlockId, torch.Tensor]) -> torch.Tensor:
        """The running blocks' reports, one after another on the mesh's
        first device."""
        return torch.cat([vecs[bid].to(self.lay.first) for bid in vecs])

    def absorb(self, vecs: Dict[BlockId, torch.Tensor],
               counts: np.ndarray) -> None:
        """Fold one iteration's host copy of the reports into the source
        counts and the next run flags (a skipped block keeps its stale,
        still exact count). The dirt flags relay axis by axis, as the
        reference's ppermutes do: a block hears of dirt from the
        neighbour's facing edge or from what that neighbour heard along
        the earlier axes."""
        w = 1 + (1 + 2 * len(self.plan.sharded)) * self.worklist
        rep = {bid: counts[i * w:(i + 1) * w] for i, bid in enumerate(vecs)}
        for bid, r in rep.items():
            # mszlint: disable=transfer-discipline -- counts came via _d2h
            self.src[bid] = int(r[0])
        if not self.worklist:
            return
        zero = np.zeros(w, np.int64)
        rep = {bid: rep.get(bid, zero) for bid in self.lay.ids}
        recv = dict.fromkeys(self.lay.ids, False)
        for k in range(len(self.plan.sharded)):
            new = {}
            for bid in self.lay.ids:
                got = recv[bid]
                prv = self.lay.neighbor(bid, k, -1)
                nxt = self.lay.neighbor(bid, k, 1)
                if prv is not None:
                    # mszlint: disable=transfer-discipline -- host (_d2h)
                    got = got or bool(rep[prv][3 + 2 * k]) or recv[prv]
                if nxt is not None:
                    # mszlint: disable=transfer-discipline -- host (_d2h)
                    got = got or bool(rep[nxt][2 + 2 * k]) or recv[nxt]
                new[bid] = got
            recv = new
        # mszlint: disable=transfer-discipline -- host flags (_d2h)
        self.run = {bid: bool(rep[bid][1]) or recv[bid]
                    for bid in self.lay.ids}

    def violations(self) -> int:
        """The summed source count of the last iteration."""
        return sum(self.src.values())

    # -- the plain schedule -------------------------------------------
    def step_plain(self, tally: Optional[Dict[str, int]] = None):
        """One non-overlapped iteration on every block: returns (g2,
        reports of the blocks that ran). A skipped block re-sends the
        mask faces of the last iteration it ran (its cached masks),
        still exact because nothing within its dependency radius
        changed."""
        extrema_masks, fix_pass = _kernels()
        lay, g = self.lay, self.g
        inner = _sl(self.plan, {a.dim: slice(1, -1)
                                for a in self.plan.sharded})
        start = lay.sharded_start(-1)
        g_ext = block_halo(g, lay, 1, tally=tally)
        stacked: Blocks = {}
        for bid in lay.ids:
            if not self.run[bid]:
                stacked[bid] = self.cache[bid]
                continue
            t = self.topo[bid]
            up_c, _, se, dem, pro = extrema_masks(
                g_ext[bid], t.M, t.m, t.is_max, t.is_min,
                **lay.coords(bid, start))
            stacked[bid] = torch.stack([se[inner], dem[inner], pro[inner],
                                        up_c[inner]])
        if self.worklist:
            self.cache = stacked
        m_ext = block_halo(stacked, lay, 1, axis_offset=1, tally=tally)
        g2, vecs = {}, {}
        for bid in lay.ids:
            if not self.run[bid]:
                g2[bid] = g[bid]
                continue
            t, m = self.topo[bid], m_ext[bid]
            out, _, _ = fix_pass(g_ext[bid], t.lower, m[0], m[1], m[2], m[3],
                                 t.dn_c, **lay.coords(bid, start))
            g2[bid] = out[inner].contiguous()
            vecs[bid] = self._report(bid, stacked[bid], g2[bid], g[bid])
        return g2, vecs

    # -- the overlap schedule -----------------------------------------
    def _shell_views(self, bid: BlockId) -> dict:
        """The constant topology slices the overlap schedule's kernels
        read, made contiguous once: the interior pass's, and each
        sharded axis's low and high shells'."""
        plan, t = self.plan, self.topo[bid]
        sh = plan.sharded

        def take(idx):
            return FieldTopo(*(x[idx].contiguous() for x in t))
        views = {"c2": take(_sl(plan, {a.dim: slice(2, -2) for a in sh})),
                 "ci": take(_sl(plan, {a.dim: slice(3, a.L + 1)
                                       for a in sh}))}
        for a in sh:
            others = {b.dim: slice(0, b.L + 4) for b in sh if b.dim != a.dim}
            o_g = {b.dim: slice(1, b.L + 3) for b in sh if b.dim != a.dim}
            views[("m", a.dim, 0)] = take(_sl(plan, {**others,
                                                     a.dim: slice(0, 4)}))
            views[("m", a.dim, 1)] = take(_sl(plan, {
                **others, a.dim: slice(a.L, a.L + 4)}))
            views[("f", a.dim, 0)] = take(_sl(plan, {**o_g,
                                                     a.dim: slice(1, 5)}))
            views[("f", a.dim, 1)] = take(_sl(plan, {
                **o_g, a.dim: slice(a.L - 1, a.L + 3)}))
        return views

    def _exchange2(self, tally: Optional[Dict[str, int]]) -> Blocks:
        """The single 2-deep ``g`` exchange; on the card it runs on each
        device's side stream, after the work already queued on the
        current stream, and its results are recorded on the current
        stream that will read them."""
        if not self.side:
            return block_halo(self.g, self.lay, 2, tally=tally)
        for d, s in self.side.items():
            s.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as stack:
            for s in self.side.values():
                stack.enter_context(torch.cuda.stream(s))
            ext2 = block_halo(self.g, self.lay, 2, tally=tally)
        for t in ext2.values():
            t.record_stream(torch.cuda.current_stream(t.device))
        return ext2

    def _join(self) -> None:
        for d, s in self.side.items():
            torch.cuda.current_stream(d).wait_stream(s)

    def step_overlap(self, tally: Optional[Dict[str, int]] = None,
                     part: str = "full"):
        """One overlapped iteration: the 2-deep exchange (a zero pad
        under ``part="interior"``, which times the kernels alone)
        alongside the interior pass of every running block, then the
        boundary shells. Returns (g2, reports of the blocks that ran)."""
        extrema_masks, fix_pass = _kernels()
        plan, lay, g = self.plan, self.lay, self.g
        sh = plan.sharded
        if part == "interior":
            ext2 = {bid: _zero_ring(x, plan, 2) for bid, x in g.items()}
        else:
            ext2 = self._exchange2(tally)
        running = [bid for bid in lay.ids if self.run[bid]]

        def masks(g_arr, t, bid, start):
            up_c, _, se, dem, pro = extrema_masks(
                g_arr, t.M, t.m, t.is_max, t.is_min,
                **lay.coords(bid, start))
            return torch.stack([se, dem, pro, up_c])

        def fix(g_arr, m, t, bid, start):
            out, _, _ = fix_pass(g_arr, t.lower, m[0], m[1], m[2], m[3],
                                 t.dn_c, **lay.coords(bid, start))
            return out

        # interior pass: no ghost read, so it overlaps the exchange
        c1 = {a.dim: slice(1, -1) for a in sh}
        m_int, g2 = {}, {}
        for bid in running:
            v = self.views[bid]
            m_int[bid] = masks(g[bid], v["c2"], bid, [0] * plan.ndim)
            g_ci = g[bid][_sl(plan, c1)].contiguous()
            m_ci = m_int[bid][_sl(plan, c1, offset=1)].contiguous()
            out = fix(g_ci, m_ci, v["ci"], bid, lay.sharded_start(1))
            g2[bid] = torch.zeros_like(g[bid])
            g2[bid][_sl(plan, {a.dim: slice(2, -2) for a in sh})] = \
                out[_sl(plan, c1)]
        self._join()

        # boundary pass: the ghost ring's and the faces' masks from the
        # deep ghosts, then the shells of the fix pass
        ext1 = tuple(s + 2 if any(a.dim == d for a in sh) else s
                     for d, s in enumerate(plan.block_shape()))
        vecs = {}
        for bid in running:
            v, e2 = self.views[bid], ext2[bid]
            m1 = torch.zeros((4,) + ext1, dtype=torch.int32,
                             device=e2.device)
            m1[_sl(plan, c1, offset=1)] = m_int.pop(bid)
            start = lay.sharded_start(-2)
            for a in sh:
                keep_o = {b.dim: slice(1, b.L + 3) for b in sh
                          if b.dim != a.dim}
                keep = _sl(plan, {**keep_o, a.dim: slice(1, 3)}, offset=1)
                others = {b.dim: slice(0, b.L + 4) for b in sh
                          if b.dim != a.dim}
                for side, (src_sl, dst_sl, at) in enumerate((
                        (slice(0, 4), slice(0, 2), -2),
                        (slice(a.L, a.L + 4), slice(a.L, a.L + 2),
                         a.L - 2))):
                    s = list(start)
                    s[a.dim] = at
                    g_sh = e2[_sl(plan, {**others, a.dim: src_sl})]
                    m_sh = masks(g_sh.contiguous(), v[("m", a.dim, side)],
                                 bid, s)
                    m1[_sl(plan, {a.dim: dst_sl}, offset=1)] = m_sh[keep]
            for a in sh:
                o_m1 = {b.dim: slice(0, b.L + 2) for b in sh if b.dim != a.dim}
                o_g = {b.dim: slice(1, b.L + 3) for b in sh if b.dim != a.dim}
                keep_o = {b.dim: slice(1, b.L + 1) for b in sh
                          if b.dim != a.dim}
                keep = _sl(plan, {**keep_o, a.dim: slice(1, 3)})
                base = [0] * plan.ndim
                for b in sh:
                    if b.dim != a.dim:
                        base[b.dim] = -1
                for side, (m_sl, g_sl, dst_sl, at) in enumerate((
                        (slice(0, 4), slice(1, 5), slice(0, 2), -1),
                        (slice(a.L - 2, a.L + 2), slice(a.L - 1, a.L + 3),
                         slice(a.L - 2, a.L), a.L - 3))):
                    s = list(base)
                    s[a.dim] = at
                    g_sh = e2[_sl(plan, {**o_g, a.dim: g_sl})].contiguous()
                    m_sh = m1[_sl(plan, {**o_m1, a.dim: m_sl},
                                  offset=1)].contiguous()
                    out = fix(g_sh, m_sh, v[("f", a.dim, side)], bid, s)
                    g2[bid][_sl(plan, {a.dim: dst_sl})] = out[keep]
            vecs[bid] = self._report(bid, m1[_sl(plan, c1, offset=1)],
                                     g2[bid], g[bid])
        for bid in lay.ids:
            if bid not in g2:
                g2[bid] = g[bid]
        return g2, vecs

    def step(self, tally: Optional[Dict[str, int]] = None):
        """One iteration of the schedule this loop runs."""
        if self.overlap:
            return self.step_overlap(tally)
        return self.step_plain(tally)

    def run_loop(self, max_iters: int) -> int:
        """Iterate until no block reports a source or ``max_iters``
        iterations ran (the first always runs); returns the count."""
        it = 0
        while True:
            g2, vecs = self.step(halo_bytes)
            counts = _d2h(self.gather(vecs)) if vecs else np.zeros(0)
            self.absorb(vecs, counts)
            self.g = g2
            it += 1
            if self.violations() == 0 or it >= max_iters:
                return it


def _zero_ring(x: torch.Tensor, plan: BlockPlan, depth: int) -> torch.Tensor:
    """``x`` with ``depth`` zero layers on both ends of every sharded
    axis."""
    shp = list(x.shape)
    for a in plan.sharded:
        shp[a.dim] += 2 * depth
    out = torch.zeros(shp, dtype=x.dtype, device=x.device)
    out[_sl(plan, {a.dim: slice(depth, -depth) for a in plan.sharded})] = x
    return out


# ---------------------------------------------------------------------------
# the loop, its accounting and its timing probe
# ---------------------------------------------------------------------------

def sharded_fix(g0: torch.Tensor, topo, mesh, *, max_iters: int = 512,
                axis_name: Optional[str] = None,
                worklist: Optional[bool] = None,
                overlap: Optional[bool] = None) -> Tuple[torch.Tensor, int,
                                                         bool]:
    """Run the fused fix loop to convergence over ``mesh``'s data axes
    (1D slab chains or 2D/3D block meshes). Returns (g, iters,
    converged), g on ``g0``'s device, bitwise ``fused_fix``'s.

    The blocks stay resident for the whole loop: g and the topology
    split once (the constant topology's halos exchanged once, one
    stacked exchange a dtype group), only ``g`` — and, without overlap,
    mask — faces move each iteration, and g is assembled once.
    ``worklist`` (default on with >= 2 vertices a sharded axis) is the
    per-block dirty skip; ``overlap`` (default on for block meshes with
    >= 3-vertex blocks, off for ``data`` chains) the interior/boundary
    schedule. All four combinations give the same trajectory."""
    loop = _BlockLoop(g0, topo, mesh, axis_name=axis_name, overlap=overlap,
                      worklist=worklist)
    iters = loop.run_loop(max_iters)
    return (loop.lay.assemble(loop.g, g0.device), iters,
            loop.violations() == 0)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def halo_plan(shape: Sequence[int], dtype, mesh, *,
              axis_name: Optional[str] = None,
              overlap: Optional[bool] = None,
              worklist: Optional[bool] = None) -> Dict[str, int]:
    """Per-mesh-axis halo bytes of ONE fix iteration, summed over all
    blocks (both directions, including the edge and corner rows that
    later phases relay). Overlap OFF counts the g faces plus the
    stacked 4-channel int32 mask faces; overlap ON the single 2-deep g
    exchange. The stream multiplies it by the observed iteration counts
    for ``stats()["shard"]``."""
    plan = plan_blocks(shape, mesh, axis_name)
    use_overlap, _ = _resolve_modes(plan, overlap, worklist)
    item = _itemsize(dtype)
    out: Dict[str, int] = {}

    def sweep(depth, channels, itemsize):
        dims = list(plan.block_shape())
        for a in plan.sharded:
            face = depth * channels * itemsize
            for d, s in enumerate(dims):
                if d != a.dim:
                    face *= s
            senders = 2 * (a.n - 1)
            for b in plan.sharded:
                if b.dim != a.dim:
                    senders *= b.n
            out[a.name] = out.get(a.name, 0) + face * senders
            dims[a.dim] += 2 * depth
    if use_overlap:
        sweep(2, 1, item)
    else:
        sweep(1, 1, item)
        sweep(1, 4, 4)
    return out


def _timed_s(fn, lay: _Layout) -> float:
    """Seconds of ``fn()``: CUDA events on each card of the mesh (the
    longest of them), the host clock on the CPU."""
    if not lay.cuda:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    for d in lay.cuda:
        torch.cuda.synchronize(d)
    ev = {}
    for d in lay.cuda:
        ev[d] = [torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)]
        ev[d][0].record(torch.cuda.current_stream(d))
    fn()
    for d in lay.cuda:
        ev[d][1].record(torch.cuda.current_stream(d))
    for d in lay.cuda:
        ev[d][1].synchronize()
    return max(a.elapsed_time(b) for a, b in ev.values()) / 1e3


def time_step_parts(g0: torch.Tensor, topo, mesh, *,
                    axis_name: Optional[str] = None,
                    reps: int = 3) -> Dict[str, object]:
    """Seconds (best of ``reps``, after one warm-up) of one overlapped
    iteration's parts on real tensors: ``t_interior_s`` (every kernel,
    ghosts zero-filled, no exchange), ``t_exchange_s`` (the 2-deep
    exchange alone), ``t_full_s`` (the whole step) and ``t_boundary_s``
    = full - interior; the plain schedule's ``t_full_s`` alone when the
    plan cannot overlap. The surface the service's ``shard_timings``
    serves."""
    loop = _BlockLoop(g0, topo, mesh, axis_name=axis_name, overlap=True,
                      worklist=False)

    def full():
        _, vecs = loop.step()
        loop.gather(vecs)

    def interior():
        _, vecs = loop.step_overlap(part="interior")
        loop.gather(vecs)

    def exchange():
        loop._exchange2(None)
        loop._join()

    parts = ({"interior": interior, "exchange": exchange, "full": full}
             if loop.overlap else {"full": full})
    res: Dict[str, object] = {}
    for name, fn in parts.items():
        fn()
        res[f"t_{name}_s"] = min(_timed_s(fn, loop.lay)
                                 for _ in range(max(1, reps)))
    if loop.overlap:
        res["t_boundary_s"] = max(0.0, res["t_full_s"] - res["t_interior_s"])
    res["overlap"] = loop.overlap
    return res


# ---------------------------------------------------------------------------
# the sharded base transform, its inverse and the edit scatter
# ---------------------------------------------------------------------------

def sharded_transform(f: torch.Tensor, step: torch.Tensor, mesh, *,
                      axis_name: Optional[str] = None) -> torch.Tensor:
    """Quantize + integer Lorenzo over the mesh: each block runs the
    Lorenzo kernel after one backward 1-deep face exchange a sharded
    axis (the stencil is backward only; the two-phase order delivers
    the backward edge and corner ghosts). The kernel places slabs in
    global coordinates (``slab_lo``); zero ghosts at the domain's start
    match the codec's zero padding, and in-plane ghosts feed the
    in-plane backward differences. The codes are bitwise a single
    launch's."""
    from ..kernels.lorenzo import lorenzo_quant
    plan = plan_blocks(tuple(f.shape), mesh, axis_name)
    lay = _Layout(plan, mesh)
    ext = lay.split(f)
    for k, a in enumerate(plan.sharded):
        nxt = {}
        for bid, x in ext.items():
            prv = lay.neighbor(bid, k, -1)
            if prv is None:
                lo = torch.zeros_like(x.narrow(a.dim, 0, 1))
            else:
                y = ext[prv]
                lo = y.narrow(a.dim, y.shape[a.dim] - 1, 1).to(x.device)
            nxt[bid] = torch.cat([lo, x], dim=a.dim)
        ext = nxt
    sh0 = next((k for k, a in enumerate(plan.sharded) if a.dim == 0), None)
    drop = _sl(plan, {a.dim: slice(1, None) for a in plan.sharded})
    out = {}
    for bid, x in ext.items():
        slab_lo = bid[sh0] * plan.sharded[sh0].L - 1 if sh0 is not None else 0
        r = lorenzo_quant(x, step.to(device=x.device, dtype=x.dtype),
                          slab_lo=slab_lo)
        out[bid] = r[drop]
    return lay.assemble(out, f.device)


def sharded_reconstruct(r: torch.Tensor, step: torch.Tensor, dtype, mesh, *,
                        axis_name: Optional[str] = None) -> torch.Tensor:
    """The inverse transform over the mesh: along every sharded axis the
    global cumsum becomes the local int32 cumsum plus an exclusive
    prefix of the blocks' totals before it (int32, wrapping as the
    global sum does); unsharded axes cumsum locally. Then the
    dequantization multiply, elementwise. Bitwise ``sz_inverse``."""
    from ..compress.szlike import int32_cumsum
    plan = plan_blocks(tuple(r.shape), mesh, axis_name)
    lay = _Layout(plan, mesh)
    q = lay.split(r)
    by_dim = {a.dim: k for k, a in enumerate(plan.sharded)}
    for d in range(plan.ndim):
        q = {bid: int32_cumsum(x, d) for bid, x in q.items()}
        k = by_dim.get(d)
        if k is None:
            continue
        a = plan.sharded[k]
        nxt = {}
        for bid in lay.ids:
            if bid[k] == 0:
                continue
            prefix = None
            for j in range(bid[k]):
                src = bid[:k] + (j,) + bid[k + 1:]
                last = q[src].narrow(d, a.L - 1, 1).to(q[bid].device)
                prefix = last if prefix is None else prefix + last
            nxt[bid] = q[bid] + prefix
        q.update(nxt)
    out = {bid: x.to(dtype) * step.to(device=x.device, dtype=dtype)
           for bid, x in q.items()}
    return lay.assemble(out, r.device)


def sharded_scatter_edits(f_hat: torch.Tensor, idx: torch.Tensor,
                          val: torch.Tensor, mesh, *,
                          axis_name: Optional[str] = None) -> torch.Tensor:
    """g = f_hat + delta over the mesh: the edit stream is replicated;
    each block decomposes every global flat index into field
    coordinates, keeps exactly those inside its own block, and
    scatter-adds at the local offset. Out-of-block and out-of-range
    indices (a padded stream's one-past-the-end included) drop, never
    wrap. Bitwise the single-device scatter."""
    plan = plan_blocks(tuple(f_hat.shape), mesh, axis_name)
    lay = _Layout(plan, mesh)
    blocks = lay.split(f_hat)
    block = plan.block_shape()
    # mszlint: disable=transfer-discipline -- a host shape product
    size = int(np.prod(plan.shape, dtype=np.int64))
    out = {}
    for bid, x in blocks.items():
        flat = idx.reshape(-1).to(device=x.device, dtype=torch.int64)
        v = val.reshape(-1).to(device=x.device, dtype=x.dtype)
        keep = (flat >= 0) & (flat < size)
        rem, coords = flat, []
        for d in range(plan.ndim - 1, -1, -1):
            coords.append(rem % plan.shape[d])
            rem = rem // plan.shape[d]
        coords = coords[::-1]
        loc = torch.zeros_like(flat)
        for d, o in enumerate(lay.origin(bid)):
            c = coords[d] - o
            keep = keep & (c >= 0) & (c < block[d])
            loc = loc * block[d] + c
        y = x.reshape(-1).clone()
        y.index_add_(0, loc[keep], v[keep])
        out[bid] = y.reshape(block)
    return lay.assemble(out, f_hat.device)


# ---------------------------------------------------------------------------
# the registered backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedBackend:
    """Block-sharded execution over a mesh's data axes.

    ``mesh=None`` (the registry instance) takes the active mesh at call
    time; ``resolve_backend`` / ``fused_fix`` bind it into a concrete
    instance. ``axis_name=None`` reads the decomposition from the mesh's
    axis names (``data`` chains and ``data_*`` block meshes); a name
    forces the 1-axis layout. ``worklist`` and ``overlap`` as in
    ``sharded_fix``: neither changes a result."""
    name: str = "sharded"
    mesh: Optional[DeviceMesh] = None
    axis_name: Optional[str] = None
    worklist: Optional[bool] = None
    overlap: Optional[bool] = None

    def with_mesh(self, mesh) -> "ShardedBackend":
        """A copy of this backend bound to ``mesh``."""
        return dataclasses.replace(self, mesh=mesh)

    def bind(self) -> "ShardedBackend":
        """Freeze the mesh this instance runs on (an explicit mesh wins,
        else the active ``with mesh:`` one)."""
        if self.mesh is not None:
            return self
        m = active_data_mesh(self.axis_name)
        if m is None:
            raise ValueError(
                "sharded backend needs a mesh: pass mesh=..., or enter a "
                "`with mesh:` context whose mesh has a data axis (one of "
                f"{ALL_DATA_AXES})")
        return self.with_mesh(m)

    def n_data_devices(self) -> int:
        """Blocks across this instance's data axes (0 when no mesh is
        bound or active)."""
        mesh = self.mesh if self.mesh is not None \
            else active_data_mesh(self.axis_name)
        return data_axis_size(mesh, self.axis_name)

    def supports(self, shape, dtype) -> bool:
        """Non-empty 2D/3D float32/float64 fields, given >= 1 block."""
        return (len(shape) in (2, 3) and min(shape) >= 1
                and dtype in (torch.float32, torch.float64)
                and self.n_data_devices() >= 1)

    def fused_step(self, g: torch.Tensor, topo):
        """One iteration on the plain schedule (split -> exchange ->
        kernels -> assemble): (g_next, n_violations as a 0-d int32
        tensor on g's device). ``fix_loop`` is the production path."""
        be = self.bind()
        loop = _BlockLoop(g, topo, be.mesh, axis_name=be.axis_name,
                          overlap=False, worklist=False)
        g2, vecs = loop.step_plain()
        viol = loop.gather(vecs)
        return (loop.lay.assemble(g2, g.device),
                viol.sum().to(device=g.device, dtype=torch.int32))

    def fix_loop(self, g0: torch.Tensor, topo, max_iters: int = 512):
        """The whole fused loop on resident blocks: (g, iters,
        converged), bitwise the single-device loop."""
        be = self.bind()
        return sharded_fix(g0, topo, be.mesh, max_iters=max_iters,
                           axis_name=be.axis_name, worklist=be.worklist,
                           overlap=be.overlap)

    def transform(self, f: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        """Quantize + Lorenzo, the Lorenzo kernel on each block."""
        be = self.bind()
        return sharded_transform(f, step, be.mesh, axis_name=be.axis_name)

    def reconstruct(self, r: torch.Tensor, step: torch.Tensor,
                    dtype) -> torch.Tensor:
        """f_hat from residual codes: local cumsums plus the blocks'
        exclusive prefixes."""
        be = self.bind()
        return sharded_reconstruct(r, step, dtype, be.mesh,
                                   axis_name=be.axis_name)

    def scatter_edits(self, f_hat: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
        """The edit scatter, each block keeping its own edits."""
        be = self.bind()
        return sharded_scatter_edits(f_hat, idx, val, be.mesh,
                                     axis_name=be.axis_name)

    def halo_plan(self, shape, dtype) -> Dict[str, int]:
        """Per-mesh-axis halo bytes of one fix iteration under this
        backend's schedule flags."""
        be = self.bind()
        return halo_plan(shape, dtype, be.mesh, axis_name=be.axis_name,
                         overlap=be.overlap, worklist=be.worklist)

    def pack_codes(self, r: torch.Tensor):
        """The pack kernel on the global code array, on the mesh's first
        device; the stream is bitwise every other backend's."""
        from ..kernels.pack import pack_codes
        first = self.bind().mesh.devices.reshape(-1)[0]
        return pack_codes(r.to(first))

    def unpack_codes(self, words: torch.Tensor, bits: torch.Tensor,
                     shape) -> torch.Tensor:
        """Inverse of ``pack_codes`` on the mesh's first device."""
        from ..kernels.pack import unpack_codes
        first = self.bind().mesh.devices.reshape(-1)[0]
        return unpack_codes(words.to(first), bits.to(first), tuple(shape))


register_backend(ShardedBackend())
