"""Stencil backends of the fused fix loop and the device base transform,
the PyTorch port of ``repro.core.backend``.

Every backend exposes

  * ``extrema_masks(g, topo)`` — 'update directions' + 'find false
    critical points' fused, as ``StencilMasks``;
  * ``fix_pass(g, topo, masks)`` — the pull-based edit application,
    ``(g_next, n_violations)``;
  * ``fused_step(g, topo)`` — the two composed into one iteration;
  * ``transform(f, step)`` / ``reconstruct(r, step, dtype)`` — quantize +
    integer Lorenzo and its inverse (``step`` a 0-d tensor of the field
    dtype);
  * ``scatter_edits(f_hat, idx, val)`` — g = f_hat + delta;
  * ``pack_codes(r)`` / ``unpack_codes(words, bits, shape)`` — the
    chunked-bitplane stream of ``entropy="device-pack"`` and its
    inverse (``repro_torch.kernels.pack``).

Registered implementations:

  * ``reference`` — plain torch ops, the port of the reference's dense
    stencils. It serves CPU tensors, and CUDA tensors only when a caller
    names it;
  * ``cuda`` — the hand-written kernels of ``repro_torch.kernels``
    behind ``extrema_masks``/``fix_pass``/``fused_step``/``transform``/
    ``pack_codes``/``unpack_codes`` (on a CPU tensor each kernel wrapper
    runs its plain version), with the dirty-slab worklist loop
    (``worklist_loop``) that ``fixes.fused_fix`` takes on fields of at
    least ``worklist_min_slabs`` slabs;
  * ``cuda_tiled`` (``z_tile=8``) and ``cuda_worklist`` (worklist always
    on, groups of 4 slabs) — the same kernels, configured to exercise
    slab tiles and the worklist's skips on small fields.

Both take ``reconstruct`` and ``scatter_edits`` from torch ops. The
``sharded`` backend (``repro_torch.distributed.shardfix``, imported when
first named) runs the same kernels on the blocks of a device mesh.
Backends are bitwise-interchangeable: same g trajectory, same violation
counts, same iteration count. ``resolve_backend("auto", ...)`` picks
``sharded`` when a mesh with >= 2 data-axis blocks is passed or active,
else ``cuda`` for a field on a CUDA device and ``reference`` for one on
the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..device import _d2h
from . import grid

__all__ = ["FalseMasks", "false_critical_masks", "trouble_masks",
           "StencilMasks", "ReferenceBackend", "CudaBackend",
           "register_backend", "available_backends", "get_backend",
           "resolve_backend", "_halve_toward_lower", "_pull"]

#: slab spans run by ``CudaBackend.worklist_loop`` so far (one extrema
#: and one fix-pass call each)
worklist_spans = 0


def _halve_toward_lower(g: torch.Tensor, lower: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """``kernels.fixpass.halve_toward_lower``, imported when called: a
    module-level import would close the cycle kernels -> core.grid ->
    core -> backend -> kernels, and a kernel module imported first would
    fail."""
    from ..kernels.fixpass import halve_toward_lower
    return halve_toward_lower(g, lower, mask)


class FalseMasks(NamedTuple):
    """The four false critical point classes plus g's direction codes."""
    fpmax: torch.Tensor
    fpmin: torch.Tensor
    fnmax: torch.Tensor
    fnmin: torch.Tensor
    up_c_g: torch.Tensor
    dn_c_g: torch.Tensor


def false_critical_masks(g: torch.Tensor, topo) -> FalseMasks:
    """Definitions 1-3 of the paper: false positive/negative maxima and
    minima of g against the original field's extrema."""
    up_c_g, dn_c_g = grid.steepest_dirs(g)
    sc = grid.self_code(g.ndim)
    is_max_g = up_c_g == sc
    is_min_g = dn_c_g == sc
    return FalseMasks(
        fpmax=is_max_g & ~topo.is_max,
        fpmin=is_min_g & ~topo.is_min,
        fnmax=~is_max_g & topo.is_max,
        fnmin=~is_min_g & topo.is_min,
        up_c_g=up_c_g,
        dn_c_g=dn_c_g,
    )


def trouble_masks(g_codes: FalseMasks, topo):
    """Local R-loop predicates: a non-max t whose g-ascending edge leaves
    t's original ascending region (demote that winner); symmetric on the
    descending side (promote the ORIGINAL descending neighbor)."""
    sc = grid.self_code(topo.M.ndim)
    nonmax_g = g_codes.up_c_g != sc
    nonmin_g = g_codes.dn_c_g != sc
    M_next = grid.gather_dir(topo.M, g_codes.up_c_g)
    m_next = grid.gather_dir(topo.m, g_codes.dn_c_g)
    return nonmax_g & (M_next != topo.M), nonmin_g & (m_next != topo.m)


def _pull(src_mask: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """pulled[j] = OR_k ( src_mask[j - off_k] & code[j - off_k] == k ):
    vertex j is an edit target iff a stencil neighbor i has src_mask[i]
    and i's direction code points at j."""
    out = torch.zeros(src_mask.shape, dtype=torch.bool,
                      device=src_mask.device)
    for k, off in enumerate(grid.offsets_for(src_mask.ndim)):
        noff = tuple(-o for o in off)
        m = grid.shift(src_mask, noff, False)
        c = grid.shift(code, noff, -1)
        out = out | (m & (c == k))
    return out


class StencilMasks(NamedTuple):
    """Outputs of one extrema/false-point classification pass;
    ``dn_c_f`` is the ORIGINAL field's descending codes."""
    up_c_g: torch.Tensor
    dn_c_g: torch.Tensor
    self_edit: torch.Tensor
    demote_src: torch.Tensor
    promote_src: torch.Tensor
    dn_c_f: torch.Tensor

    @property
    def n_violations(self) -> torch.Tensor:
        """Total fix sources as an int32 scalar tensor — 0 iff the fused
        loop has converged."""
        return (self.self_edit.sum() + self.demote_src.sum()
                + self.promote_src.sum()).to(torch.int32)


class _TorchTail:
    """The parts both backends take from torch ops."""

    def reconstruct(self, r: torch.Tensor, step: torch.Tensor,
                    dtype) -> torch.Tensor:
        """int32 residual codes -> f_hat in ``step``'s dtype."""
        from ..compress.szlike import sz_inverse
        return sz_inverse(r, step.to(dtype))

    def scatter_edits(self, f_hat: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
        """g = f_hat + delta by one scatter-add (out-of-range indices
        drop)."""
        from .driver import apply_edits_device
        return apply_edits_device(f_hat, idx, val)

    def supports(self, shape, dtype) -> bool:
        """Non-empty 2D/3D float32/float64 fields."""
        return (len(shape) in (2, 3) and min(shape) >= 1
                and dtype in (torch.float32, torch.float64))


@dataclasses.dataclass(frozen=True)
class ReferenceBackend(_TorchTail):
    """Dense plain-torch stencils (the port of the reference backend)."""
    name: str = "reference"

    def extrema_masks(self, g: torch.Tensor, topo) -> StencilMasks:
        """Classification pass: direction codes + the fused fix-source
        masks of one iteration."""
        fm = false_critical_masks(g, topo)
        t_max, t_min = trouble_masks(fm, topo)
        return StencilMasks(
            up_c_g=fm.up_c_g,
            dn_c_g=fm.dn_c_g,
            self_edit=fm.fpmax | fm.fnmin,
            demote_src=fm.fnmax | t_max,
            promote_src=fm.fpmin | t_min,
            dn_c_f=topo.dn_c,
        )

    def fix_pass(self, g: torch.Tensor, topo, masks: StencilMasks):
        """Conflict-free pull-based edit application:
        (g_next, n_violations)."""
        target = ((masks.self_edit != 0)
                  | _pull(masks.demote_src != 0, masks.up_c_g)
                  | _pull(masks.promote_src != 0, masks.dn_c_f))
        return _halve_toward_lower(g, topo.lower, target), masks.n_violations

    def fused_step(self, g: torch.Tensor, topo):
        """One fused fix iteration: (g_next, n_violations)."""
        return self.fix_pass(g, topo, self.extrema_masks(g, topo))

    def transform(self, f: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        """Quantize + integer Lorenzo -> int32 residual codes (the Lorenzo
        kernel's plain version)."""
        from ..kernels.lorenzo import geometry, lorenzo_quant_plain
        return lorenzo_quant_plain(f, step.to(f.dtype), geometry(f.shape))

    def pack_codes(self, r: torch.Tensor):
        """int32 residual codes -> ``(words, bits, n_words)`` (the pack
        kernel's plain version)."""
        from ..kernels.pack import pack_codes_plain
        return pack_codes_plain(r)

    def unpack_codes(self, words: torch.Tensor, bits: torch.Tensor,
                     shape) -> torch.Tensor:
        """Inverse of ``pack_codes`` (the unpack kernel's plain version)."""
        from ..kernels.pack import unpack_codes_plain
        return unpack_codes_plain(words, bits, tuple(shape))


@dataclasses.dataclass(frozen=True)
class CudaBackend(_TorchTail):
    """The hand-written CUDA kernels (``kernels.extrema``,
    ``kernels.fixpass``, ``kernels.lorenzo``, ``kernels.pack``).

    ``z_tile``: slabs per tile of ``fused_step`` (None: one launch of
    each kernel over the whole field; the kernels need no tiling on the
    card). Tiled and untiled steps are bitwise equal: each tile reads g
    with a 2-slab halo, the kernels compute in global coordinates, and
    only the tile's own slabs are kept.

    ``worklist`` / ``worklist_group`` / ``worklist_min_slabs``: the
    dirty-slab worklist loop. ``None`` engages it for solo fix loops on
    fields of at least ``worklist_min_slabs`` slabs; True/False force
    it. The slab axis is split into groups of ``worklist_group`` slabs,
    and each iteration re-runs the stencils only on groups within 2
    slabs of an edit target of the previous iteration — bitwise equal to
    the dense loop, because a slab's masks are a function of g on its
    2-slab neighbourhood.
    """
    name: str = "cuda"
    z_tile: Optional[int] = None
    worklist: Optional[bool] = None
    worklist_group: int = 8
    worklist_min_slabs: int = 64

    def extrema_masks(self, g: torch.Tensor, topo) -> StencilMasks:
        """Classification pass through the extrema kernel."""
        from ..kernels.extrema import extrema_masks
        up_c, dn_c, selfe, dem, pro = extrema_masks(
            g, topo.M, topo.m, topo.is_max, topo.is_min)
        return StencilMasks(up_c, dn_c, selfe, dem, pro, topo.dn_c)

    def fix_pass(self, g: torch.Tensor, topo, masks: StencilMasks):
        """Pull-based edit application through the fix kernel:
        (g_next, n_violations)."""
        from ..kernels.fixpass import fix_pass
        g2, viol, _ = fix_pass(g, topo.lower, masks.self_edit,
                               masks.demote_src, masks.promote_src,
                               masks.up_c_g, masks.dn_c_f)
        return g2, viol.sum().to(torch.int32)

    def fused_step(self, g: torch.Tensor, topo):
        """One fused fix iteration: (g_next, n_violations), in tiles of
        ``z_tile`` slabs when it is set."""
        if self.z_tile is not None and max(int(self.z_tile), 1) < g.shape[0]:
            return self._tiled_step(g, topo, max(int(self.z_tile), 1))
        return self.fix_pass(g, topo, self.extrema_masks(g, topo))

    def _span_step(self, g: torch.Tensor, topo,
                   spans: List[Tuple[int, int]]):
        """Both kernels on each slab span [z0, z1), all reading the
        pre-iteration g: extrema on [z0-2, z1+2) and the fix pass on
        [z0-1, z1+1), clipped to the field and placed in global
        coordinates. Returns (z0, z1, g', src, tgt) a span, each tensor
        the span's own slabs only (the fix kernel pulls nothing from
        outside its tile, so its first and last slab are dropped)."""
        from ..kernels.extrema import extrema_masks
        from ..kernels.fixpass import fix_pass
        n = g.shape[0]
        out = []
        for z0, z1 in spans:
            a, b = max(z0 - 2, 0), min(z1 + 2, n)
            c, d = max(z0 - 1, 0), min(z1 + 1, n)
            up_c, _, selfe, dem, pro = extrema_masks(
                g[a:b], topo.M[a:b], topo.m[a:b], topo.is_max[a:b],
                topo.is_min[a:b], slab_lo=a, n_slabs_total=n)
            ss = slice(c - a, d - a)
            g2, src, tgt = fix_pass(
                g[c:d], topo.lower[c:d], selfe[ss], dem[ss], pro[ss],
                up_c[ss], topo.dn_c[c:d], slab_lo=c, n_slabs_total=n)
            tp = slice(z0 - c, z1 - c)
            out.append((z0, z1, g2[tp], src[tp], tgt[tp]))
        return out

    def _tiled_step(self, g: torch.Tensor, topo, tile: int):
        """One iteration in tiles of ``tile`` slabs: (g_next,
        n_violations), bitwise the untiled step's."""
        n = g.shape[0]
        parts = self._span_step(
            g, topo, [(z0, min(z0 + tile, n)) for z0 in range(0, n, tile)])
        viol = torch.stack([p[3].sum() for p in parts]).sum()
        return (torch.cat([p[2] for p in parts], dim=0),
                viol.to(torch.int32))

    def use_worklist(self, shape) -> bool:
        """Whether a solo fix loop on ``shape`` runs through
        ``worklist_loop``: an explicit ``worklist`` wins (True needs at
        least 2 slabs); None engages it from ``worklist_min_slabs``
        slabs."""
        if len(shape) not in (2, 3):
            return False
        if self.worklist is not None:
            return bool(self.worklist) and shape[0] >= 2
        return shape[0] >= self.worklist_min_slabs

    def worklist_loop(self, g0: torch.Tensor, topo, *, max_iters: int):
        """The fused fix loop with per-slab-group early exit: returns
        (g, iters, converged, skipped_slabs), the first three bitwise
        the dense loop's.

        An iteration re-runs the stencils on a group of slabs iff a slab
        within 2 slabs of it had an edit target in the previous
        iteration (the first iteration runs every group). Consecutive
        running groups merge into one span, so each span is one extrema
        and one fix-pass launch, and an iteration where every group
        runs is exactly the dense step. Skipped groups keep their g and
        their stale (still exact) per-slab source counts, and count zero
        targets. Convergence tests the summed source counts, the dense
        loop's violation count. An iteration copies each span's slabs
        into g in place (after every span has read it) and makes one
        device->host copy, of the spans' per-slab source and target
        counts; the counts of every slab live on the host.
        ``skipped_slabs`` sums the slabs of skipped groups over
        iterations.
        """
        global worklist_spans
        n = g0.shape[0]
        wg = max(int(self.worklist_group), 1)
        groups = [(z0, min(z0 + wg, n)) for z0 in range(0, n, wg)]
        g = g0
        src = np.zeros(n, np.int64)     # per-slab fix sources, on the host
        dirty = np.ones(n, bool)        # sentinel: every group runs first
        it = skipped = 0
        while it == 0 or (src.sum() > 0 and it < max_iters):
            near = dirty.copy()
            for s in (1, 2):            # dilate by the 2-slab stencil radius
                near[:-s] |= dirty[s:]
                near[s:] |= dirty[:-s]
            spans: List[List[int]] = []
            for z0, z1 in groups:
                if not near[z0:z1].any():
                    skipped += z1 - z0
                elif spans and spans[-1][1] == z0:
                    spans[-1][1] = z1
                else:
                    spans.append([z0, z1])
            parts = self._span_step(g, topo, [tuple(sp) for sp in spans])
            worklist_spans += len(parts)
            if len(parts) == 1 and spans[0] == [0, n]:
                g = parts[0][2]
            else:
                if g is g0:
                    g = g0.clone()
                # in stream order after every span has read the
                # pre-iteration g (their halos may overlap)
                for z0, z1, gp, _, _ in parts:
                    g[z0:z1] = gp
            counts = (_d2h(torch.cat([t for p in parts for t in p[3:]]))
                      if parts else np.zeros(0, np.int32))
            dirty = np.zeros(n, bool)
            k = 0
            for z0, z1, _, _, _ in parts:
                m = z1 - z0
                src[z0:z1] = counts[k:k + m]
                dirty[z0:z1] = counts[k + m:k + 2 * m] > 0
                k += 2 * m
            it += 1
        return g, it, bool(src.sum() == 0), skipped

    def transform(self, f: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        """Quantize + integer Lorenzo through the Lorenzo kernel."""
        from ..kernels.lorenzo import lorenzo_quant
        return lorenzo_quant(f, step.to(f.dtype))

    def pack_codes(self, r: torch.Tensor):
        """int32 residual codes -> ``(words, bits, n_words)`` through the
        pack kernels."""
        from ..kernels.pack import pack_codes
        return pack_codes(r)

    def unpack_codes(self, words: torch.Tensor, bits: torch.Tensor,
                     shape) -> torch.Tensor:
        """Inverse of ``pack_codes`` through the unpack kernel."""
        from ..kernels.pack import unpack_codes
        return unpack_codes(words, bits, tuple(shape))


BackendLike = Union[str, ReferenceBackend, CudaBackend]

_REGISTRY: Dict[str, object] = {}

# backends of higher layers register themselves on import; naming one
# imports its module, so get_backend("sharded") works without the caller
# importing repro_torch.distributed first
_LAZY_MODULES: Dict[str, str] = {
    "sharded": "repro_torch.distributed.shardfix"}


def register_backend(backend, name=None) -> None:
    """Register a backend instance under ``name`` (default: its name)."""
    _REGISTRY[name or backend.name] = backend


def _ensure_lazy_backends() -> None:
    import importlib
    for name, module in _LAZY_MODULES.items():
        if name not in _REGISTRY:
            importlib.import_module(module)


def available_backends():
    """Sorted names of the registered backends (the lazy ones imported
    first, so the list is whole)."""
    _ensure_lazy_backends()
    return tuple(sorted(_REGISTRY))


def get_backend(spec: BackendLike):
    """Resolve a backend name or pass an instance through."""
    if isinstance(spec, str):
        if spec == "auto":
            raise ValueError(
                "'auto' needs the field's device — use resolve_backend()")
        if spec not in _REGISTRY and spec in _LAZY_MODULES:
            _ensure_lazy_backends()
        try:
            return _REGISTRY[spec]
        except KeyError:
            raise ValueError(f"unknown stencil backend {spec!r}; available: "
                             f"{available_backends()}") from None
    if not hasattr(spec, "fused_step"):
        raise TypeError(f"not a stencil backend: {spec!r}")
    return spec


def _auto_sharded(shape, dtype, mesh):
    """The ``sharded`` backend bound to ``mesh`` when it (or the active
    ``with mesh:`` one) has >= 2 data-axis blocks, else None."""
    be = get_backend("sharded")
    if mesh is not None:
        be = be.with_mesh(mesh)
    else:
        try:
            be = be.bind()
        except ValueError:
            return None
    if be.n_data_devices() < 2 or not be.supports(shape, dtype):
        return None
    return be


def resolve_backend(spec: BackendLike, shape, dtype: torch.dtype,
                    device: torch.device, mesh=None):
    """Like ``get_backend``, but 'auto' picks ``sharded`` when a mesh
    with >= 2 data-axis blocks is passed or active, else ``cuda`` for a
    field on a CUDA device and ``reference`` for one on the CPU. ``mesh``
    is bound into a mesh-less sharded backend. A named backend that does
    not support the shape or dtype raises (the sharded one without a
    mesh raises that it needs one)."""
    shape = tuple(shape)
    if isinstance(spec, str) and spec == "auto":
        be = _auto_sharded(shape, dtype, mesh)
        if be is not None:
            return be
        spec = "cuda" if torch.device(device).type == "cuda" else "reference"
    be = get_backend(spec)
    if mesh is not None and hasattr(be, "with_mesh") \
            and getattr(be, "mesh", None) is None:
        be = be.with_mesh(mesh)
    if not be.supports(shape, dtype):
        if hasattr(be, "bind"):
            be.bind()   # raises the 'needs a mesh' error when that is why
        raise ValueError(
            f"backend {be.name!r} does not support fields of shape {shape} "
            f"dtype {dtype}; use backend='auto' for automatic fallback")
    return be


register_backend(ReferenceBackend())
register_backend(CudaBackend())
# small fixed tile: exercises the span path of fused_step on modest fields
register_backend(CudaBackend(name="cuda_tiled", z_tile=8))
# worklist always on with small groups: exercises the dirty-slab loop
# (and its skips) on modest fields
register_backend(CudaBackend(name="cuda_worklist", worklist=True,
                             worklist_group=4))
