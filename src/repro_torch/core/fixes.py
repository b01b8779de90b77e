"""The fix loops, the PyTorch port of ``repro.core.fixes``: fused mode
and the paper's mode.

All six fix conditions are local stencil predicates applied at once in
one dense pass per iteration (the stencil backend's ``fused_step``);
edits only decrease, so the loop converges (paper Lemma 1). The schedule
is the reference's ``_fused_fix_impl``: the first step runs outside the
loop and the count starts at 1; the loop runs while violations remain
and fewer than ``max_iters`` steps were taken; converged means the last
step saw no violation. The convergence test is a host sync per
iteration. A backend with a dirty-slab worklist (``cuda``) runs the
loop through it where its policy says so (``use_worklist``), bitwise
equal; a backend with a whole-loop driver (``fix_loop``: the sharded
backend over a device mesh, ``mesh=``) runs the loop there.
``fused_fix_batch`` runs many members, each bitwise its solo loop.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import _d2h, _h2d
from . import grid
from .backend import (BackendLike, _halve_toward_lower, _pull,
                      false_critical_masks, get_backend, resolve_backend,
                      trouble_masks)
from .labels import labels_from_codes


class FieldTopo(NamedTuple):
    """Static per-field topology of the ORIGINAL data (computed once)."""
    up_c: torch.Tensor      # steepest ascending dir codes of f
    dn_c: torch.Tensor      # steepest descending dir codes of f
    is_max: torch.Tensor    # bool
    is_min: torch.Tensor    # bool
    M: torch.Tensor         # ascending (max) labels of f, int32, f.shape
    m: torch.Tensor         # descending (min) labels of f
    lower: torch.Tensor     # f - xi  (edit lower bound, Eq. 1)


def field_topology(f: torch.Tensor, xi: float) -> FieldTopo:
    """Everything the fix loop needs from the ORIGINAL field: direction
    codes, extremum masks, MSS labels and the lower bound f - xi (xi
    rounded to f's dtype first, as the reference does)."""
    up_c, dn_c = grid.steepest_dirs(f)
    M, m = labels_from_codes(up_c, dn_c)
    sc = grid.self_code(f.ndim)
    np_dtype = np.float64 if f.dtype == torch.float64 else np.float32
    xi_t = _h2d(np.asarray(xi, np_dtype), f.device)
    return FieldTopo(up_c, dn_c, up_c == sc, dn_c == sc, M, m, f - xi_t)


def fused_pass(g: torch.Tensor, topo: FieldTopo,
               backend: BackendLike = "reference"):
    """One iteration of the fused loop: (g_next, n_violations)."""
    return get_backend(backend).fused_step(g, topo)


def _bind(be):
    """Freeze call-time context (the active mesh, for the sharded
    backend) into the instance."""
    return be.bind() if hasattr(be, "bind") else be


def fused_fix(g0: torch.Tensor, topo: FieldTopo, max_iters: int = 512,
              backend: BackendLike = "auto", mesh=None
              ) -> Tuple[torch.Tensor, int, bool]:
    """Run the fused loop to convergence. Returns (g, iters, converged).
    ``backend`` picks the stencil execution ('auto': ``sharded`` under a
    mesh of >= 2 data-axis blocks, else ``cuda`` on a CUDA tensor and
    ``reference`` on a CPU one); ``mesh`` routes the loop through the
    sharded backend. Every backend gives the same trajectory bit for
    bit."""
    be = _bind(resolve_backend(backend, g0.shape, g0.dtype, g0.device,
                               mesh=mesh))
    if hasattr(be, "fix_loop"):
        # the sharded loop: blocks resident for the whole loop
        return be.fix_loop(g0, topo, max_iters=max_iters)
    if hasattr(be, "worklist_loop") and be.use_worklist(g0.shape):
        g, iters, ok, _ = be.worklist_loop(g0, topo, max_iters=max_iters)
        return g, iters, ok
    g, viol = be.fused_step(g0, topo)
    n_viol = int(_d2h(viol))
    iters = 1
    while n_viol > 0 and iters < max_iters:
        g, viol = be.fused_step(g, topo)
        n_viol = int(_d2h(viol))
        iters += 1
    return g, iters, n_viol == 0


def fused_fix_worklist(g0: torch.Tensor, topo: FieldTopo,
                       max_iters: int = 512,
                       backend: BackendLike = "cuda_worklist", mesh=None
                       ) -> Tuple[torch.Tensor, int, bool, int]:
    """Run the fused loop through a backend's dirty-slab worklist,
    whatever its engage threshold. Returns (g, iters, converged,
    skipped_slabs), the first three bitwise ``fused_fix``'s;
    ``skipped_slabs`` counts the slabs of skipped groups summed over
    iterations. ``mesh`` binds into a sharded backend, which has no
    slab worklist and raises, as in the reference."""
    be = _bind(resolve_backend(backend, g0.shape, g0.dtype, g0.device,
                               mesh=mesh))
    if not hasattr(be, "worklist_loop"):
        raise ValueError(
            f"backend {be.name!r} has no dirty-slab worklist driver; "
            "use the cuda backend family")
    return be.worklist_loop(g0, topo, max_iters=max_iters)


def _member(topo: FieldTopo, i: int) -> FieldTopo:
    return FieldTopo(*(x[i] for x in topo))


def fused_fix_batch(g0: torch.Tensor, topo: FieldTopo, max_iters: int = 512,
                    backend: BackendLike = "auto", mesh=None,
                    batching: str = "auto", compact_every: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused loop over a leading batch axis (timestep series,
    ensemble members). ``g0``: (B, *spatial); every FieldTopo leaf has
    the same leading axis. Returns (g (B, *spatial), iters (B,) int32,
    converged (B,) bool), each member bitwise its solo ``fused_fix``
    (dense schedule).

    Every member takes the first step; after that only members whose
    last step saw violations step again, each through the backend's
    ``fused_step``, and one device->host copy of their stacked
    violation counts an iteration decides who goes on. A member stops
    the iteration its count is 0; at ``max_iters`` the rest report
    ``converged=False``.

    ``batching`` ("auto", "compact" or "fused") and ``compact_every``
    (>= 1) are checked as the reference checks them. The reference
    chooses between freezing converged members inside one vmapped loop
    and compacting the active ones into smaller buckets; here no member
    occupies a lane, so every choice runs the same member loop, which
    already steps only the active members.

    With a sharded backend (``mesh`` with >= 2 data-axis blocks, or
    ``backend="sharded"``) the members run one after another through
    the mesh's loop, each bitwise its solo run; ``batching`` is checked
    and otherwise ignored, as in the reference.
    """
    if batching not in ("auto", "compact", "fused"):
        raise ValueError(
            'batching must be "auto", "compact", or "fused"; '
            f"got {batching!r}")
    if compact_every < 1:
        raise ValueError(f"compact_every must be >= 1, got {compact_every}")
    be = _bind(resolve_backend(backend, g0.shape[1:], g0.dtype, g0.device,
                               mesh=mesh))
    dev = g0.device
    B = g0.shape[0]
    if hasattr(be, "fix_loop"):
        outs = [be.fix_loop(g0[i], _member(topo, i), max_iters=max_iters)
                for i in range(B)]
        return (torch.stack([g for g, _, _ in outs]) if outs else g0.clone(),
                _h2d(np.asarray([it for _, it, _ in outs], np.int32), dev),
                _h2d(np.asarray([ok for _, _, ok in outs], bool), dev))
    gs = list(g0.unbind(0))
    topos = [_member(topo, i) for i in range(B)]
    iters = np.zeros(B, np.int32)
    viol = np.ones(B, np.int64)         # 1-sentinel: everyone steps once
    active = np.arange(B)
    it = 0
    while active.size and it < max_iters:
        counts = []
        for i in active:
            gs[i], v = be.fused_step(gs[i], topos[i])
            counts.append(v.reshape(1))
        viol_a = _d2h(torch.cat(counts))
        # mszlint: disable=scatter-discipline -- active is unique
        iters[active] += 1
        viol[active] = viol_a
        active = active[viol_a > 0]
        it += 1
    g = torch.stack(gs) if gs else g0.clone()
    return g, _h2d(iters, dev), _h2d(viol == 0, dev)


# ---------------------------------------------------------------------------
# paper mode: sequential sub-loops, label recomputation in R-passes
# ---------------------------------------------------------------------------

_CLASSES = ("fpmax", "fpmin", "fnmax", "fnmin")


def _count(mask: torch.Tensor) -> int:
    """The host count of a mask (one read through the seam)."""
    return int(_d2h(mask.sum()))


def _n_false(fm) -> int:
    """False critical points of all four classes (one read)."""
    return int(_d2h(fm.fpmax.sum() + fm.fpmin.sum() + fm.fnmax.sum()
                    + fm.fnmin.sum()))


def _subloop(g: torch.Tensor, topo: FieldTopo, which: str,
             max_iters: int) -> Tuple[torch.Tensor, int]:
    """Run one false-critical-point class to its fixpoint (Section 5.1).
    Returns (g, steps). The reference computes the masks of the new g at
    the end of a step and again at the start of the next; here they are
    computed once and carried."""
    def target_of(fm):
        if which == "fpmax":      # Eq. 2: decrease the vertex itself
            return fm.fpmax
        if which == "fnmin":      # Eq. 5: decrease the vertex itself
            return fm.fnmin
        if which == "fpmin":
            # DEVIATION from Eq. 3 as printed ("decrease the maximal
            # neighbor"): that target can pin at its lower bound while
            # still above g_i (e.g. neighbors j: f_j >> f_i and k:
            # f_k < f_i — the fix never touches k), deadlocking the
            # sub-loop. We decrease the ORIGINAL steepest-descending
            # neighbor dir_dn_f(i) instead: f_c - xi < f_i - xi <= g_i
            # guarantees it eventually undercuts g_i. See DESIGN.md §2.
            return _pull(fm.fpmin, topo.dn_c)
        if which == "fnmax":      # Eq. 4: decrease i's maximal (g) neighbor
            return _pull(fm.fnmax, fm.up_c_g)
        raise ValueError(which)

    fm = false_critical_masks(g, topo)
    n = _count(getattr(fm, which))
    it = 0
    while n > 0 and it < max_iters:
        g = _halve_toward_lower(g, topo.lower, target_of(fm))
        fm = false_critical_masks(g, topo)
        n = _count(getattr(fm, which))
        it += 1
    return g, it


def _c_loop(g: torch.Tensor, topo: FieldTopo, max_iters: int
            ) -> torch.Tensor:
    """One C-loop: the four sub-loops in the paper's order, repeated
    until no false critical point remains."""
    n = _n_false(false_critical_masks(g, topo))
    it = 0
    while n > 0 and it < max_iters:
        for which in _CLASSES:
            g, _ = _subloop(g, topo, which, max_iters)
        n = _n_false(false_critical_masks(g, topo))
        it += 1
    return g


def _r_pass(g: torch.Tensor, topo: FieldTopo
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One R-pass (Section 5.2): recompute the MSS labels of g, find the
    falsely labeled regular points, locate their troublemakers and
    reroute each with one edit. Returns (g', falsely labeled count as a
    device scalar)."""
    fm = false_critical_masks(g, topo)
    Mg, mg = labels_from_codes(fm.up_c_g, fm.dn_c_g)
    wrong_max_lab = Mg != topo.M
    wrong_min_lab = mg != topo.m
    t_max, t_min = trouble_masks(fm, topo)
    # paper: troublemaker = FIRST discrepancy along a falsely-labeled
    # vertex's integral line == locally-diverging AND itself falsely
    # labeled.
    t_max = t_max & wrong_max_lab
    t_min = t_min & wrong_min_lab
    target = _pull(t_max, fm.up_c_g) | _pull(t_min, topo.dn_c)
    g2 = _halve_toward_lower(g, topo.lower, target)
    return g2, wrong_max_lab.sum() + wrong_min_lab.sum()


def paper_fix(g0: torch.Tensor, topo: FieldTopo, max_iters: int = 512
              ) -> Tuple[torch.Tensor, int, bool]:
    """Alternate C- and R-loops until no false critical or falsely
    labeled point remains (Section 5.3). Returns (g, outer_iters,
    converged), bitwise the reference's."""
    g, it, n = g0, 0, 1
    while n > 0 and it < max_iters:
        g = _c_loop(g, topo, max_iters)
        g, n_wrong = _r_pass(g, topo)
        fm = false_critical_masks(g, topo)
        n = int(_d2h(n_wrong + fm.fpmax.sum() + fm.fpmin.sum()
                     + fm.fnmax.sum() + fm.fnmin.sum()))
        it += 1
    return g, it, n == 0
