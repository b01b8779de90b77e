"""The fused fix loop, the PyTorch port of ``repro.core.fixes`` (fused
mode).

All six fix conditions are local stencil predicates applied at once in
one dense pass per iteration (the stencil backend's ``fused_step``);
edits only decrease, so the loop converges (paper Lemma 1). The schedule
is the reference's ``_fused_fix_impl``: the first step runs outside the
loop and the count starts at 1; the loop runs while violations remain
and fewer than ``max_iters`` steps were taken; converged means the last
step saw no violation. The convergence test is a host sync per
iteration.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import grid
from .backend import BackendLike, get_backend, resolve_backend
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
    xi_t = torch.tensor(xi, dtype=f.dtype, device=f.device)
    return FieldTopo(up_c, dn_c, up_c == sc, dn_c == sc, M, m, f - xi_t)


def fused_pass(g: torch.Tensor, topo: FieldTopo,
               backend: BackendLike = "reference"):
    """One iteration of the fused loop: (g_next, n_violations)."""
    return get_backend(backend).fused_step(g, topo)


def fused_fix(g0: torch.Tensor, topo: FieldTopo, max_iters: int = 512,
              backend: BackendLike = "auto"
              ) -> Tuple[torch.Tensor, int, bool]:
    """Run the fused loop to convergence. Returns (g, iters, converged).
    ``backend`` picks the stencil execution ('auto': ``cuda`` on a CUDA
    tensor, ``reference`` on a CPU one); every backend gives the same
    trajectory bit for bit."""
    be = resolve_backend(backend, g0.shape, g0.dtype, g0.device)
    g, viol = be.fused_step(g0, topo)
    n_viol = int(viol)
    iters = 1
    while n_viol > 0 and iters < max_iters:
        g, viol = be.fused_step(g, topo)
        n_viol = int(viol)
        iters += 1
    return g, iters, n_viol == 0
