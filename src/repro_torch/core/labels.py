"""Morse-Smale segmentation labels via pointer jumping, the PyTorch port
of ``repro.core.labels``.

Every vertex stores the next vertex of its ascending (descending)
integral line; ``nxt <- nxt[nxt]`` halves every path per sweep, so the
labels converge in O(log(longest integral line)) gathers. The loop is a
Python loop with the reference's bound and early exit: it stops at the
first sweep that changes nothing (one read through the ``device._d2h``
seam a sweep).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import _d2h
from . import grid


def default_pointer_iters(n_vertices: int) -> int:
    """Doubling sweeps sufficient for any pointer chain over
    ``n_vertices`` (ceil(log2 V), plus one sweep that observes the fixed
    point), as in the reference."""
    return max(math.ceil(math.log2(max(int(n_vertices), 2))), 1) + 1


def pointer_jump(nxt: torch.Tensor,
                 max_iters: Optional[int] = None) -> torch.Tensor:
    """Resolve int32 next-pointers ``[V]`` (extrema point at themselves)
    to root labels by pointer doubling. ``max_iters=None`` uses
    ``default_pointer_iters``; a smaller explicit bound exits there with
    unresolved labels, as the reference does."""
    if max_iters is None:
        max_iters = default_pointer_iters(nxt.numel())
    cur = nxt
    it = 0
    while it < max_iters:
        nn = cur[cur]
        if bool(_d2h((nn == cur).all())):
            break
        cur = nn
        it += 1
    return cur


def labels_from_codes(up_c: torch.Tensor, dn_c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, m) labels from ascending/descending direction codes."""
    M = pointer_jump(grid.dir_to_pointer(up_c)).reshape(up_c.shape)
    m = pointer_jump(grid.dir_to_pointer(dn_c)).reshape(dn_c.shape)
    return M, m


def mss_labels(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max label M, min label m) per vertex — the full PLMSS of ``f``:
    linear indices of the maximum (minimum) each integral line reaches."""
    up_c, dn_c = grid.steepest_dirs(f)
    return labels_from_codes(up_c, dn_c)


def segmentation_accuracy(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """'Right labeled ratio' (paper Eq. 9): the float32 fraction of
    vertices whose <min,max> label pair matches between f and g."""
    Mf, mf = mss_labels(f)
    Mg, mg = mss_labels(g)
    return _mean_f32((Mf == Mg) & (mf == mg))


def _mean_f32(mask: torch.Tensor) -> torch.Tensor:
    """float32 mean of a bool mask as the reference's ``jnp.mean``
    computes it on XLA: the float32 sum times the float32 reciprocal of
    the count (XLA rewrites the division by a constant that way; torch's
    ``mean`` rounds differently)."""
    recip = np.float32(1.0) / np.float32(mask.numel())
    return mask.to(torch.float32).sum() * float(recip)
