"""Structured-grid PL topology primitives (Freudenthal triangulation),
the PyTorch port of ``repro.core.grid``.

Stencils (the tuples below are authoritative):

  * 2D: 6-neighborhood  (4 axis + the (+1,+1)/(-1,-1) diagonal)
  * 3D: 14-neighborhood (6 axis + 8 diagonal offsets along the main diagonal)

All comparisons use the Simulation-of-Simplicity total order
``(value, linear_index)``. Everything is dense shift-based torch ops on
tensors of any device; ``steepest_dirs`` walks the leading axis in
chunks of slabs (with a one-slab halo) so its stacked candidates stay a
bounded multiple of one chunk, not of the field.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# Freudenthal stencils. Offsets come in +/- pairs: code(2k+1) = -code(2k).
OFFSETS_2D: Tuple[Tuple[int, ...], ...] = (
    (0, 1), (0, -1),
    (1, 0), (-1, 0),
    (1, 1), (-1, -1),
)
OFFSETS_3D: Tuple[Tuple[int, ...], ...] = (
    (0, 0, 1), (0, 0, -1),
    (0, 1, 0), (0, -1, 0),
    (1, 0, 0), (-1, 0, 0),
    (0, 1, 1), (0, -1, -1),
    (1, 0, 1), (-1, 0, -1),
    (1, 1, 0), (-1, -1, 0),
    (1, 1, 1), (-1, -1, -1),
)

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1

#: elements per chunk of ``steepest_dirs`` (15 stacked candidates of a
#: 2^24-vertex chunk take ~2 GB in f32 values plus int32 indices)
CHUNK_ELEMS = 1 << 24


def offsets_for(ndim: int) -> Tuple[Tuple[int, ...], ...]:
    """The Freudenthal stencil offsets: 6 in 2D, 14 in 3D."""
    if ndim == 2:
        return OFFSETS_2D
    if ndim == 3:
        return OFFSETS_3D
    raise ValueError(f"MSz supports 2D/3D piecewise-linear fields, got ndim={ndim}")


def n_neighbors(ndim: int) -> int:
    """Stencil size: 6 in 2D, 14 in 3D."""
    return len(offsets_for(ndim))


def self_code(ndim: int) -> int:
    """Direction code meaning 'self' (the vertex is an extremum)."""
    return n_neighbors(ndim)


def shift(x: torch.Tensor, off: Sequence[int], fill) -> torch.Tensor:
    """y[v] = x[v + off], with ``fill`` outside the domain."""
    out = torch.full_like(x, fill)
    dst, src = [], []
    for o, s in zip(off, x.shape):
        n = max(s - abs(o), 0)
        dst.append(slice(max(0, -o), max(0, -o) + n))
        src.append(slice(max(0, o), max(0, o) + n))
    out[tuple(dst)] = x[tuple(src)]
    return out


def linear_index(shape: Sequence[int], device=None) -> torch.Tensor:
    """Row-major flat int32 vertex ids of a grid, shaped like the grid."""
    n = 1
    for s in shape:
        n *= int(s)
    return torch.arange(n, dtype=torch.int32, device=device).reshape(
        tuple(shape))


def _sos_argbest(vals: torch.Tensor, idxs: torch.Tensor, *,
                 ascending: bool) -> torch.Tensor:
    """Slot of the SoS-lexicographic best along dim 0 of stacked
    (values, linear indices): max (v, i) when ascending, min otherwise.
    Three reductions, as in the reference: best value, then the best
    index among value ties, then the first slot holding both."""
    if ascending:
        v_best = vals.amax(dim=0)
        i_fill = torch.full((), INT32_MIN, dtype=torch.int32,
                            device=idxs.device)
        i_best = torch.where(vals == v_best, idxs, i_fill).amax(dim=0)
    else:
        v_best = vals.amin(dim=0)
        i_fill = torch.full((), INT32_MAX, dtype=torch.int32,
                            device=idxs.device)
        i_best = torch.where(vals == v_best, idxs, i_fill).amin(dim=0)
    win = (vals == v_best) & (idxs == i_best)
    return torch.argmax(win.to(torch.uint8), dim=0).to(torch.int32)


def steepest_tile(f: torch.Tensor, lin: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(up_code, dn_code)`` of a field (or a tile of one) whose SoS
    keys are ``lin``: the stacked-candidate form of the reference's
    ``steepest_dirs``, with off-tile neighbors filled by -inf/-1
    (ascending) and +inf/INT32_MAX (descending)."""
    offs = offsets_for(f.ndim)
    sc = self_code(f.ndim)
    up_vals = torch.stack([f] + [shift(f, o, -torch.inf) for o in offs])
    up_idxs = torch.stack([lin] + [shift(lin, o, -1) for o in offs])
    slot_up = _sos_argbest(up_vals, up_idxs, ascending=True)
    del up_vals, up_idxs
    up_c = torch.where(slot_up == 0, sc, slot_up - 1).to(torch.int32)
    dn_vals = torch.stack([f] + [shift(f, o, torch.inf) for o in offs])
    dn_idxs = torch.stack([lin] + [shift(lin, o, INT32_MAX) for o in offs])
    slot_dn = _sos_argbest(dn_vals, dn_idxs, ascending=False)
    dn_c = torch.where(slot_dn == 0, sc, slot_dn - 1).to(torch.int32)
    return up_c, dn_c


def steepest_dirs(f: torch.Tensor, chunk: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 'update directions' + 'classify extrema' stencil.

    Returns ``(up_code, dn_code)`` int32 tensors of f's shape; code
    ``self_code(ndim)`` marks a maximum (minimum). ``chunk``: slabs of
    the leading axis per pass (default: as many as fit ``CHUNK_ELEMS``).
    Each pass reads its slabs plus a one-slab halo on each side and keeps
    its own slabs; their stencils lie inside the pass and their keys are
    global linear indices, so the result is the same for every chunk
    size.
    """
    n = f.shape[0]
    plane = max(f[0].numel(), 1) if n else 1
    if chunk is None:
        chunk = max(CHUNK_ELEMS // plane, 1)
    if chunk >= n:
        return steepest_tile(f, linear_index(f.shape, f.device))
    up = torch.empty(f.shape, dtype=torch.int32, device=f.device)
    dn = torch.empty_like(up)
    for z0 in range(0, n, chunk):
        z1 = min(z0 + chunk, n)
        a, b = max(z0 - 1, 0), min(z1 + 1, n)
        lin = (torch.arange(a * plane, b * plane, dtype=torch.int32,
                            device=f.device).reshape((b - a,) + f.shape[1:]))
        u, d = steepest_tile(f[a:b], lin)
        up[z0:z1] = u[z0 - a:z1 - a]
        dn[z0:z1] = d[z0 - a:z1 - a]
    return up, dn


def gather_dir(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """y[v] = x[v + offset(code[v])]; y[v] = x[v] where code==self."""
    out = x
    for k, off in enumerate(offsets_for(x.ndim)):
        # fill value irrelevant — a valid code never points off-domain.
        out = torch.where(code == k, shift(x, off, 0), out)
    return out


def dir_to_pointer(code: torch.Tensor) -> torch.Tensor:
    """Direction codes -> flattened next-vertex pointers (self at extrema)."""
    lin = linear_index(code.shape, code.device)
    return gather_dir(lin, code).reshape(-1)
