"""Steepest directions + fix-source masks: the CUDA kernel
``csrc/extrema.cu`` and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/extrema.py:_kernel`` (via
``extrema_masks_pallas``). Per vertex of ``g``: the SoS-steepest
ascending and descending neighbors over the Freudenthal stencil, the
original labels ``M_f``/``m_f`` gathered there, and five int32 outputs
``up_c``, ``dn_c`` (code K = self), ``self_edit = FPmax|FNmin``,
``demote = FNmax|trouble_max``, ``promote = FPmin|trouble_min``.

What bounds it on an H100: memory. The kernel reads g, two int32 label
arrays and two bool masks once and writes five int32 arrays, 34 B per
f32 vertex (1.362 ms at 512^3). It is a shared-memory stencil tile, as
the fix pass is: a block owns a (y, x) tile and marches over a run of
planes in z through a four-plane ring of g, M_f and m_f with a
one-vertex halo, so each plane is read from device memory once and the
14 (3D) or 6 (2D) neighbours and both winners' labels come from shared
memory. The SoS scans carry no linear index: inside the domain the
order of two candidates' indices is the lexicographic order of their
(dz, dy, dx) offsets, a constant of the stencil slot, so each scan
visits the slots in rank order and breaks ties by position; a cell off
the tile or the domain holds NaN, which loses every comparison of both
scans. Rows whose width is a multiple of 4 load 16 bytes a thread. See
the note at the head of ``csrc/extrema.cu``.

Off-domain neighbors: the kernel's NaN never wins, ``grid.steepest_dirs``
(and this module's plain version) fill them with -inf/-1 and
+inf/INT32_MAX, the Pallas kernel with -inf/+inf at index lin+offset.
No fill can win against a finite value, so the four agree for finite
fields. Neighbors outside the tile are skipped the same way: outputs on
a tile's first and last slab are for the caller to discard, as with the
reference's tiles.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.grid import INT32_MAX, _sos_argbest, shift
from . import _build
from .stencil import (Geometry, check_cuda_args, check_plane, geometry,
                      global_linear_index, neighbor_ok, offset_linear,
                      slab_chunks, slab_offsets, sub_geometry)

#: kernel launches so far (one per wrapper call on a CUDA tensor)
launches = 0

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def _tile_plain(g3, M3, m3, maxf3, minf3, geo: Geometry) -> Outputs:
    offs = slab_offsets(geo.ndim)
    K = len(offs)
    dev = g3.device
    lin = global_linear_index(geo, dev)
    oks = [neighbor_ok(geo, o, dev) for o in offs]
    neg = torch.full((), -torch.inf, dtype=g3.dtype, device=dev)
    pos = torch.full((), torch.inf, dtype=g3.dtype, device=dev)

    def codes(fill, i_fill, ascending):
        vals = torch.stack([g3] + [torch.where(ok, shift(g3, o, 0), fill)
                                   for o, ok in zip(offs, oks)])
        idxs = torch.stack([lin] + [
            torch.where(ok, lin + offset_linear(geo, o), i_fill)
            for o, ok in zip(offs, oks)])
        slot = _sos_argbest(vals, idxs, ascending=ascending)
        return torch.where(slot == 0, K, slot - 1).to(torch.int32)

    up_c = codes(neg, -1, True)
    dn_c = codes(pos, INT32_MAX, False)

    def gather(x, code):
        out = x
        for k, o in enumerate(offs):
            out = torch.where(code == k, shift(x, o, 0), out)
        return out

    is_max_g = up_c == K
    is_min_g = dn_c == K
    is_max_f = maxf3 != 0
    is_min_f = minf3 != 0
    t_max = ~is_max_g & (gather(M3, up_c) != M3)
    t_min = ~is_min_g & (gather(m3, dn_c) != m3)
    self_e = (is_max_g & ~is_max_f) | (~is_min_g & is_min_f)
    demote = (~is_max_g & is_max_f) | t_max
    promote = (is_min_g & ~is_min_f) | t_min
    return (up_c, dn_c, self_e.to(torch.int32), demote.to(torch.int32),
            promote.to(torch.int32))


def extrema_masks_plain(g, M_f, m_f, is_max_f, is_min_f, geo: Geometry,
                        chunk: Optional[int] = None) -> Outputs:
    """The plain PyTorch version: stacked candidates reduced by
    ``grid._sos_argbest``, in chunks of ``chunk`` slabs (default: about
    2^24 vertices) with a one-slab halo, so memory stays bounded."""
    ins = [x.reshape(geo.shape3) for x in (g, M_f, m_f, is_max_f, is_min_f)]
    outs = [torch.empty(geo.shape3, dtype=torch.int32, device=g.device)
            for _ in range(5)]
    for z0, z1, a, b in slab_chunks(geo, chunk, halo=1):
        part = _tile_plain(*[x[a:b] for x in ins], sub_geometry(geo, a, b))
        for o, p in zip(outs, part):
            o[z0:z1] = p[z0 - a:z1 - a]
    return tuple(o.reshape(g.shape) for o in outs)


def _entry(dtype):
    lib = _build.load("extrema")
    sym = "msz_extrema_f32" if dtype == torch.float32 else "msz_extrema_f64"
    return _build.entry(lib, sym, 10, 11, 0)


def extrema_masks(g: torch.Tensor, M_f: torch.Tensor, m_f: torch.Tensor,
                  is_max_f: torch.Tensor, is_min_f: torch.Tensor, *,
                  slab_lo: int = 0, n_slabs_total: Optional[int] = None,
                  row_lo: int = 0, col_lo: int = 0,
                  n_rows_total: Optional[int] = None,
                  n_cols_total: Optional[int] = None) -> Outputs:
    """g: (Z,Y,X) or (Y,X) float32/float64; M_f/m_f int32 labels of the
    original field; is_max_f/is_min_f bool (or int32 0/1, as the Pallas
    kernel takes them, converted here). Returns (up_c, dn_c,
    self_edit, demote_src, promote_src), int32 of g's shape. The tile
    arguments are those of ``extrema_masks_pallas``."""
    global launches
    geo = geometry(tuple(g.shape), slab_lo, row_lo, col_lo, n_slabs_total,
                   n_rows_total, n_cols_total)
    if g.device.type == "cpu":
        return extrema_masks_plain(g, M_f, m_f, is_max_f, is_min_f, geo)
    if g.device.type != "cuda":
        raise ValueError(f"extrema_masks: unsupported device {g.device}")
    if g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"extrema_masks: float32/float64 field, got {g.dtype}")
    check_plane("extrema_masks", geo)
    i32 = torch.int32
    if is_max_f.dtype != torch.bool:
        is_max_f, is_min_f = is_max_f != 0, is_min_f != 0
    dev = check_cuda_args("extrema_masks", [g, M_f, m_f, is_max_f, is_min_f],
                          [g.dtype, i32, i32, torch.bool, torch.bool],
                          g.shape)
    outs = [torch.empty(g.shape, dtype=i32, device=dev) for _ in range(5)]
    fn = _entry(g.dtype)
    ptrs = [t.data_ptr() for t in (g, M_f, m_f, is_max_f, is_min_f, *outs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(*ptrs, geo.ndim, *geo.c_ints(), dev.index, stream),
                     "extrema")
    launches += 1
    return tuple(outs)
