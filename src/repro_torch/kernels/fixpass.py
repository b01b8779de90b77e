"""Pull-based edit pass: the CUDA kernel ``csrc/fixpass.cu`` and its
plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/fixpass.py:_kernel`` (via
``fix_pass_pallas``). Vertex j is an edit target iff ``self_edit[j]``,
or a stencil source i = j - off_k inside the tile and the global domain
has ``demote_src[i]`` and ``up_code_g[i] == k``, or ``promote_src[i]``
and ``dn_code_f[i] == k`` (the ORIGINAL field's descending codes).
Targets become ``(g + lower) * 0.5``, raised to ``lower`` where that is
below it. Also returns per-slab counts of fix sources (``viol``, which
drives convergence) and of edit targets (``tgt``).

What bounds it on an H100: memory — g, lower and five int32 arrays read
once, g' written once, 32 B per f32 vertex (1.282 ms at 512^3). The
kernel is a shared-memory stencil tile: a block owns a (y, x) tile and
marches over a run of planes in z, packing each vertex's demote and
promote pulls into one byte of a four-plane ring with a one-vertex
halo, so every plane of sources is read from device memory once and the
14 (3D) or 6 (2D) pull tests read shared memory with no branch. Rows
whose width is a multiple of 4 load 16 bytes a thread. The per-slab
counts are a warp reduction plus one integer atomicAdd per (block,
plane): order-free and deterministic, with no second pass. See the note
at the head of ``csrc/fixpass.cu`` for the numbers on the card.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..core.grid import shift
from . import _build
from .stencil import (Geometry, check_cuda_args, check_plane, geometry,
                      neighbor_ok, slab_chunks, slab_offsets, sub_geometry)

#: kernel launches so far (one per wrapper call on a CUDA tensor)
launches = 0


def halve_toward_lower(g: torch.Tensor, lower: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """The decreasing edit (g + lower) * 0.5, raised to ``lower``, where
    ``mask``; g elsewhere."""
    new = (g + lower) * 0.5
    new = torch.where(new < lower, lower, new)
    return torch.where(mask, new, g)


def _tile_plain(g3, low3, se3, dem3, pro3, upg3, dnf3, geo: Geometry):
    offs = slab_offsets(geo.ndim)
    target = se3 != 0
    dem_b = dem3 != 0
    pro_b = pro3 != 0
    for k, o in enumerate(offs):
        src = tuple(-c for c in o)
        ok = neighbor_ok(geo, src, g3.device)
        pull = ((shift(dem_b, src, False) & (shift(upg3, src, -1) == k))
                | (shift(pro_b, src, False) & (shift(dnf3, src, -1) == k)))
        target = target | (ok & pull)
    g2 = halve_toward_lower(g3, low3, target)
    viol = (se3.sum(dim=(1, 2)) + dem3.sum(dim=(1, 2))
            + pro3.sum(dim=(1, 2))).to(torch.int32)
    tgt = target.sum(dim=(1, 2)).to(torch.int32)
    return g2, viol, tgt


def fix_pass_plain(g, lower, self_edit, demote_src, promote_src, up_code_g,
                   dn_code_f, geo: Geometry, chunk: Optional[int] = None):
    """The plain PyTorch version, in chunks of ``chunk`` slabs (default:
    about 2^24 vertices) with a one-slab halo."""
    ins = [x.reshape(geo.shape3) for x in
           (g, lower, self_edit, demote_src, promote_src, up_code_g,
            dn_code_f)]
    g2 = torch.empty_like(ins[0])
    viol = torch.empty(geo.nz, dtype=torch.int32, device=g.device)
    tgt = torch.empty_like(viol)
    for z0, z1, a, b in slab_chunks(geo, chunk, halo=1):
        pg, pv, pt = _tile_plain(*[x[a:b] for x in ins],
                                 sub_geometry(geo, a, b))
        g2[z0:z1] = pg[z0 - a:z1 - a]
        viol[z0:z1] = pv[z0 - a:z1 - a]
        tgt[z0:z1] = pt[z0 - a:z1 - a]
    return g2.reshape(g.shape), viol, tgt


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    lib = _build.load("fixpass")
    sym = "msz_fixpass_f32" if dtype == torch.float32 else "msz_fixpass_f64"
    return _build.entry(lib, sym, 10, 11, 0)


def fix_pass(g: torch.Tensor, lower: torch.Tensor, self_edit: torch.Tensor,
             demote_src: torch.Tensor, promote_src: torch.Tensor,
             up_code_g: torch.Tensor, dn_code_f: torch.Tensor, *,
             slab_lo: int = 0, n_slabs_total: Optional[int] = None,
             row_lo: int = 0, col_lo: int = 0,
             n_rows_total: Optional[int] = None,
             n_cols_total: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused fix pass. g/lower float32/float64 of one shape, masks and
    codes int32. Returns (g_next, viol, tgt): viol/tgt are (n_slabs,)
    int32 per-slab fix-source and edit-target counts. The tile arguments
    are those of ``fix_pass_pallas``."""
    global launches
    geo = geometry(tuple(g.shape), slab_lo, row_lo, col_lo, n_slabs_total,
                   n_rows_total, n_cols_total)
    args = (g, lower, self_edit, demote_src, promote_src, up_code_g,
            dn_code_f)
    if g.device.type == "cpu":
        return fix_pass_plain(*args, geo)
    if g.device.type != "cuda":
        raise ValueError(f"fix_pass: unsupported device {g.device}")
    if g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fix_pass: float32/float64 field, got {g.dtype}")
    check_plane("fix_pass", geo)
    i32 = torch.int32
    dev = check_cuda_args("fix_pass", list(args),
                          [g.dtype, g.dtype] + [i32] * 5, g.shape)
    g2 = torch.empty_like(g)
    viol = torch.zeros(geo.nz, dtype=i32, device=dev)
    tgt = torch.zeros(geo.nz, dtype=i32, device=dev)
    fn = _entry(g.dtype)
    ptrs = [t.data_ptr() for t in (*args, g2, viol, tgt)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(*ptrs, geo.ndim, *geo.c_ints(), dev.index, stream),
                     "fix_pass")
    launches += 1
    return g2, viol, tgt
