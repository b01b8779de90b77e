"""Geometry shared by the three stencil kernels' wrappers and plain
versions.

A field is walked as (nz, ny, nx): a 3D field (Z, Y, X) as it is, a 2D
field (Y, X) as (Y, 1, X) with its stencil offsets (dy, dx) mapped to
(dy, 0, dx), as the reference's slab kernels see it. A tensor may be a
tile of a larger field: the origin places it and the totals give the
global extents; SoS linear indices and domain edges are global.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.grid import CHUNK_ELEMS, OFFSETS_2D, OFFSETS_3D


class Geometry(NamedTuple):
    """Local extents, tile origin and global extents of a (nz, ny, nx)
    walk of a 2D or 3D field."""
    ndim: int
    nz: int
    ny: int
    nx: int
    z0: int
    y0: int
    x0: int
    N: int
    NY: int
    NX: int

    @property
    def shape3(self) -> Tuple[int, int, int]:
        """The (nz, ny, nx) view shape."""
        return (self.nz, self.ny, self.nx)

    def c_ints(self) -> Tuple[int, ...]:
        """The nine ints a C entry point takes after ``ndim``."""
        return (self.nz, self.ny, self.nx, self.z0, self.y0, self.x0,
                self.N, self.NY, self.NX)


def slab_offsets(ndim: int) -> Tuple[Tuple[int, int, int], ...]:
    """Freudenthal offsets as (dz, dy, dx) triples of the (nz, ny, nx)
    walk (2D offsets (dy, dx) become (dy, 0, dx))."""
    if ndim == 3:
        return tuple(OFFSETS_3D)
    if ndim == 2:
        return tuple((dy, 0, dx) for (dy, dx) in OFFSETS_2D)
    raise ValueError(f"stencil kernels support 2D/3D fields, got ndim={ndim}")


def geometry(shape, slab_lo: int = 0, row_lo: int = 0, col_lo: int = 0,
             n_slabs_total: Optional[int] = None,
             n_rows_total: Optional[int] = None,
             n_cols_total: Optional[int] = None) -> Geometry:
    """The walk of a tile of ``shape`` placed at (slab_lo, row_lo,
    col_lo); a missing total means the tile is flush with the domain end.
    2D fields use the col pair for their second axis; the row pair is
    unused there, as in the reference."""
    if len(shape) == 3:
        nz, ny, nx = shape
    elif len(shape) == 2:
        (nz, nx), ny, row_lo, n_rows_total = shape, 1, 0, None
    else:
        raise ValueError(f"stencil kernels support 2D/3D, got shape {shape}")
    N = slab_lo + nz if n_slabs_total is None else n_slabs_total
    NY = row_lo + ny if n_rows_total is None else n_rows_total
    NX = col_lo + nx if n_cols_total is None else n_cols_total
    return Geometry(len(shape), nz, ny, nx, slab_lo, row_lo, col_lo,
                    N, NY, NX)


def _axis_ok(n: int, lo: int, total: int, d: int, device) -> torch.Tensor:
    loc = torch.arange(n, device=device) + d
    glo = loc + lo
    return (loc >= 0) & (loc < n) & (glo >= 0) & (glo < total)


def neighbor_ok(geo: Geometry, off, device) -> torch.Tensor:
    """Bool (nz, ny, nx): whether v + off lies inside the tile and the
    global domain."""
    dz, dy, dx = off
    vz = _axis_ok(geo.nz, geo.z0, geo.N, dz, device)
    vy = _axis_ok(geo.ny, geo.y0, geo.NY, dy, device)
    vx = _axis_ok(geo.nx, geo.x0, geo.NX, dx, device)
    return vz[:, None, None] & vy[None, :, None] & vx[None, None, :]


def global_linear_index(geo: Geometry, device) -> torch.Tensor:
    """int32 (nz, ny, nx) global row-major vertex ids of the tile."""
    z = torch.arange(geo.nz, dtype=torch.int64, device=device) + geo.z0
    y = torch.arange(geo.ny, dtype=torch.int64, device=device) + geo.y0
    x = torch.arange(geo.nx, dtype=torch.int64, device=device) + geo.x0
    lin = ((z[:, None, None] * geo.NY + y[None, :, None]) * geo.NX
           + x[None, None, :])
    return lin.to(torch.int32)


def offset_linear(geo: Geometry, off) -> int:
    """Global linear-index delta of a (dz, dy, dx) offset."""
    dz, dy, dx = off
    return (dz * geo.NY + dy) * geo.NX + dx


def sub_geometry(geo: Geometry, a: int, b: int) -> Geometry:
    """The geometry of slabs [a, b) of a tile."""
    return geo._replace(nz=b - a, z0=geo.z0 + a)


def slab_chunks(geo: Geometry, chunk: Optional[int], halo: int):
    """Yield (z0, z1, a, b): slabs [z0, z1) of the tile are computed from
    the slab range [a, b) that adds ``halo`` slabs on each side."""
    plane = max(geo.ny * geo.nx, 1)
    if chunk is None:
        chunk = max(CHUNK_ELEMS // plane, 1)
    for z0 in range(0, geo.nz, chunk):
        z1 = min(z0 + chunk, geo.nz)
        yield z0, z1, max(z0 - halo, 0), min(z1 + halo, geo.nz)


#: the largest slab plane the tile kernels take: their in-plane indices
#: are 32-bit (their C entry points refuse a larger plane too)
MAX_PLANE = 2 ** 31 - 1


def check_plane(what: str, geo: Geometry) -> None:
    """Raise when a slab plane of ``geo`` exceeds ``MAX_PLANE``."""
    if geo.ny * geo.nx > MAX_PLANE:
        raise ValueError(f"{what}: a slab plane of {geo.ny * geo.nx} "
                         f"vertices exceeds the kernel's {MAX_PLANE}")


def check_cuda_args(what: str, tensors, dtypes, shape) -> torch.device:
    """Shared wrapper checks: one CUDA device, contiguous, expected
    dtypes and shape. Returns the device, which the C entry makes
    current before its launch."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{what}: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{what}: shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return dev
