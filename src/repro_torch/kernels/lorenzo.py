"""Quantize + integer Lorenzo residual: the CUDA kernel
``csrc/lorenzo.cu`` and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/lorenzo.py:_kernel`` (via
``lorenzo_quant_pallas``): ``q = round(f / step)`` in the field's dtype,
ties to even, cast to int32, then the d-D mixed backward difference of
q (8 terms in 3D, 4 in 2D). A term is zero where its position lies
before the global domain (z == 0 through ``slab_lo``, and y == 0 /
x == 0) or before the tile.

What bounds it on an H100: memory — 4 B read and 4 B written per f32
vertex (0.321 ms at 512^3). The kernel is a shared-memory stencil tile,
as the fix pass is: a block owns a (y, x) tile and marches over a run
of planes in z, and each quotient is computed once (one IEEE division a
vertex, plus the tile's backward halo) into a two-plane shared ring.
The 3D difference splits as r(z) = d(z) - d(z-1), d the 2D mixed
difference of one plane, and each thread keeps d(z-1) in registers.
Rows whose width is a multiple of 4 load and store 16 bytes a thread.
See the note at the head of ``csrc/lorenzo.cu``.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import itertools

import torch

from ..core.grid import shift
from . import _build
from .stencil import (Geometry, check_cuda_args, check_plane, geometry,
                      neighbor_ok)

#: kernel launches so far (one per wrapper call on a CUDA tensor)
launches = 0


def lorenzo_quant_plain(f: torch.Tensor, step: torch.Tensor,
                        geo: Geometry) -> torch.Tensor:
    """The plain PyTorch version: int32 quotients, then the 8 signed
    backward terms, each masked where it falls before the domain or the
    tile."""
    q = torch.round(f.reshape(geo.shape3) / step).to(torch.int32)
    r = torch.zeros_like(q)
    for dz, dy, dx in itertools.product((0, 1), repeat=3):
        off = (-dz, -dy, -dx)
        term = torch.where(neighbor_ok(geo, off, q.device),
                           shift(q, off, 0), 0)
        r = r - term if (dz + dy + dx) % 2 else r + term
    return r.reshape(f.shape)


def _entry(dtype):
    lib = _build.load("lorenzo")
    sym = "msz_lorenzo_f32" if dtype == torch.float32 else "msz_lorenzo_f64"
    return _build.entry(lib, sym, 3, 7, 0)


def lorenzo_quant(f: torch.Tensor, step: torch.Tensor, *,
                  slab_lo: int = 0) -> torch.Tensor:
    """f: (Z,Y,X) or (Y,X) float32/float64; ``step``: a 0-d tensor of f's
    dtype on f's device. Returns the int32 Lorenzo residuals of
    round(f / step); ``slab_lo`` places a slab block inside a larger
    field, as in ``lorenzo_quant_pallas``."""
    global launches
    geo = geometry(tuple(f.shape), slab_lo)
    if step.dtype != f.dtype or step.numel() != 1:
        raise TypeError("lorenzo_quant: step must be a scalar tensor of the "
                        f"field dtype {f.dtype}, got {step.dtype}")
    if f.device.type == "cpu":
        return lorenzo_quant_plain(f, step.to(f.device), geo)
    if f.device.type != "cuda":
        raise ValueError(f"lorenzo_quant: unsupported device {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lorenzo_quant: float32/float64 field, got {f.dtype}")
    check_plane("lorenzo_quant", geo)
    dev = check_cuda_args("lorenzo_quant", [f], [f.dtype], f.shape)
    if step.device != dev:
        raise ValueError(f"lorenzo_quant: step on {step.device}, f on {dev}")
    r = torch.empty(f.shape, dtype=torch.int32, device=dev)
    fn = _entry(f.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(f.data_ptr(), step.data_ptr(), r.data_ptr(),
                        *geo.c_ints()[:6], dev.index, stream),
                     "lorenzo_quant")
    launches += 1
    return r
