"""Data meshes of the port, the counterpart of ``repro.launch.mesh``'s
``make_data_mesh`` / ``factor_block_shape`` / ``make_block_mesh`` for the
block-sharded fix loop (``repro_torch.distributed.shardfix``).

A mesh lives in one process. It names its axes as the reference's do —
``('data',)`` for a slab chain, or the block axes ``data_x`` / ``data_y``
/ ``data_z`` (field axes 2 / 1 / 0) — and holds one ``torch.device`` per
block, an object array in the mesh's shape. By default each block gets
a visible card of its own, and asking for more blocks than there are
cards raises. ``devices=`` names the placement instead: several blocks
may share one card (``["cuda:0"] * 4``, the counterpart of the
reference's emulated host devices) or all lie on the CPU
(``["cpu"] * 4``, which the tests use). Nothing moves to the CPU unless
``devices=`` says so.

``with mesh:`` makes a mesh the active one of the calling context (a
``contextvars`` stack), which ``backend="auto"`` consults as the
reference consults its ``with mesh:`` context.
"""
from __future__ import annotations

import contextvars
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["BLOCK_AXIS_ORDER", "DeviceMesh", "active_mesh",
           "factor_block_shape", "make_block_mesh", "make_data_mesh"]

#: mesh axis names for block meshes, outermost first; the LAST k of these
#: name a k-axis mesh, so the slab axis (data_z, field axis 0) is always
#: present and data_x appears only in full 3D decompositions
BLOCK_AXIS_ORDER = ("data_x", "data_y", "data_z")

DeviceSpec = Union[str, torch.device]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_mesh", default=())


class DeviceMesh:
    """Named axes over an object array of ``torch.device``s, one per
    block. ``shape`` maps each axis name to its size, as the reference's
    ``Mesh.shape`` does, so the reference's ``plan_blocks`` and
    ``halo_plan`` accept this object as they are."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-axis device array needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self._tokens: List[contextvars.Token] = []

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __enter__(self) -> "DeviceMesh":
        self._tokens.append(_ACTIVE.set(_ACTIVE.get() + (self,)))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._tokens.pop())

    def __repr__(self) -> str:
        places = ", ".join(str(d) for d in self.devices.reshape(-1))
        return f"DeviceMesh({self.shape}, devices=[{places}])"


def active_mesh() -> Optional[DeviceMesh]:
    """The innermost mesh entered with ``with mesh:`` in this context,
    or None."""
    stack = _ACTIVE.get()
    return stack[-1] if stack else None


def _visible() -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _object_array(devs: List[torch.device]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr


def _place(n: int, devices: Optional[Sequence[DeviceSpec]], what: str
           ) -> List[torch.device]:
    """``n`` block placements: ``devices`` as named (one per block), or
    the first ``n`` visible cards, one per block."""
    if n < 1:
        raise ValueError(f"a {what} needs at least one block, got {n}")
    if devices is None:
        avail = _visible()
        if n > len(avail):
            raise ValueError(
                f"requested a {what} of {n} blocks but {len(avail)} CUDA "
                f"device(s) are visible; pass devices=[...] to place "
                f"several blocks on one device (e.g. ['cuda:0'] * {n}, "
                f"or ['cpu'] * {n} for the plain versions)")
        return avail[:n]
    devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"devices= names {len(devs)} placement(s) for a "
                         f"{what} of {n} blocks")
    out = []
    for d in devs:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: no CUDA GPU is "
                                   "available")
            idx = torch.cuda.current_device() if d.index is None else d.index
            if idx >= torch.cuda.device_count():
                raise ValueError(f"mesh device {d}: only "
                                 f"{torch.cuda.device_count()} CUDA "
                                 "device(s) are visible")
            d = torch.device("cuda", idx)
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}; use cuda or cpu")
        out.append(d)
    if len({d.type for d in out}) > 1:
        raise ValueError(f"a mesh's blocks lie on one device type, got "
                         f"{sorted({str(d) for d in out})}")
    return out


def make_data_mesh(n_devices: Optional[int] = None, *,
                   devices: Optional[Sequence[DeviceSpec]] = None
                   ) -> DeviceMesh:
    """One-axis ``('data',)`` mesh: the slab chain that shards field axis
    0. ``n_devices`` defaults to every visible card (or to the length of
    ``devices``). For 2D/3D block decompositions use
    :func:`make_block_mesh`."""
    if n_devices is None:
        n_devices = len(devices) if devices is not None else len(_visible())
    return DeviceMesh(_object_array(_place(int(n_devices), devices,
                                           "data mesh")), ("data",))


def factor_block_shape(n_devices: int, ndim: int = 2) -> Tuple[int, ...]:
    """Factor ``n_devices`` into the most cube-like ``ndim``-tuple
    (ascending, so the largest factor lands on the innermost ``data_z``
    slab axis): 8 -> (2, 4) or (2, 2, 2), 6 -> (2, 3), primes give
    (1, ..., p). Cube-like shapes minimize the total halo face area for
    a given block count."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"cannot factor a {n}-device block mesh")
    if ndim == 1:
        return (n,)
    # peel the divisor closest to the ndim-th root, recurse on the rest
    root = round(n ** (1.0 / ndim))
    best = 1
    for cand in range(1, n + 1):
        if n % cand:
            continue
        if abs(cand - root) < abs(best - root) or (
                abs(cand - root) == abs(best - root) and cand < best):
            best = cand
    rest = factor_block_shape(n // best, ndim - 1)
    return tuple(sorted((best,) + rest))


def make_block_mesh(shape: Union[Sequence[int], str, None] = "auto", *,
                    ndim: int = 2,
                    devices: Optional[Sequence[DeviceSpec]] = None
                    ) -> DeviceMesh:
    """Block mesh for the 2D/3D block-decomposed fix loop. ``shape`` is a
    tuple of 1-3 axis sizes, outermost first, mapped onto the LAST k of
    ``(data_x, data_y, data_z)`` — a 2-tuple gives ``('data_y',
    'data_z')`` (field axes 1 and 0), a 3-tuple the full 3D
    decomposition — or ``"auto"``, which factors every block (the
    visible cards, or ``devices``) into the most cube-like
    ``ndim``-tuple. Blocks fill the mesh in row-major order."""
    if shape is None or (isinstance(shape, str) and shape == "auto"):
        n_all = len(devices) if devices is not None else len(_visible())
        shape_t = factor_block_shape(n_all, ndim)
    elif isinstance(shape, str):
        raise ValueError(f"shape must be a tuple of mesh-axis sizes or "
                         f"'auto', got {shape!r}")
    else:
        shape_t = tuple(int(s) for s in shape)
    if not 1 <= len(shape_t) <= 3 or any(s < 1 for s in shape_t):
        raise ValueError(f"block mesh shape must be 1-3 positive axis "
                         f"sizes, got {shape_t}")
    devs = _place(math.prod(shape_t), devices, f"{shape_t} block mesh")
    return DeviceMesh(_object_array(devs).reshape(shape_t),
                      BLOCK_AXIS_ORDER[-len(shape_t):])
