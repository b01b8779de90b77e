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

``make_host_mesh`` is the reference's degenerate 1 x 1 ``("data",
"model")`` mesh on one device, which the train launcher runs on;
``make_production_mesh`` the reference's (16, 16) ``("data", "model")``
pod or (2, 16, 16) ``("pod", "data", "model")`` pair of pods, on 256 or
512 visible cards or on the placements ``devices=`` names
(``["meta"] * 256`` is the dry-run's: shapes only, nothing allocated).

``init_distributed`` joins this process to a ``torch.distributed``
process group. A mesh then spans processes: ``make_mesh`` and
``make_production_mesh`` called under a group place rank r at position
r (row-major) on its card (``cuda:LOCAL_RANK`` under NCCL, the CPU under
gloo), as ``jax.make_mesh`` lays the devices of every process out. Such
a mesh knows the rank that owns each position (``ranks``), which
positions are this process's (``local_positions``: one), and the
process group of every set of its axes (``group``), built with
``dist.new_group`` on every rank in the same order when the mesh is
made. A mesh made without a group (or with ``devices=``) holds every
position in this process.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["BLOCK_AXIS_ORDER", "DeviceMesh", "active_mesh", "entered",
           "factor_block_shape", "init_distributed", "make_block_mesh",
           "launcher_mesh", "make_data_mesh", "make_host_mesh", "make_mesh",
           "make_production_mesh"]

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
    ``halo_plan`` accept this object as they are.

    ``ranks`` (an int array of the devices' shape) names the process
    that owns each position; None: every position is this process's.
    A multi-process mesh holds one position a rank, and builds the
    process group of every non-empty set of its axes at once, on every
    rank in the same order (``dist.new_group`` needs that)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-axis device array needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.ranks = None if ranks is None else np.asarray(
            ranks, dtype=np.int64).reshape(devices.shape)
        self._tokens: List[contextvars.Token] = []
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._coords: Dict[int, Dict[str, int]] = {}
        self._members: Dict[Tuple[int, Tuple[str, ...]], List[int]] = {}
        if self.ranks is not None:
            if len(set(self.ranks.reshape(-1).tolist())) != self.ranks.size:
                raise ValueError("a multi-process mesh holds one position "
                                 "a rank")
            self._build_groups()

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multi_process(self) -> bool:
        return self.ranks is not None

    def is_rank0(self) -> bool:
        """Whether this process speaks for the mesh: rank 0 across
        processes, always in one."""
        if self.ranks is None:
            return True
        import torch.distributed as dist
        return dist.get_rank() == 0

    def local_positions(self) -> List[int]:
        """The flat (row-major) positions this process holds: every one,
        or on a multi-process mesh this rank's one."""
        if self.ranks is None:
            return list(range(self.size))
        import torch.distributed as dist
        me = dist.get_rank()
        return [int(i) for i in np.flatnonzero(self.ranks.reshape(-1) == me)]

    def device_at(self, pos: int) -> torch.device:
        """The ``torch.device`` of flat (row-major) position ``pos``."""
        return torch.device(self.devices.reshape(-1)[pos])

    def coords(self, pos: int) -> Dict[str, int]:
        """Axis name -> index of flat position ``pos`` (a fresh dict; the
        mesh keeps each position's, as the serving's per-layer views ask
        for them at every step)."""
        if pos not in self._coords:
            self._coords[pos] = {a: int(i) for a, i in zip(
                self.axis_names, np.unravel_index(pos, self.devices.shape))}
        return dict(self._coords[pos])

    def members(self, pos: int, axes: Sequence[str]) -> List[int]:
        """The flat positions that differ from ``pos`` only along
        ``axes``, row-major (the first axis of the mesh's order
        outermost): the group ``pos`` meets in a collective over
        ``axes`` (a fresh list of the mesh's memo)."""
        key = (pos, tuple(axes))
        if key not in self._members:
            c = self.coords(pos)
            ranges = [range(n) if a in axes else (c[a],)
                      for a, n in zip(self.axis_names, self.devices.shape)]
            self._members[key] = [
                int(np.ravel_multi_index(ix, self.devices.shape))
                for ix in itertools.product(*ranges)]
        return list(self._members[key])

    def _axes_key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} lack "
                             f"{sorted(unknown)}")
        return tuple(a for a in self.axis_names if a in axes)

    def _build_groups(self) -> None:
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("a multi-process mesh needs a process group "
                               "(launch.mesh.init_distributed)")
        if dist.get_world_size() < self.size:
            raise ValueError(f"a mesh of {self.size} positions over "
                             f"{dist.get_world_size()} ranks")
        me = dist.get_rank()
        flat = self.ranks.reshape(-1)
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                seen = set()
                for pos in range(self.size):
                    ms = tuple(self.members(pos, axes))
                    if ms in seen:
                        continue
                    seen.add(ms)
                    ranks = [int(flat[q]) for q in ms]
                    g = dist.new_group(ranks)
                    if me in ranks:
                        self._groups[axes] = g

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes`` (a multi-process mesh's
        own; its members in position order, which is rank order)."""
        if self.ranks is None:
            raise ValueError("a single-process mesh has no process groups")
        return self._groups[self._axes_key(axes)]

    def __enter__(self) -> "DeviceMesh":
        self._tokens.append(_ACTIVE.set(_ACTIVE.get() + (self,)))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._tokens.pop())

    def __repr__(self) -> str:
        places = ", ".join(str(d) for d in self.devices.reshape(-1))
        where = "" if self.ranks is None else ", multi-process"
        return f"DeviceMesh({self.shape}, devices=[{places}]{where})"


def active_mesh() -> Optional[DeviceMesh]:
    """The innermost mesh entered with ``with mesh:`` in this context,
    or None."""
    stack = _ACTIVE.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def entered(mesh: Optional[DeviceMesh]):
    """``mesh`` as the active mesh of this context while the block runs
    (nothing for None): a context another thread took from
    ``active_mesh()``, such as a remat recompute on autograd's device
    thread, which does not see the caller's."""
    if mesh is None:
        yield
        return
    token = _ACTIVE.set(_ACTIVE.get() + (mesh,))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


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
        elif d.type not in ("cpu", "meta"):
            raise ValueError(f"unsupported mesh device {d}; use cuda, cpu "
                             "or meta")
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


def _group_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank_device() -> torch.device:
    """This rank's device in a process group: its current card under
    NCCL, the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              devices: Optional[Sequence[DeviceSpec]] = None
              ) -> DeviceMesh:
    """A mesh of ``shape`` over ``axis_names``, ``jax.make_mesh``'s
    counterpart. Under a process group (and without ``devices=``) it
    spans the processes: rank r at position r, row-major, on its own
    device; the group must have exactly as many ranks as the mesh has
    positions. Otherwise every position lies in this process, on
    ``devices`` (one each) or a visible card each."""
    shape_t = tuple(int(s) for s in shape)
    n = math.prod(shape_t)
    if devices is None and _group_up():
        import torch.distributed as dist
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"requested a {shape_t} mesh of {n} positions "
                             f"but the process group has {world} ranks")
        dev = _rank_device()
        # every rank sees one device a rank: its own is the only one it
        # touches; the others' entries name where those ranks run
        devs = [dev if r == dist.get_rank() else
                (torch.device("cuda", r % max(torch.cuda.device_count(), 1))
                 if dev.type == "cuda" else dev) for r in range(n)]
        return DeviceMesh(_object_array(devs).reshape(shape_t), axis_names,
                          ranks=np.arange(n).reshape(shape_t))
    devs = _place(n, devices, f"{shape_t} mesh")
    return DeviceMesh(_object_array(devs).reshape(shape_t), axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceSpec]] = None
                         ) -> DeviceMesh:
    """16 x 16 = 256 devices a pod; ``multi_pod`` stacks 2 pods = 512.
    Axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
    multi-pod. Under a process group a rank a position (``make_mesh``),
    raising unless the group has 256 (512) ranks; otherwise a visible
    card a device, raising with fewer than 256 (512) cards, as
    ``jax.make_mesh`` raises with too few devices;
    ``devices=["meta"] * 256`` places the dry-run's mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None and _group_up():
        return make_mesh(shape, axes)
    devs = _place(math.prod(shape), devices, f"{shape} production mesh")
    return DeviceMesh(_object_array(devs).reshape(shape), axes)


def init_distributed(*, coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join this process to a ``torch.distributed`` process group.

    The arguments default to torchrun's environment: ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. ``coordinator_address``
    is ``host:port`` (a TCP rendezvous) or an ``init_method`` URL
    (``tcp://...``, ``file://...``). Returns False without touching
    ``torch.distributed`` when neither arguments nor environment request
    a multi-process run (one process), True once the group is up.
    Idempotent: a process already in a group returns True. The backend is
    ``nccl`` (each process then takes the card ``LOCAL_RANK``, or its
    rank, modulo the visible cards) unless ``backend`` names another
    (``gloo`` for the CPU)."""
    import torch.distributed as dist
    env = os.environ
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    nproc = num_processes if num_processes is not None else (
        int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    if addr is None or nproc is None or nproc <= 1:
        return False
    if dist.is_initialized():
        return True
    pid = process_id if process_id is not None else (
        int(env["RANK"]) if "RANK" in env else None)
    if pid is None:
        raise ValueError("init_distributed: a multi-process run needs this "
                         "process's rank (process_id= or RANK)")
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", pid))
                              % torch.cuda.device_count())
    url = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=url, world_size=nproc,
                            rank=pid)
    return True


def make_host_mesh(device: Optional[DeviceSpec] = None) -> DeviceMesh:
    """The degenerate 1 x 1 ``("data", "model")`` mesh on one device
    (``cuda`` unless ``device`` names another; ``resolve_device``'s
    rule), so the launchers' mesh code runs unchanged on one card."""
    from ..device import resolve_device
    return DeviceMesh(_object_array([resolve_device(device)]).reshape(1, 1),
                      ("data", "model"))


def launcher_mesh(device: Optional[DeviceSpec] = None) -> DeviceMesh:
    """The LM launchers' mesh, the reference's choice
    (``repro/launch/train.py:52-53``): the 1 x 1 host mesh on one device,
    otherwise ``make_production_mesh()``, over the process group that
    ``init_distributed`` joins (torchrun's environment) or over the
    visible cards of this process."""
    from ..device import resolve_device
    dev = resolve_device(device)
    if init_distributed():
        import torch.distributed as dist
        n_dev = dist.get_world_size()
    else:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_host_mesh(dev) if n_dev == 1 else make_production_mesh()


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
