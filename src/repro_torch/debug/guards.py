"""Runtime sanitizer guards, the port of ``repro.debug.guards``.

* ``no_transfers()`` — inside the block, a host<->device transfer made
  outside the audited seams (``device._h2d`` / ``device._d2h``) raises
  ``TransferError`` at the offending call: a value read off a CUDA
  tensor (``.item()``, ``.tolist()``, ``bool``/``int``/``float``,
  ``torch.equal``, ``np.asarray``), a copy of one to the CPU
  (``.cpu()``, ``.to("cpu")``), and a CPU tensor or host value copied
  onto the card (``.cuda()``, ``.to("cuda")``, ``torch.tensor(...,
  device="cuda")``). The seams stay permitted and are counted
  (``TransferCounts``), so the block asserts that every crossing is an
  audited one. The guard watches the Python calls through a
  ``torch.overrides.TorchFunctionMode``; a data-dependent shape inside
  one op (``torch.nonzero``) syncs in C++ and is not seen.
* ``no_recompiles()`` — inside the block, more than ``max_compiles``
  compilations raise ``RecompileError``. The port's only compilations
  are the kernels' builds: an ``nvcc`` run or a library load in
  ``kernels/_build.py``, reported through ``note_compile``.

``sanitizers_enabled()`` reads the ``MSZ_SANITIZERS`` environment knob;
``sanitize_transfers()`` is ``no_transfers()`` when it is on and a no-op
otherwise, the wrapper the stream scheduler puts around its device
stage.

Both guards are thread-local: the mode stack of ``TorchFunctionMode``
and the compile sinks belong to the thread that entered the block, so a
guarded scheduler thread never constrains the worker threads that run
host entropy coding (and their own d2h copies).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Iterator, List, Optional

import torch
from torch.overrides import TorchFunctionMode

ENV_VAR = "MSZ_SANITIZERS"

_tls = threading.local()


def sanitizers_enabled() -> bool:
    """Whether the ``MSZ_SANITIZERS`` environment knob is on: hot paths
    that claim transfer discipline wrap themselves in ``no_transfers``
    when it is."""
    env = os.environ.get(ENV_VAR, "").strip().lower()
    if env in ("", "0", "false", "no", "off"):
        return False
    if env in ("1", "true", "yes", "on"):
        return True
    raise ValueError(
        f"{ENV_VAR}={env!r} not understood; use one of 1/true/yes/on "
        "(sanitizers on) or 0/false/no/off (off)")


class TransferError(RuntimeError):
    """Raised by ``no_transfers`` at a host<->device transfer made
    outside the audited seams."""


@dataclasses.dataclass
class TransferCounts:
    """The audited crossings one ``no_transfers`` block saw."""
    h2d: int = 0
    d2h: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0


def _is_device(t) -> bool:
    """Whether ``t`` is a tensor on the card (the guard's notion of a
    device tensor)."""
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


_T = torch.Tensor
#: calls that hand a device tensor's value to the host
_READS = frozenset({
    _T.item, _T.tolist, _T.numpy, _T.__array__, _T.__bool__, _T.__int__,
    _T.__float__, _T.__index__, _T.__complex__, _T.equal, _T.allclose,
    _T.is_nonzero, torch.equal, torch.allclose, torch.is_nonzero,
})
#: calls whose result may lie on another device than their input
_MOVES = frozenset({_T.cpu, _T.cuda, _T.to, _T.copy_})
#: calls that build a tensor from host values
_BUILDS = frozenset({torch.tensor, torch.as_tensor, torch.asarray})


def _name(func) -> str:
    return getattr(func, "__qualname__", None) or repr(func)


class _TransferGuard(TorchFunctionMode):
    """Raises at an unaudited transfer in the thread that entered it."""

    def __init__(self, h2d: bool, d2h: bool):
        super().__init__()
        self.h2d, self.d2h = h2d, d2h

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_tls, "in_seam", 0):
            return func(*args, **kwargs)
        if self.d2h and func in _READS and any(_is_device(a)
                                               for a in args[:2]):
            raise TransferError(
                f"device->host read `{_name(func)}` of a CUDA tensor "
                "outside the audited seam (device._d2h) inside "
                "no_transfers()")
        out = func(*args, **kwargs)
        if func in _MOVES and isinstance(out, torch.Tensor):
            # copy_(dst, src) writes into dst; the others return a copy
            src = args[1] if func is _T.copy_ and len(args) > 1 else args[0]
            moved = isinstance(src, torch.Tensor) and (
                func in (_T.cpu, _T.cuda) or out.device != src.device)
            if moved and self.d2h and _is_device(src) \
                    and out.device.type == "cpu":
                raise TransferError(
                    f"device->host copy `{_name(func)}` outside the "
                    "audited seam (device._d2h) inside no_transfers()")
            if moved and self.h2d and src.device.type == "cpu" \
                    and out.device.type == "cuda":
                raise TransferError(
                    f"host->device copy `{_name(func)}` outside the "
                    "audited seam (device._h2d) inside no_transfers()")
        if self.h2d and func in _BUILDS and isinstance(out, torch.Tensor) \
                and out.device.type == "cuda":
            raise TransferError(
                f"host->device build `{_name(func)}` outside the audited "
                "seam (device._h2d) inside no_transfers()")
        return out


@contextlib.contextmanager
def seam(direction: str, nbytes: int) -> Iterator[None]:
    """The audited crossing itself (``device._h2d`` / ``_d2h``): counted
    by every ``no_transfers`` block of this thread and permitted."""
    for counts in getattr(_tls, "counts", ()):
        setattr(counts, direction, getattr(counts, direction) + 1)
        key = direction + "_bytes"
        setattr(counts, key, getattr(counts, key) + int(nbytes))
    _tls.in_seam = getattr(_tls, "in_seam", 0) + 1
    try:
        yield
    finally:
        _tls.in_seam -= 1


@contextlib.contextmanager
def no_transfers(*, h2d: bool = True, d2h: bool = True
                 ) -> Iterator[TransferCounts]:
    """Raise ``TransferError`` at any host<->device transfer inside the
    block that does not go through ``device._h2d`` / ``device._d2h``;
    yields the counts of the audited crossings made in the block.
    ``h2d=False`` / ``d2h=False`` narrow the guard to one direction.
    Only the entering thread is guarded."""
    counts = TransferCounts()
    stack = getattr(_tls, "counts", None)
    if stack is None:
        stack = _tls.counts = []
    stack.append(counts)
    try:
        with _TransferGuard(h2d, d2h):
            yield counts
    finally:
        stack.remove(counts)


def sanitize_transfers():
    """``no_transfers()`` when the ``MSZ_SANITIZERS`` knob is on, else a
    no-op context."""
    if sanitizers_enabled():
        return no_transfers()
    return contextlib.nullcontext()


class RecompileError(RuntimeError):
    """Raised by ``no_recompiles`` when a block compiled more than its
    budget."""


def note_compile(what: str) -> None:
    """Report one compilation (an nvcc build or a library load) to the
    ``no_recompiles`` blocks of the calling thread."""
    for sink in getattr(_tls, "compiles", ()):
        sink.append(what)


@contextlib.contextmanager
def no_recompiles(max_compiles: int = 0, *,
                  label: Optional[str] = None) -> Iterator[List[str]]:
    """Raise ``RecompileError`` when the block (in this thread) compiled
    more than ``max_compiles`` times: kernel builds and library loads.
    Yields the live list of what was compiled. An exception raised by
    the block propagates unchanged (the budget is checked on a clean
    exit only)."""
    messages: List[str] = []
    sinks = getattr(_tls, "compiles", None)
    if sinks is None:
        sinks = _tls.compiles = []
    sinks.append(messages)
    try:
        yield messages
    finally:
        sinks.remove(messages)
    if len(messages) > max_compiles:
        what = f" in {label}" if label else ""
        detail = "\n  ".join(messages)
        raise RecompileError(
            f"{len(messages)} compilation(s){what} where at most "
            f"{max_compiles} were budgeted. Compiled:\n  {detail}")
