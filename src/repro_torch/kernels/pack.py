"""Chunked-bitplane packing of int32 residual codes (``entropy=
"device-pack"``, the SZP1 stream): the CUDA kernels ``csrc/pack.cu``,
their plain PyTorch versions and the numpy host mirror.

The layout, shared with ``repro.kernels.pack`` bit for bit: the flat
codes split into ``CHUNK``-code chunks (the ragged last one padded with
zigzag 0); each chunk zigzags its codes to uint32 and keeps its ``b``
lowest bitplanes, ``b = 32 - clz(max)``; plane ``k`` of a chunk is
``CHUNK / 32`` words, bit ``t`` of word ``m`` being bit ``k`` of code
``m*32 + t``; chunks follow each other in the stream, planes in order.

Replaces two Pallas calls of ``repro/kernels/pack.py``:

* ``pack_codes`` replaces ``_pack_codes_pallas_jit`` (kernel body
  ``_pack_kernel``) and the offset scan and compaction around it. One
  launch reads each code once: a 256-thread block takes a tile of 8
  chunks from an atomic ticket, stages its codes in shared memory
  (``cp.async``), OR-reduces each chunk's zigzagged codes to its width
  (``__reduce_or_sync``), builds the planes with ``__ballot_sync`` and
  finds the tile's word offset with a single-pass chained scan with
  decoupled look-back (a 64-bit flag|value status word per tile), then
  writes its words there. The words go into a buffer of the largest possible
  stream; one 16-byte read of the scratch after the launch (the call's
  one sync) gives the stream length, and the call returns that many.
* ``unpack_codes`` replaces ``_unpack_codes_pallas_jit`` (kernel body
  ``_unpack_kernel``) and the expand gather before it. One launch and
  no host work before it beyond shape checks: each block validates its
  width, finds its offset with the same look-back, loads its planes into
  shared memory and rebuilds 4 codes a thread. The kernel counts widths
  outside [0, 32] and sums the stream length the widths demand; one
  16-byte read after the launch raises what ``check_stream`` raises for
  a bad stream, so a bad stream never returns a decode.

What bounds them on an H100: memory — 4 B read per code and the stream
written (pack), the stream read and 4 B written per code (unpack); the
ballots and shifts are a few integer instructions per code and plane.
Both read and write contiguous runs of words, coalesced across the warp.

The stream is uint32, but torch's ``uint32`` lacks shifts and
reductions, so the tensors here are int32 with the stream's bits and the
plain versions compute in int64; at the numpy seam the words are viewed
as uint32. On a CPU tensor each wrapper runs its plain version; on a
CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import _d2h
from . import _build

#: codes per chunk (one bit width each); a multiple of 32 so that a
#: bitplane transposes into whole uint32 words
CHUNK = 1024

#: kernel launches so far (one per wrapper call on a CUDA tensor)
pack_launches = 0
unpack_launches = 0

_INT32_LIMIT = 2 ** 31


def words_per_plane(chunk: int = CHUNK) -> int:
    """uint32 words one bitplane of a ``chunk``-code chunk occupies."""
    if chunk % 32:
        raise ValueError(f"chunk must be a multiple of 32, got {chunk}")
    return chunk // 32


def _chunk_layout(n: int, chunk: int) -> Tuple[int, int, int]:
    """(n_chunks, padded length, words/plane) of an ``n``-code stream."""
    wpp = words_per_plane(chunk)
    n_chunks = -(-n // chunk) if n else 0
    return n_chunks, n_chunks * chunk, wpp


# ---------------------------------------------------------------------------
# numpy host mirror (a copy of the reference's; backs the SZP1 blob codec)
# ---------------------------------------------------------------------------

def _zigzag_np(r: np.ndarray) -> np.ndarray:
    v = np.asarray(r, np.int64)
    return (((v << 1) ^ (v >> 31)) & 0xFFFFFFFF).astype(np.uint32)


def _unzigzag_np(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, np.uint64)
    v = (u >> np.uint64(1)).astype(np.int64) ^ -(u & np.uint64(1)).astype(
        np.int64)
    return v.astype(np.int32)


def _bits_np(maxu: np.ndarray) -> np.ndarray:
    """Per-chunk bit widths: bit_length of the max zigzagged magnitude."""
    thresholds = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return np.sum(maxu.astype(np.uint64)[:, None] >= thresholds[None, :],
                  axis=1).astype(np.int32)


def pack_codes_host(r: np.ndarray, chunk: int = CHUNK
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``(words, bits)`` of int32-range codes ``r``: the uint32 stream,
    exactly as long as the widths demand, and the int32 widths."""
    flat = np.asarray(r).reshape(-1)
    if flat.size and not (np.all(flat >= np.iinfo(np.int32).min)
                          and np.all(flat <= np.iinfo(np.int32).max)):
        raise ValueError("device-pack serves int32 residual codes only")
    n = flat.size
    n_chunks, n_pad, wpp = _chunk_layout(n, chunk)
    if n_chunks == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    u3 = np.zeros(n_pad, np.uint32)
    u3[:n] = _zigzag_np(flat)
    u3 = u3.reshape(n_chunks, wpp, 32)
    bits = _bits_np(u3.max(axis=(1, 2)))
    t = np.arange(32, dtype=np.uint32)
    dense = np.empty((n_chunks, 32, wpp), np.uint32)
    for k in range(32):
        dense[:, k, :] = np.sum(
            ((u3 >> np.uint32(k)) & np.uint32(1)) << t, axis=2,
            dtype=np.uint32)
    keep = np.arange(32)[None, :] < bits[:, None]          # (n_chunks, 32)
    return dense[keep].reshape(-1), bits


def check_stream(n_words: int, bits: np.ndarray, n: int,
                 chunk: int = CHUNK) -> None:
    """Validate a packed stream of ``n_words`` words and widths ``bits``
    for ``n`` codes: one width per chunk, each in [0, 32], and
    ``sum(bits) * words_per_plane == n_words``. A truncated or over-long
    stream raises ``ValueError``; it never decodes short."""
    bits = np.asarray(bits, np.int64)
    n_chunks, _, wpp = _chunk_layout(n, chunk)
    if bits.size != n_chunks:
        raise ValueError(
            f"bit-width table has {bits.size} chunks, expected {n_chunks} "
            f"for {n} codes at chunk={chunk}")
    if np.any(bits < 0) or np.any(bits > 32):
        raise ValueError("chunk bit widths must lie in [0, 32]")
    expect = int(np.sum(bits)) * wpp
    if n_words != expect:
        raise ValueError(
            f"packed stream has {n_words} words, expected {expect} "
            "(truncated or over-long device-pack blob)")


def unpack_codes_host(words: np.ndarray, bits: np.ndarray, n: int,
                      chunk: int = CHUNK) -> np.ndarray:
    """Inverse of ``pack_codes_host``: the flat int32 codes of length
    ``n`` (the stream is validated first, see ``check_stream``)."""
    bits = np.asarray(bits, np.int64)
    words = np.asarray(words, np.uint32)
    check_stream(words.size, bits, n, chunk)
    n_chunks, _, wpp = _chunk_layout(n, chunk)
    if n_chunks == 0:
        return np.zeros(0, np.int32)
    dense = np.zeros((n_chunks, 32, wpp), np.uint32)
    keep = np.arange(32)[None, :] < bits[:, None]
    dense[keep] = words.reshape(-1, wpp)
    t = np.arange(32, dtype=np.uint32)
    u3 = np.zeros((n_chunks, wpp, 32), np.uint32)
    for k in range(32):
        u3 |= ((dense[:, k, :, None] >> t) & np.uint32(1)) << np.uint32(k)
    return _unzigzag_np(u3.reshape(-1)[:n])


# ---------------------------------------------------------------------------
# plain PyTorch versions (int64 arithmetic; int32 bit patterns in and out)
# ---------------------------------------------------------------------------

def zigzag(r: torch.Tensor) -> torch.Tensor:
    """int32 codes -> their zigzag values (0,-1,1,-2,.. -> 0,1,2,3,..)
    as int64 in [0, 2^32)."""
    v = r.to(torch.int64)
    return ((v << 1) ^ (v >> 31)) & 0xFFFFFFFF


def unzigzag(u: torch.Tensor) -> torch.Tensor:
    """Inverse of ``zigzag``: int64 values in [0, 2^32) -> int32 codes."""
    return ((u >> 1) ^ -(u & 1)).to(torch.int32)


def _as_int32_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(u >= _INT32_LIMIT, u - 2 ** 32, u).to(torch.int32)


def _widths_plain(u3: torch.Tensor) -> torch.Tensor:
    """int32 bit length of each chunk's max zigzag value."""
    maxu = u3.amax(dim=(1, 2))
    thresholds = torch.ones(32, dtype=torch.int64, device=u3.device) \
        << torch.arange(32, device=u3.device)
    return (maxu[:, None] >= thresholds[None, :]).sum(1).to(torch.int32)


def pack_codes_plain(r: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The plain version of ``pack_codes``: ``(words, bits, n_words)``
    with ``words`` int32 (the stream's bits) of length ``n_words``. Each
    plane is written into a preallocated (n_chunks, 32, 32) int64 array,
    so the peak is a few times the code array, not 32 times."""
    n = r.numel()
    n_chunks, n_pad, wpp = _chunk_layout(n, CHUNK)
    dev = r.device
    if n_chunks == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev), 0)
    u3 = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    u3[:n] = zigzag(r.reshape(-1))
    u3 = u3.reshape(n_chunks, wpp, 32)
    bits = _widths_plain(u3)
    t = torch.arange(32, dtype=torch.int64, device=dev)
    dense = torch.empty((n_chunks, 32, wpp), dtype=torch.int64, device=dev)
    for k in range(32):
        dense[:, k, :] = (((u3 >> k) & 1) << t).sum(2)
    del u3
    keep = torch.arange(32, device=dev)[None, :] < bits[:, None]
    words = _as_int32_bits(dense[keep].reshape(-1))
    return words, bits, int(words.numel())


def unpack_codes_plain(words: torch.Tensor, bits: torch.Tensor,
                       shape: Tuple[int, ...]) -> torch.Tensor:
    """The plain version of ``unpack_codes``: int32 codes of ``shape``,
    after ``check_stream`` has validated the stream."""
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    check_stream(words.numel(), bits.cpu().numpy(), n)
    n_chunks, _, wpp = _chunk_layout(n, CHUNK)
    dev = words.device
    if n_chunks == 0:
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    dense = torch.zeros((n_chunks, 32, wpp), dtype=torch.int64, device=dev)
    keep = torch.arange(32, device=dev)[None, :] < bits.to(dev)[:, None]
    dense[keep] = (words.to(torch.int64) & 0xFFFFFFFF).reshape(-1, wpp)
    t = torch.arange(32, dtype=torch.int64, device=dev)
    u3 = torch.zeros((n_chunks, wpp, 32), dtype=torch.int64, device=dev)
    for k in range(32):
        u3 |= ((dense[:, k, :, None] >> t) & 1) << k
    del dense
    return unzigzag(u3.reshape(-1)[:n]).reshape(shape)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

#: int64 scratch words before the look-back statuses (one a tile of
#: chunks): the stream length in words, the count of widths outside
#: [0, 32] (unpack) and the ticket (``csrc/pack.cu``)
_META = 3


def scratch_size(n_chunks: int) -> int:
    """int64 words of scratch a launch over ``n_chunks`` chunks takes
    (room for one status a chunk, more than the tiles need)."""
    return _META + n_chunks


def _check_int32_tensor(what: str, x: torch.Tensor,
                        dev: torch.device) -> None:
    if x.device != dev:
        raise ValueError(f"{what}: tensor on {x.device}, expected {dev}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: int32 tensor expected, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check_size(what: str, n: int) -> None:
    if -(-n // CHUNK) * CHUNK >= _INT32_LIMIT:
        raise ValueError(f"{what}: {n} codes; the kernels index codes and "
                         f"words with 32-bit ints (n_chunks * {CHUNK} < "
                         "2^31)")


def launch_pack(r: torch.Tensor, words: torch.Tensor, bits: torch.Tensor,
                scratch: torch.Tensor) -> None:
    """The pack kernel alone, on the current stream of ``r``'s device,
    into preallocated buffers on that device: ``words`` int32 with room
    for ``n_chunks * CHUNK``, ``bits`` int32 ``n_chunks``, ``scratch``
    int64 ``scratch_size(n_chunks)`` (zeroed by the launch). Counts
    nothing and reads nothing back."""
    lib = _build.load("pack")
    dev = r.device
    with torch.cuda.device(dev):
        _build.check(_build.entry(lib, "msz_pack", 4, 2, 0)(
            r.data_ptr(), words.data_ptr(), bits.data_ptr(),
            scratch.data_ptr(), r.numel(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream), "pack_codes")


def launch_unpack(words: torch.Tensor, bits: torch.Tensor, out: torch.Tensor,
                  scratch: torch.Tensor) -> None:
    """The unpack kernel alone, on the current stream of ``out``'s
    device: ``out`` int32 of the code count (16-byte aligned),
    ``scratch`` as in ``launch_pack``. Counts nothing and reads nothing
    back."""
    lib = _build.load("pack")
    dev = out.device
    with torch.cuda.device(dev):
        _build.check(_build.entry(lib, "msz_unpack", 4, 3, 0)(
            words.data_ptr(), bits.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), out.numel(), words.numel(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream), "unpack_codes")


def _read_meta(scratch: torch.Tensor) -> Tuple[int, int]:
    """(stream length the widths demand, widths outside [0, 32]): one
    16-byte device-to-host read, after the launch."""
    total, bad = _d2h(scratch[:2]).tolist()
    return total, bad


def pack_codes(r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pack int32 residual codes (any shape) into the chunked-bitplane
    stream: ``(words, bits, n_words)``, ``words`` an int32 tensor with
    the bits of the ``n_words`` uint32 words, ``bits`` the int32 width
    of each chunk. On CUDA: one launch, then one 16-byte read for
    ``n_words``; ``words`` is a view of a buffer with room for the
    largest stream."""
    global pack_launches
    if r.device.type == "cpu":
        return pack_codes_plain(r)
    if r.device.type != "cuda":
        raise ValueError(f"pack_codes: unsupported device {r.device}")
    _check_int32_tensor("pack_codes", r, r.device)
    n = r.numel()
    _check_size("pack_codes", n)
    n_chunks, n_pad, _ = _chunk_layout(n, CHUNK)
    dev = r.device
    bits = torch.empty(n_chunks, dtype=torch.int32, device=dev)
    if n_chunks == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), bits, 0
    words = torch.empty(n_pad, dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_size(n_chunks), dtype=torch.int64,
                          device=dev)
    launch_pack(r, words, bits, scratch)
    pack_launches += 1
    n_words, bad = _read_meta(scratch)
    if bad or n_words % words_per_plane() or not 0 <= n_words <= n_pad:
        raise RuntimeError(f"pack_codes: the kernel's scratch reads "
                           f"{n_words} words and {bad} bad widths")
    return words[:n_words], bits, n_words


def _check_status(n_words: int, total: int, bad: int) -> None:
    """Raise what ``check_stream`` raises, from the unpack kernel's
    status: ``bad`` widths outside [0, 32], ``total`` words demanded."""
    if bad:
        raise ValueError("chunk bit widths must lie in [0, 32]")
    if n_words != total:
        raise ValueError(
            f"packed stream has {n_words} words, expected {total} "
            "(truncated or over-long device-pack blob)")


def unpack_codes(words: torch.Tensor, bits: torch.Tensor,
                 shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of ``pack_codes``: the int32 codes of ``shape`` from the
    stream ``words`` (int32, exactly ``n_words`` long) and the widths
    ``bits`` (int32), both on one device. A bad stream raises
    ``ValueError``, as ``check_stream`` does; on CUDA the widths are
    validated by the kernel and read back in one 16-byte read after the
    launch, and the decode is discarded."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unpack_codes: unsupported device {dev}")
    if bits.device != dev:
        raise ValueError(f"unpack_codes: bits on {bits.device}, words on "
                         f"{dev}")
    if dev.type == "cpu":
        return unpack_codes_plain(words, bits, shape)
    return _unpack_launched(words, bits, shape, n)


def _unpack_launched(words: torch.Tensor, bits: torch.Tensor,
                     shape: Tuple[int, ...], n: int) -> torch.Tensor:
    """``unpack_codes`` through ``launch_unpack``: host checks that need
    no sync, the launch, then one 16-byte status read that raises for a
    bad stream."""
    global unpack_launches
    dev = words.device
    _check_int32_tensor("unpack_codes (words)", words, dev)
    _check_int32_tensor("unpack_codes (bits)", bits, dev)
    _check_size("unpack_codes", n)
    n_chunks, n_pad, _ = _chunk_layout(n, CHUNK)
    if bits.numel() != n_chunks:
        raise ValueError(
            f"bit-width table has {bits.numel()} chunks, expected "
            f"{n_chunks} for {n} codes at chunk={CHUNK}")
    if words.numel() > n_pad:
        raise ValueError(
            f"packed stream has {words.numel()} words, expected at most "
            f"{n_pad} (over-long device-pack blob)")
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if n_chunks == 0:
        return out
    scratch = torch.empty(scratch_size(n_chunks), dtype=torch.int64,
                          device=dev)
    launch_unpack(words, bits, out, scratch)
    unpack_launches += 1
    _check_status(words.numel(), *_read_meta(scratch))
    return out
