"""SZ-like error-bounded lossy compressor, the PyTorch port of
``repro.compress.szlike`` (dual quantization, as in cuSZ):

  1. linear-scaling quantization   q = round(f / step),  step = 2*xi_eff
  2. Lorenzo prediction in the integer domain: the residual is the d-D
     mixed first difference of q; the inverse is d nested int32 cumsums;
  3. residual entropy coding: int8 stream + int64 escapes, DEFLATE'd
     (``SZJ2``), or the chunked-bitplane stream of
     ``entropy="device-pack"`` (``SZP1``, ``repro_torch.kernels.pack``).

One arithmetic contract per dtype, shared with the reference: the
quotient, its rounding (half to even) and the dequantizing multiply run
in the FIELD'S dtype, with the step a scalar of that dtype; integer work
is exact (int64 on the host, int32 on the device, which requires
max|f|/xi < 2^28, and < 2^21 for f32 fields — ``check_int32_range``).

The host byte codecs below are numpy copies of the reference's, so equal
residual codes give equal bytes. The port reads and writes ``SZJ2``
(DEFLATE) and ``SZP1`` (device-pack) blobs; ``SZJ1`` is refused by
``compress.preserve``.
"""
from __future__ import annotations

import io
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import pack
# SZJ2: the dequantization arithmetic runs in the field's dtype. SZJ1
# blobs used f64-multiply-then-cast and are refused.
_MAGIC = b"SZJ2"
_MAGIC_PACK = b"SZP1"

#: residual entropy codecs of the format
ENTROPIES = ("deflate", "device-pack")

INT32_RANGE_LIMIT = 2.0 ** 28
F32_RANGE_LIMIT = 2.0 ** 21


class TruncatedStreamError(ValueError, struct.error, zlib.error):
    """A truncated SZJ2 residual stream. It is a ``ValueError`` like the
    port's other format errors, and what the reference raises for the
    same cut: ``struct.error`` when a chunk length is missing,
    ``zlib.error`` when a chunk is cut short. Callers written against
    either package catch it."""


def device_range_limit(dtype) -> float:
    """max|f|/xi ceiling of the device path for fields of ``dtype``."""
    return F32_RANGE_LIMIT if np.dtype(dtype) == np.float32 \
        else INT32_RANGE_LIMIT


def effective_step(f: np.ndarray, xi: float,
                   amax: Optional[float] = None) -> float:
    """The quantization step actually used for ``f`` at bound ``xi``:
    f32 fields reserve a 2^-22 max|f| headroom and use an f32-exact step
    (a copy of the reference's rule)."""
    f = np.asarray(f)
    if f.dtype == np.float32 and f.size:
        if amax is None:
            amax = float(np.max(np.abs(f)))
        xi = max(xi - amax * 2.0 ** -22, xi * 0.5)
    step = np.float64(2.0 * xi)
    if f.dtype == np.float32:
        step = np.float64(np.float32(step))
    return float(step)


def check_int32_range(f: np.ndarray, xi: float,
                      amax: Optional[float] = None) -> None:
    """Validate the device path's range precondition (max|f|/xi < 2^28,
    and < 2^21 for f32 fields); raises ValueError otherwise."""
    f = np.asarray(f)
    if f.size == 0:
        return
    if xi <= 0:
        raise ValueError(f"error bound must be positive, got xi={xi!r}")
    if amax is None:
        amax = float(np.max(np.abs(f)))
    limit = device_range_limit(f.dtype)
    if amax / xi >= limit:
        why = ("the f32 quantization quotient would exceed f32 rounding "
               "precision" if limit == F32_RANGE_LIMIT else
               "quantized codes would overflow the int32 cumsum "
               "reconstruction")
        raise ValueError(
            f"device path precondition violated: max|f|/xi = "
            f"{amax / xi:.3g} >= 2^{int(np.log2(limit))}; {why}. Use the "
            "host path (device_path=False) or a looser error bound.")


# ---------------------------------------------------------------------------
# torch device path
# ---------------------------------------------------------------------------

def sz_transform(f: torch.Tensor, step: torch.Tensor,
                 backend="auto") -> torch.Tensor:
    """quantize + integer Lorenzo -> int32 residual codes, through the
    backend's ``transform`` ('auto': the Lorenzo kernel on CUDA, plain
    torch on the CPU). ``step``: a 0-d tensor of f's dtype. Callers
    validate the range with ``check_int32_range`` on the host field."""
    from ..core.backend import resolve_backend
    return resolve_backend(backend, f.shape, f.dtype,
                           f.device).transform(f, step)


def int32_cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact int32 cumsum along ``axis`` (torch promotes int32 sums to
    int64 unless told otherwise)."""
    return torch.cumsum(x.to(torch.int32), dim=axis, dtype=torch.int32)


def sz_inverse(r: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """int32 residual codes -> reconstructed field in ``step``'s dtype:
    d nested int32 cumsums, then ``q.to(step.dtype) * step``."""
    q = r
    for ax in range(r.ndim):
        q = int32_cumsum(q, ax)
    return q.to(step.dtype) * step


# ---------------------------------------------------------------------------
# host byte codec (numpy copy of the reference's)
# ---------------------------------------------------------------------------

def _lorenzo_residual_np(q: np.ndarray) -> np.ndarray:
    if q.size == 0:
        return q
    r = q
    for ax in range(q.ndim):
        pad = np.zeros_like(np.take(r, [0], axis=ax))
        shifted = np.concatenate(
            [pad, np.take(r, range(r.shape[ax] - 1), axis=ax)], axis=ax)
        r = r - shifted
    return r


def _pack_residuals(r: np.ndarray) -> bytes:
    """int8 main stream with int64 escape side-channel, DEFLATE'd."""
    flat = r.reshape(-1).astype(np.int64)
    small = (flat >= -127) & (flat <= 127)
    main = np.where(small, flat, -128).astype(np.int8)
    esc_idx = np.flatnonzero(~small).astype(np.int64)
    esc_val = flat[esc_idx].astype(np.int64)
    payload = io.BytesIO()
    for chunk in (main.tobytes(), esc_idx.tobytes(), esc_val.tobytes()):
        comp = zlib.compress(chunk, 6)
        payload.write(struct.pack("<Q", len(comp)))
        payload.write(comp)
    return payload.getvalue()


def _unpack_residuals(buf: bytes, n: int) -> np.ndarray:
    view = memoryview(buf)
    parts = []
    off = 0
    for _ in range(3):
        if len(view) < off + 8:
            raise TruncatedStreamError("truncated SZ-like residual "
                                       "stream: a chunk length is missing")
        (ln,) = struct.unpack_from("<Q", view, off)
        off += 8
        if len(view) < off + ln:
            raise TruncatedStreamError(
                f"truncated SZ-like residual stream: chunk of {ln} bytes, "
                f"{len(view) - off} left")
        parts.append(zlib.decompress(view[off:off + ln]))
        off += ln
    main = np.frombuffer(parts[0], np.int8).astype(np.int64)
    esc_idx = np.frombuffer(parts[1], np.int64)
    esc_val = np.frombuffer(parts[2], np.int64)
    out = main.copy()
    if esc_idx.size:
        out[esc_idx] = esc_val
    return out[:n]


def check_entropy(entropy: str) -> None:
    """Validate a residual entropy codec name (``ENTROPIES``)."""
    if entropy not in ENTROPIES:
        raise ValueError(
            f"unknown entropy codec {entropy!r}; expected one of "
            f"{ENTROPIES}")


def _szlike_header(magic: bytes, shape: Tuple[int, ...], dtype,
                   step: float) -> bytes:
    dtype = np.dtype(dtype)
    ndim = len(shape)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    hdr = struct.pack("<4sBBdQ", magic, ndim,
                      0 if dtype == np.float32 else 1, float(step), size)
    return hdr + struct.pack(f"<{ndim}Q", *shape)


def sz_encode_residuals(r: np.ndarray, shape: Tuple[int, ...],
                        dtype, step: float, *,
                        entropy: str = "deflate") -> bytes:
    """Serialize Lorenzo residual codes into an SZ-like blob: SZJ2 for
    "deflate", SZP1 through the packer's numpy mirror for "device-pack"
    (equal codes give equal bytes on every path)."""
    check_entropy(entropy)
    if entropy == "device-pack":
        words, bits = pack.pack_codes_host(np.asarray(r))
        return sz_encode_packed(words, bits, shape, dtype, step)
    return _szlike_header(_MAGIC, shape, dtype, step) \
        + _pack_residuals(np.asarray(r))


def sz_encode_packed(words: np.ndarray, bits: np.ndarray,
                     shape: Tuple[int, ...], dtype, step: float, *,
                     chunk: Optional[int] = None) -> bytes:
    """Serialize an already-packed chunked-bitplane stream into the SZP1
    blob: the SZJ2-shaped header, then ``<IIQ`` (chunk size, chunk count,
    word count), one uint8 width per chunk, and the little-endian uint32
    words. Pure byte assembly."""
    if chunk is None:
        chunk = pack.CHUNK
    words = np.ascontiguousarray(np.asarray(words, np.uint32))
    bits = np.asarray(bits)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    n_chunks = -(-n // chunk) if n else 0
    if bits.size != n_chunks:
        raise ValueError(
            f"bit-width table has {bits.size} chunks, expected "
            f"{n_chunks} for shape {shape} at chunk={chunk}")
    sub = struct.pack("<IIQ", chunk, n_chunks, words.size)
    return _szlike_header(_MAGIC_PACK, shape, dtype, step) + sub \
        + bits.astype(np.uint8).tobytes() \
        + words.astype("<u4").tobytes()


def _parse_header(blob: bytes):
    hdr = struct.calcsize("<4sBBdQ")
    if len(blob) < hdr:
        raise ValueError(
            f"truncated SZ-like blob: {len(blob)} bytes, header needs {hdr}")
    magic, ndim, dt, step, size = struct.unpack_from("<4sBBdQ", blob, 0)
    off = hdr
    if len(blob) < off + 8 * ndim:
        raise ValueError(
            f"truncated SZ-like blob: {len(blob)} bytes, {ndim}-d header "
            f"needs {off + 8 * ndim}")
    shape = struct.unpack_from(f"<{ndim}Q", blob, off)
    return magic, tuple(int(s) for s in shape), \
        np.dtype(np.float32 if dt == 0 else np.float64), float(step), \
        int(size), off + 8 * ndim


def sz_blob_entropy(blob: bytes) -> str:
    """Which residual entropy codec an SZ-like blob carries ("deflate"
    or "device-pack"), from its magic alone."""
    magic = bytes(blob[:4])
    if magic == _MAGIC:
        return "deflate"
    if magic == _MAGIC_PACK:
        return "device-pack"
    raise ValueError("not an SZ-like blob")


def sz_parse_packed(blob: bytes
                    ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...],
                               np.dtype, float, int]:
    """Split an SZP1 blob into ``(words, bits, shape, dtype, step,
    chunk)`` without unpacking codes: ``words`` uint32, ``bits`` int32.
    The header's lengths are checked against ``len(blob)``: a truncated
    or over-long blob raises ``ValueError``."""
    magic, shape, dtype, step, size, off = _parse_header(blob)
    if magic != _MAGIC_PACK:
        raise ValueError("not a packed (SZP1) SZ-like blob")
    sub = struct.calcsize("<IIQ")
    if len(blob) < off + sub:
        raise ValueError(
            f"SZP1 blob is {len(blob)} bytes, too short for its "
            "pack sub-header (truncated blob)")
    chunk, n_chunks, n_words = struct.unpack_from("<IIQ", blob, off)
    off += sub
    expect_chunks = (-(-size // chunk) if size else 0) if chunk else -1
    if n_chunks != expect_chunks:
        raise ValueError(
            f"SZP1 header: {n_chunks} chunks inconsistent with "
            f"{size} codes at chunk={chunk}")
    end = off + n_chunks + 4 * n_words
    if end != len(blob):
        raise ValueError(
            f"SZP1 blob is {len(blob)} bytes, header demands {end} "
            "(truncated or over-long blob)")
    bits = np.frombuffer(blob, np.uint8, n_chunks, off).astype(np.int32)
    words = np.frombuffer(blob, "<u4", n_words, off + n_chunks)
    words = words.astype(np.uint32, copy=False)
    return words, bits, shape, dtype, step, int(chunk)


def error_bound_error(xi) -> ValueError:
    """The codec's error for a bound that is not positive (the
    reference's message)."""
    return ValueError(
        f"error bound must be positive for the SZ-like codec, got "
        f"xi={xi!r} (linear-scaling quantization has no lossless mode)")


def sz_compress(f: np.ndarray, xi: float, *,
                entropy: str = "deflate") -> bytes:
    """Host compression with absolute error bound xi: an SZJ2 blob, or
    SZP1 for ``entropy="device-pack"``."""
    f = np.asarray(f)
    if f.dtype not in (np.float32, np.float64):
        raise TypeError(f"float field expected, got {f.dtype}")
    if xi <= 0:
        raise error_bound_error(xi)
    step = effective_step(f, xi)
    if f.dtype == np.float32:
        q = np.round(f / np.float32(step)).astype(np.int64)
    else:
        q = np.round(f.astype(np.float64) / step).astype(np.int64)
    r = _lorenzo_residual_np(q)
    return sz_encode_residuals(r, f.shape, f.dtype, step, entropy=entropy)


def sz_decode_residuals(blob: bytes
                        ) -> Tuple[np.ndarray, Tuple[int, ...], np.dtype,
                                   float]:
    """Entropy-decode an SZ-like blob into ``(r, shape, dtype, step)``
    with r the int64 residual codes, without reconstructing. SZP1 blobs
    decode through the packer's numpy mirror."""
    magic, shape, dtype, step, size, off = _parse_header(blob)
    if magic == _MAGIC_PACK:
        words, bits, shape, dtype, step, chunk = sz_parse_packed(blob)
        r = pack.unpack_codes_host(words, bits, size, chunk) \
            .astype(np.int64).reshape(shape)
        return r, shape, dtype, step
    if magic != _MAGIC:
        raise ValueError("not an SZ-like blob")
    r = _unpack_residuals(blob[off:], size).reshape(shape)
    return r, shape, dtype, step


def codes_fit_int32(r: np.ndarray) -> bool:
    """Whether every intermediate of the d nested cumsums of ``r`` fits
    int32 (sum|r| < 2^31 proves it in one pass; else the exact int64
    sweep decides)."""
    q = np.asarray(r, np.int64)
    if q.size == 0:
        return True
    lim = np.int64(2 ** 31 - 1)
    total = float(np.sum(np.abs(q), dtype=np.float64))
    if total * (1 + 1e-6) < float(lim):
        return True
    for ax in range(q.ndim):
        q = np.cumsum(q, axis=ax, dtype=np.int64)
        if np.max(np.abs(q)) > lim:
            return False
    return True


def sz_decompress(blob: bytes) -> np.ndarray:
    """Host inverse of ``sz_compress`` (bitwise equal to the device
    ``sz_inverse`` of the same codes)."""
    r, shape, dtype, step = sz_decode_residuals(blob)
    q = r
    for ax in range(len(shape)):
        q = np.cumsum(q, axis=ax, dtype=np.int64)
    if dtype == np.float32:
        return q.astype(np.float32) * np.float32(step)
    return q.astype(np.float64) * step


def sz_roundtrip(f: np.ndarray, xi: float) -> Tuple[np.ndarray, int]:
    """Compress + decompress in one call on the host codec: (f_hat,
    compressed bytes), the benchmarks' convenience for the SZ-like
    base."""
    blob = sz_compress(f, xi)
    return sz_decompress(blob), len(blob)
