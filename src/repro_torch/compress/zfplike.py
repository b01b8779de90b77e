"""ZFP-like error-bounded transform compressor (the paper's 'base
compressor #2' baseline), the port of ``repro.compress.zfplike``: a host
codec in numpy, byte for byte the reference's.

Follows ZFP's structure (Lindstrom 2014):
  * partition into 4^d blocks (edge blocks padded by replication),
  * per-block block-floating-point: align to the block's max exponent,
  * ZFP's exact integer lifting transform along each dimension
    (the non-orthogonal decorrelating transform from the reference codec),
  * error-bounded bit-plane truncation: drop the b lowest bit planes where
    b is the largest value keeping `gain * 2^b * scale <= xi` and `gain`
    is the numerically-computed Linf amplification of the inverse
    transform — this gives a hard absolute error bound like ZFP's
    fixed-accuracy mode,
  * DEFLATE over the truncated coefficient planes (stand-in for ZFP's
    embedded group-testing coder; ratios are conservative but the
    bound/size tradeoff shape matches).
"""
from __future__ import annotations

import functools
import struct
import zlib
from typing import Tuple

import numpy as np

# ZFJ2: the header records the field dtype and decompression returns it
# (f64 fields reconstruct in f64 — no final f32 cast). ZFJ1 blobs record
# no dtype and always decode to float32, silently losing the precision
# an f64 bound was derived in — refuse them.
_MAGIC = b"ZFJ2"
_MAGIC_OLD = b"ZFJ1"
_BITS = 26  # fixed-point fraction bits for block-floating-point
_DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.float64)}


def _fwd_lift_np(x: np.ndarray, axis: int) -> np.ndarray:
    """ZFP's forward integer lifting on groups of 4 along `axis` (exact)."""
    x = np.moveaxis(x, axis, -1)
    s = x.shape
    v = x.reshape(-1, 4).astype(np.int64)
    a, b, c, d = v[:, 0].copy(), v[:, 1].copy(), v[:, 2].copy(), v[:, 3].copy()
    # reference codec lifting steps
    a += d; a >>= 1; d -= a
    c += b; c >>= 1; b -= c
    a += c; a >>= 1; c -= a
    d += b; d >>= 1; b -= d
    d += b >> 1; b -= d >> 1
    out = np.stack([a, b, c, d], axis=1).reshape(s)
    return np.moveaxis(out, -1, axis)


def _inv_lift_np(x: np.ndarray, axis: int) -> np.ndarray:
    x = np.moveaxis(x, axis, -1)
    s = x.shape
    v = x.reshape(-1, 4).astype(np.int64)
    a, b, c, d = v[:, 0].copy(), v[:, 1].copy(), v[:, 2].copy(), v[:, 3].copy()
    b += d >> 1; d -= b >> 1
    b += d; d <<= 1; d -= b
    c += a; a <<= 1; a -= c
    b += c; c <<= 1; c -= b
    d += a; a <<= 1; a -= d
    out = np.stack([a, b, c, d], axis=1).reshape(s)
    return np.moveaxis(out, -1, axis)


@functools.lru_cache(maxsize=4)
def _inverse_gain(ndim: int) -> float:
    """Linf->Linf gain of the inverse transform: max over outputs of the
    L1 row norm of the inverse matrix (worst case: every coefficient
    perturbed by +/-1 LSB with adversarial signs). Built by probing the
    exact integer lifting with unit impulses at high scale."""
    shape = (4,) * ndim
    scale = 1 << 20
    n = 4 ** ndim
    rowsum = np.zeros(shape, np.float64)
    for i in range(n):
        e = np.zeros(n, np.int64)
        e[i] = scale
        e = e.reshape(shape)
        for ax in range(ndim):
            e = _inv_lift_np(e, ax)
        rowsum += np.abs(e).astype(np.float64) / scale
    return float(np.max(rowsum))


@functools.lru_cache(maxsize=4)
def _lift_slack(ndim: int) -> float:
    """Max |inv(fwd(x)) - x| in LSBs: the forward lifting's >>1 steps drop
    low bits, so the pair is near- but not bit-exact; measure the slack."""
    rng = np.random.default_rng(0)
    shape = (4,) * ndim
    worst = 0.0
    for _ in range(64):
        x = rng.integers(-(1 << 24), 1 << 24, size=shape).astype(np.int64)
        y = x
        for ax in range(ndim):
            y = _fwd_lift_np(y, ax)
        for ax in range(ndim - 1, -1, -1):
            y = _inv_lift_np(y, ax)
        worst = max(worst, float(np.max(np.abs(y - x))))
    return worst


def _blockify(f: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Pad to multiples of 4 (edge replication) and reshape to blocks:
    returns (nblocks, 4^d) int-indexable view and padded shape."""
    pads = [(0, (-s) % 4) for s in f.shape]
    fp = np.pad(f, pads, mode="edge")
    if f.ndim == 2:
        H, W = fp.shape
        blocks = fp.reshape(H // 4, 4, W // 4, 4).transpose(0, 2, 1, 3).reshape(-1, 4, 4)
    else:
        D, H, W = fp.shape
        blocks = (fp.reshape(D // 4, 4, H // 4, 4, W // 4, 4)
                  .transpose(0, 2, 4, 1, 3, 5).reshape(-1, 4, 4, 4))
    return blocks, fp.shape


def _unblockify(blocks: np.ndarray, padded_shape, orig_shape) -> np.ndarray:
    if len(orig_shape) == 2:
        H, W = padded_shape
        f = (blocks.reshape(H // 4, W // 4, 4, 4).transpose(0, 2, 1, 3)
             .reshape(H, W))
    else:
        D, H, W = padded_shape
        f = (blocks.reshape(D // 4, H // 4, W // 4, 4, 4, 4)
             .transpose(0, 3, 1, 4, 2, 5).reshape(D, H, W))
    return f[tuple(slice(0, s) for s in orig_shape)]


def zfp_compress(f: np.ndarray, xi: float) -> bytes:
    """ZFP-like fixed-accuracy compression of a 2D/3D field to one
    blob: 4^d block transform, per-block bit-plane truncation against
    the error bound ``xi``, then DEFLATE.

    ``xi = 0`` is permitted (maximum coded precision, b = 0 everywhere)
    but guaranteed only for fields the block transform round-trips
    exactly; the per-dtype floor below which the bound is unreachable is
    ~``amax * 2^-23`` for f32 fields (BFP quantization + the output
    cast) and ~``amax * 2^-25`` for f64 (the ``_BITS``-bit BFP mantissa
    alone). The preserving pipeline's derivation re-checks the bound and
    raises when a blob misses it."""
    f = np.asarray(f)
    if f.ndim not in (2, 3):
        raise ValueError("zfp-like supports 2D/3D fields")
    if xi < 0:
        raise ValueError(f"error bound must be non-negative, got xi={xi!r}")
    dt_codes = {v: k for k, v in _DTYPES.items()}
    if f.dtype not in dt_codes:
        raise TypeError(f"float field expected, got {f.dtype}")
    dt = dt_codes[f.dtype]
    # reserve headroom for the final f32 cast: the cast costs at most half
    # an ulp of the cast value, |f_hat| <= amax + xi, so the cast error is
    # <= (amax + xi) * 2^-24 — the f64 guarantee then holds inclusive of
    # output rounding. (Below xi ~ amax * 2^-23 the bound is unreachable
    # in f32 regardless of headroom: BFP quantization + the cast alone
    # exceed it; the xi*0.5 floor keeps the transform well-posed there.)
    # f64 output needs no headroom: reconstruction stays in f64 end to end.
    if f.dtype == np.float32 and f.size:
        amax = float(np.max(np.abs(f)))
        xi = max(xi - (amax + xi) * 2.0 ** -24, xi * 0.5)
    if f.size == 0:                  # empty field: header only, no blocks
        hdr = struct.pack("<4sBBdQ", _MAGIC, f.ndim, dt, float(xi), 0)
        dims = struct.pack(f"<{f.ndim}Q", *f.shape)
        return hdr + dims + struct.pack("<QQ", 0, 0)
    blocks, padded = _blockify(f.astype(np.float64))
    nb = blocks.shape[0]
    flat = blocks.reshape(nb, -1)

    # block-floating-point: shared exponent per block
    amax = np.max(np.abs(flat), axis=1)
    e = np.where(amax > 0, np.ceil(np.log2(np.maximum(amax, 1e-300))), 0.0)
    scale = np.exp2(e - _BITS)                       # LSB value per block
    ints = np.round(flat / scale[:, None]).astype(np.int64)

    blk = ints.reshape(blocks.shape)
    for ax in range(1, blocks.ndim):
        blk = _fwd_lift_np(blk, ax)
    coeff = blk.reshape(nb, -1)

    # error-bounded plane truncation: fixed-point error <= 0.5*scale, the
    # integer lifting round-trip slack <= _LIFT_SLACK LSB; truncation error
    # after inverse <= gain * 2^b * scale  ==> choose the largest valid b.
    gain = _inverse_gain(f.ndim)
    slack = _lift_slack(f.ndim)
    margin = xi - (0.5 + slack) * scale             # room for BFP+lift error
    with np.errstate(divide="ignore", invalid="ignore"):
        b = np.floor(np.log2(np.maximum(margin, 0.0) / (gain * scale) + 1e-300))
    b = np.clip(np.where(margin > 0, b, 0), 0, _BITS + 8).astype(np.int64)
    # rounded truncation (error <= 2^(b-1) < 2^b, consistent with the bound)
    q = (coeff + (np.int64(1) << b[:, None] >> 1)) >> b[:, None]

    # serialize: per-block exponent (f16-safe int16), plane shift b (uint8),
    # then the shifted coefficients as int32 (DEFLATE squeezes the slack).
    if np.any(np.abs(q) >= 2**31):
        raise OverflowError("coefficient overflow; xi too small for range")
    stream = zlib.compress(q.astype(np.int32).tobytes(), 6)
    meta = zlib.compress(
        e.astype(np.int16).tobytes() + b.astype(np.uint8).tobytes(), 6)
    hdr = struct.pack("<4sBBdQ", _MAGIC, f.ndim, dt, float(xi), nb)
    dims = struct.pack(f"<{f.ndim}Q", *f.shape)
    return (hdr + dims + struct.pack("<QQ", len(meta), len(stream))
            + meta + stream)


def zfp_decompress(blob: bytes) -> np.ndarray:
    """Inverse of ``zfp_compress``: f_hat with max|f - f_hat| <= xi, in
    the dtype the blob records. Retired ZFJ1 blobs are refused (they
    carry no dtype and were always decoded as f32) — never misdecoded."""
    if bytes(blob[:4]) == _MAGIC_OLD:
        raise ValueError(
            "refusing retired 'ZFJ1' payload: ZFJ1 blobs record no field "
            "dtype and always decode to float32; re-compress with the "
            "current codec")
    magic, ndim, dt, xi, nb = struct.unpack_from("<4sBBdQ", blob, 0)
    if magic != _MAGIC:
        raise ValueError("not a ZFP-like blob")
    if dt not in _DTYPES:
        raise ValueError(f"unknown ZFP-like dtype code {dt}")
    out_dtype = _DTYPES[dt]
    off = struct.calcsize("<4sBBdQ")
    shape = struct.unpack_from(f"<{ndim}Q", blob, off)
    off += 8 * ndim
    lm, ls = struct.unpack_from("<QQ", blob, off)
    off += 16
    if nb == 0:                     # empty field: no blocks were coded
        return np.zeros(shape, out_dtype)
    meta = zlib.decompress(blob[off:off + lm]); off += lm
    stream = zlib.decompress(blob[off:off + ls])
    e = np.frombuffer(meta[:2 * nb], np.int16).astype(np.float64)
    b = np.frombuffer(meta[2 * nb:], np.uint8).astype(np.int64)
    q = np.frombuffer(stream, np.int32).astype(np.int64).reshape(nb, -1)
    coeff = q << b[:, None]
    bs = (4,) * ndim
    blk = coeff.reshape((nb,) + bs)
    for ax in range(ndim, 0, -1):
        blk = _inv_lift_np(blk, ax)
    scale = np.exp2(e - _BITS)
    flat = blk.reshape(nb, -1).astype(np.float64) * scale[:, None]
    padded = tuple(s + ((-s) % 4) for s in shape)
    return _unblockify(flat.reshape((nb,) + bs), padded, shape) \
        .astype(out_dtype)


def zfp_roundtrip(f: np.ndarray, xi: float) -> Tuple[np.ndarray, int]:
    """Compress + decompress in one call: (f_hat, compressed bytes) —
    the bench/test convenience for the ZFP-like base."""
    blob = zfp_compress(f, xi)
    return zfp_decompress(blob), len(blob)
