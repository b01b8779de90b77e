"""Lossless compression of MSz edits (paper Section 6.3), a numpy copy
of ``repro.compress.codec``'s ``MSE1`` format.

Each edit is a (vertex index, float value) pair. Indices are sorted
ascending, delta-encoded, LEB128-varint-packed and DEFLATE'd; values are
stored as f32, f64 (the exact dtype for f64 fields) or bf16 (rounded to
nearest even) and DEFLATE'd separately. Truncated or over-long blobs are
hard errors. Equal edits give equal bytes on both packages.

A batch of blobs decodes on a thread pool (``iter_decode_blobs``,
``decode_edits_batch``): DEFLATE releases the GIL.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_MAGIC = b"MSE1"


def _varint_encode(a: np.ndarray) -> bytes:
    """LEB128 varint pack of a non-negative int64 array (vectorized)."""
    if a.size == 0:
        return b""
    a = a.astype(np.uint64)
    # max 10 bytes each; build columns of 7-bit groups
    cols = []
    rest = a.copy()
    more = np.ones(a.shape, bool)
    out_bytes = []
    while more.any():
        b7 = (rest & np.uint64(0x7F)).astype(np.uint8)
        rest = rest >> np.uint64(7)
        cont = (rest != 0) & more
        byte = np.where(cont, b7 | np.uint8(0x80), b7)
        out_bytes.append((byte, more.copy()))
        more = cont
    # interleave per-element in order
    n = a.size
    parts = []
    arr = np.zeros((len(out_bytes), n), np.uint8)
    mask = np.zeros((len(out_bytes), n), bool)
    for i, (byte, m) in enumerate(out_bytes):
        arr[i] = byte
        mask[i] = m
    flat = arr.T[mask.T]  # bytes of element 0, element 1, ... in order
    return flat.tobytes()


def _varint_decode(buf: bytes, count: int) -> np.ndarray:
    """Vectorized LEB128 decode (numpy scan — the former per-byte Python
    loop cost O(stream bytes) interpreter time, seconds on million-edit
    blobs). Value boundaries come from the continuation bits; each byte's
    7-bit group is shifted by 7x its position within its value and the
    groups are summed per value with one ``np.add.reduceat``.

    The stream must hold EXACTLY ``count`` values: a short stream is
    truncation, and trailing bytes beyond value ``count`` mean the
    caller's framing disagrees with the payload — both are corruption,
    and both raise instead of decoding what happens to fit (the old
    behavior, which let a mis-framed blob decode to plausible-looking
    indices)."""
    if count == 0:
        if len(buf):
            raise ValueError(
                f"varint stream carries {len(buf)} bytes but 0 values "
                "were promised")
        return np.zeros(0, np.int64)
    data = np.frombuffer(buf, np.uint8)
    ends = np.flatnonzero((data & 0x80) == 0)      # last byte of each value
    if ends.size < count:
        raise ValueError(
            f"truncated varint stream: {ends.size} terminated values, "
            f"expected {count}")
    if ends.size > count or int(ends[-1]) != data.size - 1:
        raise ValueError(
            f"over-long varint stream: {ends.size} terminated values and "
            f"{data.size - 1 - int(ends[-1])} dangling bytes, expected "
            f"exactly {count} values")
    starts = np.empty(count, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    n_bytes = int(ends[-1]) + 1
    data = data[:n_bytes]
    owner = np.zeros(n_bytes, np.int64)                 # value of each byte
    owner[1:] = np.cumsum((data[:-1] & 0x80) == 0)      # exclusive end scan
    pos = (np.arange(n_bytes) - starts[owner]).astype(np.uint64)
    contrib = (data & np.uint8(0x7F)).astype(np.uint64) << (np.uint64(7) * pos)
    return np.add.reduceat(contrib, starts).astype(np.int64)


def _f32_to_bf16(val: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (top 16 bits) with IEEE round-to-nearest-even.

    The former ``(v32 + 0x8000) >> 16`` rounded halfway cases away from
    zero (a systematic up-bias on tie points like 1.0 + 2^-8), promoted
    NaNs with small payloads to Inf (the +0x8000 carry rippled into the
    exponent), and wrapped sign-bit-set NaNs to +0 via uint32 overflow.
    RNE adds ``0x7FFF + lsb-of-result`` instead (carry in uint64 so it
    cannot wrap), and non-finite values bypass rounding entirely: Inf
    truncates to Inf, NaN truncates with the quiet bit forced so a
    payload living only in the dropped low mantissa bits cannot decay
    to Inf."""
    v32 = val.view(np.uint32).astype(np.uint64)
    bias = np.uint64(0x7FFF) + ((v32 >> np.uint64(16)) & np.uint64(1))
    rounded = ((v32 + bias) >> np.uint64(16)).astype(np.uint16)
    top = (v32 >> np.uint64(16)).astype(np.uint16)
    special = (v32 & np.uint64(0x7F800000)) == np.uint64(0x7F800000)
    is_nan = special & ((v32 & np.uint64(0x007FFFFF)) != 0)
    return np.where(special,
                    np.where(is_nan, top | np.uint16(0x0040), top),
                    rounded)


def encode_edits(idx: np.ndarray, val: np.ndarray, value_dtype="f4") -> bytes:
    """Pack sorted edit indices + values. value_dtype: 'f4', 'f8', or
    'bf16' ('f8' stores full f64 deltas — the exact dtype for f64
    fields, where an f32-rounded delta could perturb a tie-break).

    Unsorted indices are sorted (order carries no information); DUPLICATE
    indices are a hard error. One vertex never receives two edits — the
    fix loop produces one delta per vertex — so a duplicate means the
    caller's edit extraction is broken, and the delta coding + the
    decompression scatter would otherwise mask it (re-sorting used to
    swallow duplicates silently; ``apply_edits`` would then drop or
    double-apply them depending on the path)."""
    if value_dtype not in ("f4", "f8", "bf16"):
        raise ValueError(
            f"unknown edit value_dtype {value_dtype!r}; expected "
            "'f4', 'f8', or 'bf16'")
    idx = np.asarray(idx, np.int64)
    val = np.asarray(val, np.float64 if value_dtype == "f8" else np.float32)
    if idx.size != val.size:
        raise ValueError("idx/val length mismatch")
    if idx.size and np.any(np.diff(idx) <= 0):
        order = np.argsort(idx, kind="stable")
        idx, val = idx[order], val[order]
        if np.any(np.diff(idx) == 0):
            dup = int(idx[np.flatnonzero(np.diff(idx) == 0)[0]])
            raise ValueError(
                f"duplicate edit index {dup}: edits must target each vertex "
                "at most once (broken upstream edit extraction?)")
    deltas = np.diff(idx, prepend=np.int64(0))
    key_stream = zlib.compress(_varint_encode(deltas), 9)
    if value_dtype == "bf16":
        vb = _f32_to_bf16(val)
        val_stream = zlib.compress(vb.tobytes(), 9)
        dt = 1
    elif value_dtype == "f8":
        val_stream = zlib.compress(val.tobytes(), 9)
        dt = 2
    else:
        val_stream = zlib.compress(val.tobytes(), 9)
        dt = 0
    hdr = struct.pack("<4sBQQQ", _MAGIC, dt, idx.size,
                      len(key_stream), len(val_stream))
    return hdr + key_stream + val_stream


def decode_edits(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of ``encode_edits``: (sorted int64 indices, values) of
    one edit blob — f32 values for the 'f4'/'bf16' codings (bf16 widens
    back to f32), f64 for 'f8'.

    The header's stream lengths are validated against ``len(blob)``
    before any slice: Python slicing silently clips, so a truncated
    blob used to flow into ``zlib.decompress`` (surfacing, at best, as
    a confusing zlib error — or decoding a prefix that happens to be
    well-formed), and trailing garbage after the promised streams was
    silently ignored. Both now raise ``ValueError`` here."""
    hdr = struct.calcsize("<4sBQQQ")
    if len(blob) < hdr:
        raise ValueError(
            f"truncated edit blob: {len(blob)} bytes, header needs {hdr}")
    magic, dt, n, lk, lv = struct.unpack_from("<4sBQQQ", blob, 0)
    if magic != _MAGIC:
        raise ValueError("not an MSz edit blob")
    if len(blob) != hdr + lk + lv:
        raise ValueError(
            f"edit blob length mismatch: header promises {hdr + lk + lv} "
            f"bytes ({lk} key + {lv} value), got {len(blob)}")
    off = hdr
    keys = zlib.decompress(blob[off:off + lk]); off += lk
    vals = zlib.decompress(blob[off:off + lv])
    deltas = _varint_decode(keys, n)
    idx = np.cumsum(deltas, dtype=np.int64)
    if dt == 1:
        if len(vals) != 2 * n:
            raise ValueError(
                f"edit value stream decodes to {len(vals)} bytes, "
                f"expected {2 * n} (bf16 x {n})")
        v16 = np.frombuffer(vals, np.uint16).astype(np.uint32) << 16
        val = v16.view(np.float32)
    elif dt == 2:
        if len(vals) != 8 * n:
            raise ValueError(
                f"edit value stream decodes to {len(vals)} bytes, "
                f"expected {8 * n} (f64 x {n})")
        val = np.frombuffer(vals, np.float64)
    elif dt == 0:
        if len(vals) != 4 * n:
            raise ValueError(
                f"edit value stream decodes to {len(vals)} bytes, "
                f"expected {4 * n} (f32 x {n})")
        val = np.frombuffer(vals, np.float32)
    else:
        raise ValueError(f"unknown edit value dtype code {dt}")
    return idx, val.copy()


def iter_decode_blobs(decode, blobs, max_workers: Optional[int] = None,
                      window: Optional[int] = None):
    """Lazily yield ``decode(blob)`` results in blob order from a thread
    pool of ``max_workers`` (default: one a core, at most one a blob).
    At most ``window`` (default 2x workers) decodes are in flight or
    undelivered, so resident memory stays O(window) decoded blobs
    however large the batch. Single-element (or empty) batches skip the
    pool."""
    n = len(blobs)
    if n <= 1:
        for b in blobs:
            yield decode(b)
        return
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    workers = max_workers or min(n, os.cpu_count() or 1)
    window = window or 2 * workers
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = deque()
        i = 0
        while i < n or pending:
            while i < n and len(pending) < window:
                pending.append(ex.submit(decode, blobs[i]))
                i += 1
            yield pending.popleft().result()


def decode_blobs_parallel(decode, blobs, max_workers: Optional[int] = None):
    """Eager form of ``iter_decode_blobs``: the full result list."""
    return list(iter_decode_blobs(decode, blobs, max_workers))


def decode_edits_batch(blobs, fill_idx: Optional[int] = None):
    """Decode many edit blobs in one call.

    With ``fill_idx=None`` returns the list of per-blob ``(idx, val)``
    pairs. With ``fill_idx`` set (the field size) returns the dense
    layout ``(idx_b, val_b, counts)``: (B, L) arrays padded to the
    longest member, indices with ``fill_idx`` and values with 0, and
    each member's true edit count. The widest value dtype wins (an
    f8-coded blob promotes the batch to f64). Padding keeps every row
    sorted ascending; a consumer scatters ``idx_b[i, :counts[i]]``.
    """
    pairs = decode_blobs_parallel(decode_edits, blobs)
    if fill_idx is None:
        return pairs
    B = len(pairs)
    L = max((i.size for i, _ in pairs), default=0)
    idx_b = np.full((B, L), np.int64(fill_idx), np.int64)
    vdt = np.result_type(np.float32, *(v.dtype for _, v in pairs)) \
        if pairs else np.dtype(np.float32)
    val_b = np.zeros((B, L), vdt)
    counts = np.zeros(B, np.int64)
    for i, (idx, val) in enumerate(pairs):
        idx_b[i, :idx.size] = idx
        val_b[i, :idx.size] = val
        counts[i] = idx.size
    return idx_b, val_b, counts


# --- lossless baselines (the paper's Table 2 GZIP / ZSTD columns) ----------

def gzip_like(data: np.ndarray) -> int:
    """DEFLATE level 6 ~ gzip default; returns compressed size in bytes."""
    return len(zlib.compress(np.asarray(data).tobytes(), 6))


def zstd_like(data: np.ndarray) -> int:
    """Stronger LZ backend as the ZSTD stand-in (lzma preset 1); returns
    compressed size in bytes."""
    import lzma
    return len(lzma.compress(np.asarray(data).tobytes(), preset=1))


def lossless_bytes(data: np.ndarray, codec: str = "gzip") -> int:
    """Compressed byte size of ``data`` under the named lossless baseline
    codec: "gzip" (``gzip_like``), anything else ``zstd_like``."""
    return gzip_like(data) if codec == "gzip" else zstd_like(data)
