"""The preserve layer of the port, after ``repro.compress.preserve``:
the artifact format, the ``PreservingCodec`` registry and payload-magic
negotiation, the edit-value dtype policy with its checked encoders, and
the codec-agnostic host correction path (``compress_host``,
``compress_host_batch``).

``CompressedArtifact`` (version 4) has the reference's fields, so an
artifact moves between the packages as a plain dict
(``repro_torch.convert``) and each side decodes the other's. The
registry holds ``szlike`` (``SZJ2`` and ``SZP1`` payloads decode,
``SZJ1`` is refused) and ``zfplike`` (``ZFJ2`` decodes, ``ZFJ1`` is
refused), each refusal with the reference's reason.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..core.driver import (MszResult, apply_edits, derive_edits,
                           derive_edits_batch, verify_preservation)
from ..device import DeviceLike, _h2d
from . import codec, szlike, zfplike

__all__ = [
    "ARTIFACT_VERSION", "CompressedArtifact", "PreservingCodec",
    "register_preserving_codec", "get_preserving_codec",
    "available_preserving_codecs", "payload_magic", "payload_codec",
    "check_artifact", "decode_payload", "resolve_edit_dtype",
    "exact_edit_dtype", "encode_edits_checked", "encode_edits_checked_dev",
    "compress_host", "compress_host_batch",
]

#: v4: ``base_magic`` records the payload's leading four bytes
ARTIFACT_VERSION = 4


@dataclasses.dataclass
class CompressedArtifact:
    """One MSS-preserving compression result: the base codec's payload
    plus the MSz edit blob, with the metadata both read paths need."""
    base: str
    base_payload: bytes
    edit_payload: bytes
    shape: tuple
    dtype: str
    xi: float
    t_base: float = 0.0          # base compressor seconds (t_comp)
    t_fix: float = 0.0           # MSz fix seconds (t_fix)
    edit_ratio: float = 0.0
    fix_iters: int = 0
    backend: str = ""            # stencil backend that ran the fix loop
    version: int = ARTIFACT_VERSION
    path: str = "host"           # "host" | "device"
    t_transform: float = 0.0     # device quantize+Lorenzo+reconstruct secs
    entropy: str = "deflate"     # "deflate" | "device-pack"
    base_magic: str = ""         # the payload's leading magic (ascii)

    @property
    def nbytes(self) -> int:
        """Total compressed bytes: base payload + edit blob."""
        return len(self.base_payload) + len(self.edit_payload)


@dataclasses.dataclass(frozen=True)
class PreservingCodec:
    """The contract a base codec signs to be topology-corrected:
    ``compress(f, xi) -> payload`` and ``decompress(payload) -> f_hat``
    in the field's dtype with ``max|f - f_hat| <= xi``; ``magics`` are
    the leading four bytes of every blob format it reads; ``refused``
    maps retired magics to the reason they must not be decoded;
    ``device_transform`` marks a codec whose transform the stencil
    backends also run on the device."""
    name: str
    compress: Callable[..., bytes]
    decompress: Callable[[bytes], np.ndarray]
    magics: Tuple[bytes, ...]
    refused: Mapping[bytes, str] = dataclasses.field(default_factory=dict)
    device_transform: bool = False


_REGISTRY: Dict[str, PreservingCodec] = {}


def register_preserving_codec(pc: PreservingCodec) -> PreservingCodec:
    """Register ``pc`` under its name (later registrations win); returns
    ``pc``."""
    if not pc.magics:
        raise ValueError(f"codec {pc.name!r} declares no payload magics")
    for m in tuple(pc.magics) + tuple(pc.refused):
        if len(m) != 4:
            raise ValueError(
                f"codec {pc.name!r}: payload magic {m!r} must be 4 bytes")
    _REGISTRY[pc.name] = pc
    return pc


def get_preserving_codec(name: str) -> PreservingCodec:
    """A registered codec by name; an unknown name raises ``KeyError``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown preserving codec {name!r}; registered: "
            f"{available_preserving_codecs()}") from None


def available_preserving_codecs() -> Tuple[str, ...]:
    """Names of the registered preserving codecs, sorted."""
    return tuple(sorted(_REGISTRY))


register_preserving_codec(PreservingCodec(
    name="szlike",
    compress=szlike.sz_compress,
    decompress=szlike.sz_decompress,
    magics=(b"SZJ2", b"SZP1"),
    refused={b"SZJ1": (
        "SZJ1 blobs predate the shared host/device dequantization "
        "contract (f64-multiply-then-cast) and would silently "
        "reconstruct a different f_hat; re-compress with the current "
        "codec")},
    device_transform=True,
))

register_preserving_codec(PreservingCodec(
    name="zfplike",
    compress=zfplike.zfp_compress,
    decompress=zfplike.zfp_decompress,
    magics=(b"ZFJ2",),
    refused={b"ZFJ1": (
        "ZFJ1 blobs record no field dtype and always decode to float32, "
        "so an f64 artifact would silently lose the precision its error "
        "bound was derived in; re-compress with the current codec")},
))


def payload_magic(payload: bytes) -> bytes:
    """The leading four bytes of a base payload (its format magic)."""
    if len(payload) < 4:
        raise ValueError(
            f"base payload too short for a magic: {len(payload)} bytes")
    return bytes(payload[:4])


def payload_codec(payload: bytes) -> PreservingCodec:
    """The codec that reads ``payload``, from its magic. Retired magics
    raise their codec's refusal; unknown magics raise ``ValueError``."""
    magic = payload_magic(payload)
    for pc in _REGISTRY.values():
        if magic in pc.magics:
            return pc
        if magic in pc.refused:
            raise ValueError(
                f"refusing retired {magic.decode('ascii', 'replace')!r} "
                f"payload: {pc.refused[magic]}")
    known = sorted(m.decode("ascii", "replace")
                   for pc in _REGISTRY.values() for m in pc.magics)
    raise ValueError(
        f"unknown base payload magic {magic!r}; readable formats: {known}")


def check_artifact(art: CompressedArtifact) -> PreservingCodec:
    """Cross-check ``art.base`` against the payload's magic and return
    the codec that reads it; a mismatch raises instead of trusting
    either side."""
    pc = get_preserving_codec(art.base)
    magic = payload_magic(art.base_payload)
    if magic not in pc.magics:
        sniffed = payload_codec(art.base_payload)   # raises on retired/unknown
        raise ValueError(
            f"artifact records base={art.base!r} but its payload magic "
            f"{magic!r} belongs to codec {sniffed.name!r}")
    return pc


def decode_payload(art: CompressedArtifact) -> np.ndarray:
    """Magic-negotiated host decode of an artifact's base payload:
    ``f_hat`` in the artifact's recorded dtype (a disagreement with the
    payload raises)."""
    pc = check_artifact(art)
    f_hat = pc.decompress(art.base_payload)
    if f_hat.dtype != np.dtype(art.dtype):
        raise ValueError(
            f"artifact records dtype {art.dtype} but the {pc.name!r} "
            f"payload decodes to {f_hat.dtype}")
    return f_hat


#: edit-value storage dtypes the pipeline accepts
EDIT_VALUE_DTYPES = ("auto", "f4", "f8", "bf16")


def exact_edit_dtype(field_dtype) -> str:
    """The edit-value storage dtype that round-trips the field's deltas
    bit-exactly: "f8" for f64 fields, "f4" otherwise."""
    if isinstance(field_dtype, torch.dtype):
        return "f8" if field_dtype == torch.float64 else "f4"
    return "f8" if np.dtype(field_dtype) == np.float64 else "f4"


def resolve_edit_dtype(edit_value_dtype: str, field_dtype) -> str:
    """"auto" becomes the field's exact dtype; explicit names pass
    through (unknown names raise)."""
    if edit_value_dtype not in EDIT_VALUE_DTYPES:
        raise ValueError(
            f"unknown edit_value_dtype {edit_value_dtype!r}; expected one "
            f"of {EDIT_VALUE_DTYPES}")
    if edit_value_dtype == "auto":
        return exact_edit_dtype(field_dtype)
    return edit_value_dtype


def encode_edits_checked(f: np.ndarray, f_hat: np.ndarray, res: MszResult,
                         xi: float, edit_value_dtype: str,
                         device: DeviceLike = None) -> bytes:
    """Encode the edits of ``res``; a lossy edit dtype (bf16, or f4 on
    an f64 field) is re-verified after a decode round trip (the edits
    applied on the host, the check on ``device``) and falls back to the
    exact dtype when rounding breaks preservation or the bound."""
    evd = resolve_edit_dtype(edit_value_dtype, f.dtype)
    blob = codec.encode_edits(res.edits_idx, res.edits_val, evd)
    if evd != exact_edit_dtype(f.dtype):
        idx2, val2 = codec.decode_edits(blob)
        g2 = apply_edits(f_hat, idx2, val2)
        v = verify_preservation(f, g2, xi, device=device)
        if not (v["mss_preserved"] and v["bound_ok"]):
            blob = codec.encode_edits(res.edits_idx, res.edits_val,
                                      exact_edit_dtype(f.dtype))
    return blob


def encode_edits_checked_dev(fj: torch.Tensor, f_hat: torch.Tensor,
                             idx: np.ndarray, val: np.ndarray, xi: float,
                             edit_value_dtype: str) -> bytes:
    """Device-path twin of ``encode_edits_checked``: the re-verification
    runs on DEVICE tensors with the same predicate, so both paths make
    the same fallback decision and the bytes agree."""
    evd = resolve_edit_dtype(edit_value_dtype, f_hat.dtype)
    blob = codec.encode_edits(idx, val, evd)
    if evd != exact_edit_dtype(f_hat.dtype):
        idx2, val2 = codec.decode_edits(blob)
        delta2 = torch.zeros(f_hat.numel(), dtype=f_hat.dtype,
                             device=f_hat.device)
        delta2.index_add_(0, _h2d(idx2, f_hat.device),
                          _h2d(val2, f_hat.device).to(f_hat.dtype))
        v = verify_preservation(fj, f_hat + delta2.reshape(f_hat.shape), xi)
        if not (v["mss_preserved"] and v["bound_ok"]):
            blob = codec.encode_edits(idx, val, exact_edit_dtype(f_hat.dtype))
    return blob


def _make_artifact(f: np.ndarray, payload: bytes, blob: bytes, xi: float,
                   base: str, res: MszResult, t_base: float,
                   t_fix: float) -> CompressedArtifact:
    return CompressedArtifact(
        base=base, base_payload=payload, edit_payload=blob,
        shape=f.shape, dtype=str(f.dtype), xi=xi,
        t_base=t_base, t_fix=t_fix,
        edit_ratio=res.edit_ratio, fix_iters=res.iters,
        backend=res.backend,
        base_magic=payload_magic(payload).decode("ascii", "replace"),
    )


def compress_host(name: str, f: np.ndarray, xi: float, *,
                  compressor: Callable[..., bytes] = None,
                  mode: str = "fused", edit_value_dtype: str = "auto",
                  max_iters: int = 512, backend="auto", mesh=None,
                  device: DeviceLike = None) -> CompressedArtifact:
    """The codec-agnostic host compression path: base round trip on the
    host through the registered codec ``name`` (or ``compressor``, a
    pre-bound variant of it), the fix loop (``core.driver.derive_edits``
    on ``device``), checked edit encoding, one artifact format."""
    pc = get_preserving_codec(name)
    f = np.asarray(f)
    comp = compressor if compressor is not None else pc.compress
    t0 = time.perf_counter()
    payload = comp(f, xi)
    f_hat = pc.decompress(payload)
    t1 = time.perf_counter()
    res = derive_edits(f, f_hat, xi, mode=mode, max_iters=max_iters,
                       backend=backend, mesh=mesh, device=device)
    if not res.converged:
        raise RuntimeError("MSz fix loops did not converge within max_iters")
    t2 = time.perf_counter()
    blob = encode_edits_checked(f, f_hat, res, xi, edit_value_dtype,
                                device=device)
    return _make_artifact(f, payload, blob, xi, pc.name, res, t1 - t0,
                          t2 - t1)


def compress_host_batch(name: str, fields: List[np.ndarray],
                        xi_arr: np.ndarray, *,
                        compressor: Callable[..., bytes] = None,
                        edit_value_dtype: str = "auto",
                        max_iters: int = 512, backend="auto", mesh=None,
                        device: DeviceLike = None
                        ) -> List[CompressedArtifact]:
    """Batch form of ``compress_host``: per-member base round trips on
    the host, then one batched fix loop over the stacked members
    (``core.driver.derive_edits_batch``). Each artifact is bitwise a
    solo ``compress_host`` call's; t_fix is the batch's split evenly."""
    pc = get_preserving_codec(name)
    comp = compressor if compressor is not None else pc.compress
    payloads, fhats, t_bases = [], [], []
    for fi, xi_i in zip(fields, xi_arr):
        t0 = time.perf_counter()
        payload = comp(fi, float(xi_i))
        fhats.append(pc.decompress(payload))
        t_bases.append(time.perf_counter() - t0)
        payloads.append(payload)

    t0 = time.perf_counter()
    results = derive_edits_batch(np.stack(fields), np.stack(fhats), xi_arr,
                                 max_iters=max_iters, backend=backend,
                                 mesh=mesh, device=device)
    t_fix_each = (time.perf_counter() - t0) / max(len(fields), 1)

    arts = []
    for fi, xi_i, payload, f_hat, res, t_base in zip(
            fields, xi_arr, payloads, fhats, results, t_bases):
        if not res.converged:
            raise RuntimeError(
                "MSz fix loops did not converge within max_iters")
        blob = encode_edits_checked(fi, f_hat, res, float(xi_i),
                                    edit_value_dtype, device=device)
        arts.append(_make_artifact(fi, payload, blob, float(xi_i), pc.name,
                                   res, t_base, t_fix_each))
    return arts
