"""The preserve layer of the port: the artifact format, payload-magic
negotiation and the edit-value dtype policy, after
``repro.compress.preserve``.

``CompressedArtifact`` (version 4) has the reference's fields, so an
artifact moves between the packages as a plain dict
(``repro_torch.convert``) and each side decodes the other's. This slice
reads the ``szlike`` base only: ``SZJ2`` and ``SZP1`` payloads decode,
``SZJ1`` is refused with the reference's reason, and the format of the
unported codec (``ZFJ2``) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import _h2d
from . import codec

__all__ = [
    "ARTIFACT_VERSION", "CompressedArtifact", "payload_magic",
    "payload_codec", "check_artifact", "resolve_edit_dtype",
    "exact_edit_dtype", "encode_edits_checked_dev",
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


#: magic -> codec name of the formats the port reads
_READABLE = {b"SZJ2": "szlike", b"SZP1": "szlike"}

#: retired magics and why they must not be decoded (the reference's text)
_REFUSED = {
    b"SZJ1": (
        "SZJ1 blobs predate the shared host/device dequantization "
        "contract (f64-multiply-then-cast) and would silently "
        "reconstruct a different f_hat; re-compress with the current "
        "codec"),
    b"ZFJ1": (
        "ZFJ1 blobs record no field dtype and always decode to float32, "
        "so an f64 artifact would silently lose the precision its error "
        "bound was derived in; re-compress with the current codec"),
}

#: magics of formats the reference reads that the port does not yet
_NOT_PORTED = {
    b"ZFJ2": "zfplike (ROADMAP.md Queue 1: 'zfplike and the paper-mode "
             "loop')",
}


def payload_magic(payload: bytes) -> bytes:
    """The leading four bytes of a base payload (its format magic)."""
    if len(payload) < 4:
        raise ValueError(
            f"base payload too short for a magic: {len(payload)} bytes")
    return bytes(payload[:4])


def payload_codec(payload: bytes) -> str:
    """The name of the codec that reads ``payload``, from its magic.
    Retired magics raise their refusal; formats of unported codecs raise
    ``NotImplementedError``; unknown magics raise ``ValueError``."""
    magic = payload_magic(payload)
    if magic in _READABLE:
        return _READABLE[magic]
    if magic in _REFUSED:
        raise ValueError(
            f"refusing retired {magic.decode('ascii', 'replace')!r} "
            f"payload: {_REFUSED[magic]}")
    if magic in _NOT_PORTED:
        raise NotImplementedError(
            f"{magic.decode('ascii', 'replace')!r} payloads are not yet "
            f"ported: {_NOT_PORTED[magic]}")
    known = sorted(m.decode("ascii") for m in _READABLE)
    raise ValueError(
        f"unknown base payload magic {magic!r}; readable formats: {known}")


def check_artifact(art: CompressedArtifact) -> str:
    """Cross-check ``art.base`` against the payload's magic; returns the
    codec name. A mismatch raises instead of trusting either side."""
    name = payload_codec(art.base_payload)
    if art.base != name:
        if art.base == "zfplike":
            raise NotImplementedError(
                "base='zfplike' is not yet ported (ROADMAP.md Queue 1: "
                "'zfplike and the paper-mode loop')")
        raise ValueError(
            f"artifact records base={art.base!r} but its payload magic "
            f"{payload_magic(art.base_payload)!r} belongs to codec {name!r}")
    return name


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


def encode_edits_checked_dev(fj: torch.Tensor, f_hat: torch.Tensor,
                             idx: np.ndarray, val: np.ndarray, xi: float,
                             edit_value_dtype: str) -> bytes:
    """Encode the edits; a lossy edit dtype (bf16, or f4 on an f64
    field) is re-verified on DEVICE tensors after a decode round trip and
    falls back to the exact dtype when rounding breaks preservation or
    the bound — the reference's decision, so the bytes agree."""
    from ..core.driver import verify_preservation
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
