"""End-to-end MSz-corrected compression on one GPU, the PyTorch port of
``repro.compress.pipeline`` (the szlike device path).

compression:   f --quantize+Lorenzo--> r --reconstruct--> f_hat
               (f, f_hat) --fused fix loop--> g --> edits
               r --DEFLATE--> SZJ2 payload   (entropy="deflate")
               r --pack kernels--> SZP1 payload   (entropy="device-pack")
               edits --> MSE1 blob
decompression: payload --> r --reconstruct--> f_hat ; f_hat + edits --> g

``compress_preserving_mss`` makes one host->device copy of ``f``; the
transform, reconstruction, topology, fix loop and edit extraction stay
on the device. Under "deflate" one device->host copy of the int32
residual codes feeds host DEFLATE; under "device-pack" the codes are
packed on the device and only the packed words and the chunk widths
cross (the blob assembly is byte copying). The edits cross once and are
encoded on the host either way. ``decompress_preserving_mss`` decodes
an SZJ2 stream on the host and copies the codes up once; a device-path
SZP1 artifact instead ships its words and widths up and unpacks them on
the device. Reconstruction and the edit scatter run on the device, and
g comes down once. Artifacts and g are bitwise the reference's.

Arguments this slice does not serve raise ``NotImplementedError`` naming
the ROADMAP.md item that brings them; nothing is silently rerouted.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import fixes
from ..core.backend import BackendLike, resolve_backend
from ..core.driver import apply_edits, extract_edits
from ..device import DeviceLike, _d2h, _h2d, resolve_device, torch_dtype
from ..kernels.pack import CHUNK
from . import codec, preserve, szlike
from .preserve import CompressedArtifact

__all__ = ["CompressedArtifact", "compress_preserving_mss",
           "compress_preserving_mss_batch", "decompress_preserving_mss",
           "decompress_artifact", "decompress_artifact_batch",
           "overall_compression_ratio"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1: {item!r})")


def _device_dtype_ok(dtype) -> bool:
    """f32 always and f64 always: torch has no x64 switch."""
    return np.dtype(dtype) in (np.float32, np.float64)


def _device_path_reason(f: np.ndarray, xi: float
                        ) -> Tuple[Optional[str], Optional[float]]:
    """(None, step) when the device path can serve this szlike fused-mode
    call, else (why not, None). One field scan: max|f| feeds both the
    step headroom and the range check."""
    if f.ndim not in (2, 3) or f.size == 0:
        return (f"device path needs a non-empty 2D/3D field "
                f"(shape {f.shape})"), None
    if not _device_dtype_ok(f.dtype):
        return f"device path needs float32 or float64; got {f.dtype}", None
    amax = float(np.max(np.abs(f)))
    step = szlike.effective_step(f, xi, amax=amax)
    try:
        szlike.check_int32_range(f, step / 2.0, amax=amax)
    except ValueError as e:
        return str(e), None
    return None, step


def _check_served(base: str, xi: float, mode: str, mesh, device_path,
                  entropy: str) -> None:
    if base == "zfplike":
        raise _not_ported("codec='zfplike'", "zfplike and the paper-mode loop")
    if base != "szlike":
        raise ValueError(f"unknown base codec {base!r}")
    if not (np.isfinite(xi) and xi > 0):
        # the codec's own error, whichever path would have run
        raise szlike.error_bound_error(xi)
    if mode == "paper":
        raise _not_ported("mode='paper'", "zfplike and the paper-mode loop")
    if mode != "fused":
        raise ValueError(f"unknown mode {mode!r}")
    if mesh is not None:
        raise _not_ported("mesh=", "Multi-GPU sharded fix loop")
    if device_path is False:
        raise _not_ported("device_path=False (the host path)",
                          "Batched and worklist fix loops, host path")
    szlike.check_entropy(entropy)


class _Clock:
    """Stage seconds into ``timings`` (synchronizing the device first so
    each stage's own kernels are counted); a no-op when None."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings = timings
        self.device = device
        self.t = time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - self.t
        self.t = now


def _device_compress(f: np.ndarray, xi: float, be, max_iters: int,
                     edit_value_dtype: str, step: float, dev: torch.device,
                     entropy: str, timings: Optional[dict]
                     ) -> CompressedArtifact:
    """One h2d of f; transform, reconstruction, base-error check,
    topology, fused fix loop and edit extraction on the device; then the
    residual payload (one d2h of the codes for DEFLATE, or the packed
    stream for device-pack) and the edit blob."""
    clock = _Clock(timings, dev)
    t0 = time.perf_counter()
    fj = _h2d(f, dev)
    step_t = _h2d(np.asarray(step, f.dtype), dev)
    r = be.transform(fj, step_t)
    f_hat = be.reconstruct(r, step_t, fj.dtype)
    base_err = float(_d2h((fj - f_hat).abs().max()))
    t1 = time.perf_counter()
    clock.lap("transform")
    if base_err > xi * (1 + 1e-6):
        raise ValueError(
            f"reconstructed data violates the error bound before editing: "
            f"max|f-f_hat|={base_err:.3g} > xi={xi:.3g}")

    topo = fixes.field_topology(fj, xi)
    clock.lap("topology")
    g, iters, ok = fixes.fused_fix(f_hat, topo, max_iters=max_iters,
                                   backend=be)
    clock.lap("fix_loop")
    if not ok:
        raise RuntimeError("MSz fix loops did not converge within max_iters")
    idx_d, val_d = extract_edits(f_hat, g)
    del g, topo
    t2 = time.perf_counter()
    clock.lap("extraction")

    if entropy == "device-pack":
        # the stream length is one scalar sync inside pack_codes; the
        # int32 words carry the uint32 stream's bits (a view of a buffer
        # of the largest stream, freed here)
        words, bits, _ = be.pack_codes(r)
        payload = szlike.sz_encode_packed(_d2h(words).view(np.uint32),
                                          _d2h(bits), f.shape, f.dtype,
                                          step)
        del words, bits
    else:
        payload = szlike.sz_encode_residuals(_d2h(r), f.shape, f.dtype,
                                             step)
    clock.lap("entropy_residual")
    idx = _d2h(idx_d).astype(np.int64)
    val = _d2h(val_d)
    blob = preserve.encode_edits_checked_dev(fj, f_hat, idx, val, xi,
                                             edit_value_dtype)
    t3 = time.perf_counter()
    clock.lap("entropy_edits")
    return CompressedArtifact(
        base="szlike", base_payload=payload, edit_payload=blob,
        shape=f.shape, dtype=str(f.dtype), xi=xi,
        t_base=(t1 - t0) + (t3 - t2), t_fix=t2 - t1,
        edit_ratio=idx.size / f.size,
        fix_iters=iters, backend=be.name,
        path="device", t_transform=t1 - t0, entropy=entropy,
        base_magic=preserve.payload_magic(payload).decode("ascii"),
    )


def compress_preserving_mss(f: np.ndarray, xi: float, base: str = "szlike",
                            mode: str = "fused",
                            edit_value_dtype: str = "auto",
                            max_iters: int = 512,
                            backend: BackendLike = "auto",
                            mesh=None, device_path="auto",
                            entropy: str = "deflate",
                            codec: Optional[str] = None,
                            device: DeviceLike = None,
                            timings: Optional[dict] = None
                            ) -> CompressedArtifact:
    """Compress ``f`` (numpy, 2D/3D, float32/float64) with absolute bound
    ``xi`` so that decompression has exactly f's Morse-Smale
    segmentation. ``device=None`` runs on CUDA and raises without a GPU;
    ``backend`` picks the stencil backend ('auto': ``cuda`` on the GPU,
    ``reference`` on the CPU). ``entropy``: the residual codec,
    "deflate" (host DEFLATE, SZJ2) or "device-pack" (the chunked-bitplane
    pack kernels, SZP1). ``timings``: a dict that receives the seconds
    of each stage (transform, topology, fix_loop, extraction,
    entropy_residual, entropy_edits), measured with a device sync
    between stages.

    The reference's other options raise ``NotImplementedError`` here:
    ``codec="zfplike"``, ``mode="paper"``, ``mesh=`` and
    ``device_path=False``."""
    if codec is not None:
        base = codec
    _check_served(base, xi, mode, mesh, device_path, entropy)
    f = np.asarray(f)
    dev = resolve_device(device)
    reason, step = _device_path_reason(f, xi)
    if reason is not None:
        if device_path is True:
            raise ValueError(f"device_path=True but {reason}")
        raise _not_ported(f"the host path (needed because {reason})",
                          "Batched and worklist fix loops, host path")
    be = resolve_backend(backend, f.shape, torch_dtype(f.dtype), dev)
    return _device_compress(f, xi, be, max_iters, edit_value_dtype, step,
                            dev, entropy, timings)


def compress_preserving_mss_batch(*args, **kwargs):
    """Batched compression is not ported yet."""
    raise _not_ported("compress_preserving_mss_batch",
                      "Batched and worklist fix loops, host path")


def decompress_artifact(art: CompressedArtifact) -> np.ndarray:
    """Host-side decompression: magic-checked SZJ2 or SZP1 decode (the
    packer's numpy mirror) plus numpy edit application."""
    preserve.check_artifact(art)
    f_hat = szlike.sz_decompress(art.base_payload)
    if f_hat.dtype != np.dtype(art.dtype):
        raise ValueError(
            f"artifact records dtype {art.dtype} but the payload decodes "
            f"to {f_hat.dtype}")
    idx, val = codec.decode_edits(art.edit_payload)
    return apply_edits(f_hat, idx, val)


def _device_unpack_decompress(art: CompressedArtifact,
                              backend: BackendLike, dev: torch.device
                              ) -> Optional[np.ndarray]:
    """The read path with no host entropy decode of the codes, for
    device-path SZP1 artifacts: split the blob into (words, bits) on the
    host, one h2d of each, unpack -> reconstruct -> edit scatter on the
    device, one d2h of g. Device-path artifacts were range-checked at
    compress time. None for a chunk size other than ``CHUNK``, which the
    host decoder reads."""
    words, bits, shape, dtype, step, chunk = \
        szlike.sz_parse_packed(art.base_payload)
    if chunk != CHUNK:
        return None
    idx, val = codec.decode_edits(art.edit_payload)
    w_j = _h2d(words.view(np.int32), dev)
    b_j = _h2d(bits, dev)
    step_t = _h2d(np.asarray(step, dtype), dev)
    be = resolve_backend(backend, shape, step_t.dtype, dev)
    f_hat = be.reconstruct(be.unpack_codes(w_j, b_j, shape), step_t,
                           step_t.dtype)
    g = be.scatter_edits(f_hat, _h2d(idx, dev), _h2d(val, dev))
    return _d2h(g)


def decompress_preserving_mss(art: CompressedArtifact, device_path="auto",
                              backend: BackendLike = "auto", mesh=None,
                              device: DeviceLike = None) -> np.ndarray:
    """The read side: host-decode the entropy streams once, one h2d of
    the int32 residual codes, reconstruction and edit scatter-add on the
    device, one d2h of g. A device-path SZP1 artifact skips the host
    decode of the codes: its packed words go up and the unpack kernel
    runs on the device. Bitwise equal to ``decompress_artifact``.

    Artifacts whose codes overflow the int32 reconstruction (host-path
    artifacts of the reference) take ``decompress_artifact`` under
    ``device_path="auto"`` and raise under ``True``, as in the
    reference. ``device_path=False`` is ``decompress_artifact``."""
    if mesh is not None:
        raise _not_ported("mesh=", "Multi-GPU sharded fix loop")
    if device_path is False:
        return decompress_artifact(art)
    preserve.check_artifact(art)
    dev = resolve_device(device)
    if len(art.shape) not in (2, 3) or min(art.shape) == 0:
        reason = f"device decode needs a non-empty 2D/3D field ({art.shape})"
    elif not _device_dtype_ok(art.dtype):
        reason = f"device decode needs float32 or float64; got {art.dtype}"
    else:
        reason = None
    if reason is None and art.path == "device" \
            and szlike.sz_blob_entropy(art.base_payload) == "device-pack":
        g = _device_unpack_decompress(art, backend, dev)
        if g is not None:
            return g
    if reason is None:
        r, shape, dtype, step = szlike.sz_decode_residuals(art.base_payload)
        if art.path != "device" and not szlike.codes_fit_int32(r):
            reason = ("the artifact's residual codes overflow the int32 "
                      "cumsum reconstruction")
    if reason is not None:
        if device_path is True:
            raise ValueError(f"device_path=True but {reason}")
        return decompress_artifact(art)
    idx, val = codec.decode_edits(art.edit_payload)
    r_j = _h2d(np.asarray(r, np.int32), dev)
    step_t = _h2d(np.asarray(step, dtype), dev)
    be = resolve_backend(backend, shape, step_t.dtype, dev)
    f_hat = be.reconstruct(r_j, step_t, step_t.dtype)
    g = be.scatter_edits(f_hat, _h2d(idx, dev), _h2d(val, dev))
    return _d2h(g)


def decompress_artifact_batch(*args, **kwargs):
    """Batched decompression is not ported yet."""
    raise _not_ported("decompress_artifact_batch",
                      "Batched and worklist fix loops, host path")


def overall_compression_ratio(f: np.ndarray, art: CompressedArtifact
                              ) -> float:
    """OCR: original bytes / (base payload + edit payload)."""
    return f.nbytes / art.nbytes

