"""End-to-end MSz-corrected compression on one GPU, the PyTorch port of
``repro.compress.pipeline``.

compression:   f --quantize+Lorenzo--> r --reconstruct--> f_hat
               (f, f_hat) --fused fix loop--> g --> edits
               r --DEFLATE--> SZJ2 payload   (entropy="deflate")
               r --pack kernels--> SZP1 payload   (entropy="device-pack")
               edits --> MSE1 blob
decompression: payload --> r --reconstruct--> f_hat ; f_hat + edits --> g

Two paths give byte-identical artifacts:

* **device** (szlike, fused mode, a non-empty 2D/3D float32/float64
  field whose codes fit the int32 reconstruction): one host->device
  copy of ``f``; the transform, reconstruction, topology, fix loop and
  edit extraction stay on the device. Under "deflate" one
  device->host copy of the int32 residual codes feeds host DEFLATE;
  under "device-pack" the codes are packed on the device and only the
  packed words and the chunk widths cross. The edits cross once and are
  encoded on the host either way.
* **host** (``device_path=False``, or "auto" when the device path's
  preconditions fail: the ``zfplike`` codec, ``mode="paper"``, a field
  outside the int32 range): the base codec round trip on the host
  (``preserve.compress_host``), the fix loop still on the resolved
  device.

``compress_preserving_mss_batch`` runs many same-shape fields through
one h2d of the stacked fields, the transform once a member, and one
batched fix loop (``fixes.fused_fix_batch``); only entropy coding runs
per member on the host. ``_device_pipelined_stage`` is the stream
scheduler's alternative: one h2d and one transform for the batch, then
a solo fix loop a member.

``decompress_preserving_mss`` decodes an SZJ2 stream on the host and
copies the codes up once; a device-path SZP1 artifact instead ships its
words and widths up and unpacks them on the device. Reconstruction and
the edit scatter run on the device, and g comes down once.
``decompress_artifact_batch`` does the same for many same-shape
artifacts (threaded host inflate, one d2h of the stacked g). Artifacts
and g are bitwise the reference's.

``mesh=`` (a ``repro_torch.launch.mesh`` device mesh) runs the
transform, the fix loop, the reconstruction and the edit scatter on the
mesh's blocks through the ``sharded`` backend, and the pack kernels on
the global code array; artifacts and g stay byte for byte the solo
path's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

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
           "overall_compression_ratio", "overall_bit_rate", "psnr"]


def _device_dtype_ok(dtype) -> bool:
    """f32 always and f64 always: torch has no x64 switch."""
    return np.dtype(dtype) in (np.float32, np.float64)


def _device_path_reason(f: np.ndarray, xi: float, base: str = "szlike",
                        mode: str = "fused"
                        ) -> Tuple[Optional[str], Optional[float]]:
    """(None, step) when the device path can serve this call (the szlike
    codec in fused mode), else (why not, None). One field scan: max|f|
    feeds both the step headroom and the range check."""
    if base != "szlike":
        return (f"device path serves the szlike base only (got {base!r}); "
                "zfplike's block transform stays host-side"), None
    if mode != "fused":
        return f"device path requires mode='fused' (got {mode!r})", None
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


def _check_base_entropy(base: str, entropy: str) -> None:
    """Validate the (base, entropy) pair: the residual entropy codec
    choice exists for the szlike residual stream only."""
    szlike.check_entropy(entropy)
    if entropy != "deflate" and base != "szlike":
        raise ValueError(
            f"entropy={entropy!r} applies to the szlike base only "
            f"(got base={base!r})")


def _check_served(base: str, xi, mode: str, entropy: str) -> None:
    """Raise for an unknown codec or mode, for an entropy codec the base
    has not, and szlike's own error for a
    bound (or any of a sequence of bounds) that is not finite and
    positive, whichever path would have run. zfplike checks its bound
    itself (``xi = 0`` is allowed there)."""
    if base not in ("szlike", "zfplike"):
        raise ValueError(f"unknown base codec {base!r}")
    if base == "szlike":
        for x in np.atleast_1d(np.asarray(xi, np.float64)).reshape(-1):
            if not (np.isfinite(x) and x > 0):
                raise szlike.error_bound_error(xi if np.ndim(xi) == 0
                                               else float(x))
    if mode not in ("fused", "paper"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_base_entropy(base, entropy)


def _host_compressor(base: str, entropy: str) -> Optional[Callable]:
    """The szlike compressor with ``entropy`` bound in, for the host
    path, or None for the registered default (the decoders dispatch on
    the blob magic)."""
    if base == "szlike" and entropy != "deflate":
        return functools.partial(szlike.sz_compress, entropy=entropy)
    return None


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


@dataclasses.dataclass
class _DeviceBatch:
    """The finished device stage of one compress batch: everything up
    to and including the d2h of the residual codes (or their packed
    streams under device-pack) and of each member's edits has run; what
    remains per member is host entropy coding (``_encode_batch_member``),
    which touches the device only to re-verify a lossy edit dtype. So
    the stream's worker threads, which run it, wait on no kernel the
    scheduler queued for the next batch."""
    fields: List[np.ndarray]
    xi_arr: np.ndarray
    steps: List[float]
    f_b: torch.Tensor             # device originals (lossy-edit re-verify)
    fhat_b: torch.Tensor          # device reconstructions
    r_host: Optional[np.ndarray]  # residual codes on the host (DEFLATE)
    edits: List[Tuple[np.ndarray, np.ndarray]]  # host (idx int64, val)
    iters_b: np.ndarray
    backend_name: str
    t_transform_each: float
    t_fix_each: float
    t_pull_each: float
    nbytes_h2d: int = 0           # array bytes crossed host->device
    nbytes_d2h: int = 0           # array bytes crossed device->host
    entropy: str = "deflate"
    # device-pack batches carry per-member (words, bits) instead of
    # r_host; _encode_batch_member then only assembles bytes
    packed: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None


def _batch_transform(fields: List[np.ndarray], xi_arr: np.ndarray, be,
                     steps: List[float], n_check: int, dev: torch.device):
    """One h2d of the stacked fields and steps, the transform and
    reconstruction of each member, and the pre-edit bound check of the
    first ``n_check`` members (one d2h of their errors). Returns
    (f_stack, f_b, step_b, r_b, fhat_b, base_errs)."""
    B = len(fields)
    f_stack = np.stack(fields)
    f_b = _h2d(f_stack, dev)
    step_b = _h2d(np.asarray(steps, fields[0].dtype), dev)
    r_b = torch.stack([be.transform(f_b[i], step_b[i]) for i in range(B)])
    fhat_b = torch.stack([be.reconstruct(r_b[i], step_b[i], f_b.dtype)
                          for i in range(B)])
    sp = tuple(range(1, f_b.ndim))
    base_errs = _d2h((f_b - fhat_b).abs().amax(dim=sp))
    for i in range(n_check):
        if base_errs[i] > xi_arr[i] * (1 + 1e-6):
            raise ValueError(
                f"batch member {i}: reconstructed data violates the error "
                f"bound before editing: max|f-f_hat|={base_errs[i]:.3g} > "
                f"xi={xi_arr[i]:.3g}")
    return f_stack, f_b, step_b, r_b, fhat_b, base_errs


def _pull_packed(be, r: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """One member's codes packed on the device, then (words as uint32,
    widths) on the host."""
    words, bits, _ = be.pack_codes(r)
    return _d2h(words).view(np.uint32), _d2h(bits)


def _pull_batch_codes(be, r_b: torch.Tensor, entropy: str):
    """The batch's residual-code d2h: each member's packed stream under
    device-pack, else the stacked codes for host DEFLATE. Returns
    (r_host, packed, nbytes)."""
    if entropy == "device-pack":
        packed = [_pull_packed(be, r) for r in r_b]
        return None, packed, sum(w.nbytes + b.nbytes for w, b in packed)
    r_host = _d2h(r_b)
    return r_host, None, r_host.nbytes


def _pull_edits(edits_d: List[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int]:
    """Each member's device (idx, val) on the host, idx as int64; and
    the bytes that crossed."""
    edits = [(_d2h(i).astype(np.int64), _d2h(v)) for i, v in edits_d]
    nbytes = sum(i.nbytes // 2 + v.nbytes for i, v in edits)
    return edits, nbytes


def _device_batch_stage(fields: List[np.ndarray], xi_arr: np.ndarray,
                        be, max_iters: int, steps: List[float],
                        dev: torch.device, entropy: str = "deflate"
                        ) -> _DeviceBatch:
    """The device half of a compress batch: one h2d of the stacked
    fields, the transform a member, one batched fix loop, edit
    extraction on the device, then the d2h of the codes and of the
    edits. ``steps`` come checked from the caller's
    ``_device_path_reason`` sweep."""
    B = len(fields)
    t0 = time.perf_counter()
    f_stack, f_b, step_b, r_b, fhat_b, base_errs = _batch_transform(
        fields, xi_arr, be, steps, B, dev)
    t1 = time.perf_counter()

    # mszlint: disable=transfer-discipline -- xi_arr is the host bounds
    topos = [fixes.field_topology(f_b[i], float(xi_arr[i]))
             for i in range(B)]
    topo_b = fixes.FieldTopo(*(torch.stack(leaves)
                               for leaves in zip(*topos)))
    del topos
    g_b, iters_b, ok_b = fixes.fused_fix_batch(fhat_b, topo_b,
                                               max_iters=max_iters,
                                               backend=be)
    del topo_b
    if not _d2h(ok_b.all()):
        raise RuntimeError("MSz fix loops did not converge within max_iters")
    edits_d = [extract_edits(fhat_b[i], g_b[i]) for i in range(B)]
    del g_b
    t2 = time.perf_counter()

    r_host, packed, nbytes_codes = _pull_batch_codes(be, r_b, entropy)
    edits, nbytes_edits = _pull_edits(edits_d)
    t_pull = time.perf_counter() - t2
    return _DeviceBatch(
        fields=fields, xi_arr=xi_arr, steps=steps,
        f_b=f_b, fhat_b=fhat_b, r_host=r_host, edits=edits,
        iters_b=_d2h(iters_b), backend_name=be.name,
        t_transform_each=(t1 - t0) / B, t_fix_each=(t2 - t1) / B,
        t_pull_each=t_pull / B,
        nbytes_h2d=f_stack.nbytes + step_b.numel() * step_b.element_size(),
        nbytes_d2h=nbytes_codes + nbytes_edits + base_errs.nbytes,
        entropy=entropy, packed=packed,
    )


def _device_pipelined_stage(fields: List[np.ndarray], xi_arr: np.ndarray,
                            be, max_iters: int, steps: List[float],
                            dev: torch.device, n_real: Optional[int] = None,
                            entropy: str = "deflate") -> _DeviceBatch:
    """The stream scheduler's alternative to ``_device_batch_stage``: one
    h2d and one transform of the batch, then a solo ``fixes.fused_fix``
    a member (each member stops at its own convergence; the solo loop
    takes the worklist where its policy says so), so each g is the
    one-shot call's. ``n_real``: members beyond it are batch padding,
    transformed but never fixed."""
    B = len(fields)
    n_real = B if n_real is None else n_real
    t0 = time.perf_counter()
    f_stack, f_b, step_b, r_b, fhat_b, base_errs = _batch_transform(
        fields, xi_arr, be, steps, n_real, dev)
    t1 = time.perf_counter()

    edits_d = []
    iters_list: List[int] = []
    for i in range(n_real):
        # mszlint: disable=transfer-discipline -- xi_arr is the host bounds
        topo = fixes.field_topology(f_b[i], float(xi_arr[i]))
        g, iters, ok = fixes.fused_fix(fhat_b[i], topo, max_iters=max_iters,
                                       backend=be)
        if not ok:
            raise RuntimeError(
                "MSz fix loops did not converge within max_iters")
        edits_d.append(extract_edits(fhat_b[i], g))
        iters_list.append(iters)
        del g, topo
    t2 = time.perf_counter()

    r_host, packed, nbytes_codes = _pull_batch_codes(be, r_b, entropy)
    edits, nbytes_edits = _pull_edits(edits_d)
    t_pull = time.perf_counter() - t2
    empty = (np.zeros(0, np.int64), np.zeros(0, fields[0].dtype))
    return _DeviceBatch(
        fields=fields, xi_arr=xi_arr, steps=steps,
        f_b=f_b, fhat_b=fhat_b, r_host=r_host,
        edits=edits + [empty] * (B - n_real),
        # mszlint: disable=transfer-discipline -- iters_list is python ints
        iters_b=np.asarray(iters_list + [0] * (B - n_real), np.int32),
        backend_name=be.name,
        t_transform_each=(t1 - t0) / B,
        t_fix_each=(t2 - t1) / max(n_real, 1),
        t_pull_each=t_pull / B,
        nbytes_h2d=f_stack.nbytes + step_b.numel() * step_b.element_size(),
        nbytes_d2h=nbytes_codes + nbytes_edits + base_errs.nbytes,
        entropy=entropy, packed=packed,
    )


def _encode_batch_member(db: _DeviceBatch, i: int,
                         edit_value_dtype: str) -> CompressedArtifact:
    """The host tail of one batch member: its residual payload (DEFLATE,
    or byte assembly of its packed stream) and its checked edit blob."""
    fi = db.fields[i]
    te0 = time.perf_counter()
    if db.packed is not None:
        words, bits = db.packed[i]
        payload = szlike.sz_encode_packed(words, bits, fi.shape, fi.dtype,
                                          db.steps[i])
    else:
        payload = szlike.sz_encode_residuals(db.r_host[i], fi.shape,
                                             fi.dtype, db.steps[i])
    idx, val = db.edits[i]
    xi = float(db.xi_arr[i])  # mszlint: disable=transfer-discipline -- host
    blob = preserve.encode_edits_checked_dev(db.f_b[i], db.fhat_b[i], idx,
                                             val, xi, edit_value_dtype)
    t_entropy = time.perf_counter() - te0
    return CompressedArtifact(
        base="szlike", base_payload=payload, edit_payload=blob,
        shape=fi.shape, dtype=str(fi.dtype), xi=xi,
        t_base=db.t_transform_each + db.t_pull_each + t_entropy,
        t_fix=db.t_fix_each,
        edit_ratio=float(idx.size) / float(fi.size),
        # mszlint: disable=transfer-discipline -- iters_b came through _d2h
        fix_iters=int(db.iters_b[i]), backend=db.backend_name,
        path="device", t_transform=db.t_transform_each,
        entropy=db.entropy,
        base_magic=preserve.payload_magic(payload).decode("ascii"),
    )


def _device_compress_batch(fields: List[np.ndarray], xi_arr: np.ndarray,
                           be, max_iters: int, edit_value_dtype: str,
                           steps: List[float], dev: torch.device,
                           entropy: str = "deflate"
                           ) -> List[CompressedArtifact]:
    """The device batch: ``_device_batch_stage``, then each member's
    host tail. Each artifact is bitwise a solo device-path call's."""
    db = _device_batch_stage(fields, xi_arr, be, max_iters, steps, dev,
                             entropy=entropy)
    return [_encode_batch_member(db, i, edit_value_dtype)
            for i in range(len(fields))]


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
    """Compress ``f`` (numpy, float32/float64) with absolute bound ``xi``
    so that decompression has exactly f's Morse-Smale segmentation.
    ``codec`` (an alias that overrides ``base``): "szlike" or
    "zfplike"; ``mode``: "fused" or "paper" (the paper's C/R loops).
    ``device=None`` runs on CUDA and raises without a GPU; ``backend``
    picks the stencil backend ('auto': ``cuda`` on the GPU,
    ``reference`` on the CPU). ``entropy``: the residual codec,
    "deflate" (host DEFLATE, SZJ2) or "device-pack" (the chunked-bitplane
    pack kernels on the device path, SZP1). ``device_path``: "auto"
    takes the device path whenever its preconditions hold and the host
    path otherwise, True raises where they fail, False takes the host
    path. ``timings``: a dict that receives the seconds of each device
    path stage (transform, topology, fix_loop, extraction,
    entropy_residual, entropy_edits), measured with a device sync
    between stages. zfplike and paper mode take the host path (under
    ``device_path=True`` they raise the reference's ``ValueError``).
    ``mesh``: a device mesh whose >= 2 data-axis blocks carry the
    transform and the fix loop (the sharded backend); the bytes do not
    change."""
    if codec is not None:
        base = codec
    _check_served(base, xi, mode, entropy)
    f = np.asarray(f)
    dev = resolve_device(device)
    if device_path is not False:
        reason, step = _device_path_reason(f, xi, base, mode)
        if reason is None:
            be = fixes._bind(resolve_backend(
                backend, f.shape, torch_dtype(f.dtype), dev, mesh=mesh))
            return _device_compress(f, xi, be, max_iters, edit_value_dtype,
                                    step, dev, entropy, timings)
        if device_path is True:
            raise ValueError(f"device_path=True but {reason}")
    art = preserve.compress_host(
        base, f, xi, compressor=_host_compressor(base, entropy), mode=mode,
        edit_value_dtype=edit_value_dtype, max_iters=max_iters,
        backend=backend, mesh=mesh, device=dev)
    art.entropy = entropy
    return art


def compress_preserving_mss_batch(
        fields: Union[np.ndarray, Sequence[np.ndarray]],
        xi: Union[float, Sequence[float]],
        base: str = "szlike",
        edit_value_dtype: str = "auto",
        max_iters: int = 512,
        backend: BackendLike = "auto",
        mesh=None,
        device_path="auto",
        entropy: str = "deflate",
        codec: Optional[str] = None,
        device: DeviceLike = None) -> List[CompressedArtifact]:
    """``compress_preserving_mss`` for many same-shape fields, with one
    bound for all or one a member. On the device path: one h2d of the
    stacked fields, the transform of each member, one batched fix loop,
    then per-member entropy coding on the host (byte assembly only under
    device-pack). When any member fails the device path's preconditions
    under "auto", or under ``device_path=False``, the batch takes the
    host path (``preserve.compress_host_batch``), which still shares one
    batched fix loop. Each artifact is bitwise a solo
    ``compress_preserving_mss`` call's; t_base / t_fix split the batch's
    time evenly."""
    if codec is not None:
        base = codec
    fields = [np.asarray(fi) for fi in fields]
    _check_served(base, xi, "fused", entropy)
    if not fields:
        return []
    if any(fi.shape != fields[0].shape for fi in fields):
        raise ValueError("batch members must share one shape; got "
                         f"{[fi.shape for fi in fields]}")
    B = len(fields)
    xi_arr = np.broadcast_to(np.asarray(xi, np.float64), (B,))
    dev = resolve_device(device)

    use_dev, steps = False, []
    if device_path is not False:
        reasons = [_device_path_reason(fi, float(xi_i), base)
                   for fi, xi_i in zip(fields, xi_arr)]
        use_dev = all(r is None for r, _ in reasons)
        steps = [s for _, s in reasons]
        if device_path is True and not use_dev:
            bad = next(r for r, _ in reasons if r is not None)
            raise ValueError(f"device_path=True but {bad}")
    if use_dev:
        be = fixes._bind(resolve_backend(backend, fields[0].shape,
                                         torch_dtype(fields[0].dtype), dev,
                                         mesh=mesh))
        return _device_compress_batch(fields, xi_arr, be, max_iters,
                                      edit_value_dtype, steps, dev,
                                      entropy=entropy)
    arts = preserve.compress_host_batch(
        base, fields, xi_arr, compressor=_host_compressor(base, entropy),
        edit_value_dtype=edit_value_dtype, max_iters=max_iters,
        backend=backend, mesh=mesh, device=dev)
    for art in arts:
        art.entropy = entropy
    return arts


def decompress_artifact(art: CompressedArtifact) -> np.ndarray:
    """Host-side decompression: magic-negotiated SZJ2 or SZP1 decode
    (``preserve.decode_payload``; the packer's numpy mirror for SZP1)
    plus numpy edit application."""
    f_hat = preserve.decode_payload(art)
    idx, val = codec.decode_edits(art.edit_payload)
    return apply_edits(f_hat, idx, val)


def _device_decode_reason(art: CompressedArtifact) -> Optional[str]:
    """None when the device decode can serve ``art`` on metadata grounds
    (the code-range check runs after the entropy decode), else why not."""
    if art.base != "szlike":
        return (f"device decode serves the szlike base only (got "
                f"{art.base!r}); zfplike's block transform stays host-side")
    if len(art.shape) not in (2, 3) or min(art.shape) == 0:
        return f"device decode needs a non-empty 2D/3D field ({art.shape})"
    if not _device_dtype_ok(art.dtype):
        return f"device decode needs float32 or float64; got {art.dtype}"
    return None


def _codes_reason(art: CompressedArtifact, r: np.ndarray) -> Optional[str]:
    """Why decoded codes cannot take the int32 reconstruction, or None.
    Device-path artifacts were range-checked at compress time."""
    if art.path != "device" and not szlike.codes_fit_int32(r):
        return ("the artifact's residual codes overflow the int32 cumsum "
                "reconstruction")
    return None


def _is_device_pack(art: CompressedArtifact) -> bool:
    return (art.path == "device"
            and szlike.sz_blob_entropy(art.base_payload) == "device-pack")


def _decode_backend(backend: BackendLike, shape, dtype, mesh,
                    dev: torch.device):
    """The stencil backend of a decode call, with the mesh (passed or
    active) bound in."""
    return fixes._bind(resolve_backend(backend, shape, torch_dtype(dtype),
                                       dev, mesh=mesh))


def _device_unpack_decompress(art: CompressedArtifact,
                              backend: BackendLike, mesh, dev: torch.device
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
    be = _decode_backend(backend, shape, dtype, mesh, dev)
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
    artifacts) take ``decompress_artifact`` under ``device_path="auto"``
    and raise under ``True``, as in the reference. ``device_path=False``
    is ``decompress_artifact``. ``mesh`` runs the reconstruction and the
    scatter on the mesh's blocks."""
    if device_path is False:
        return decompress_artifact(art)
    preserve.check_artifact(art)
    dev = resolve_device(device)
    reason = _device_decode_reason(art)
    if reason is None and _is_device_pack(art):
        g = _device_unpack_decompress(art, backend, mesh, dev)
        if g is not None:
            return g
    if reason is None:
        r, shape, dtype, step = szlike.sz_decode_residuals(art.base_payload)
        reason = _codes_reason(art, r)
    if reason is not None:
        if device_path is True:
            raise ValueError(f"device_path=True but {reason}")
        return decompress_artifact(art)
    idx, val = codec.decode_edits(art.edit_payload)
    r_j = _h2d(np.asarray(r, np.int32), dev)
    step_t = _h2d(np.asarray(step, dtype), dev)
    be = _decode_backend(backend, shape, dtype, mesh, dev)
    f_hat = be.reconstruct(r_j, step_t, step_t.dtype)
    g = be.scatter_edits(f_hat, _h2d(idx, dev), _h2d(val, dev))
    return _d2h(g)


def decompress_artifact_batch(arts: Sequence[CompressedArtifact],
                              device_path="auto",
                              backend: BackendLike = "auto", mesh=None,
                              device: DeviceLike = None) -> List[np.ndarray]:
    """Decompress many same-shape szlike artifacts: the edit blobs
    decode on host threads into one padded (B, L) layout that crosses
    once; the residual streams inflate on host threads while each
    decoded member's codes cross and reconstruct + scatter its edits
    (``counts[i]`` of them; torch's scatter raises on the padding's
    out-of-range index) on the device; one d2h of the stacked g. An
    all-device-pack batch of device-path artifacts ships each member's
    packed words instead and unpacks them on the device. Each g is
    bitwise a solo ``decompress_preserving_mss`` call's.

    Mixed batches (shapes, dtypes or bases) and ``device_path=False``
    decompress member by member; a batch the device cannot serve (a
    member's codes overflow the int32 reconstruction, say) falls back
    to ``decompress_artifact`` under "auto" and raises under True.
    ``mesh`` serves each member's reconstruction and scatter on the
    mesh's blocks."""
    arts = list(arts)
    if not arts:
        return []
    a0 = arts[0]
    uniform = all(a.base == a0.base and tuple(a.shape) == tuple(a0.shape)
                  and a.dtype == a0.dtype for a in arts)
    if device_path is False or not uniform:
        return [decompress_preserving_mss(a, device_path=device_path,
                                          backend=backend, mesh=mesh,
                                          device=device)
                for a in arts]
    for a in arts:
        preserve.check_artifact(a)
    dev = resolve_device(device)
    reason = _device_decode_reason(a0)
    if reason is not None:
        if device_path is True:
            raise ValueError(f"device_path=True but {reason}")
        return [decompress_artifact(a) for a in arts]

    shape, dtype = tuple(a0.shape), np.dtype(a0.dtype)
    be = _decode_backend(backend, shape, dtype, mesh, dev)
    idx_b, val_b, counts = codec.decode_edits_batch(
        [a.edit_payload for a in arts], fill_idx=math.prod(shape))
    idx_j = _h2d(idx_b, dev)
    val_j = _h2d(val_b, dev)

    def finish(i: int, f_hat: torch.Tensor) -> torch.Tensor:
        n = int(counts[i])  # mszlint: disable=transfer-discipline -- host
        return be.scatter_edits(f_hat, idx_j[i, :n], val_j[i, :n])

    if all(_is_device_pack(a) for a in arts):
        parsed = [szlike.sz_parse_packed(a.base_payload) for a in arts]
        if all(p[5] == CHUNK for p in parsed):
            gs = []
            for i, (words, bits, _, _, step, _) in enumerate(parsed):
                step_t = _h2d(np.asarray(step, dtype), dev)
                codes = be.unpack_codes(_h2d(words.view(np.int32), dev),
                                        _h2d(bits, dev), shape)
                gs.append(finish(i, be.reconstruct(codes, step_t,
                                                   step_t.dtype)))
            g_host = _d2h(torch.stack(gs))
            return [g_host[i] for i in range(len(arts))]
    gs = []
    for i, (r, _, _, step) in enumerate(codec.iter_decode_blobs(
            szlike.sz_decode_residuals, [a.base_payload for a in arts])):
        reason = _codes_reason(arts[i], r)
        if reason is not None:
            if device_path is True:
                raise ValueError(f"device_path=True but {reason}")
            return [decompress_artifact(a) for a in arts]
        step_t = _h2d(np.asarray(step, dtype), dev)
        f_hat = be.reconstruct(_h2d(np.asarray(r, np.int32), dev), step_t,
                               step_t.dtype)
        gs.append(finish(i, f_hat))
    g_host = _d2h(torch.stack(gs))
    return [g_host[i] for i in range(len(arts))]


def overall_compression_ratio(f: np.ndarray, art: CompressedArtifact
                              ) -> float:
    """OCR: original bytes / (base payload + edit payload)."""
    return f.nbytes / art.nbytes


def overall_bit_rate(f: np.ndarray, art: CompressedArtifact) -> float:
    """OBR: average bits per data point after combining data + edits."""
    return art.nbytes * 8.0 / f.size


def psnr(f: np.ndarray, g: np.ndarray) -> float:
    """PSNR normalized by the value range max(f) - min(f), as in the
    paper; inf for an exact reconstruction, -inf for a constant field
    reconstructed with error."""
    f64 = np.asarray(f, np.float64)
    mse = float(np.mean((f64 - np.asarray(g, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    rng = float(np.max(f64) - np.min(f64))
    if rng == 0:
        return float("-inf")
    return 20.0 * np.log10(rng / np.sqrt(mse))
