"""High-level MSz API, the PyTorch port of ``repro.core.driver``: derive
edits at compression time (one field in fused or paper mode, or a batch
through ``fixes.fused_fix_batch``), apply them at decompression time,
verify exact MSS preservation."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, _h2d, resolve_device
from . import fixes
from .backend import BackendLike, resolve_backend
from .labels import _mean_f32, mss_labels


@dataclasses.dataclass
class MszResult:
    """Edits that give f_hat the MSS of f, with the loop's statistics."""
    g: np.ndarray             # edited decompressed field (MSS == original's)
    edits_idx: np.ndarray     # int64 flat indices of edited vertices (sorted)
    edits_val: np.ndarray     # edit values delta_i  (g = f_hat + delta)
    iters: int                # fix-loop iterations to convergence
    converged: bool
    edit_ratio: float         # |edits| / V   (paper's 'edit ratio')
    max_abs_err: float        # max |f - g|   (must be <= xi)
    backend: str = ""         # stencil backend that executed the fix loop


def _as_tensor(x, device: DeviceLike, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` (numpy inputs cross the h2d seam)."""
    if isinstance(x, torch.Tensor):
        t = x.to(resolve_device(device) if device is not None else x.device)
    else:
        t = _h2d(np.asarray(x), resolve_device(device))
    return t if dtype is None else t.to(dtype)


def _check_inputs(f: torch.Tensor, f_hat: torch.Tensor, xi: float) -> None:
    if f.shape != f_hat.shape:
        raise ValueError(f"shape mismatch {tuple(f.shape)} vs "
                         f"{tuple(f_hat.shape)}")
    if f.ndim not in (2, 3):
        raise ValueError("MSz operates on 2D/3D piecewise-linear scalar fields")
    if not f.dtype.is_floating_point:
        raise ValueError(
            f"MSz operates on floating-point fields, got dtype {f.dtype}")
    base_err = float((f - f_hat).abs().max())
    if base_err > xi * (1 + 1e-6):
        raise ValueError(
            f"decompressed data violates the error bound before editing: "
            f"max|f-f_hat|={base_err:.3g} > xi={xi:.3g}")


def derive_edits(f, f_hat, xi: float, mode: str = "fused",
                 max_iters: int = 512, backend: BackendLike = "auto",
                 mesh=None, device: DeviceLike = None) -> MszResult:
    """Edits such that f_hat + delta has exactly the MS segmentation of f
    with |f - (f_hat + delta)| <= xi. ``mode``: "fused" (the fused loop
    on ``backend``) or "paper" (``fixes.paper_fix`` on torch ops, whatever
    ``backend`` says, as in the reference). "auto" takes the sharded
    loop when ``mesh`` (or the active ``with mesh:`` one) has >= 2
    data-axis blocks. ``device=None`` runs on CUDA (numpy inputs);
    tensors stay on their device unless ``device`` names another."""
    if mode not in ("fused", "paper"):
        raise ValueError(f"unknown mode {mode!r}")
    ft = _as_tensor(f, device)
    fh = _as_tensor(f_hat, ft.device, ft.dtype)
    _check_inputs(ft, fh, xi)
    topo = fixes.field_topology(ft, xi)
    if mode == "paper":
        g, iters, ok = fixes.paper_fix(fh, topo, max_iters=max_iters)
        return _package_result(ft, fh, g, iters, ok, "reference")
    be = fixes._bind(resolve_backend(backend, ft.shape, ft.dtype, ft.device,
                                     mesh=mesh))
    g, iters, ok = fixes.fused_fix(fh, topo, max_iters=max_iters, backend=be)
    return _package_result(ft, fh, g, iters, ok, be.name)


def _package_result(f: torch.Tensor, f_hat: torch.Tensor, g: torch.Tensor,
                    iters: int, ok: bool, backend_name: str) -> MszResult:
    delta = (g - f_hat).cpu().numpy()
    idx = np.flatnonzero(delta != 0.0)
    g_np = g.cpu().numpy()
    return MszResult(
        g=g_np,
        edits_idx=idx.astype(np.int64),
        edits_val=delta.reshape(-1)[idx],
        iters=int(iters),
        converged=bool(ok),
        edit_ratio=float(idx.size) / float(delta.size),
        max_abs_err=float(np.max(np.abs(f.cpu().numpy() - g_np))),
        backend=backend_name,
    )


def derive_edits_batch(f, f_hat, xi: Union[float, Sequence[float]],
                       max_iters: int = 512, backend: BackendLike = "auto",
                       mesh=None, batching: str = "auto",
                       compact_every: int = 8,
                       device: DeviceLike = None) -> List[MszResult]:
    """Batched ``derive_edits`` over a leading batch axis (fused mode).
    ``f``/``f_hat``: (B, *spatial) with 2D/3D members; ``xi`` a scalar
    or one bound a member (each member's topology honours its own).
    The fix loops run through ``fixes.fused_fix_batch`` (``batching``
    and ``compact_every`` passed through; under a mesh the members run
    one after another through the sharded loop); each member's result
    is bitwise a solo ``derive_edits`` call's."""
    ft = _as_tensor(f, device)
    fh = _as_tensor(f_hat, ft.device, ft.dtype)
    if ft.shape != fh.shape:
        raise ValueError(f"shape mismatch {tuple(ft.shape)} vs "
                         f"{tuple(fh.shape)}")
    if ft.ndim not in (3, 4):
        raise ValueError(
            "derive_edits_batch expects (B, *spatial) with 2D/3D members; "
            f"got shape {tuple(ft.shape)}")
    B = ft.shape[0]
    xi_arr = np.broadcast_to(np.asarray(xi, np.float64), (B,))
    for i in range(B):
        _check_inputs(ft[i], fh[i], float(xi_arr[i]))
    topos = [fixes.field_topology(ft[i], float(xi_arr[i])) for i in range(B)]
    topo_b = fixes.FieldTopo(*(torch.stack(leaves)
                               for leaves in zip(*topos)))
    be = fixes._bind(resolve_backend(backend, ft.shape[1:], ft.dtype,
                                     ft.device, mesh=mesh))
    g_b, iters_b, ok_b = fixes.fused_fix_batch(
        fh, topo_b, max_iters=max_iters, backend=be, batching=batching,
        compact_every=compact_every)
    iters_b, ok_b = iters_b.cpu().numpy(), ok_b.cpu().numpy()
    return [_package_result(ft[i], fh[i], g_b[i], iters_b[i], ok_b[i],
                            be.name)
            for i in range(B)]


def extract_edits(f_hat: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device edit extraction: (idx, val) of ``delta = g - f_hat`` at
    its nonzeros, idx int32 flat indices in ascending order (as
    ``torch.nonzero`` gives them, and as the host path's
    ``np.flatnonzero``)."""
    delta = (g - f_hat).reshape(-1)
    idx = torch.nonzero(delta != 0).reshape(-1)
    return idx.to(torch.int32), delta[idx]


def apply_edits(f_hat, edits_idx, edits_val) -> np.ndarray:
    """Host reconstruction g = f_hat + delta. Duplicate indices
    ACCUMULATE (``np.add.at`` semantics); strictly increasing indices
    take the vectorized path."""
    g = np.array(f_hat, copy=True)
    flat = g.reshape(-1)
    idx = np.asarray(edits_idx).reshape(-1)
    val = np.asarray(edits_val).reshape(-1)
    if idx.size == 0:
        return g
    if idx.size == 1 or np.all(np.diff(idx) > 0):
        # mszlint: disable=scatter-discipline -- diff>0 proves uniqueness
        flat[idx] += val            # strictly increasing => no duplicates
    else:
        np.add.at(flat, idx, val)   # unbuffered: duplicates accumulate
    return g


def apply_edits_device(f_hat: torch.Tensor, edits_idx: torch.Tensor,
                       edits_val: torch.Tensor) -> torch.Tensor:
    """Device twin of ``apply_edits``: one scatter-add of the deltas
    (cast to f_hat's dtype) into a copy of f_hat. Indices must be unique
    (the codec invariant), which makes the scatter order-free; indices
    outside [0, size) are dropped, never wrapped, so a caller may pad the
    edit stream with index ``size``."""
    flat = f_hat.reshape(-1).clone()
    idx = edits_idx.reshape(-1).to(torch.int64)
    val = edits_val.reshape(-1).to(f_hat.dtype)
    keep = (idx >= 0) & (idx < flat.numel())
    flat.index_add_(0, idx[keep], val[keep])
    return flat.reshape(f_hat.shape)


def verify_preservation(f, g, xi: float, device: DeviceLike = None) -> dict:
    """Check both paper constraints: global error bound + exact MSS.
    ``f``/``g``: numpy arrays (moved to ``device``, CUDA by default) or
    tensors (verified where they lie)."""
    ft = _as_tensor(f, device)
    if ft.ndim not in (2, 3):
        raise ValueError(
            f"verify_preservation takes one 2D/3D field (got shape "
            f"{tuple(ft.shape)})")
    gt = _as_tensor(g, ft.device, ft.dtype)
    Mf, mf = mss_labels(ft)
    Mg, mg = mss_labels(gt)
    max_label_ok = bool(torch.equal(Mf, Mg))
    min_label_ok = bool(torch.equal(mf, mg))
    err = float((ft - gt).abs().max())
    right = float(_mean_f32((Mf == Mg) & (mf == mg)))
    return dict(
        bound_ok=err <= xi * (1 + 1e-6),
        max_abs_err=err,
        max_labels_ok=max_label_ok,
        min_labels_ok=min_label_ok,
        mss_preserved=max_label_ok and min_label_ok,
        right_labeled_ratio=right,
    )


def verify_preservation_batch(f_b, g_b, xi, device: DeviceLike = None
                              ) -> list:
    """Member-wise ``verify_preservation`` over stacked batches: ``f_b``
    and ``g_b`` are (B, *spatial) with 2D/3D members, ``xi`` a scalar or
    one bound a member. Returns one verdict dict a member."""
    f_b = np.asarray(f_b)
    g_b = np.asarray(g_b)
    if f_b.ndim not in (3, 4):
        raise ValueError(
            f"verify_preservation_batch takes a (B, *spatial) stack of "
            f"2D/3D fields (got shape {f_b.shape})")
    if f_b.shape != g_b.shape:
        raise ValueError(
            f"batch shapes disagree: f {f_b.shape} vs g {g_b.shape}")
    B = f_b.shape[0]
    xi_arr = np.broadcast_to(np.asarray(xi, np.float64), (B,))
    return [verify_preservation(f_b[i], g_b[i], float(xi_arr[i]),
                                device=device)
            for i in range(B)]
