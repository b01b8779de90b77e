"""Error-bounded gradient compression for the slow cross-pod links, the
port of ``repro.distributed.compression``.

The paper's compressor (linear-scaling quantization, the primitive of
``compress.szlike``) applied to data-parallel training: each pod's
gradients are quantized to int16 (or int8) codes with one per-tensor step
shared by every pod (from the largest |g| of any pod, the reference's
``pmax``), the codes are summed exactly as integers (its ``psum``), and
the sum is dequantized. Each pod's codes fit ``qmax / n_shards``, so the
sum fits the narrow type: the reduce moves 2x (int16) or 4x (int8) fewer
bytes than f32, with a hard per-element error bound.

The reference runs this inside ``shard_map`` over the ``pod`` axis. The
port runs it in one process: ``compressed_psum_tree`` takes every pod's
gradient tree (each on its pod's device), moves the int codes to one
device and sums them there. Rounding is ``torch.round`` (half to even,
as ``jnp.round``), and the step divides the gradient (no reciprocal),
so codes, steps and sums are bitwise the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from .. import tree


def _bits_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits == 8 else torch.int16


def _step(amax: torch.Tensor, rel_bound: float, qmax: float) -> torch.Tensor:
    """The quantization step of a tensor whose largest |g| is ``amax``:
    fine enough for ``rel_bound`` * amax, coarse enough for the codes to
    fit ``qmax``; never below 1e-30."""
    return torch.clamp_min(torch.maximum(amax * rel_bound * 2.0,
                                         amax / qmax), 1e-30)


def _codes(gf: torch.Tensor, step: torch.Tensor, qmax: float,
           bits: int) -> torch.Tensor:
    return torch.clip(torch.round(gf / step), -qmax, qmax).to(
        _bits_dtype(bits))


def quantize_tree(grads: Any, rel_bound: float, bits: int = 16):
    """Per-tensor linear-scaling quantization. Returns (codes, steps),
    trees like ``grads`` (int16/int8 codes, f32 scalar steps)."""
    # mszlint: disable=transfer-discipline -- bits is a python int
    qmax = float(2 ** (bits - 1) - 1)

    def q(g):
        gf = g.float()
        step = _step(torch.max(torch.abs(gf)), rel_bound, qmax)
        return _codes(gf, step, qmax, bits), step

    flat = [q(g) for g in tree.leaves(grads)]
    return (tree.unflatten(grads, [c for c, _ in flat]),
            tree.unflatten(grads, [s for _, s in flat]))


def dequantize_tree(codes: Any, steps: Any, like: Any):
    """Inverse of ``quantize_tree``: codes * step, cast back to the
    dtypes of ``like``."""
    return tree.tree_map(lambda c, s, g: (c.float() * s).to(g.dtype),
                         codes, steps, like)


def compressed_psum_tree(pod_grads: Sequence[Any], rel_bound: float = 1e-3,
                         bits: int = 16, n_shards: Optional[int] = None,
                         device=None):
    """The sum over pods of ``pod_grads`` (one gradient tree a pod) with
    error-bounded quantized payloads, on ``device`` (default: the device
    of the first pod's first leaf), in each leaf's dtype.

    The per-tensor ``amax`` is the largest over pods, so every pod uses
    one step; each pod's codes are clipped to ``qmax / n_shards``
    (``n_shards`` defaults to the number of pods), cross to ``device`` in
    the wire dtype and are summed there exactly. Each pod's
    dequantization error is bounded by half its step, so the sum's error
    is bounded by ``n_shards`` * step / 2."""
    n = len(pod_grads) if n_shards is None else n_shards
    # mszlint: disable=transfer-discipline -- bits is a python int
    qmax = float(2 ** (bits - 1) - 1) / n       # headroom for the sum
    if device is None:
        device = tree.leaves(pod_grads[0])[0].device

    def q(*gs):
        gfs = [g.float() for g in gs]
        amax = torch.stack([torch.max(torch.abs(gf)).to(device)
                            for gf in gfs]).amax()        # shared scale
        step = _step(amax, rel_bound, qmax)
        summed = None
        for gf in gfs:
            # the wire: int16 / int8 codes, summed exactly
            codes = _codes(gf, step.to(gf.device), qmax, bits).to(device)
            summed = codes if summed is None else summed + codes
        return (summed.float() * step).to(gs[0].dtype)

    return tree.tree_map(q, *pod_grads)


def make_grad_sync(rel_bound: float = 1e-3, bits: int = 16,
                   n_pods: int = 2, device=None) -> Callable:
    """Returns ``grad_sync(pod_grads)``: the compressed sum over the pods'
    gradient trees divided by ``n_pods`` (the mean), on ``device``."""
    def sync(pod_grads):
        summed = compressed_psum_tree(pod_grads, rel_bound, bits,
                                      n_shards=n_pods, device=device)
        return tree.tree_map(lambda g: g / n_pods, summed)
    return sync


__all__ = ["quantize_tree", "dequantize_tree", "compressed_psum_tree",
           "make_grad_sync"]
