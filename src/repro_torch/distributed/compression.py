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
port runs it in one process or across processes. ``compressed_psum_tree``
takes every pod's gradient tree (each on its pod's device), moves the int
codes to one device and sums them there. ``compressed_all_reduce_tree``
is the process-group form, a process a pod: a MAX all-reduce of the
tensors' ``amax`` (the ``pmax``), the same steps and codes, an exact sum
of the codes over the ranks, dequantized; both forms give the same bits.
Neither NCCL nor gloo reduces int16, so int16 codes cross as their bytes
in an all-gather and each rank sums the world's codes in rank order, in
int16: (world - 1) x the codes' bytes received a rank, where an f32 ring
all-reduce moves 2 (world - 1) / world x 4 bytes an element; int8 codes
are all-reduced. Rounding is ``torch.round`` (half to even, as
``jnp.round``), and the step divides the gradient (no reciprocal), so
codes, steps and sums are bitwise the reference's.
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


def _sum_codes(codes: torch.Tensor, group) -> torch.Tensor:
    """The exact sum over the group's ranks of each rank's ``codes`` (1-D,
    int8 or int16), in that dtype: an all-reduce for int8; for int16,
    which neither NCCL nor gloo reduces, an all-gather of the codes'
    bytes and a sum in rank order."""
    import torch.distributed as dist
    if codes.dtype == torch.int8:
        dist.all_reduce(codes, op=dist.ReduceOp.SUM, group=group)
        return codes
    raw = codes.view(torch.uint8)
    parts = [torch.empty_like(raw)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    summed = parts[0].view(codes.dtype)
    for part in parts[1:]:
        summed = summed + part.view(codes.dtype)
    return summed


def compressed_all_reduce_tree(grads: Any, rel_bound: float = 1e-3,
                               bits: int = 16,
                               n_shards: Optional[int] = None, group=None):
    """The sum over the ranks of ``group`` (default: the world) of each
    rank's gradient tree ``grads``, with error-bounded quantized
    payloads: ``compressed_psum_tree`` with a process a pod, the same
    bits on every rank. One MAX all-reduce carries every tensor's
    ``amax``; one collective carries every tensor's codes (``_sum_codes``).
    ``n_shards`` defaults to the group's size."""
    import torch.distributed as dist
    n = dist.get_world_size(group) if n_shards is None else n_shards
    # mszlint: disable=transfer-discipline -- bits is a python int
    qmax = float(2 ** (bits - 1) - 1) / n       # headroom for the sum
    leaves = tree.leaves(grads)
    gfs = [g.float() for g in leaves]
    amax = torch.stack([torch.max(torch.abs(gf)) for gf in gfs])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    steps = _step(amax, rel_bound, qmax)
    codes = torch.cat([_codes(gf, steps[i], qmax, bits).reshape(-1)
                       for i, gf in enumerate(gfs)])
    summed = _sum_codes(codes, group).split([g.numel() for g in leaves])
    return tree.unflatten(grads, [
        (c.reshape(g.shape).float() * steps[i]).to(g.dtype)
        for i, (c, g) in enumerate(zip(summed, leaves))])


def make_grad_sync(rel_bound: float = 1e-3, bits: int = 16,
                   n_pods: int = 2, device=None, group=None) -> Callable:
    """Returns ``grad_sync(grads)``: the compressed sum over the pods
    divided by ``n_pods`` (the mean). In one process ``grads`` is the
    list of the pods' gradient trees, summed on ``device``; with a
    process ``group`` (a process a pod) it is this rank's tree, summed
    over the group (``compressed_all_reduce_tree``)."""
    def sync(grads):
        if group is None:
            summed = compressed_psum_tree(grads, rel_bound, bits,
                                          n_shards=n_pods, device=device)
        else:
            summed = compressed_all_reduce_tree(grads, rel_bound, bits,
                                                n_shards=n_pods,
                                                group=group)
        return tree.tree_map(lambda g: g / n_pods, summed)
    return sync


__all__ = ["quantize_tree", "dequantize_tree", "compressed_psum_tree",
           "compressed_all_reduce_tree", "make_grad_sync"]
