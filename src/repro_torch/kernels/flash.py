"""Causal or full GQA flash-attention forward: the CUDA kernel
``csrc/flash.cu`` and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/flash.py:_kernel`` (the
``pallas_call`` in ``_call``, reached through ``flash_attention_pallas``):
q (B, S, H, Dh) against k, v (B, T, Hk, Dh) with H = Hk * G, query head
h reading KV head h // G. Both versions compute what the Pallas kernel
computes, which is not bit for bit what the jnp oracle
(``repro.models.layers.flash_attention``) computes: q is scaled before
the product, scores and p stay in f32 for the p . v product, ``l`` is
floored at 1e-37, and the result is cast to q's type once at the end.

What bounds it on an H100: operations (the causal 8 x 2048 prefill of
smollm-135m is 3.87e10 FLOPs against 50 MB moved; 0.039 ms on the tensor
cores). bf16, the LM path's type, runs on the tensor cores (``mma.sync``
bf16 tiles, K/V by ``cp.async`` into a two-stage ring, the online softmax
in registers) and keeps f32 accuracy by splitting the f32 operands, the
scaled q and p, into bf16 hi and lo parts whose products are exact; f32
runs on the CUDA cores. Both take one block per (batch * head, 64 query
rows) and loop over 64-key K/V tiles that stop at the diagonal; see the
note at the head of ``csrc/flash.cu`` for the design and its numbers.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel on that tensor's card (the C entry takes the device
and makes it current) or raises.
"""
from __future__ import annotations

import functools

import torch

from . import _build

#: kernel launches so far (one per wrapper call on a CUDA tensor)
launches = 0

#: head widths the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)

#: query rows per block of the kernel (the grid's second axis)
Q_ROWS = 64


@functools.lru_cache(maxsize=None)
def softmax_scale(head_dim: int) -> float:
    """``head_dim ** -0.5`` rounded to float32 once, as the Pallas kernel
    receives it; the kernel gets this value as its ``float`` argument."""
    return torch.tensor(head_dim ** -0.5, dtype=torch.float32).item()


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError("flash_attention: q (B, S, H, Dh) and k, v "
                         f"(B, T, Hk, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head width")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {k.shape[2]} KV heads")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          q_block: int = 256,
                          k_block: int = 256) -> torch.Tensor:
    """The plain PyTorch version: the Pallas kernel's online softmax over
    (q_block, k_block) tiles, all heads of a tile at once. Tiles wholly
    above the diagonal are skipped when causal; ragged tails are sliced,
    not padded."""
    _check_shapes(q, k, v)
    B, S, H, Dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    dev = q.device
    scale = softmax_scale(Dh)
    # (B, Hk, G, S, Dh) and (B, Hk, 1, T, Dh): head h = hk * G + g
    qf = (q.float() * scale).reshape(B, S, Hk, G, Dh).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((B, Hk, G, S, Dh), dtype=torch.float32, device=dev)
    neg_inf = float("-inf")
    for i0 in range(0, S, q_block):
        i1 = min(i0 + q_block, S)
        qb = qf[:, :, :, i0:i1]
        m = torch.full((B, Hk, G, i1 - i0), neg_inf, device=dev)
        l = torch.zeros((B, Hk, G, i1 - i0), device=dev)
        acc = torch.zeros((B, Hk, G, i1 - i0, Dh), device=dev)
        q_pos = torch.arange(i0, i1, device=dev)
        k_end = min(T, i1) if causal else T
        for j0 in range(0, k_end, k_block):
            j1 = min(j0 + k_block, T)
            s = torch.matmul(qb, kf[..., j0:j1, :].transpose(-1, -2))
            if causal:
                k_pos = torch.arange(j0, j1, device=dev)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], neg_inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, vf[..., j0:j1, :])
            m = m_new
        out[:, :, :, i0:i1] = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    lib = _build.load("flash")
    sym = "msz_flash_f32" if dtype == torch.float32 else "msz_flash_bf16"
    return _build.entry(lib, sym, 4, 8, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, Dh); k, v: (B, T, Hk, Dh), H a multiple of Hk; float32
    or bfloat16, all three alike. Returns (B, S, H, Dh) in q's dtype.
    ``causal`` masks k_pos > q_pos, both counted from 0."""
    global launches
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: float32/bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: tensors must be contiguous")
    B, S, H, Dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {Dh} is not one of "
                         f"{HEAD_DIMS}")
    if -(-S // Q_ROWS) > 65535 or B * H >= 2 ** 31:
        raise ValueError(f"flash_attention: grid too large for {q.shape}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel copies rows 16 bytes at a time
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
    with torch.cuda.device(dev):
        _build.check(_entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, T, H, Hk, Dh, 1 if causal else 0, dev.index,
            softmax_scale(Dh), torch.cuda.current_stream(dev).cuda_stream),
            "flash_attention")
    launches += 1
    return o
