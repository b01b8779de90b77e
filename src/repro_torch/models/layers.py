"""Model building blocks of the port (plain torch functions on tensors,
parameter dicts in, tensors out), with the reference's conventions:

  * activations in ``cfg.dtype``, reductions, softmax and norms in f32;
  * attention is flash-style and never materializes the S x T logits;
  * MoE uses the reference's sort-based token dispatch with a static
    capacity (no E x C one-hot dispatch tensors).

``flash_attention`` keeps the reference's chunked online softmax (its
non-Pallas path, the jnp oracle) in plain torch, and routes the plain
causal or full case to the hand-written kernel (``kernels.flash``): when
``window`` masks nothing (None, or at least T), there is no logit
softcap and no query offset. Unlike the reference it imposes no
``S % 128`` condition: the kernel masks ragged tails. The kernel computes
the Pallas kernel's numbers, which differ from the oracle's in bf16
(ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import flash as kflash


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = positions[..., None].float() * freq            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ---------------------------------------------------------------------------
# flash-style chunked attention (prefill)
# ---------------------------------------------------------------------------

def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (n assumed power-of-two-ish)."""
    c = min(n, target)
    while n % c:
        c -= 1
    return max(c, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    q_offset: int = 0,
                    q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention with GQA, O(S * k_chunk) memory.

    q: (B, S, H, D); k/v: (B, T, Hk, D). Returns (B, S, H, D).
    ``window``: only attend to keys with q_pos - k_pos < window (local
    attention), a Python int. The plain causal/full case goes to
    ``kernels.flash.flash_attention``; the rest runs the reference's
    chunked oracle in plain torch."""
    T = k.shape[1]
    if ((window is None or window >= T) and logit_softcap is None
            and q_offset == 0):
        return kflash.flash_attention(q, k, v, causal=causal)
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qc = _pick_chunk(S, q_chunk)
    kc = _pick_chunk(T, k_chunk)
    scale = kflash.softmax_scale(D)
    dev = q.device
    # (B, Hk, G, S, D) and (B, Hk, 1, T, D): head h = hk * G + g
    qr = q.float().reshape(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)
    kr = k.float().permute(0, 2, 1, 3)[:, :, None]
    vr = v.permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((B, Hk, G, S, D), dtype=torch.float32, device=dev)
    neg_inf = float("-inf")
    for i0 in range(0, S, qc):
        qb = qr[:, :, :, i0:i0 + qc]
        q_pos = q_offset + i0 + torch.arange(qc, device=dev)
        m = torch.full((B, Hk, G, qc), neg_inf, device=dev)
        l = torch.zeros((B, Hk, G, qc), device=dev)
        acc = torch.zeros((B, Hk, G, qc, D), device=dev)
        for j0 in range(0, T, kc):
            s = torch.matmul(qb, kr[..., j0:j0 + kc, :].transpose(-1, -2))
            s = softcap(s * scale, logit_softcap)
            k_pos = j0 + torch.arange(kc, device=dev)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = s.masked_fill(~mask, neg_inf)
            m2 = torch.maximum(m, s.amax(-1))
            # guard fully-masked rows (m2 = -inf)
            m_safe = torch.where(torch.isfinite(m2), m2, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = p.masked_fill(~mask, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            pv = torch.matmul(p.to(v.dtype).float(),
                              vr[..., j0:j0 + kc, :].float())
            acc = acc * corr[..., None] + pv
            m = m2
        out[:, :, :, i0:i0 + qc] = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, t: int, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a (B, T, Hk, D) KV cache.

    q: (B, 1, H, D); t: the number of valid cache entries (a Python int).
    Unchunked: the (B, H, t) logits are small. Only the valid entries
    [max(0, t - window), t) are read; the reference masks the rest to
    -inf, which contributes exact zeros, so the two differ only in the
    order of the sums."""
    B, _, H, D = q.shape
    Hk = k_cache.shape[2]
    G = H // Hk
    lo = 0 if window is None else max(0, t - window)
    kc = k_cache[:, lo:t].float()                  # (B, t', Hk, D)
    vc = v_cache[:, lo:t]
    qr = q.reshape(B, Hk, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qr, kc) * (D ** -0.5)
    s = softcap(s, logit_softcap)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).float(),
                       vc.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch, static capacity)
# ---------------------------------------------------------------------------

class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, lower
    index first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` breaks ties in no stated order, and on a row of equal
    probabilities picks others)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _mean0_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 mean over axis 0 as XLA computes ``jnp.mean``: the sum times
    the f32 reciprocal of the count."""
    recip = np.float32(1.0) / np.float32(x.shape[0])
    return x.sum(0) * float(recip)


def moe_ffn(x: torch.Tensor, p, n_experts: int, top_k: int,
            capacity_factor: float = 1.25) -> MoEOut:
    """Top-k MoE with the reference's sort-based dispatch.

    x: (B, S, d). p: router (d, E), w_gate/w_up (E, d, ff), w_down
    (E, ff, d). Assignments beyond an expert's static capacity are
    dropped exactly where the reference drops them (the same stable sort,
    left search and capacity); aux_loss is the Switch load-balancing loss.
    The grouped expert GEMMs are ``torch.bmm``. The combine un-sorts the
    N*K weighted rows with the inverse permutation of the sort and sums
    each token's K rows in f32, where the reference scatter-adds them:
    no atomics, so the result is the same from run to run."""
    B, S, d = x.shape
    N = B * S
    E, K = n_experts, top_k
    dev = x.device
    xf = x.reshape(N, d)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, K)                   # (N, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # load-balance loss (Switch): E * sum_e f_e * P_e
    me = _mean0_f32(probs)
    ce = _mean0_f32(torch.zeros((N, E), dtype=torch.float32, device=dev)
                    .scatter_add_(1, expert_ids,
                                  torch.ones((N, K), device=dev)))
    aux = float(E) * torch.sum(me * ce)

    cap = int(np.ceil(N * K / E * capacity_factor / 8)) * 8

    flat_e = expert_ids.reshape(-1)                           # (N*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=sorted_e.dtype, device=dev))
    pos_in_grp = torch.arange(N * K, device=dev) - group_start[sorted_e]
    keep = pos_in_grp < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_grp, E * cap)
    tok = order // K

    # row E * cap takes every dropped assignment and is never read back
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xf[tok]
    h_in = buf[:E * cap].reshape(E, cap, d)
    g = torch.bmm(h_in, p["w_gate"])
    u = torch.bmm(h_in, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    out_e = torch.bmm(h, p["w_down"]).reshape(E * cap, d)
    out_e = torch.cat([out_e, out_e.new_zeros((1, d))], 0)

    w = (gate_vals.reshape(-1)[order] * keep).float()
    weighted = out_e[slot].float() * w[:, None]               # sorted order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * K, device=dev)
    y = weighted[inv].reshape(N, K, d).sum(1)
    return MoEOut(y.reshape(B, S, d).to(x.dtype), aux)
