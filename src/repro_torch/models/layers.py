"""Model building blocks of the port (plain torch functions on tensors,
parameter dicts in, tensors out), with the reference's conventions:

  * activations in ``cfg.dtype``, reductions, softmax and norms in f32;
  * attention is flash-style and never materializes the S x T logits;
  * MoE uses the reference's sort-based token dispatch with a static
    capacity (no E x C one-hot dispatch tensors);
  * the recurrent blocks' scans (mLSTM and the SSM chunkwise, the sLSTM
    step by step) and their O(1) decode steps are plain torch, as the
    reference's are plain jnp: no kernel.

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


# ---------------------------------------------------------------------------
# recurrent scans: plain torch, as the reference's are plain jnp (no kernel)
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no threshold
    (``torch.nn.functional.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


def _tril(L: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_f: torch.Tensor, log_i: torch.Tensor,
               chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM (matrix memory), the reference's
    ``mlstm_scan``: a Python loop over chunks of ``_pick_chunk(S, chunk)``
    carrying C (B, H, D, D) and n (B, H, D) in f32.

    q/k/v: (B, S, H, D); log_f/log_i: (B, S, H). Returns (B, S, H, D) in
    q's dtype. C_t = f_t C_{t-1} + i_t v_t k_t^T; n_t = f_t n_{t-1} + i_t
    k_t; h_t = C_t q_t / max(|n_t . q_t|, 1). The reference's
    three-operand einsums are contracted two at a time (C . q, then the
    decay; v scaled by the weights, then one product with k), so nothing
    of (B, L, H, D, D) is formed."""
    B, S, H, D = q.shape
    L = _pick_chunk(S, chunk)
    dev = q.device
    tri = _tril(L, dev)[None, :, :, None]                 # (1, L, M, 1)
    C = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    for s0 in range(0, S, L):
        qc = q[:, s0:s0 + L].float() * (D ** -0.5)
        kc = k[:, s0:s0 + L].float()
        vc = v[:, s0:s0 + L].float()
        li = log_i[:, s0:s0 + L].float()
        LF = torch.cumsum(log_f[:, s0:s0 + L].float(), dim=1)  # (B, L, H)
        tot = LF[:, -1]                                   # (B, H)
        # w[t, s] = exp(LF_t - LF_s + li_s), s <= t      (B, L, M, H)
        w = torch.where(tri, torch.exp(LF[:, :, None] - LF[:, None]
                                       + li[:, None]), 0.0)
        dec = torch.exp(LF)                               # (B, L, H)
        h_inter = torch.einsum("bhde,blhe->blhd", C, qc) * dec[..., None]
        n_inter = dec[..., None] * n[:, None]             # (B, L, H, D)
        A = torch.einsum("blhd,bmhd->blmh", qc, kc) * w
        h_intra = torch.einsum("blmh,bmhd->blhd", A, vc)
        denom = torch.abs((n_inter * qc).sum(-1) + A.sum(2))
        out[:, s0:s0 + L] = ((h_inter + h_intra)
                             / torch.clamp_min(denom, 1.0)[..., None])
        wk = torch.exp(tot[:, None] - LF + li)            # (B, L, H)
        et = torch.exp(tot)
        C = et[..., None, None] * C + torch.einsum(
            "blhd,blhe->bhde", vc * wk[..., None], kc)
        n = et[..., None] * n + torch.einsum("blh,blhd->bhd", wk, kc)
    return out


def mlstm_step(state, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_f: torch.Tensor, log_i: torch.Tensor):
    """O(1) mLSTM decode step. state: (C (B, H, D, D) f32 or bf16, n
    (B, H, D) f32); q/k/v: (B, 1, H, D); log_f/log_i: (B, 1, H). The C
    update is computed in f32 and returned in C's dtype (round to
    nearest); the readout uses the f32 update. Returns ((C, n), h
    (B, 1, H, D))."""
    C, n = state
    D = q.shape[-1]
    qf = q[:, 0].float() * (D ** -0.5)
    kf = k[:, 0].float()
    vf = v[:, 0].float()
    f = torch.exp(log_f[:, 0].float())[..., None, None]
    i = torch.exp(log_i[:, 0].float())[..., None, None]
    C2 = f * C.float() + i * (vf[..., :, None] * kf[..., None, :])
    n2 = f[..., 0] * n + i[..., 0] * kf
    num = torch.einsum("bhde,bhe->bhd", C2, qf)
    den = torch.clamp_min(torch.abs((n2 * qf).sum(-1)), 1.0)
    h = (num / den[..., None])[:, None].to(q.dtype)
    return (C2.to(C.dtype), n2), h


def _slstm_gates(zi, zf, zz, zo):
    """The sLSTM's per-position gate terms, f32: log forget, log input,
    the cell input tanh(zz) and the output gate sigmoid(zo)."""
    return (_log_sigmoid(zf.float()), zi.float(), torch.tanh(zz.float()),
            torch.sigmoid(zo.float()))


def _slstm_cell(c, n, m, lf, li, z, o):
    """One stabilized sLSTM update: m' = max(lf + m, li), c and n in the
    exp(. - m') domain; returns (c', n', m', h)."""
    lfm = lf + m
    m2 = torch.maximum(lfm, li)
    a = torch.exp(lfm - m2)
    b = torch.exp(li - m2)
    c2 = a * c + b * z
    n2 = a * n + b
    return c2, n2, m2, o * c2 / torch.clamp_min(n2, 1.0)


def slstm_scan(zi: torch.Tensor, zf: torch.Tensor, zz: torch.Tensor,
               zo: torch.Tensor) -> torch.Tensor:
    """The reference's stabilized sLSTM scan, sequential over S (a Python
    loop; the gate activations are taken for every position first). zi/
    zf/zz/zo: (B, S, H, D) pre-activations; c and n start at 0, m at
    -1e30. Returns (B, S, H, D) in zz's dtype."""
    B, S, H, D = zz.shape
    lf, li, z, o = _slstm_gates(zi, zf, zz, zo)
    dev = zz.device
    c = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
    n = torch.zeros_like(c)
    m = torch.full((B, H, D), -1e30, dtype=torch.float32, device=dev)
    out = torch.empty((B, S, H, D), dtype=zz.dtype, device=dev)
    for t in range(S):
        c, n, m, out[:, t] = _slstm_cell(c, n, m, lf[:, t], li[:, t],
                                         z[:, t], o[:, t])
    return out


def slstm_step(state, zi: torch.Tensor, zf: torch.Tensor, zz: torch.Tensor,
               zo: torch.Tensor):
    """O(1) sLSTM decode step. state: (c, n, m), each (B, H, D) f32;
    pre-activations (B, 1, H, D). Returns ((c, n, m), h (B, 1, H, D))."""
    c, n, m = state
    lf, li, z, o = _slstm_gates(zi[:, 0], zf[:, 0], zz[:, 0], zo[:, 0])
    c2, n2, m2, h = _slstm_cell(c, n, m, lf, li, z, o)
    return (c2, n2, m2), h[:, None].to(zz.dtype)


def ssm_scan(x: torch.Tensor, delta: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, A_log: torch.Tensor,
             chunk: int = 256) -> torch.Tensor:
    """Chunkwise diagonal selective SSM, the reference's ``ssm_scan``: a
    Python loop over chunks of ``_pick_chunk(S, chunk)`` carrying the
    state h (B, H, N, D) in f32.

    x: (B, S, H, D); delta: (B, S, H); Bmat/Cmat: (B, S, H, N); A_log
    (H, N) (A = -exp(A_log)). h_t = exp(delta_t A) h_{t-1} + delta_t B_t
    x_t^T; y_t = C_t . h_t. The intra-chunk weights (B, L, M, H, N) are
    formed once a chunk, as the reference forms them, and reduced in
    place. Returns (B, S, H, D) in x's dtype."""
    B, S, H, D = x.shape
    L = _pick_chunk(S, chunk)
    dev = x.device
    A = -torch.exp(A_log.float())                         # (H, N)
    dt = _softplus(delta.float())                         # (B, S, H)
    lg = dt[..., None] * A                                # (B, S, H, N)
    xB = dt[..., None] * Bmat.float()
    above = ~_tril(L, dev)[None, :, :, None, None]        # (1, L, M, 1, 1)
    h = torch.zeros((B, H, Bmat.shape[-1], D), dtype=torch.float32,
                    device=dev)
    out = torch.empty((B, S, H, D), dtype=x.dtype, device=dev)
    for s0 in range(0, S, L):
        xc = x[:, s0:s0 + L].float()
        bc = xB[:, s0:s0 + L]
        cc = Cmat[:, s0:s0 + L].float()
        LG = torch.cumsum(lg[:, s0:s0 + L], dim=1)        # (B, L, H, N)
        tot = LG[:, -1]                                   # (B, H, N)
        y = torch.einsum("blhn,bhnd->blhd", cc * torch.exp(LG), h)
        # y_intra[t] = sum_s C_t . (w[t, s] B_s) x_s, w = exp(LG_t - LG_s)
        w = (LG[:, :, None] - LG[:, None]).exp_().masked_fill_(above, 0.0)
        cb = w.mul_(cc[:, :, None]).mul_(bc[:, None]).sum(-1)  # (B, L, M, H)
        del w
        y += torch.einsum("blmh,bmhd->blhd", cb, xc)
        out[:, s0:s0 + L] = y
        wk = torch.exp(tot[:, None] - LG)                 # (B, L, H, N)
        h = torch.exp(tot)[..., None] * h + torch.einsum(
            "blhn,blhd->bhnd", wk * bc, xc)
    return out


def ssm_step(h: torch.Tensor, x: torch.Tensor, delta: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, A_log: torch.Tensor):
    """O(1) SSM decode step. h: (B, H, N, D) f32; x (B, 1, H, D), delta
    (B, 1, H), Bmat/Cmat (B, 1, H, N). Returns (h', y (B, 1, H, D))."""
    A = -torch.exp(A_log.float())
    dt = _softplus(delta[:, 0].float())                   # (B, H)
    dec = torch.exp(dt[..., None] * A)                    # (B, H, N)
    xb = dt[..., None] * Bmat[:, 0].float()               # (B, H, N)
    h2 = dec[..., None] * h + xb[..., None] * x[:, 0].float()[:, :, None]
    y = torch.einsum("bhn,bhnd->bhd", Cmat[:, 0].float(), h2)
    return h2, y[:, None].to(x.dtype)
