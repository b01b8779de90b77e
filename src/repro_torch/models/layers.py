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
non-Pallas path, the jnp oracle: ``oracle_attention``) in plain torch,
and routes the plain causal or full case to the hand-written kernel
(``kernels.flash``): when ``window`` masks nothing (None, or at least
T), there is no logit softcap and no query offset. Under autograd the
kernel's output takes the oracle's gradient (``_KernelAttention``), the
gradient ``jax.grad`` takes in the reference. Unlike the reference it
imposes no ``S % 128`` condition: the kernel masks ragged tails. The
kernel computes the Pallas kernel's numbers, which differ from the
oracle's in bf16 (ROADMAP Queue 3).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..distributed import placement as PL
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


def whole(w) -> torch.Tensor:
    """A weight as one tensor: a model-sharded weight of the sharded
    train step (``placement.ModelShards``) gathered over ``model``."""
    return w if isinstance(w, torch.Tensor) else w.full()


def model_parallel(fn, x: torch.Tensor, *ws) -> torch.Tensor:
    """``fn(x, *ws)``, a block whose first weights are split by columns
    and whose last by rows (SwiGLU, GELU MLP, an expert's ff): on
    tensors as it is; on model shards (``placement.ModelShards``, more
    than one) each local shard's ``fn`` on its own weights, the partial
    outputs summed over ``model`` (``placement.sum_model``). Weights
    some of which are model-sharded and some not raise."""
    if all(isinstance(w, torch.Tensor) for w in ws):
        return fn(x, *ws)
    if any(isinstance(w, torch.Tensor) for w in ws):
        raise ValueError("model_parallel: some weights are model-sharded "
                         "and some are not")
    row = ws[0].row
    if row.tp == 1:
        return fn(x, *(w.full() for w in ws))
    return PL.sum_model([fn(xj, *(w.parts[j] for w in ws)) for j, xj in
                         enumerate(PL.to_model(x, row))], row)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ---------------------------------------------------------------------------
# flash-style chunked attention (prefill)
# ---------------------------------------------------------------------------

def _meta_chunk(n: int, target: int, device: torch.device) -> int:
    """``target``, or on ``meta`` (the dry-run: shapes only) at least
    n / 8, so the chunk loops stay short at 32k positions."""
    return max(target, -(-n // 8)) if device.type == "meta" else target


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
    ``kernels.flash.flash_attention`` (through ``_KernelAttention`` when a
    gradient is wanted); the rest runs the reference's chunked oracle in
    plain torch, which autograd differentiates as it is."""
    T = k.shape[1]
    if ((window is None or window >= T) and logit_softcap is None
            and q_offset == 0):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _KernelAttention.apply(q, k, v, causal, q_chunk, k_chunk)
        return kflash.flash_attention(q, k, v, causal=causal)
    return oracle_attention(q, k, v, causal=causal, window=window,
                            logit_softcap=logit_softcap, q_offset=q_offset,
                            q_chunk=q_chunk, k_chunk=k_chunk)


def oracle_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     q_offset: int = 0,
                     q_chunk: int = 512, k_chunk: int = 1024
                     ) -> torch.Tensor:
    """The reference's chunked online-softmax oracle
    (``repro.models.layers.flash_attention`` off its Pallas branch) in
    plain torch: query chunks of ``_pick_chunk(S, q_chunk)``, each against
    every key chunk of ``_pick_chunk(T, k_chunk)``, masked, never the
    whole S x T. Arguments as ``flash_attention``'s."""
    T = k.shape[1]
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qc = _pick_chunk(S, _meta_chunk(S, q_chunk, q.device))
    kc = _pick_chunk(T, _meta_chunk(T, k_chunk, q.device))
    # (B, Hk, G, S, D) and (B, Hk, 1, T, D): head h = hk * G + g
    qr = q.float().reshape(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)
    kr = k.float().permute(0, 2, 1, 3)[:, :, None]
    vr = v.permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((B, Hk, G, S, D), dtype=torch.float32, device=q.device)
    for i0 in range(0, S, qc):
        out[:, :, :, i0:i0 + qc] = _attend_rows(
            qr[:, :, :, i0:i0 + qc], kr, vr, v.dtype, q_offset + i0, kc,
            causal, window, logit_softcap)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def _attend_rows(qb: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor,
                 v_dtype: torch.dtype, q0: int, kc: int, causal: bool,
                 window: Optional[int],
                 logit_softcap: Optional[float]) -> torch.Tensor:
    """One query chunk of the oracle: qb (B, Hk, G, qc, D) f32 at query
    positions q0.., against every key chunk of kr (B, Hk, 1, T, D) f32 and
    vr (its dtype or f32; p is rounded to ``v_dtype`` before p . v, as
    the reference's einsum takes it). Returns (B, Hk, G, qc, D) f32."""
    B, Hk, G, qc, D = qb.shape
    T = kr.shape[3]
    dev = qb.device
    scale = kflash.softmax_scale(D)
    q_pos = q0 + torch.arange(qc, device=dev)
    m = torch.full((B, Hk, G, qc), float("-inf"), device=dev)
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
        s = s.masked_fill(~mask, float("-inf"))
        m2 = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m2 = -inf)
        m_safe = torch.where(torch.isfinite(m2), m2, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = p.masked_fill(~mask, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        pv = torch.matmul(p.to(v_dtype).float(),
                          vr[..., j0:j0 + kc, :].float())
        acc = acc * corr[..., None] + pv
        m = m2
    return acc / torch.clamp_min(l, 1e-37)[..., None]


class _KernelAttention(torch.autograd.Function):
    """The flash kernel's forward with the oracle's gradient.

    Forward: ``kernels.flash.flash_attention`` as it is (on a CUDA tensor
    the kernel, on a CPU tensor its plain version), which saves q, k, v.
    Backward: the gradient of the reference's chunked oracle (the
    function ``jax.grad`` differentiates there: its Pallas kernel has no
    VJP and is off on the training path), recomputed from q, k and v one
    query chunk at a time with ``torch.autograd.grad``, so no more than
    (q_chunk x T) scores a head are held at once. dk and dv sum over the
    chunks in f32 and are cast to k's and v's dtype once, as autograd
    through the whole oracle casts them. No backward kernel: the
    reference has none."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, k_chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_chunk, ctx.k_chunk = causal, q_chunk, k_chunk
        return kflash.flash_attention(q, k, v, causal=causal)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        B, S, H, D = q.shape
        T, Hk = k.shape[1], k.shape[2]
        G = H // Hk
        qc = _pick_chunk(S, _meta_chunk(S, ctx.q_chunk, q.device))
        kc = _pick_chunk(T, _meta_chunk(T, ctx.k_chunk, q.device))
        qr = q.detach().float().reshape(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)
        dor = dout.float().reshape(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)
        kr = k.detach().float().permute(0, 2, 1, 3)[:, :, None] \
            .requires_grad_(True)
        vr = v.detach().float().permute(0, 2, 1, 3)[:, :, None] \
            .requires_grad_(True)
        dq = torch.empty_like(qr)
        dk = torch.zeros_like(kr)
        dv = torch.zeros_like(vr)
        for i0 in range(0, S, qc):
            qb = qr[:, :, :, i0:i0 + qc].detach().requires_grad_(True)
            with torch.enable_grad():
                o = _attend_rows(qb, kr, vr, v.dtype, i0, kc, ctx.causal,
                                 None, None)
                gq, gk, gv = torch.autograd.grad(
                    o, (qb, kr, vr), dor[:, :, :, i0:i0 + qc])
            dq[:, :, :, i0:i0 + qc] = gq
            dk += gk
            dv += gv
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
        dk = dk[:, :, 0].permute(0, 2, 1, 3).to(k.dtype)
        dv = dv[:, :, 0].permute(0, 2, 1, 3).to(v.dtype)
        return dq, dk, dv, None, None, None


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


def _route(xf: torch.Tensor, router: torch.Tensor, E: int, K: int):
    """The router of N tokens xf (N, d): f32 logits and softmax, the top
    ``K`` (``_top_k``) renormalized, and the Switch load-balancing loss
    E * sum_e f_e * P_e. Returns (gate_vals (N, K) f32, expert_ids (N, K)
    int64, aux 0-d f32)."""
    N = xf.shape[0]
    dev = xf.device
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, K)                   # (N, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    me = _mean0_f32(probs)
    ce = _mean0_f32(torch.zeros((N, E), dtype=torch.float32, device=dev)
                    .scatter_add_(1, expert_ids,
                                  torch.ones((N, K), device=dev)))
    return gate_vals, expert_ids, float(E) * torch.sum(me * ce)


def _experts(h_in: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The grouped expert SwiGLU (``torch.bmm``): h_in (E, cap, d) ->
    (E * cap, d) in h_in's dtype, silu in f32."""
    g = torch.bmm(h_in, w_gate)
    u = torch.bmm(h_in, w_up)
    h = torch.nn.functional.silu(g.float()).to(h_in.dtype) * u
    return torch.bmm(h, w_down).reshape(-1, h_in.shape[-1])


def _experts_split(h_in: torch.Tensor, w_gate, w_up,
                   w_down) -> torch.Tensor:
    """``_experts`` on tensors, or over the model shards: split by
    expert (each shard's experts run its rows of ``h_in``, the outputs
    concatenated over ``model``, each expert's its own) or, where the
    experts do not divide, each expert's ff split by columns and rows
    (``model_parallel``)."""
    if (isinstance(w_gate, torch.Tensor) or w_gate.dim != 0
            or w_gate.row.tp == 1):
        return model_parallel(_experts, h_in, w_gate, w_up, w_down)
    row = w_gate.row
    outs = [_experts(hj, w_gate.parts[j], w_up.parts[j], w_down.parts[j])
            for j, hj in enumerate(PL.split_model(h_in, row, 0))]
    return PL.cat_model(outs, row, 0)


def _unsort_sum(weighted: torch.Tensor, order: torch.Tensor,
                k: int) -> torch.Tensor:
    """Each token's ``k`` rows of ``weighted`` (f32, in the order of the
    sort ``order``) summed in a fixed order: un-sorted by the inverse
    permutation, then a sum over k. The reference scatter-adds them; an
    atomic ``index_add_`` would change its bits from run to run."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return weighted[inv].reshape(-1, k, weighted.shape[-1]).sum(1)


def moe_ffn(x: torch.Tensor, p, n_experts: int, top_k: int,
            capacity_factor: float = 1.25) -> MoEOut:
    """Top-k MoE with the reference's sort-based dispatch.

    x: (B, S, d). p: router (d, E), w_gate/w_up (E, d, ff), w_down
    (E, ff, d). Assignments beyond an expert's static capacity are
    dropped exactly where the reference drops them (the same stable sort,
    left search and capacity); aux_loss is the Switch load-balancing loss.
    The grouped expert GEMMs are ``torch.bmm``; with model-sharded
    expert weights the router, the sort and the dispatch buffer stay
    replicated and the experts split (``_experts_split``). The combine
    un-sorts the N*K weighted rows with the inverse permutation of the
    sort and sums each token's K rows in f32, where the reference
    scatter-adds them: no atomics, so the result is the same from run
    to run."""
    B, S, d = x.shape
    N = B * S
    E, K = n_experts, top_k
    dev = x.device
    xf = x.reshape(N, d)
    gate_vals, expert_ids, aux = _route(xf, p["router"], E, K)

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
    out_e = _experts_split(buf[:E * cap].reshape(E, cap, d), p["w_gate"],
                           p["w_up"], p["w_down"])
    out_e = torch.cat([out_e, out_e.new_zeros((1, d))], 0)

    w = (gate_vals.reshape(-1)[order] * keep).float()
    weighted = out_e[slot].float() * w[:, None]               # sorted order
    y = _unsort_sum(weighted, order, K)
    return MoEOut(y.reshape(B, S, d).to(x.dtype), aux)


# --- expert-parallel MoE: the reference's shard_map body, a shard at a time --
# The reference's launchers turn it on with REPRO_MOE_EP=1. Its token
# movement is two all_to_all ops over the model axis; here, on a
# single-process mesh, they are copies of the (tp, cap_send, d) blocks
# between the model shards of one data row (peer copies between cards).

#: route ``blocks.ffn_block``'s MoE through ``moe_ffn_ep``
MOE_EP_MODE = False


class _Dispatch(NamedTuple):
    """One shard's first dispatch: its send blocks and what its combine
    needs back."""
    send: torch.Tensor       # (tp, cap_send, d): rows for each model shard
    send_eid: torch.Tensor   # (tp, cap_send) int32: local expert, -1 pads
    slot: torch.Tensor       # (N_loc * K_eff,): row of each sorted entry
    tok: torch.Tensor        # (N_loc * K_eff,): its token
    order: torch.Tensor      # the stable sort by destination shard
    w: torch.Tensor          # (N_loc * K_eff,) f32: gate weight x keep
    aux: torch.Tensor        # 0-d f32: this shard's load-balancing loss


def _ep_dispatch(xf: torch.Tensor, router: torch.Tensor, *, E: int, K: int,
                 m: int, tp: int, cap_send: int) -> _Dispatch:
    """The body up to the first all_to_all: route the N_loc local tokens,
    copy each (token, virtual expert e*m + j) to its model shard's block
    (e*m + j) // E_loc, first come first served up to ``cap_send`` rows a
    shard (the stable sort by destination, the left searchsorted
    starts); row tp * cap_send takes the dropped ones."""
    N_loc, d = xf.shape
    dev = xf.device
    E_loc = E * m // tp
    K_eff = K * m
    gate_vals, expert_ids, aux = _route(xf, router, E, K)
    # virtualize: assignment (token, expert e) -> m copies (e*m + j)
    virt = expert_ids[..., None] * m + torch.arange(m, device=dev)
    flat_e = virt.reshape(-1)                                  # (N*K*m,)
    gate_rep = gate_vals[..., None].expand(virt.shape).reshape(-1)
    dest = flat_e // E_loc                                     # model shard
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    start = torch.searchsorted(sorted_dest,
                               torch.arange(tp, dtype=dest.dtype, device=dev))
    pos = torch.arange(N_loc * K_eff, device=dev) - start[sorted_dest]
    keep = pos < cap_send
    slot = torch.where(keep, sorted_dest * cap_send + pos, tp * cap_send)
    tok = order // K_eff
    send = torch.zeros((tp * cap_send + 1, d), dtype=xf.dtype, device=dev)
    send[slot] = xf[tok]
    send_eid = torch.full((tp * cap_send + 1,), -1, dtype=torch.int32,
                          device=dev)
    send_eid[slot] = (flat_e % E_loc)[order].to(torch.int32)
    return _Dispatch(send[:-1].reshape(tp, cap_send, d),
                     send_eid[:-1].reshape(tp, cap_send), slot, tok, order,
                     (gate_rep[order] * keep).float(), aux)


def _ep_experts(recv: torch.Tensor, recv_eid: torch.Tensor, w_gate, w_up,
                w_down, *, cap_loc: int) -> torch.Tensor:
    """The body between the all_to_alls on one model shard: recv (tp,
    cap_send, d) from every shard of its data row, grouped by local
    expert (the stable sort on the pad-corrected key, pads last), first
    come first served up to ``cap_loc`` rows an expert, the expert FFN,
    un-grouped into the received layout. Returns back (tp, cap_send, d),
    zero where a row was a pad or dropped."""
    tp, cap_send, d = recv.shape
    E_loc = w_gate.shape[0]
    dev = recv.device
    rx = recv.reshape(tp * cap_send, d)
    re = recv_eid.reshape(tp * cap_send).long()
    key2 = torch.where(re < 0, E_loc, re)
    order2 = torch.argsort(key2, stable=True)
    sorted_key2 = key2[order2]
    sorted_e2 = re[order2]
    start2 = torch.searchsorted(
        sorted_key2, torch.arange(E_loc, dtype=key2.dtype, device=dev))
    pos2 = (torch.arange(tp * cap_send, device=dev)
            - start2[torch.clamp(sorted_e2, 0, E_loc - 1)])
    keep2 = (pos2 < cap_loc) & (sorted_e2 >= 0)
    slot2 = torch.where(keep2, sorted_e2 * cap_loc + pos2, E_loc * cap_loc)
    buf = torch.zeros((E_loc * cap_loc + 1, d), dtype=recv.dtype,
                      device=dev)
    buf[slot2] = rx[order2]
    out_e = _experts(buf[:-1].reshape(E_loc, cap_loc, d), w_gate, w_up,
                     w_down)
    del buf
    out_e = torch.cat([out_e, out_e.new_zeros((1, d))], 0)
    back = torch.zeros((tp * cap_send, d), dtype=recv.dtype, device=dev)
    back[order2] = out_e[slot2] * keep2[:, None]
    return back.reshape(tp, cap_send, d)


def _moe_ep_body(xf: torch.Tensor, router, w_gate, w_up, w_down, devices,
                 *, E: int, K: int, m: int, tp: int, cap_send: int,
                 cap_loc: int):
    """One data row of the reference's shard_map body: xf (N_loc, d) its
    tokens, ``devices`` its tp model shards' devices, w_* the (E * m, d,
    ff / m) virtual-expert weights (shard j holds rows j * E_loc..).
    Returns (y (N_loc, d) in xf's dtype on devices[0], aux).

    As in the reference, every model shard of the row routes the same
    tokens and sends its blocks (the first all_to_all: shard j receives
    block j of every shard, in shard order), runs its E_loc experts on
    what it received, and sends each shard its rows back (the second).
    The reference's ``out_specs`` declare y replicated over ``model``
    (unchecked) and read back model shard 0's; where the second dispatch
    drops the later copies of a hot expert the shards' y differ, so the
    combine runs for model shard 0 alone. aux is the mean over the model
    shards of each shard's loss (its ``pmean``). Each shard's expert
    buffers are freed before the next shard runs."""
    E_loc = E * m // tp
    disp = [_ep_dispatch(xf.to(dev), router.to(dev), E=E, K=K, m=m, tp=tp,
                         cap_send=cap_send) for dev in devices]
    backs = []
    for j, dev in enumerate(devices):
        recv = torch.stack([dp.send[j].to(dev) for dp in disp])
        recv_eid = torch.stack([dp.send_eid[j].to(dev) for dp in disp])
        ws = (w[j * E_loc:(j + 1) * E_loc].to(dev)
              for w in (w_gate, w_up, w_down))
        backs.append(_ep_experts(recv, recv_eid, *ws, cap_loc=cap_loc))
        del recv, recv_eid
    home = devices[0]
    aux = sum(dp.aux.to(home) for dp in disp) / tp
    slot, order, w = disp[0].slot, disp[0].order, disp[0].w
    del disp
    flat_back = torch.cat([b[0].to(home) for b in backs]
                          + [backs[0].new_zeros((1, xf.shape[1]))], 0)
    del backs
    weighted = flat_back[slot].float() * w[:, None]
    y = _unsort_sum(weighted, order, K * m)
    return y.to(xf.dtype), aux


def _ep_devices(mesh, ax) -> np.ndarray:
    """``mesh``'s devices as (dp, tp): the batch axes flattened in
    ``ax.batch`` order (the data rows), the model axis last."""
    names = list(mesh.axis_names)
    order = [names.index(a) for a in ax.batch] + [names.index(ax.model)]
    if len(order) != len(names):
        raise ValueError(f"moe_ffn_ep: mesh axes {mesh.axis_names} beyond "
                         f"{ax.batch + (ax.model,)}")
    devs = np.transpose(mesh.devices, order)
    return devs.reshape(-1, devs.shape[-1])


def moe_ffn_ep(x: torch.Tensor, p, n_experts: int, top_k: int,
               capacity_factor: float = 1.25) -> MoEOut:
    """Expert-parallel MoE over the ambient ``(data, model)`` or ``(pod,
    data, model)`` mesh (``with mesh:``): tokens split over the batch
    axes, experts over ``model`` (``_moe_ep_body`` a data row, each model
    shard on its device). E < tp is handled by ff-sliced virtual experts
    (m = tp / gcd(E, tp) slices an expert, each computing a partial
    down-projection that the combine sums). Falls back to the dense
    ``moe_ffn`` without an ambient mesh, when ff % m, (E * m) % tp or
    (B * S) % dp is non-zero, and for B * S <= 4096 tokens, where the
    reference does. y is on x's device; aux is the mean of the per-shard
    losses over ``model``, then over each batch axis in turn."""
    from ..launch.mesh import active_mesh
    from .sharding import ambient_axes
    ax = ambient_axes()
    if ax is None:
        return moe_ffn(x, p, n_experts, top_k, capacity_factor)
    sizes = active_mesh().shape
    tp = sizes.get("model", 1)
    dp = math.prod(sizes.get(a, 1) for a in ax.batch)

    B, S, d = x.shape
    E, K = n_experts, top_k
    ff = p["w_gate"].shape[-1]
    m = tp // math.gcd(E, tp)
    if ff % m or (E * m) % tp or (B * S) % dp:
        return moe_ffn(x, p, n_experts, top_k, capacity_factor)
    if B * S <= 4096:
        # decode-shaped calls: too few tokens to amortize the exchange;
        # the dense dispatch is cheap at this size (the reference's rule)
        return moe_ffn(x, p, n_experts, top_k, capacity_factor)

    def virt3(w):                       # (E, d, ff) -> (E*m, d, ff/m)
        Ew, dw, fw = w.shape
        return (w.reshape(Ew, dw, m, fw // m).permute(0, 2, 1, 3)
                .reshape(Ew * m, dw, fw // m))

    def virt_down(w):                   # (E, ff, d) -> (E*m, ff/m, d)
        Ew, fw, dw = w.shape
        return w.reshape(Ew * m, fw // m, dw)

    wg, wu, wd = virt3(p["w_gate"]), virt3(p["w_up"]), virt_down(p["w_down"])
    N = B * S
    N_loc = N // dp
    K_eff = K * m
    cap_send = max(int(np.ceil(N_loc * K_eff / tp * capacity_factor / 8))
                   * 8, 8)
    # a shard receives <= tp*cap_send rows spread over its E_loc experts
    E_loc = E * m // tp
    cap_loc = max(int(np.ceil(tp * cap_send / E_loc
                              * capacity_factor / 8)) * 8, 8)

    devs = _ep_devices(active_mesh(), ax)
    xf = x.reshape(N, d)
    ys, auxs = [], []
    for r in range(dp):
        y, aux = _moe_ep_body(xf[r * N_loc:(r + 1) * N_loc], p["router"],
                              wg, wu, wd, [torch.device(v) for v in devs[r]],
                              E=E, K=K, m=m, tp=tp, cap_send=cap_send,
                              cap_loc=cap_loc)
        ys.append(y.to(x.device))
        auxs.append(aux.to(x.device))
    # the reference's pmean over each batch axis in turn (pod, then data)
    aux_t = torch.stack(auxs).reshape(
        [sizes[a] for a in ax.batch])
    for _ in ax.batch:
        aux_t = aux_t.sum(0) / aux_t.shape[0]
    return MoEOut(torch.cat(ys, 0).reshape(B, S, d), aux_t)


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
        # w[t, s] = exp(LF_t - LF_s + li_s), s <= t      (B, L, M, H); the
        # exponent is masked to -inf before the exp, not the exp after it
        # (the reference's order): the same values, but above the
        # diagonal the exponent overflows, and exp's gradient there is
        # 0 * inf = nan
        w = torch.exp((LF[:, :, None] - LF[:, None] + li[:, None])
                      .masked_fill(~tri, float("-inf")))
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
    place (0.84 GB a chunk at hymba's 8 x 2048), or out of place when
    autograd records the scan: it saves the tensors the in-place form
    overwrites. Both forms give the same bits. Returns (B, S, H, D) in
    x's dtype."""
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
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, delta, Bmat, Cmat, A_log))
    for s0 in range(0, S, L):
        xc = x[:, s0:s0 + L].float()
        bc = xB[:, s0:s0 + L]
        cc = Cmat[:, s0:s0 + L].float()
        LG = torch.cumsum(lg[:, s0:s0 + L], dim=1)        # (B, L, H, N)
        tot = LG[:, -1]                                   # (B, H, N)
        y = torch.einsum("blhn,bhnd->blhd", cc * torch.exp(LG), h)
        # y_intra[t] = sum_s C_t . (w[t, s] B_s) x_s, w = exp(LG_t - LG_s),
        # the exponent masked before the exp (as in mlstm_scan)
        if recorded:
            w = torch.exp((LG[:, :, None] - LG[:, None])
                          .masked_fill(above, float("-inf")))
            cb = (w * cc[:, :, None] * bc[:, None]).sum(-1)
        else:
            w = (LG[:, :, None] - LG[:, None]).masked_fill_(
                above, float("-inf")).exp_()
            cb = w.mul_(cc[:, :, None]).mul_(bc[:, None]).sum(-1)
        del w                                             # (B, L, M, H)
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
