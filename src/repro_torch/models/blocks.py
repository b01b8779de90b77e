"""Per-layer block forwards of the dense transformer family (the port's
``repro.models.blocks``, dense SwiGLU without gemma2's post-norms).

Every function takes the layer's param dict and returns the residual
stream. ``window`` is a per-layer Python int; ``GLOBAL_WINDOW`` (2**30)
means global attention, which ``layers.flash_attention`` sends to the
kernel."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import layers
from .config import ArchConfig

GLOBAL_WINDOW = 1 << 30


class AttnOut(NamedTuple):
    y: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor


def _qkv(cfg: ArchConfig, p, x, positions):
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, Hk, Dh)
    v = (x @ p["wv"]).reshape(B, S, Hk, Dh)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(cfg: ArchConfig, p, x, positions, *, window=None,
                    causal=True, q_offset=0) -> AttnOut:
    """Pre-norm attention; returns the residual and this layer's k, v."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, positions)
    y = layers.flash_attention(
        q, k, v, causal=causal, window=window,
        logit_softcap=cfg.attn_softcap, q_offset=q_offset)
    y = y.reshape(y.shape[0], y.shape[1], -1) @ p["wo"]
    return AttnOut(x + y, k, v)


def attention_decode(cfg: ArchConfig, p, x, k_cache, v_cache, t: int, *,
                     window=None):
    """One-token attention at position ``t``. Writes this token's k and v
    into ``k_cache``/``v_cache`` (B, T, Hk, Dh) in place, where the
    reference returns updated copies; returns (residual, k_cache,
    v_cache) as the reference does."""
    B = x.shape[0]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, h, positions)
    k_cache[:, t] = k[:, 0].to(k_cache.dtype)
    v_cache[:, t] = v[:, 0].to(v_cache.dtype)
    y = layers.decode_attention(q, k_cache, v_cache, t + 1, window=window,
                                logit_softcap=cfg.attn_softcap)
    y = y.reshape(B, 1, -1) @ p["wo"]
    return x + y, k_cache, v_cache


def ffn_block(cfg: ArchConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense SwiGLU; returns (residual, aux_loss = 0)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE FFN is not ported yet (ROADMAP Queue 1 item 7)")
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    y = layers.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)
