"""Per-layer block forwards of the uniform transformer families (the
port's ``repro.models.blocks``: dense / MoE / gemma2-style local-global
/ llava backbone / whisper).

Every function takes the layer's param dict and returns the residual
stream. ``window`` is a per-layer Python int; ``GLOBAL_WINDOW`` (2**30)
means global attention, which ``layers.flash_attention`` sends to the
kernel when there is no softcap."""
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
    """Pre-norm attention with gemma2's post-norm where the layer has
    one; returns the residual and this layer's k, v."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, positions)
    y = layers.flash_attention(
        q, k, v, causal=causal, window=window,
        logit_softcap=cfg.attn_softcap, q_offset=q_offset)
    y = y.reshape(y.shape[0], y.shape[1], -1) @ p["wo"]
    if "ln1_post" in p:
        y = layers.rms_norm(y, p["ln1_post"], cfg.norm_eps)
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
    if "ln1_post" in p:
        y = layers.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    return x + y, k_cache, v_cache


def ffn_block(cfg: ArchConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense SwiGLU or MoE, with gemma2's post-norm where the layer has
    one; returns (residual, aux_loss). The MoE is ``layers.moe_ffn``, or
    under ``layers.MOE_EP_MODE`` the expert-parallel ``moe_ffn_ep`` (which
    falls back to ``moe_ffn`` where the reference's does)."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        moe_impl = layers.moe_ffn_ep if layers.MOE_EP_MODE else layers.moe_ffn
        out = moe_impl(
            h, {"router": p["router"], "w_gate": p["moe_w_gate"],
                "w_up": p["moe_w_up"], "w_down": p["moe_w_down"]},
            cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor)
        y, aux = out.y, out.aux_loss
    else:
        y = layers.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ln2_post" in p:
        y = layers.rms_norm(y, p["ln2_post"], cfg.norm_eps)
    return x + y, aux


# --- whisper (enc-dec) ------------------------------------------------------

def gelu_mlp(p, x, eps):
    """Pre-norm GELU MLP. ``jax.nn.gelu`` defaults to the tanh
    approximation, ``torch.nn.functional.gelu`` to the exact erf form;
    the port asks for the tanh one."""
    h = layers.rms_norm(x, p["ln2"], eps)
    u = h @ p["w1"]
    u = torch.nn.functional.gelu(u.float(), approximate="tanh").to(x.dtype)
    return x + u @ p["w2"]


def whisper_encoder_block(cfg: ArchConfig, p, x):
    positions = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    a = attention_block(cfg, p, x, positions, causal=False)
    return gelu_mlp(p, a.y, cfg.norm_eps)


def cross_attention(cfg: ArchConfig, p, x, enc_out):
    """Attention of the decoder's positions over the encoder memory
    ``enc_out`` (B, Te, d), non-causal: the flash kernel on CUDA."""
    B, S, _ = x.shape
    Te = enc_out.shape[1]
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
    q = (h @ p["wq_x"]).reshape(B, S, H, Dh)
    k = (enc_out @ p["wk_x"]).reshape(B, Te, Hk, Dh)
    v = (enc_out @ p["wv_x"]).reshape(B, Te, Hk, Dh)
    y = layers.flash_attention(q, k, v, causal=False)
    return x + y.reshape(B, S, -1) @ p["wo_x"]


def whisper_decoder_block(cfg: ArchConfig, p, x, enc_out, positions):
    a = attention_block(cfg, p, x, positions, causal=True)
    h = cross_attention(cfg, p, a.y, enc_out)
    return gelu_mlp(p, h, cfg.norm_eps), a.k, a.v
