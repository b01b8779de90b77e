"""Recurrent and hybrid block forwards of the port (``repro.models.
recurrent``): xLSTM's mLSTM and sLSTM blocks and hymba's parallel
attention + SSM layer, each with its O(1) decode step.

The mLSTM weights keep the reference's Dh-major layout: wq3/wk3/wv3/w_z3
(d, Dh, H) and w_down3 (Dh, H, d), so ``einsum("bsd,dvh->bshv")`` gives
(B, S, H, Dh) with the head axis inner in the weight. ``_heads`` computes
it as one (d, Dh * H) matmul whose output is unflattened to (Dh, H) and
transposed, exactly as the einsum indexes it. The scans are the plain
torch ones of ``layers``; hymba's global layers reach the flash kernel
through ``layers.flash_attention``."""
from __future__ import annotations

import torch

from . import blocks, layers
from .config import ArchConfig

_GATE_CAP = 15.0  # softcap on log input gate pre-activations (stability)


def _heads(h: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dvh->bshv", h, w3)``: (B, S, d) @ (d, Dh, H) ->
    (B, S, H, Dh)."""
    d, Dh, H = w3.shape
    return (h @ w3.reshape(d, Dh * H)).unflatten(-1, (Dh, H)).transpose(-1,
                                                                        -2)


def _down3(y: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """``einsum("bshv,vhd->bsd", y, w3)``: (B, S, H, Dh) @ (Dh, H, d)."""
    Dh, H, d = w3.shape
    return y.transpose(-1, -2).reshape(*y.shape[:2], Dh * H) @ \
        w3.reshape(Dh * H, d)


# --- xLSTM: mLSTM block -----------------------------------------------------

def _mlstm_qkvzg(cfg: ArchConfig, p, h):
    q, k, v, z = (_heads(h, p[name]) for name in ("wq3", "wk3", "wv3",
                                                   "w_z3"))
    gates = h @ p["w_if"]                                  # (B, S, 2H)
    H = cfg.n_heads
    log_i = layers.softcap(gates[..., :H].float(), _GATE_CAP)
    log_f = layers._log_sigmoid(gates[..., H:].float())
    return q, k, v, z, log_i, log_f


def _mlstm_out(x, p, y, z):
    y = y * torch.nn.functional.silu(z.float()).to(x.dtype)
    return x + _down3(y, p["w_down3"])


def mlstm_block(cfg: ArchConfig, p, x):
    """Pre-norm mLSTM block (no causal conv; gates and projections from
    the normed stream, as in the reference)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v, z, log_i, log_f = _mlstm_qkvzg(cfg, p, h)
    return _mlstm_out(x, p, layers.mlstm_scan(q, k, v, log_f, log_i), z)


def mlstm_block_step(cfg: ArchConfig, p, x, state):
    """O(1) decode step; state = (C, n). Returns (x, (C, n))."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v, z, log_i, log_f = _mlstm_qkvzg(cfg, p, h)
    state, y = layers.mlstm_step(state, q, k, v, log_f, log_i)
    return _mlstm_out(x, p, y, z), state


# --- xLSTM: sLSTM block -----------------------------------------------------

def _slstm_preact(cfg: ArchConfig, p, h):
    B, S, _ = h.shape
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    return tuple((h @ p[name]).reshape(B, S, H, Dh)
                 for name in ("w_zi", "w_zf", "w_zz", "w_zo"))


def slstm_block(cfg: ArchConfig, p, x):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    y = layers.slstm_scan(*_slstm_preact(cfg, p, h))
    return x + y.reshape(*x.shape[:2], -1) @ p["w_down"]


def slstm_block_step(cfg: ArchConfig, p, x, state):
    """O(1) decode step; state = (c, n, m). Returns (x, (c, n, m))."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    state, y = layers.slstm_step(state, *_slstm_preact(cfg, p, h))
    return x + y.reshape(x.shape[0], 1, -1) @ p["w_down"], state


# --- Hymba: parallel attention + SSM heads ----------------------------------

def _hymba_ssm_in(cfg: ArchConfig, p, h):
    """The SSM branch's inputs: x (B, S, H, Dh), delta (B, S, H), B and C
    (B, S, H, N)."""
    B, S, _ = h.shape
    H, Dh, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    return ((h @ p["ssm_in"]).reshape(B, S, H, Dh), h @ p["ssm_dt"],
            (h @ p["ssm_B"]).reshape(B, S, H, N),
            (h @ p["ssm_C"]).reshape(B, S, H, N))


def _hymba_fuse_ffn(cfg: ArchConfig, p, x, ya, ys):
    """The average of the per-branch RMS-normalized outputs through the
    shared output projection, then the dense SwiGLU FFN."""
    fused = 0.5 * (layers.rms_norm(ya, p["attn_norm"], cfg.norm_eps)
                   + layers.rms_norm(ys, p["ssm_norm"], cfg.norm_eps))
    x = x + fused @ p["wo"]
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.swiglu(h2, p["w_gate"], p["w_up"], p["w_down"])


def hymba_block(cfg: ArchConfig, p, x, positions, *, window: int,
                q_offset: int = 0):
    """Attention and the Mamba-style SSM on the same normed input, fused
    (meta-tokens omitted, as in the reference). ``window`` is the layer's
    Python int (``GLOBAL_WINDOW`` for the global layers). Returns
    (x, k after rope, v)."""
    B, S, _ = x.shape
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = blocks._qkv(cfg, p, h, positions)
    ya = layers.flash_attention(q, k, v, causal=True, window=window,
                                q_offset=q_offset).reshape(B, S, -1)
    ys = layers.ssm_scan(*_hymba_ssm_in(cfg, p, h), p["A_log"])
    return _hymba_fuse_ffn(cfg, p, x, ya, ys.reshape(B, S, -1)), k, v


def hymba_block_step(cfg: ArchConfig, p, x, k_cache, v_cache, ssm_state,
                     t: int):
    """Decode step at position ``t`` (a Python int). The KV cache is a
    ring buffer of T_cache positions (the layer's window, or max_len):
    this token goes to slot t % T_cache, written in place, and the
    attention reads the min(t + 1, T_cache) valid entries with no
    window. Returns (x, k_cache, v_cache, ssm_state)."""
    B = x.shape[0]
    T_cache = k_cache.shape[1]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = blocks._qkv(cfg, p, h, positions)
    slot = t % T_cache
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    ya = layers.decode_attention(q, k_cache, v_cache, min(t + 1, T_cache))
    xs, dt, Bm, Cm = _hymba_ssm_in(cfg, p, h)
    ssm_state, ys = layers.ssm_step(ssm_state, xs, dt, Bm, Cm, p["A_log"])
    x = _hymba_fuse_ffn(cfg, p, x, ya.reshape(B, 1, -1),
                        ys.reshape(B, 1, -1))
    return x, k_cache, v_cache, ssm_state
