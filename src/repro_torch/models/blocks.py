"""Per-layer block forwards of the uniform transformer families (the
port's ``repro.models.blocks``: dense / MoE / gemma2-style local-global
/ llava backbone / whisper).

Every function takes the layer's param dict and returns the residual
stream. ``window`` is a per-layer Python int; ``GLOBAL_WINDOW`` (2**30)
means global attention, which ``layers.flash_attention`` sends to the
kernel when there is no softcap.

In the sharded train step a model-sharded weight arrives as
``distributed.placement.ModelShards``. Attention splits over ``model``
where whole heads fall to each shard (``sharding.heads_split``): each
shard projects its q and KV heads from its columns of wq/wk/wv, runs
rope and ``layers.flash_attention`` on them, and multiplies by its rows
of wo, and ``sum_model`` adds the partial outputs (gemma2's
``ln1_post`` after the sum). Where the heads do not divide (smollm's
9/3 at 2 or 4 shards) the layer's attention weights are gathered whole
instead: splitting them by columns would cut heads and gather each
row's activations, and at smollm's widths a layer's wq/wk/wv/wo are 1.8
MB in bf16 where one 4 x 2048-token row's q is 9.4 MB. The MLPs split
by ``layers.model_parallel``; such a layer returns no k and v."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..distributed import placement as PL
from . import layers
from .config import ArchConfig
from .sharding import heads_split

GLOBAL_WINDOW = 1 << 30


class AttnOut(NamedTuple):
    y: torch.Tensor
    k: Optional[torch.Tensor]     # None where the layer split over model
    v: Optional[torch.Tensor]


def _qkv(cfg: ArchConfig, p, x, positions):
    """q, k, v of the heads ``p``'s wq/wk/wv hold (all of them, or one
    model shard's), q and k after rope."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, -1, Dh)
    k = (x @ p["wk"]).reshape(B, S, -1, Dh)
    v = (x @ p["wv"]).reshape(B, S, -1, Dh)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_row(cfg: ArchConfig, p, names):
    """The ``ModelRow`` when the attention weights ``names`` of ``p``
    split over ``model`` (``heads_split``), else None: a model-sharded
    one among them is then gathered whole into ``p``. Raises where the
    heads split but a weight is not model-sharded."""
    w = p[names[0]]
    if isinstance(w, torch.Tensor):
        return None
    if not heads_split(cfg, w.row.tp):
        for n in names:
            p[n] = layers.whole(p[n])
        return None
    if any(isinstance(p[n], torch.Tensor) for n in names):
        raise ValueError(f"{names}: whole heads split over {w.row.tp} "
                         f"shards, but not every weight is model-sharded")
    return w.row


def _project_out(y: torch.Tensor, wo) -> torch.Tensor:
    return y.reshape(y.shape[0], y.shape[1], -1) @ wo


def attention_block(cfg: ArchConfig, p, x, positions, *, window=None,
                    causal=True, q_offset=0) -> AttnOut:
    """Pre-norm attention with gemma2's post-norm where the layer has
    one; returns the residual and this layer's k, v (None for a layer
    split over ``model``: see the module's docstring)."""
    p = dict(p)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    kw = dict(causal=causal, window=window, logit_softcap=cfg.attn_softcap,
              q_offset=q_offset)
    names = ("wq", "wk", "wv", "wo")
    row = _attn_row(cfg, p, names)
    if row is None:
        q, k, v = _qkv(cfg, p, h, positions)
        y = _project_out(layers.flash_attention(q, k, v, **kw), p["wo"])
    else:
        k = v = None
        ys = []
        for j, hj in enumerate(PL.to_model(h, row)):
            pj = {n: p[n].parts[j] for n in names}
            q, kj, vj = _qkv(cfg, pj, hj, positions.to(hj.device))
            ys.append(_project_out(layers.flash_attention(q, kj, vj, **kw),
                                   pj["wo"]))
        y = PL.sum_model(ys, row)
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
    falls back to ``moe_ffn`` where the reference's does) on whole
    weights."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        moe = {"router": p["router"], "w_gate": p["moe_w_gate"],
               "w_up": p["moe_w_up"], "w_down": p["moe_w_down"]}
        if layers.MOE_EP_MODE:    # its own layout over the ambient mesh
            moe = {k: layers.whole(v) for k, v in moe.items()}
            out = layers.moe_ffn_ep(h, moe, cfg.moe.n_experts,
                                    cfg.moe.top_k, cfg.moe.capacity_factor)
        else:
            out = layers.moe_ffn(h, moe, cfg.moe.n_experts, cfg.moe.top_k,
                                 cfg.moe.capacity_factor)
        y, aux = out.y, out.aux_loss
    else:
        y = layers.model_parallel(layers.swiglu, h, p["w_gate"], p["w_up"],
                                  p["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ln2_post" in p:
        y = layers.rms_norm(y, p["ln2_post"], cfg.norm_eps)
    return x + y, aux


# --- whisper (enc-dec) ------------------------------------------------------

def _gelu_ff(h, w1, w2):
    u = h @ w1
    u = torch.nn.functional.gelu(u.float(), approximate="tanh").to(h.dtype)
    return u @ w2


def gelu_mlp(p, x, eps):
    """Pre-norm GELU MLP. ``jax.nn.gelu`` defaults to the tanh
    approximation, ``torch.nn.functional.gelu`` to the exact erf form;
    the port asks for the tanh one. Model-sharded w1/w2 split
    (``layers.model_parallel``)."""
    h = layers.rms_norm(x, p["ln2"], eps)
    return x + layers.model_parallel(_gelu_ff, h, p["w1"], p["w2"])


def whisper_encoder_block(cfg: ArchConfig, p, x):
    positions = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    a = attention_block(cfg, p, x, positions, causal=False)
    return gelu_mlp(p, a.y, cfg.norm_eps)


def cross_attention(cfg: ArchConfig, p, x, enc_out):
    """Attention of the decoder's positions over the encoder memory
    ``enc_out`` (B, Te, d), non-causal: the flash kernel on CUDA. Split
    over ``model`` as ``attention_block`` is, the encoder memory handed
    to each shard."""
    p = dict(p)
    h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
    names = ("wq_x", "wk_x", "wv_x", "wo_x")

    def attend(h, enc, wq, wk, wv, wo):
        B, S, _ = h.shape
        Dh = cfg.head_dim
        q = (h @ wq).reshape(B, S, -1, Dh)
        k = (enc @ wk).reshape(B, enc.shape[1], -1, Dh)
        v = (enc @ wv).reshape(B, enc.shape[1], -1, Dh)
        return _project_out(layers.flash_attention(q, k, v, causal=False),
                            wo)

    row = _attn_row(cfg, p, names)
    if row is None:
        return x + attend(h, enc_out, *(p[n] for n in names))
    ys = [attend(hj, ej, *(p[n].parts[j] for n in names)) for j, (hj, ej)
          in enumerate(zip(PL.to_model(h, row), PL.to_model(enc_out, row)))]
    return x + PL.sum_model(ys, row)


def whisper_decoder_block(cfg: ArchConfig, p, x, enc_out, positions):
    a = attention_block(cfg, p, x, positions, causal=True)
    h = cross_attention(cfg, p, a.y, enc_out)
    return gelu_mlp(p, h, cfg.norm_eps), a.k, a.v
