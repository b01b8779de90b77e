"""Model assembly for the transformer families of ``repro.models``:
parameter init, the stacked-layer forward (a Python loop where the
reference scans), prefill-with-cache and single-token decode.

The port serves the dense family (smollm-135m, granite-8b,
deepseek-coder-33b and gemma2-9b with its local/global windows, post-norms
and softcaps), MoE (qwen3-moe-235b-a22b, grok-1-314b; sort-based dispatch,
``layers.moe_ffn``), the llava backbone (image embeddings prepended to the
tokens) and whisper's encoder-decoder (the encoder memory kept in the
decode cache). The ssm (xLSTM) and hybrid (hymba) families raise
``NotImplementedError`` (ROADMAP Queue 1 item 7)."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import blocks, layers
from .blocks import GLOBAL_WINDOW
from .config import ArchConfig

Params = Dict[str, Any]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_served(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config this slice does not
    serve: the recurrent families."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the "
            "port serves the dense, MoE, vlm and audio families (ROADMAP "
            "Queue 1 item 7)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, H, Hk, Dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    p: Dict[str, Tuple[int, ...]] = dict(
        ln1=(d,), ln2=(d,), wq=(d, H * Dh), wk=(d, Hk * Dh),
        wv=(d, Hk * Dh), wo=(H * Dh, d))
    if cfg.local_global_period:           # gemma2 post-norms
        p.update(ln1_post=(d,), ln2_post=(d,))
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        p.update(router=(d, E), moe_w_gate=(E, d, ff), moe_w_up=(E, d, ff),
                 moe_w_down=(E, ff, d))
    elif cfg.enc_dec:
        p.update(w1=(d, ff), w2=(ff, d))   # whisper GELU MLP
    else:
        p.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
    if cfg.enc_dec:                       # decoder cross-attention
        p.update(ln_x=(d,), wq_x=(d, H * Dh), wk_x=(d, Hk * Dh),
                 wv_x=(d, Hk * Dh), wo_x=(H * Dh, d))
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """The parameter dict with the reference's names, shapes and scales
    (norm weights zero, matrices normal * fan_in ** -0.5, embeddings and
    whisper's ``enc_pos`` normal * 0.02; blocks stacked on a leading layer
    axis, whisper's encoder in ``enc_blocks``), drawn in f32 on the
    generator's device from ``generator`` and cast to ``cfg.dtype`` on
    ``device``. A stack is drawn a layer at a time into its preallocated
    ``cfg.dtype`` tensor, so the f32 draw never holds more than one
    layer of one weight. The numbers differ from ``jax.random``'s; tests
    carry the reference's weights across with
    ``convert.params_from_numpy`` instead."""
    check_served(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def draw_into(out: torch.Tensor, scale: float) -> torch.Tensor:
        x = torch.randn(out.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return out.copy_(x.mul_(scale))

    def normal(shape, scale):
        return draw_into(torch.empty(shape, dtype=dt, device=dev), scale)

    def group(shapes: Dict[str, Tuple[int, ...]], L: int) -> Params:
        out: Params = {}
        for name, shp in sorted(shapes.items()):
            if len(shp) == 1:
                out[name] = torch.zeros((L,) + shp, dtype=dt, device=dev)
                continue
            t = torch.empty((L,) + shp, dtype=dt, device=dev)
            for i in range(L):
                draw_into(t[i], shp[0] ** -0.5)
            out[name] = t
        return out

    params: Params = {
        "embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5)
    shapes = _layer_param_shapes(cfg)
    if cfg.enc_dec:
        params["enc_blocks"] = group(
            {k: v for k, v in shapes.items() if not k.endswith("_x")},
            cfg.n_enc_layers)
    params["blocks"] = group(shapes, cfg.n_layers)
    if cfg.enc_dec:
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                         device=dev)
        params["enc_pos"] = normal((cfg.enc_positions, cfg.d_model), 0.02)
    return params


def window_schedule(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (GLOBAL_WINDOW = full attention)."""
    L = cfg.n_layers
    w = np.full((L,), GLOBAL_WINDOW, np.int32)
    if cfg.local_global_period and cfg.sliding_window:
        for i in range(L):                 # gemma2: local on even layers
            if i % cfg.local_global_period == 0:
                w[i] = cfg.sliding_window
    elif cfg.family == "hybrid" and cfg.sliding_window:
        w[:] = cfg.sliding_window          # hymba: SWA everywhere except
        for i in (0, L // 2, L - 1):       # first / middle / last global
            w[i] = GLOBAL_WINDOW
    return w


def _layer(stack: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into a stacked group."""
    return {k: v[i] for k, v in stack.items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    cache: Optional[Any]          # {"kv": (k, v)}, each (L, B, S, Hk, Dh),
                                  # and whisper's "enc_out" (B, Te, d)


def _embed_tokens(cfg: ArchConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``; gemma scales them by
    sqrt(d_model) rounded to that dtype first, as the reference's
    ``x * asarray(d_model ** 0.5, dt)`` does."""
    dt = _dtype(cfg)
    x = params["embed"][tokens.long()].to(dt)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    return x


def _embed_inputs(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    """The token embeddings, after llava's image embeddings (B, Ni, d)
    where the batch has them."""
    x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.n_img_tokens and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    return x


def _unembed(cfg: ArchConfig, params: Params, x: torch.Tensor
             ) -> torch.Tensor:
    """f32 logits of hidden states, as the reference's einsum with
    ``preferred_element_type=float32`` gives them (products of bf16
    values are exact in f32), then ``final_softcap``, applied in place
    (gemma2's 2 x 8192 x 256000 logits are 16.8 GB in f32)."""
    unemb = params.get("unembed")
    if unemb is None:
        unemb = params["embed"].T
    logits = x.float() @ unemb.float()
    cap = cfg.final_softcap
    if cap is not None:
        logits.div_(cap).tanh_().mul_(cap)
    return logits


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, return_cache: bool = False, q_offset: int = 0,
            logits_mode: str = "all") -> ForwardOut:
    """Full-sequence forward. batch: tokens (B, S) int; llava adds
    image_embeds (B, Ni, d); whisper adds frames (B, Te, d).

    logits_mode: 'all' (every position, f32), 'last' (unembed only the
    final position), 'hidden' (the final hidden states in ``.logits``)."""
    check_served(cfg)
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = q_offset + torch.arange(S, dtype=torch.int32,
                                        device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    extra = {}
    if cfg.enc_dec:
        enc = batch["frames"].to(x.dtype)
        enc = enc + params["enc_pos"][None, :enc.shape[1]].to(x.dtype)
        for i in range(cfg.n_enc_layers):
            enc = blocks.whisper_encoder_block(
                cfg, _layer(params["enc_blocks"], i), enc)
        enc = layers.rms_norm(enc, params["enc_norm"], cfg.norm_eps)
        for i in range(cfg.n_layers):
            x, k, v = blocks.whisper_decoder_block(
                cfg, _layer(params["blocks"], i), x, enc, positions)
            if return_cache:
                ks.append(k)
                vs.append(v)
        extra["enc_out"] = enc
    else:
        for i, w in enumerate(window_schedule(cfg)):
            lp = _layer(params["blocks"], i)
            a = blocks.attention_block(cfg, lp, x, positions, window=int(w),
                                       q_offset=q_offset)
            x, aux = blocks.ffn_block(cfg, lp, a.y)
            aux_total = aux_total + aux
            if return_cache:
                ks.append(a.k)
                vs.append(a.v)
    cache = {"kv": (torch.stack(ks), torch.stack(vs)), **extra} \
        if return_cache else None
    del ks, vs                    # the stack holds copies: free before
                                  # the unembed's f32 buffers

    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_mode == "hidden":
        return ForwardOut(x, aux_total, cache)
    if logits_mode == "last":
        x = x[:, -1:]
    return ForwardOut(_unembed(cfg, params, x), aux_total, cache)


# ---------------------------------------------------------------------------
# decode (single token, KV caches)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The zeroed KV cache, k and v each (L, B, max_len, Hk, Dh) in
    ``cfg.dtype``; whisper's also holds the encoder memory ``enc_out``
    (B, enc_positions, d)."""
    check_served(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.enc_dec:
        cache["enc_out"] = torch.zeros((batch, cfg.enc_positions,
                                        cfg.d_model), dtype=dt, device=dev)
    return cache


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                tokens: torch.Tensor, t: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1) at position ``t`` (a Python int) ->
    logits (B, 1, V) f32 and the cache. The cache is updated in place
    (row ``t`` of every layer's k and v), where the reference returns new
    arrays; the returned cache is the same dict. Whisper's step attends
    over ``cache["enc_out"]`` in every layer (the flash kernel on CUDA)."""
    check_served(cfg)
    x = _embed_tokens(cfg, params, tokens)
    if cfg.enc_dec:
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            x, _, _ = blocks.attention_decode(cfg, lp, x, cache["k"][i],
                                              cache["v"][i], t)
            x = blocks.cross_attention(cfg, lp, x, cache["enc_out"])
            x = blocks.gelu_mlp(lp, x, cfg.norm_eps)
    else:
        for i, w in enumerate(window_schedule(cfg)):
            lp = _layer(params["blocks"], i)
            x, _, _ = blocks.attention_decode(cfg, lp, x, cache["k"][i],
                                              cache["v"][i], t,
                                              window=int(w))
            x, _ = blocks.ffn_block(cfg, lp, x)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, x), cache
