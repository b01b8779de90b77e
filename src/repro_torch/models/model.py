"""Model assembly for the dense family: parameter init, the stacked-layer
forward (a Python loop where the reference scans), prefill-with-cache and
single-token decode.

The port serves dense configs without gemma2's local/global window and
softcaps (smollm-135m, granite-8b, deepseek-coder-33b and their smoke
configs). The MoE, vlm, audio (enc-dec), ssm and hybrid families, and
dense configs with ``local_global_period``, ``attn_softcap`` or
``final_softcap``, raise ``NotImplementedError`` (ROADMAP Queue 1
item 7)."""
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
    serve."""
    why = None
    if cfg.family != "dense" or cfg.moe is not None or cfg.enc_dec:
        why = f"the {cfg.family} family"
    elif cfg.local_global_period or cfg.attn_softcap or cfg.final_softcap:
        why = "local/global attention windows and logit softcaps"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported yet; the port serves dense "
            "configs without windows or softcaps (ROADMAP Queue 1 item 7)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, H, Hk, Dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    return dict(ln1=(d,), ln2=(d,), wq=(d, H * Dh), wk=(d, Hk * Dh),
                wv=(d, Hk * Dh), wo=(H * Dh, d), w_gate=(d, ff),
                w_up=(d, ff), w_down=(ff, d))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """The parameter dict with the reference's names, shapes and scales
    (norm weights zero, matrices normal * fan_in ** -0.5, embeddings
    normal * 0.02; blocks stacked on a leading layer axis), drawn in f32
    on the generator's device from ``generator`` and cast to
    ``cfg.dtype`` on ``device``. The numbers differ from ``jax.random``'s;
    tests carry the reference's weights across with
    ``convert.params_from_numpy`` instead."""
    check_served(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(device=dev, dtype=dt)

    params: Params = {
        "embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5)
    L = cfg.n_layers
    block: Params = {}
    for name, shp in sorted(_layer_param_shapes(cfg).items()):
        if len(shp) == 1:
            block[name] = torch.zeros((L,) + shp, dtype=dt, device=dev)
        else:
            block[name] = normal((L,) + shp, shp[0] ** -0.5)
    params["blocks"] = block
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


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked blocks."""
    return {k: v[i] for k, v in params["blocks"].items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    cache: Optional[Any]          # {"kv": (k, v)}, each (L, B, S, Hk, Dh)


def _embed_inputs(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    return params["embed"][batch["tokens"].long()].to(_dtype(cfg))


def _unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of hidden states, as the reference's einsum with
    ``preferred_element_type=float32`` gives them (products of bf16
    values are exact in f32)."""
    unemb = params.get("unembed")
    if unemb is None:
        unemb = params["embed"].T
    return x.float() @ unemb.float()


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, return_cache: bool = False, q_offset: int = 0,
            logits_mode: str = "all") -> ForwardOut:
    """Full-sequence forward. batch: tokens (B, S) int.

    logits_mode: 'all' (every position, f32), 'last' (unembed only the
    final position), 'hidden' (the final hidden states in ``.logits``)."""
    check_served(cfg)
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = q_offset + torch.arange(S, dtype=torch.int32,
                                        device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i, w in enumerate(window_schedule(cfg)):
        lp = _layer(params, i)
        a = blocks.attention_block(cfg, lp, x, positions, window=int(w),
                                   q_offset=q_offset)
        x, aux = blocks.ffn_block(cfg, lp, a.y)
        aux_total = aux_total + aux
        if return_cache:
            ks.append(a.k)
            vs.append(a.v)
    cache = {"kv": (torch.stack(ks), torch.stack(vs))} if return_cache \
        else None

    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_mode == "hidden":
        return ForwardOut(x, aux_total, cache)
    if logits_mode == "last":
        x = x[:, -1:]
    return ForwardOut(_unembed(params, x), aux_total, cache)


# ---------------------------------------------------------------------------
# decode (single token, KV caches)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The zeroed KV cache, k and v each (L, B, max_len, Hk, Dh) in
    ``cfg.dtype``."""
    check_served(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                tokens: torch.Tensor, t: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1) at position ``t`` (a Python int) ->
    logits (B, 1, V) f32 and the cache. The cache is updated in place
    (row ``t`` of every layer's k and v), where the reference returns new
    arrays; the returned cache is the same dict."""
    check_served(cfg)
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    for i, w in enumerate(window_schedule(cfg)):
        lp = _layer(params, i)
        x, _, _ = blocks.attention_decode(cfg, lp, x, cache["k"][i],
                                          cache["v"][i], t, window=int(w))
        x, _ = blocks.ffn_block(cfg, lp, x)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x), cache
