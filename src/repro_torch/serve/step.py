"""Serving: prefill (populate the KV cache from a prompt through the full
forward, whose plain causal or full attention is the flash kernel) and
serve_step (one batched greedy decode step; whisper's cross-attention
over the encoder memory is the flash kernel there too)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import full_precision_matmuls
from ..models import decode_step, forward, init_decode_cache
from ..models.config import ArchConfig


def make_serve_step(cfg: ArchConfig) -> Callable:
    """serve_step(params, cache, tokens (B, 1), t) -> (next_tokens,
    logits, cache). Greedy argmax sampling; ``t`` is a Python int and the
    cache is updated in place. Sets the full-precision matmul flags
    (``device.full_precision_matmuls``)."""
    full_precision_matmuls()
    def serve_step(params, cache, tokens, t: int):
        logits, cache = decode_step(cfg, params, cache, tokens, t)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return serve_step


def make_prefill(cfg: ArchConfig, max_len: int) -> Callable:
    """prefill(params, batch) -> (cache, last_logits). Runs the full
    forward with ``return_cache`` (every position's logits, as the
    reference does) and writes the per-layer k and v, (L, B, S, Hk, Dh),
    into a zeroed cache of ``max_len`` positions at position 0. B comes
    from the tokens and S from the forward's k, so llava's image
    positions are cached too; whisper's cache takes the encoder memory
    ``enc_out``. Sets the full-precision matmul flags
    (``device.full_precision_matmuls``)."""
    full_precision_matmuls()
    def prefill(params, batch):
        out = forward(cfg, params, batch, return_cache=True)
        tokens = batch["tokens"]
        cache = init_decode_cache(cfg, tokens.shape[0], max_len,
                                  device=tokens.device)
        k, v = out.cache["kv"]
        S = k.shape[2]
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
        if cfg.enc_dec:
            cache["enc_out"] = out.cache["enc_out"]
        # a copy, so the (B, S, V) logits are freed on return
        return cache, out.logits[:, -1:].clone()
    return prefill


def greedy_generate(cfg: ArchConfig, params, prompt: torch.Tensor,
                    n_new: int, max_len: Optional[int] = None
                    ) -> torch.Tensor:
    """Reference end-to-end generation loop (token by token from position
    0, through decode steps only); returns (B, n_new) int32 tokens."""
    B, S0 = prompt.shape
    max_len = max_len or (S0 + n_new)
    cache = init_decode_cache(cfg, B, max_len, device=prompt.device)
    step = make_serve_step(cfg)
    cur = prompt[:, :1]
    out = []
    for t in range(S0 + n_new - 1):
        cur = prompt[:, t:t + 1] if t < S0 else cur
        nxt, _, cache = step(params, cache, cur, t)
        if t >= S0 - 1:
            out.append(nxt)
            cur = nxt
    return torch.cat(out, dim=1) if out else prompt[:, :0].to(torch.int32)
