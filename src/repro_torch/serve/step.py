"""Serving: prefill (populate the KV cache from a prompt through the full
forward, whose plain causal or full attention is the flash kernel) and
serve_step (one batched greedy decode step; whisper's cross-attention
over the encoder memory is the flash kernel there too)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import full_precision_matmuls
from ..distributed import placement as PL
from ..models import (decode_step, decode_step_model, forward,
                      init_decode_cache)
from ..models.config import ArchConfig
from ..models.model import unembed_shards


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
    ``enc_out``. The recurrent families' caches are returned as
    ``init_decode_cache`` made them, as the reference returns them: xLSTM's
    forward threads no state out, and hymba's per-layer cache has no
    stacked "k" to write (their states come from decoding from position
    0, ``greedy_generate``). Sets the full-precision matmul flags
    (``device.full_precision_matmuls``)."""
    full_precision_matmuls()
    def prefill(params, batch):
        out = forward(cfg, params, batch, return_cache=True)
        tokens = batch["tokens"]
        cache = init_decode_cache(cfg, tokens.shape[0], max_len,
                                  device=tokens.device)
        if cfg.family in ("ssm", "hybrid"):
            return cache, out.logits[:, -1:].clone()
        k, v = out.cache["kv"]
        S = k.shape[2]
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
        if cfg.enc_dec:
            cache["enc_out"] = out.cache["enc_out"]
        # a copy, so the (B, S, V) logits are freed on return
        return cache, out.logits[:, -1:].clone()
    return prefill


def _generate(cfg: ArchConfig, step: Callable, prompts, n_new: int,
              max_len: Optional[int]):
    """Greedy generation token by token from position 0 through decode
    steps only, over one prompt batch a row: ``step(caches, tokens, t)``
    gives each row's logits. Returns each row's (B, n_new) int32
    tokens."""
    S0 = prompts[0].shape[1]
    max_len = max_len or (S0 + n_new)
    caches = [init_decode_cache(cfg, p.shape[0], max_len, device=p.device)
              for p in prompts]
    cur = [p[:, :1] for p in prompts]
    out = []
    for t in range(S0 + n_new - 1):
        cur = [p[:, t:t + 1] for p in prompts] if t < S0 else cur
        nxt = [torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
               for lg in step(caches, cur, t)]
        if t >= S0 - 1:
            out.append(nxt)
            cur = nxt
    if not out:
        return [p[:, :0].to(torch.int32) for p in prompts]
    return [torch.cat(col, dim=1) for col in zip(*out)]


def greedy_generate(cfg: ArchConfig, params, prompt: torch.Tensor,
                    n_new: int, max_len: Optional[int] = None
                    ) -> torch.Tensor:
    """Reference end-to-end generation loop (token by token from position
    0, through decode steps only); returns (B, n_new) int32 tokens."""
    full_precision_matmuls()

    def step(caches, tokens, t):
        return [decode_step(cfg, params, caches[0], tokens[0], t)[0]]
    return _generate(cfg, step, [prompt], n_new, max_len)[0]


def _whole_layers(cache, row: PL.ModelRow, rng) -> list:
    """A row's whole cache (``init_decode_cache``'s, its requests the
    batch's [lo, hi) ``rng``) as ``decode_step_model`` takes it: a
    ``placement.CacheShards`` a layer that every model shard of the row
    holds whole."""
    L, _, T, Hk, Dh = cache["k"].shape
    n = len(row.indices)
    box = (tuple(rng), (0, T), (0, Hk), (0, Dh))
    return [PL.CacheShards(row, None, [cache["k"][i]] * n,
                           [cache["v"][i]] * n, [box] * row.tp)
            for i in range(L)]


def greedy_generate_rows(cfg: ArchConfig, params, prompts, n_new: int,
                         rows, max_len: Optional[int] = None):
    """``greedy_generate`` of a MoE config over data rows whose decode
    steps advance together and meet at every MoE layer
    (``models.decode_step_model`` on whole params and each row's whole
    cache): ``params`` and ``prompts`` each local row's of ``rows`` (a
    ``placement.BatchRows``), its prompts its own rows of the batch. The
    MoE routes the whole batch each step, so the tokens are the
    one-device run's whatever the batch. Returns each row's (B_row,
    n_new) int32 tokens."""
    full_precision_matmuls()
    heads = [PL.ModelRow(rows.mesh, q, home)
             for q, home in zip(rows.positions, rows.homes)]

    def step(caches, tokens, t):
        views = [_whole_layers(c, row, rng)
                 for c, row, rng in zip(caches, heads, rows.ranges)]
        hs = decode_step_model(cfg, params, views, tokens, t, rows)
        return [unembed_shards(cfg, p, h)[0][0] for p, h in zip(params, hs)]
    return _generate(cfg, step, prompts, n_new, max_len)
