"""Serving at the reference's dry-run partition: ``make_sharded_prefill``
and ``make_sharded_serve_step``, the port of ``build_prefill_lowered``
and ``build_serve_lowered`` (``repro/launch/dryrun.py``), which jit the
prefill (``model_forward(..., logits_mode="last", return_cache=True)``)
and ``make_serve_step`` with ``in_shardings`` on the production meshes,
for every family: dense and gemma2, MoE, llava, whisper, xLSTM, hymba.

* Params are placed by ``launch.specs.param_shardings``
  (``prefill_param_shardings``: ZeRO-1's split over the batch axes too
  where ``specs.needs_fsdp`` says, as the dry-run's prefill;
  ``serve_param_shardings``: the model split alone, as its decode step)
  and the serving state by ``specs.cache_shardings`` (``place_cache``):
  B over the batch axes, then the largest other dim that divides by tp
  over ``model``. A KV cache splits over its positions T at the serving
  shapes (``decode_32k``, ``long_500k``), whose (B, H, T) scores the
  reference's ``decode_attention`` notes "shard cleanly"; at small sizes
  over Dh, Hk or L, and ``layers.decode_attention_model`` computes the
  same function on each without gathering the cache. Whisper's encoder
  memory splits over its frames (1,500 divide by 2 and 4) or over d
  (at 8 and 16); xLSTM's mLSTM memory over D_out, its other states
  whole on every model shard; hymba's k/v rings over their slots (or
  Dh) and its SSM states over Dh.
* Requests split over the data rows as ``specs.batch_shardings`` splits
  the tokens (every row takes them all where B does not divide), and
  every (data, model) position computes its share, as the sharded train
  step does: attention by whole query heads (``sharding.shard_heads``),
  the MLPs by ff, the embedding and logits by vocabulary, a MoE
  config's rows meeting at every MoE layer (``blocks.moe_block_rows``:
  the dense dispatch, or under ``layers.MOE_EP_MODE`` above 4,096 tokens
  a call each position's own experts, ``layers.moe_ep_rows``), the
  recurrent blocks as their split train step splits them; the entry
  points run with the mesh ambient, as the reference lowers under
  ``use_mesh``.
* The prefill's K/V leave each shard's KV heads and go to the cache's
  split by one all-to-all over ``model`` a layer each
  (``blocks.write_kv``, ``placement.put_model``); whisper's memory is
  written into each position's frames or d columns; xLSTM's and hymba's
  states stay at ``init_decode_cache``'s values, as the reference's
  prefill leaves them. A decode token's k and v go to the shard that
  keeps position t (hymba's: slot t % ring). Whisper's cross-attention
  scores each shard's frames (or sums each shard's d columns' partial
  k and v), xLSTM's and hymba's steps update each shard's part of their
  states (``recurrent``). No position ever holds a leaf of the state
  that ``cache_shardings`` splits whole.
* The greedy argmax runs over the vocabulary shards
  (``placement.argmax_model``: the lowest index on ties).

The mesh is any ``launch.mesh`` mesh: one process with every position on
one device or spread over cards, or one rank a position (NCCL on cards,
gloo on the CPU), where every process passes the whole batch and gets
its own positions' shards back. Every sum runs in model order, so ranks
give the one-process mesh's bits."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from .. import tree
from ..device import full_precision_matmuls
from ..distributed import placement as PL
from ..launch import specs
from ..launch.mesh import entered
from ..models.config import ArchConfig, ShapeConfig
from ..models.layers import CACHE_SPLITS
from ..models.model import decode_step_model, forward_rows, greedy_tokens
from ..models.blocks import write_kv
from ..models.sharding import P, axes_for_mesh


def prefill_param_shardings(cfg: ArchConfig, mesh):
    """The prefill's params: ``param_shardings(zero1=needs_fsdp)``."""
    return specs.param_shardings(cfg, mesh,
                                 zero1=specs.needs_fsdp(cfg, mesh))


def serve_param_shardings(cfg: ArchConfig, mesh):
    """The decode step's params: ``param_shardings(zero1=False)``."""
    return specs.param_shardings(cfg, mesh, zero1=False)


def serve_shape(batch: int, max_len: int) -> ShapeConfig:
    """The decode shape of ``batch`` requests over ``max_len`` cache
    positions (``decode_32k`` is (128, 32768))."""
    return ShapeConfig("serve", max_len, batch, "decode")


def place_cache(cfg: ArchConfig, mesh, batch: int, max_len: int):
    """A fresh serving state placed by ``specs.cache_shardings``, the
    whole tree ``init_decode_cache`` returns: the KV cache (whisper's
    with its encoder memory ``enc_out``), xLSTM's five recurrent states
    (``slstm_m`` at -1e30, as ``init_decode_cache`` fills it, the rest
    zero), hymba's ``{"layers": [{k, v, ssm}, ...]}``. Each local
    position allocates its own shard and nothing else."""
    shape = serve_shape(batch, max_len)
    structs = specs.cache_structs(cfg, shape)
    shardings = specs.cache_shardings(cfg, shape, mesh)

    def alloc(path, t, sh):
        fill = -1e30 if path.endswith("slstm_m") else 0.0
        return PL.Sharded(sh, t.shape, t.dtype, {
            q: torch.full(sh.shard_shape(tuple(t.shape)), fill,
                          dtype=t.dtype, device=mesh.device_at(q))
            for q in mesh.local_positions()})
    leaves = [alloc(path, t, sh) for (path, t), sh in zip(
        tree.flatten_with_path(structs), tree.leaves(shardings))]
    return tree.unflatten(structs, leaves)


def _rows(mesh) -> Dict[int, List[int]]:
    """{data row: this process's positions of it, in model order}."""
    ax = axes_for_mesh(mesh)
    out: Dict[int, List[int]] = {}
    for q in mesh.local_positions():
        out.setdefault(PL.mixed_radix(mesh.coords(q), ax.batch, mesh.shape),
                       []).append(q)
    return dict(sorted(out.items()))


def _batch_rows(mesh, B: int) -> PL.BatchRows:
    """The local rows and their requests: ``batch_shardings``' split of
    B over the batch axes, or every row the whole batch."""
    ax = axes_for_mesh(mesh)
    dp = math.prod(mesh.shape[a] for a in ax.batch)
    shared = B % dp != 0 or B < dp
    per = B if shared else B // dp
    bounds = [(0, B) if shared else (r * per, (r + 1) * per)
              for r in range(dp)]
    return PL.BatchRows(mesh, ax.batch, [qs[0] for qs in
                                         _rows(mesh).values()], bounds,
                        shared)


def _param_views(placed, mesh) -> list:
    """Each local row's params (``placement.row_params``); a leaf split
    over the batch axes too (ZeRO-1) is first rebuilt at its model split
    (``placement.regather``: an all-gather over those axes, each call)."""
    def unzero(s):
        spec = tuple(None if e is not None and "model" not in
                     (e if isinstance(e, tuple) else (e,)) else e
                     for e in s.sharding.spec)
        if spec == tuple(s.sharding.spec):
            return s
        return PL.regather(s, specs.NamedSharding(mesh, P(*spec)))
    placed = tree.tree_map(unzero, placed)
    return [PL.row_params(placed, qs) for qs in _rows(mesh).values()]


def _kv_layers(k: PL.Sharded, v: PL.Sharded, mesh, qs) -> list:
    """Local row ``qs``'s ``placement.CacheShards`` a layer of a stacked
    (L, B, T, Hk, Dh) k/v pair."""
    sh = k.sharding
    dim = PL.model_dim(sh.spec)
    row = PL.ModelRow(mesh, qs[0], mesh.device_at(qs[0]))
    kind = CACHE_SPLITS.get(dim) if row.tp > 1 else None
    full = [PL.slice_box(PL.shard_slices(sh, k.shape, q))
            for q in mesh.members(qs[0], ("model",))]
    layers_ = []
    for i in range(k.shape[0]):
        boxes = [b[1:] if b[0][0] <= i < b[0][1] else
                 (b[1], (b[2][0], b[2][0]), b[3], b[4]) for b in full]
        held = [full[j][0] for j in row.indices]
        layers_.append(PL.CacheShards(
            row, kind,
            [k.local[q][i - lo] if lo <= i < hi else None
             for q, (lo, hi) in zip(qs, held)],
            [v.local[q][i - lo] if lo <= i < hi else None
             for q, (lo, hi) in zip(qs, held)], boxes))
    return layers_


def _state_view(s: PL.Sharded, mesh, qs) -> PL.StateShards:
    """Local row ``qs``'s ``placement.StateShards`` of a placed leaf."""
    row = PL.ModelRow(mesh, qs[0], mesh.device_at(qs[0]))
    return PL.StateShards(
        row, PL.model_dim(s.sharding.spec) if row.tp > 1 else None,
        [s.local[q] for q in qs],
        [PL.slice_box(PL.shard_slices(s.sharding, s.shape, q))
         for q in mesh.members(qs[0], ("model",))])


def _ring_view(k: PL.Sharded, v: PL.Sharded, mesh, qs) -> PL.CacheShards:
    """Local row ``qs``'s ``placement.CacheShards`` of one hymba layer's
    (B, T, Hk, Dh) k/v ring."""
    kv, vv = _state_view(k, mesh, qs), _state_view(v, mesh, qs)
    return PL.CacheShards(kv.row, None if kv.dim is None else
                          CACHE_SPLITS[kv.dim + 1], kv.parts, vv.parts,
                          kv.boxes)


def _cache_views(cache, mesh) -> list:
    """Each local row's view of the placed serving state, as
    ``decode_step_model`` takes it: the attention families'
    ``placement.CacheShards`` a layer; whisper's {"kv": those,
    "enc_out": ``placement.StateShards``}; xLSTM's {leaf name:
    ``StateShards``}; hymba's [{"kv": the layer's ring as
    ``CacheShards``, "ssm": ``StateShards``, "ring": its slots}, ...]."""
    out = []
    for qs in _rows(mesh).values():
        if "layers" in cache:
            out.append([{"kv": _ring_view(lc["k"], lc["v"], mesh, qs),
                         "ssm": _state_view(lc["ssm"], mesh, qs),
                         "ring": lc["k"].shape[1]}
                        for lc in cache["layers"]])
        elif "k" not in cache:
            out.append({n: _state_view(s, mesh, qs)
                        for n, s in cache.items()})
        elif "enc_out" in cache:
            out.append({"kv": _kv_layers(cache["k"], cache["v"], mesh, qs),
                        "enc_out": _state_view(cache["enc_out"], mesh, qs)})
        else:
            out.append(_kv_layers(cache["k"], cache["v"], mesh, qs))
    return out


def _token_sharding(cfg: ArchConfig, mesh, B: int):
    sds = {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")}
    return specs.batch_shardings(sds, cfg, mesh)["tokens"]


def _placed_rows(mesh, sharding, shape, dtype, rows_parts) -> PL.Sharded:
    """A ``Sharded`` of each local row's tensors: ``rows_parts[r]`` local
    row r's parts, one a local position of the row (model order) or one
    the row's positions share."""
    local = {}
    for qs, parts in zip(_rows(mesh).values(), rows_parts):
        for k, q in enumerate(qs):
            t = parts[k] if len(parts) == len(qs) else parts[0]
            local[q] = t.to(mesh.device_at(q))
    return PL.Sharded(sharding, shape, dtype, local)


def _outputs(cfg: ArchConfig, mesh, params, hs, B: int):
    """(next tokens, logits) of each local row's last hidden states, as
    ``Sharded`` (B, 1) int32 and (B, 1, V) f32 (vocab-split where the
    unembedding is)."""
    tsh = _token_sharding(cfg, mesh, B)
    toks, logits, vsplit = [], [], False
    for p, h in zip(params, hs):
        tok, (parts, vrow) = greedy_tokens(cfg, p, h)
        toks.append([tok])
        logits.append(parts)
        vsplit = vrow is not None
    lsh = specs.NamedSharding(mesh, P(tsh.spec[0], None,
                                      "model" if vsplit else None))
    return (_placed_rows(mesh, tsh, (B, 1), torch.int32, toks),
            _placed_rows(mesh, lsh, (B, 1, cfg.vocab), torch.float32,
                         logits))


def sharded_argmax(cfg: ArchConfig, logits: PL.Sharded) -> PL.Sharded:
    """The greedy tokens of placed (B, 1, V) logits (``prefill``'s):
    each row's argmax over its vocabulary shards
    (``placement.argmax_model``), placed as the tokens are."""
    mesh = logits.mesh
    toks = []
    for qs in _rows(mesh).values():
        parts = [logits.local[q][:, -1] for q in qs]
        if PL.model_dim(logits.sharding.spec) is None:
            tok = torch.argmax(parts[0], dim=-1)
        else:
            tok = PL.argmax_model(parts, PL.ModelRow(mesh, qs[0],
                                                     mesh.device_at(qs[0])))
        toks.append([tok.to(torch.int32)[:, None]])
    B = logits.shape[0]
    return _placed_rows(mesh, _token_sharding(cfg, mesh, B), (B, 1),
                        torch.int32, toks)


def make_sharded_prefill(cfg: ArchConfig, mesh, max_len: int) -> Callable:
    """prefill(placed_params, batch) -> (placed_cache, last_logits): the
    forward of ``batch`` (tokens (B, S); llava's image_embeds (B, Ni, d),
    whisper's frames (B, Te, d) too), whole in every process, over
    ``mesh`` (see the module's docstring), into a serving state of
    ``max_len`` positions placed by ``specs.cache_shardings``
    (``place_cache``): each attention layer's K/V written into its
    split, whisper's encoder memory ``enc_out`` too (each position keeps
    its frames, or its d columns, of its row's memory); xLSTM's and
    hymba's states stay at ``init_decode_cache``'s values, as the
    one-device ``make_prefill`` and the reference's leave them. The
    params are placed by ``prefill_param_shardings`` (or
    ``serve_param_shardings``). last_logits is ``Sharded`` (B, 1, V)
    f32, vocab shards where the unembedding splits. Sets the
    full-precision matmul flags."""
    full_precision_matmuls()

    def prefill(placed_params, batch):
        B = batch["tokens"].shape[0]
        rows = _batch_rows(mesh, B)
        with torch.no_grad(), entered(mesh):
            params = _param_views(placed_params, mesh)
            cache = place_cache(cfg, mesh, B, max_len)
            caches = _cache_views(cache, mesh)
            batches = [{k: v[lo:hi].to(home) for k, v in batch.items()}
                       for (lo, hi), home in zip(rows.ranges, rows.homes)]

            def put(i, r, k, v):
                c = caches[r]
                write_kv(cfg, (c["kv"] if cfg.enc_dec else c)[i], k, v, 0)
            outs = forward_rows(cfg, params, batches, rows,
                                put_kv=put if "k" in cache else None)
            if cfg.enc_dec:
                for c, o, (lo, hi) in zip(caches, outs, rows.ranges):
                    enc, mem = c["enc_out"], o.cache["enc_out"]
                    PL.put_local(mem, ((lo, hi), (0, mem.shape[1]),
                                       (0, mem.shape[2])),
                                 enc.parts, enc.boxes, enc.row)
            _, logits = _outputs(cfg, mesh, params,
                                 [o.logits[:, -1:] for o in outs], B)
        return cache, logits
    return prefill


def make_sharded_serve_step(cfg: ArchConfig, mesh,
                            whole_logits: bool = False) -> Callable:
    """serve_step(placed_params, placed_cache, tokens, t) ->
    (next_tokens, logits, placed_cache): one greedy decode step at
    position ``t`` (a Python int) over ``mesh``, the params placed by
    ``serve_param_shardings``, the cache by ``place_cache`` (updated in
    place: the reference donates it). ``tokens`` is (B, 1), whole or as
    this function's ``next_tokens`` (``Sharded``). The logits are
    ``Sharded`` vocab shards, or with ``whole_logits`` the (B, 1, V)
    tensor gathered on the first local position's device. Sets the
    full-precision matmul flags."""
    full_precision_matmuls()

    def serve_step(placed_params, placed_cache, tokens, t: int):
        B = tokens.shape[0]
        rows = _batch_rows(mesh, B)
        with torch.no_grad(), entered(mesh):
            params = _param_views(placed_params, mesh)
            caches = _cache_views(placed_cache, mesh)
            if isinstance(tokens, PL.Sharded):
                toks = [tokens.local[q] for q in rows.positions]
            else:
                toks = [tokens[lo:hi].to(home)
                        for (lo, hi), home in zip(rows.ranges, rows.homes)]
            hs = decode_step_model(cfg, params, caches, toks, t, rows)
            nxt, logits = _outputs(cfg, mesh, params, hs, B)
        if whole_logits:
            logits = PL.gather(logits)
        return nxt, logits, placed_cache
    return serve_step


def greedy_generate_sharded(cfg: ArchConfig, mesh, prefill_params,
                            serve_params, batch, n_new: int,
                            max_len: int):
    """Prefill then ``n_new - 1`` greedy decode steps over ``mesh``:
    returns (the (B, n_new) int32 tokens, whole, on the first local
    position's device; the placed cache). ``prefill_params`` and
    ``serve_params`` may be one tree (placed by
    ``serve_param_shardings``)."""
    prefill = make_sharded_prefill(cfg, mesh, max_len)
    step = make_sharded_serve_step(cfg, mesh)
    cache, logits = prefill(prefill_params, batch)
    t = batch["tokens"].shape[1] + (batch["image_embeds"].shape[1]
                                    if "image_embeds" in batch else 0)
    tok = sharded_argmax(cfg, logits)
    out = [PL.gather(tok)]
    for i in range(n_new - 1):
        tok, _, cache = step(serve_params, cache, tok, t + i)
        out.append(PL.gather(tok))
    return torch.cat(out, 1), cache


__all__ = ["make_sharded_prefill", "make_sharded_serve_step",
           "greedy_generate_sharded", "place_cache", "sharded_argmax",
           "prefill_param_shardings", "serve_param_shardings",
           "serve_shape"]
