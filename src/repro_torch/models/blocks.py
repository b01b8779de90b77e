"""Per-layer block forwards of the uniform transformer families (the
port's ``repro.models.blocks``: dense / MoE / gemma2-style local-global
/ llava backbone / whisper).

Every function takes the layer's param dict and returns the residual
stream. ``window`` is a per-layer Python int; ``GLOBAL_WINDOW`` (2**30)
means global attention, which ``layers.flash_attention`` sends to the
kernel when there is no softcap.

In the sharded train step a model-sharded weight arrives as
``distributed.placement.ModelShards``. Attention splits over ``model``
by whole query heads at every tp (``sharding.heads_split``): shard j
runs the query heads ``sharding.shard_heads`` gives it, from the wq
columns and wo rows of those heads and the wk/wv columns of the KV
heads they read, which ``placement.take_model`` copies from their
owners (``param_spec`` splits the columns evenly, so a shard's heads
may straddle its neighbours' blocks); where the heads and KV heads
divide tp these are exactly the shard's own blocks, untouched. Each
shard projects its q and KV heads, runs rope and one
``layers.flash_attention`` call a run of whole KV groups and one a
partial group at either end (``ShardHeads.segments``: the kernel's
h // G map holds in each), and multiplies by its rows of wo;
``sum_model`` adds the partial outputs (gemma2's ``ln1_post`` after the
sum); a shard with no head (H < tp) adds zeros. Whole heads a shard
rather than the columns ``param_spec`` splits: a layer's weights are
smaller than one row's activations (smollm: 1.8 MB of wq/wk/wv/wo in
bf16 against 9.4 MB of one 4 x 2048-token row's q), so a shard fetches
weight columns, never activations. The MLPs split by
``layers.model_parallel``; such a layer returns no k and v, or with
``shard_kv`` each shard's KV heads, which the sharded prefill writes
into a cache placed by ``launch.specs.cache_shardings`` (``write_kv``).
``attention_decode_model`` decodes one token over such a cache, split
over ``model`` along its positions (or Dh, Hk, the layers)."""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..distributed import placement as PL
from . import layers
from .config import ArchConfig
from .sharding import shard_heads

GLOBAL_WINDOW = 1 << 30


class AttnOut(NamedTuple):
    y: torch.Tensor
    k: Any                        # (B, S, Hk, Dh); where the layer split
    v: Any                        # over model None, or with shard_kv each
                                  # local shard's KV heads


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


def _attn_split(cfg: ArchConfig, p, names):
    """(row, each local shard's ``ShardHeads``, each local shard's
    wq/wk/wv/wo of its heads) when the attention weights ``names`` of
    ``p`` are model shards of more than one position, else None (model
    shards of one position go into ``p`` whole). wq and wo must both be
    model-sharded (``param_spec`` shards them together); wk/wv may be
    replicated, and are then narrowed."""
    ws = [p[n] for n in names]
    sharded = [w for w in ws if not isinstance(w, torch.Tensor)]
    if not sharded:
        return None
    if sharded[0].row.tp == 1:
        for n in names:
            p[n] = layers.whole(p[n])
        return None
    if isinstance(ws[0], torch.Tensor) or isinstance(ws[3], torch.Tensor):
        raise ValueError(f"{names}: the heads split, but not every weight "
                         "of the query heads is model-sharded")
    row = ws[0].row
    Dh = cfg.head_dim
    heads = shard_heads(cfg.n_heads, cfg.n_kv_heads, row.tp)
    q = [(a * Dh, b * Dh) for a, b in (h.q for h in heads)]
    kv = [(a * Dh, b * Dh) for a, b in (h.kv for h in heads)]
    taken = PL.take_model(ws, [q, kv, kv, q], [1, 1, 1, 0])
    mine = [heads[j] for j in row.indices]
    return row, mine, [dict(zip(names, t)) for t in zip(*taken)]


def _by_segments(cfg: ArchConfig, heads, q, k, v, **kw) -> torch.Tensor:
    """``layers.flash_attention`` over one shard's heads (q its query
    heads, k/v their KV heads): one call a run of ``heads.segments``,
    the outputs joined along the heads; one call where ``heads`` is
    None (every head) or one run."""
    if heads is None or len(heads.segments) == 1:
        return layers.flash_attention(q, k, v, **kw)
    G = cfg.n_heads // cfg.n_kv_heads
    q0, k0 = heads.q[0], heads.kv[0]
    ys = []
    for a, b in heads.segments:
        ka, kb = a // G - k0, (b - 1) // G + 1 - k0
        ys.append(layers.flash_attention(
            q[:, :, a - q0:b - q0].contiguous(),
            k[:, :, ka:kb].contiguous(), v[:, :, ka:kb].contiguous(), **kw))
    return torch.cat(ys, 2)


def _project_out(y: torch.Tensor, wo) -> torch.Tensor:
    return y.reshape(y.shape[0], y.shape[1], -1) @ wo


def _no_heads(h: torch.Tensor, wq, wo) -> torch.Tensor:
    """A shard with no query head: its q (no columns) through its rows
    of wo (none), zeros of the residual's shape whose graph reaches its
    (empty) ranges of the weights, so their exchange runs on every
    rank."""
    return (h @ wq) @ wo


def attention_block(cfg: ArchConfig, p, x, positions, *, window=None,
                    causal=True, q_offset=0, shard_kv=False) -> AttnOut:
    """Pre-norm attention with gemma2's post-norm where the layer has
    one; returns the residual and this layer's k, v: where the layer
    splits over ``model`` (see the module's docstring) None, or with
    ``shard_kv`` lists of each local shard's k and v of the KV heads
    ``ShardHeads.kv`` gives it (none for a shard with no query head),
    which the sharded prefill writes into the cache's split
    (``write_kv``)."""
    p = dict(p)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    kw = dict(causal=causal, window=window, logit_softcap=cfg.attn_softcap,
              q_offset=q_offset)
    split = _attn_split(cfg, p, ("wq", "wk", "wv", "wo"))
    if split is None:
        q, k, v = _qkv(cfg, p, h, positions)
        y = _project_out(layers.flash_attention(q, k, v, **kw), p["wo"])
    else:
        row, heads, ws = split
        k, v, ys = [], [], []
        for hd, hj, wj in zip(heads, PL.to_model(h, row), ws):
            if not hd.segments:
                ys.append(_no_heads(hj, wj["wq"], wj["wo"]))
                k.append(hj.new_empty(hj.shape[:2] + (0, cfg.head_dim)))
                v.append(k[-1])
                continue
            q, kj, vj = _qkv(cfg, wj, hj, positions.to(hj.device))
            ys.append(_project_out(_by_segments(cfg, hd, q, kj, vj, **kw),
                                   wj["wo"]))
            k.append(kj)
            v.append(vj)
        y = PL.sum_model(ys, row)
        if not shard_kv:
            k = v = None
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


def owned_kv(cfg: ArchConfig, tp: int) -> List[Tuple[int, int]]:
    """Each model shard's KV heads [lo, hi) it writes to the cache where
    the heads split (``shard_heads``): its own, where shards share a KV
    head the lowest shard reading it; (lo, lo) for a shard that writes
    none."""
    out, done = [], 0
    for h in shard_heads(cfg.n_heads, cfg.n_kv_heads, tp):
        lo = max(h.kv[0], done) if h.segments else done
        hi = max(lo, h.kv[1]) if h.segments else lo
        out.append((lo, hi))
        done = hi
    return out


def _own(cfg: ArchConfig, row, ts: List[torch.Tensor]):
    """Each local shard's owned KV heads (``owned_kv``) of its k or v
    (B, S, its KV heads, Dh), and every coordinate's owned range."""
    owned = owned_kv(cfg, row.tp)
    heads = shard_heads(cfg.n_heads, cfg.n_kv_heads, row.tp)
    out = []
    for j, t in zip(row.indices, ts):
        lo, hi = owned[j]
        k0 = heads[j].kv[0] if heads[j].segments else lo
        out.append(t[:, :, lo - k0:hi - k0])
    return out, owned


def write_kv(cfg: ArchConfig, cache: PL.CacheShards, k, v, t0: int) -> None:
    """An attention layer's k and v (``AttnOut``'s: whole, or each local
    shard's KV heads where it split) written into its layer of the
    cache's split at positions [t0, t0 + S)."""
    if isinstance(k, torch.Tensor):
        cache.write(k, v, t0)
        return
    ks, owned = _own(cfg, cache.row, k)
    vs, _ = _own(cfg, cache.row, v)
    cache.write(ks, vs, t0, owned)


def attention_decode_model(cfg: ArchConfig, p, x, cache: PL.CacheShards,
                           t: int, *, window=None) -> torch.Tensor:
    """``attention_decode`` of one data row whose weights may be model
    shards (the heads split as in ``attention_block``: each shard
    projects its query and KV heads) and whose cache layer is split over
    its model shards (``cache``): the token's k and v go to the shards
    that keep position ``t`` (``write_kv``), the query heads meet on the
    row's home (each shard's placed in zeros and summed over ``model``:
    B H Dh a layer), ``layers.decode_attention_model`` attends over the
    split, and each shard multiplies its heads' output by its rows of
    wo. Returns the residual on the row's home; no cache is gathered."""
    p = dict(p)
    B = x.shape[0]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    split = _attn_split(cfg, p, ("wq", "wk", "wv", "wo"))
    kw = dict(window=window, logit_softcap=cfg.attn_softcap)
    row = cache.row
    if split is None:
        q, k, v = _qkv(cfg, p, h, positions)
        write_kv(cfg, cache, k, v, t)
        out = layers.decode_attention_model(q, cache.parts(), t, cache.kind,
                                            row, **kw)
        y = out.reshape(B, 1, -1) @ p["wo"]
    else:
        row, heads, ws = split
        Dh, H = cfg.head_dim, cfg.n_heads
        qs, ks, vs = [], [], []
        for hd, hj, wj in zip(heads, PL.to_model(h, row), ws):
            full = torch.zeros((B, 1, H, Dh), dtype=torch.float32,
                               device=hj.device)
            if not hd.segments:
                kj = vj = hj.new_empty((B, 1, 0, Dh))
            else:
                qj, kj, vj = _qkv(cfg, wj, hj, positions.to(hj.device))
                full[:, :, hd.q[0]:hd.q[1]] = qj.float()
            qs.append(full)
            ks.append(kj)
            vs.append(vj)
        write_kv(cfg, cache, ks, vs, t)
        q = PL.sum_model(qs, row).to(x.dtype)
        out = layers.decode_attention_model(q, cache.parts(), t, cache.kind,
                                            row, **kw)
        y = PL.sum_model([
            out[:, :, hd.q[0]:hd.q[1]].to(wj["wo"].device).reshape(B, 1, -1)
            @ wj["wo"] for hd, wj in zip(heads, ws)], row)
    if "ln1_post" in p:
        y = layers.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    return x + y


def _moe_params(p) -> dict:
    return {"router": p["router"], "w_gate": p["moe_w_gate"],
            "w_up": p["moe_w_up"], "w_down": p["moe_w_down"]}


def _moe(cfg: ArchConfig, p, h) -> layers.MoEOut:
    """The layer's MoE on its normed input ``h``: ``layers.moe_ffn``, or
    under ``layers.MOE_EP_MODE`` the expert-parallel ``moe_ffn_ep`` over
    the ambient mesh (it falls back to ``moe_ffn`` where the reference's
    does), each position's virtual experts narrowed from whole weights or
    taken from model shards (``layers._expert_weights``: no expert leaf
    is built whole). The sharded train step's and the sharded serving's
    MoE layers go through ``moe_block_rows`` instead."""
    moe = _moe_params(p)
    if layers.MOE_EP_MODE:        # its own layout over the ambient mesh
        return layers.moe_ffn_ep(h, moe, cfg.moe.n_experts, cfg.moe.top_k,
                                 cfg.moe.capacity_factor)
    return layers.moe_ffn(h, moe, cfg.moe.n_experts, cfg.moe.top_k,
                          cfg.moe.capacity_factor)


def _residual(cfg: ArchConfig, p, x, y) -> torch.Tensor:
    if "ln2_post" in p:
        y = layers.rms_norm(y, p["ln2_post"], cfg.norm_eps)
    return x + y


def ffn_block(cfg: ArchConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense SwiGLU or MoE (``_moe``), with gemma2's post-norm where the
    layer has one; returns (residual, aux_loss)."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = _moe(cfg, p, h)
    else:
        y = layers.model_parallel(layers.swiglu, h, p["w_gate"], p["w_up"],
                                  p["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _residual(cfg, p, x, y), aux


def _ep_rows_shape(cfg: ArchConfig, xs, rows: PL.BatchRows):
    """The ``layers.EPShape`` of a lockstep MoE layer under
    ``layers.MOE_EP_MODE`` and an ambient mesh, decided as the reference's
    call decides it, on the domain batch (every row's tokens: the global
    microbatch, or a pod's under ``grad_compress``) over the rows, so
    every row takes the same branch; None where it falls back."""
    from .sharding import ambient_axes
    if not layers.MOE_EP_MODE or ambient_axes() is None:
        return None
    n = (xs[0].shape[0] if rows.shared else
         sum(hi - lo for lo, hi in rows.bounds)) * xs[0].shape[1]
    return layers.ep_shape(n, len(rows.bounds),
                           rows.mesh.shape.get("model", 1),
                           cfg.moe.n_experts, cfg.moe.top_k, cfg.d_ff,
                           cfg.moe.capacity_factor)


def moe_block_rows(cfg: ArchConfig, ps, xs, rows: PL.BatchRows
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``ffn_block`` of a MoE config over the data rows ``rows`` in
    lockstep: ``xs`` each local row's residual (its own rows of the
    batch), ``ps`` its layer params. Under ``layers.MOE_EP_MODE`` with an
    ambient mesh, where the reference's expert parallelism engages
    (``_ep_rows_shape``), each position routes its row's tokens through
    its own experts (``layers.moe_ep_rows``). Otherwise the rows' normed
    inputs meet (``placement.gather_rows``) and each row routes the whole
    domain batch with the dense ``moe_ffn``, the router, sort and
    dispatch replicated over the rows as the reference's partitioner runs
    them, its experts split over its model shards, and keeps its own rows
    of y. Rows that each hold the whole batch (``rows.shared``) route it
    alone, or under EP each its share (``layers.moe_ep_rows``). Returns
    each row's (residual, aux_loss), the aux loss over the domain
    batch."""
    hs = [layers.rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, xs)]
    shape = _ep_rows_shape(cfg, xs, rows)
    if shape is not None:
        ys, auxs = layers.moe_ep_rows(hs, [_moe_params(p) for p in ps], rows,
                                      shape, cfg.moe.n_experts,
                                      cfg.moe.top_k)
        return [(_residual(cfg, p, x, y), aux)
                for p, x, y, aux in zip(ps, xs, ys, auxs)]
    out = []
    for p, x, h, (lo, hi) in zip(ps, xs, hs if rows.shared else
                                 PL.gather_rows(hs, rows), rows.ranges):
        y, aux = layers.moe_ffn(h, _moe_params(p), cfg.moe.n_experts,
                                cfg.moe.top_k, cfg.moe.capacity_factor)
        out.append((_residual(cfg, p, x, y[lo:hi]), aux))
    return out


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
    Dh = cfg.head_dim

    def attend(h, enc, w, heads=None):
        B, S, _ = h.shape
        q = (h @ w["wq_x"]).reshape(B, S, -1, Dh)
        k = (enc @ w["wk_x"]).reshape(B, enc.shape[1], -1, Dh)
        v = (enc @ w["wv_x"]).reshape(B, enc.shape[1], -1, Dh)
        return _project_out(_by_segments(cfg, heads, q, k, v, causal=False),
                            w["wo_x"])

    split = _attn_split(cfg, p, names)
    if split is None:
        return x + attend(h, enc_out, p)
    row, heads, ws = split
    ys = [attend(hj, ej, wj, hd) if hd.segments else
          _no_heads(hj, wj["wq_x"], wj["wo_x"])
          for hd, hj, ej, wj in zip(heads, PL.to_model(h, row),
                                    PL.to_model(enc_out, row), ws)]
    return x + PL.sum_model(ys, row)


def whisper_decoder_block(cfg: ArchConfig, p, x, enc_out, positions):
    a = attention_block(cfg, p, x, positions, causal=True)
    h = cross_attention(cfg, p, a.y, enc_out)
    return gelu_mlp(p, h, cfg.norm_eps), a.k, a.v
