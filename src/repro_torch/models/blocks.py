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
over ``model`` along its positions (or Dh, Hk, the layers), and
``cross_attention_decode_model`` whisper's cross-attention over its
encoder memory split along its frames or d."""
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


def _attn_split(cfg: ArchConfig, p, names, roles: str = "qkko"):
    """(row, each local shard's ``ShardHeads``, each local shard's
    weights ``names`` of its heads) when the attention weights ``names``
    of ``p`` are model shards of more than one position, else None
    (model shards of one position go into ``p`` whole). ``roles`` says
    what each name's shard takes: "q" the columns of its query heads,
    "k" those of the KV heads they read, "a" every column, "o" the rows
    of its query heads. The "q" and "o" weights must be model-sharded
    (``param_spec`` shards them together); the others may be
    replicated, and are then narrowed."""
    ws = [p[n] for n in names]
    sharded = [w for w in ws if not isinstance(w, torch.Tensor)]
    if not sharded:
        return None
    if sharded[0].row.tp == 1:
        for n in names:
            p[n] = layers.whole(p[n])
        return None
    if any(isinstance(w, torch.Tensor) for w, r in zip(ws, roles)
           if r in "qo"):
        raise ValueError(f"{names}: the heads split, but not every weight "
                         "of the query heads is model-sharded")
    row = sharded[0].row
    Dh = cfg.head_dim
    heads = shard_heads(cfg.n_heads, cfg.n_kv_heads, row.tp)
    q = [(a * Dh, b * Dh) for a, b in (h.q for h in heads)]
    kv = [(a * Dh, b * Dh) for a, b in (h.kv for h in heads)]
    every = [(0, cfg.n_kv_heads * Dh)] * row.tp
    rng = {"q": q, "k": kv, "a": every, "o": q}
    taken = PL.take_model(ws, [rng[r] for r in roles],
                          [0 if r == "o" else 1 for r in roles])
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


def _decode_attend(cfg: ArchConfig, p, h, cache: PL.CacheShards, t: int,
                   *, window=None, ring=None, names=("wq", "wk", "wv")):
    """``attention_decode_model``'s attention of the normed ``h`` before
    its output projection: (the heads' output (B, 1, H, Dh) on the row's
    home, ``_attn_split``'s split of ``names`` or None). With ``ring``
    (hymba's ring of that many slots) the token at position ``t`` goes
    to slot t % ring and the attention reads the min(t + 1, ring) valid
    slots, with no window."""
    B = h.shape[0]
    positions = torch.full((B, 1), t, dtype=torch.int32, device=h.device)
    split = _attn_split(cfg, p, names, "qkko"[:len(names)])
    kw = dict(window=window, logit_softcap=cfg.attn_softcap)
    slot = last = t
    if ring is not None:
        slot, last, kw["window"] = t % ring, min(t + 1, ring) - 1, None
    if split is None:
        q, k, v = _qkv(cfg, p, h, positions)
        write_kv(cfg, cache, k, v, slot)
    else:
        row, heads, ws = split
        Dh = cfg.head_dim
        qs, ks, vs = [], [], []
        for hd, hj, wj in zip(heads, PL.to_model(h, row), ws):
            if not hd.segments:
                qj = kj = vj = hj.new_empty((B, 1, 0, Dh))
            else:
                qj, kj, vj = _qkv(cfg, wj, hj, positions.to(hj.device))
            qs.append(qj)
            ks.append(kj)
            vs.append(vj)
        write_kv(cfg, cache, ks, vs, slot)
        q = _meet_heads(cfg, heads, qs, row).to(h.dtype)
    out = layers.decode_attention_model(q, cache.parts(), last, cache.kind,
                                        cache.row, **kw)
    return out, split


def _meet_heads(cfg: ArchConfig, heads, qs, row) -> torch.Tensor:
    """The whole q (B, 1, H, Dh) f32 on the row's home from each local
    shard's query heads ``qs`` (B, 1, its heads, Dh): each placed in
    zeros and summed over ``model`` (one term an element; B H Dh a
    layer)."""
    fulls = []
    for hd, qj in zip(heads, qs):
        full = qj.new_zeros(qj.shape[:2] + (cfg.n_heads, cfg.head_dim),
                            dtype=torch.float32)
        full[:, :, hd.q[0]:hd.q[1]] = qj.float()
        fulls.append(full)
    return PL.sum_model(fulls, row)


def _heads_out(heads, ws, out, name: str, row) -> torch.Tensor:
    """Each local shard's query heads of the whole ``out`` (B, 1, H, Dh)
    through its rows of the output projection ``name``, summed over
    ``model``."""
    B = out.shape[0]
    return PL.sum_model([
        out[:, :, hd.q[0]:hd.q[1]].to(wj[name].device).reshape(B, 1, -1)
        @ wj[name] for hd, wj in zip(heads, ws)], row)


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
    out, split = _decode_attend(cfg, p, h, cache, t, window=window,
                                names=("wq", "wk", "wv", "wo"))
    if split is None:
        y = out.reshape(B, 1, -1) @ p["wo"]
    else:
        row, heads, ws = split
        y = _heads_out(heads, ws, out, "wo", row)
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


def _memory_kv(cfg: ArchConfig, enc, w):
    """k and v (B, Te, heads, Dh) of the encoder memory ``enc`` from the
    columns of wk_x and wv_x that ``w`` holds."""
    B, T, _ = enc.shape
    Dh = cfg.head_dim
    return ((enc @ w["wk_x"]).reshape(B, T, -1, Dh),
            (enc @ w["wv_x"]).reshape(B, T, -1, Dh))


def _cross_heads(cfg: ArchConfig, h, k, v, w, heads=None):
    """The query heads of ``w``'s wq_x columns over their KV heads ``k``
    and ``v``, non-causal (the flash kernel on CUDA), through ``w``'s
    rows of wo_x."""
    B, S, _ = h.shape
    q = (h @ w["wq_x"]).reshape(B, S, -1, cfg.head_dim)
    return _project_out(_by_segments(cfg, heads, q, k, v, causal=False),
                        w["wo_x"])


def cross_attention(cfg: ArchConfig, p, x, enc_out):
    """Attention of the decoder's positions over the encoder memory
    ``enc_out`` (B, Te, d), non-causal: the flash kernel on CUDA. Split
    over ``model`` as ``attention_block`` is, the encoder memory handed
    to each shard."""
    p = dict(p)
    h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
    names = ("wq_x", "wk_x", "wv_x", "wo_x")
    split = _attn_split(cfg, p, names)
    if split is None:
        return x + _cross_heads(cfg, h, *_memory_kv(cfg, enc_out, p), p)
    row, heads, ws = split
    ys = [_cross_heads(cfg, hj, *_memory_kv(cfg, ej, wj), wj, hd)
          if hd.segments else _no_heads(hj, wj["wq_x"], wj["wo_x"])
          # its memory's (empty) k too: the memory's gradient exchange
          # (``to_model``'s backward) then runs on every rank
          + (ej @ wj["wk_x"]).sum()
          for hd, hj, ej, wj in zip(heads, PL.to_model(h, row),
                                    PL.to_model(enc_out, row), ws)]
    return x + PL.sum_model(ys, row)


def _weight_rows(w, row, ranges) -> List[torch.Tensor]:
    """Each local shard's rows ``ranges[j]`` (j its model coordinate) of
    every column of a weight: a replicated tensor narrowed, a
    column-sharded one's pieces fetched from every shard
    (``placement.put_model``: one all-to-all over ``model``)."""
    if isinstance(w, torch.Tensor):
        return [w[lo:hi].to(d) for (lo, hi), d in
                zip((ranges[j] for j in row.indices), row.devices)]
    if w.dim != 1:
        raise ValueError(f"_weight_rows: a weight split along {w.dim}")
    n, C = w.parts[0].shape[1], w.parts[0].shape[1] * row.tp
    d = w.parts[0].shape[0]
    out = [torch.empty((ranges[j][1] - ranges[j][0], C),
                       dtype=w.parts[0].dtype, device=dev)
           for j, dev in zip(row.indices, row.devices)]
    PL.put_model(row, w.parts, [((0, d), (i * n, (i + 1) * n))
                                for i in range(row.tp)], out,
                 [(tuple(r), (0, C)) for r in ranges])
    return out


def cross_attention_decode_model(cfg: ArchConfig, p, x,
                                 enc: PL.StateShards) -> torch.Tensor:
    """``cross_attention`` of one data row's token over its encoder
    memory as ``launch.specs.cache_shardings`` splits it over the row's
    model shards (``enc``); no shard's memory leaves it:

    * frames (tp 2 and 4 at whisper-base: 1,500 frames divide): each
      shard projects k and v of every KV head from its frames, with the
      whole wk_x and wv_x (the columns it lacks fetched,
      ``placement.take_model``: 2 d Hk Dh of the weights' dtype a
      layer), scores them for every query head (the query heads meet on
      the row's home as in ``attention_decode_model``) and the split
      softmax of ``layers.decode_attention_model``'s "T" case combines
      the shards; each shard multiplies its heads' output by its rows of
      wo_x. No flash call: flash returns no log-sum-exp, so its
      per-shard outputs could not be combined;
    * d (tp 8 and 16: the production layout): each shard multiplies its
      d columns of the memory by its rows of wk_x and wv_x (fetched,
      ``_weight_rows``), and the f32 partial k and v meet by a
      reduce-scatter to each shard's KV heads in model order
      (``placement.sum_scatter_model``: the transient k and v, B Te
      Hk Dh each, of which a shard keeps its heads); each shard then
      attends with its query heads as ``cross_attention`` does (flash on
      CUDA, one call a segment of its heads);
    * a memory every shard keeps whole, or a model axis of one:
      ``cross_attention``.

    Returns the residual on the row's home."""
    row = enc.row
    if row.tp == 1 or enc.dim is None:
        return cross_attention(cfg, p, x, enc.parts[0])
    p = dict(p)
    h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
    B, Dh = x.shape[0], cfg.head_dim
    if enc.dim == 2:
        split = _attn_split(cfg, p, ("wq_x", "wo_x"), "qo")
        if split is None:
            raise ValueError("cross_attention_decode_model: a memory split "
                             "over d with unsplit query heads")
        _, heads, ws = split
        rows_ = [b[2] for b in enc.boxes]
        wk = _weight_rows(p["wk_x"], row, rows_)
        wv = _weight_rows(p["wv_x"], row, rows_)
        kv = [(a * Dh, b * Dh) for a, b in (hd.kv for hd in shard_heads(
            cfg.n_heads, cfg.n_kv_heads, row.tp))]
        ks, vs = ([t.to(h.dtype).reshape(t.shape[0], t.shape[1], -1, Dh)
                   for t in PL.sum_scatter_model(
                       row, [e.float() @ w.float() for e, w in
                             zip(enc.parts, ws_)], kv, -1)]
                  for ws_ in (wk, wv))
        return x + PL.sum_model([
            _cross_heads(cfg, hj, kj, vj, wj, hd) if hd.segments else
            _no_heads(hj, wj["wq_x"], wj["wo_x"])
            for hd, hj, kj, vj, wj in zip(heads, PL.to_model(h, row), ks,
                                          vs, ws)], row)
    if enc.dim != 1:
        raise ValueError(f"cross_attention_decode_model: a memory split "
                         f"over dim {enc.dim}")
    split = _attn_split(cfg, p, ("wq_x", "wk_x", "wv_x", "wo_x"), "qaao")
    H, Hk = cfg.n_heads, cfg.n_kv_heads
    if split is None:
        q = (h @ p["wq_x"]).reshape(B, 1, H, Dh)
        ws = [{n: p[n].to(dev) for n in ("wk_x", "wv_x")}
              for dev in row.devices]
    else:
        _, heads, ws = split
        q = _meet_heads(cfg, heads, [
            (hj @ wj["wq_x"]).reshape(B, 1, -1, Dh)
            for hj, wj in zip(PL.to_model(h, row), ws)], row).to(h.dtype)
    parts = [_memory_kv(cfg, e, w) + ((box[1], (0, Hk), (0, Dh)),)
             for e, w, box in zip(enc.parts, ws, enc.mine())]
    frames = max(b[1][1] for b in enc.boxes)
    out = layers.decode_attention_model(q, parts, frames - 1, "T", row)
    if split is None:
        return x + out.reshape(B, 1, -1) @ p["wo_x"]
    return x + _heads_out(heads, ws, out, "wo_x", row)


def whisper_decoder_block(cfg: ArchConfig, p, x, enc_out, positions,
                          shard_kv: bool = False):
    """A decoder layer: causal self-attention (its k and v as
    ``attention_block`` gives them, each shard's KV heads with
    ``shard_kv``), cross-attention over ``enc_out``, the GELU MLP."""
    a = attention_block(cfg, p, x, positions, causal=True,
                        shard_kv=shard_kv)
    h = cross_attention(cfg, p, a.y, enc_out)
    return gelu_mlp(p, h, cfg.norm_eps), a.k, a.v
