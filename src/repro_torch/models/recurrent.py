"""Recurrent and hybrid block forwards of the port (``repro.models.
recurrent``): xLSTM's mLSTM and sLSTM blocks and hymba's parallel
attention + SSM layer, each with its O(1) decode step.

The mLSTM weights keep the reference's Dh-major layout: wq3/wk3/wv3/w_z3
(d, Dh, H) and w_down3 (Dh, H, d), so ``einsum("bsd,dvh->bshv")`` gives
(B, S, H, Dh) with the head axis inner in the weight. ``_heads`` computes
it as one (d, Dh * H) matmul whose output is unflattened to (Dh, H) and
transposed, exactly as the einsum indexes it. The scans are the plain
torch ones of ``layers``; hymba's global layers reach the flash kernel
through ``layers.flash_attention``.

In the sharded train step the blocks split over ``model`` where their
weights arrive as ``placement.ModelShards`` (the reference's layout,
``sharding.param_spec``): the mLSTM by Dh (each shard's columns of v, z
and the matrix memory, from the replicated q, k and gates), the sLSTM by
columns (its scan is elementwise: no hidden-to-hidden matrix), hymba's
SSM, fused projection and MLP by columns (each shard scans the heads its
columns span, zeros in the spanned columns not its own), and hymba's
attention by whole query heads as ``blocks.attention_block``'s (each
shard's heads from the weight columns ``placement.take_model`` fetches).
Each layer's one collective a split part is ``sum_model`` of its row
products; the replicated inputs reach the shards through ``to_model``,
whose backward sums their gradients.

The sharded serving's decode steps (``*_step_model``) take the same
weight split over a state placed by ``launch.specs.cache_shardings``:
the mLSTM memory by D_out (the same split as its v columns), the sLSTM
states whole on every shard (each shard steps its columns and the new
columns are gathered into every copy), hymba's SSM state by Dh against
its weights' flattened columns (x and y dealt between the two layouts,
``placement.regroup_model``) and its k/v ring by slots or Dh."""
from __future__ import annotations

import torch

from ..distributed import placement as PL
from . import blocks, layers
from .config import ArchConfig
from .sharding import shard_heads

_GATE_CAP = 15.0  # softcap on log input gate pre-activations (stability)


def _heads(h: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dvh->bshv", h, w3)``: (B, S, d) @ (d, Dh, H) ->
    (B, S, H, Dh)."""
    d, Dh, H = w3.shape
    return (h @ w3.reshape(d, Dh * H)).unflatten(-1, (Dh, H)).transpose(-1,
                                                                        -2)


def _down3(y: torch.Tensor, w3: torch.Tensor, mm=torch.matmul
           ) -> torch.Tensor:
    """``einsum("bshv,vhd->bsd", y, w3)``: (B, S, H, Dh) @ (Dh, H, d),
    the product taken by ``mm``."""
    Dh, H, d = w3.shape
    return mm(y.transpose(-1, -2).reshape(*y.shape[:2], Dh * H),
              w3.reshape(Dh * H, d))


def _shard_row(p, names):
    """The ``ModelRow`` when ``p``'s weights ``names`` are model shards
    of more than one position, else None; on a model axis of one they
    go into ``p`` whole. Some of them sharded and some not raises."""
    ws = [p[n] for n in names]
    if all(isinstance(w, torch.Tensor) for w in ws):
        return None
    if any(isinstance(w, torch.Tensor) for w in ws):
        raise ValueError(f"{names}: some weights are model-sharded and "
                         "some are not")
    row = ws[0].row
    if row.tp > 1:
        return row
    for n in names:
        p[n] = p[n].full()
    return None


# --- xLSTM: mLSTM block -----------------------------------------------------

_MLSTM_SPLIT = ("wv3", "w_z3", "w_down3")


def _mlstm_gates(cfg: ArchConfig, p, h):
    gates = h @ p["w_if"]                                  # (B, S, 2H)
    H = cfg.n_heads
    log_i = layers.softcap(gates[..., :H].float(), _GATE_CAP)
    log_f = layers._log_sigmoid(gates[..., H:].float())
    return log_i, log_f


def _mlstm_qkvzg(cfg: ArchConfig, p, h):
    q, k, v, z = (_heads(h, p[name]) for name in ("wq3", "wk3", "wv3",
                                                   "w_z3"))
    return (q, k, v, z) + _mlstm_gates(cfg, p, h)


def _row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A model shard's row-parallel partial product ``x @ w``: in f32
    where no gradient is recorded (the sharded serving), so the split
    rounds once, after ``sum_model``'s f32 sum, as the unsplit product
    rounds its f32 accumulator once (bf16 partials rounded apart move a
    recurrent stack's bf16 logits several times further from the
    unsplit ones); in x's dtype under autograd, where the training step
    saves it. An f32 product is the same either way."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return x @ w
    return x.float() @ w.float()


def _mlstm_down(y, z, w_down3, mm=torch.matmul):
    """The gated readout through the down-projection (all of Dh, or a
    model shard's rows, ``mm`` then ``_row``)."""
    y = y * torch.nn.functional.silu(z.float()).to(y.dtype)
    return _down3(y, w_down3, mm)


def mlstm_block(cfg: ArchConfig, p, x):
    """Pre-norm mLSTM block (no causal conv; gates and projections from
    the normed stream, as in the reference). On model shards of wv3,
    w_z3 and w_down3 (split along Dh) each shard runs the scan on its
    Dh / tp columns of v and z with the whole q, k and gates, and
    ``sum_model`` adds its down-projections."""
    p = dict(p)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    row = _shard_row(p, _MLSTM_SPLIT)
    if row is None:
        q, k, v, z, log_i, log_f = _mlstm_qkvzg(cfg, p, h)
        return x + _mlstm_down(layers.mlstm_scan(q, k, v, log_f, log_i), z,
                               p["w_down3"])
    q, k = _heads(h, p["wq3"]), _heads(h, p["wk3"])
    log_i, log_f = _mlstm_gates(cfg, p, h)
    outs = []
    for j, (hj, qj, kj, ij, fj) in enumerate(zip(*(
            PL.to_model(t, row) for t in (h, q, k, log_i, log_f)))):
        wv, wz, wd = (p[n].parts[j] for n in _MLSTM_SPLIT)
        y = layers.mlstm_scan(qj, kj, _heads(hj, wv), fj, ij)
        outs.append(_mlstm_down(y, _heads(hj, wz), wd, _row))
    return x + PL.sum_model(outs, row).to(x.dtype)


def mlstm_block_step(cfg: ArchConfig, p, x, state):
    """O(1) decode step; state = (C, n). Returns (x, (C, n))."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v, z, log_i, log_f = _mlstm_qkvzg(cfg, p, h)
    state, y = layers.mlstm_step(state, q, k, v, log_f, log_i)
    return x + _mlstm_down(y, z, p["w_down3"]), state


def _whole_params(p) -> dict:
    """``p`` with every model-sharded weight whole (``layers.whole``):
    on a model axis of one, the shard itself."""
    return {k: layers.whole(v) for k, v in p.items()}


def _copy_into(parts, new) -> None:
    """``new`` (one tensor) into every local shard's copy of a state
    leaf every shard keeps whole."""
    for part in parts:
        part.copy_(new)


def mlstm_block_step_model(cfg: ArchConfig, p, x, C: PL.StateShards,
                           n: PL.StateShards) -> torch.Tensor:
    """``mlstm_block_step`` of one data row over its layer of the placed
    state, updated in place: ``C`` the matrix memory (B, H, D_out, D_in)
    split over D_out as ``cache_shardings`` splits it, ``n`` (B, H, D)
    a whole copy on every shard. On model shards of wv3, w_z3 and
    w_down3 (split along Dh, the same split) each shard updates its
    D_out rows of C with its v columns from the replicated q, k and
    gates (``layers.mlstm_step``, whose n update and normalizer are
    every shard's alike), reads out C q locally, and ``sum_model`` adds
    its rows of the down-projection; the first shard's new n is copied
    into every shard's. On a model axis of one, the one-device step."""
    p = dict(p)
    row = _shard_row(p, _MLSTM_SPLIT)
    if row is None:
        if C.row.tp > 1 and C.dim is not None:
            raise ValueError("mlstm_block_step_model: the memory splits "
                             "but the weights do not")
        x, (C2, n2) = mlstm_block_step(cfg, _whole_params(p), x,
                                       (C.parts[0], n.parts[0]))
        _copy_into(C.parts, C2)
        _copy_into(n.parts, n2)
        return x
    if C.dim != 2 or n.dim is not None:
        raise ValueError(f"mlstm_block_step_model: C split over {C.dim}, "
                         f"n over {n.dim}")
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k = _heads(h, p["wq3"]), _heads(h, p["wk3"])
    log_i, log_f = _mlstm_gates(cfg, p, h)
    outs, n_new = [], None
    for j, (hj, qj, kj, ij, fj) in enumerate(zip(*(
            PL.to_model(t, row) for t in (h, q, k, log_i, log_f)))):
        wv, wz, wd = (p[name].parts[j] for name in _MLSTM_SPLIT)
        (C2, n2), y = layers.mlstm_step((C.parts[j], n.parts[j]), qj, kj,
                                        _heads(hj, wv), fj, ij)
        C.parts[j].copy_(C2)
        n_new = n2 if n_new is None else n_new
        outs.append(_mlstm_down(y, _heads(hj, wz), wd, _row))
    _copy_into(n.parts, n_new)
    return x + PL.sum_model(outs, row).to(x.dtype)


# --- xLSTM: sLSTM block -----------------------------------------------------

_SLSTM = ("w_zi", "w_zf", "w_zz", "w_zo", "w_down")


def _slstm_preact(cfg: ArchConfig, p, h):
    B, S, _ = h.shape
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    return tuple((h @ p[name]).reshape(B, S, H, Dh)
                 for name in _SLSTM[:4])


def _slstm_split(p, h, row) -> list:
    """Each local shard's sLSTM output (B, S, cols) from its columns of
    w_zi/w_zf/w_zz/w_zo. The shards on one device run one scan, their
    columns stacked as more batch rows: the scan is elementwise, so each
    shard's values are its own, and a row on one card loops over S once
    rather than once a shard."""
    B, S, _ = h.shape
    pre = [[(hj @ p[n].parts[j]).reshape(B, S, 1, -1) for n in _SLSTM[:4]]
           for j, hj in enumerate(PL.to_model(h, row))]
    by_device: dict = {}
    for j, zs in enumerate(pre):
        by_device.setdefault(zs[0].device, []).append(j)
    out = [None] * len(pre)
    for js in by_device.values():
        y = layers.slstm_scan(*(torch.cat([pre[j][g] for j in js])
                                for g in range(4)))
        for j, yj in zip(js, y.split(B)):
            out[j] = yj.reshape(B, S, -1)
    return out


def slstm_block(cfg: ArchConfig, p, x):
    """Pre-norm sLSTM block. On model shards of its weights (split by
    columns, which may cut a head) each shard projects its columns, scans
    them (``_slstm_split``) and multiplies by its rows of w_down, and
    ``sum_model`` adds the products."""
    p = dict(p)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    row = _shard_row(p, _SLSTM)
    if row is None:
        y = layers.slstm_scan(*_slstm_preact(cfg, p, h))
        return x + y.reshape(*x.shape[:2], -1) @ p["w_down"]
    return x + PL.sum_model([_row(y, p["w_down"].parts[j]) for j, y in
                             enumerate(_slstm_split(p, h, row))],
                            row).to(x.dtype)


def slstm_block_step(cfg: ArchConfig, p, x, state):
    """O(1) decode step; state = (c, n, m). Returns (x, (c, n, m))."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    state, y = layers.slstm_step(state, *_slstm_preact(cfg, p, h))
    return x + y.reshape(x.shape[0], 1, -1) @ p["w_down"], state


def slstm_block_step_model(cfg: ArchConfig, p, x, states) -> torch.Tensor:
    """``slstm_block_step`` of one data row over its layer of the placed
    state (``states``: c, n, m as ``placement.StateShards``, each a whole
    copy on every shard, as ``cache_shardings`` keeps them), updated in
    place. On model shards of its weights (split by columns, which may
    cut a head) each shard steps its columns of the state
    (``layers.slstm_step``: elementwise) and multiplies its output by
    its rows of w_down, ``sum_model`` adds the products, and the new c,
    n and m columns are gathered over ``model`` (``cat_model``: B d f32
    each) into every shard's copy, so every position holds the whole
    state, bit for bit alike. On a model axis of one, the one-device
    step."""
    p = dict(p)
    row = _shard_row(p, _SLSTM)
    if any(s.dim is not None and s.row.tp > 1 for s in states):
        raise ValueError("slstm_block_step_model: the sLSTM state splits "
                         "over model")
    if row is None:
        x, new = slstm_block_step(cfg, _whole_params(p), x,
                                  tuple(s.parts[0] for s in states))
        for s, t in zip(states, new):
            _copy_into(s.parts, t)
        return x
    B = x.shape[0]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    n = cfg.d_model // row.tp
    outs, news = [], []
    for k, (i, hj) in enumerate(zip(row.indices, PL.to_model(h, row))):
        pre = [(hj @ p[name].parts[k]).reshape(B, 1, 1, n)
               for name in _SLSTM[:4]]
        state = tuple(s.parts[k].reshape(B, 1, -1)[..., i * n:(i + 1) * n]
                      for s in states)
        new, y = layers.slstm_step(state, *pre)
        outs.append(_row(y.reshape(B, 1, n), p["w_down"].parts[k]))
        news.append(new)
    for s, cols in zip(states, zip(*news)):
        whole = PL.cat_model([c.reshape(B, n) for c in cols], row, 1)
        for part in s.parts:
            part.copy_(whole.reshape(part.shape))
    return x + PL.sum_model(outs, row).to(x.dtype)


# --- Hymba: parallel attention + SSM heads ----------------------------------

def _hymba_ssm_in(cfg: ArchConfig, p, h):
    """The SSM branch's inputs: x (B, S, H, Dh), delta (B, S, H), B and C
    (B, S, H, N)."""
    B, S, _ = h.shape
    H, Dh, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    return ((h @ p["ssm_in"]).reshape(B, S, H, Dh), h @ p["ssm_dt"],
            (h @ p["ssm_B"]).reshape(B, S, H, N),
            (h @ p["ssm_C"]).reshape(B, S, H, N))


def _hymba_ffn(cfg: ArchConfig, p, x):
    """The dense SwiGLU FFN, split by ff where its weights are model
    shards (``layers.model_parallel``)."""
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.model_parallel(layers.swiglu, h2, p["w_gate"],
                                     p["w_up"], p["w_down"])


def _hymba_fuse_ffn(cfg: ArchConfig, p, x, ya, ys):
    """The average of the per-branch RMS-normalized outputs through the
    shared output projection, then the dense SwiGLU FFN."""
    fused = 0.5 * (layers.rms_norm(ya, p["attn_norm"], cfg.norm_eps)
                   + layers.rms_norm(ys, p["ssm_norm"], cfg.norm_eps))
    return _hymba_ffn(cfg, p, x + fused @ p["wo"])


def _hymba_ssm_split(cfg: ArchConfig, p, h, row):
    """Each local shard's columns [c0, c1) of the SSM branch's output
    (B, S, c1 - c0), from its columns of ``ssm_in``: the scan runs on the
    heads [c0 // Dh, ceil(c1 / Dh)) those columns span, with the whole
    delta, B and C of those heads and zeros in the spanned columns that
    are not the shard's (each output column reads only its own)."""
    B, S, _ = h.shape
    H, Dh, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    n = H * Dh // row.tp
    dt = h @ p["ssm_dt"]
    Bm = (h @ p["ssm_B"]).reshape(B, S, H, N)
    Cm = (h @ p["ssm_C"]).reshape(B, S, H, N)
    outs = []
    for i, w, hj, dj, bj, cj, aj in zip(
            row.indices, p["ssm_in"].parts,
            *(PL.to_model(t, row) for t in (h, dt, Bm, Cm, p["A_log"]))):
        c0 = i * n
        a, b = c0 // Dh, -(-(c0 + n) // Dh)
        off = c0 - a * Dh
        xs = torch.nn.functional.pad(hj @ w, (off, b * Dh - c0 - n))
        ys = layers.ssm_scan(xs.reshape(B, S, b - a, Dh), dj[..., a:b],
                             bj[:, :, a:b], cj[:, :, a:b], aj[a:b])
        outs.append(ys.reshape(B, S, -1)[..., off:off + n])
    return outs


def hymba_block(cfg: ArchConfig, p, x, positions, *, window: int,
                q_offset: int = 0):
    """Attention and the Mamba-style SSM on the same normed input, fused
    (meta-tokens omitted, as in the reference). ``window`` is the layer's
    Python int (``GLOBAL_WINDOW`` for the global layers). Returns
    (x, k after rope, v). On model shards the attention splits by whole
    query heads (``blocks._attn_split``), the SSM branch, the fusion and
    the output projection by columns (``_hymba_ssm_split``), each
    branch's norm over its whole width (``layers.rms_norm_model``, the
    attention's over each shard's head-aligned columns), and by
    linearity ``sum_model`` adds each shard's 0.5 a_j @ wo[its heads'
    rows] + 0.5 s_j @ wo[its own rows]; k and v are then None."""
    B, S, _ = x.shape
    p = dict(p)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    row = _shard_row(p, ("ssm_in", "wo"))
    split = blocks._attn_split(cfg, p, ("wq", "wk", "wv", "wo"))
    if row is None:
        q, k, v = blocks._qkv(cfg, p, h, positions)
        ya = layers.flash_attention(q, k, v, **kw).reshape(B, S, -1)
        ys = layers.ssm_scan(*_hymba_ssm_in(cfg, p, h), p["A_log"])
        return _hymba_fuse_ffn(cfg, p, x, ya, ys.reshape(B, S, -1)), k, v
    _, heads, ws = split
    ya = []
    for hd, hj, wj in zip(heads, PL.to_model(h, row), ws):
        if not hd.segments:            # no head: (B, S, 0)
            ya.append(hj @ wj["wq"])
            continue
        q, k, v = blocks._qkv(cfg, wj, hj, positions.to(hj.device))
        ya.append(blocks._by_segments(cfg, hd, q, k, v, **kw)
                  .reshape(B, S, -1))
    eps, width, Dh = cfg.norm_eps, cfg.n_heads * cfg.head_dim, cfg.head_dim
    (na,) = PL.take_model([p["attn_norm"]], [[
        (a * Dh, b * Dh) for a, b in (hd.q for hd in shard_heads(
            cfg.n_heads, cfg.n_kv_heads, row.tp))]], [0], row)
    ya = layers.rms_norm_model(ya, na, row, width, eps)
    ys = layers.rms_norm_model(_hymba_ssm_split(cfg, p, h, row),
                               PL.split_model(p["ssm_norm"], row, 0), row,
                               width, eps)
    y = PL.sum_model([_row(0.5 * a, wj["wo"]) + _row(0.5 * s, w)
                      for a, s, wj, w in
                      zip(ya, ys, ws, p["wo"].parts)], row)
    return _hymba_ffn(cfg, p, x + y.to(x.dtype)), None, None


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


def _ssm_columns(cfg: ArchConfig, box) -> list:
    """The flattened (H Dh) columns of the SSM's x and y that a state
    box (B, H, N, Dh) covers: every head of its range, its Dh columns;
    the box must hold every N."""
    (_, (h0, h1), (n0, n1), (d0, d1)) = box
    if (n0, n1) != (0, cfg.ssm_state):
        raise ValueError("hymba: an SSM state split over its N")
    Dh = cfg.head_dim
    return [hh * Dh + dd for hh in range(h0, h1) for dd in range(d0, d1)]


def hymba_block_step_model(cfg: ArchConfig, p, x, kv: PL.CacheShards,
                           ssm: PL.StateShards, t: int, ring: int
                           ) -> torch.Tensor:
    """``hymba_block_step`` of one data row at position ``t`` over its
    layer of the placed cache, updated in place: ``kv`` the layer's k/v
    ring of ``ring`` slots split as ``cache_shardings`` splits it (its
    slots, or Dh), ``ssm`` the SSM state (B, H, N, Dh) split over Dh.

    * attention by whole query heads over the ring
      (``blocks._decode_attend``: the token to slot t % ring on the
      shards that keep it, min(t + 1, ring) valid slots, no window); the
      output meets whole on the row's home;
    * the SSM: each shard projects x on its flattened columns of
      ``ssm_in`` (which cut heads), and x is dealt to the state's split
      (``placement.regroup_model``: every head's Dh columns of the
      shard; B H Dh elements a step over the row). dt, B, C and
      ``A_log`` are replicated; the state update and C h are
      elementwise in Dh, so each shard steps its columns exactly
      (``layers.ssm_step``), and y goes back to the flattened columns
      the same way;
    * the fusion: the attention's RMS norm on the home, the SSM's over
      its shards' columns (``layers.rms_norm_model``), their mean
      through each shard's rows of wo, summed over ``model``; then the
      FFN by ff.

    On a model axis of one, the one-device step."""
    p = dict(p)
    row = _shard_row(p, ("ssm_in", "wo"))
    if row is None:
        if kv.row.tp > 1 and (kv.kind is not None or ssm.dim is not None):
            raise ValueError("hymba_block_step_model: the cache splits but "
                             "the weights do not")
        s = ssm.parts[0]
        x, _, _, s2 = hymba_block_step(cfg, _whole_params(p), x, kv.k[0],
                                       kv.v[0], s, t)
        _copy_into(ssm.parts, s2)
        return x
    B = x.shape[0]
    H, Dh, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    eps, width = cfg.norm_eps, H * Dh
    h = layers.rms_norm(x, p["ln1"], eps)
    ya, _ = blocks._decode_attend(cfg, p, h, kv, t, ring=ring)
    na = layers.rms_norm(ya.reshape(B, 1, width), p["attn_norm"], eps)
    n = width // row.tp
    have = [range(i * n, (i + 1) * n) for i in range(row.tp)]
    want = [_ssm_columns(cfg, b) for b in ssm.boxes]
    xs = PL.regroup_model(row, [hj @ w for hj, w in zip(
        PL.to_model(h, row), p["ssm_in"].parts)], have, want)
    dt = h @ p["ssm_dt"]
    Bm = (h @ p["ssm_B"]).reshape(B, 1, H, N)
    Cm = (h @ p["ssm_C"]).reshape(B, 1, H, N)
    ys = []
    for s, box, xj in zip(ssm.parts, ssm.mine(), xs):
        (h0, h1), dev = box[1], xj.device
        s2, y = layers.ssm_step(
            s, xj.reshape(B, 1, h1 - h0, -1), dt[..., h0:h1].to(dev),
            Bm[:, :, h0:h1].to(dev), Cm[:, :, h0:h1].to(dev),
            p["A_log"][h0:h1].to(dev))
        s.copy_(s2)
        ys.append(y.reshape(B, 1, -1))
    ns = layers.rms_norm_model(PL.regroup_model(row, ys, want, have),
                               PL.split_model(p["ssm_norm"], row, 0), row,
                               width, eps)
    y = PL.sum_model([_row(0.5 * (a + s), w) for a, s, w in zip(
        PL.split_model(na, row, 2), ns, p["wo"].parts)], row)
    return _hymba_ffn(cfg, p, x + y.to(x.dtype))
