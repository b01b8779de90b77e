"""Model assembly for every family of ``repro.models``: parameter init,
the stacked-layer forward (a Python loop where the reference scans),
prefill-with-cache and single-token decode.

The port serves the dense family (smollm-135m, granite-8b,
deepseek-coder-33b and gemma2-9b with its local/global windows, post-norms
and softcaps), MoE (qwen3-moe-235b-a22b, grok-1-314b; sort-based dispatch,
``layers.moe_ffn``), the llava backbone (image embeddings prepended to the
tokens), whisper's encoder-decoder (the encoder memory kept in the decode
cache), xLSTM (``ssm``: groups of mLSTM blocks closed by one sLSTM block,
recurrent states in the decode cache) and hymba (``hybrid``: attention and
an SSM in parallel in every layer, a ring-buffered KV cache and an SSM
state a layer)."""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from ..distributed import placement as PL
from . import blocks, layers, recurrent
from .blocks import GLOBAL_WINDOW
from .config import ArchConfig

Params = Dict[str, Any]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


#: the families of ``ArchConfig.family``, every one of them served
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def check_served(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose family is none of
    ``FAMILIES``; every config of ``configs`` is served."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; the port serves "
            f"{', '.join(FAMILIES)}")


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
    if cfg.family == "hybrid":
        N = cfg.ssm_state
        p.update(ssm_in=(d, H * Dh), ssm_dt=(d, H), ssm_B=(d, H * N),
                 ssm_C=(d, H * N), A_log=(H, N),
                 attn_norm=(H * Dh,), ssm_norm=(H * Dh,))
    if cfg.enc_dec:                       # decoder cross-attention
        p.update(ln_x=(d,), wq_x=(d, H * Dh), wk_x=(d, Hk * Dh),
                 wv_x=(d, Hk * Dh), wo_x=(H * Dh, d))
    return p


def _mlstm_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """The reference's Dh-major layout: (d, Dh, H) projections and a
    (Dh, H, d) down-projection."""
    d, H = cfg.d_model, cfg.n_heads
    Dh = d // H
    return dict(ln1=(d,), wq3=(d, Dh, H), wk3=(d, Dh, H), wv3=(d, Dh, H),
                w_z3=(d, Dh, H), w_if=(d, 2 * H), w_down3=(Dh, H, d))


def _slstm_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    return dict(ln1=(d,), w_zi=(d, d), w_zf=(d, d), w_zz=(d, d),
                w_zo=(d, d), w_down=(d, d))


def _xlstm_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(G, per): G groups of per - 1 mLSTM blocks and one sLSTM block."""
    per = cfg.slstm_every if cfg.slstm_every else cfg.n_layers
    if cfg.n_layers % per:
        raise ValueError("n_layers must divide by slstm_every")
    return cfg.n_layers // per, per


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """The parameter dict with the reference's names, shapes and scales
    (norm weights zero, matrices normal * fan_in ** -0.5, embeddings and
    whisper's ``enc_pos`` normal * 0.02; blocks stacked on a leading layer
    axis, whisper's encoder in ``enc_blocks``), drawn in f32 on the
    generator's device from ``generator`` and cast to ``cfg.dtype`` on
    ``device``. A stack is drawn a layer at a time into its preallocated
    ``cfg.dtype`` tensor, so the f32 draw never holds more than one
    layer of one weight. xLSTM's blocks are ``mlstm`` stacked (G, per - 1)
    and ``slstm`` stacked (G,) (``_xlstm_groups``); hymba's ``A_log`` is
    log(1..N) in float32 whatever ``cfg.dtype`` is. The numbers differ
    from ``jax.random``'s; tests carry the reference's weights across with
    ``convert.params_from_numpy`` instead. On ``device="meta"`` nothing is
    drawn (``generator`` may be None): the tensors have the shapes and
    dtypes and no storage, the dry-run's ``param_structs``."""
    check_served(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def draw_into(out: torch.Tensor, scale: float) -> torch.Tensor:
        if dev.type == "meta":
            return out
        x = torch.randn(out.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return out.copy_(x.mul_(scale))

    def normal(shape, scale):
        return draw_into(torch.empty(shape, dtype=dt, device=dev), scale)

    def group(shapes: Dict[str, Tuple[int, ...]], *stack: int) -> Params:
        out: Params = {}
        for name, shp in sorted(shapes.items()):
            if name == "A_log":
                out[name] = torch.log(torch.arange(
                    1, shp[-1] + 1, dtype=torch.float32, device=dev)
                ).expand(stack + shp).contiguous()
                continue
            if len(shp) == 1:
                out[name] = torch.zeros(stack + shp, dtype=dt, device=dev)
                continue
            t = torch.empty(stack + shp, dtype=dt, device=dev)
            for i in np.ndindex(*stack) if dev.type != "meta" else ():
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
    if cfg.family == "ssm":
        G, per = _xlstm_groups(cfg)
        params["mlstm"] = group(_mlstm_param_shapes(cfg), G, per - 1)
        params["slstm"] = group(_slstm_param_shapes(cfg), G)
        return params
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


def _layer(stack: Params, i) -> Params:
    """Layer ``i``'s parameters (an int, or a tuple into xLSTM's
    (G, per - 1) mLSTM stack): views into a stacked group."""
    return {k: v[i] for k, v in stack.items()}


def _layers(stack: Params) -> List[Params]:
    """Every layer's parameters along the stack's leading axis, views
    taken by one ``unbind`` a weight: under autograd its backward stacks
    the layers' gradients once, where a view a layer would add a
    stack-sized gradient a layer. A model-sharded weight unbinds its
    shards the same way."""
    cols = {k: v.unbind(0) for k, v in stack.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


class _FrameGate(torch.autograd.Function):
    """The identity on a checkpointed layer's outputs that saves one of
    them, so the layer's backward starts here: its first unpack runs the
    recompute, on this node's thread, before any other node of the
    layer runs. A layer whose shards sit on several cards has backward
    nodes on several of autograd's device threads, and two of them
    unpacking the frame at once would both recompute it (the
    checkpoint's frame takes no lock)."""

    @staticmethod
    def forward(ctx, *ts):
        ctx.save_for_backward(ts[0])
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        ctx.saved_tensors            # the recompute, if it has not run
        return gs


def _spans_devices(args) -> bool:
    """Whether a layer's model shards lie on more than one device."""
    devs = {p.device for a in args if isinstance(a, dict)
            for v in a.values() if isinstance(v, PL.ModelShards)
            for p in v.parts}
    return len(devs) > 1


def _gate(out):
    """``out`` (a tensor or a tuple) through one ``_FrameGate`` on its
    tensors that want a gradient."""
    outs = out if isinstance(out, tuple) else (out,)
    idx = [i for i, t in enumerate(outs)
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if not idx:
        return out
    gated = _FrameGate.apply(*(outs[i] for i in idx))
    outs = list(outs)
    for i, t in zip(idx, gated):
        outs[i] = t
    return tuple(outs) if isinstance(out, tuple) else outs[0]


def _run(remat: bool, fn, *args, whole: bool = False):
    """``fn(*args)``, under ``remat`` (and grad mode) through
    ``torch.utils.checkpoint`` (non-reentrant): the layer keeps only its
    inputs and runs again in the backward, the same ops on the same
    values, so the numbers are bitwise those without it. A layer's
    model-sharded weights (``placement.ModelShards``) reach ``fn``,
    whose blocks split over ``model`` (``blocks``); with ``whole`` (the
    recurrent families) they are gathered inside the call instead, so
    under remat the gather runs again in the backward and a layer's
    whole weights live only while it runs. Either way the recompute
    issues the layer's collectives again, in the forward's order. A
    layer whose shards span several devices goes through ``_FrameGate``,
    so one thread recomputes it."""
    gate = remat and _spans_devices(args)

    def call(*a):
        if whole:
            a = tuple({k: layers.whole(v) for k, v in x.items()}
                      if isinstance(x, dict) else x for x in a)
        out = fn(*a)
        return _gate(out) if gate else out
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            call, *args, use_reentrant=False, preserve_rng_state=False)
    return call(*args)


def _dense_layer(cfg: ArchConfig, lp: Params, x, positions, window: int,
                 q_offset: int):
    a = blocks.attention_block(cfg, lp, x, positions, window=window,
                               q_offset=q_offset)
    x, aux = blocks.ffn_block(cfg, lp, a.y)
    return x, aux, a.k, a.v


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    cache: Optional[Any]          # {"kv": (k, v)}, each (L, B, S, Hk, Dh),
                                  # and whisper's "enc_out" (B, Te, d);
                                  # None for xLSTM


def _vocab_local(ids: torch.Tensor, index: int, n: int):
    """(ids into a vocab shard of ``n`` rows at model coordinate
    ``index``, 0 outside it; whether each is inside)."""
    t = ids.long() - index * n
    inside = (t >= 0) & (t < n)
    return torch.where(inside, t, 0), inside


def _embed_tokens(cfg: ArchConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``; gemma scales them by
    sqrt(d_model) rounded to that dtype first, as the reference's
    ``x * asarray(d_model ** 0.5, dt)`` does. The lookup is
    ``F.embedding``: the gather of ``embed[tokens]``, with a backward
    that sums each row's gradients in a fixed order (indexing's
    backward accumulates with atomics on the CPU, and its bits change
    from run to run). A vocab-sharded embedding (``ModelShards``): each
    shard looks up the tokens of its rows and gives zeros elsewhere, and
    ``sum_model`` adds them, one nonzero term a token, so the result is
    the whole lookup's bits."""
    dt = _dtype(cfg)
    emb = params["embed"]
    if isinstance(emb, torch.Tensor) or emb.row.tp == 1:
        x = torch.nn.functional.embedding(tokens.long(),
                                          layers.whole(emb)).to(dt)
    else:
        row = emb.row
        parts = []
        for i, e in zip(row.indices, emb.parts):
            t, inside = _vocab_local(tokens.to(e.device), i, e.shape[0])
            xe = torch.nn.functional.embedding(t, e)
            parts.append(torch.where(inside[..., None], xe, 0.0))
        x = PL.sum_model(parts, row).to(dt)
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
    values are exact in f32), then ``final_softcap``: in place unless
    autograd records it (gemma2's 2 x 8192 x 256000 logits are 16.8 GB
    in f32), out of place when it does (``tanh`` saves its output for
    the backward); both forms give the same bits. A vocab-sharded
    unembedding gives vocab shards: ``unembed_shards``."""
    unemb = params.get("unembed")
    tied = unemb is None
    unemb = params["embed"] if tied else unemb
    if not isinstance(unemb, torch.Tensor):
        if unemb.row.tp > 1:
            raise TypeError("a vocab-sharded unembedding gives each shard's "
                            "logits: call unembed_shards")
        unemb = unemb.full()
    return _logits(cfg, x, unemb.T if tied else unemb)


def unembed_shards(cfg: ArchConfig, params: Params, x: torch.Tensor):
    """The logits of hidden states ``x`` as vocab shards: ([each local
    shard's (..., V / tp) f32 logits], the ``ModelRow``) for a
    vocab-sharded unembedding (tied: the embedding's rows), ([the whole
    logits], None) otherwise. ``final_softcap`` applies per element, as
    in ``_unembed``; the whole (..., V) logits are never formed."""
    unemb = params.get("unembed")
    tied = unemb is None
    unemb = params["embed"] if tied else unemb
    if isinstance(unemb, torch.Tensor) or unemb.row.tp == 1:
        return [_unembed(cfg, params, x)], None
    row = unemb.row
    return [_logits(cfg, xj, w.T if tied else w) for xj, w in
            zip(PL.to_model(x, row), unemb.parts)], row


def _logits(cfg: ArchConfig, x: torch.Tensor, unemb: torch.Tensor
            ) -> torch.Tensor:
    logits = x.float() @ unemb.float()
    cap = cfg.final_softcap
    if cap is not None:
        if logits.requires_grad:
            logits = torch.tanh(logits / cap) * cap
        else:
            logits.div_(cap).tanh_().mul_(cap)
    return logits


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, return_cache: bool = False, q_offset: int = 0,
            logits_mode: str = "all", remat: bool = False) -> ForwardOut:
    """Full-sequence forward. batch: tokens (B, S) int; llava adds
    image_embeds (B, Ni, d); whisper adds frames (B, Te, d).

    logits_mode: 'all' (every position, f32), 'last' (unembed only the
    final position), 'hidden' (the final hidden states in ``.logits``).
    xLSTM returns no cache (its recurrent states are not threaded out,
    as in the reference); hymba's is every layer's k and v. ``remat``
    recomputes each layer (each block of whisper's encoder and decoder,
    of xLSTM's groups) in the backward (``_run``); the training path's
    counterpart of the reference's ``jax.checkpoint``. Differentiable
    throughout: the flash kernel's output takes the oracle's gradient."""
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
        for lp in _layers(params["enc_blocks"]):
            enc = _run(remat, blocks.whisper_encoder_block, cfg, lp, enc)
        enc = layers.rms_norm(enc, params["enc_norm"], cfg.norm_eps)
        for lp in _layers(params["blocks"]):
            x, k, v = _run(remat, blocks.whisper_decoder_block, cfg, lp, x,
                           enc, positions)
            if return_cache:
                ks.append(k)
                vs.append(v)
        extra["enc_out"] = enc
    elif cfg.family == "ssm":
        x = _xlstm_stack(cfg, params, x, remat)
    elif cfg.family == "hybrid":
        for lp, w in zip(_layers(params["blocks"]), window_schedule(cfg)):
            x, k, v = _run(remat, functools.partial(
                recurrent.hymba_block, window=int(w), q_offset=q_offset),
                cfg, lp, x, positions, whole=True)
            if return_cache:
                ks.append(k)
                vs.append(v)
    else:
        for lp, w in zip(_layers(params["blocks"]), window_schedule(cfg)):
            x, aux, k, v = _run(remat, _dense_layer, cfg, lp, x, positions,
                                int(w), q_offset)
            aux_total = aux_total + aux
            if return_cache:
                ks.append(k)
                vs.append(v)
    cache = {"kv": (torch.stack(ks), torch.stack(vs)), **extra} \
        if return_cache and ks else None
    del ks, vs                    # the stack holds copies: free before
                                  # the unembed's f32 buffers

    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_mode == "hidden":
        return ForwardOut(x, aux_total, cache)
    if logits_mode == "last":
        x = x[:, -1:]
    return ForwardOut(_unembed(cfg, params, x), aux_total, cache)


def _xlstm_stack(cfg: ArchConfig, params: Params, x: torch.Tensor,
                 remat: bool = False) -> torch.Tensor:
    for group, sp in zip(_layers(params["mlstm"]), _layers(params["slstm"])):
        for mp in _layers(group):
            x = _run(remat, recurrent.mlstm_block, cfg, mp, x, whole=True)
        x = _run(remat, recurrent.slstm_block, cfg, sp, x, whole=True)
    return x


# ---------------------------------------------------------------------------
# decode (single token, KV caches)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The zeroed decode cache in the reference's layout and dtypes: k
    and v each (L, B, max_len, Hk, Dh) in ``cfg.dtype``, whisper's with
    the encoder memory ``enc_out`` (B, enc_positions, d); xLSTM's
    recurrent states (``mlstm_C`` (G, per - 1, B, H, D, D) in bf16
    whatever ``cfg.dtype`` is, ``mlstm_n`` and the sLSTM's c, n in f32,
    its m filled with -1e30); hymba's ``{"layers": [{k, v, ssm}, ...]}``,
    a layer's k and v ring of min(window, max_len) positions and its SSM
    state (B, H, N, Dh) in f32."""
    check_served(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    f32 = dict(dtype=torch.float32, device=dev)
    if cfg.family == "ssm":
        G, per = _xlstm_groups(cfg)
        H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
        return {
            "mlstm_C": torch.zeros((G, per - 1, batch, H, D, D),
                                   dtype=torch.bfloat16, device=dev),
            "mlstm_n": torch.zeros((G, per - 1, batch, H, D), **f32),
            "slstm_c": torch.zeros((G, batch, H, D), **f32),
            "slstm_n": torch.zeros((G, batch, H, D), **f32),
            "slstm_m": torch.full((G, batch, H, D), -1e30, **f32),
        }
    if cfg.family == "hybrid":
        H, N, Hk, Dh = (cfg.n_heads, cfg.ssm_state, cfg.n_kv_heads,
                        cfg.head_dim)
        layers_ = []
        for w in window_schedule(cfg):
            T = min(int(w), max_len)
            layers_.append({
                "k": torch.zeros((batch, T, Hk, Dh), dtype=dt, device=dev),
                "v": torch.zeros((batch, T, Hk, Dh), dtype=dt, device=dev),
                "ssm": torch.zeros((batch, H, N, Dh), **f32)})
        return {"layers": layers_}
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
    (row ``t`` of every layer's k and v; hymba's ring slot t % T_cache;
    every recurrent state), where the reference returns new arrays; the
    returned cache is the same dict. Whisper's step attends over
    ``cache["enc_out"]`` in every layer (the flash kernel on CUDA)."""
    check_served(cfg)
    x = _embed_tokens(cfg, params, tokens)
    if cfg.family == "ssm":
        x = _xlstm_decode(cfg, params, cache, x)
    elif cfg.family == "hybrid":
        for i, lc in enumerate(cache["layers"]):
            x, _, _, s2 = recurrent.hymba_block_step(
                cfg, _layer(params["blocks"], i), x, lc["k"], lc["v"],
                lc["ssm"], t)
            lc["ssm"].copy_(s2)
    elif cfg.enc_dec:
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


def _xlstm_decode(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                  x: torch.Tensor) -> torch.Tensor:
    """Every block's decode step, its new state copied into the cache."""
    G, per = _xlstm_groups(cfg)
    for g in range(G):
        for j in range(per - 1):
            x, (C2, n2) = recurrent.mlstm_block_step(
                cfg, _layer(params["mlstm"], (g, j)), x,
                (cache["mlstm_C"][g, j], cache["mlstm_n"][g, j]))
            cache["mlstm_C"][g, j].copy_(C2)
            cache["mlstm_n"][g, j].copy_(n2)
        names = ("slstm_c", "slstm_n", "slstm_m")
        x, state = recurrent.slstm_block_step(
            cfg, _layer(params["slstm"], g), x,
            tuple(cache[k][g] for k in names))
        for k, s2 in zip(names, state):
            cache[k][g].copy_(s2)
    return x
