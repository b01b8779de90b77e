"""Attention split over the model axis at every tp, on the CPU: each
shard runs whole query heads (shard j the heads [j H / tp, (j + 1) H /
tp), floored), from the weight columns of its heads and of the KV heads
they read, which ``placement.take_model`` fetches from their owners.

* ``take_model`` forward and backward, bitwise in f64: ranges that
  straddle the shards' blocks, a range two shards take (a shared KV
  head: their gradients summed into it in model order), an empty range
  (a shard with no head), a replicated leaf, one leaf's own blocks
  handed back untouched; on (1, 4) and on the (2, 2) mesh's second row;
  ``take_plan``'s pieces are each range cut at the block edges, and a
  shard receives no more than its range's pieces from other owners;
* the split attention against the unsplit block at the published head
  counts, f32, Dh 16 (smollm 9/3, deepseek-coder 56/8, granite 32/8,
  qwen3-moe 64/4, whisper 8/8 self- and cross-attention, hymba 25/5 in
  its fused block) on single-process (1, tp) CPU meshes of tp 2, 4, 8
  and 16: the residual and every gradient (x, the norms, each owner's
  shard of wq/wk/wv/wo) within ``test_torch_tensor_parallel``'s
  ``RTOL``/``ATOL``, the split forward within 1e-5 of the reference's
  block (``repro.models``) on the same numpy weights, every
  ``flash_attention`` call exactly one head segment of one shard (a run
  of whole KV groups, or a partial group at either end), no weight
  gathered whole (``cat_model`` and ``ModelShards.full`` unused);
* where the heads and KV heads divide tp, the split block is bitwise
  the layout before (each shard's own blocks, one call a shard; kept
  here as ``_even_split``), forward and gradients.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import recurrent as jrec
from _torch_threads import one_thread  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import placement as PL
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import blocks, layers, recurrent

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_tensor_parallel import close, grads_match  # noqa: E402

#: the split forward against the reference's block (f32)
REF = dict(rtol=1e-5, atol=1e-5)
TPS = [2, 4, 8, 16]
#: case -> (arch, heads, KV heads): the published head counts
HEADS = {"smollm 9/3": ("smollm-135m", 9, 3),
         "deepseek 56/8": ("deepseek-coder-33b", 56, 8),
         "granite 32/8": ("granite-8b", 32, 8),
         "qwen3-moe 64/4": ("qwen3-moe-235b-a22b", 64, 4)}
DH = 16
B, S = 2, 16
ATTN = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
CROSS = {"wq_x": 1, "wk_x": 1, "wv_x": 1, "wo_x": 0}


def configs(arch: str, H: int, Hk: int):
    kw = dict(dtype="float32", n_heads=H, n_kv_heads=Hk, d_head=DH)
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def layer_np(cfg, names: dict, seed: int) -> dict:
    """numpy weights of one layer: the projections normal / sqrt(fan
    in), the vectors (norms) normal * 0.1, A_log log(1..N)."""
    rng = np.random.default_rng(seed)
    d, H, Hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (d, H * DH), "wk": (d, Hk * DH), "wv": (d, Hk * DH),
              "wo": (H * DH, d), "ln1": (d,)}
    shapes.update(names)
    out = {}
    for k, shape in shapes.items():
        a = rng.standard_normal(shape)
        out[k] = (a * 0.1 if len(shape) == 1 else a / np.sqrt(shape[0]))
    return {k: v.astype(np.float32) for k, v in out.items()}


def leaves(lnp: dict) -> dict:
    return {k: torch.from_numpy(v.copy()).requires_grad_(True)
            for k, v in lnp.items()}


def mesh_row(tp: int, shape=None, pos: int = 0):
    shape = shape or (1, tp)
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape))), pos


def split(lp: dict, dims: dict, tp: int, shape=None, pos: int = 0) -> dict:
    """``lp`` with the weights of ``dims`` split over the row's model
    shards (``param_spec``'s even blocks), each part a leaf."""
    mesh, pos = mesh_row(tp, shape, pos)
    return {k: PL.ModelShards([p.detach().clone().requires_grad_(True)
                               for p in v.chunk(tp, dims[k])], dims[k],
                              mesh, pos, torch.device("cpu"))
            if k in dims else v for k, v in lp.items()}


def segment_shapes(H: int, Hk: int, tp: int, T: int) -> list:
    """The (q, k) shape of every attention call of a split layer: the
    head rule written out. Shard j's heads [j H // tp, (j + 1) H // tp)
    in runs that never cross a KV group's edge, each run all the whole
    groups it can take, else the part of one group left."""
    G = H // Hk
    calls = []
    for j in range(tp):
        a, q1 = j * H // tp, (j + 1) * H // tp
        while a < q1:
            if a % G:
                b = min(q1, (a // G + 1) * G)
            elif q1 - a >= G:
                b = a + (q1 - a) // G * G
            else:
                b = q1
            calls.append(((B, S, b - a, DH),
                          (B, T, (b - 1) // G - a // G + 1, DH)))
            a = b
    return calls


@pytest.fixture
def attention_calls(monkeypatch):
    """The (q, k) shapes of every ``layers.flash_attention`` call; and
    no weight gathered whole while the fixture is on."""
    calls = []
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    def refuse(*a, **k):
        raise AssertionError("a weight gathered whole")
    monkeypatch.setattr(layers, "flash_attention", spy)
    monkeypatch.setattr(PL, "cat_model", refuse)
    monkeypatch.setattr(PL.ModelShards, "full", refuse)
    return calls


def x_of(seed: int, d: int, n: int = S) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, n, d)).astype(np.float32)


POSITIONS = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


def _j(lnp: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in lnp.items()}


# --- take_model --------------------------------------------------------------

def _taken_leaf(tp: int, shape=None, pos: int = 0):
    gen = torch.Generator().manual_seed(tp)
    w = torch.randn(5, 8 * tp, generator=gen, dtype=torch.float64)
    mesh, pos = mesh_row(tp, shape, pos)
    parts = [p.clone().requires_grad_(True) for p in w.chunk(tp, 1)]
    return w, PL.ModelShards(parts, 1, mesh, pos, torch.device("cpu")), gen


@pytest.mark.parametrize("mesh", ["1x4", "2x2 second row"])
def test_take_model_is_the_slices_and_their_summed_gradient(mesh):
    """Shard 0 takes a range inside block 0, shards 1 and 2 the same
    range across blocks 0-2 (a KV head both read), shard 3 nothing;
    a replicated vector is taken by the same ranges and a second leaf's
    own blocks come back as they are. Forward: the slices; backward:
    each owner's block the sum of the gradients of every range over it,
    the vector's the sum of all, bitwise (f64, model order)."""
    shape, pos = ((1, 4), 0) if mesh == "1x4" else ((2, 2), 2)
    tp = shape[1]
    w, s, gen = _taken_leaf(tp, shape, pos)
    n = w.shape[1] // tp
    rg = ([(1, 3), (n - 2, 2 * n + 3), (n - 2, 2 * n + 3), (4 * n, 4 * n)]
          if tp == 4 else [(1, 3), (1, 3)])
    vec = torch.randn(w.shape[1], generator=gen,
                      dtype=torch.float64).requires_grad_(True)
    own = PL.ModelShards([p.detach().clone().requires_grad_(True)
                          for p in w.chunk(tp, 1)], 1, s.row.mesh, pos,
                         torch.device("cpu"))
    a, b, c = PL.take_model([s, vec, own], [rg, rg, [(j * n, (j + 1) * n)
                                                     for j in range(tp)]],
                            [1, 0, 1])
    assert all(x is y for x, y in zip(c, own.parts))
    for t, u, (lo, hi) in zip(a, b, rg):
        assert torch.equal(t, w[:, lo:hi]) and torch.equal(u, vec[lo:hi])
    ra = [torch.randn(t.shape, generator=gen, dtype=torch.float64)
          for t in a]
    rb = [torch.randn(t.shape, generator=gen, dtype=torch.float64)
          for t in b]
    loss = sum((t * r).sum() for t, r in zip(a + b, ra + rb))
    gs = torch.autograd.grad(loss, [*s.parts, vec])
    gw = torch.zeros_like(w)
    gv = torch.zeros_like(vec)
    for r, q, (lo, hi) in zip(ra, rb, rg):
        gw[:, lo:hi] += r
        gv[lo:hi] += q
    for g, want in zip(gs[:tp], gw.chunk(tp, 1)):
        assert torch.equal(g, want)
    assert torch.equal(gs[tp], gv)


def test_take_model_refuses_another_dim_and_a_short_range_list():
    _, s, _ = _taken_leaf(2)
    with pytest.raises(ValueError, match="split along 1"):
        PL.take_model([s], [[(0, 1), (0, 1)]], [0])
    with pytest.raises(ValueError, match="1 ranges for 2"):
        PL.take_model([s], [[(0, 1)]], [1])


@pytest.mark.parametrize("case,tp", [("smollm 9/3", 2), ("smollm 9/3", 4),
                                     ("deepseek 56/8", 16),
                                     ("qwen3-moe 64/4", 8)])
def test_each_shard_receives_its_heads_columns_only(case, tp):
    """What ``take_model`` copies to each shard: its range cut at the
    block edges, whose pieces from other owners are exactly the columns
    of its heads (of its KV heads) outside its own block; never a whole
    leaf at tp >= 2."""
    _, H, Hk = HEADS[case]
    G = H // Hk
    for width, heads in ((H * DH, lambda a, b: (a, b)),
                         (Hk * DH, lambda a, b: (a // G, (b - 1) // G + 1))):
        n = width // tp
        rg = [tuple(x * DH for x in heads(j * H // tp, (j + 1) * H // tp))
              for j in range(tp)]
        for j, pieces in enumerate(PL.take_plan(width, tp, rg)):
            lo, hi = rg[j]
            assert [p[1] for p in pieces] == [lo] + [p[2]
                                                     for p in pieces[:-1]]
            assert pieces[-1][2] == hi
            foreign = sum(b - a for i, a, b in pieces if i != j)
            inside = max(0, min(hi, (j + 1) * n) - max(lo, j * n))
            assert foreign == hi - lo - inside
            assert all(b - a <= n and i * n <= a < b <= (i + 1) * n
                       for i, a, b in pieces)
            assert hi - lo < width


# --- the split block at the published head counts ---------------------------

@functools.lru_cache(maxsize=None)
def reference_y(case: str) -> np.ndarray:
    arch, H, Hk = HEADS[case]
    jcfg, cfg = configs(arch, H, Hk)
    lnp = layer_np(cfg, {}, 5)
    return np.asarray(jblocks.attention_block(
        jcfg, _j(lnp), jnp.asarray(x_of(6, cfg.d_model)),
        jnp.asarray(POSITIONS)).y)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", list(HEADS))
def test_attention_splits_at_every_tp(case, tp, attention_calls):
    arch, H, Hk = HEADS[case]
    _, cfg = configs(arch, H, Hk)
    lnp = layer_np(cfg, {}, 5)
    x = torch.from_numpy(x_of(6, cfg.d_model)).requires_grad_(True)
    positions = torch.from_numpy(POSITIONS)
    lp = leaves(lnp)
    want = blocks.attention_block(cfg, lp, x, positions)
    attention_calls.clear()
    sp = split(lp, ATTN, tp)
    got = blocks.attention_block(cfg, sp, x, positions)
    assert attention_calls == segment_shapes(H, Hk, tp, S)
    assert got.k is None and got.v is None
    close(got.y, want.y)
    names = sorted(lp)
    grads_match(got.y, want.y, [x] + [sp[k] for k in names],
                [x] + [lp[k] for k in names])
    np.testing.assert_allclose(got.y.detach().numpy(), reference_y(case),
                               **REF)


@functools.lru_cache(maxsize=None)
def whisper_inputs():
    jcfg, cfg = configs("whisper-base", 8, 8)
    d, ff, HD = cfg.d_model, cfg.d_ff, 8 * DH
    lnp = layer_np(cfg, {"wq_x": (d, HD), "wk_x": (d, HD), "wv_x": (d, HD),
                         "wo_x": (HD, d), "ln_x": (d,), "ln2": (d,),
                         "w1": (d, ff), "w2": (ff, d)}, 7)
    xn, en = x_of(8, d), x_of(9, d, cfg.enc_positions)
    jy = jblocks.whisper_decoder_block(jcfg, _j(lnp), jnp.asarray(xn),
                                       jnp.asarray(en),
                                       jnp.asarray(POSITIONS))[0]
    je = jblocks.whisper_encoder_block(jcfg, _j(lnp), jnp.asarray(xn))
    return cfg, lnp, xn, en, np.asarray(jy), np.asarray(je)


@pytest.mark.parametrize("tp", TPS)
def test_whisper_self_and_cross_attention_split_at_every_tp(
        tp, attention_calls):
    """whisper's 8/8 heads: the decoder's causal self-attention and its
    cross-attention over the encoder memory, and the encoder's
    non-causal block; at tp 16 half the shards hold no head and add
    zeros."""
    cfg, lnp, xn, en, jy, je = whisper_inputs()
    x = torch.from_numpy(xn).requires_grad_(True)
    enc = torch.from_numpy(en).requires_grad_(True)
    positions = torch.from_numpy(POSITIONS)
    lp = leaves(lnp)
    y, _, _ = blocks.whisper_decoder_block(cfg, lp, x, enc, positions)
    attention_calls.clear()
    sp = split(lp, {**ATTN, **CROSS, "w1": 1, "w2": 0}, tp)
    got, k, _ = blocks.whisper_decoder_block(cfg, sp, x, enc, positions)
    assert k is None
    assert attention_calls == (segment_shapes(8, 8, tp, S)
                               + segment_shapes(8, 8, tp, cfg.enc_positions))
    close(got, y)
    names = sorted(lp)
    grads_match(got, y, [x, enc] + [sp[k] for k in names],
                [x, enc] + [lp[k] for k in names])
    np.testing.assert_allclose(got.detach().numpy(), jy, **REF)
    e_want = blocks.whisper_encoder_block(cfg, lp, x)
    e_got = blocks.whisper_encoder_block(cfg, sp, x)
    close(e_got, e_want)
    grads_match(e_got, e_want, [x] + [sp[k] for k in ATTN],
                [x] + [lp[k] for k in ATTN])
    np.testing.assert_allclose(e_got.detach().numpy(), je, **REF)


HYMBA_SPLIT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "ssm_in": 1,
               "w_gate": 1, "w_up": 1, "w_down": 0}


@functools.lru_cache(maxsize=None)
def hymba_inputs():
    jcfg, cfg = configs("hymba-1.5b", 25, 5)
    d, HD, N, ff = cfg.d_model, 25 * DH, cfg.ssm_state, cfg.d_ff
    lnp = layer_np(cfg, {"ssm_in": (d, HD), "ssm_dt": (d, 25),
                         "ssm_B": (d, 25 * N), "ssm_C": (d, 25 * N),
                         "attn_norm": (HD,), "ssm_norm": (HD,),
                         "ln2": (d,), "w_gate": (d, ff), "w_up": (d, ff),
                         "w_down": (ff, d)}, 10)
    lnp["A_log"] = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                                          (25, N))).copy()
    xn = x_of(11, d)
    jy = jrec.hymba_block(jcfg, _j(lnp), jnp.asarray(xn),
                          jnp.asarray(POSITIONS), window=1 << 30)[0]
    return cfg, lnp, xn, np.asarray(jy)


@pytest.mark.parametrize("tp", TPS)
def test_hymba_attention_splits_at_every_tp(tp, attention_calls):
    """hymba's 25/5 heads (a global layer: the flash path) fused with
    its split SSM: each shard's attention output normed over the whole
    H Dh width (``rms_norm_model`` over the head-aligned parts) and
    projected by its heads' rows of wo beside its SSM columns' own
    rows; the block and every gradient (attn_norm, A_log, the
    replicated dt/B/C included) match the unsplit block."""
    cfg, lnp, xn, jy = hymba_inputs()
    x = torch.from_numpy(xn).requires_grad_(True)
    positions = torch.from_numpy(POSITIONS)
    lp = leaves(lnp)
    want, _, _ = recurrent.hymba_block(cfg, lp, x, positions,
                                       window=1 << 30)
    attention_calls.clear()
    sp = split(lp, HYMBA_SPLIT, tp)
    got, k, v = recurrent.hymba_block(cfg, sp, x, positions, window=1 << 30)
    assert k is None and v is None
    assert attention_calls == segment_shapes(25, 5, tp, S)
    close(got, want)
    names = sorted(lp)
    grads_match(got, want, [x] + [sp[k] for k in names],
                [x] + [lp[k] for k in names])
    np.testing.assert_allclose(got.detach().numpy(), jy, **REF)


# --- where the heads divide: the layout before, bitwise ----------------------

def _even_split(cfg, p, x, positions, kw):
    """The split attention as it ran where the heads and KV heads
    divide tp: shard j's own blocks of wq/wk/wv/wo, one call a shard."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    row = p["wq"].row
    ys = []
    for j, hj in enumerate(PL.to_model(h, row)):
        pj = {n: p[n].parts[j] for n in ATTN}
        q, kj, vj = blocks._qkv(cfg, pj, hj, positions)
        ys.append(blocks._project_out(layers.flash_attention(q, kj, vj, **kw),
                                      pj["wo"]))
    y = PL.sum_model(ys, row)
    if "ln1_post" in p:
        y = layers.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    return x + y


@pytest.mark.parametrize("case,tp", [("granite 32/8", 2),
                                     ("granite 32/8", 8),
                                     ("qwen3-moe 64/4", 4),
                                     ("gemma2 16/8", 8)])
def test_where_heads_divide_the_split_is_the_layout_before(case, tp):
    """granite and qwen3-moe at their published heads, gemma2's 16/8
    with its softcap and window 8: outputs and gradients bit for bit."""
    if case.startswith("gemma2"):
        _, cfg = configs("gemma2-9b", 16, 8)
    else:
        _, cfg = configs(*HEADS[case])
    lnp = layer_np(cfg, {"ln1_post": (cfg.d_model,)}
                   if case.startswith("gemma2") else {}, 12)
    kw = dict(causal=True, window=cfg.sliding_window,
              logit_softcap=cfg.attn_softcap, q_offset=0)
    x = torch.from_numpy(x_of(13, cfg.d_model)).requires_grad_(True)
    positions = torch.from_numpy(POSITIONS)
    runs = []
    for fn in (lambda p: blocks.attention_block(
            cfg, p, x, positions, window=cfg.sliding_window).y,
               lambda p: _even_split(cfg, p, x, positions, kw)):
        sp = split(leaves(lnp), ATTN, tp)
        y = fn(sp)
        r = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
        flat = [x] + [t for k in sorted(sp) for t in
                      (sp[k].parts if k in ATTN else [sp[k]])]
        runs.append((y, torch.autograd.grad((y * r).sum(), flat)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


# --- the counts the chip run asserts -----------------------------------------

@pytest.mark.parametrize("tp", [1] + TPS)
def test_attention_calls_are_every_shards_segments(tp):
    """``sharding.attention_calls`` of every config with attention: the
    head rule's segment count (1 on one position)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.sharding import attention_calls
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.family == "ssm":
            continue
        want = 1 if tp == 1 else len(segment_shapes(
            cfg.n_heads, cfg.n_kv_heads, tp, S))
        assert attention_calls(cfg, tp) == want, arch


@pytest.mark.parametrize("arch,H,Hk,tp", [
    ("smollm-135m", 9, 3, 2), ("smollm-135m", 9, 3, 4),
    ("deepseek-coder-33b", 56, 8, 16), ("hymba-1.5b", 25, 5, 4)])
def test_one_process_step_counts_every_shards_heads(arch, H, Hk, tp):
    """The matmul FLOPs ``FlopCounterMode`` counts over one sharded step
    on a single-process (1, tp) CPU mesh (every shard of the row):
    ``step_matmul_flops``' ``local=tp`` count; at these uneven heads
    the positions' counts differ, and one needs its position."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   adamw_init, make_train_step)
    from repro_torch.train.sharded import step_matmul_flops
    _, cfg = configs(arch, H, Hk)
    mesh, _ = mesh_row(tp)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = PL.place_tree(TrainState(p, adamw_init(p)), TrainState(
        specs.param_shardings(cfg, mesh),
        specs.opt_state_shardings(cfg, mesh, zero1=True)))
    fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(), mesh=mesh)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    with FlopCounterMode(display=False) as fc:
        fn(state, batch)
    each = [step_matmul_flops(cfg, 2, S, tp, position=j) for j in range(tp)]
    assert fc.get_total_flops() == step_matmul_flops(cfg, 2, S, tp,
                                                     local=tp)
    assert len(set(each)) > 1
    with pytest.raises(ValueError, match="give the position"):
        step_matmul_flops(cfg, 2, S, tp)
