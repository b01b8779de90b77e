"""The port's recurrent families against ``repro``'s: the mLSTM, sLSTM and
SSM scans and decode steps of ``models.layers``, the blocks of
``models.recurrent``, and xLSTM and hymba as models (init layout, cache
layout and dtypes, the empty prefill caches, hymba's ring-buffered
sliding-window cache, the parameter round trip).

Inputs are seeded numpy arrays given to both packages. f32 results agree
within rtol = atol = 1e-5 for a step or a block, and for a scan within
rtol 1e-5 and an atol of 1e-5 of the output's largest magnitude: a
chunk sums up to L decayed terms in an order each framework picks, and
at one chunk of 64 the reference's ``ssm_scan`` is itself 4.4e-5 off an
f64 recursion on outputs up to 21 (the port 1.5e-5). In bf16 a scan
agrees within one bf16 ulp of the f32 result (rtol 2^-7, atol 1e-5),
and a block within the LM path's bf16 tolerance (rtol 5e-2, atol 1e-1).
Serving at the smoke configs is in ``tests/test_torch_lm.py``."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import serve as jserve
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from _torch_threads import one_thread  # noqa: F401
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import recurrent as trec

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_lm import _configs, _np, _serve_both, _weights  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_SCAN = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_BLOCK = dict(rtol=5e-2, atol=1e-1)


def _assert_scan_close(got, want, dtype):
    want = _np(want)
    tol = (dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
           if dtype == "float32" else BF16_SCAN)
    np.testing.assert_allclose(_np(got), want, **tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a jnp array and a torch tensor of ``dtype``
    (bf16 rounds once, on the JAX side, and crosses as exact f32)."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _pairs(arrays, dtype="float32"):
    js, ts = zip(*(_pair(a, dtype) for a in arrays))
    return list(js), list(ts)


def _mlstm_inputs(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    # log forget gates in (-inf, 0], log input gates softcapped, as the
    # block makes them
    log_f = np.array(jax.nn.log_sigmoid(jnp.asarray(
        _rand(rng, B, S, H) + 2.0)))
    log_i = np.array(jlayers.softcap(jnp.asarray(_rand(rng, B, S, H)),
                                     15.0))
    return [q, k, v, log_f, log_i]


def _ssm_inputs(seed, B, S, H, D, N):
    rng = np.random.default_rng(seed)
    A_log = np.broadcast_to(np.log(np.arange(1, N + 1, dtype=np.float32)),
                            (H, N)) + _rand(rng, H, N, scale=0.1)
    return [_rand(rng, B, S, H, D), _rand(rng, B, S, H),
            _rand(rng, B, S, H, N), _rand(rng, B, S, H, N),
            np.ascontiguousarray(A_log, dtype=np.float32)]


# (S, chunk): two or more full chunks, a ragged S through _pick_chunk (60
# -> 15, 50 -> 10), and one chunk of the default 256
SCAN_CASES = [(64, 16), (60, 16), (50, 16), (64, 256)]


# --- scans -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_mlstm_scan_matches_reference(S, chunk, dtype):
    arrs = _mlstm_inputs(S + chunk, 2, S, 3, 8)
    js, ts = _pairs(arrs[:3], dtype)
    gj, gt = _pairs(arrs[3:])
    want = jlayers.mlstm_scan(*js, *gj, chunk=chunk)
    got = tlayers.mlstm_scan(*ts, *gt, chunk=chunk)
    assert got.dtype == ts[0].dtype and tuple(got.shape) == (2, S, 3, 8)
    _assert_scan_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 37])
def test_slstm_scan_matches_reference(S, dtype):
    rng = np.random.default_rng(S)
    arrs = [_rand(rng, 2, S, 3, 8, scale=2.0) for _ in range(4)]
    js, ts = _pairs(arrs, dtype)
    want = jlayers.slstm_scan(*js)
    got = tlayers.slstm_scan(*ts)
    assert got.dtype == ts[0].dtype
    _assert_scan_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_ssm_scan_matches_reference(S, chunk, dtype):
    arrs = _ssm_inputs(S * chunk, 2, S, 3, 8, 4)
    js, ts = _pairs(arrs[:4], dtype)
    aj, at = _pair(arrs[4])
    want = jlayers.ssm_scan(*js, aj, chunk=chunk)
    got = tlayers.ssm_scan(*ts, at, chunk=chunk)
    assert got.dtype == ts[0].dtype and tuple(got.shape) == (2, S, 3, 8)
    _assert_scan_close(got, want, dtype)


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` and ``log_sigmoid`` at +-30 and beyond torch's
    default softplus threshold of 20."""
    x = np.array([-30.0, -20.5, -1.0, 0.0, 0.5, 20.5, 30.0], np.float32)
    for jf, tf in ((jax.nn.softplus, tlayers._softplus),
                   (jax.nn.log_sigmoid, tlayers._log_sigmoid)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))),
                                   rtol=1e-6, atol=0)


# --- steps -----------------------------------------------------------------

@pytest.mark.parametrize("c_dtype", ["float32", "bfloat16"])
def test_mlstm_step_matches_reference(c_dtype):
    rng = np.random.default_rng(1)
    B, H, D = 2, 3, 8
    arrs = _mlstm_inputs(2, B, 1, H, D)
    C, n = _rand(rng, B, H, D, D), _rand(rng, B, H, D)
    (Cj, Ct), (nj, nt) = _pair(C, c_dtype), _pair(n)
    js, ts = _pairs(arrs)
    (C2j, n2j), hj = jlayers.mlstm_step((Cj, nj), *js)
    (C2t, n2t), ht = tlayers.mlstm_step((Ct, nt), *ts)
    assert C2t.dtype == Ct.dtype and n2t.dtype == torch.float32
    np.testing.assert_allclose(_np(ht), _np(hj), **F32)
    np.testing.assert_allclose(_np(n2t), _np(n2j), **F32)
    np.testing.assert_allclose(_np(C2t), _np(C2j),
                               **(F32 if c_dtype == "float32" else BF16_SCAN))


def test_slstm_step_matches_reference():
    rng = np.random.default_rng(3)
    B, H, D = 2, 3, 8
    state = [_rand(rng, B, H, D), np.abs(_rand(rng, B, H, D)) + 0.5,
             _rand(rng, B, H, D)]
    zs = [_rand(rng, B, 1, H, D, scale=2.0) for _ in range(4)]
    (sj, st), (zj, zt) = _pairs(state), _pairs(zs)
    (cj, nj, mj), hj = jlayers.slstm_step(tuple(sj), *zj)
    (ct, nt, mt), ht = tlayers.slstm_step(tuple(st), *zt)
    for got, want in ((ct, cj), (nt, nj), (mt, mj), (ht, hj)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_ssm_step_matches_reference():
    rng = np.random.default_rng(5)
    arrs = _ssm_inputs(6, 2, 1, 3, 8, 4)
    h = _rand(rng, 2, 3, 4, 8)
    (hj, ht), (js, ts) = _pair(h), _pairs(arrs)
    h2j, yj = jlayers.ssm_step(hj, *js)
    h2t, yt = tlayers.ssm_step(ht, *ts)
    np.testing.assert_allclose(_np(h2t), _np(h2j), **F32)
    np.testing.assert_allclose(_np(yt), _np(yj), **F32)


# --- scan against steps ----------------------------------------------------

def test_mlstm_steps_equal_the_chunked_scan():
    """S calls of ``mlstm_step`` from the zero state (C in f32) give the
    chunked scan's outputs."""
    S = 40
    q, k, v, lf, li = (torch.from_numpy(a)
                       for a in _mlstm_inputs(7, 2, S, 3, 8))
    want = tlayers.mlstm_scan(q, k, v, lf, li, chunk=16)
    state = (torch.zeros(2, 3, 8, 8), torch.zeros(2, 3, 8))
    for t in range(S):
        sl = slice(t, t + 1)
        state, h = tlayers.mlstm_step(state, q[:, sl], k[:, sl], v[:, sl],
                                      lf[:, sl], li[:, sl])
        np.testing.assert_allclose(h[:, 0].numpy(), want[:, t].numpy(),
                                   **F32)


def test_slstm_steps_equal_the_scan():
    S = 33
    rng = np.random.default_rng(8)
    zs = [torch.from_numpy(_rand(rng, 2, S, 3, 8, scale=2.0))
          for _ in range(4)]
    want = tlayers.slstm_scan(*zs)
    state = (torch.zeros(2, 3, 8), torch.zeros(2, 3, 8),
             torch.full((2, 3, 8), -1e30))
    for t in range(S):
        state, h = tlayers.slstm_step(state, *(z[:, t:t + 1] for z in zs))
        np.testing.assert_allclose(h[:, 0].numpy(), want[:, t].numpy(),
                                   **F32)


def test_ssm_steps_equal_the_chunked_scan():
    S = 48
    x, dl, Bm, Cm, A_log = (torch.from_numpy(a)
                            for a in _ssm_inputs(9, 2, S, 3, 8, 4))
    want = tlayers.ssm_scan(x, dl, Bm, Cm, A_log, chunk=16)
    h = torch.zeros(2, 3, 4, 8)
    for t in range(S):
        sl = slice(t, t + 1)
        h, y = tlayers.ssm_step(h, x[:, sl], dl[:, sl], Bm[:, sl],
                                Cm[:, sl], A_log)
        np.testing.assert_allclose(y[:, 0].numpy(), want[:, t].numpy(),
                                   **F32)


# --- blocks ----------------------------------------------------------------

def _layer_pair(jp, tp, group, index):
    """One layer's parameters of both packages' stacked group."""
    take = lambda a: a[index]  # noqa: E731
    return (jax.tree.map(take, jp[group]),
            {k: v[index] for k, v in tp[group].items()})


def _block_tol(dtype):
    return F32 if dtype == "float32" else BF16_BLOCK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_blocks_match_reference(dtype):
    jcfg, tcfg = _configs("xlstm-1.3b", dtype=dtype)
    jp, tp, _ = _weights(jcfg, tcfg)
    rng = np.random.default_rng(11)
    xj, xt = _pair(_rand(rng, 2, 12, jcfg.d_model), dtype)
    mj, mt = _layer_pair(jp, tp, "mlstm", (0, 0))
    sj, st = _layer_pair(jp, tp, "slstm", 1)
    tol = _block_tol(dtype)
    np.testing.assert_allclose(_np(trec.mlstm_block(tcfg, mt, xt)),
                               _np(jrec.mlstm_block(jcfg, mj, xj)), **tol)
    np.testing.assert_allclose(_np(trec.slstm_block(tcfg, st, xt)),
                               _np(jrec.slstm_block(jcfg, sj, xj)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_block_steps_match_reference(dtype):
    jcfg, tcfg = _configs("xlstm-1.3b", dtype=dtype)
    jp, tp, _ = _weights(jcfg, tcfg)
    rng = np.random.default_rng(12)
    H, D = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    xj, xt = _pair(_rand(rng, 2, 1, jcfg.d_model), dtype)
    (Cj, Ct), (nj, nt) = (_pair(_rand(rng, 2, H, D, D, scale=0.1),
                                "bfloat16"),
                          _pair(np.abs(_rand(rng, 2, H, D))))
    mj, mt = _layer_pair(jp, tp, "mlstm", (1, 0))
    yj, (C2j, n2j) = jrec.mlstm_block_step(jcfg, mj, xj, (Cj, nj))
    yt, (C2t, n2t) = trec.mlstm_block_step(tcfg, mt, xt, (Ct, nt))
    tol = _block_tol(dtype)
    np.testing.assert_allclose(_np(yt), _np(yj), **tol)
    np.testing.assert_allclose(_np(n2t), _np(n2j), **tol)
    np.testing.assert_allclose(_np(C2t), _np(C2j), **BF16_SCAN)
    state = [_rand(rng, 2, H, D), np.abs(_rand(rng, 2, H, D)) + 0.5,
             _rand(rng, 2, H, D)]
    sj_, st_ = _pairs(state)
    sj, st = _layer_pair(jp, tp, "slstm", 0)
    yj, statej = jrec.slstm_block_step(jcfg, sj, xj, tuple(sj_))
    yt, statet = trec.slstm_block_step(tcfg, st, xt, tuple(st_))
    np.testing.assert_allclose(_np(yt), _np(yj), **tol)
    for got, want in zip(statet, statej):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_mlstm_heads_follow_the_dh_major_layout():
    """Distinct weights for every head: the reshape-to-matmul of the
    port gives the reference's ``einsum("bsd,dvh->bshv")`` and its
    down-projection ``einsum("bshv,vhd->bsd")``, not a transposed
    layout."""
    rng = np.random.default_rng(13)
    d, Dh, H = 12, 5, 3
    h, w3, y, wd = (_rand(rng, 2, 4, d), _rand(rng, d, Dh, H),
                    _rand(rng, 2, 4, H, Dh), _rand(rng, Dh, H, d))
    got = trec._heads(torch.from_numpy(h), torch.from_numpy(w3))
    np.testing.assert_allclose(
        got.numpy(), np.einsum("bsd,dvh->bshv", h, w3), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        trec._down3(torch.from_numpy(y), torch.from_numpy(wd)).numpy(),
        np.einsum("bshv,vhd->bsd", y, wd), rtol=1e-6, atol=1e-6)
    # swapping the (Dh, H) axes of the weight must change the result
    swapped = np.ascontiguousarray(w3.reshape(d, H, Dh).transpose(0, 2, 1))
    assert not np.allclose(trec._heads(torch.from_numpy(h),
                                       torch.from_numpy(swapped)).numpy(),
                           got.numpy())


def _hymba4(dtype="float32"):
    """hymba's smoke config at 4 layers: layers 0, 2 and 3 global, layer
    1 sliding with window 8."""
    return _configs("hymba-1.5b", n_layers=4, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1 << 30, 8, 24])
def test_hymba_block_matches_reference(window, dtype):
    """A global layer (the flash kernel's plain version), a window that
    masks (the chunked oracle) and one that covers the prompt."""
    jcfg, tcfg = _hymba4(dtype)
    jp, tp, _ = _weights(jcfg, tcfg)
    rng = np.random.default_rng(14)
    S = 24
    xj, xt = _pair(_rand(rng, 2, S, jcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    lj, lt = _layer_pair(jp, tp, "blocks", 1)
    yj, kj, vj = jrec.hymba_block(jcfg, lj, xj, jnp.asarray(pos),
                                  window=window)
    yt, kt, vt = trec.hymba_block(tcfg, lt, xt, torch.from_numpy(pos.copy()),
                                  window=window)
    tol = _block_tol(dtype)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("t", [3, 8, 13])
def test_hymba_block_step_matches_reference(t):
    """One decode step into an 8-slot ring: before it fills (t 3), at its
    first wrap (t 8) and past it (t 13)."""
    jcfg, tcfg = _hymba4()
    jp, tp, _ = _weights(jcfg, tcfg)
    rng = np.random.default_rng(15 + t)
    Hk, Dh, H, N = (jcfg.n_kv_heads, jcfg.head_dim, jcfg.n_heads,
                    jcfg.ssm_state)
    (xj, xt), (kj, kt), (vj, vt), (sj, st) = (_pair(a) for a in (
        _rand(rng, 2, 1, jcfg.d_model), _rand(rng, 2, 8, Hk, Dh),
        _rand(rng, 2, 8, Hk, Dh), _rand(rng, 2, H, N, Dh)))
    lj, lt = _layer_pair(jp, tp, "blocks", 1)
    want = jrec.hymba_block_step(jcfg, lj, xj, kj, vj, sj, jnp.int32(t),
                                 window=8)
    got = trec.hymba_block_step(tcfg, lt, xt, kt, vt, st, t)
    assert got[1] is kt and got[2] is vt        # written in place
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


# --- models ----------------------------------------------------------------

def test_hymba_sliding_window_and_ring_wrap_serving_matches_reference():
    """hymba at 4 layers (one sliding layer, window 8): 24-token prompts
    run past the window in the prefill, and 12 decode steps after the
    prefill and greedy generation from position 0 wrap the 8-slot ring
    several times."""
    jcfg, tcfg = _hymba4()
    assert list(tmodels.window_schedule(tcfg)) == [1 << 30, 8, 1 << 30,
                                                   1 << 30]
    jp, tp, toks, picks = _serve_both(jcfg, tcfg, B=2, S=24, steps=12,
                                      rtol=1e-4, atol=1e-4)
    for jn, tn in picks:
        np.testing.assert_array_equal(tn, jn)
    want = jserve.greedy_generate(jcfg, jp, jnp.asarray(toks[:, :10]), 9)
    got = tserve.greedy_generate(tcfg, tp, torch.from_numpy(toks[:, :10]), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hymba_bf16_ring_serving_matches_reference():
    jcfg, tcfg = _hymba4("bfloat16")
    _serve_both(jcfg, tcfg, B=2, S=24, steps=10, rtol=5e-2, atol=1e-1)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_prefill_caches_stay_empty_as_in_the_reference(arch):
    """The reference's ``make_prefill`` writes nothing into the recurrent
    families' caches (xLSTM: its forward threads no state out; hymba:
    its cache has no stacked "k"), so both return ``init_decode_cache``'s
    zeros (and xLSTM's m at -1e30) beside the last logits."""
    jcfg, tcfg = _configs(arch, dtype="float32")
    jp, tp, _ = _weights(jcfg, tcfg)
    toks = np.random.default_rng(16).integers(0, jcfg.vocab, (2, 12)) \
        .astype(np.int32)
    jcache, _ = jserve.make_prefill(jcfg, 16)(jp, {"tokens": jnp.asarray(toks)})
    tcache, last = tserve.make_prefill(tcfg, 16)(
        tp, {"tokens": torch.from_numpy(toks)})
    empty = tmodels.init_decode_cache(tcfg, 2, 16, device="cpu")
    jleaves = jax.tree.leaves(jcache)
    for got, init, want in zip(jax.tree.leaves(tcache),
                               jax.tree.leaves(empty), jleaves):
        assert torch.equal(got, init)
        np.testing.assert_array_equal(_np(got), _np(want))
    assert len(jleaves) == len(jax.tree.leaves(tcache))
    full = tmodels.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(last, full.logits[:, -1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_decode_cache_has_the_reference_layout(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype=dtype)
    if arch.startswith("hymba"):
        jcfg, tcfg = _hymba4(dtype)
    want = jax.eval_shape(lambda: jmodels.init_decode_cache(jcfg, 2, 12))
    got = tmodels.init_decode_cache(tcfg, 2, 12, device="cpu")
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for t, j in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    if arch.startswith("xlstm"):
        assert got["mlstm_C"].dtype == torch.bfloat16
        assert bool((got["slstm_m"] == -1e30).all())
    else:
        # a ring of min(window, max_len) slots on the sliding layer
        assert [c["k"].shape[1] for c in got["layers"]] == [12, 8, 12, 12]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_init_params_has_the_reference_layout(arch):
    jcfg, tcfg = _configs(arch)
    want = jax.eval_shape(lambda: jmodels.init_params(
        jcfg, jax.random.PRNGKey(0)))
    got = tmodels.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1]), got) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
    if arch.startswith("xlstm"):
        G, per = 2, 2
        assert got["mlstm"]["wq3"].shape == (G, per - 1, tcfg.d_model,
                                             tcfg.d_model // tcfg.n_heads,
                                             tcfg.n_heads)
        assert got["slstm"]["w_zi"].shape[0] == G
        wq = got["mlstm"]["wq3"].float()
        assert not got["mlstm"]["ln1"].any()
    else:
        A_log = got["blocks"]["A_log"]
        assert A_log.dtype == torch.float32          # under a bf16 config
        np.testing.assert_allclose(
            A_log.numpy(), np.broadcast_to(np.log(np.arange(
                1, tcfg.ssm_state + 1, dtype=np.float32)), A_log.shape),
            rtol=1e-7, atol=0)
        wq = got["blocks"]["wq"].float()
        assert not got["blocks"]["attn_norm"].any()
    assert abs(wq.std().item() * tcfg.d_model ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_params_round_trip_recurrent(arch, dtype):
    """The ``mlstm``/``slstm`` groups and ``A_log`` cross both ways
    unchanged; ``A_log`` stays f32 under a bf16 config (no rounding)."""
    jcfg, tcfg = _configs(arch, dtype=dtype)
    _, tp, tree = _weights(jcfg, tcfg)
    back = params_to_numpy(tp)
    flat_a, tdef_a = jax.tree.flatten(back)
    flat_b, tdef_b = jax.tree.flatten(tree)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if arch.startswith("hymba"):
        assert tp["blocks"]["A_log"].dtype == torch.float32
        assert tp["blocks"]["wq"].dtype == getattr(torch, dtype)
        moved = dict(tree, blocks=dict(tree["blocks"]))
        moved["blocks"]["A_log"] = tree["blocks"]["A_log"] + np.float32(1e-3)
        np.testing.assert_array_equal(
            params_from_numpy(moved, tcfg, "cpu")["blocks"]["A_log"].numpy(),
            moved["blocks"]["A_log"])
    else:
        assert tp["mlstm"]["wq3"].dtype == getattr(torch, dtype)


def test_xlstm_groups_refuse_a_ragged_depth():
    _, tcfg = _configs("xlstm-1.3b", n_layers=5)
    with pytest.raises(ValueError, match="slstm_every"):
        tmodels.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")


def test_full_xlstm_schedule_has_the_reference_groups():
    """xlstm-1.3b's 48 layers are 6 groups of 7 mLSTM blocks and one
    sLSTM block."""
    from repro.models import model as jmodel
    from repro_torch.models import model as tmodel
    jcfg, tcfg = _configs("xlstm-1.3b", real=True)
    assert tmodel._xlstm_groups(tcfg) == jmodel._xlstm_groups(jcfg) == (6, 8)
