"""The port's training path against ``repro``'s, on the CPU.

* ``data.tokens``: ``synthetic_tokens`` and ``TokenPipeline`` (synthetic,
  a memmap ``.bin`` corpus, ``dp_rank``/``dp_size`` shards), bitwise;
* ``train.optimizer``: ``cosine_schedule``, ``global_norm`` and
  ``adamw_update`` on trees of f32 and bf16 leaves; the in-place update
  bitwise the functional one;
* ``cross_entropy`` and ``chunked_cross_entropy`` (masked labels,
  z-loss);
* ``make_loss_fn``'s value and every gradient leaf against
  ``jax.value_and_grad`` of the reference's, for each family's smoke
  config (dense, gemma2, MoE, llava, whisper, xLSTM, hymba);
* three ``make_train_step`` steps against the reference's (remat off and
  on, 1 and 2 microbatches); remat bitwise equal to no remat, with two
  flash calls a layer a step against one;
* ``distributed.compression``: ``quantize_tree`` codes and steps and
  ``compressed_psum_tree`` (against the reference under
  ``jax.vmap(axis_name="pod")``) bitwise, and the ``grad_compress`` train
  step with two pods against the reference run on two emulated JAX
  devices in a child process;
* the launcher (``launch.train.main``): its loss improves, and a resume
  from a checkpoint repeats the uninterrupted run's later steps.

Weights are the reference's ``init_params(cfg, PRNGKey(0))`` in f32
(``dataclasses.replace(cfg, dtype="float32")``), carried across with
``convert.params_from_numpy``. Tolerances: the loss within 1e-5
relative; each gradient leaf within 1e-4 x its largest |g| (measured:
1.2e-5 at most, xLSTM's gates); parameters after three AdamW steps
within 1e-4 absolute, a tenth of the peak learning rate a step can move
them (measured: 3e-5); moments after three steps within 1e-3 x their
largest value (measured: 2.7e-4; the later steps' gradients are taken
at parameters that already differ). The two frameworks sum in other
orders, so nothing of the gradients is bitwise.

The reference's recurrent scans mask the intra-chunk decay after its
``exp``, and the exponent above the diagonal overflows once the
cumulative decay passes ~88: the reference's gradients turn to NaN (a
hymba smoke sequence of 32 tokens does it). The port masks the exponent
first (the same forward values) and stays finite
(``test_scan_gradients_stay_finite_where_the_reference_overflows``); the
families are compared at 16 tokens, where the reference is finite."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import train as jtrain
from repro.data import tokens as jtokens
from repro.distributed import compression as jcomp
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import train as ttrain
from repro_torch import tree
from repro_torch.convert import (params_from_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import tokens as ttokens
from repro_torch.distributed import compression as tcomp
from repro_torch.kernels import flash as tflash
from repro_torch.launch import train as tlaunch
from repro_torch.models import window_schedule
from repro_torch.train import step as tstep
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parent.parent

FAMILIES = ("smollm-135m", "gemma2-9b", "qwen3-moe-235b-a22b",
            "llava-next-34b", "whisper-base", "xlstm-1.3b", "hymba-1.5b")

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4      # of the leaf's largest |g|
PARAM_ATOL = 1e-4     # lr_peak 1e-3: a tenth of the most a step moves
MOMENT_RTOL = 1e-3    # of the largest m or v, after three steps
OPT = dict(lr_peak=1e-3, warmup_steps=1, decay_steps=10)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _key(path) -> str:
    """The reference checkpoint manager's ``_tensor_key``."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _pairs(jtree, ttree):
    """(key, reference leaf, port leaf) of two trees of one structure,
    keyed by the reference's paths."""
    tl = dict(tree.flatten_with_path(ttree))
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(jl) == len(tl)
    return [(_key(p), j, tl[_key(p)]) for p, j in jl]


def _assert_tree_close(jtree, ttree, *, rel=None, atol=None):
    for key, j, t in _pairs(jtree, ttree):
        a, b = _np(j), _np(t)
        assert a.shape == b.shape, key
        bound = (rel * np.abs(a).max() if rel is not None else 0.0) + \
            (atol or 0.0)
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= bound, (key, err, bound)


def _configs(arch: str, **kw):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype="float32", **kw),
            dataclasses.replace(tconfigs.get_smoke_config(arch),
                                dtype="float32", **kw))


def _weights(jcfg, tcfg):
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _batch(cfg, B: int, S: int, seed: int = 0, masked: int = 3):
    """Seeded tokens and next-token labels (the first ``masked`` labels
    of row 0 set to -1), llava's image and whisper's frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :masked] = -1
    b = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.n_img_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# --- tokens -----------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,step,seed", [
    (256, 4, 64, 0, 0), (49152, 2, 33, 7, 3), (1000, 3, 1, 2 ** 31, 5)])
def test_synthetic_tokens_are_the_references(vocab, batch, seq, step, seed):
    want = jtokens.synthetic_tokens(vocab, batch, seq, step, seed)
    got = ttokens.synthetic_tokens(vocab, batch, seq, step, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("corpus", [False, True])
@pytest.mark.parametrize("dp_rank,dp_size", [(0, 1), (1, 2), (3, 4)])
def test_token_pipeline_is_the_references(tmp_path, corpus, dp_rank,
                                          dp_size):
    path = None
    if corpus:
        path = tmp_path / "corpus.bin"
        np.random.default_rng(0).integers(0, 70000, 5000).astype(
            np.int32).tofile(path)
    kw = dict(vocab_size=300, batch=8, seq_len=24, dp_rank=dp_rank,
              dp_size=dp_size, seed=2,
              bin_path=None if path is None else str(path))
    jp, tp = jtokens.TokenPipeline(**kw), ttokens.TokenPipeline(**kw)
    for step in (0, 1, 9, 40):
        want, got = jp.get_batch(step), tp.get_batch(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    it_j, it_t = iter(jp), iter(tp)
    for _ in range(2):
        a, b = next(it_j), next(it_t)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError):
        ttokens.TokenPipeline(vocab_size=10, batch=3, seq_len=4, dp_size=2)


# --- optimizer --------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    for cfg in (dict(), dict(warmup_steps=5, decay_steps=12),
                dict(warmup_steps=0, decay_steps=1, lr_min_ratio=0.0)):
        jc, tc = jtrain.AdamWConfig(**cfg), ttrain.AdamWConfig(**cfg)
        for s in (0, 1, 4, 5, 6, 11, 12, 50, 10_000, 20_000):
            want = float(jtrain.cosine_schedule(jc, jnp.int32(s)))
            got = float(ttrain.cosine_schedule(
                tc, torch.tensor(s, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def _grad_trees(seed: int, dtype):
    """A nested tree of f32 or bf16 leaves (1-, 2- and 3-D), numpy f32
    values exactly representable in ``dtype``, with the same structure
    in both packages."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (12, 8), "final_norm": (8,),
              "blocks": {"wq": (2, 8, 8), "ln1": (2, 8), "w_up": (2, 8, 16)}}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        a = rng.standard_normal(node).astype(np.float32)
        if dtype == "bfloat16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return a
    return make(shapes)


def _to_both(np_tree, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), np_tree),
            tree.tree_map(lambda a: torch.from_numpy(a).to(tdt), np_tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_reference(dtype):
    j, t = _to_both(_grad_trees(1, dtype), dtype)
    np.testing.assert_allclose(float(topt.global_norm(t)),
                               float(jtrain.global_norm(j)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    jp, tp = _to_both(_grad_trees(2, dtype), dtype)
    jg, tg = _to_both(_grad_trees(3, dtype), dtype)
    cfg = dict(lr_peak=1e-2, warmup_steps=2, decay_steps=6)
    jc, tc = jtrain.AdamWConfig(**cfg), ttrain.AdamWConfig(**cfg)
    js, ts = jtrain.adamw_init(jp), ttrain.adamw_init(tp)
    for i in range(4):
        jg_i = jax.tree.map(lambda g: g * (i + 1), jg)
        tg_i = tree.tree_map(lambda g: g * (i + 1), tg)
        jp, js, jm = jtrain.adamw_update(jc, js, jp, jg_i)
        tp_new, ts_new, tm = ttrain.adamw_update(tc, ts, tp, tg_i)
        # the in-place form gives the same bits and writes in place
        tp_in = tree.tree_map(torch.clone, tp)
        ts_in = ttrain.AdamWState(ts.step.clone(),
                                  tree.tree_map(torch.clone, ts.m),
                                  tree.tree_map(torch.clone, ts.v))
        tp_out, ts_out, _ = ttrain.adamw_update(tc, ts_in, tp_in, tg_i,
                                                inplace=True)
        for a, b in zip(tree.leaves(tp_new), tree.leaves(tp_out)):
            assert torch.equal(a, b)
        for a, b in zip(tree.leaves(ts_new.v), tree.leaves(ts_in.v)):
            assert torch.equal(a, b)
        assert all(a is b for a, b in zip(tree.leaves(tp_out),
                                          tree.leaves(tp_in)))
        tp, ts = tp_new, ts_new
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        for j, t in zip(jax.tree.leaves(jp), tree.leaves(tp)):
            assert str(t.dtype).endswith(dtype)
        # bf16 params round once a step: one bf16 ulp apart at most
        _assert_tree_close(jp, tp, rel=2.0 ** -7 if dtype == "bfloat16"
                           else 1e-6)
        _assert_tree_close(js.m, ts.m, rel=1e-5)
        _assert_tree_close(js.v, ts.v, rel=1e-5)


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropies_match_reference(z_loss):
    rng = np.random.default_rng(4)
    B, S, d, V = 2, 16, 8, 40
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    unembed = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    logits = hidden @ unembed
    want, wn = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    z_loss)
    got, gn = ttrain.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(gn) == float(wn) == B * S - 5
    for softcap, chunk in ((None, 4), (3.0, 5)):
        want, wn = jstep.chunked_cross_entropy(
            jnp.asarray(hidden), jnp.asarray(unembed), jnp.asarray(labels),
            softcap=softcap, z_loss=z_loss, chunk=chunk)
        got, gn = tstep.chunked_cross_entropy(
            torch.from_numpy(hidden), torch.from_numpy(unembed),
            torch.from_numpy(labels), softcap=softcap, z_loss=z_loss,
            chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        assert float(gn) == float(wn)
    # every label masked: the mean divides by 1, not 0
    none = torch.full((B, S), -1, dtype=torch.int32)
    loss, n = ttrain.cross_entropy(torch.from_numpy(logits), none, z_loss)
    assert float(loss) == 0.0 and float(n) == 1.0


# --- loss and gradients, every family ---------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _weights(jcfg, tcfg)
    jb, tb = _batch(jcfg, B=2, S=16)
    step = jtrain.TrainStepConfig()
    (jl, jaux), jg = jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, step), has_aux=True)(jp, jb)
    (tl, taux), tg = tstep.value_and_grad(
        ttrain.make_loss_fn(tcfg, ttrain.TrainStepConfig()), tp, tb)
    assert all(np.isfinite(_np(g)).all() for g in jax.tree.leaves(jg))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    for key, j, t in _pairs(jg, tg):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, key
        a, b = _np(j), _np(t)
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(a).max(), key
    # the port's params were left as they were
    assert not any(p.requires_grad for p in tree.leaves(tp))


def test_scan_gradients_stay_finite_where_the_reference_overflows():
    """hymba at 32 tokens: the reference's masked-after-exp SSM weights
    overflow above the diagonal and its gradient is NaN; the port masks
    the exponent first, so its gradient is finite, and its loss is the
    reference's."""
    jcfg, tcfg = _configs("hymba-1.5b")
    jp, tp = _weights(jcfg, tcfg)
    jb, tb = _batch(jcfg, B=2, S=32)
    step = jtrain.TrainStepConfig()
    (jl, _), jg = jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, step), has_aux=True)(jp, jb)
    (tl, _), tg = tstep.value_and_grad(
        ttrain.make_loss_fn(tcfg, ttrain.TrainStepConfig()), tp, tb)
    assert not np.isfinite(_np(jg["embed"])).all()
    assert all(torch.isfinite(g).all() for g in tree.leaves(tg))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)


# --- train steps ------------------------------------------------------------

def _run_steps(jcfg, tcfg, step_kw: dict, n: int = 3, B: int = 4,
               S: int = 16):
    jp, _ = _weights(jcfg, tcfg)
    jstate = jtrain.TrainState(jp, jtrain.adamw_init(jp))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                    "cpu")
    jfn = jax.jit(jtrain.make_train_step(
        jcfg, jtrain.TrainStepConfig(**step_kw), jtrain.AdamWConfig(**OPT)))
    tfn = ttrain.make_train_step(tcfg, ttrain.TrainStepConfig(**step_kw),
                                 ttrain.AdamWConfig(**OPT))
    metrics = []
    for i in range(n):
        jb, tb = _batch(jcfg, B, S, seed=10 + i, masked=0)
        jstate, jm = jfn(jstate, jb)
        tstate, tm = tfn(tstate, tb)
        metrics.append((jm, tm))
    return jstate, tstate, metrics


@pytest.mark.parametrize("remat,n_mb", [(False, 1), (True, 1), (False, 2),
                                        (True, 2)])
def test_train_steps_match_reference(remat, n_mb):
    jcfg, tcfg = _configs("smollm-135m")
    jstate, tstate, metrics = _run_steps(
        jcfg, tcfg, dict(remat=remat, n_microbatches=n_mb))
    for jm, tm in metrics:
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-7)
    assert int(tstate.opt.step) == 3
    _assert_tree_close(jstate.params, tstate.params, atol=PARAM_ATOL)
    _assert_tree_close(jstate.opt.m, tstate.opt.m, rel=MOMENT_RTOL)
    _assert_tree_close(jstate.opt.v, tstate.opt.v, rel=MOMENT_RTOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-base",
                                  "xlstm-1.3b", "hymba-1.5b"])
def test_remat_is_bitwise_and_recomputes_each_layer(arch, monkeypatch):
    """remat recomputes every layer in the backward: the same gradients
    bit for bit, and each plain attention reaches the flash wrapper twice
    a step (the forward and the recompute) against once."""
    _, tcfg = _configs(arch)
    _, tp = _weights(*_configs(arch))
    _, tb = _batch(tcfg, B=2, S=16)
    calls = []
    wrapper = tflash.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return wrapper(*a, **kw)
    monkeypatch.setattr(tflash, "flash_attention", counted)
    grads = {}
    for remat in (False, True):
        calls.clear()
        step = ttrain.TrainStepConfig(remat=remat)
        _, grads[remat] = tstep.value_and_grad(
            ttrain.make_loss_fn(tcfg, step), tp, tb)
        grads[remat, "calls"] = len(calls)
    for a, b in zip(tree.leaves(grads[False]), tree.leaves(grads[True])):
        assert torch.equal(a, b)
    per_step = {"smollm-135m": tcfg.n_layers,
                "whisper-base": tcfg.n_enc_layers + 2 * tcfg.n_layers,
                "xlstm-1.3b": 0, "hymba-1.5b": int(
                    (window_schedule(tcfg) >= 16).sum())}[arch]
    assert grads[False, "calls"] == per_step
    assert grads[True, "calls"] == 2 * per_step


# --- gradient compression ---------------------------------------------------

def _grads_np(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 64)).astype(np.float32),
            "b": (rng.standard_normal((128,)) * 1e-3).astype(np.float32),
            "c": {"d": rng.standard_normal((3, 5, 7)).astype(np.float32),
                  "z": np.zeros((4,), np.float32)}}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tree_is_the_references(bits, dtype):
    j, t = _to_both(_grads_np(5), dtype)
    jc_, js_ = jcomp.quantize_tree(j, rel_bound=1e-3, bits=bits)
    tc_, ts_ = tcomp.quantize_tree(t, rel_bound=1e-3, bits=bits)
    for key, a, b in _pairs(jc_, tc_):
        assert b.dtype == (torch.int8 if bits == 8 else torch.int16)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=key)
    for key, a, b in _pairs(js_, ts_):
        assert b.dtype == torch.float32
        assert np.float32(b.numpy()) == np.float32(a), key
    jd = jcomp.dequantize_tree(jc_, js_, j)
    td = tcomp.dequantize_tree(tc_, ts_, t)
    for key, a, b in _pairs(jd, td):
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=key)


@pytest.mark.parametrize("bits,n_pods", [(16, 2), (8, 2), (16, 4)])
def test_compressed_psum_tree_is_the_references(bits, n_pods):
    pods = [_grads_np(20 + i) for i in range(n_pods)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *pods)
    want = jax.vmap(lambda g: jcomp.compressed_psum_tree(
        g, "pod", 1e-3, bits, n_shards=n_pods), axis_name="pod")(stacked)
    got = tcomp.compressed_psum_tree(
        [tree.tree_map(torch.from_numpy, p) for p in pods], 1e-3, bits)
    for key, a, b in _pairs(want, got):
        a = np.asarray(a)
        for i in range(n_pods):
            np.testing.assert_array_equal(b.numpy(), a[i], err_msg=key)
    sync = tcomp.make_grad_sync(1e-3, bits, n_pods=n_pods)(
        [tree.tree_map(torch.from_numpy, p) for p in pods])
    exact = jax.tree.map(lambda *xs: sum(xs) / n_pods, *pods)
    for key, a, b in _pairs(exact, sync):
        amax = max(np.abs(dict(tree.flatten_with_path(p))[key]).max()
                   for p in pods)
        qmax = (2 ** (bits - 1) - 1) / n_pods
        step = max(amax * 2e-3, amax / qmax)
        assert np.abs(_np(b) - np.asarray(a)).max() <= step / 2 * 1.001


_POD_CHILD = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs, models, train
from repro.models.sharding import use_mesh
cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"),
                          dtype="float32")
p = models.init_params(cfg, jax.random.PRNGKey(0))
state = train.TrainState(p, train.adamw_init(p))
step = jax.jit(train.make_train_step(
    cfg, train.TrainStepConfig(remat=False, grad_compress=True, n_pods=2),
    train.AdamWConfig(lr_peak=1e-3, warmup_steps=1, decay_steps=10)))
out = {}
with use_mesh(jax.make_mesh((2,), ("pod",))):
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(
            0, cfg.vocab, (4, 17)).astype(np.int32)
        state, m = step(state, {"tokens": jnp.asarray(toks[:, :-1]),
                                "labels": jnp.asarray(toks[:, 1:])})
        out.update({f"m{i}/{k}": np.asarray(v) for k, v in m.items()})
for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
    out["p/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
print(len(jax.devices()), "OK")
"""


def test_grad_compress_step_matches_reference_on_two_pods(tmp_path):
    """Two pods: the reference's ``shard_map`` over two emulated devices
    (a child process), the port's pods in one process. Loss and metrics
    within 1e-5; params after 3 steps within 1e-4 (codes that round the
    other way move a gradient by one step, 2e-3 of its largest value)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=2").strip()
    out = tmp_path / "ref.npz"
    proc = subprocess.run([sys.executable, "-c", _POD_CHILD, str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-2:] == ["2", "OK"]
    ref = np.load(out)
    jcfg, tcfg = _configs("smollm-135m")
    jp, _ = _weights(jcfg, tcfg)
    state = train_state_from_numpy(jax.tree.map(
        np.asarray, jtrain.TrainState(jp, jtrain.adamw_init(jp))), tcfg,
        "cpu")
    fn = ttrain.make_train_step(
        tcfg, ttrain.TrainStepConfig(remat=False, grad_compress=True,
                                     n_pods=2), ttrain.AdamWConfig(**OPT))
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(
            0, tcfg.vocab, (4, 17)).astype(np.int32)
        state, m = fn(state, {"tokens": torch.from_numpy(toks[:, :-1]),
                              "labels": torch.from_numpy(toks[:, 1:])})
        for k, v in m.items():
            np.testing.assert_allclose(float(v), float(ref[f"m{i}/{k}"]),
                                       rtol=LOSS_RTOL, atol=1e-7)
    for key, t in tree.flatten_with_path(state.params):
        np.testing.assert_allclose(t.numpy(), ref[f"p/{key}"], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


def test_grad_compress_with_one_pod_changes_nothing():
    """As in the reference, ``grad_compress`` with one pod is the plain
    step."""
    _, tcfg = _configs("smollm-135m")
    _, tp = _weights(*_configs("smollm-135m"))
    _, tb = _batch(tcfg, B=2, S=8)
    outs = []
    for compress in (False, True):
        fn = tstep.make_grad_fn(tcfg, ttrain.TrainStepConfig(
            remat=False, grad_compress=compress, n_pods=1))
        outs.append(fn(tp, tb)[0])
    for a, b in zip(tree.leaves(outs[0]), tree.leaves(outs[1])):
        assert torch.equal(a, b)


def test_train_state_crosses_both_ways():
    jcfg, tcfg = _configs("qwen3-moe-235b-a22b")
    jp, _ = _weights(jcfg, tcfg)
    jstate = jtrain.TrainState(jp, jtrain.adamw_init(jp))
    t = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    assert t.opt.step.dtype == torch.int32 and t.opt.step.ndim == 0
    assert all(m.dtype == torch.float32 for m in tree.leaves(t.opt.m))
    back = train_state_to_numpy(t)
    for key, a, b in _pairs(jstate, back):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=key)
        assert b.dtype == np.asarray(a).dtype


# --- the launcher -----------------------------------------------------------

def test_launcher_improves_and_resumes(tmp_path, capsys):
    argv = ["--arch", "smollm-135m", "--smoke", "--steps", "12", "--batch",
            "4", "--seq", "32", "--lr", "1e-2", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "6", "--device", "cpu",
            "--log-every", "4"]
    run = tlaunch.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith('{"final_loss"') and '"improved": true' in out[-1]
    assert len(run.losses) == 12 and run.losses[-1] < run.losses[0]
    assert [s for s, _, _ in run.saves] == [6, 12]
    assert all(n > 0 for _, _, n in run.saves)
    # resume from step 6: the later steps repeat (the CPU sums in one
    # order, so bitwise)
    import shutil
    shutil.rmtree(tmp_path / "ck" / "step_0000000012")
    again = tlaunch.main(argv + ["--resume"])
    assert again.start_step == 6 and again.restore_seconds is not None
    assert again.losses == run.losses[6:]
    for a, b in zip(tree.leaves(again.state), tree.leaves(run.state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-base",
                                  "hymba-1.5b"])
def test_launcher_trains_every_input_kind(arch, capsys):
    run = tlaunch.main(["--arch", arch, "--smoke", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--device", "cpu",
                        "--grad-compress", "--microbatches", "2"])
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert int(run.state.opt.step) == 2


def test_a_meshs_pod_axis_places_the_pods():
    """``mesh=`` with a ``pod`` axis puts pod i on that axis's i-th
    device (here both on the CPU): the same gradients as without a mesh;
    a pod axis of another size than ``n_pods`` raises."""
    from repro_torch.launch.mesh import DeviceMesh
    _, tcfg = _configs("smollm-135m")
    _, tp = _weights(*_configs("smollm-135m"))
    _, tb = _batch(tcfg, B=4, S=8)
    step = ttrain.TrainStepConfig(remat=False, grad_compress=True, n_pods=2)
    pods = np.empty(2, dtype=object)
    pods[:] = [torch.device("cpu")] * 2
    want, _ = tstep.make_grad_fn(tcfg, step)(tp, tb)
    got, _ = tstep.make_grad_fn(tcfg, step,
                                DeviceMesh(pods, ("pod",)))(tp, tb)
    for a, b in zip(tree.leaves(want), tree.leaves(got)):
        assert torch.equal(a, b)
    three = np.empty(3, dtype=object)
    three[:] = [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="pod axis"):
        tstep.make_grad_fn(tcfg, step, DeviceMesh(three, ("pod",)))(tp, tb)
