"""The port's LM serving path against ``repro``'s: ``make_prefill`` (the
full forward, whose attention is the flash kernel's plain version on the
CPU) and ``make_serve_step`` decode steps, on the same weights, for every
transformer family: dense, gemma2 (local/global windows, post-norms,
softcaps), MoE (qwen3-moe, grok-1), llava (image embeddings before the
tokens) and whisper (the encoder memory in the cache).

Weights come from ``repro.models.init_params(cfg, PRNGKey(0))``, cast to
f32 numpy and carried across with ``convert.params_from_numpy``. In f32
the logits and the KV cache agree within rtol = atol = 1e-4 and the
greedy tokens are equal; in bf16 within rtol 5e-2, atol 1e-1 (the
reference's own decode-vs-forward tolerance, ``tests/test_serve_data.py``):
the port's attention follows the Pallas kernel, which keeps p in f32
where the reference's oracle rounds it to bf16, and the two frameworks
round bf16 matmuls at other places."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import serve as jserve
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve_lm

DENSE = ("smollm-135m", "granite-8b", "deepseek-coder-33b")
FAMILIES = ("qwen3-moe-235b-a22b", "grok-1-314b", "gemma2-9b",
            "llava-next-34b", "whisper-base")
UNSERVED = ("xlstm-1.3b", "hymba-1.5b")


def _configs(arch: str, real: bool = False, **kw):
    get_j = jconfigs.get_config if real else jconfigs.get_smoke_config
    get_t = tconfigs.get_config if real else tconfigs.get_smoke_config
    return (dataclasses.replace(get_j(arch), **kw),
            dataclasses.replace(get_t(arch), **kw))


def _weights(jcfg, tcfg):
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return jp, params_from_numpy(tree, tcfg, "cpu"), tree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _extra_inputs(cfg, B: int, seed: int = 0) -> dict:
    """llava's image embeddings (B, Ni, d) and whisper's frame embeddings
    (B, Te, d), normal(0, 1) f32 from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.n_img_tokens:
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return out


def _batches(cfg, toks):
    extra = _extra_inputs(cfg, toks.shape[0], seed=1)
    jb = {"tokens": jnp.asarray(toks),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(toks),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


def _serve_both(jcfg, tcfg, B: int, S: int, steps: int, rtol: float,
                atol: float):
    """Prefill then ``steps`` decode steps on both packages, feeding both
    the reference's greedy tokens; every logit, the KV cache (llava's
    image positions included) and whisper's encoder memory compared.
    Returns the two packages' greedy tokens of each step."""
    jp, tp, _ = _weights(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)) \
        .astype(np.int32)
    S0 = S + jcfg.n_img_tokens          # cached positions after prefill
    max_len = S0 + steps
    jb, tb = _batches(jcfg, toks)
    jcache, jlast = jserve.make_prefill(jcfg, max_len)(jp, jb)
    tcache, tlast = tserve.make_prefill(tcfg, max_len)(tp, tb)
    assert tuple(tlast.shape) == (B, 1, jcfg.vocab)
    assert tlast.dtype == torch.float32
    np.testing.assert_allclose(_np(tlast), _np(jlast), rtol=rtol, atol=atol)
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        assert tuple(tcache[name].shape) == tuple(jcache[name].shape)
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=rtol, atol=atol)
    jstep = jax.jit(jserve.make_serve_step(jcfg))
    tstep = tserve.make_serve_step(tcfg)
    cur = np.asarray(jnp.argmax(jlast[:, -1], -1)).astype(np.int32)[:, None]
    picks = []
    for i in range(steps):
        jn, jl, jcache = jstep(jp, jcache, jnp.asarray(cur),
                               jnp.int32(S0 + i))
        tn, tl, tcache = tstep(tp, tcache, torch.from_numpy(cur), S0 + i)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=rtol, atol=atol)
        picks.append((np.asarray(jn), tn.numpy()))
        cur = np.asarray(jn).astype(np.int32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=rtol, atol=atol)
    return jp, tp, toks, picks


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_smoke_f32_serving_matches_reference(arch):
    jcfg, tcfg = _configs(arch, dtype="float32")
    jp, tp, toks, picks = _serve_both(jcfg, tcfg, B=2, S=16, steps=8,
                                      rtol=1e-4, atol=1e-4)
    for jn, tn in picks:
        np.testing.assert_array_equal(tn, jn)
    want = jserve.greedy_generate(jcfg, jp, jnp.asarray(toks[:, :8]), 6)
    got = tserve.greedy_generate(tcfg, tp, torch.from_numpy(toks[:, :8]), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smoke_bf16_serving_matches_reference():
    jcfg, tcfg = _configs("smollm-135m")
    assert tcfg.dtype == "bfloat16"
    _serve_both(jcfg, tcfg, B=2, S=16, steps=8, rtol=5e-2, atol=1e-1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_bf16_serving_families_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    assert tcfg.dtype == "bfloat16"
    _serve_both(jcfg, tcfg, B=2, S=16, steps=6, rtol=5e-2, atol=1e-1)


def test_moe_many_experts_f32_serving_matches_reference():
    """qwen3-moe's 128 experts, top-8, at narrowed width (one layer of
    d_model 64, 4/2 heads of 16, expert d_ff 32): 2 x 40 prompt tokens
    give the prefill a capacity of 40 a expert, each decode step 8."""
    kw = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
              d_ff=32, vocab=512, dtype="float32")
    jcfg, tcfg = _configs("qwen3-moe-235b-a22b", real=True, **kw)
    assert (tcfg.moe.n_experts, tcfg.moe.top_k) == (128, 8)
    _, _, _, picks = _serve_both(jcfg, tcfg, B=2, S=40, steps=3,
                                 rtol=1e-4, atol=1e-4)
    for jn, tn in picks:
        np.testing.assert_array_equal(tn, jn)


def test_gemma2_prompts_past_the_window_match_reference():
    """gemma2's smoke window is 8: a 24-token prompt and 6 steps make
    every local layer mask, in the prefill (the chunked oracle) and in
    the windowed decode."""
    jcfg, tcfg = _configs("gemma2-9b", dtype="float32")
    assert tcfg.sliding_window == 8
    assert list(tmodels.window_schedule(tcfg)) == [8, 1 << 30]
    _, _, _, picks = _serve_both(jcfg, tcfg, B=2, S=24, steps=6,
                                 rtol=1e-4, atol=1e-4)
    for jn, tn in picks:
        np.testing.assert_array_equal(tn, jn)


def test_moe_prefill_is_repeatable():
    """Two prefills of the MoE model give bitwise-equal logits and caches
    (the combine un-sorts, it does not scatter-add)."""
    _, tcfg = _configs("qwen3-moe-235b-a22b")
    params = tmodels.init_params(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (2, 16)).astype(np.int32))
    prefill = tserve.make_prefill(tcfg, 20)
    (c1, l1), (c2, l2) = (prefill(params, {"tokens": toks})
                          for _ in range(2))
    assert torch.equal(l1, l2)
    assert torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])


def test_real_widths_f32_serving_matches_reference():
    """smollm-135m's published widths (d_model 576, 9/3 heads of 64,
    d_ff 1536, vocab 49152) at 2 layers."""
    jcfg, tcfg = _configs("smollm-135m", real=True, n_layers=2,
                          dtype="float32")
    _, _, _, picks = _serve_both(jcfg, tcfg, B=2, S=128, steps=2,
                                 rtol=1e-4, atol=1e-4)
    for jn, tn in picks:
        np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-coder-33b"])
def test_head_width_128_f32_serving_matches_reference(arch):
    """granite-8b and deepseek-coder-33b run the same path with d_head
    128 and their own rope theta; narrowed to one layer of 4/2 heads."""
    kw = dict(n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
              vocab=1024, dtype="float32")
    jcfg, tcfg = _configs(arch, real=True, **kw)
    assert tcfg.head_dim == 128
    _, _, _, picks = _serve_both(jcfg, tcfg, B=2, S=40, steps=3,
                                 rtol=1e-4, atol=1e-4)
    for jn, tn in picks:
        np.testing.assert_array_equal(tn, jn)


def test_forward_logits_modes_match_reference():
    jcfg, tcfg = _configs("smollm-135m", dtype="float32")
    jp, tp, _ = _weights(jcfg, tcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12)) \
        .astype(np.int32)
    for mode in ("all", "last", "hidden"):
        want = jmodels.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               logits_mode=mode).logits
        got = tmodels.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                              logits_mode=mode).logits
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_modes_families_match_reference(arch):
    """'all', 'last' and 'hidden' with each family's inputs, and the MoE
    aux loss beside them."""
    jcfg, tcfg = _configs(arch, dtype="float32")
    jp, tp, _ = _weights(jcfg, tcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12)) \
        .astype(np.int32)
    jb, tb = _batches(jcfg, toks)
    for mode in ("all", "last", "hidden"):
        want = jmodels.forward(jcfg, jp, jb, logits_mode=mode)
        got = tmodels.forward(tcfg, tp, tb, logits_mode=mode)
        assert got.cache is None
        np.testing.assert_allclose(_np(got.logits), _np(want.logits),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(got.aux_loss),
                                   float(want.aux_loss), rtol=1e-5,
                                   atol=1e-6)
    if jcfg.moe is not None:
        assert float(got.aux_loss) > 0


@pytest.mark.parametrize("arch", ["gemma2-9b", "llava-next-34b"])
def test_embed_inputs_match_reference_bitwise(arch):
    """bf16 embeddings as the reference makes them: gemma's sqrt(d_model)
    rounded to bf16 before the multiply (sqrt(3584) is 59.75 there),
    llava's image embeddings before the tokens."""
    from repro.models import model as jmodel
    from repro_torch.models import model as tmodel
    jcfg, tcfg = _configs(arch, real=True, n_layers=1, d_ff=64, vocab=512)
    jp, tp, _ = _weights(jcfg, tcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 7)) \
        .astype(np.int32)
    jb, tb = _batches(jcfg, toks)
    want = jmodel._embed_inputs(jcfg, jp, jb)
    got = tmodel._embed_inputs(tcfg, tp, tb)
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, 7 + jcfg.n_img_tokens, jcfg.d_model)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    jcfg, tcfg = _configs("smollm-135m", dtype=dtype)
    _, tp, tree = _weights(jcfg, tcfg)
    assert tp["blocks"]["wq"].dtype == getattr(torch, dtype)
    back = params_to_numpy(tp)
    flat_a, tdef_a = jax.tree.flatten(back)
    flat_b, tdef_b = jax.tree.flatten(tree)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["whisper-base", "qwen3-moe-235b-a22b"])
def test_params_round_trip_families(arch):
    """whisper's ``enc_blocks``, ``enc_norm`` and ``enc_pos`` and the MoE
    router and expert stacks cross both ways unchanged."""
    jcfg, tcfg = _configs(arch)
    _, tp, tree = _weights(jcfg, tcfg)
    back = params_to_numpy(tp)
    flat_a, tdef_a = jax.tree.flatten(back)
    flat_b, tdef_b = jax.tree.flatten(tree)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    if tcfg.enc_dec:
        assert tp["enc_blocks"]["wq"].shape[0] == tcfg.n_enc_layers
        assert "wq_x" in tp["blocks"] and "wq_x" not in tp["enc_blocks"]
    else:
        assert tp["blocks"]["moe_w_gate"].dtype == torch.bfloat16


def test_params_from_numpy_refuses_other_dtypes():
    _, tcfg = _configs("smollm-135m")
    with pytest.raises(TypeError):
        params_from_numpy({"embed": np.zeros((2, 2), np.float64)}, tcfg,
                          "cpu")


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_init_params_has_the_reference_layout(arch):
    jcfg, tcfg = _configs(arch)
    want = jax.eval_shape(lambda: jmodels.init_params(
        jcfg, jax.random.PRNGKey(0)))
    got = tmodels.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(got))
    assert not got["final_norm"].any() and not got["blocks"]["ln1"].any()
    # matrices are normal * fan_in ** -0.5, embeddings normal * 0.02
    wq = got["blocks"]["wq"].float()
    assert abs(wq.std().item() * tcfg.d_model ** 0.5 - 1) < 0.1
    assert abs(got["embed"].float().std().item() / 0.02 - 1) < 0.1


def test_init_params_is_seeded():
    _, tcfg = _configs("smollm-135m")
    a = tmodels.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = tmodels.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a["blocks"]["w_up"], b["blocks"]["w_up"])


@pytest.mark.parametrize("arch", UNSERVED)
def test_unserved_configs_raise_not_implemented(arch):
    _, tcfg = _configs(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tmodels.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError):
        tmodels.init_decode_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        tmodels.forward(tcfg, {}, {"tokens": torch.zeros((1, 4),
                                                         dtype=torch.int32)})


def test_check_served_raises_only_for_the_recurrent_families():
    for arch in jconfigs.ARCH_IDS:
        for cfg in (tconfigs.get_config(arch),
                    tconfigs.get_smoke_config(arch)):
            if cfg.family in ("ssm", "hybrid"):
                with pytest.raises(NotImplementedError):
                    tmodels.model.check_served(cfg)
            else:
                tmodels.model.check_served(cfg)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    for real in (True, False):
        jcfg, tcfg = _configs(arch, real=real)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.head_dim == jcfg.head_dim
        assert tcfg.n_params() == jcfg.n_params()
        np.testing.assert_array_equal(tmodels.window_schedule(tcfg),
                                      jmodels.window_schedule(jcfg))
    assert [dataclasses.asdict(s) for s in tmodels.SHAPES] == \
        [dataclasses.asdict(s) for s in jmodels.SHAPES]


def test_decode_updates_the_cache_in_place():
    _, tcfg = _configs("smollm-135m", dtype="float32")
    params = tmodels.init_params(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    cache = tmodels.init_decode_cache(tcfg, 2, 6, device="cpu")
    k_before = cache["k"]
    logits, out = tmodels.decode_step(tcfg, params, cache,
                                      torch.ones((2, 1), dtype=torch.int32),
                                      3)
    assert out is cache and out["k"] is k_before
    assert tuple(logits.shape) == (2, 1, tcfg.vocab)
    assert cache["k"][:, :, 3].abs().sum() > 0
    assert not cache["k"][:, :, [0, 1, 2, 4, 5]].any()


@pytest.mark.parametrize("factory", ["make_prefill", "make_serve_step"])
def test_serving_factories_set_full_precision_matmuls(monkeypatch, factory):
    mm = torch.backends.cuda.matmul
    for flags, name in ((mm, "allow_tf32"), (torch.backends.cudnn,
                                             "allow_tf32"),
                        (mm, "allow_bf16_reduced_precision_reduction")):
        monkeypatch.setattr(flags, name, True)
    _, tcfg = _configs("smollm-135m")
    getattr(tserve, factory)(tcfg, **({"max_len": 8}
                                      if factory == "make_prefill" else {}))
    assert not mm.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert not mm.allow_bf16_reduced_precision_reduction


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmodels.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmodels.init_decode_cache(tcfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve_lm.main(["--smoke", "--batch", "1", "--prompt-len", "2",
                       "--new-tokens", "1"])


def test_serve_lm_launcher_runs_on_cpu(capsys):
    args = ["--arch", "smollm-135m", "--smoke", "--batch", "2",
            "--prompt-len", "5", "--new-tokens", "4"]
    gen = serve_lm.main(args, device="cpu")
    assert tuple(gen.shape) == (2, 4) and gen.dtype == torch.int32
    assert torch.equal(gen, serve_lm.main(args, device="cpu"))
    assert "arch=smollm-smoke device=cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_lm_launcher_runs_the_families_on_cpu(capsys, arch):
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "3",
            "--new-tokens", "3"]
    gen = serve_lm.main(args, device="cpu")
    assert tuple(gen.shape) == (2, 3) and gen.dtype == torch.int32
    name = tconfigs.get_smoke_config(arch).name
    assert f"arch={name} device=cpu" in capsys.readouterr().out
