"""The model axis of the sharded train step computes its share: the
port's tensor-parallel layers against the unsplit ones, on the CPU.

* ``placement.to_model`` / ``sum_model`` (Megatron's conjugate pair) and
  ``split_model`` / ``cat_model`` against the unsplit ops, forward and
  gradient, in f64 (within 1e-12 relative: only the order of the sums
  moves) and bitwise where nothing is summed;
* each split layer against the same function on whole weights, in f32,
  on single-process (1, 2), (1, 4) and (2, 2) CPU meshes (the (2, 2)
  mesh's second data row): attention with and without gemma2's softcap
  and window, whisper's cross-attention, SwiGLU, the GELU MLP, the MoE
  split by expert and by each expert's ff, the vocab-parallel embedding,
  and the vocab-sharded unembedding with the vocab-parallel masked NLL
  (masked labels, z-loss, tied embeddings). Outputs and every gradient
  within ``RTOL``/``ATOL`` (of the largest value) of the unsplit
  ones; the embedding and the
  experts' outputs bitwise. The split layers run on each shard's heads
  (the attention calls are counted and their shapes checked), and a
  split whose weights are not all model-sharded raises;
* ``sharding.tp_layout`` / ``tp_split`` for every config of ``configs``
  at tp 2, 4, 8 and 16 against the head rule and ``param_spec``: no
  layer gathers its weights (the recurrent families' splits:
  ``tests/test_torch_recurrent_tp.py``; attention at the published head
  counts and every tp: ``tests/test_torch_attention_tp.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import placement as PL
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import blocks, layers
from repro_torch.models import model as M
from repro_torch.models.config import MoEConfig
from repro_torch.models.sharding import (MeshAxes, heads_split, param_spec,
                                         tp_layout, tp_split)
from repro_torch.train.step import _masked_nll, _masked_nll_model

#: split against unsplit in f32: the partial sums over the shards round
#: in another order than one matmul's. Each element within RTOL of its
#: value or ATOL of the unsplit tensor's largest |value| (a gradient
#: summed over many terms carries their rounding: f32's 6e-8 a term)
RTOL = 1e-5
ATOL = 1e-5
#: (mesh shape, the row's first position)
MESHES = {"1x2": ((1, 2), 0), "1x4": ((1, 4), 0), "2x2": ((2, 2), 2)}


def row_of(name: str):
    shape, pos = MESHES[name]
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))
    return mesh, pos


def shards(w: torch.Tensor, dim: int, mesh, pos: int) -> PL.ModelShards:
    """``w`` split along ``dim`` over the row's model shards, each a leaf
    that wants a gradient."""
    tp = mesh.shape["model"]
    parts = [p.detach().clone().requires_grad_(True)
             for p in w.chunk(tp, dim)]
    return PL.ModelShards(parts, dim, mesh, pos, torch.device("cpu"))


def rand(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, dtype=dtype) * scale
            ).requires_grad_(True)


def close(got, want, what=""):
    atol = ATOL * float(want.detach().abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=atol,
                               msg=lambda m: f"{what}: {m}")


def grads_match(out_split, out_whole, split_leaves, whole_leaves, seed=0):
    """The gradients of <out, r> for a random r: every split leaf's
    (a ``ModelShards``' parts against the slices of the whole leaf's
    gradient, a tensor against the tensor's) within RTOL/ATOL."""
    r = torch.randn(out_whole.shape, generator=torch.Generator()
                    .manual_seed(seed), dtype=out_whole.dtype)
    flat_s, flat_w = [], []
    for s, w in zip(split_leaves, whole_leaves):
        if isinstance(s, PL.ModelShards):
            flat_s.extend(s.parts)
            flat_w.extend([w] * len(s.parts))
        else:
            flat_s.append(s)
            flat_w.append(w)
    gs = torch.autograd.grad((out_split * r).sum(), flat_s)
    gw = dict(zip(map(id, whole_leaves), torch.autograd.grad(
        (out_whole * r).sum(), whole_leaves)))
    i = 0
    for s, w in zip(split_leaves, whole_leaves):
        if isinstance(s, PL.ModelShards):
            for g, want in zip(gs[i:i + len(s.parts)],
                               gw[id(w)].chunk(len(s.parts), s.dim)):
                close(g, want, f"shard of {tuple(w.shape)}")
            i += len(s.parts)
        else:
            close(gs[i], gw[id(w)], f"leaf {tuple(w.shape)}")
            i += 1


@pytest.fixture
def attention_calls(monkeypatch):
    """The (q, k) shapes of every ``layers.flash_attention`` call."""
    calls = []
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(layers, "flash_attention", spy)
    return calls


# --- the collectives ---------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_to_model_and_sum_model_are_the_unsplit_product(mesh_name):
    """(x W1) W2 with W1 split by columns and W2 by rows, through
    to_model and sum_model: the unsplit product and its gradients in f64
    (the partial products' sum only reorders)."""
    mesh, pos = row_of(mesh_name)
    gen = torch.Generator().manual_seed(1)
    x = rand(gen, 5, 7, 12, dtype=torch.float64)
    w1 = rand(gen, 12, 16, dtype=torch.float64)
    w2 = rand(gen, 16, 12, dtype=torch.float64)
    s1, s2 = shards(w1, 1, mesh, pos), shards(w2, 0, mesh, pos)
    row = s1.row
    xs = PL.to_model(x, row)
    assert len(xs) == mesh.shape["model"]
    y = PL.sum_model([a @ p1 @ p2 for a, p1, p2 in
                      zip(xs, s1.parts, s2.parts)], row)
    want = x @ w1 @ w2
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    r = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad((y * r).sum(), [x, *s1.parts, *s2.parts])
    full = torch.autograd.grad((want * r).sum(), [x, w1, w2])
    torch.testing.assert_close(got[0], full[0], rtol=1e-12, atol=1e-12)
    tp = mesh.shape["model"]
    for g, w in zip(got[1:1 + tp], full[1].chunk(tp, 1)):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    for g, w in zip(got[1 + tp:], full[2].chunk(tp, 0)):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_split_and_cat_model_are_bitwise(mesh_name):
    """split_model's blocks are the slices; cat_model of them is the
    whole; the gradient through both is the upstream one, bitwise; the
    max over model is the max."""
    mesh, pos = row_of(mesh_name)
    tp = mesh.shape["model"]
    row = PL.ModelRow(mesh, pos, torch.device("cpu"))
    gen = torch.Generator().manual_seed(2)
    x = rand(gen, 8, 3, 5, dtype=torch.float64)
    parts = PL.split_model(x, row, 0)
    for p, want in zip(parts, x.chunk(tp, 0)):
        assert torch.equal(p, want)
    y = PL.cat_model([p * 3.0 for p in parts], row, 0)
    assert torch.equal(y, x * 3.0)
    r = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    (g,) = torch.autograd.grad((y * r).sum(), [x])
    assert torch.equal(g, r * 3.0)
    m = PL.max_model([p.sum(0) for p in parts], row)
    assert torch.equal(m, torch.stack([p.sum(0) for p in parts]).amax(0))


def test_a_gathered_leaf_keeps_the_slice_gradient():
    """``full()`` (a layer that runs whole) is the whole leaf, and each
    shard's gradient its slice, bitwise."""
    mesh, pos = row_of("1x4")
    gen = torch.Generator().manual_seed(3)
    w = rand(gen, 6, 8)
    s = shards(w, 1, mesh, pos)
    full = s.full()
    assert torch.equal(full, w)
    r = torch.randn(w.shape, generator=gen)
    gs = torch.autograd.grad((full * r).sum(), s.parts)
    for g, want in zip(gs, r.chunk(4, 1)):
        assert torch.equal(g, want)


# --- the split layers --------------------------------------------------------

def f32(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def layer_params(cfg, seed: int):
    p = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    lp = {k: v[0].detach().clone() for k, v in p["blocks"].items()}
    for k in lp:             # norms are zeros at init: give them values
        if lp[k].dim() == 1:
            lp[k] = torch.randn(lp[k].shape, generator=torch.Generator()
                                .manual_seed(seed + 1)) * 0.1
    return {k: v.requires_grad_(True) for k, v in lp.items()}


#: attention weight -> the dim it splits along (columns, rows for wo)
ATTN = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
CROSS = {"wq_x": 1, "wk_x": 1, "wv_x": 1, "wo_x": 0}


def split_layer(lp, dims, mesh, pos):
    return {k: shards(v, dims[k], mesh, pos) if k in dims else v
            for k, v in lp.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b"])
def test_attention_splits_by_heads(arch, mesh_name, attention_calls):
    """granite (4/2 heads) and gemma2 (softcap 50, window 8, post-norm):
    each shard attends with its H / tp query heads; at 2 shards with its
    own KV head, at 4 with the one KV head two shards share (fetched
    from its owner); the residual and every gradient match the unsplit
    block."""
    cfg = f32(arch)
    mesh, pos = row_of(mesh_name)
    tp = mesh.shape["model"]
    lp = layer_params(cfg, 5)
    gen = torch.Generator().manual_seed(6)
    x = rand(gen, 2, 16, cfg.d_model)
    positions = torch.arange(16, dtype=torch.int32).expand(2, 16)
    window = cfg.sliding_window if cfg.sliding_window else None
    want = blocks.attention_block(cfg, lp, x, positions, window=window)
    attention_calls.clear()
    sp = split_layer(lp, ATTN, mesh, pos)
    got = blocks.attention_block(cfg, sp, x, positions, window=window)
    assert heads_split(cfg, tp)
    H, Hk = cfg.n_heads // tp, max(cfg.n_kv_heads // tp, 1)
    assert attention_calls == [((2, 16, H, 16), (2, 16, Hk, 16))] * tp
    assert got.k is None
    close(got.y, want.y)
    names = sorted(k for k in lp if k.startswith("ln1") or k in ATTN)
    grads_match(got.y, want.y, [x] + [sp[k] for k in names],
                [x] + [lp[k] for k in names])


@pytest.mark.parametrize("mesh_name", ["1x2", "1x4"])
def test_whisper_cross_attention_and_gelu_mlp_split(mesh_name,
                                                    attention_calls):
    """whisper (4/4 heads): the decoder's self- and cross-attention split
    by heads (the encoder memory handed to each shard), the GELU MLP by
    w1's columns and w2's rows; the block and its gradients (encoder
    memory included) match."""
    cfg = f32("whisper-base")
    mesh, pos = row_of(mesh_name)
    tp = mesh.shape["model"]
    lp = layer_params(cfg, 7)
    gen = torch.Generator().manual_seed(8)
    x = rand(gen, 2, 8, cfg.d_model)
    enc = rand(gen, 2, cfg.enc_positions, cfg.d_model)
    positions = torch.arange(8, dtype=torch.int32).expand(2, 8)
    y, _, _ = blocks.whisper_decoder_block(cfg, lp, x, enc, positions)
    attention_calls.clear()
    sp = split_layer(lp, {**ATTN, **CROSS, "w1": 1, "w2": 0}, mesh, pos)
    got, k, _ = blocks.whisper_decoder_block(cfg, sp, x, enc, positions)
    assert k is None
    assert attention_calls == (
        [((2, 8, 4 // tp, 16), (2, 8, 4 // tp, 16))] * tp
        + [((2, 8, 4 // tp, 16), (2, cfg.enc_positions, 4 // tp, 16))] * tp)
    close(got, y)
    names = sorted(lp)
    grads_match(got, y, [x, enc] + [sp[k] for k in names],
                [x, enc] + [lp[k] for k in names])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_swiglu_splits_by_ff(mesh_name):
    cfg = f32("granite-8b")
    mesh, pos = row_of(mesh_name)
    lp = layer_params(cfg, 9)
    gen = torch.Generator().manual_seed(10)
    x = rand(gen, 2, 16, cfg.d_model)
    names = ("w_gate", "w_up", "w_down")
    want = layers.swiglu(x, *(lp[n] for n in names))
    sp = split_layer(lp, {"w_gate": 1, "w_up": 1, "w_down": 0}, mesh, pos)
    got = layers.model_parallel(layers.swiglu, x, *(sp[n] for n in names))
    close(got, want)
    grads_match(got, want, [x] + [sp[n] for n in names],
                [x] + [lp[n] for n in names])
    with pytest.raises(ValueError, match="some weights"):
        layers.model_parallel(layers.swiglu, x, sp["w_gate"], lp["w_up"],
                              sp["w_down"])


def moe_weights(E: int, d: int, ff: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return {"router": rand(gen, d, E, scale=d ** -0.5),
            "w_gate": rand(gen, E, d, ff, scale=d ** -0.5),
            "w_up": rand(gen, E, d, ff, scale=d ** -0.5),
            "w_down": rand(gen, E, ff, d, scale=ff ** -0.5)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_splits_by_expert_bitwise(mesh_name):
    """E 8 top-2 at capacity 1.25 (assignments drop): each shard runs
    its E / tp experts on its rows of the dispatch buffer; the experts'
    outputs, concatenated, are the unsplit ones bit for bit, and so is
    the layer's output; the gradients match."""
    mesh, pos = row_of(mesh_name)
    w = moe_weights(8, 32, 24, 11)
    x = rand(torch.Generator().manual_seed(12), 2, 32, 32)
    buf = torch.randn((8, 10, 32), generator=torch.Generator()
                      .manual_seed(13))
    dims = {"w_gate": 0, "w_up": 0, "w_down": 0}
    sw = {k: shards(v, dims[k], mesh, pos) if k in dims else v
          for k, v in w.items()}
    assert torch.equal(
        layers._experts_split(buf, sw["w_gate"], sw["w_up"], sw["w_down"]),
        layers._experts(buf, w["w_gate"], w["w_up"], w["w_down"]))
    want = layers.moe_ffn(x, w, 8, 2, 1.25)
    got = layers.moe_ffn(x, sw, 8, 2, 1.25)
    assert torch.equal(got.y, want.y) and torch.equal(got.aux_loss,
                                                      want.aux_loss)
    names = sorted(w)
    grads_match(got.y, want.y, [x] + [sw[k] for k in names],
                [x] + [w[k] for k in names])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_splits_each_experts_ff_where_experts_do_not_divide(mesh_name):
    """E 6 at 4 shards (and the same ff split at 2): each expert's
    w_gate/w_up by columns and w_down by rows, summed over model."""
    mesh, pos = row_of(mesh_name)
    w = moe_weights(6, 32, 24, 14)
    x = rand(torch.Generator().manual_seed(15), 2, 32, 32)
    dims = {"w_gate": 2, "w_up": 2, "w_down": 1}
    sw = {k: shards(v, dims[k], mesh, pos) if k in dims else v
          for k, v in w.items()}
    want = layers.moe_ffn(x, w, 6, 2, 1.25)
    got = layers.moe_ffn(x, sw, 6, 2, 1.25)
    close(got.y, want.y)
    assert torch.equal(got.aux_loss, want.aux_loss)
    names = sorted(w)
    grads_match(got.y, want.y, [x] + [sw[k] for k in names],
                [x] + [w[k] for k in names])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b"])
def test_vocab_parallel_embedding_is_bitwise(arch, mesh_name):
    """Each shard looks up the tokens of its vocab rows (zeros
    elsewhere); the sum over model has one nonzero term a token: the
    whole lookup bit for bit (gemma's scale after the sum), and each
    shard's gradient its rows of the whole gradient."""
    cfg = f32(arch)
    mesh, pos = row_of(mesh_name)
    gen = torch.Generator().manual_seed(16)
    emb = rand(gen, cfg.vocab, cfg.d_model)
    tokens = torch.randint(0, cfg.vocab, (3, 40), generator=gen)
    want = M._embed_tokens(cfg, {"embed": emb}, tokens)
    s = shards(emb, 0, mesh, pos)
    got = M._embed_tokens(cfg, {"embed": s}, tokens)
    assert torch.equal(got, want)
    r = torch.randn(want.shape, generator=gen)
    gs = torch.autograd.grad((got * r).sum(), s.parts)
    (full,) = torch.autograd.grad((want * r).sum(), [emb])
    for g, w in zip(gs, full.chunk(len(gs), 0)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", ["granite", "gemma2 softcap", "tied"])
def test_vocab_parallel_unembed_and_nll(case, mesh_name):
    """Each shard's (B, S, V / tp) logits (gemma2's final softcap per
    element; tied embeddings through embed.T) and the vocab-parallel
    masked NLL (the max and the sum of exps over model, the label's
    logit from its shard, masked labels, z-loss 1e-4): the loss sum and
    the gradients of the hidden states and the unembedding match
    ``_unembed`` + ``_masked_nll``."""
    arch = "gemma2-9b" if case.startswith("gemma2") else "granite-8b"
    cfg = f32(arch, tie_embeddings=case == "tied")
    mesh, pos = row_of(mesh_name)
    gen = torch.Generator().manual_seed(17)
    h = rand(gen, 3, 10, cfg.d_model)
    name = "embed" if case == "tied" else "unembed"
    w = rand(gen, *((cfg.vocab, cfg.d_model) if case == "tied" else
                    (cfg.d_model, cfg.vocab)), scale=0.5)
    labels = torch.randint(0, cfg.vocab, (3, 10), generator=gen)
    labels[0, :7] = -1
    want_sum, want_n = _masked_nll(M._unembed(cfg, {name: w}, h), labels,
                                   1e-4)
    s = shards(w, 0 if case == "tied" else 1, mesh, pos)
    parts, row = M.unembed_shards(cfg, {name: s}, h)
    tp = mesh.shape["model"]
    assert [tuple(p.shape) for p in parts] == [(3, 10, cfg.vocab // tp)] * tp
    got_sum, got_n = _masked_nll_model(parts, labels, 1e-4, row)
    close(got_sum, want_sum)
    assert torch.equal(got_n, want_n)
    grads_match(got_sum, want_sum, [h, s], [h, w])
    with pytest.raises(TypeError, match="unembed_shards"):
        M._unembed(cfg, {name: s}, h)


def test_a_split_layer_without_every_weight_sharded_raises():
    """No quiet gather: attention whose heads split but whose wo is
    whole raises."""
    cfg = f32("granite-8b")
    mesh, pos = row_of("1x2")
    lp = layer_params(cfg, 18)
    sp = split_layer(lp, {"wq": 1, "wk": 1, "wv": 1}, mesh, pos)
    x = torch.randn(1, 4, cfg.d_model)
    positions = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="not every weight"):
        blocks.attention_block(cfg, sp, x, positions)


# --- which layers split ------------------------------------------------------

def expected_layout(cfg, tp: int) -> dict:
    """The head rule and ``param_spec``, written out."""
    vocab = "split" if cfg.vocab % tp == 0 else "whole"
    out = {"embed": vocab, "unembed": vocab}
    if cfg.family == "ssm":           # mLSTM by Dh, sLSTM by columns
        rec = (cfg.d_model // cfg.n_heads) % tp == 0 or cfg.d_model % tp == 0
        return {**out, "recurrent": "split" if rec else "whole"}
    attn = "split" if (cfg.n_heads * cfg.head_dim) % tp == 0 else "whole"
    out["attention"] = attn
    if cfg.enc_dec:
        out["cross_attention"] = attn
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        out["experts"] = ("expert" if E % tp == 0 else
                          "split" if cfg.d_ff % tp == 0 else "whole")
    else:
        out["mlp"] = "split" if cfg.d_ff % tp == 0 else "whole"
    if cfg.family == "hybrid":   # the SSM and fused projection: H Dh too
        out["recurrent"] = attn
    return out


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_which_layers_split(arch, tp):
    cfg = get_config(arch)
    layout = tp_layout(cfg, tp)
    assert layout == expected_layout(cfg, tp)
    got = tp_split(cfg, {"data": 1, "model": tp})
    ms = {"data": 1, "model": tp}
    sharded = [name for name, leaf in tree.flatten_with_path(
        M.init_params(cfg, None, "meta"))
        if "model" in param_spec(name, tuple(leaf.shape), MeshAxes(), ms)]
    assert sorted(got["split"]) == sorted(sharded)
    assert got["gathered"] == []
    assert layout.get("attention", "split") == "split"


@pytest.mark.parametrize("tp", [2, 4])
def test_the_named_examples(tp):
    smollm = tp_layout(get_config("smollm-135m"), tp)
    assert smollm["attention"] == "split" and smollm["mlp"] == "split"
    granite = tp_layout(get_config("granite-8b"), tp)
    assert granite["attention"] == "split" and granite["mlp"] == "split"
    hymba = get_config("hymba-1.5b")
    assert tp_layout(hymba, tp) == {
        "embed": "whole", "unembed": "whole", "attention": "split",
        "mlp": "split", "recurrent": "split"}
    assert tp_split(hymba, {"data": 1, "model": tp})["gathered"] == []
    for n in (tp, 8):
        xlstm = get_config("xlstm-1.3b")
        assert tp_layout(xlstm, n)["recurrent"] == "split"
        assert tp_split(xlstm, {"data": 1, "model": n})["gathered"] == []
    assert tp_layout(get_config("qwen3-moe-235b-a22b"), tp)["experts"] == \
        "expert"
    assert tp_layout(get_config("granite-8b"), 1) == {
        "embed": "whole", "unembed": "whole", "attention": "whole",
        "mlp": "whole"}
    assert tp_layout(dataclasses.replace(
        get_smoke_config("grok-1-314b"), moe=MoEConfig(3, 2)), tp)[
        "experts"] == "split"


def test_a_layer_over_several_devices_recomputes_behind_one_gate(
        monkeypatch):
    """Where a row's shards lie on several cards, ``models.model._run``
    sends a checkpointed layer's outputs through ``_FrameGate`` (one
    thread recomputes the layer). On the CPU, forced on: the step's
    loss and every gradient bitwise those without it."""
    from repro_torch.train import (AdamWConfig, TrainState,
                                   TrainStepConfig, make_train_step)
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.launch import specs as S
    cfg = f32("granite-8b")
    mesh, _ = row_of("1x2")
    gen = np.random.default_rng(19)
    toks = gen.integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    runs = []
    for forced in (False, True):
        monkeypatch.setattr(M, "_spans_devices", lambda args: forced)
        p = M.init_params(cfg, torch.Generator().manual_seed(20), "cpu")
        state = PL.place_tree(TrainState(p, adamw_init(p)), TrainState(
            S.param_shardings(cfg, mesh),
            S.opt_state_shardings(cfg, mesh, zero1=False)))
        fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(),
                             mesh=mesh)
        state, m = fn(state, batch)
        runs.append((PL.gather_tree(state), float(m["loss"])))
    assert runs[0][1] == runs[1][1]
    for a, b in zip(tree.leaves(runs[0][0]), tree.leaves(runs[1][0])):
        assert torch.equal(a, b)
