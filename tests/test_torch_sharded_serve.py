"""Serving at the reference's dry-run partition on the CPU
(``serve.sharded``): params by ``param_shardings``, the KV cache by
``cache_shardings`` (split over positions on ``model`` at these sizes,
over Dh, Hk or the layers where ``_auto_spec`` picks those), every
position computing its share.

* the sharded prefill and 8 greedy decode steps on (1, 2), (2, 2) and
  (1, 4) CPU meshes against the one-device ``make_prefill`` +
  ``make_serve_step``, for the dense smoke config (3/1 heads: a KV head
  two shards share; a 10-token prompt in 64 positions, so some shards'
  positions stay wholly masked), gemma2 (a window of 8 that masks whole
  shards, softcaps), MoE with the dense dispatch, MoE under
  ``MOE_EP_MODE`` above 4,096 tokens (EP engages in the prefill; the
  one-device run is ``moe_ffn_ep`` on whole weights over the same
  mesh) and llava (its image prefix cached): the greedy tokens equal,
  f32 logits within ``RTOL``/``ATOL`` (the sums' order differs);
  caches split over Dh, Hk and the layers the same way;
* against the reference's own programs: smollm's smoke config in f32 on
  (2, 2), a child with four emulated JAX devices and Auto axes jits the
  reference's prefill and ``make_serve_step`` with
  ``build_prefill_lowered``'s and ``build_serve_lowered``'s
  ``in_shardings`` (the cache donated), on its own weights;
* each position's resident cache bytes are
  ``specs.shard_bytes(cache, cache_shardings)``, below the whole cache;
* four gloo ranks on (2, 2) are bitwise the one-process mesh: a dense
  prefill and decode, the EP prefill of the MoE smoke config, and the
  train step's shared batch under EP (a batch of 33 over 2 rows: every
  row holds it and routes its share of the tokens);
* the vocab-sharded argmax takes the lowest index where shards tie;
* every config of ``configs`` builds the sharded prefill and serve step
  on (1, 2) and serves two steps (whisper, xLSTM and hymba at length in
  ``test_torch_sharded_serve_families.py``).

Torch runs on one thread here and in the ranks (restored after)."""
import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params, layers
from repro_torch.models.config import MoEConfig
from repro_torch.serve import make_prefill, make_serve_step
from repro_torch.serve import sharded as SS

ROOT = Path(__file__).resolve().parent.parent
AX2 = ("data", "model")
WORLD = 4
#: f32 logits of the split against the one-device step: the same
#: function, its sums in another order (seen: 6e-6 at most)
RTOL, ATOL = 2e-5, 2e-5
STEPS = 8

#: (arch, config overrides, batch, prompt, cache positions, EP)
CASES = {
    "dense": ("smollm-135m", {}, 4, 10, 64, False),
    "gemma2": ("gemma2-9b", {}, 4, 40, 64, False),
    "moe": ("qwen3-moe-235b-a22b", {}, 4, 20, 64, False),
    # 32 x 130 = 4,160 prompt tokens: EP engages in the prefill
    "moe-ep": ("qwen3-moe-235b-a22b", dict(moe=MoEConfig(8, 2, 4.0)), 32,
               130, 140, True),
    "llava": ("llava-next-34b", {}, 4, 20, 64, False),
    # caches _auto_spec splits over Dh (16 positions), Hk (16 KV heads
    # of 8) and the layers (16 of them)
    "dh": ("granite-8b", {}, 4, 6, 16, False),
    "hk": ("granite-8b", dict(n_heads=16, n_kv_heads=16, d_head=8), 4, 3,
           12, False),
    "layers": ("gemma2-9b", dict(n_layers=16, d_head=8), 4, 3, 12, False),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
SPLIT = {"dense": "T", "gemma2": "T", "moe": "T", "moe-ep": "T",
         "llava": "T", "dh": "Dh", "hk": "Hk", "layers": "L"}


def case_cfg(case: str):
    arch, kw = CASES[case][:2]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def case_batch(case: str, seed: int = 0) -> dict:
    cfg = case_cfg(case)
    B, Sp = CASES[case][2:4]
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, Sp)).astype(np.int32)}
    if cfg.n_img_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def cpu_mesh(shape):
    return make_mesh(shape, AX2, devices=["cpu"] * int(np.prod(shape)))


@contextlib.contextmanager
def ep_mode(on: bool, mesh=None):
    old = layers.MOE_EP_MODE
    layers.MOE_EP_MODE = on
    try:
        with (mesh if on and mesh is not None else contextlib.nullcontext()):
            yield
    finally:
        layers.MOE_EP_MODE = old


def positions(cfg, batch) -> int:
    return batch["tokens"].shape[1] + (cfg.n_img_tokens
                                       if "image_embeds" in batch else 0)


def one_device(cfg, params, batch, max_len: int):
    """The one-device prefill and ``STEPS`` greedy steps: (tokens, each
    step's logits, the prefill's last logits)."""
    t0 = positions(cfg, batch)
    with torch.no_grad():
        cache, lg = make_prefill(cfg, max_len)(params, batch)
        tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        toks, logits = [tok], []
        step = make_serve_step(cfg)
        for i in range(STEPS):
            tok, lgi, cache = step(params, cache, tok, t0 + i)
            toks.append(tok)
            logits.append(lgi)
    return torch.cat(toks, 1), logits, lg


def sharded(cfg, mesh, params, batch, max_len: int):
    """The same on ``mesh``: (tokens, each step's whole logits, the
    prefill's, the placed cache)."""
    t0 = positions(cfg, batch)
    pp = PL.place_tree(params, SS.prefill_param_shardings(cfg, mesh))
    sp = PL.place_tree(params, SS.serve_param_shardings(cfg, mesh))
    cache, lg = SS.make_sharded_prefill(cfg, mesh, max_len)(pp, batch)
    tok = SS.sharded_argmax(cfg, lg)
    toks, logits = [PL.gather(tok)], []
    step = SS.make_sharded_serve_step(cfg, mesh, whole_logits=True)
    for i in range(STEPS):
        tok, lgi, cache = step(sp, cache, tok, t0 + i)
        toks.append(PL.gather(tok))
        logits.append(lgi)
    return torch.cat(toks, 1), logits, PL.gather(lg), cache


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c not in ("dh", "hk", "layers")])
def test_split_meshes_serve_the_one_device_tokens(case, mesh_name):
    cfg = case_cfg(case)
    mesh = cpu_mesh(MESHES[mesh_name])
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = case_batch(case)
    max_len, ep = CASES[case][4:6]
    with ep_mode(ep, mesh):
        want_t, want_l, want_p = one_device(cfg, params, batch, max_len)
    seen = []
    body = layers._moe_ep_body
    layers._moe_ep_body = lambda *a, **k: seen.append(1) or body(*a, **k)
    try:
        with ep_mode(ep):
            got_t, got_l, got_p, cache = sharded(cfg, mesh, params, batch,
                                                 max_len)
    finally:
        layers._moe_ep_body = body
    assert bool(seen) == ep
    assert SS._cache_views(cache, mesh)[0][0].kind == SPLIT[case]
    assert torch.equal(got_t, want_t)
    torch.testing.assert_close(got_p, want_p, rtol=RTOL, atol=ATOL)
    for a, b in zip(got_l, want_l):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case,shape", [("dh", (1, 2)), ("dh", (1, 4)),
                                        ("hk", (1, 2)), ("hk", (2, 4)),
                                        ("layers", (1, 2)),
                                        ("layers", (2, 4))])
def test_caches_split_over_dh_hk_or_layers_serve_alike(case, shape):
    """Where ``_auto_spec`` puts ``model`` on Dh, Hk or L: the scores'
    partial dot products summed over ``model``, heads local, a layer's
    cache on its owner; no cache gathered."""
    cfg = case_cfg(case)
    mesh = cpu_mesh(shape)
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = case_batch(case)
    max_len = CASES[case][4]
    want_t, want_l, want_p = one_device(cfg, params, batch, max_len)
    got_t, got_l, got_p, cache = sharded(cfg, mesh, params, batch, max_len)
    assert SS._cache_views(cache, mesh)[0][0].kind == SPLIT[case]
    assert torch.equal(got_t, want_t)
    torch.testing.assert_close(got_p, want_p, rtol=RTOL, atol=ATOL)
    for a, b in zip(got_l, want_l):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_no_position_holds_the_whole_cache(mesh_name):
    """The greedy loop (``greedy_generate_sharded``) gives the one-device
    tokens; each position's resident cache bytes are ``shard_bytes`` of
    the cache under ``cache_shardings``, a fraction of the whole; after
    the prefill every placed leaf's shard is the position's slice of the
    one-device cache (within the tolerance: each shard projects its own
    KV heads)."""
    case = "dense"
    cfg = case_cfg(case)
    mesh = cpu_mesh(MESHES[mesh_name])
    B, _, max_len = CASES[case][2:5]
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = case_batch(case, seed=3)
    pp = PL.place_tree(params, SS.prefill_param_shardings(cfg, mesh))
    toks, _ = SS.greedy_generate_sharded(cfg, mesh, pp, pp, batch,
                                         STEPS + 1, max_len)
    assert torch.equal(toks, one_device(cfg, params, batch, max_len)[0])
    cache, _ = SS.make_sharded_prefill(cfg, mesh, max_len)(pp, batch)
    shape = SS.serve_shape(B, max_len)
    want = S.shard_bytes(S.cache_structs(cfg, shape),
                         S.cache_shardings(cfg, shape, mesh))
    whole = sum(t.numel() * t.element_size()
                for t in tree.leaves(S.cache_structs(cfg, shape)))
    got = PL.resident_bytes(cache)
    assert set(got) == set(range(mesh.size))
    assert all(b == want for b in got.values()) and want * mesh.size == whole
    with torch.no_grad():
        ref, _ = make_prefill(cfg, max_len)(params, batch)
    for name in ("k", "v"):
        torch.testing.assert_close(PL.gather(cache[name]), ref[name],
                                   rtol=RTOL, atol=ATOL)


#: the decoder-only attention configs this slice serves
SLICE_ARCHS = ("smollm-135m", "granite-8b", "deepseek-coder-33b", "gemma2-9b",
               "qwen3-moe-235b-a22b", "grok-1-314b", "llava-next-34b")


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_serving_shapes_split_the_cache_positions(multi_pod):
    """At ``decode_32k`` and ``long_500k`` ``cache_shardings`` puts
    ``model`` on T for every config of the slice, on the (16, 16) and
    (2, 16, 16) meshes (``meta`` placements): the layout
    ``decode_attention_model``'s "T" branch serves. granite-8b's
    ``decode_32k`` cache is 618,475,290,624 bytes, 2,415,919,104 a
    position of (16, 16)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import shape_by_name
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * (
        512 if multi_pod else 256))
    for arch in SLICE_ARCHS:
        cfg = get_config(arch)
        for name in ("decode_32k", "long_500k"):
            shape = shape_by_name(name)
            sh = S.cache_shardings(cfg, shape, mesh)
            for leaf in ("k", "v"):
                assert PL.model_dim(sh[leaf].spec) == 2, (arch, name)
    cfg, shape = get_config("granite-8b"), shape_by_name("decode_32k")
    structs = S.cache_structs(cfg, shape)
    assert sum(t.numel() * t.element_size()
               for t in tree.leaves(structs)) == 618_475_290_624
    if not multi_pod:
        assert S.shard_bytes(structs, S.cache_shardings(
            cfg, shape, mesh)) == 2_415_919_104


def test_vocab_argmax_takes_the_lowest_index_on_ties():
    """Shards 0 and 2 of 4 hold the max: shard 0's index wins; within a
    shard the first; a later shard only where strictly greater."""
    mesh = cpu_mesh((1, 4))
    row = PL.ModelRow(mesh, 0, torch.device("cpu"))
    parts = [torch.zeros(3, 5) for _ in range(4)]
    parts[0][0, 3] = parts[2][0, 1] = 7.0          # a tie across shards
    parts[1][1, 2] = parts[1][1, 4] = 2.0          # a tie in a shard
    parts[3][2, 0] = 1.0
    parts[1][2, 0] = 1.0                           # equal, earlier shard
    got = PL.argmax_model(parts, row)
    whole = torch.cat(parts, -1)
    assert got.tolist() == [3, 7, 5] == torch.argmax(whole, -1).tolist()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_builds_the_sharded_serving(arch):
    """Every config of ``configs`` (its smoke size, f32) builds
    ``make_sharded_prefill`` and ``make_sharded_serve_step`` on (1, 2)
    and serves a prefill and two steps: finite logits of the whole
    vocabulary, the cache placed by ``cache_shardings``."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mesh = cpu_mesh((1, 2))
    params = init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    placed = PL.place_tree(params, SS.serve_param_shardings(cfg, mesh))
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32))}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_positions, cfg.d_model)).astype(np.float32))
    if cfg.n_img_tokens:
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    max_len = positions(cfg, batch) + 2
    cache, lg = SS.make_sharded_prefill(cfg, mesh, max_len)(placed, batch)
    step = SS.make_sharded_serve_step(cfg, mesh, whole_logits=True)
    tok = SS.sharded_argmax(cfg, lg)
    for i in range(2):
        tok, lgi, cache = step(placed, cache, tok,
                               positions(cfg, batch) + i)
        assert lgi.shape == (2, 1, cfg.vocab)
        assert bool(torch.isfinite(lgi).all())
    shape = SS.serve_shape(2, max_len)
    assert set(PL.resident_bytes(cache).values()) == {S.shard_bytes(
        S.cache_structs(cfg, shape), S.cache_shardings(cfg, shape, mesh))}


# --- against the reference's own programs -------------------------------------

REF_CASE = dict(arch="smollm-135m", B=4, prompt=24, max_len=64, seed=5)

_REF = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    sys.path.insert(0, sys.argv[2])
    from test_torch_sharded_serve import REF_CASE, STEPS
    from repro import configs, models
    from repro.launch import specs as S
    from repro.models.config import ShapeConfig
    from repro.models.sharding import use_mesh
    from repro.serve.step import make_serve_step

    k = REF_CASE
    cfg = dataclasses.replace(configs.get_smoke_config(k["arch"]),
                              dtype="float32")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    B, Sp, T = k["B"], k["prompt"], k["max_len"]
    tokens = np.random.default_rng(k["seed"]).integers(
        0, cfg.vocab, (B, Sp)).astype(np.int32)
    out = {}
    p = models.init_params(cfg, jax.random.PRNGKey(0))
    for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        out["w/" + "/".join(str(x.key) for x in path)] = np.asarray(v)

    def prefill_step(params, batch):
        o = models.forward(cfg, params, batch, logits_mode="last",
                           return_cache=True)
        return o.logits, o.cache["kv"]

    pre_shape = ShapeConfig("p", Sp, B, "prefill")
    dec_shape = ShapeConfig("d", T, B, "decode")
    with use_mesh(mesh):
        b_sds = S.batch_spec(cfg, pre_shape, mesh)
        pre = jax.jit(prefill_step, in_shardings=(
            # dryrun's _needs_fsdp (its import asks for 512 devices)
            S.param_shardings(cfg, mesh, zero1=cfg.n_params() * 2 / 2
                              / 2**30 > 4.0),
            S.batch_shardings(b_sds, cfg, mesh)))
        logits, (kk, vv) = pre(p, {"tokens": jnp.asarray(tokens)})
        cache = models.init_decode_cache(cfg, B, T)
        cache["k"] = cache["k"].at[:, :, :Sp].set(kk)
        cache["v"] = cache["v"].at[:, :, :Sp].set(vv)
        c_shard = S.cache_shardings(cfg, dec_shape, mesh)
        d_sds = S.batch_spec(cfg, dec_shape, mesh)
        t_shard = S.batch_shardings(d_sds, cfg, mesh)["tokens"]
        cache = jax.device_put(cache, c_shard)
        step = jax.jit(make_serve_step(cfg), in_shardings=(
            S.param_shardings(cfg, mesh, zero1=False), c_shard, t_shard,
            None), out_shardings=(t_shard, None, c_shard),
            donate_argnums=(1,))
        out["prefill"] = np.asarray(logits)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks = [np.asarray(tok)]
        for i in range(STEPS):
            tok, lg, cache = step(p, cache, tok, jnp.int32(Sp + i))
            toks.append(np.asarray(tok))
            out[f"step{i}"] = np.asarray(lg)
        out["tokens"] = np.concatenate(toks, 1)
        out["cache_spec"] = np.asarray(str(c_shard["k"].spec))
    np.savez(sys.argv[1], **out)
    print(len(jax.devices()), "OK")
''')


@pytest.fixture(scope="module", autouse=True)
def reference_child(tmp_path_factory):
    """The reference's run, started with the module and left to run
    while the port's runs compute."""
    out = tmp_path_factory.mktemp("serve_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(out),
                             str(ROOT / "tests")], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_split_serving_matches_the_references_jitted_programs(
        reference_child):
    proc, path = reference_child
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    assert stdout.split()[-2:] == ["4", "OK"]
    ref = dict(np.load(path))
    k = REF_CASE
    cfg = dataclasses.replace(get_smoke_config(k["arch"]), dtype="float32")
    w = {}
    for key, v in ref.items():
        if key.startswith("w/"):
            node = w
            *path_, leaf = key[2:].split("/")
            for p_ in path_:
                node = node.setdefault(p_, {})
            node[leaf] = v
    params = params_from_numpy(w, cfg, "cpu")
    tokens = np.random.default_rng(k["seed"]).integers(
        0, cfg.vocab, (k["B"], k["prompt"])).astype(np.int32)
    mesh = cpu_mesh((2, 2))
    got_t, got_l, got_p, cache = sharded(
        cfg, mesh, params, {"tokens": torch.from_numpy(tokens)},
        k["max_len"])
    assert str(cache["k"].sharding.spec) == str(ref["cache_spec"])
    assert np.array_equal(got_t.numpy(), ref["tokens"])
    np.testing.assert_allclose(got_p.numpy(), ref["prefill"], rtol=RTOL,
                               atol=ATOL)
    for i, lg in enumerate(got_l):
        np.testing.assert_allclose(lg.numpy(), ref[f"step{i}"], rtol=RTOL,
                                   atol=ATOL)


# --- four gloo processes --------------------------------------------------------

#: the train step's shared batch under EP: 33 sequences over 2 data rows
#: (every row holds them), 33 x 126 = 4,158 tokens (EP engages)
SHARED_EP = dict(B=33, seq=126, capacity_factor=2.0)


def rank_runs(mesh) -> dict:
    """What the gloo test compares, on ``mesh``: the dense case's
    sharded serving (tokens, logits, every local cache shard), the EP
    case's prefill (logits, cache shards) and one train step of the
    shared batch under EP (the gathered state and its metrics)."""
    from test_torch_sharded_launch import (fresh_state, make_batch,
                                           run_steps, f32)
    out = {}
    for case, cut in (("dense", None), ("moe-ep", "prefill")):
        cfg = case_cfg(case)
        params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
        batch = case_batch(case, seed=4)
        max_len, ep = CASES[case][4:6]
        with ep_mode(ep):
            if cut == "prefill":
                pp = PL.place_tree(params,
                                   SS.prefill_param_shardings(cfg, mesh))
                cache, lg = SS.make_sharded_prefill(cfg, mesh, max_len)(
                    pp, batch)
                toks, logits = None, [PL.gather(lg)]
            else:
                toks, logits, lg, cache = sharded(cfg, mesh, params, batch,
                                                  max_len)
        out[case] = dict(tokens=toks, logits=logits,
                         cache={n: dict(cache[n].local) for n in cache})
    k = SHARED_EP
    cfg = f32("qwen3-moe-235b-a22b", moe=MoEConfig(8, 2,
                                                   k["capacity_factor"]))
    import test_torch_sharded_launch as T
    real = T.make_batch
    T.make_batch = lambda c, seed, B=8, S_=16: real(c, seed, B=k["B"],
                                                    S_=k["seq"])
    try:
        with ep_mode(True, mesh):
            out["train"] = run_steps(cfg, mesh, fresh_state(cfg), n=1)
    finally:
        T.make_batch = real
    return out


_GLOO_WORKER = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[3])
    import test_torch_sharded_serve as T
    from repro_torch.launch.mesh import init_distributed, make_mesh

    rank, rdv = int(sys.argv[1]), sys.argv[2]
    init_distributed(coordinator_address="file://" + rdv,
                     num_processes=T.WORLD, process_id=rank, backend="gloo")
    out = T.rank_runs(make_mesh((2, 2), T.AX2))
    torch.save(out, f"{rdv}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
''')


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory, reference_child):
    tmp = tmp_path_factory.mktemp("gloo_serve")
    rdv = str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r),
                               rdv, str(ROOT / "tests")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    try:
        want = rank_runs(cpu_mesh((2, 2)))
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=400)
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc, _ in errs), errs
    return want, [torch.load(f"{rdv}.rank{r}.pt", weights_only=False)
                  for r in range(WORLD)]


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("case", ["dense", "moe-ep"])
def test_gloo_ranks_serve_the_one_process_bits(gloo_ranks, case):
    want, ranks = gloo_ranks
    for r, got in enumerate(ranks):
        g, w = got[case], want[case]
        assert _equal(g["logits"], w["logits"]), r
        if w["tokens"] is not None:
            assert torch.equal(g["tokens"], w["tokens"]), r
        for name in w["cache"]:
            assert list(g["cache"][name]) == [r]
            assert torch.equal(g["cache"][name][r], w["cache"][name][r]), r


def test_gloo_ranks_train_the_shared_batch_under_ep(gloo_ranks):
    """A batch that does not divide over the data rows under EP across
    processes: each position routes its row's share of the tokens; the
    ranks' step is the one-process mesh's, bitwise."""
    want, ranks = gloo_ranks
    (ws, wm) = want["train"]
    for r, got in enumerate(ranks):
        gs, gm = got["train"]
        assert _equal(gs, ws), r
        assert gm == wm, r
