"""Whisper, xLSTM and hymba served at the reference's dry-run partition
on the CPU (``serve.sharded``): params by ``param_shardings``, the whole
serving state by ``cache_shardings`` (whisper's encoder memory beside
its KV cache, xLSTM's five recurrent states, hymba's k/v rings and SSM
states), every position computing its share.

* against the one-device ``make_prefill`` + ``make_serve_step`` on
  (1, 2), (2, 2) and (1, 4) CPU meshes, and (1, 8) for a case a family:
  whisper with its memory split over d (the smoke config: 32 frames
  under d 64, the production layout) and over its frames (160 frames);
  xLSTM; hymba at 4 layers decoded from position 0 so its 8-slot ring
  wraps (split over Dh, ``_auto_spec`` taking the largest dim) and with
  a 32-slot ring under a 48-token prompt (split over its slots). The
  greedy tokens equal, f32 logits within ``RTOL``/``ATOL``; xLSTM a step
  at a time from the shared state (its bf16 ``mlstm_C`` turns one f32
  ulp into one bf16 ulp, which later steps amplify), its replicated
  states bitwise alike on every model shard;
* a batch that does not divide over the rows (B 1 at dp 2, long_500k's
  batch): every row takes the whole batch;
* each position's resident bytes are ``specs.shard_bytes`` of the state
  under ``cache_shardings``; ``slstm_m`` starts at -1e30 on every shard;
  at ``decode_32k`` and ``long_500k`` on (16, 16) the per-position bytes
  and the split dims of the production layout;
* against the reference's own jitted ``make_serve_step`` with
  ``in_shardings`` from ``cache_shardings`` on four emulated JAX devices
  (Auto axes), a step at a time from the reference's state;
* four gloo ranks on (2, 2) are bitwise the one-process mesh for whisper
  (frames split) and hymba.

Torch runs on one thread here and in the ranks (restored after)."""
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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import init_decode_cache, init_params
from repro_torch.models.config import shape_by_name
from repro_torch.serve import make_prefill, make_serve_step
from repro_torch.serve import sharded as SS

ROOT = Path(__file__).resolve().parent.parent
AX2 = ("data", "model")
WORLD = 4
#: f32 logits of the split against the one-device step: the same
#: function, its sums in another order
RTOL, ATOL = 2e-5, 2e-5
STEPS = 8

#: (arch, config overrides, batch, prompt, cache positions, how it runs:
#: "prefill" (the prefill, then greedy steps), "zero" (decoded from
#: position 0, the reference's greedy_generate), "stepwise" (from 0, a
#: step at a time from the one-device state))
CASES = {
    "whisper-d": ("whisper-base", {}, 4, 10, 24, "prefill"),
    "whisper-frames": ("whisper-base", dict(enc_positions=160), 4, 10, 24,
                       "prefill"),
    "xlstm": ("xlstm-1.3b", {}, 4, 6, 16, "stepwise"),
    "hymba-dh": ("hymba-1.5b", dict(n_layers=4), 4, 12, 24, "zero"),
    "hymba-t": ("hymba-1.5b", dict(n_layers=4, sliding_window=32), 2, 48,
                64, "zero"),
}
#: what ``cache_shardings`` splits over ``model`` on every mesh here: the
#: whisper memory's dim, hymba's ring's (layer 1, the windowed one)
SPLIT = {"whisper-d": ("enc_out", 2), "whisper-frames": ("enc_out", 1),
         "hymba-dh": ("ring", 3), "hymba-t": ("ring", 1)}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "1x8": (1, 8)}
RUNS = [(c, m) for c in CASES for m in ("1x2", "2x2", "1x4")] + [
    (c, "1x8") for c in ("whisper-d", "xlstm", "hymba-dh")]


def case_cfg(case: str):
    arch, kw = CASES[case][:2]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def case_batch(case: str, seed: int = 0, B=None) -> dict:
    cfg = case_cfg(case)
    B = B or CASES[case][2]
    Sp = CASES[case][3]
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, Sp)).astype(np.int32)}
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def cpu_mesh(shape):
    return make_mesh(shape, AX2, devices=["cpu"] * int(np.prod(shape)))


def feed(prompt, toks, t):
    """The token at step t of a decode from position 0: the prompt's,
    then the last one generated."""
    return prompt[:, t:t + 1] if t < prompt.shape[1] else toks[-1]


def one_device(cfg, params, batch, max_len: int, how: str):
    """(tokens, each call's logits, each step's state before it) of the
    one-device serving: the prefill and ``STEPS`` greedy steps, or a
    decode from position 0 through the prompt and ``STEPS`` more."""
    step = make_serve_step(cfg)
    with torch.no_grad():
        if how == "prefill":
            cache, lg = make_prefill(cfg, max_len)(params, batch)
            toks = [torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]]
            logits, states, t0 = [lg], [], batch["tokens"].shape[1]
            for i in range(STEPS):
                states.append(tree.tree_map(torch.clone, cache))
                tok, lg, cache = step(params, cache, toks[-1], t0 + i)
                toks.append(tok)
                logits.append(lg)
            return torch.cat(toks, 1), logits, states
        prompt = batch["tokens"]
        B = prompt.shape[0]
        cache = init_decode_cache(cfg, B, max_len, device="cpu")
        toks, logits, states = [], [], []
        for t in range(prompt.shape[1] + STEPS):
            states.append(tree.tree_map(torch.clone, cache))
            tok, lg, cache = step(params, cache, feed(prompt, toks, t), t)
            toks.append(tok)
            logits.append(lg)
        return torch.cat(toks, 1), logits, states


def placed_params(cfg, mesh, params):
    return (PL.place_tree(params, SS.prefill_param_shardings(cfg, mesh)),
            PL.place_tree(params, SS.serve_param_shardings(cfg, mesh)))


def sharded(cfg, mesh, params, batch, max_len: int, how: str,
            states=None):
    """The same on ``mesh``: (tokens, each call's whole logits, the
    placed state). With ``states`` (``one_device``'s) each step starts
    from the one-device state before it, placed by ``cache_shardings``,
    and takes the one-device run's token."""
    pp, sp = placed_params(cfg, mesh, params)
    step = SS.make_sharded_serve_step(cfg, mesh, whole_logits=True)
    B = batch["tokens"].shape[0]
    shardings = S.cache_shardings(cfg, SS.serve_shape(B, max_len), mesh)
    if how == "prefill":
        cache, lg = SS.make_sharded_prefill(cfg, mesh, max_len)(pp, batch)
        tok = SS.sharded_argmax(cfg, lg)
        toks, logits, t0 = [PL.gather(tok)], [PL.gather(lg)], \
            batch["tokens"].shape[1]
        for i in range(STEPS):
            tok, lg, cache = step(sp, cache, tok, t0 + i)
            toks.append(PL.gather(tok))
            logits.append(lg)
        return torch.cat(toks, 1), logits, cache
    prompt = batch["tokens"]
    cache = SS.place_cache(cfg, mesh, B, max_len)
    toks, logits = [], []
    for t in range(prompt.shape[1] + STEPS):
        cur = feed(prompt, toks, t)
        if states is not None:
            cache = PL.place_tree(states[t], shardings)
        tok, lg, cache = step(sp, cache, cur, t)
        toks.append(PL.gather(tok))
        logits.append(lg)
    return torch.cat(toks, 1), logits, cache


def shards_alike(cache, mesh) -> bool:
    """Every leaf kept whole over ``model`` (xLSTM's mlstm_n and sLSTM
    states) holds the same bits on every model shard of a row."""
    for leaf in tree.leaves(cache):
        if PL.model_dim(leaf.sharding.spec) is not None:
            continue
        for q, t in leaf.local.items():
            for q2 in mesh.members(q, ("model",)):
                if not torch.equal(leaf.local[q2], t):
                    return False
    return True


@pytest.mark.parametrize("case,mesh_name", RUNS)
def test_split_meshes_serve_the_one_device_tokens(case, mesh_name):
    cfg = case_cfg(case)
    mesh = cpu_mesh(MESHES[mesh_name])
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = case_batch(case)
    max_len, how = CASES[case][4:6]
    want_t, want_l, states = one_device(cfg, params, batch, max_len, how)
    got_t, got_l, cache = sharded(
        cfg, mesh, params, batch, max_len, "zero" if how == "stepwise"
        else how, states if how == "stepwise" else None)
    if case in SPLIT:
        leaf, dim = SPLIT[case]
        sh = (cache["enc_out"] if leaf == "enc_out" else
              cache["layers"][1]["k"]).sharding
        assert PL.model_dim(sh.spec) == dim
    assert torch.equal(got_t, want_t)
    for a, b in zip(got_l, want_l):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    if how == "stepwise":
        assert shards_alike(cache, mesh)
        pp, _ = placed_params(cfg, mesh, params)
        _, lg = SS.make_sharded_prefill(cfg, mesh, max_len)(pp, batch)
        with torch.no_grad():
            _, want = make_prefill(cfg, max_len)(params, batch)
        torch.testing.assert_close(PL.gather(lg), want, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["whisper-frames", "xlstm", "hymba-dh"])
def test_a_batch_that_does_not_divide_over_the_rows(case):
    """B 1 on dp 2: every row takes the whole batch and keeps the whole
    batch dim of the state; the tokens are the one-device run's."""
    cfg = case_cfg(case)
    mesh = cpu_mesh((2, 2))
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = case_batch(case, seed=2, B=1)
    max_len, how = CASES[case][4:6]
    want_t, want_l, states = one_device(cfg, params, batch, max_len, how)
    got_t, got_l, cache = sharded(
        cfg, mesh, params, batch, max_len, "zero" if how == "stepwise"
        else how, states if how == "stepwise" else None)
    assert SS._batch_rows(mesh, 1).shared
    assert all("data" not in PL.spec_axes(leaf.sharding.spec)
               for leaf in tree.leaves(cache))
    assert torch.equal(got_t, want_t)
    for a, b in zip(got_l, want_l):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh_name", ["1x2", "2x2", "1x4", "1x8"])
@pytest.mark.parametrize("case", ["whisper-frames", "xlstm", "hymba-dh"])
def test_each_position_holds_its_shard_of_the_state(case, mesh_name):
    """``place_cache`` and the prefill's state: each position's resident
    bytes are ``shard_bytes`` under ``cache_shardings``; xLSTM's
    ``slstm_m`` starts at -1e30 on every shard (its other states at 0);
    whisper's placed memory is the one-device memory's slice."""
    cfg = case_cfg(case)
    mesh = cpu_mesh(MESHES[mesh_name])
    B, _, max_len = CASES[case][2:5]
    shape = SS.serve_shape(B, max_len)
    want = S.shard_bytes(S.cache_structs(cfg, shape),
                         S.cache_shardings(cfg, shape, mesh))
    cache = SS.place_cache(cfg, mesh, B, max_len)
    got = PL.resident_bytes(cache)
    assert set(got) == set(range(mesh.size))
    assert set(got.values()) == {want}
    if cfg.family == "ssm":
        for name, leaf in cache.items():
            fill = -1e30 if name == "slstm_m" else 0.0
            assert all(bool((t == fill).all()) for t in leaf.local.values())
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = case_batch(case, seed=3)
    pp, _ = placed_params(cfg, mesh, params)
    cache, _ = SS.make_sharded_prefill(cfg, mesh, max_len)(pp, batch)
    assert set(PL.resident_bytes(cache).values()) == {want}
    with torch.no_grad():
        ref, _ = make_prefill(cfg, max_len)(params, batch)
    for (name, leaf), r in zip(tree.flatten_with_path(cache),
                               tree.leaves(ref)):
        torch.testing.assert_close(PL.gather(leaf), r, rtol=RTOL,
                                   atol=ATOL, msg=name)


#: bytes a position of (16, 16) holds of the serving state, and the dim
#: each leaf splits over ``model``
PRODUCTION = {
    ("whisper-base", "decode_32k"): (202_094_592, {"enc_out": 2, "k": 2}),
    ("xlstm-1.3b", "decode_32k"): (47_972_352, {"mlstm_C": 4,
                                                "mlstm_n": None,
                                                "slstm_c": None}),
    ("xlstm-1.3b", "long_500k"): (5_996_544, {"mlstm_C": 4}),
    ("hymba-1.5b", "decode_32k"): (83_558_400, {"layers/0/k": 1,
                                                "layers/1/k": 1,
                                                "layers/1/ssm": 3}),
    ("hymba-1.5b", "long_500k"): (128_409_600, {"layers/0/k": 1,
                                                "layers/1/ssm": 3}),
}


@pytest.mark.parametrize("arch,shape_name", list(PRODUCTION))
def test_production_layout_bytes_a_position(arch, shape_name):
    """At the serving shapes on the (16, 16) mesh (``meta``): the memory
    over d (1,500 frames do not divide by 16), the mLSTM memory over
    D_out, the sLSTM states whole, hymba's rings over their slots and
    its SSM state over Dh; the bytes a position keeps."""
    cfg, shape = get_config(arch), shape_by_name(shape_name)
    mesh = make_production_mesh(devices=["meta"] * 256)
    structs = S.cache_structs(cfg, shape)
    sh = S.cache_shardings(cfg, shape, mesh)
    want, dims = PRODUCTION[(arch, shape_name)]
    assert S.shard_bytes(structs, sh) == want
    by_path = dict(tree.flatten_with_path(sh))
    for path, dim in dims.items():
        assert PL.model_dim(by_path[path].spec) == dim, path


def test_the_sharded_serving_states_its_layouts():
    """The placed memory at (1, 4) with whisper-base's 1,500 frames
    splits over the frames, at (1, 8) over d."""
    cfg = get_config("whisper-base")
    shape = SS.serve_shape(8, 448)
    for mshape, dim in (((1, 4), 1), ((2, 2), 1), ((1, 8), 2),
                        ((1, 16), 2)):
        mesh = make_mesh(mshape, AX2, devices=["meta"] * int(
            np.prod(mshape)))
        spec = S.cache_shardings(cfg, shape, mesh)["enc_out"].spec
        assert PL.model_dim(spec) == dim, mshape


# --- against the reference's own jitted serve step ---------------------------

REF_STEPS = {"whisper-d": 4, "whisper-frames": 4, "xlstm": 6,
             "hymba-dh": 12, "hymba-t": 4}

_REF = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    sys.path.insert(0, sys.argv[2])
    from test_torch_sharded_serve_families import CASES, REF_STEPS
    from repro import configs, models
    from repro.launch import specs as S
    from repro.models.config import ShapeConfig
    from repro.models.sharding import use_mesh
    from repro.serve.step import make_prefill, make_serve_step

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}

    def leaves(tag, tree_):
        for path, v in jax.tree_util.tree_flatten_with_path(tree_)[0]:
            key = "/".join(str(getattr(x, "key", getattr(x, "idx", x)))
                           for x in path)
            out[f"{tag}/{key}"] = np.asarray(v.astype(jnp.float32)
                                             if v.dtype == jnp.bfloat16
                                             else v)

    for case, n in REF_STEPS.items():
        arch, kw, B, Sp, T, how = CASES[case]
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32", **kw)
        p = models.init_params(cfg, jax.random.PRNGKey(0))
        leaves(f"{case}/w", p)
        rng = np.random.default_rng(9)
        toks = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
        dec = ShapeConfig("d", T, B, "decode")
        t0 = 0
        with use_mesh(mesh):
            if cfg.enc_dec:
                frames = rng.standard_normal(
                    (B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
                t0 = Sp
                cache, _ = make_prefill(cfg, T)(p, {
                    "tokens": jnp.asarray(rng.integers(
                        0, cfg.vocab, (B, Sp)).astype(np.int32)),
                    "frames": jnp.asarray(frames)})
            else:
                cache = models.init_decode_cache(cfg, B, T)
            c_shard = S.cache_shardings(cfg, dec, mesh)
            t_shard = S.batch_shardings(S.batch_spec(cfg, dec, mesh), cfg,
                                        mesh)["tokens"]
            cache = jax.device_put(cache, c_shard)
            step = jax.jit(make_serve_step(cfg), in_shardings=(
                S.param_shardings(cfg, mesh, zero1=False), c_shard,
                t_shard, None), out_shardings=(t_shard, None, c_shard))
            for i in range(n):
                leaves(f"{case}/c{i}", cache)
                tok, lg, cache = step(p, cache,
                                      jnp.asarray(toks[:, i:i + 1]),
                                      jnp.int32(t0 + i))
                out[f"{case}/logits{i}"] = np.asarray(lg)
                out[f"{case}/next{i}"] = np.asarray(tok)
        out[f"{case}/tokens"] = toks
        out[f"{case}/t0"] = np.asarray(t0)
    np.savez(sys.argv[1], **out)
    print(len(jax.devices()), "OK")
''')


@pytest.fixture(scope="module", autouse=True)
def reference_child(tmp_path_factory):
    """The reference's jitted steps, started with the module and left to
    run while the port's runs compute."""
    out = tmp_path_factory.mktemp("serve_families_ref") / "ref.npz"
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


@pytest.fixture(scope="module")
def reference_run(reference_child):
    proc, path = reference_child
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    assert stdout.split()[-2:] == ["4", "OK"]
    return dict(np.load(path))


def _subtree(ref: dict, prefix: str) -> dict:
    """The nested dict of ``ref``'s keys under ``prefix``."""
    out: dict = {}
    for key, v in ref.items():
        if key.startswith(prefix + "/"):
            node = out
            *path_, leaf = key[len(prefix) + 1:].split("/")
            for p_ in path_:
                node = node.setdefault(p_, {})
            node[leaf] = v
    return out


def _state(cfg, ref: dict, prefix: str, B: int, T: int):
    """The reference's state ``prefix`` as the port's tree (its leaves
    in the same order), each leaf in the port's dtype."""
    like = init_decode_cache(cfg, B, T, device="meta")
    keys = [k for k in ref if k.startswith(prefix + "/")]
    by_path = {k[len(prefix) + 1:]: ref[k] for k in keys}
    return tree.unflatten(like, [
        torch.from_numpy(np.asarray(by_path[path])).to(t.dtype)
        for path, t in tree.flatten_with_path(like)])


@pytest.mark.parametrize("case", list(REF_STEPS))
def test_split_step_matches_the_references_jitted_step(case,
                                                        reference_run):
    """On (2, 2), each step from the reference's state before it, placed
    by ``cache_shardings``: the logits within 2e-5 and the next tokens
    equal the reference's jitted ``make_serve_step``'s."""
    ref = reference_run
    arch, kw, B, _, T, _ = CASES[case]
    cfg = case_cfg(case)
    params = params_from_numpy(_subtree(ref, f"{case}/w"), cfg, "cpu")
    mesh = cpu_mesh((2, 2))
    _, sp = placed_params(cfg, mesh, params)
    shardings = S.cache_shardings(cfg, SS.serve_shape(B, T), mesh)
    step = SS.make_sharded_serve_step(cfg, mesh, whole_logits=True)
    toks = torch.from_numpy(ref[f"{case}/tokens"])
    t0 = int(ref[f"{case}/t0"])
    for i in range(REF_STEPS[case]):
        cache = PL.place_tree(_state(cfg, ref, f"{case}/c{i}", B, T),
                              shardings)
        tok, lg, _ = step(sp, cache, toks[:, i:i + 1], t0 + i)
        np.testing.assert_allclose(lg.numpy(), ref[f"{case}/logits{i}"],
                                   rtol=RTOL, atol=ATOL)
        assert np.array_equal(PL.gather(tok).numpy(),
                              ref[f"{case}/next{i}"])


# --- four gloo processes ------------------------------------------------------

GLOO_CASES = ("whisper-frames", "hymba-dh")


def rank_runs(mesh) -> dict:
    """What the gloo test compares, on ``mesh``: each case's tokens,
    logits and every local shard of its placed state."""
    out = {}
    for case in GLOO_CASES:
        cfg = case_cfg(case)
        params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
        batch = case_batch(case, seed=4)
        max_len, how = CASES[case][4:6]
        toks, logits, cache = sharded(cfg, mesh, params, batch, max_len, how)
        out[case] = dict(tokens=toks, logits=logits,
                         cache=[dict(leaf.local)
                                for leaf in tree.leaves(cache)])
    return out


_GLOO_WORKER = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[3])
    import test_torch_sharded_serve_families as T
    from repro_torch.launch.mesh import init_distributed, make_mesh

    rank, rdv = int(sys.argv[1]), sys.argv[2]
    init_distributed(coordinator_address="file://" + rdv,
                     num_processes=T.WORLD, process_id=rank, backend="gloo")
    out = T.rank_runs(make_mesh((2, 2), T.AX2))
    torch.save(out, f"{rdv}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
''')


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_serve_families")
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


@pytest.mark.parametrize("case", GLOO_CASES)
def test_gloo_ranks_serve_the_one_process_bits(gloo_ranks, case):
    want, ranks = gloo_ranks
    for r, got in enumerate(ranks):
        g, w = got[case], want[case]
        assert torch.equal(g["tokens"], w["tokens"]), r
        assert all(torch.equal(a, b) for a, b in zip(g["logits"],
                                                     w["logits"])), r
        for gl, wl in zip(g["cache"], w["cache"]):
            assert list(gl) == [r]
            assert torch.equal(gl[r], wl[r]), r
