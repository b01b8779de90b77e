"""The LM launchers' sharded execution on the CPU: meshes over processes,
placement (``distributed.placement``) and the sharded train step
(``train.sharded``) in one process.

* ``place_tree`` then ``gather_tree`` is bitwise for every family's smoke
  state on (2, 2), (1, 4), (4, 1) and (2, 2, 2 with ``pod``) meshes,
  each position holding ``specs.shard_bytes``;
* a model-sharded weight's gradient through the gather is the full
  gradient's slice (the reduce-scatter of the row's one gradient);
* the sharded step on single-process CPU meshes: bitwise the one-device
  step on (1, 1); within ``LOSS_RTOL``/``PARAM_ATOL``/``MOMENT_RTOL`` of
  it for 3 steps on (2, 2), (4, 1) and (1, 4) (each family's one-device
  run computed once for the four meshes), for every family's smoke
  config, with labels masked unevenly across the data rows (a per-row
  mean moves the loss by ~10 %) and, for the MoE, at a capacity that
  drops tokens (per-row routing drops others);
* the reference's own step under ``jax.jit(..., in_shardings=...)`` on a
  (2, 2) mesh of four emulated host devices (a child process), against
  the port's (2, 2) step on the same numpy weights;
  (smollm, qwen3-moe, granite and xLSTM; the reference's own hymba step
  takes a NaN gradient norm at the third step, on one device too);
* the compressed pod sync at the default bound, on (2, 1, 2) and
  (2, 2, 1) pod meshes, within a quantization step of the one-device
  pod loop's gradients;
* the gloo ranks, checkpoints across meshes and the launchers with
  ``mesh=`` are ``test_torch_sharded_ranks``'s, which shares this
  module's helpers.

Weights are the port's ``init_params`` in f32 (the reference's in the
jitted comparison, carried across with ``convert``). Tolerances are
``tests/test_torch_train.py``'s: the loss within 1e-5 relative, params
after three steps within 1e-4 absolute, moments within 1e-3 of their
largest value; as in chip_smoke's card-against-CPU steps, at most one
parameter in 10^5 may pass 1e-4 (see ``PARAM_SHARE``)."""
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
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import placement as PL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh, make_mesh
from repro_torch.models import init_params, layers
from repro_torch.models.config import MoEConfig
from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                               make_train_step)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ("smollm-135m", "granite-8b", "gemma2-9b", "qwen3-moe-235b-a22b",
            "llava-next-34b", "whisper-base", "xlstm-1.3b", "hymba-1.5b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
#: the share of parameters allowed past PARAM_ATOL (within 2 lr_peak a
#: step): chip_smoke's TRAIN_TOL rule. AdamW moves an element by about lr
#: whatever the size of its gradient, so one whose gradient lies within
#: the summation-order noise of zero can step another way (one element of
#: llava's 106,816 on (2, 2) and (1, 4): a token seen once, its gradient
#: 3e-8 in one run and 8e-10 in the other)
PARAM_SHARE = 1e-5
MOMENT_RTOL = 1e-3
OPT = dict(lr_peak=1e-3, warmup_steps=1, decay_steps=10)
WORLD = 4


def cpu_mesh(name: str) -> DeviceMesh:
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def f32(arch: str, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def fresh_state(cfg, seed: int = 0) -> TrainState:
    p = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return TrainState(p, adamw_init(p))


def shardings(cfg, mesh) -> TrainState:
    return TrainState(S.param_shardings(cfg, mesh),
                      S.opt_state_shardings(cfg, mesh, zero1=mesh.size > 1))


def make_batch(cfg, seed: int, B: int = 8, S_: int = 16) -> dict:
    """Seeded tokens and next-token labels, masked unevenly: 12 of the 16
    labels of each of the first B/4 rows, none after."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S_ + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:B // 4, :12] = -1
    b = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.n_img_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def run_steps(cfg, mesh, state, n: int = 3, tcfg=None, seed: int = 10):
    """``n`` steps of ``make_train_step`` (one-device without a mesh);
    returns (the state, gathered, and each step's metrics as floats)."""
    tcfg = tcfg or TrainStepConfig()
    if mesh is not None:
        state = PL.place_tree(state, shardings(cfg, mesh))
    fn = make_train_step(cfg, tcfg, AdamWConfig(**OPT), mesh=mesh)
    metrics = []
    for i in range(n):
        state, m = fn(state, make_batch(cfg, seed + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return (PL.gather_tree(state) if mesh is not None else state), metrics


def assert_close(want, got, want_m, got_m):
    for a, b in zip(want_m, got_m):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
    over, total = 0, 0
    for (key, a), b in zip(tree.flatten_with_path(want.params),
                           tree.leaves(got.params)):
        d = (a.float() - b.float()).abs()
        assert float(d.max()) <= 2 * OPT["lr_peak"] * len(want_m), key
        over += int((d > PARAM_ATOL).sum())
        total += d.numel()
    assert over <= PARAM_SHARE * total, (over, total)
    for part in ("m", "v"):
        for (key, a), b in zip(tree.flatten_with_path(getattr(want.opt, part)),
                               tree.leaves(getattr(got.opt, part))):
            bound = MOMENT_RTOL * float(a.abs().max())
            assert float((a - b).abs().max()) <= bound, (part, key)
    assert int(got.opt.step) == int(want.opt.step)


def equal_trees(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# --- meshes -----------------------------------------------------------------

def test_mesh_members_follow_the_axes():
    mesh = cpu_mesh("2x2x2")
    assert not mesh.multi_process and mesh.local_positions() == list(range(8))
    assert mesh.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert mesh.members(5, ("model",)) == [4, 5]
    assert mesh.members(5, ("pod", "data")) == [1, 3, 5, 7]
    assert mesh.members(5, ("pod", "model")) == [0, 1, 4, 5]
    assert mesh.device_at(7) == torch.device("cpu")
    with pytest.raises(ValueError, match="single-process"):
        mesh.group(("data",))


# --- placement --------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_place_then_gather_is_bitwise(arch, mesh_name):
    cfg = get_smoke_config(arch)
    mesh = cpu_mesh(mesh_name)
    state = fresh_state(cfg)
    sh = shardings(cfg, mesh)
    placed = PL.place_tree(state, sh)
    assert equal_trees(PL.gather_tree(placed), state)
    want = S.shard_bytes(TrainState(S.param_structs(cfg),
                                    S.opt_state_structs(cfg)), sh)
    got = PL.resident_bytes(placed)
    assert sorted(got) == list(range(mesh.size))
    assert set(got.values()) == {want}
    for s, shd in zip(tree.leaves(placed), tree.leaves(sh)):
        for q, t in s.local.items():
            assert tuple(t.shape) == shd.shard_shape(s.shape)
            assert t.device == mesh.device_at(q)


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
def test_the_gathers_gradient_is_the_full_gradients_slice(mesh_name,
                                                         monkeypatch):
    """A row's model shards through ``ModelShards``, on the MoE's expert
    weights under ``layers.MOE_EP_MODE`` (which ``ffn_block`` gathers
    whole over ``model`` for ``moe_ffn_ep``, here without an ambient
    mesh: the dense ``moe_ffn``; since attention splits at every tp this
    is the layer a model gathers): the loss and every shard's gradient
    equal the one-device loss and the slice of its full gradient, bit
    for bit (one contribution reduce-scattered). The embedding goes in
    as shards too (the vocab-parallel lookup is the whole lookup's
    bits); the other model-sharded weights whole (the split attention
    and the unembedding's vocab-sharded logits would need the step's
    sums over ``model``: they round in another order)."""
    monkeypatch.setattr(layers, "MOE_EP_MODE", True)
    cfg = f32("qwen3-moe-235b-a22b")
    mesh = cpu_mesh(mesh_name)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = make_batch(cfg, 4, B=2)
    loss_fn = make_loss_fn(cfg, TrainStepConfig())
    (want, _), full = value_and_grad(loss_fn, params, batch)
    placed = PL.place_tree(params, S.param_shardings(cfg, mesh))
    qs = mesh.members(0, ("model",))
    view, flat = [], []
    for (name, s), whole in zip(tree.flatten_with_path(placed),
                                tree.leaves(params)):
        k = PL.model_dim(s.sharding.spec)
        if k is None or name.split("/")[-1] not in (
                "embed", "moe_w_gate", "moe_w_up", "moe_w_down"):
            t = (whole if k is not None else s.local[0]).detach()
            view.append(t.requires_grad_(True))
            flat.append((view[-1], s, None))
            continue
        parts = [s.local[q].detach().requires_grad_(True) for q in qs]
        view.append(PL.ModelShards(parts, k, mesh, 0, torch.device("cpu")))
        flat.extend((p, s, q) for p, q in zip(parts, qs))
    total, _ = loss_fn(tree.unflatten(params, view), batch)
    grads = torch.autograd.grad(total, [t for t, _, _ in flat])
    assert torch.equal(total.detach(), want)
    full_of = {id(s): g for s, g in zip(tree.leaves(placed),
                                        tree.leaves(full))}
    n_split = 0
    for (t, s, q), g in zip(flat, grads):
        want_g = full_of[id(s)]
        if q is not None:
            want_g = want_g[PL.shard_slices(s.sharding, s.shape, q)]
            n_split += 1
        assert torch.equal(g, want_g)
    assert n_split > len(qs)          # the experts and the embedding


# --- the sharded step, one process ------------------------------------------

#: each family's one-device run (3 steps), computed once for the step
#: tests that hold a mesh to it
_ONE_DEVICE: dict = {}


def one_device_run(arch: str):
    if arch not in _ONE_DEVICE:
        cfg = f32(arch)
        _ONE_DEVICE[arch] = run_steps(cfg, None, fresh_state(cfg))
    return _ONE_DEVICE[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_on_a_1x1_mesh_is_the_one_device_step(arch):
    cfg = f32(arch)
    want, wm = one_device_run(arch)
    got, gm = run_steps(cfg, make_host_mesh("cpu"), fresh_state(cfg))
    assert wm == gm
    assert equal_trees(want, got)


@pytest.mark.parametrize("mesh_name", ["2x2", "4x1", "1x4"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_steps_match_the_one_device_step(arch, mesh_name):
    cfg = f32(arch)
    want, wm = one_device_run(arch)
    got, gm = run_steps(cfg, cpu_mesh(mesh_name), fresh_state(cfg))
    assert_close(want, got, wm, gm)


def test_uneven_masks_need_the_global_mean():
    """The batch's labels are masked unevenly over the data rows: the
    mean of the rows' own means is another number (more than 100 x the
    tolerance away), so a step that took it would fail the test
    above."""
    cfg = f32("smollm-135m")
    (loss, _), _ = value_and_grad(make_loss_fn(cfg, TrainStepConfig()),
                                  fresh_state(cfg).params,
                                  make_batch(cfg, 10))
    halves = [float(value_and_grad(
        make_loss_fn(cfg, TrainStepConfig()), fresh_state(cfg).params,
        {k: v[i * 4:(i + 1) * 4] for k, v in make_batch(cfg, 10).items()}
    )[0][0]) for i in range(2)]
    assert abs(sum(halves) / 2 - float(loss)) > 100 * LOSS_RTOL * float(loss)


@pytest.mark.parametrize("mesh_name", ["2x2", "4x1"])
def test_moe_rows_route_the_global_batch_where_capacity_drops(mesh_name):
    """At capacity factor 0.5 the dense dispatch drops assignments (the
    loss moves against ample capacity); the sharded step still matches
    the one-device step, which routes all 128 tokens at once."""
    tight = f32("qwen3-moe-235b-a22b",
                moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=0.5))
    ample = dataclasses.replace(tight, moe=MoEConfig(8, 2, 100.0))
    losses = [run_steps(c, None, fresh_state(c), n=1)[1][0]["loss"]
              for c in (tight, ample)]
    assert abs(losses[0] - losses[1]) > 1e-3
    want, wm = run_steps(tight, None, fresh_state(tight))
    got, gm = run_steps(tight, cpu_mesh(mesh_name), fresh_state(tight))
    assert_close(want, got, wm, gm)


@pytest.mark.parametrize("tcfg", [
    TrainStepConfig(n_microbatches=2),
    TrainStepConfig(remat=False, n_microbatches=4)], ids=["mb2", "mb4"])
def test_microbatches_keep_the_mean_of_microbatch_means(tcfg):
    """4 microbatches of 2 rows on 2 data rows, and 2 of 4: each
    microbatch splits over the rows (or every row takes it whole)."""
    cfg = f32("smollm-135m")
    want, wm = run_steps(cfg, None, fresh_state(cfg), tcfg=tcfg)
    got, gm = run_steps(cfg, cpu_mesh("2x2"), fresh_state(cfg), tcfg=tcfg)
    assert_close(want, got, wm, gm)


def test_a_batch_that_does_not_divide_is_replicated():
    cfg = f32("smollm-135m")
    state = fresh_state(cfg)
    fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**OPT))
    b = make_batch(cfg, 10, B=3)
    want, wm = fn(state, b)
    mesh = cpu_mesh("4x1")
    placed = PL.place_tree(fresh_state(cfg), shardings(cfg, mesh))
    got, gm = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**OPT),
                              mesh=mesh)(placed, b)
    assert_close(want, PL.gather_tree(got), [{k: float(v) for k, v in
                                              wm.items()}],
                 [{k: float(v) for k, v in gm.items()}])


def test_grad_compress_on_a_pod_mesh_matches_the_pod_loop():
    """(2, 1, 2) with ``grad_compress``: the pods' compressed sync over
    each position's pod subgroup, against the one-device pod loop (the
    same pods, one quantization step a tensor). The model axis splits
    the MLPs and the vocabulary, whose sums then round in another order
    than the one device's: a gradient at a rounding edge of the
    quantizer takes the next code, one step. At the default bound
    (1e-3: a step of 2e-3 of the tensor's largest |g|) one step is more
    than MOMENT_RTOL, which is made for f32 noise; at 1e-4 the step is
    still the bound's (above the 16-bit codes' amax / qmax) and one step
    is within it. The default bound is held bitwise across processes
    (``GLOO_CASES``' pod case)."""
    cfg = f32("smollm-135m")
    tcfg = TrainStepConfig(grad_compress=True, n_pods=2,
                           grad_compress_bound=1e-4)
    want, wm = run_steps(cfg, None, fresh_state(cfg), tcfg=tcfg)
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"),
                     devices=["cpu"] * 4)
    got, gm = run_steps(cfg, mesh, fresh_state(cfg), tcfg=tcfg)
    assert_close(want, got, wm, gm)
    fn = make_train_step(cfg, TrainStepConfig(grad_compress=True, n_pods=4),
                         AdamWConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="pod axis"):
        fn(PL.place_tree(fresh_state(cfg), shardings(cfg, mesh)),
           make_batch(cfg, 0))


#: the default-bound pod cases: (arch, mesh shape)
POD_CASES = {"smollm 2x1x2": ("smollm-135m", (2, 1, 2)),
             "smollm 2x2x1": ("smollm-135m", (2, 2, 1)),
             "xlstm 2x1x2": ("xlstm-1.3b", (2, 1, 2))}


@pytest.mark.parametrize("case", list(POD_CASES))
def test_pod_sync_at_the_default_bound_is_within_a_step_of_the_pod_loop(
        case, monkeypatch):
    """At the default ``grad_compress_bound`` (1e-3) the synced
    gradients of one step, as each position hands them to AdamW (its
    ZeRO-1 slice), against the one-device pod loop's (``make_grad_fn``):
    each element within one quantization step of its tensor (the step
    the position's sync quantized with), where the f32 sums of the model
    shards or the data rows moved a gradient across a rounding edge of
    the quantizer (one code of one pod: half a step); the others within
    a thousandth of a step (the steps themselves differ in the last bits
    of their amax)."""
    import repro_torch.train.sharded as TS
    from repro_torch.train.step import make_grad_fn
    arch, shape = POD_CASES[case]
    cfg = f32(arch)
    tcfg = TrainStepConfig(grad_compress=True, n_pods=2)
    batch = make_batch(cfg, 10)
    want, _ = make_grad_fn(cfg, tcfg)(fresh_state(cfg).params, batch)
    seen, steps = [], []
    real_update, real_step = TS.adamw_update, TS._step

    def update(opt_cfg, st, params, grads, **kw):
        seen.append([g.clone() for g in grads])
        return real_update(opt_cfg, st, params, grads, **kw)

    def step(*a):
        steps.append(real_step(*a))
        return steps[-1]
    monkeypatch.setattr(TS, "adamw_update", update)
    monkeypatch.setattr(TS, "_step", step)
    mesh = make_mesh(shape, ("pod", "data", "model"), devices=["cpu"] * 4)
    sh = shardings(cfg, mesh)
    fn = make_train_step(cfg, tcfg, AdamWConfig(**OPT), mesh=mesh)
    fn(PL.place_tree(fresh_state(cfg), sh), batch)
    assert len(seen) == len(steps) == mesh.size
    moved, total = 0, 0
    for q, (gs, st) in enumerate(zip(seen, steps)):
        for i, (g, w, msh) in enumerate(zip(gs, tree.leaves(want),
                                            tree.leaves(sh.opt.m))):
            w = w[PL.shard_slices(msh, w.shape, q)]
            d = (g - w).abs()
            assert float(d.max()) <= float(st[i]), (case, q, i)
            moved += int((d > 1e-3 * st[i]).sum())
            total += d.numel()
    assert moved <= 1e-3 * total, (moved, total)


def test_the_state_chooses_the_step():
    """With ``mesh=``, a plain state runs the one-device step (the
    dry-run's meta state does); a state placed on another mesh raises."""
    cfg = f32("smollm-135m")
    mesh = cpu_mesh("2x2")
    fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**OPT),
                         mesh=mesh)
    plain = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**OPT))
    got, _ = fn(fresh_state(cfg), make_batch(cfg, 0))
    assert equal_trees(got, plain(fresh_state(cfg), make_batch(cfg, 0))[0])
    other = PL.place_tree(fresh_state(cfg), shardings(cfg, cpu_mesh("1x4")))
    with pytest.raises(ValueError, match="another mesh"):
        fn(other, make_batch(cfg, 0))


# --- the reference's jitted step on four host devices -----------------------

_REF_CHILD = textwrap.dedent(r"""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs, models, train
    from repro.launch import specs as S
    sys.path.insert(0, sys.argv[2])
    from test_torch_sharded_launch import OPT, make_batch
    out = {}
    # Auto axes: under jax.set_mesh (use_mesh) this JAX's default Explicit
    # axes refuse the vocab-sharded embedding gather of the reference's
    # own step (ShardingTypeError), so the partitioner places it
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for arch in ("smollm-135m", "qwen3-moe-235b-a22b", "granite-8b",
                 "xlstm-1.3b"):
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32")
        with mesh:
            p = models.init_params(cfg, jax.random.PRNGKey(0))
            state = train.TrainState(p, train.adamw_init(p))
            shard = train.TrainState(S.param_shardings(cfg, mesh),
                                     S.opt_state_shardings(cfg, mesh,
                                                           zero1=True))
            state = jax.device_put(state, shard)
            step = jax.jit(train.make_train_step(
                cfg, train.TrainStepConfig(), train.AdamWConfig(**OPT)),
                in_shardings=(shard, None), out_shardings=(shard, None))
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
                out[f"{arch}/w/" + "/".join(str(x.key) for x in k)] = \
                    np.asarray(v)
            for i in range(3):
                b = {k: jnp.asarray(v.numpy())
                     for k, v in make_batch(cfg, 10 + i).items()}
                state, m = step(state, b)
                out.update({f"{arch}/m{i}/{k}": np.asarray(v)
                            for k, v in m.items()})
            for part, t in (("p", state.params), ("m", state.opt.m),
                            ("v", state.opt.v)):
                for k, v in jax.tree_util.tree_flatten_with_path(t)[0]:
                    out[f"{arch}/{part}/" + "/".join(
                        str(x.key) for x in k)] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print(len(jax.devices()), "OK")
""")


@pytest.fixture(scope="module")
def reference_2x2(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    proc = subprocess.run([sys.executable, "-c", _REF_CHILD, str(out),
                           str(ROOT / "tests")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert proc.stdout.split()[-2:] == ["4", "OK"]
    return dict(np.load(out))


# not hymba: the reference's own step (on one device too) takes a NaN
# gradient norm at the third of these steps (its ssm_scan exponentiates
# above the diagonal before it masks: 0 * inf in the gradient)
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b",
                                  "granite-8b", "xlstm-1.3b"])
def test_sharded_step_matches_the_references_jitted_2x2_step(arch,
                                                              reference_2x2):
    ref = reference_2x2
    cfg = f32(arch)
    w = {}
    for k, v in ref.items():
        if k.startswith(f"{arch}/w/"):
            node = w
            *path, leaf = k[len(arch) + 3:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    params = params_from_numpy(w, cfg, "cpu")
    got, gm = run_steps(cfg, cpu_mesh("2x2"),
                        TrainState(params, adamw_init(params)))
    for i, m in enumerate(gm):
        for k, v in m.items():
            np.testing.assert_allclose(v, float(ref[f"{arch}/m{i}/{k}"]),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{arch} step {i} {k}")
    over, total = 0, 0
    for key, b in tree.flatten_with_path(got.params):
        d = np.abs(b.numpy() - ref[f"{arch}/p/{key}"])
        assert d.max() <= 2 * OPT["lr_peak"] * len(gm), key
        over += int((d > PARAM_ATOL).sum())
        total += d.size
    assert over <= PARAM_SHARE * total, (over, total)
    for part, t in (("m", got.opt.m), ("v", got.opt.v)):
        for key, b in tree.flatten_with_path(t):
            a = ref[f"{arch}/{part}/{key}"]
            assert np.abs(b.numpy() - a).max() <= \
                MOMENT_RTOL * np.abs(a).max(), (part, key)
