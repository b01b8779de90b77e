"""A MoE config's data rows compute only their own rows and meet at every
MoE layer: ``placement.gather_rows``, ``models.forward_rows`` /
``decode_step_model`` on whole caches (the serve launcher's rows), the
sharded train step's lockstep rows and the serve launcher's, on the CPU at the smoke configs in f32.

* ``gather_rows`` on (2, 2) and (2, 2, 2) meshes (over the batch axes,
  and over ``data`` within each pod): each row's copy is the
  concatenation, bitwise, and the gradient each row gets is its slice of
  the copies' gradients summed, the plain concatenation's gradient;
* ``forward_rows`` over two rows against the reference's
  ``repro.models.forward`` on the whole batch (hidden states and aux
  loss within 1e-5) at a capacity that drops assignments, and
  ``decode_step_model`` over two rows' whole caches (as
  ``serve.greedy_generate_rows`` decodes) against the one-device
  ``decode_step``;
* the sharded step of qwen3-moe at capacity factor 0.5 on (2, 2),
  (4, 1), (2, 1, 2) and (2, 2, 1) pod meshes with ``grad_compress``,
  and with microbatches, within ``test_torch_sharded_launch``'s
  tolerances of the one-device step (the reference's jitted (2, 2) step
  is held in that file);
* ``FlopCounterMode`` over a step equal to
  ``train.sharded.step_matmul_flops`` (a row attends and unembeds its
  own rows; every row routes the domain batch): for the process, and in
  four gloo ranks on (2, 2) for each position, below the whole batch a
  row ran before; the ranks bitwise the one-process run;
* the serve launcher on (2, 2), in one process and over four gloo
  ranks, giving the 1 x 1 tokens at batches where capacity binds (routing
  each row's requests alone drops other assignments and changes them).

The tests run torch on one thread (restored after): the comparisons
hold at any count, but at these sizes more threads only wait."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro import models as jmodels
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import placement as PL
from repro_torch.launch import serve_lm
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import (decode_step, decode_step_model, forward_rows,
                                init_decode_cache)
from repro_torch.models.config import MoEConfig
from repro_torch.models.model import unembed_shards
from repro_torch.serve.step import _whole_layers
from repro_torch.train import AdamWConfig, TrainStepConfig, make_train_step
from repro_torch.train.sharded import step_matmul_flops

from test_torch_sharded_launch import (OPT, WORLD, assert_close,
                                       equal_trees, f32, fresh_state,
                                       make_batch, run_steps, shardings)

ROOT = Path(__file__).resolve().parent.parent
AXES3 = ("pod", "data", "model")
#: capacity factor 0.5: the smoke batches' MoE layers drop assignments
TIGHT = MoEConfig(n_experts=8, top_k=2, capacity_factor=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tight(arch: str = "qwen3-moe-235b-a22b"):
    return f32(arch, moe=TIGHT)


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def group_rows(mesh, axes, n: int):
    """The ``BatchRows`` of each gather group over ``axes`` (every
    position of ``mesh``'s model coordinate 0), ``n`` rows of the batch
    split evenly."""
    out = {}
    for q in mesh.local_positions():
        c = mesh.coords(q)
        if c["model"]:
            continue
        key = tuple(v for a, v in c.items() if a not in axes)
        out.setdefault(key, []).append(q)
    nd = int(np.prod([mesh.shape[a] for a in axes]))
    bounds = [(j * n // nd, (j + 1) * n // nd) for j in range(nd)]
    return [PL.BatchRows(mesh, axes, qs, bounds) for qs in out.values()]


# --- gather_rows --------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((2, 2), ("data",)), ((2, 2, 2), ("pod", "data")),
    ((2, 2, 2), ("data",))], ids=["2x2", "2x2x2 batch", "2x2x2 pods"])
def test_gather_rows_is_the_concatenation_and_its_gradient(shape, axes):
    mesh = cpu_mesh(shape, ("data", "model") if len(shape) == 2 else AXES3)
    rng = np.random.default_rng(0)
    for rows in group_rows(mesh, axes, 8):
        xs = [torch.from_numpy(rng.standard_normal((8 // len(rows.positions),
                                                    3, 5))
                               .astype(np.float32)).requires_grad_(True)
              for _ in rows.positions]
        ws = [torch.from_numpy(rng.standard_normal((8, 3, 5))
                               .astype(np.float32)) for _ in xs]
        got = PL.gather_rows(xs, rows)
        whole = torch.cat([x.detach() for x in xs])
        assert all(torch.equal(g, whole) for g in got)
        grads = torch.autograd.grad(sum((g * w).sum() for g, w in
                                        zip(got, ws)), xs)
        plain = [x.detach().clone().requires_grad_(True) for x in xs]
        want = torch.autograd.grad(sum((torch.cat(plain) * w).sum()
                                       for w in ws), plain)
        for (lo, hi), g, wg in zip(rows.ranges, grads, want):
            summed = ws[0][lo:hi]
            for w in ws[1:]:
                summed = summed + w[lo:hi]
            assert torch.equal(g, summed)
            torch.testing.assert_close(g, wg, rtol=1e-6, atol=1e-6)


def test_gather_rows_refuses_what_it_cannot_gather():
    mesh = cpu_mesh((2, 2))
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="uneven"):
        PL.gather_rows([x, x], PL.BatchRows(mesh, ("data",), [0, 2],
                                            [(0, 2), (2, 5)]))
    with pytest.raises(ValueError, match="every row"):
        PL.gather_rows([x], PL.BatchRows(mesh, ("data",), [0],
                                         [(0, 2), (2, 4)]))


# --- the model over rows -----------------------------------------------------

def test_forward_rows_is_the_references_whole_batch_forward():
    """Two rows of a (2, 1) mesh, each its 4 of 8 sequences, against
    ``repro.models.forward`` on all 8 on the same weights at capacity
    factor 0.5 (the layers drop assignments): the rows' hidden states
    and each row's aux loss (the domain batch's) within 1e-5."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(
        "qwen3-moe-235b-a22b"), dtype="float32", moe=TIGHT)
    tcfg = tight()
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (8, 16)) \
        .astype(np.int32)
    want = jmodels.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                           logits_mode="hidden")
    (rows,) = group_rows(cpu_mesh((2, 1)), ("data",), 8)
    outs = forward_rows(tcfg, [tp, tp], [
        {"tokens": torch.from_numpy(toks[lo:hi])} for lo, hi in rows.ranges],
        rows)
    got = torch.cat([o.logits for o in outs]).numpy()
    np.testing.assert_allclose(got, np.asarray(want.logits), rtol=1e-5,
                               atol=1e-5)
    for o in outs:
        np.testing.assert_allclose(float(o.aux_loss), float(want.aux_loss),
                                   rtol=1e-5)


def test_decode_step_rows_is_the_one_device_step():
    """Two rows' decode steps from position 0 (``decode_step_model`` on
    whole params and each row's whole cache, as the serve launcher's
    rows decode), each its 8 of 16 requests, against ``decode_step`` on
    all 16: logits within 1e-5 and equal greedy tokens at every step."""
    cfg = tight()
    params = fresh_state(cfg).params
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (16, 6)).astype(np.int32))
    (rows,) = group_rows(cpu_mesh((2, 1)), ("data",), 16)
    cache = init_decode_cache(cfg, 16, 6, device="cpu")
    caches = [init_decode_cache(cfg, 8, 6, device="cpu") for _ in range(2)]
    views = [_whole_layers(c, PL.ModelRow(rows.mesh, q, home), rng)
             for c, q, home, rng in zip(caches, rows.positions, rows.homes,
                                        rows.ranges)]
    with torch.inference_mode():
        for t in range(6):
            want, _ = decode_step(cfg, params, cache, toks[:, t:t + 1], t)
            hs = decode_step_model(cfg, [params] * 2, views,
                                   [toks[lo:hi, t:t + 1]
                                    for lo, hi in rows.ranges], t, rows)
            got = torch.cat([unembed_shards(cfg, params, h)[0][0]
                             for h in hs])
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(got.argmax(-1), want.argmax(-1))


# --- the sharded step ---------------------------------------------------------

STEP_CASES = {
    "2x2": ((2, 2), ("data", "model"), {}),
    "4x1": ((4, 1), ("data", "model"), {}),
    "2x2 mb2": ((2, 2), ("data", "model"), dict(n_microbatches=2)),
    # the pod meshes' quantized sync at bound 1e-4, as in
    # test_torch_sharded_launch's pod test: an f32 sum in another order
    # moves a gradient at the quantizer's rounding edge by one code
    "pods 2x1x2": ((2, 1, 2), AXES3, dict(grad_compress=True, n_pods=2,
                                          grad_compress_bound=1e-4)),
    "pods 2x2x1": ((2, 2, 1), AXES3, dict(grad_compress=True, n_pods=2,
                                          grad_compress_bound=1e-4)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_moe_rows_match_the_one_device_step(case):
    """3 steps of qwen3-moe's smoke config at capacity factor 0.5, its
    rows in lockstep (on (2, 1, 2) a pod's one row alone), against the
    one-device step (the pod loop under ``grad_compress``)."""
    shape, axes, kw = STEP_CASES[case]
    cfg = tight()
    tcfg = TrainStepConfig(**kw)
    want, wm = run_steps(cfg, None, fresh_state(cfg), tcfg=tcfg)
    got, gm = run_steps(cfg, cpu_mesh(shape, axes), fresh_state(cfg),
                        tcfg=tcfg)
    assert_close(want, got, wm, gm)


def step_flops(cfg, mesh, tcfg) -> int:
    fn = make_train_step(cfg, tcfg, AdamWConfig(**OPT), mesh=mesh)
    state = PL.place_tree(fresh_state(cfg), shardings(cfg, mesh))
    with FlopCounterMode(display=False) as fc:
        fn(state, make_batch(cfg, 10))
    return fc.get_total_flops()


@pytest.mark.parametrize("shape,kw", [
    ((1, 1), {}), ((1, 1), dict(remat=False)), ((2, 2), {}), ((4, 1), {}),
    ((2, 2), dict(n_microbatches=2))],
    ids=["1x1", "1x1 no remat", "2x2", "4x1", "2x2 mb2"])
def test_a_rows_attention_sees_only_its_own_rows(shape, kw):
    """The process's matmul FLOPs of one step are the reckoning of dp
    rows, each attending and unembedding its own rows and routing the
    domain's microbatch at every MoE layer; below dp rows each running
    the whole batch's forward (past one row)."""
    dp, tp = shape
    cfg = tight()
    tcfg = TrainStepConfig(**kw)
    mesh = cpu_mesh(shape) if dp * tp > 1 else make_host_mesh("cpu")
    mb = tcfg.n_microbatches
    want = dp * step_matmul_flops(cfg, 8 // dp, 16, tp, local=tp,
                                  remat=tcfg.remat, moe_rows=8 // mb,
                                  microbatches=mb)
    assert step_flops(cfg, mesh, tcfg) == want
    if dp > 1:
        assert want < dp * step_matmul_flops(cfg, 8, 16, tp, local=tp,
                                             remat=tcfg.remat,
                                             moe_rows=8 // mb,
                                             microbatches=mb)


# --- four gloo processes ------------------------------------------------------

GLOO_MESH = ((2, 2), ("data", "model"))
SERVE_ARGV = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--batch", "32",
              "--new-tokens", "6"]

_GLOO_WORKER = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[3])
    import test_torch_moe_rows as T
    from repro_torch.launch import serve_lm
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.train import TrainStepConfig

    rank, rdv = int(sys.argv[1]), sys.argv[2]
    init_distributed(coordinator_address="file://" + rdv,
                     num_processes=T.WORLD, process_id=rank, backend="gloo")
    mesh = make_mesh(*T.GLOO_MESH)
    out = {"steps": T.gloo_steps(mesh),
           "flops": T.step_flops(T.tight(), mesh, TrainStepConfig()),
           "tokens": serve_lm.main(T.SERVE_ARGV, device="cpu", mesh=mesh)}
    torch.save(out, f"{rdv}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
''')


def gloo_steps(mesh):
    cfg = tight()
    return run_steps(cfg, mesh, fresh_state(cfg))


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    rdv = str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r),
                               rdv, str(ROOT / "tests")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc, _ in errs), errs
    return [torch.load(f"{rdv}.rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_gloo_moe_ranks_are_the_one_process_run(gloo_ranks):
    want, wm = gloo_steps(cpu_mesh(*GLOO_MESH))
    for r, got in enumerate(gloo_ranks):
        state, metrics = got["steps"]
        assert equal_trees(state, want), r
        assert metrics == wm, r


def test_gloo_moe_ranks_compute_their_share(gloo_ranks):
    """Each rank's matmul FLOPs are its position's reckoning: its row's
    4 sequences attended and unembedded, the 8 routed, its model shard's
    experts; fewer than its row running the forward of all 8."""
    cfg = tight()
    for r, got in enumerate(gloo_ranks):
        want = step_matmul_flops(cfg, 4, 16, 2, moe_rows=8)
        assert got["flops"] == want, r
        assert want < step_matmul_flops(cfg, 8, 16, 2)


def test_gloo_moe_serve_gives_the_one_device_tokens(gloo_ranks):
    want = serve_lm.main(SERVE_ARGV, device="cpu")
    for r, got in enumerate(gloo_ranks):
        assert torch.equal(got["tokens"], want), r


# --- the serve launcher -------------------------------------------------------

@pytest.mark.parametrize("arch,batch", [("qwen3-moe-235b-a22b", 32),
                                        ("qwen3-moe-235b-a22b", 128),
                                        ("grok-1-314b", 128)])
def test_serve_launcher_moe_rows_give_the_one_device_tokens(arch, batch):
    """At these batches the decode steps' capacity binds: each row's
    requests routed alone drop other assignments than the whole batch
    routed at once (the tokens differ); the rows in lockstep route the
    whole batch at every MoE layer."""
    argv = ["--arch", arch, "--smoke", "--batch", str(batch),
            "--new-tokens", "6"]
    want = serve_lm.main(argv, device="cpu")
    got = serve_lm.main(argv, device="cpu", mesh=cpu_mesh((2, 2)))
    assert torch.equal(got, want)
