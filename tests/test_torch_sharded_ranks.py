"""The LM launchers' sharded execution across processes and meshes
on the CPU (the second half of ``test_torch_sharded_launch``, whose
helpers and tolerances it shares):

* four gloo processes on (2, 2), (1, 4) with microbatches and a
  ``(2, 1, 2)`` pod mesh with ``grad_compress``, granite on (2, 2), and
  xLSTM on (1, 4) and hymba on (2, 2) with their recurrent layers split:
  every rank bitwise the one-process run and its matmul FLOPs those
  reckoned for one position; a checkpoint rank 0 writes;
  ``make_production_mesh`` and the pod path of ``make_grad_fn`` raise
  under a group of 4;
* checkpoints written on (2, 2) restore bitwise on 1 x 1 and the other
  way round, in the one-device format's bytes;
* the launchers with ``mesh=``: train improves and resumes across 1 x 1
  and (2, 2); serve's tokens equal the 1 x 1 run's."""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_threads import one_thread  # noqa: F401
from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager, save_checkpoint
from repro_torch.checkpoint.manager import restore_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import placement as PL
from repro_torch.launch import serve_lm
from repro_torch.launch import specs as S
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                               make_train_step)
from repro_torch.train.sharded import step_matmul_flops

from test_torch_sharded_launch import (OPT, WORLD, cpu_mesh, equal_trees,
                                       f32, fresh_state, make_batch,
                                       run_steps, shardings)

ROOT = Path(__file__).resolve().parent.parent


# --- four gloo processes ----------------------------------------------------

GLOO_CASES = {
    "2x2": ("smollm-135m", ((2, 2), ("data", "model")), {}),
    "1x4 mb2": ("smollm-135m", ((1, 4), ("data", "model")),
                dict(n_microbatches=2)),
    "pods 2x1x2": ("smollm-135m", ((2, 1, 2), ("pod", "data", "model")),
                   dict(grad_compress=True, n_pods=2)),
    "granite 2x2": ("granite-8b", ((2, 2), ("data", "model")), {}),
    "xlstm 1x4": ("xlstm-1.3b", ((1, 4), ("data", "model")), {}),
    "hymba 2x2": ("hymba-1.5b", ((2, 2), ("data", "model")), {}),
}


def gloo_case(name: str, devices=None):
    """The case's 3 steps (its smoke config, f32) on its mesh: (state,
    gathered; metrics)."""
    arch, (shape, axes), kw = GLOO_CASES[name]
    cfg = f32(arch)
    mesh = make_mesh(shape, axes, devices=devices)
    return run_steps(cfg, mesh, fresh_state(cfg), tcfg=TrainStepConfig(**kw))


def gloo_flops(name: str) -> int:
    """The matmul FLOPs ``FlopCounterMode`` counts in this process over
    one step of the case (a rank's: its position's share)."""
    from torch.utils.flop_counter import FlopCounterMode
    arch, (shape, axes), kw = GLOO_CASES[name]
    cfg = f32(arch)
    mesh = make_mesh(shape, axes)
    fn = make_train_step(cfg, TrainStepConfig(**kw), AdamWConfig(**OPT),
                         mesh=mesh)
    state = PL.place_tree(fresh_state(cfg), shardings(cfg, mesh))
    with FlopCounterMode(display=False) as fc:
        fn(state, make_batch(cfg, 10))
    return fc.get_total_flops()


def reckoned_flops(name: str, tp=None, position=None) -> int:
    """``step_matmul_flops`` of one position of the case (on a model
    axis of ``tp``, default the case's; at model coordinate
    ``position``): its data row's rows of the batch of 8 (each pod's
    half, split over ``data``)."""
    arch, (shape, axes), kw = GLOO_CASES[name]
    sizes = dict(zip(axes, shape))
    tcfg = TrainStepConfig(**kw)
    m = 8 // sizes.get("pod", 1) // tcfg.n_microbatches
    nd = sizes["data"]
    rows = (m if m % nd or m < nd else m // nd) * tcfg.n_microbatches
    return step_matmul_flops(f32(arch), rows, 16, tp or sizes["model"],
                             position=position, remat=tcfg.remat)


_GLOO_WORKER = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[3])
    import test_torch_sharded_ranks as T
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.distributed import placement as PL
    from repro_torch.train import TrainStepConfig
    from repro_torch.train.step import make_grad_fn

    rank, rdv = int(sys.argv[1]), sys.argv[2]
    init_distributed(coordinator_address="file://" + rdv,
                     num_processes=T.WORLD, process_id=rank, backend="gloo")
    out = {name: T.gloo_case(name) for name in T.GLOO_CASES}
    out["flops"] = {name: T.gloo_flops(name) for name in T.GLOO_CASES}
    mesh = make_mesh((2, 2), ("data", "model"))
    out["local"] = mesh.local_positions()
    cfg = T.f32("smollm-135m")
    placed = PL.place_tree(T.fresh_state(cfg), T.shardings(cfg, mesh))
    out["resident"] = PL.resident_bytes(placed)
    save_checkpoint(rdv + ".ckpt", 3, placed)
    for what, fn in (
            ("production", make_production_mesh),
            ("pod loop", lambda: make_grad_fn(
                cfg, TrainStepConfig(grad_compress=True, n_pods=2))(
                    T.fresh_state(cfg).params, T.make_batch(cfg, 0)))):
        try:
            fn()
        except ValueError as e:
            out[what] = str(e)
    torch.save(out, f"{rdv}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
''')


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
    return rdv, [torch.load(f"{rdv}.rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]


@pytest.mark.parametrize("name", list(GLOO_CASES))
def test_gloo_ranks_are_the_one_process_run(gloo_ranks, name):
    want, wm = gloo_case(name, devices=["cpu"] * WORLD)
    for r, got in enumerate(gloo_ranks[1]):
        state, metrics = got[name]
        assert equal_trees(state, want), (name, r)
        assert metrics == wm, (name, r)


@pytest.mark.parametrize("name", list(GLOO_CASES))
def test_gloo_ranks_compute_their_share(gloo_ranks, name):
    """Each rank's matmul FLOPs of one step (``FlopCounterMode``) are the
    count reckoned from the shapes for its own position: the layers
    split over ``model`` (``tp_layout``) at its shard's part of their
    work (smollm's 3/1 heads fall 1 and 2 to the shards of 2, none, 1, 1
    and 1 to those of 4), the rest whole: fewer than the same rows take
    unsplit."""
    _, (shape, axes), _ = GLOO_CASES[name]
    mesh = make_mesh(shape, axes, devices=["cpu"] * WORLD)
    for r, got in enumerate(gloo_ranks[1]):
        want = reckoned_flops(name, position=mesh.coords(r)["model"])
        assert got["flops"][name] == want, (name, r)
        assert want < reckoned_flops(name, tp=1)


def test_gloo_ranks_hold_one_position_each(gloo_ranks):
    cfg = f32("smollm-135m")
    mesh = cpu_mesh("2x2")
    want = S.shard_bytes(TrainState(S.param_structs(cfg),
                                    S.opt_state_structs(cfg)),
                         shardings(cfg, mesh))
    for r, got in enumerate(gloo_ranks[1]):
        assert got["local"] == [r]
        assert got["resident"] == {r: want}


def test_gloo_checkpoint_is_the_one_device_checkpoint(gloo_ranks, tmp_path):
    """Rank 0 wrote the gathered state: the one-device save's manifest
    tensors (sha1 of every file) and a bitwise restore on 1 x 1."""
    rdv, _ = gloo_ranks
    cfg = f32("smollm-135m")
    state = fresh_state(cfg)
    one = save_checkpoint(tmp_path, 3, state)
    multi = Path(rdv + ".ckpt") / one.name
    tensors = [json.loads((p / "manifest.json").read_text())["tensors"]
               for p in (one, multi)]
    assert tensors[0] == tensors[1]
    got, step = restore_checkpoint(Path(rdv + ".ckpt"), state)
    assert step == 3 and equal_trees(got, state)


def test_gloo_group_of_four_refuses_the_production_mesh_and_pod_loop(
        gloo_ranks):
    for got in gloo_ranks[1]:
        assert "256 positions" in got["production"]
        assert "pod subgroup" in got["pod loop"]


# --- checkpoints across meshes ----------------------------------------------

def _files_sha1(path: Path) -> dict:
    return {f.name: hashlib.sha1(f.read_bytes()).hexdigest()
            for f in sorted(path.iterdir()) if f.suffix == ".bin"}


@pytest.mark.parametrize("src,dst", [("2x2", "1x1"), ("1x1", "2x2"),
                                     ("2x2", "2x2x2")])
def test_checkpoints_restore_across_meshes(src, dst, tmp_path):
    cfg = f32("hymba-1.5b")
    meshes = {"1x1": make_host_mesh("cpu"), "2x2": cpu_mesh("2x2"),
              "2x2x2": cpu_mesh("2x2x2")}
    state = fresh_state(cfg)
    placed = PL.place_tree(state, shardings(cfg, meshes[src]))
    path = CheckpointManager(tmp_path / "a", save_every=1).maybe_save(
        2, placed)
    plain = save_checkpoint(tmp_path / "b", 2, state)
    assert _files_sha1(path) == _files_sha1(plain)
    got, step = CheckpointManager(tmp_path / "a").restore_latest(
        placed, shardings=shardings(cfg, meshes[dst]))
    assert step == 2 and PL.is_placed(got)
    assert tree.leaves(got)[0].mesh is meshes[dst]
    assert equal_trees(PL.gather_tree(got), state)


# --- the launchers ----------------------------------------------------------

def test_train_launcher_on_a_mesh_improves_and_resumes_across_meshes(
        tmp_path, capsys):
    base = ["--arch", "smollm-135m", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "32", "--lr", "1e-2", "--device", "cpu",
            "--log-every", "4"]
    argv = base + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "4"]
    mesh = cpu_mesh("2x2")
    run = tlaunch.main(argv, mesh=mesh)
    out = capsys.readouterr().out.strip().splitlines()
    assert "mesh={'data': 2, 'model': 2}" in out[0]
    assert '"improved": true' in out[-1]
    assert run.losses[-1] < run.losses[0] and run.mesh is mesh
    cfg = get_smoke_config("smollm-135m")
    want = S.shard_bytes(TrainState(S.param_structs(cfg),
                                    S.opt_state_structs(cfg)),
                         shardings(cfg, mesh))
    assert run.resident_bytes == {q: want for q in range(4)}
    one = tlaunch.main(base)
    np.testing.assert_allclose(run.losses, one.losses, rtol=1e-2)
    # resume on 1 x 1 from the (2, 2) step-4 checkpoint, and back
    import shutil
    shutil.rmtree(tmp_path / "ck" / "step_0000000008")
    again = tlaunch.main(argv + ["--resume"])
    assert again.start_step == 4 and again.mesh.size == 1
    np.testing.assert_allclose(again.losses, run.losses[4:], rtol=1e-2)
    shutil.rmtree(tmp_path / "ck" / "step_0000000008")
    back = tlaunch.main(argv + ["--resume"], mesh=cpu_mesh("4x1"))
    assert back.start_step == 4
    np.testing.assert_allclose(back.losses, run.losses[4:], rtol=1e-2)


@pytest.mark.parametrize("arch,batch", [("smollm-135m", 4),
                                        ("qwen3-moe-235b-a22b", 4),
                                        ("xlstm-1.3b", 3)])
def test_serve_launcher_on_a_mesh_gives_the_one_device_tokens(arch, batch,
                                                              capsys):
    argv = ["--arch", arch, "--smoke", "--batch", str(batch),
            "--new-tokens", "6"]
    want = serve_lm.main(argv, device="cpu")
    got = serve_lm.main(argv, device="cpu", mesh=cpu_mesh("2x2"))
    assert torch.equal(got, want)
    assert "mesh={'data': 2, 'model': 2}" in capsys.readouterr().out


def test_production_mesh_without_a_group_needs_256_cards():
    assert not dist.is_initialized()
    with pytest.raises((ValueError, RuntimeError)):
        make_production_mesh()
