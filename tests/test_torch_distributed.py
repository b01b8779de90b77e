"""Multi-process pieces of the port: ``launch.mesh.init_distributed`` and
the compressed gradient all-reduce across processes
(``distributed.compression.compressed_all_reduce_tree``, and the train
step's pod path over a process group).

Four child processes join one ``gloo`` group through a ``file://``
rendezvous under the test's temporary directory (no port). Each takes
one pod's gradient tree and its shard of a batch; every rank's sum, and
every rank's train step, must equal the one-process
``compressed_psum_tree`` over the same four pods, and the one-process
step, bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.compression import compressed_psum_tree
from repro_torch.launch.mesh import init_distributed
from repro_torch.train import (AdamWConfig, TrainStepConfig,
                               make_train_step)
from repro_torch.train.step import init_train_state

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4


def pod_grads(pod: int):
    """Pod ``pod``'s gradient tree: f32 and bf16 leaves, seeded."""
    rng = np.random.default_rng(10 + pod)
    return {"a": torch.from_numpy(rng.normal(size=(64, 32))
                                  .astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.normal(size=(128,)) * 1e-3
                                        ).to(torch.bfloat16),
                  "d": torch.from_numpy(rng.normal(size=(3, 5, 7)) * 50
                                        ).float()}}


def train_setup():
    cfg = dataclasses.replace(get_smoke_config("smollm_135m"),
                              dtype="float32")
    tcfg = TrainStepConfig(remat=False, grad_compress=True, n_pods=WORLD)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (WORLD * 2, 17))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return cfg, tcfg, state, batch


_WORKER = textwrap.dedent('''
    import sys
    import torch
    sys.path.insert(0, sys.argv[3])
    from test_torch_distributed import WORLD, pod_grads, train_setup
    from repro_torch.distributed.compression import (
        compressed_all_reduce_tree)
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.train import AdamWConfig, make_train_step

    rank, rdv = int(sys.argv[1]), sys.argv[2]
    kw = dict(coordinator_address="file://" + rdv, num_processes=WORLD,
              process_id=rank, backend="gloo")
    assert init_distributed(**kw) and init_distributed(**kw)
    out = {"sum16": compressed_all_reduce_tree(pod_grads(rank)),
           "sum8": compressed_all_reduce_tree(pod_grads(rank), bits=8)}
    cfg, tcfg, state, batch = train_setup()
    step = make_train_step(cfg, tcfg, AdamWConfig(warmup_steps=1))
    state, metrics = step(state, batch)
    out.update(params=state.params, metrics=metrics)
    torch.save(out, f"{rdv}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    rdv = str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), rdv,
                               str(ROOT / "tests")], cwd=ROOT, env=env,
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
    return [torch.load(f"{rdv}.rank{r}.pt") for r in range(WORLD)]


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("bits", [16, 8])
def test_all_reduce_equals_one_process_sum(ranks, bits):
    want = compressed_psum_tree([pod_grads(p) for p in range(WORLD)],
                                bits=bits)
    for r, got in enumerate(ranks):
        assert _equal(got[f"sum{bits}"], want), f"rank {r}"


def test_train_step_pod_path_across_ranks_equals_one_process(ranks):
    cfg, tcfg, state, batch = train_setup()
    step = make_train_step(cfg, tcfg, AdamWConfig(warmup_steps=1))
    state, metrics = step(state, batch)
    for r, got in enumerate(ranks):
        assert _equal(got["params"], state.params), f"rank {r}"
        for k, v in metrics.items():
            assert torch.equal(got["metrics"][k], v), (r, k)


def test_init_distributed_without_a_request(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed(coordinator_address="localhost:1",
                            num_processes=1, process_id=0) is False
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert init_distributed() is False           # no address either
    assert not dist.is_initialized()


def test_init_distributed_needs_a_rank(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="rank"):
        init_distributed(coordinator_address="localhost:1", num_processes=2)
    assert not dist.is_initialized()
