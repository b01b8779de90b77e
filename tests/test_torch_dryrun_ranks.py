"""The dry-run's rank (``launch.mesh.dry_rank``: one position of a mesh on
``meta``, no process group) against real ranks, on the CPU.

Four gloo processes run each case below as the ranks of its mesh, then,
with the group down, their positions of the same case as dry ranks. The
cases: the sharded train step of smollm's smoke config on (2, 2) with
FSDP params (``param_shardings(zero1=True)``), of qwen3-moe's under
expert parallelism on (1, 4) (8 x 520 tokens: EP engages above 4,096),
the pods' compressed sync on (2, 1, 2) (params placed as the dry-run
places them under ``REPRO_GRAD_COMPRESS``), whisper's with 2 heads on
(1, 4) (two shards without a head, whose cross-attention still sends
its memory's gradient), and a prefill plus one decode step of
``serve.sharded`` for smollm's and hymba's smoke configs on (2, 2). At
every position of every case:

* (a) the dry rank's collectives (``distributed.collectives``: kind,
  count, bytes) equal the real rank's exactly;
* (b) its FLOPs (``FlopCounterMode``) equal the real rank's, and a train
  step's equal ``train.sharded.step_matmul_flops(position=)``;
* (c) ``dryrun.LiveBytes`` counts alike on meta and on CPU tensors (the
  dense train case, one process holding every position), and the dry
  rank's outputs are the real rank's;
* (d) ``run_cell`` writes the reference's record keys: ``collectives``
  those of ``repro.launch.dryrun.collective_stats`` (read in a child:
  importing the reference's dry-run sets its 512-device ``XLA_FLAGS``),
  ``memory`` its four ``*_gb``.

The numbers are not compared with the reference's HLO: its partitioner
schedules its collectives its own way (reduce-scatters, fused
all-reduces), the port its own (an all-gather and an ordered sum, so
ranks give one process's bits), by design."""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro_torch import tree
from repro_torch.distributed import placement as PL
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import dry_rank, make_mesh
from repro_torch.models import layers
from repro_torch.models.config import MoEConfig
from repro_torch.serve.sharded import (make_sharded_prefill,
                                       make_sharded_serve_step,
                                       serve_param_shardings)
from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                               make_train_step)
from repro_torch.train.sharded import step_matmul_flops

from test_torch_sharded_launch import OPT, f32, fresh_state, make_batch

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
AX2 = ("data", "model")
AX3 = ("pod", "data", "model")

#: (config, mesh shape, axes, what runs, options): "train" one step of
#: a batch of 8 x ``seq`` (``zero1``: FSDP params; ``tcfg``: the step's
#: config; ``ep``: under ``MOE_EP_MODE``; ``gc``: params placed as the
#: dry-run's under grad compression), "serve" a prefill of 4 x 12 tokens
#: into 24 positions and one decode step
CASES = {
    "dense 2x2": (("smollm-135m", {}), (2, 2), AX2, "train",
                  dict(seq=16, zero1=True)),
    "moe ep 1x4": (("qwen3-moe-235b-a22b", dict(moe=MoEConfig(8, 2, 2.0))),
                   (1, 4), AX2, "train", dict(seq=520, ep=True)),
    "pods 2x1x2": (("smollm-135m", {}), (2, 1, 2), AX3, "train",
                   dict(seq=16, gc=True, tcfg=dict(grad_compress=True,
                                                   n_pods=2))),
    "whisper 1x4": (("whisper-base", dict(n_heads=2, n_kv_heads=2)),
                    (1, 4), AX2, "train", dict(seq=16)),
    "serve dense 2x2": (("smollm-135m", {}), (2, 2), AX2, "serve", {}),
    "serve hymba 2x2": (("hymba-1.5b", dict(n_layers=4)), (2, 2), AX2,
                        "serve", {}),
}


def case_cfg(name: str):
    arch, kw = CASES[name][0]
    return f32(arch, **kw)


def _on(x, dry: bool):
    return tree.tree_map(lambda t: t.to("meta"), x) if dry else x


def run_case(name: str, mesh) -> dict:
    """{phase: ``dryrun.measure``'s record} of the case on ``mesh`` (a
    rank of a process group, or a dry rank: the same seeded inputs,
    moved to ``meta``); the arguments' bytes are the rank's placed
    shards and its rows of the batch."""
    cfg = case_cfg(name)
    _, _, _, kind, opts = CASES[name]
    dry = mesh.device_at(mesh.local_positions()[0]).type == "meta"
    old = layers.MOE_EP_MODE
    layers.MOE_EP_MODE = bool(opts.get("ep"))
    try:
        with mesh:
            if kind == "train":
                return {"train": _train(cfg, mesh, opts, dry)}
            return _serve(cfg, mesh, dry)
    finally:
        layers.MOE_EP_MODE = old


def _train(cfg, mesh, opts, dry: bool) -> dict:
    tcfg = TrainStepConfig(**opts.get("tcfg", {}))
    gc = opts.get("gc", False)
    shardings = TrainState(
        S.param_shardings(cfg, mesh, zero1=opts.get("zero1", gc),
                          data_only=gc, replicate_embed=gc),
        S.opt_state_shardings(cfg, mesh))
    state = PL.place_tree(_on(fresh_state(cfg), dry), shardings)
    batch = _on(make_batch(cfg, 10, S_=opts["seq"]), dry)
    fn = make_train_step(cfg, tcfg, AdamWConfig(**OPT), mesh=mesh)
    args = dryrun.local_bytes(state) + S.shard_bytes(
        batch, S.batch_shardings(batch, cfg, mesh))
    return dryrun.measure(lambda: fn(state, batch), args)


def _serve(cfg, mesh, dry: bool) -> dict:
    from repro_torch.models import init_params
    params = _on(init_params(cfg, torch.Generator().manual_seed(4), "cpu"),
                 dry)
    g = torch.Generator().manual_seed(5)
    batch = _on({"tokens": torch.randint(0, cfg.vocab, (4, 12), generator=g,
                                         dtype=torch.int32)}, dry)
    placed = PL.place_tree(params, serve_param_shardings(cfg, mesh))
    args = dryrun.local_bytes(placed)
    prefill = make_sharded_prefill(cfg, mesh, max_len=24)
    out, got = {}, {}
    out["prefill"] = dryrun.measure(
        lambda: got.setdefault("p", prefill(placed, batch)), args)
    cache = got["p"][0]
    step = make_sharded_serve_step(cfg, mesh)
    tok = batch["tokens"][:, -1:]
    out["decode"] = dryrun.measure(lambda: step(placed, cache, tok, 12),
                                   args + dryrun.local_bytes(cache))
    return out


def rank_runs(mesh_of) -> dict:
    """Every case's ``run_case`` on ``mesh_of(shape, axes)``."""
    return {name: run_case(name, mesh_of(c[1], c[2]))
            for name, c in CASES.items()}


_GLOO_WORKER = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[3])
    import test_torch_dryrun_ranks as T
    from repro_torch.launch.mesh import dry_rank, init_distributed, make_mesh

    rank, rdv = int(sys.argv[1]), sys.argv[2]
    init_distributed(coordinator_address="file://" + rdv,
                     num_processes=T.WORLD, process_id=rank, backend="gloo")
    real = T.rank_runs(make_mesh)
    torch.distributed.destroy_process_group()
    # the same position as a dry rank, with no process group up
    dry = T.rank_runs(lambda shape, axes: dry_rank(shape, axes, rank))
    torch.save({"real": real, "dry": dry}, f"{rdv}.rank{rank}.pt")
''')

#: the reference's ``collective_stats`` keys, printed by a child (importing
#: the reference's dry-run sets its 512-device ``XLA_FLAGS``)
_REF_KEYS = ("import json; from repro.launch.dryrun import collective_stats;"
             " print(json.dumps(sorted(collective_stats(''))))")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{"real": each gloo rank's ``rank_runs``, "dry": each position's
    dry rank's (run by the same process once its group is down),
    "ref_keys": the reference's collective keys}."""
    tmp = tmp_path_factory.mktemp("gloo_dryrun")
    rdv = str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r),
                               rdv, str(ROOT / "tests")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REF_KEYS], cwd=ROOT,
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc, _, _ in outs), [(rc, e) for rc, _, e in outs]
    got = [torch.load(f"{rdv}.rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return {"real": [g["real"] for g in got], "dry": [g["dry"] for g in got],
            "ref_keys": set(json.loads(outs[-1][1].strip().splitlines()[-1]))}


def _phases(ranks, name):
    real, dry = ranks["real"], ranks["dry"]
    for r in range(WORLD):
        for phase in real[r][name]:
            yield r, phase, real[r][name][phase], dry[r][name][phase]


@pytest.mark.parametrize("name", list(CASES))
def test_dry_rank_counts_the_real_ranks_collectives(ranks, name):
    for r, phase, real, dry in _phases(ranks, name):
        assert dry["collectives"] == real["collectives"], (name, r, phase)
        assert real["collectives"]["total_count"] > 0, (name, r, phase)


@pytest.mark.parametrize("name", list(CASES))
def test_dry_rank_counts_the_real_ranks_flops(ranks, name):
    for r, phase, real, dry in _phases(ranks, name):
        assert dry["flops"] == real["flops"] > 0, (name, r, phase)


def _reckoned(name: str, mesh, r: int) -> int:
    """``step_matmul_flops`` of position ``r`` of a train case."""
    _, shape, axes, _, opts = CASES[name]
    cfg = case_cfg(name)
    sizes = dict(zip(axes, shape))
    tcfg = TrainStepConfig(**opts.get("tcfg", {}))
    pods = sizes.get("pod", 1) if tcfg.grad_compress else 1
    nd = sizes["data"] * (1 if tcfg.grad_compress else sizes.get("pod", 1))
    m = 8 // pods
    rows = m if m % nd or m < nd else m // nd
    if opts.get("ep"):
        return step_matmul_flops(cfg, rows, opts["seq"], sizes["model"],
                                 position=mesh.coords(r)["model"],
                                 ep_rows=nd)
    return step_matmul_flops(cfg, rows, opts["seq"], sizes["model"],
                             position=mesh.coords(r)["model"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[3] == "train"])
def test_dry_rank_flops_are_the_reckoning(ranks, name):
    _, shape, axes, _, _ = CASES[name]
    for r, _, _, dry in _phases(ranks, name):
        want = _reckoned(name, dry_rank(shape, axes, r), r)
        assert dry["flops"] == want, (name, r)


@pytest.mark.parametrize("name", list(CASES))
def test_dry_rank_peak_and_outputs_are_the_real_ranks(ranks, name):
    """The same outputs; the real rank's peak at least the dry rank's:
    c10d holds a collective's buffers until the next collective starts,
    a little after the last reference to them goes, which a dry rank
    (nothing issued) does not see."""
    for r, phase, real, dry in _phases(ranks, name):
        assert dry["output_bytes"] == real["output_bytes"], (name, r, phase)
        assert dry["peak_bytes"] <= real["peak_bytes"], (name, r, phase)


def test_live_bytes_counts_alike_on_meta_and_on_the_cpu():
    """(c) The dense train case on one process holding every position of
    its mesh (no collective: copies), once on CPU tensors and once on
    meta: the same peak, outputs and FLOPs, and the peak above the
    arguments'."""
    name = "dense 2x2"
    _, shape, axes, _, _ = CASES[name]
    n = math.prod(shape)
    cpu, meta = (run_case(name, make_mesh(shape, axes, devices=[d] * n))
                 for d in ("cpu", "meta"))
    for phase, want in cpu.items():
        got = meta[phase]
        for k in ("peak_bytes", "output_bytes", "flops"):
            assert got[k] == want[k], (phase, k)
        assert got["peak_bytes"] > got["output_bytes"] > 0


#: (arch, config overrides, model axis, rows, seq) of the reckoning's
#: check on the one-process step: gemma2 (softcaps: the chunked oracle),
#: llava (its image prefix) and whisper (encoder, cross-attention), a
#: head a shard where a shard's heads cut a KV group, and sequences past
#: one 256-row tile of the plain attention (whisper's shards without a
#: head: the "whisper 1x4" case above)
RECKONED = [("gemma2-9b", {}, 4, 2, 16), ("gemma2-9b", {}, 2, 1, 260),
            ("llava-next-34b", {}, 4, 2, 16),
            ("llava-next-34b", {}, 2, 1, 260),
            ("whisper-base", {}, 2, 1, 260)]


@pytest.mark.parametrize("arch,kw,tp,rows,seq", RECKONED)
def test_reckoning_covers_gemma2_llava_and_whisper(arch, kw, tp, rows, seq):
    """``step_matmul_flops`` of a (1, tp) row is ``FlopCounterMode``'s
    count of the one-process sharded step (``local=tp``), and each
    position's that of its dry rank (``position=j``)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = f32(arch, **kw)

    def step_flops(mesh):
        state = _on(fresh_state(cfg), mesh.multi_process)
        batch = _on(make_batch(cfg, 3, B=rows, S_=seq), mesh.multi_process)
        state = PL.place_tree(state, TrainState(
            S.param_shardings(cfg, mesh),
            S.opt_state_shardings(cfg, mesh, zero1=True)))
        fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**OPT),
                             mesh=mesh)
        with FlopCounterMode(display=False) as fc:
            fn(state, batch)
        return fc.get_total_flops()
    one = step_flops(make_mesh((1, tp), AX2, devices=["cpu"] * tp))
    assert one == step_matmul_flops(cfg, rows, seq, tp, local=tp)
    for j in range(tp):
        assert step_flops(dry_rank((1, tp), AX2, j)) == step_matmul_flops(
            cfg, rows, seq, tp, position=j), j


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b"])
def test_fsdp_params_train_as_the_model_split(arch):
    """The dry-run's FSDP placement (``param_shardings(zero1=True)``:
    params split over the batch axes too, as the moments are) trains as
    params at their model split: two steps on a one-process (2, 2) CPU
    mesh give the same losses and params, bit for bit, and each FSDP
    leaf stays at its own spec."""
    cfg = f32(arch)
    mesh = make_mesh((2, 2), AX2, devices=["cpu"] * 4)
    runs = []
    for zero1 in (False, True):
        shard = TrainState(S.param_shardings(cfg, mesh, zero1=zero1),
                           S.opt_state_shardings(cfg, mesh))
        state = PL.place_tree(fresh_state(cfg), shard)
        fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(**OPT),
                             mesh=mesh)
        losses = []
        for i in range(2):
            state, m = fn(state, make_batch(cfg, 20 + i))
            losses.append(float(m["loss"]))
        assert all(a.sharding.spec == b.spec for a, b in zip(
            tree.leaves(state.params), tree.leaves(shard.params)))
        runs.append((losses, PL.gather_tree(state.params)))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for a, b in zip(tree.leaves(p0), tree.leaves(p1)):
        assert torch.equal(a, b)


def test_live_bytes_counts_new_storages_until_freed():
    with dryrun.LiveBytes() as live:
        a = torch.empty(1000, device="meta")          # 4,000 bytes
        b = a[10:].view(2, 495)                       # a view: nothing
        a.add_(1.0)                                    # in place: nothing
        c = torch.ones(500, dtype=torch.float64, device="meta") * 2
        del a, b
        d = torch.empty(100, dtype=torch.int8, device="meta")
    assert live.peak == 4000 + 2 * 4000 and live.live == 4000 + 100
    del c, d
    assert live.live == 0


def test_run_cell_writes_the_references_keys(ranks):
    from test_torch_specs_dryrun import CHEAP_CELL
    res = dryrun.run_cell(*CHEAP_CELL)
    assert res["status"] == "ok", res.get("trace")
    want = ranks["ref_keys"]
    assert set(res["collectives"]) == want
    mem = res["memory"]
    assert {"argument_size_gb", "output_size_gb", "temp_size_gb",
            "peak_gb"} <= set(mem)
    assert mem["peak_bytes"] >= mem["argument_size_bytes"]
    assert mem["temp_size_bytes"] == (mem["peak_bytes"]
                                      - mem["argument_size_bytes"])
    assert res["collectives"]["entry_bytes"] == \
        res["collectives"]["total_bytes"] > 0
    assert res["position"] == {"data": 0, "model": 1}
