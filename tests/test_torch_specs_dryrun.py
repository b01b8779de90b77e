"""The port's dry-run specs (``repro_torch.launch.specs``) and dry-run
(``repro_torch.launch.dryrun``) against the reference's.

One child process with 512 placeholder devices (the reference's
production meshes need them) dumps the reference's parameter, optimizer,
cache and batch stand-ins with their shardings' specs and shard shapes,
for every arch x input shape x production mesh, and the reference's
``cell_is_applicable``; the port's specs on its meta tensors must match
leaf by leaf.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES, ShapeConfig, shape_by_name

ROOT = Path(__file__).resolve().parent.parent

#: param_shardings variants: (zero1, data_only, replicate_embed)
PARAM_VARIANTS = ((False, False, False), (True, False, False),
                  (True, True, True))

#: a short decode cache (name, positions, requests, kind): at 64
#: positions ``_auto_spec`` puts ``model`` on Dh, not T, on the (16, 16)
#: and (2, 16, 16) meshes (the serving shapes split T)
SHORT_CACHE = ("decode_short", 64, 128, "decode")

#: the cell run end to end here: cheap on meta (one decode step)
CHEAP_CELL = ("smollm_135m", "decode_32k", False)

_DUMP = textwrap.dedent('''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import json, sys
    import jax, numpy as np
    from repro.configs import ARCH_IDS, get_config
    from repro.launch import specs as S
    from repro.launch.dryrun import cell_is_applicable, collective_stats
    from repro.launch.mesh import make_production_mesh
    from repro.models.config import SHAPES, ShapeConfig

    def spec_json(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def leaves(structs, shardings):
        out = []
        for t, s in zip(jax.tree.leaves(structs), jax.tree.leaves(shardings)):
            out.append([list(t.shape), str(t.dtype), spec_json(s.spec),
                        list(s.shard_shape(t.shape))])
        return out

    dump = {"applicable": {}, "cells": {},
            "collective_keys": sorted(collective_stats(""))}
    meshes = {"pod1": make_production_mesh(multi_pod=False),
              "pod2": make_production_mesh(multi_pod=True)}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = S.param_structs(cfg)
        opt = S.opt_state_structs(cfg)
        for sh in SHAPES:
            dump["applicable"][f"{arch}/{sh.name}"] = list(
                cell_is_applicable(arch, sh))
        for tag, mesh in meshes.items():
            cell = {"params": [leaves(params, S.param_shardings(
                        cfg, mesh, zero1=z, data_only=d, replicate_embed=r))
                               for z, d, r in %(variants)r],
                    "opt": leaves(opt, S.opt_state_shardings(cfg, mesh)),
                    "cache": {}, "batch": {}}
            for sh in SHAPES + (ShapeConfig(*%(short)r),):
                cell["cache"][sh.name] = leaves(
                    S.cache_structs(cfg, sh), S.cache_shardings(cfg, sh, mesh))
                b = S.batch_spec(cfg, sh, mesh)
                cell["batch"][sh.name] = leaves(
                    b, S.batch_shardings(b, cfg, mesh))
            dump["cells"][f"{arch}/{tag}"] = cell
    json.dump(dump, open(sys.argv[1], "w"))
''') % {"variants": PARAM_VARIANTS, "short": SHORT_CACHE}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DUMP, str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _leaves(structs, shardings):
    return [[list(t.shape), str(t.dtype).replace("torch.", ""),
             _spec_json(s.spec), list(s.shard_shape(tuple(t.shape)))]
            for t, s in zip(tree.leaves(structs), tree.leaves(shardings))]


def _mesh(tag):
    multi = tag == "pod2"
    return make_production_mesh(multi_pod=multi,
                                devices=["meta"] * (512 if multi else 256))


@pytest.mark.parametrize("tag", ["pod1", "pod2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_match_reference(ref, arch, tag):
    want = ref["cells"][f"{arch}/{tag}"]
    cfg = get_config(arch)
    mesh = _mesh(tag)
    params = S.param_structs(cfg)
    for (z, d, r), w in zip(PARAM_VARIANTS, want["params"]):
        assert _leaves(params, S.param_shardings(
            cfg, mesh, zero1=z, data_only=d, replicate_embed=r)) == w
    assert _leaves(S.opt_state_structs(cfg),
                   S.opt_state_shardings(cfg, mesh)) == want["opt"]
    for sh in SHAPES + (ShapeConfig(*SHORT_CACHE),):
        assert _leaves(S.cache_structs(cfg, sh),
                       S.cache_shardings(cfg, sh, mesh)) == \
            want["cache"][sh.name], sh.name
    for sh in SHAPES:
        b = S.batch_spec(cfg, sh, mesh)
        assert _leaves(b, S.batch_shardings(b, cfg, mesh)) == \
            want["batch"][sh.name], sh.name


def test_structs_allocate_nothing():
    cfg = get_config("qwen3_moe_235b_a22b")
    leaves = (tree.leaves(S.param_structs(cfg))
              + tree.leaves(S.opt_state_structs(cfg))
              + tree.leaves(S.cache_structs(cfg, shape_by_name("decode_32k"))))
    assert {t.device.type for t in leaves} == {"meta"}
    assert sum(t.numel() for t in tree.leaves(S.param_structs(cfg))) > 2e11


def test_cell_applicability_matches_reference(ref):
    got = {f"{a}/{s.name}": list(dryrun.cell_is_applicable(a, s))
           for a in ARCH_IDS for s in SHAPES}
    assert got == ref["applicable"]
    skipped = [k for k, (ok, _) in got.items() if not ok]
    assert len(skipped) == 8 and all(k.endswith("/long_500k")
                                     for k in skipped)


def _ref_bytes(parts):
    return sum(int(np.prod(shard)) * np.dtype(
        {"bfloat16": "float16"}.get(dt, dt)).itemsize
        for part in parts for _, dt, _, shard in part)


def test_run_cell_reports_the_references_shard_bytes(ref):
    arch, shape, multi = CHEAP_CELL
    res = dryrun.run_cell(arch, shape, multi)
    assert res["status"] == "ok", res.get("trace")
    cell = ref["cells"][f"{arch}/{'pod2' if multi else 'pod1'}"]
    mem = res["memory"]
    assert mem["params_bytes"] == _ref_bytes([cell["params"][0]])
    assert mem["cache_bytes"] == _ref_bytes([cell["cache"][shape]])
    assert mem["batch_bytes"] == _ref_bytes([cell["batch"][shape]])
    assert mem["argument_size_bytes"] == sum(
        mem[f"{k}_bytes"] for k in ("params", "cache", "batch"))
    assert res["cost"]["flops"] > 0
    assert sorted(res["collectives"]) == ref["collective_keys"]
    assert {"argument_size_gb", "output_size_gb", "temp_size_gb",
            "peak_gb"} <= set(mem)


@pytest.mark.parametrize("arch", ["smollm_135m", "qwen3_moe_235b_a22b"])
@pytest.mark.parametrize("tag", ["pod1", "pod2"])
def test_train_cell_bytes_match_reference(ref, arch, tag):
    """The train cell's per-device bytes (params under FSDP where the
    reference's ``_needs_fsdp`` asks for it, ZeRO-1 moments, the batch),
    without running the step."""
    cfg = get_config(arch)
    mesh = _mesh(tag)
    _, mem, extra = dryrun._train_cell(cfg, shape_by_name("train_4k"), mesh)
    cell = ref["cells"][f"{arch}/{tag}"]
    fsdp_variant = cell["params"][1 if extra["fsdp"] else 0]
    assert extra["fsdp"] == (arch == "qwen3_moe_235b_a22b")
    assert mem["params"] == _ref_bytes([fsdp_variant])
    assert mem["opt_state"] == _ref_bytes([cell["opt"]])
    assert mem["batch"] == _ref_bytes([cell["batch"]["train_4k"]])


def test_dryrun_main_caches_its_records(tmp_path, capsys):
    arch, shape, _ = CHEAP_CELL
    argv = ["--arch", arch, "--shape", shape, "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / f"{arch}__{shape}__pod1.json").read_text())
    assert rec["status"] == "ok"
    assert dryrun.main(argv) == 0
    assert f"[cached] {arch}__{shape}__pod1" in capsys.readouterr().out
