"""The examples on the port's API (``examples/torch_*.py``) on the CPU.

Each example runs as its own process with ``--device cpu`` at its
defaults (the train example at 8 steps into ``tmp_path``, then resumed
from its checkpoint); without a GPU and without ``--device cpu`` each
exits non-zero with the port's "no CUDA GPU" error instead of falling
back to the CPU; importing one pulls in neither ``jax`` nor ``repro``.
Where the result is deterministic the examples are held to the
reference: the quickstart's szlike artifact bytes, and the topo
pipeline's climate rows against the reference library's numbers.

LM serving and training parity with the reference are held elsewhere:
``test_torch_lm.py::test_smoke_f32_serving_matches_reference`` (every
family's tokens, ``greedy_generate`` too) and
``test_torch_train.py::test_launcher_improves_and_resumes``.
"""
import importlib.util
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "topo_pipeline", "serve_lm", "train_lm")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"      # one torch thread a child
    env.update(extra)
    return env


def _run(name, *argv, **env):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), *argv],
        cwd=ROOT, env=_env(**env), capture_output=True, text=True,
        timeout=300)


def _load(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (name, argv, last printed line) of each run at the example's defaults
RUNS = (
    ("quickstart", (), "OK"),
    ("quickstart", ("--codec", "zfplike"), "OK"),
    ("topo_pipeline", (), "all cells preserved MSS exactly within bounds"),
    ("serve_lm", (), "OK"),
)

_IMPORT_ONE = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("ex", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main) and "repro_torch" in sys.modules
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
"""


def _train_twice(ck):
    argv = ("--steps", "8", "--ckpt-every", "4", "--ckpt-dir", ck,
            "--device", "cpu")
    return _run("train_lm", *argv), _run("train_lm", *argv, "--resume")


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Every child process of this module, four at a time, started on
    first use: the runs at the defaults, the train example's two runs,
    each example without a GPU, and each example's imports."""
    tmp = tmp_path_factory.mktemp("examples")
    jobs = {("run", name, argv): (_run, (name, *argv, "--device", "cpu"), {})
            for name, argv, _ in RUNS}
    jobs["train"] = (_train_twice, (str(tmp / "ck"),), {})
    for name in EXAMPLES:
        empty = tmp / f"no_gpu_{name}"
        empty.mkdir()
        argv = ("--ckpt-dir", str(empty)) if name == "train_lm" else ()
        jobs[("no_gpu", name)] = (_run, (name, *argv),
                                  {"CUDA_VISIBLE_DEVICES": ""})
        jobs[("imports", name)] = (subprocess.run, (
            [sys.executable, "-c", _IMPORT_ONE,
             str(ROOT / "examples" / f"torch_{name}.py")],), dict(
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=300))
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {k: pool.submit(fn, *a, **kw) for k, (fn, a, kw) in jobs.items()}
        yield {k: f.result() for k, f in futs.items()}, tmp


@pytest.mark.parametrize("name, argv, last", RUNS)
def test_example_runs_on_the_cpu(procs, name, argv, last):
    proc = procs[0][("run", name, argv)]
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == last


def test_train_example_improves_then_resumes_from_its_checkpoint(procs):
    first, resumed = procs[0]["train"]
    assert first.returncode == 0, first.stdout + first.stderr
    assert '"improved": true' in first.stdout.strip().splitlines()[-1]
    assert len(os.listdir(procs[1] / "ck")) == 2     # steps 4 and 8
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    lines = resumed.stdout.strip().splitlines()
    assert "resumed from step 8" in lines
    assert lines[-1] == "started at step 8 of 8: 0 step(s) run"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_gpu_raises_instead_of_falling_back(procs, name):
    proc = procs[0][("no_gpu", name)]
    assert proc.returncode != 0
    assert "RuntimeError: no CUDA GPU is available" in proc.stderr
    assert not os.listdir(procs[1] / f"no_gpu_{name}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_repro(procs, name):
    proc = procs[0][("imports", name)]
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_quickstart_artifact_is_the_references():
    from repro.compress import compress_preserving_mss
    from repro.data import synthetic_field
    out = _load("quickstart").main(["--device", "cpu"])
    art = out["artifact"]
    f = synthetic_field("nyx", shape=(32, 32, 32))
    xi = 1e-3 * float(np.ptp(f))
    assert np.array_equal(out["field"], f) and out["xi"] == xi
    ref = compress_preserving_mss(f, xi, codec="szlike", backend="reference")
    assert art.base == "szlike" and art.path == ref.path == "device"
    assert art.base_payload == ref.base_payload
    assert art.edit_payload == ref.edit_payload


def test_topo_pipeline_climate_rows_are_the_references():
    from repro.compress import (compress_preserving_mss,
                                decompress_preserving_mss, overall_bit_rate,
                                overall_compression_ratio, psnr)
    from repro.data import synthetic_field
    rows = _load("topo_pipeline").main(["--device", "cpu"])
    climate = [r for r in rows if r["dataset"] == "climate"]
    assert [(r["base"], r["rel_xi"]) for r in climate] == [
        ("szlike", 1e-4), ("szlike", 1e-3), ("zfplike", 1e-4),
        ("zfplike", 1e-3)]
    f = synthetic_field("climate", shape=(48, 96))
    for r in climate:
        xi = r["rel_xi"] * float(np.ptp(f))
        ref = compress_preserving_mss(f, xi, codec=r["base"],
                                      backend="reference")
        g = decompress_preserving_mss(ref, backend="reference")
        assert r["ok"] and r["path"] == ref.path
        assert r["ocr"] == overall_compression_ratio(f, ref)
        assert r["obr"] == overall_bit_rate(f, ref)
        assert r["edit_ratio"] == ref.edit_ratio
        assert r["psnr"] == psnr(f, g)
