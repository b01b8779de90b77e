"""The port stands alone: no ``repro_torch`` module imports ``jax`` or
``repro``, entry points refuse to fall back to the CPU when no GPU is
present and the caller did not ask for the CPU, and ``chip_smoke.py``
fails without a GPU instead of printing a result."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15     # every module was imported


def test_importing_kernels_builds_nothing(tmp_path):
    code = ("import os, repro_torch.kernels.extrema, "
            "repro_torch.kernels.fixpass, repro_torch.kernels.lorenzo, "
            "repro_torch.kernels.pack, repro_torch.kernels.flash, "
            "repro_torch.models, repro_torch.core; print(os.listdir(os.environ["
            "'REPRO_TORCH_BUILD_DIR']) if os.path.isdir(os.environ["
            "'REPRO_TORCH_BUILD_DIR']) else [])")
    env = _env()
    env["REPRO_TORCH_BUILD_DIR"] = str(tmp_path / "build")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["extrema", "fixpass", "lorenzo", "pack",
                                    "flash", "stencil", "_build"])
def test_each_kernel_module_imports_first(module):
    """A kernel module imported before anything else of the port imports
    cleanly (no cycle through ``repro_torch.core``)."""
    proc = subprocess.run(
        [sys.executable, "-c", f"import repro_torch.kernels.{module}"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(no_cuda):
    from repro_torch.compress import (compress_preserving_mss,
                                      decompress_preserving_mss)
    from repro_torch.core import derive_edits, verify_preservation
    from repro_torch.device import resolve_device
    f = np.random.default_rng(0).normal(size=(6, 7)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        compress_preserving_mss(f, 0.1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        derive_edits(f, f, 0.1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        verify_preservation(f, f, 0.1)
    art = compress_preserving_mss(f, 0.1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        decompress_preserving_mss(art)
    # asking for the CPU explicitly is the only way onto it
    assert decompress_preserving_mss(art, device="cpu").shape == f.shape


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA GPU")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the repository around it, it fails too
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
