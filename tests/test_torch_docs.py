"""Documentation gates of the port: the docstring audit of
``docs/audit_docstrings.py`` over ``repro_torch`` (every module
documented, every ``__all__`` export and public method of an exported
class with a docstring), and the README's port quickstart block run
verbatim in a fresh interpreter."""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

from _torch_threads import one_thread  # noqa: F401

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_docstring_audit_clean():
    audit = _load(REPO_ROOT / "docs" / "audit_docstrings.py")
    audit.ROOT_PACKAGE = "repro_torch"
    problems = audit.collect_problems()
    assert problems == [], "\n".join(problems)


def test_readme_port_quickstart_runs_verbatim():
    """Extract the fenced block following '### Port quickstart' and run
    it unmodified in a fresh interpreter with PYTHONPATH=src."""
    text = (REPO_ROOT / "README.md").read_text()
    m = re.search(r"### Port quickstart.*?```python\n(.*?)```", text,
                  re.DOTALL)
    assert m, "README has no fenced port quickstart block"
    code = m.group(1)
    assert 'device="cpu"' in code
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, text=True,
        capture_output=True, timeout=300,
        env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, \
        f"README port quickstart failed:\n{proc.stdout}\n{proc.stderr}"
    assert "jax" not in code and "from repro." not in code
