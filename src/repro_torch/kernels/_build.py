"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles at first use, with ``nvcc`` for ``sm_90a``, into
its own shared library with a plain C interface under ``build/`` at the
repository root (``REPRO_TORCH_BUILD_DIR`` overrides), and loads through
``ctypes``. A library is named after the hash of its sources and flags,
so an edited source rebuilds and an unchanged one loads as it is.
``build_all`` starts one ``nvcc`` per source at once and waits for all.
Each nvcc run and each library load is reported to
``debug.no_recompiles`` (``debug.guards.note_compile``).

The C entry points return ``cudaGetLastError()`` after the launch; the
wrappers raise on anything but 0. Pointers and the stream cross as
``ctypes.c_void_p``, ints as ``ctypes.c_int``, floats as
``ctypes.c_float``. No flag relaxes IEEE arithmetic (no
``--use_fast_math``): the stencil and pack kernels must match their plain
versions bit for bit, and the flash kernel within a stated tolerance (it
sums in another order).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

from ..debug.guards import note_compile

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("extrema", "fixpass", "lorenzo", "pack", "flash")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    """Where the shared libraries go (created on demand)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    d = Path(env) if env else Path(__file__).resolve().parents[3] / "build"
    d.mkdir(parents=True, exist_ok=True)
    return d


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (set PATH or install it under /usr/local/cuda)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in (CSRC / f"{name}.cu", CSRC / "stencil.cuh"):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc (or return None when the library is built)."""
    out = _lib_path(name)
    if out.exists():
        return None
    note_compile(f"nvcc csrc/{name}.cu")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, job) -> None:
    proc, tmp, out, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (rc={rc}):\n{text}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every kernel library not yet built, one nvcc per source,
    all started together; returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return time.perf_counter() - t0


def ptxas_summary(names: Sequence[str] = SOURCES) -> Dict[str, list]:
    """Per source, the ptxas lines of its last build that report
    registers, shared memory and spills (``-Xptxas -v``), each after the
    (mangled) name of its kernel."""
    out = {}
    for n in names:
        log = _lib_path(n).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        fn, rows = "", []
        for ln in lines:
            text = ln.split("ptxas info    : ")[-1].strip()
            if text.startswith("Function properties for "):
                fn = text[len("Function properties for "):]
            elif "Used" in text or "spill" in text:
                rows.append(f"{fn}: {text}")
        out[n] = rows
    return out


def sass_counts(name: str, opcode: str) -> Dict[str, int]:
    """Per kernel function of ``csrc/<name>.cu``'s built library, how
    many of its SASS instructions are ``opcode`` (any variant, e.g.
    ``HMMA`` counts ``HMMA.16816.F32.BF16``), from ``cuobjdump -sass``."""
    build_all((name,))
    tool = Path(nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    ops: Dict[str, list] = {}
    fn = None
    for line in text.splitlines():
        head = line.strip()
        if head.startswith("Function :"):
            fn = head.split(":", 1)[1].strip()
            ops[fn] = []
        elif fn is not None and "*/" in head:
            words = head.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):      # a predicate
                words = words[1:]
            if words:
                ops[fn].append(words[0].split(".")[0])
    return {f: op_list.count(opcode) for f, op_list in ops.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                note_compile(f"load lib{name}")
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib


def entry(lib: ctypes.CDLL, symbol: str, n_ptr: int, n_int: int,
          n_float: int):
    """A C entry point of ``lib`` taking ``n_ptr`` pointers, ``n_int``
    ints, ``n_float`` floats and the stream, in that order, returning an
    int error code."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
