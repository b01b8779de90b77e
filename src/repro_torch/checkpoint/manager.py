"""Fault-tolerant checkpointing, the port of ``repro.checkpoint.manager``
in the reference's format (version 3), so each package restores the
other's checkpoints.

Guarantees, as the reference's:
  * atomic commits: payloads are written to a temp dir, then renamed; a
    manifest with per-tensor checksums is written LAST, so a checkpoint
    without a valid manifest is garbage-collected, never loaded;
  * crash-safe restore: ``latest`` resolution scans manifests
    newest-first and verifies checksums before use, falling back to the
    next-newest on any error;
  * tensors are stored whole (on the host, unsharded) and restored onto
    ``device``;
  * optional error-bounded lossy payloads (``compress="sz"``: the
    SZ-like host codec ``compress.szlike.sz_compress``, byte for byte
    the reference's) for 2-D and 3-D float tensors, exact zlib for the
    rest.

A state placed on a mesh (``distributed.placement``) saves its gathered
tensors, the same bytes as the one-device state's; across processes
every rank gathers, rank 0 writes and the others wait at a barrier.
``shardings=`` re-places the restored tensors on the current mesh, as
the reference's elastic restore does: a checkpoint written on one mesh
restores on any other.

The tensors are encoded (and on restore decoded) on a pool of threads,
one tensor a task (zlib and the codec release the GIL): a file's bytes
depend on its tensor alone, so they are the same as one thread's.

The format: ``step_<N:010d>/t<i:05d>.bin``, one file a leaf in
``jax.tree_util`` order (``tree.flatten_with_path``: dict keys sorted,
NamedTuple fields in order), and ``manifest.json`` with ``format``,
``step``, ``time``, ``tensors`` (key -> codec, dtype, shape, file, sha1,
and for sz the bound ``xi``) and ``treedef``. Keys are the reference's
``_tensor_key`` strings (``.params/blocks/wq``, ``.opt/.step``). bf16 is
stored as its uint16 bits with ``"jax_dtype": "bfloat16"``; zlib at
level 1. ``tensors`` is equal to the reference's for the same state.
``treedef`` is the reference's ``repr`` of a JAX ``PyTreeDef``, which no
restore reads; the port writes a structural string in its place.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import tree
from ..compress.szlike import sz_compress, sz_decompress
from ..distributed import placement
from ..device import DeviceLike, _d2h, _h2d

_FORMAT_VERSION = 3


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1))


def _split(flat):
    """(keys, leaves) of ``tree.flatten_with_path``'s pairs."""
    return [k for k, _ in flat], [leaf for _, leaf in flat]


def _encode(arr: np.ndarray, mode: str, rel_bound: float):
    """Returns (blob, meta). mode: 'raw' | 'zlib' | 'sz'."""
    if mode == "sz" and arr.dtype in (np.float32, np.float64) and arr.ndim in (2, 3):
        rng = float(np.max(arr) - np.min(arr)) if arr.size else 0.0
        xi = max(rng * rel_bound, 1e-12)
        blob = sz_compress(arr, xi)
        return blob, {"codec": "sz", "xi": xi, "dtype": str(arr.dtype),
                      "shape": list(arr.shape)}
    if mode in ("zlib", "sz"):
        return (zlib.compress(arr.tobytes(), 1),
                {"codec": "zlib", "dtype": str(arr.dtype),
                 "shape": list(arr.shape)})
    return arr.tobytes(), {"codec": "raw", "dtype": str(arr.dtype),
                           "shape": list(arr.shape)}


def _decode(blob: bytes, meta: dict) -> np.ndarray:
    if meta["codec"] == "sz":
        return sz_decompress(blob).astype(meta["dtype"]).reshape(meta["shape"])
    raw = zlib.decompress(blob) if meta["codec"] == "zlib" else blob
    a = np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
    return a.reshape(meta["shape"]).copy()


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference stores (bf16 as its
    uint16 bits; the caller tags it)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _d2h(leaf.view(torch.int16)).view(np.uint16)
        return _d2h(leaf)
    return np.asarray(leaf)


def _structure(node) -> str:
    """The tree's structure as a string (leaves as ``*``)."""
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return f"{type(node).__name__}(" + ", ".join(
            f"{f}={_structure(getattr(node, f))}"
            for f in node._fields) + ")"
    if isinstance(node, (list, tuple)):
        return ("[" if isinstance(node, list) else "(") + ", ".join(
            _structure(x) for x in node) + ("]" if isinstance(node, list)
                                            else ")")
    return "*"


def save_checkpoint(directory: str | Path, step: int, tree_: Any,
                    compress: str = "zlib", lossy_rel_bound: float = 1e-5,
                    lossy_filter: Optional[Callable[[str], bool]] = None
                    ) -> Path:
    """Atomically write ``tree_`` (a tree of tensors or arrays, or one
    placed on a mesh) under directory/step_<N>."""
    directory = Path(directory)
    final = directory / f"step_{step:010d}"
    mesh = _placed_mesh(tree_)
    if mesh is not None:
        tree_ = placement.gather_tree(tree_)
        if not mesh.is_rank0():
            placement.barrier(mesh)
            return final
    try:
        return _save(directory, final, step, tree_, compress,
                     lossy_rel_bound, lossy_filter)
    finally:
        if mesh is not None:
            placement.barrier(mesh)


def _placed_mesh(tree_):
    """The mesh of a placed tree, None for a plain one."""
    leaves = tree.leaves(tree_)
    return leaves[0].mesh if leaves and isinstance(
        leaves[0], placement.Sharded) else None


def _save(directory: Path, final: Path, step: int, tree_: Any,
          compress: str, lossy_rel_bound: float,
          lossy_filter: Optional[Callable[[str], bool]]) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    manifest: Dict[str, Any] = {"format": _FORMAT_VERSION, "step": step,
                                "time": time.time(), "tensors": {}}

    def write(i: int, key: str, leaf) -> dict:
        arr = _host(leaf)
        mode = compress
        if compress == "sz" and lossy_filter and not lossy_filter(key):
            mode = "zlib"
        blob, meta = _encode(arr, mode, lossy_rel_bound)
        # bf16 has no numpy dtype string round-trip: raw bits + tag
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            meta["jax_dtype"] = "bfloat16"
        fn = f"t{i:05d}.bin"
        (tmp / fn).write_bytes(blob)
        meta["file"] = fn
        meta["sha1"] = hashlib.sha1(blob).hexdigest()
        return meta

    try:
        keys, leaves = _split(tree.flatten_with_path(tree_))
        with _pool() as pool:
            metas = list(pool.map(write, range(len(keys)), keys, leaves))
        manifest["tensors"] = dict(zip(keys, metas))
        manifest["treedef"] = _structure(tree_)
        # manifest written last = commit point
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _valid_ckpts(directory: Path):
    out = []
    for p in sorted(directory.glob("step_*"), reverse=True):
        if (p / "manifest.json").exists():
            out.append(p)
    return out


def restore_checkpoint(directory: str | Path, like: Any,
                       step: Optional[int] = None,
                       device: DeviceLike = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore the newest valid checkpoint (or a specific ``step``) into
    the structure of ``like``: (tree, step). Each tensor keeps its stored
    dtype and takes its ``like`` leaf's shape; it lands on ``device``,
    or without one on the device of its ``like`` leaf (the CPU where
    that leaf is not a tensor or is placed). With ``shardings`` (a tree
    of ``NamedSharding``) it is placed on their mesh
    (``placement.place_tree``): the elastic restore."""
    if shardings is not None:
        got, at = restore_checkpoint(directory, like, step, device)
        return placement.place_tree(got, shardings), at
    directory = Path(directory)
    cands = _valid_ckpts(directory)
    if step is not None:
        cands = [p for p in cands if p.name == f"step_{step:010d}"]
    last_err: Optional[Exception] = None
    for ckpt in cands:
        try:
            manifest = json.loads((ckpt / "manifest.json").read_text())

            def read(key: str, leaf) -> torch.Tensor:
                meta = manifest["tensors"][key]
                blob = (ckpt / meta["file"]).read_bytes()
                if hashlib.sha1(blob).hexdigest() != meta["sha1"]:
                    raise IOError(f"checksum mismatch for {key}")
                arr = _decode(blob, meta)
                dev = device if device is not None else (
                    leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
                if meta.get("jax_dtype") == "bfloat16":
                    t = _h2d(arr.view(np.int16), dev).view(torch.bfloat16)
                else:
                    t = _h2d(arr, dev)
                return t.reshape(tuple(leaf.shape))

            with _pool() as pool:
                leaves = list(pool.map(read, *_split(
                    tree.flatten_with_path(like))))
            return tree.unflatten(like, leaves), int(manifest["step"])
        except Exception as e:      # corrupted: try the next-newest
            last_err = e
            continue
    raise FileNotFoundError(
        f"no valid checkpoint under {directory}"
        + (f" (last error: {last_err})" if last_err else ""))


@dataclasses.dataclass
class CheckpointManager:
    """save-every-N policy + retention + auto-resume."""
    directory: str | Path
    save_every: int = 100
    keep: int = 3
    compress: str = "zlib"

    def maybe_save(self, step: int, tree_: Any) -> Optional[Path]:
        """Save ``tree_`` when ``step`` hits the save cadence; returns the
        checkpoint path (None when this step is skipped). Of a placed
        tree across processes, rank 0 alone writes and collects."""
        if step % self.save_every:
            return None
        p = save_checkpoint(self.directory, step, tree_, self.compress)
        mesh = _placed_mesh(tree_)
        if mesh is None or mesh.is_rank0():
            self._gc()
        return p

    def _gc(self):
        ckpts = _valid_ckpts(Path(self.directory))
        for old in ckpts[self.keep:]:
            shutil.rmtree(old, ignore_errors=True)
        # orphaned temp dirs from crashes
        for tmp in Path(self.directory).glob(".tmp_ckpt_*"):
            shutil.rmtree(tmp, ignore_errors=True)

    def restore_latest(self, like: Any, device: DeviceLike = None,
                       shardings: Any = None):
        """Restore the newest checkpoint in the directory into the
        structure of ``like`` (onto ``device``, or placed by
        ``shardings``; see ``restore_checkpoint``)."""
        return restore_checkpoint(self.directory, like, device=device,
                                  shardings=shardings)


__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
