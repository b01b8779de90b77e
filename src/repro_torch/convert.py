"""State carried across between ``repro`` and ``repro_torch``.

The codec has no weights: its state is the original field's topology
and the compressed artifact. Both cross as plain Python data, so neither
package imports the other:

* ``topo_from_numpy`` turns a ``FieldTopo`` given as a dict of numpy
  arrays (``{k: np.asarray(v) for k, v in topo._asdict().items()}`` on
  the JAX side) into the port's ``FieldTopo`` on ``device``;
* ``artifact_to_dict`` / ``artifact_from_dict`` move a
  ``CompressedArtifact`` as the dict ``dataclasses.asdict`` gives, so
  each side decodes the other's artifacts.

The LM's state is its parameter dict; ``params_from_numpy`` and
``params_to_numpy`` carry it across as float32 numpy arrays (the
reference's bf16 weights widen to f32 and narrow back losslessly), with
no dependency on ``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .compress.preserve import CompressedArtifact
from .core.fixes import FieldTopo
from .device import DeviceLike, _d2h, _h2d, resolve_device
from .models.config import ArchConfig


def topo_from_numpy(arrays: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> FieldTopo:
    """The port's ``FieldTopo`` from numpy arrays keyed by field name
    (masks become bool, codes and labels int32, ``lower`` keeps its
    float dtype)."""
    dev = resolve_device(device)
    casts = {"up_c": np.int32, "dn_c": np.int32, "is_max": np.bool_,
             "is_min": np.bool_, "M": np.int32, "m": np.int32}
    out = {}
    for name in FieldTopo._fields:
        a = np.asarray(arrays[name])
        out[name] = _h2d(a.astype(casts[name]) if name in casts else a, dev)
    return FieldTopo(**out)


def artifact_to_dict(art: CompressedArtifact) -> dict:
    """A plain dict of the artifact's fields (bytes stay bytes)."""
    return dataclasses.asdict(art)


def artifact_from_dict(d: Mapping) -> CompressedArtifact:
    """A ``CompressedArtifact`` from a dict of its fields; fields the
    port does not know raise, missing ones take their defaults."""
    names = {f.name for f in dataclasses.fields(CompressedArtifact)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown artifact fields {sorted(unknown)}")
    kw = dict(d)
    kw["shape"] = tuple(int(s) for s in kw["shape"])
    return CompressedArtifact(**kw)


def params_from_numpy(tree: Mapping, cfg: ArchConfig,
                      device: DeviceLike = None) -> dict:
    """The port's parameter dict from the reference's, given as a nested
    dict of float32 numpy arrays (e.g. ``jax.tree.map(lambda a:
    np.asarray(a.astype(jnp.float32)), params)``), as tensors in
    ``cfg.dtype`` on ``device``; hymba's ``A_log`` stays float32, as the
    reference keeps it."""
    dev = resolve_device(device)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def conv(node, name=None):
        if isinstance(node, Mapping):
            return {k: conv(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype != np.float32:
            raise TypeError(f"params_from_numpy: float32 arrays, got "
                            f"{a.dtype}")
        return _h2d(a, dev).to(torch.float32 if name == "A_log" else dt)
    return conv(tree)


def params_to_numpy(params: Mapping) -> dict:
    """The inverse of ``params_from_numpy``: a nested dict of float32
    numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else _d2h(v.float()) for k, v in params.items()}


__all__ = ["topo_from_numpy", "artifact_to_dict", "artifact_from_dict",
           "params_from_numpy", "params_to_numpy"]
