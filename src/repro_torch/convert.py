"""State carried across between ``repro`` and ``repro_torch``.

MSz has no weights: its state is the original field's topology and the
compressed artifact. Both cross as plain Python data, so neither package
imports the other:

* ``topo_from_numpy`` turns a ``FieldTopo`` given as a dict of numpy
  arrays (``{k: np.asarray(v) for k, v in topo._asdict().items()}`` on
  the JAX side) into the port's ``FieldTopo`` on ``device``;
* ``artifact_to_dict`` / ``artifact_from_dict`` move a
  ``CompressedArtifact`` as the dict ``dataclasses.asdict`` gives, so
  each side decodes the other's artifacts.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .compress.preserve import CompressedArtifact
from .core.fixes import FieldTopo
from .device import DeviceLike, _h2d, resolve_device


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


__all__ = ["topo_from_numpy", "artifact_to_dict", "artifact_from_dict"]
