"""The port's collectives across processes, one seam that counts.

Every collective the port issues across processes goes through
``all_gather``, ``all_reduce`` or ``all_to_all_single`` here:
``placement``'s all-gather and its two all-to-alls (``_exchange``,
``regroup_model``), ``compression``'s reductions of the pods' scales
and codes, and the one-device step's pod metrics (``train.step``).
Each call adds, for this process, one to the count of its kind and its
bytes to the kind's bytes. The kinds are the reference dry-run's
(``repro/launch/dryrun.py``'s ``_COLLECTIVES``) and so is the byte
rule: an op's bytes are the larger of its operand's and its result's
(an all-gather's are its result's, the group's parts together).
``stats()`` reads the tally with the keys of the reference's
``collective_stats``, ``reset()`` zeroes it. The port issues no
reduce-scatter and no collective-permute (its reduce-scatters are an
all-gather and an ordered local sum, ``placement.axis_sum``), so those
two kinds stay 0.

On a ``torch.distributed`` process group (NCCL, gloo) each call is
issued as before and counted. On a dry rank's group (``DryGroup``: a
position of ``launch.mesh.dry_rank``, a mesh on ``meta`` with no
process group) nothing is issued: the caller's output tensors, made
with ``torch.empty``, stand as the result, and the count is the same as
the real rank's at that position.
"""
from __future__ import annotations

import copy
from typing import List, NamedTuple, Sequence

import torch

#: the reference dry-run's collective kinds, in its order
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

#: this process's tally, {kind: {"count", "bytes"}}; ``reset`` zeroes it
COUNTED = {k: {"count": 0, "bytes": 0} for k in KINDS}


class DryGroup(NamedTuple):
    """A dry rank's group over some axes of its mesh: ``size`` members,
    this position the ``rank``-th of them (position order)."""
    size: int
    rank: int


def reset() -> None:
    """Zero the tally."""
    for v in COUNTED.values():
        v["count"] = 0
        v["bytes"] = 0


def stats() -> dict:
    """The tally in the keys of the reference's ``collective_stats``:
    each kind's ``count`` and ``bytes``, ``total_bytes``,
    ``total_count``, and ``entry_bytes`` / ``body_bytes``. Every
    collective the port issues is counted where it runs (nothing once
    for many loop trips), so ``entry_bytes`` is the total and
    ``body_bytes`` 0."""
    out = copy.deepcopy(COUNTED)
    total = sum(v["bytes"] for v in COUNTED.values())
    out.update(total_bytes=total,
               total_count=sum(v["count"] for v in COUNTED.values()),
               entry_bytes=total, body_bytes=0)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, nbytes: int) -> None:
    COUNTED[kind]["count"] += 1
    COUNTED[kind]["bytes"] += nbytes


def _dry(group) -> bool:
    return isinstance(group, DryGroup)


def world_size(group=None) -> int:
    """The number of ranks of ``group`` (default: the world)."""
    if _dry(group):
        return group.size
    import torch.distributed as dist
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group`` (default: the world)."""
    if _dry(group):
        return group.rank
    import torch.distributed as dist
    return dist.get_rank(group)


def all_gather(outs: List[torch.Tensor], x: torch.Tensor, group=None
               ) -> None:
    """Every rank's ``x`` into ``outs`` (one tensor a rank of the group,
    each of ``x``'s shape and dtype), ``torch.distributed.all_gather``."""
    _count("all-gather", max(_nbytes(x), sum(_nbytes(o) for o in outs)))
    if _dry(group):
        return
    import torch.distributed as dist
    dist.all_gather(outs, x, group=group)


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> None:
    """``x`` reduced in place over the group by ``op`` ("sum" or
    "max"), ``torch.distributed.all_reduce``."""
    _count("all-reduce", _nbytes(x))
    if _dry(group):
        return
    import torch.distributed as dist
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)


def all_to_all_single(out: torch.Tensor, x: torch.Tensor,
                      out_sizes: Sequence[int], in_sizes: Sequence[int],
                      group=None) -> None:
    """``torch.distributed.all_to_all_single``: ``x``'s pieces of
    ``in_sizes`` (along dim 0) to each rank in order, each rank's piece
    for this one into ``out`` at ``out_sizes``."""
    _count("all-to-all", max(_nbytes(x), _nbytes(out)))
    if _dry(group):
        return
    import torch.distributed as dist
    dist.all_to_all_single(out, x, list(out_sizes), list(in_sizes),
                           group=group)


__all__ = ["KINDS", "COUNTED", "DryGroup", "reset", "stats", "world_size",
           "rank", "all_gather", "all_reduce", "all_to_all_single"]
