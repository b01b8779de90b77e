"""The train step, the port of ``repro.train.step``: cross-entropy loss
(label -1 masks a position; z-loss), microbatched gradient accumulation,
the remat policy, and the optional compressed cross-pod gradient sync.

Gradients come from ``torch.autograd.grad`` through ``models.forward``
(``value_and_grad``), in each parameter's dtype, as ``jax.grad`` returns
them. Microbatches split the batch on axis 0, their gradients add in f32
and are divided by their count, and the metrics are the last
microbatch's, as the reference's ``lax.scan`` gives them. ``remat``
recomputes every layer in the backward (``torch.utils.checkpoint``
around each one, where the reference wraps the whole loss in
``jax.checkpoint``): the same numbers, bitwise. With ``grad_compress``
and ``n_pods`` > 1, the batch splits into ``n_pods`` shards, each pod
takes its shard's gradients, and ``distributed.compression`` sums them
(one shared step a tensor, int codes summed exactly) and divides by
``n_pods``: the reference's ``shard_map`` over ``pod``. In one process
pod i runs on the i-th device of a mesh's ``pod`` axis, or on the
parameters' device without a mesh. When a ``torch.distributed`` process
group of ``n_pods`` ranks is up (``launch.mesh.init_distributed``), pod
i is rank i: each rank takes shard i of the batch it is given and the
codes are summed over the group (``compressed_all_reduce_tree``), so
every rank gets the one-process step's bits.

The step updates the state in place (``adamw_update(inplace=True)``):
the state passed in is consumed, as the reference's launcher donates it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import tree
from ..device import DeviceLike
from ..distributed.compression import make_grad_sync
from ..distributed.placement import is_placed
from ..models import forward as model_forward
from ..models import init_params
from ..models import layers as _L
from ..models.config import ArchConfig
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_microbatches: int = 1
    remat: bool = True
    aux_loss_weight: float = 0.01
    grad_compress: bool = False     # compressed cross-pod all-reduce
    grad_compress_bound: float = 1e-3
    grad_compress_bits: int = 16
    n_pods: int = 1
    z_loss: float = 1e-4            # logit normalizer regularizer


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """(summed loss, summed mask) of one (B, S, V) f32 block."""
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp_min(0).long()[..., None])[..., 0]
    loss = torch.sum((lse - ll) * mask)
    if z_loss:
        loss = loss + z_loss * torch.sum(torch.square(lse) * mask)
    return loss, torch.sum(mask)


def _masked_nll_model(parts, labels: torch.Tensor, z_loss: float, row):
    """``_masked_nll`` of vocab-sharded logits: ``parts`` each local
    shard's (B, S, V / tp) f32 logits (``models.model.unembed_shards``),
    ``row`` their ``placement.ModelRow``. The log-sum-exp takes the max
    over ``model`` (no gradient) and the sum of exps over ``model``
    (``sum_model``: f32, model order); the label's logit comes from the
    shard that holds it (zeros elsewhere, a masked label none), so the
    whole (B, S, V) logits are never formed. The z-loss is on the global
    log-sum-exp. Returns (summed loss, summed mask) on ``row.home``."""
    from ..distributed import placement as PL
    from ..models.model import _vocab_local
    mask = (labels >= 0).float()
    m = PL.max_model([p.amax(-1) for p in parts], row)
    sums = [torch.exp(p - m.to(p.device)[..., None]).sum(-1) for p in parts]
    lse = torch.log(PL.sum_model(sums, row)) + m
    picked = []
    for i, p in zip(row.indices, parts):
        t, inside = _vocab_local(labels.to(p.device), i, p.shape[-1])
        got = torch.gather(p, -1, t[..., None])[..., 0]
        picked.append(torch.where(inside, got, 0.0))
    ll = PL.sum_model(picked, row)
    loss = torch.sum((lse - ll) * mask)
    if z_loss:
        loss = loss + z_loss * torch.sum(torch.square(lse) * mask)
    return loss, torch.sum(mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0):
    """logits (B, S, V) f32, labels (B, S) int; label -1 masks the
    position. Returns (mean_loss, n_tokens)."""
    loss, n = _masked_nll(logits, labels, z_loss)
    n = torch.clamp_min(n, 1.0)
    return loss / n, n


def chunked_cross_entropy(hidden: torch.Tensor, unembed: torch.Tensor,
                          labels: torch.Tensor, *,
                          softcap: Optional[float], z_loss: float = 0.0,
                          chunk: int = 512):
    """Cross-entropy from the final hidden states (B, S, d) and the
    unembedding (d, V), a chunk of positions at a time (the largest
    divisor of S up to ``chunk``), so the full (B, S, V) f32 logits are
    never resident. Returns (mean_loss, n_tokens). Not wired into
    ``make_loss_fn``, as in the reference."""
    S = hidden.shape[1]
    c = chunk
    while S % c:
        c -= 1
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, c):
        logits = hidden[:, s0:s0 + c].float() @ unembed.float()
        lc, nc = _masked_nll(_L.softcap(logits, softcap),
                             labels[:, s0:s0 + c], z_loss)
        loss = loss + lc
        n = n + nc
    n = torch.clamp_min(n, 1.0)
    return loss / n, n


def make_loss_fn(cfg: ArchConfig, tcfg: TrainStepConfig) -> Callable:
    """The per-batch LM loss ``loss_fn(params, batch) -> (total, aux)``:
    the mean cross-entropy with ``tcfg.z_loss``, plus ``aux_loss_weight``
    x the MoE router's aux loss; llava's image positions carry no loss
    (their logits are dropped). aux: ``loss``, ``aux_loss``, ``tokens``.
    The forward recomputes each layer in the backward under
    ``tcfg.remat``."""
    def loss_fn(params, batch):
        out = model_forward(cfg, params, batch, remat=tcfg.remat)
        logits = out.logits
        if cfg.n_img_tokens and "image_embeds" in batch:
            logits = logits[:, cfg.n_img_tokens:]
        loss, n = cross_entropy(logits, batch["labels"], tcfg.z_loss)
        total = loss + tcfg.aux_loss_weight * out.aux_loss
        return total, {"loss": loss, "aux_loss": out.aux_loss, "tokens": n}
    return loss_fn


def value_and_grad(loss_fn: Callable, params: Any, batch: Dict):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``:
    ((total, aux), grads), grads a tree like ``params`` in each leaf's
    dtype (zeros for a leaf the loss does not reach). ``params`` is left
    as it is: the gradient is taken at detached aliases of its leaves."""
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    total, aux = loss_fn(tree.unflatten(params, flat), batch)
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (total.detach(), aux), tree.unflatten(params, grads)


def _pod_devices(mesh, n_pods: int, default: torch.device) -> list:
    """The device of each pod: the ``pod`` axis of ``mesh`` (the first
    device of each pod's sub-mesh), or ``default`` for every pod."""
    if mesh is None or "pod" not in mesh.axis_names:
        return [default] * n_pods
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index("pod"), 0)
    if devs.shape[0] != n_pods:
        raise ValueError(f"n_pods={n_pods} but the mesh's pod axis has "
                         f"{devs.shape[0]} devices")
    return [torch.device(d) for d in devs.reshape(n_pods, -1)[:, 0]]


def make_grad_fn(cfg: ArchConfig, tcfg: TrainStepConfig,
                 mesh=None) -> Callable:
    """``grad_fn(params, batch) -> (grads, aux)``: the gradients
    ``make_train_step`` hands the optimizer (microbatched, and synced
    over the pods when ``tcfg.grad_compress`` and ``tcfg.n_pods`` > 1)."""
    loss_fn = make_loss_fn(cfg, tcfg)
    n_mb = tcfg.n_microbatches

    def compute_grads(params, batch):
        if n_mb <= 1:
            (_, aux), g = value_and_grad(loss_fn, params, batch)
            return g, aux
        gsum = None
        for i in range(n_mb):
            mb = {k: v.reshape((n_mb, v.shape[0] // n_mb) + v.shape[1:])[i]
                  for k, v in batch.items()}
            (_, aux), g = value_and_grad(loss_fn, params, mb)
            if gsum is None:
                gsum = tree.tree_map(lambda x: x.float(), g)
            else:
                tree.tree_map(lambda acc, x: acc.add_(x), gsum, g)
            del g
        return tree.tree_map(lambda x: x / n_mb, gsum), aux

    if not (tcfg.grad_compress and tcfg.n_pods > 1):
        return compute_grads

    n = tcfg.n_pods
    if _pod_group_spans(n, mesh):
        return _rank_pod_grads(compute_grads, tcfg)

    def pod_grads(params, batch):
        home = tree.leaves(params)[0].device
        devs = _pod_devices(mesh, n, home)
        sync = make_grad_sync(tcfg.grad_compress_bound,
                              tcfg.grad_compress_bits, n_pods=n,
                              device=home)
        grads, auxs = [], []
        for i, dev in enumerate(devs):
            shard = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                     .to(dev) for k, v in batch.items()}
            p = params if dev == home else tree.tree_map(
                lambda t: t.to(dev), params)
            g, a = compute_grads(p, shard)
            grads.append(g)
            auxs.append(a)
        aux = {k: sum(a[k].to(home) for a in auxs) / n for k in auxs[0]}
        return sync(grads), aux
    return pod_grads


def _pod_group_spans(n_pods: int, mesh=None) -> bool:
    """Whether the pods are the ranks of the ``torch.distributed`` process
    group: one is up and has ``n_pods`` ranks. A group of another size,
    or a mesh over processes, raises: there the pods are subgroups of a
    ``(pod, data, model)`` mesh, which the sharded step
    (``make_train_step(mesh=)``) syncs, each position over its own pod
    subgroup."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return False
    world = dist.get_world_size()
    if (mesh is not None and getattr(mesh, "multi_process", False)) \
            or world != n_pods:
        raise ValueError(
            f"grad_compress over {n_pods} pods in a process group of "
            f"{world} ranks: pass the (pod, data, model) mesh and a state "
            "placed on it to make_train_step(mesh=), whose pods sync over "
            "each position's pod subgroup")
    return True


def _rank_pod_grads(compute_grads: Callable, tcfg: TrainStepConfig
                    ) -> Callable:
    """The pod path across processes: this rank's pod's gradients (shard
    ``rank`` of the batch), synced over the world; the aux metrics summed
    over the ranks in rank order and divided by the pod count, as the
    one-process path sums them."""
    import torch.distributed as dist
    n = tcfg.n_pods
    sync = make_grad_sync(tcfg.grad_compress_bound, tcfg.grad_compress_bits,
                          n_pods=n, group=dist.group.WORLD)

    def pod_grads(params, batch):
        i = dist.get_rank()
        shard = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                 for k, v in batch.items()}
        g, a = compute_grads(params, shard)
        keys = list(a)
        mine = torch.stack([a[k].float() for k in keys])
        every = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(every, mine)
        aux = {k: sum(e[j].to(a[k].dtype) for e in every) / n
               for j, k in enumerate(keys)}
        return sync(g), aux
    return pod_grads


def make_train_step(cfg: ArchConfig, tcfg: TrainStepConfig,
                    opt_cfg: AdamWConfig, *, mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``loss``, ``aux_loss``, ``tokens``, ``grad_norm`` and ``lr`` (0-d
    tensors). The state is updated in place and returned. A state placed
    on ``mesh`` (``distributed.placement.place_tree``; a ``(data,
    model)`` or ``(pod, data, model)`` mesh) runs the sharded step
    (``train.sharded``); a plain state the one-device step, ``mesh``
    placing the pods of its compressed sync (``make_grad_fn``)."""
    built: Dict[str, Callable] = {}     # each path made at its first use

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if is_placed(state.params):
            if "sharded" not in built:
                from .sharded import make_sharded_train_step
                built["sharded"] = make_sharded_train_step(cfg, tcfg,
                                                           opt_cfg, mesh)
            return built["sharded"](state, batch)
        if "grad" not in built:
            built["grad"] = make_grad_fn(cfg, tcfg, mesh)
        grads, aux = built["grad"](state.params, batch)
        params, opt, om = adamw_update(opt_cfg, state.opt, state.params,
                                       grads, inplace=True)
        return TrainState(params, opt), {**aux, **om}

    return train_step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     device: DeviceLike = None) -> TrainState:
    """Fresh params (``models.init_params``) and optimizer state for one
    architecture config."""
    params = init_params(cfg, generator, device)
    return TrainState(params=params, opt=adamw_init(params))


__all__ = ["TrainState", "TrainStepConfig", "cross_entropy",
           "chunked_cross_entropy", "make_loss_fn", "value_and_grad",
           "make_grad_fn", "make_train_step", "init_train_state"]
