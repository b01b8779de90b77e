"""AdamW, the cosine schedule and global-norm clipping: the port of
``repro.train.optimizer``, in the reference's f32 arithmetic and order.

The optimizer state mirrors the parameter dict: ``m`` and ``v`` in f32,
``step`` an int32 scalar. Each update is computed in f32 and cast back to
the parameter's dtype; decoupled weight decay applies where ``ndim > 1``.
``adamw_update`` returns new tensors, as the reference does; with
``inplace=True`` it writes ``m``, ``v`` and the parameters in place, so a
train step never holds the state twice (the reference's launcher donates
it to ``jit`` for the same reason). Both forms give the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from .. import tree


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    m: Any                     # f32 tree like params
    v: Any                     # f32 tree like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear-warmup + cosine-decay learning rate at ``step`` (f32)."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clip((s - cfg.warmup_steps)
                      / max(cfg.decay_steps - cfg.warmup_steps, 1),
                      0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(s < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> AdamWState:
    """Fresh AdamW state (f32 zero moments) for ``params``, on their
    devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree.tree_map(zeros, params),
                      v=tree.tree_map(zeros, params))


def global_norm(grads: Any) -> torch.Tensor:
    """L2 norm over every leaf of ``grads``: each leaf's sum of squares in
    f32, added in ``jax.tree.leaves`` order (sorted keys), as the
    reference's Python ``sum`` adds them."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def adamw_update(cfg: AdamWConfig, state: AdamWState, params: Any,
                 grads: Any, *, inplace: bool = False
                 ) -> Tuple[Any, AdamWState, dict]:
    """Returns (new_params, new_state, metrics) with metrics ``grad_norm``
    and ``lr``. ``inplace`` updates ``state.m``, ``state.v`` and
    ``params`` in place and returns them."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        if not inplace:
            m, v = m.clone(), v.clone()
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        # decoupled weight decay (skip 1-D params: norms/biases)
        if p.ndim > 1:
            delta = delta + cfg.weight_decay * p.float()
        p2 = (p.float() - lr * delta).to(p.dtype)
        if inplace:
            p.copy_(p2)
            p2 = p
        return p2, m, v

    with torch.no_grad():
        out = [upd(*xs) for xs in zip(*(tree.leaves(t) for t in
                                        (params, grads, state.m, state.v)))]
    new_params, new_m, new_v = (tree.unflatten(params, [o[i] for o in out])
                                for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step, new_m, new_v), metrics


__all__ = ["AdamWState", "AdamWConfig", "cosine_schedule", "adamw_init",
           "global_norm", "adamw_update"]
