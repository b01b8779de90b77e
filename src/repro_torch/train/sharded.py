"""The train step over a ``("data", "model")`` or ``("pod", "data",
"model")`` mesh: the port of the reference launcher's ``jax.jit(step,
in_shardings=..., out_shardings=...)`` (``repro/launch/train.py:66-72``),
in one process or across processes (``launch.mesh.make_mesh``).

The state is placed (``distributed.placement.place_tree``) by the
reference's specs: params by ``param_spec`` (model-sharded), AdamW's
moments by ``param_spec(zero1=True)`` (also split over the batch axes).
The batch splits over the data rows and the model axis splits the
layers, the reference's partitioned step:

* each data row (a position of the batch axes) computes its rows of the
  batch (``specs.batch_shardings``' split, the whole batch on every row
  where it does not divide); in one process a row runs once, its split
  layers running each model shard's part on that shard's device;
  across processes every model shard of the row runs its own part;
* a model-sharded weight enters the model as ``ModelShards`` and the
  layers split where ``models.sharding.tp_layout`` says: attention by
  heads (``heads_split``), the MLPs by ff, MoE experts by expert (or
  each expert's ff), the embedding and the unembedding by vocabulary,
  Megatron's layout through ``placement.to_model``/``sum_model``; the
  logits stay vocab shards and the masked loss is the vocab-parallel
  one (``step._masked_nll_model``); an attention whose heads do not
  divide and the recurrent families' layers gather their weights over
  ``model`` inside their (checkpointed) call and run whole; remat
  recomputes a layer's collectives in the backward, in the forward's
  order on every rank; a replicated weight is used only outside a split
  region, so each rank's gradient of it is the whole one;
* the loss is the global mean: each row's masked sum over the global
  count of labels >= 0, so the rows' gradients sum to the one-device
  gradient; microbatches split the batch first, as the reference's scan
  does, and keep its mean of microbatch means;
* a MoE config's rows each run the whole batch's forward (the dense
  dispatch sets capacity, drops and the aux loss over every token, so
  the rows' tokens meet in every MoE layer) and take the loss of their
  own rows and 1 / rows of the aux loss: the gather of each MoE layer's
  input moved to the batch itself;
* the rows' gradients sum over the batch axes (an all-gather and an f32
  sum in row order); with ``grad_compress`` over a ``pod`` axis they sum
  over ``data`` within the pod and then cross the pods compressed (one
  quantization step a leaf from its largest |g| over the pods and the
  model shards, the reference's, and an exact integer sum over the
  position's pod subgroup), divided by the pod count;
* the global norm counts each element once (a model-sharded leaf's
  shards summed, a replicated leaf once), and AdamW updates each
  position's ZeRO-1 slice, whose params an all-gather over the batch
  axes rebuilds.

Every sum runs in position order, so a multi-process run gives the
one-process run's bits. On a 1 x 1 mesh the step is bitwise the
one-device ``make_train_step``'s.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from .. import tree
from ..distributed import placement as PL
from ..distributed.compression import _codes, _step
from ..models import forward as model_forward
from ..models import layers as _L
from ..models.model import unembed_shards
from ..models.sharding import axes_for_mesh, tp_layout
from .optimizer import AdamWConfig, AdamWState, adamw_update
from .step import (TrainState, TrainStepConfig, _masked_nll,
                   _masked_nll_model)


def _rel(outer, inner) -> tuple:
    """``inner``'s slices (global) relative to ``outer``'s start."""
    return tuple(slice(i.start - o.start, i.stop - o.start)
                 for o, i in zip(outer, inner))


def make_sharded_train_step(cfg, tcfg: TrainStepConfig,
                            opt_cfg: AdamWConfig, mesh) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` on a state placed
    on ``mesh`` (see the module's docstring). ``batch`` is the global
    batch, whole in every process. The state is updated in place and
    returned; the metrics are those of ``make_train_step``, on the first
    local position's device."""
    if "data" not in mesh.axis_names or "model" not in mesh.axis_names:
        raise ValueError(f"the sharded train step runs on a (data, model) "
                         f"or (pod, data, model) mesh, got {mesh.axis_names}")
    ax = axes_for_mesh(mesh)
    sizes = mesh.shape
    n_pods = sizes.get("pod", 1)
    compress = tcfg.grad_compress and tcfg.n_pods > 1
    if compress and n_pods != tcfg.n_pods:
        raise ValueError(f"n_pods={tcfg.n_pods} but the mesh's pod axis has "
                         f"{n_pods} positions")
    coupled = cfg.moe is not None
    if coupled and _L.MOE_EP_MODE and mesh.multi_process:
        raise NotImplementedError("MOE_EP_MODE on a multi-process mesh: "
                                  "moe_ffn_ep exchanges between one "
                                  "process's shards")
    # the rows whose gradients sum exactly: a pod's under compression
    sum_axes = ("data",) if compress else ax.batch
    nd = math.prod(sizes[a] for a in sum_axes)
    n_mb = max(tcfg.n_microbatches, 1)

    def rows() -> Dict[int, List[int]]:
        """{row: this process's positions of it, in model order}."""
        out: Dict[int, List[int]] = {}
        for q in mesh.local_positions():
            r = PL.mixed_radix(mesh.coords(q), ax.batch, sizes)
            out.setdefault(r, []).append(q)
        return out

    def row_view(leaves, qs):
        """The row's params (tensors and ``ModelShards``), the tensors
        its gradients are taken at, and for each the positions they go
        to."""
        home = mesh.device_at(qs[0])
        view, flat, owners = [], [], []
        for s in leaves:
            k = PL.model_dim(s.sharding.spec)
            if k is None:
                t = s.local[qs[0]].detach().requires_grad_(True)
                view.append(t)
                flat.append(t)
                owners.append(list(qs))
                continue
            parts = [s.local[q].detach().requires_grad_(True) for q in qs]
            view.append(PL.ModelShards(parts, k, mesh, qs[0], home))
            flat.extend(parts)
            owners.extend([q] for q in qs)
        return view, flat, owners

    def row_loss(params, mb: Dict[str, torch.Tensor], lo: int, hi: int,
                 n_tok: torch.Tensor, shared: bool):
        """(objective, masked loss sum of the row's rows, aux loss) of one
        microbatch ``mb`` (the domain's), the row's rows being
        ``lo:hi``."""
        own = {k: v[lo:hi] for k, v in mb.items()}
        out = model_forward(cfg, params, mb if coupled else own,
                            remat=tcfg.remat, logits_mode="hidden")
        h = out.logits
        if coupled and (lo, hi) != (0, h.shape[0]):
            h = h[lo:hi]
        parts, vrow = unembed_shards(cfg, params, h)
        if cfg.n_img_tokens and "image_embeds" in own:
            parts = [p[:, cfg.n_img_tokens:] for p in parts]
        if vrow is None:
            loss_sum, _ = _masked_nll(parts[0], own["labels"], tcfg.z_loss)
        else:
            loss_sum, _ = _masked_nll_model(parts, own["labels"],
                                            tcfg.z_loss, vrow)
        loss = loss_sum / n_tok
        if shared and nd > 1:
            loss = loss / nd
        aux = tcfg.aux_loss_weight * out.aux_loss
        if (coupled or shared) and nd > 1:
            aux = aux / nd
        return loss + aux, loss_sum.detach(), out.aux_loss.detach()

    def split(B: int):
        """(domain batch, microbatch size, whether each row takes the
        whole microbatch)."""
        n_dom = n_pods if compress else 1
        if B % n_dom or (B // n_dom) % n_mb:
            raise ValueError(f"a batch of {B} does not split over {n_dom} "
                             f"pod(s) and {n_mb} microbatch(es)")
        Bd = B // n_dom
        m = Bd // n_mb
        return Bd, m, m % nd != 0 or m < nd

    def compute(params_like, batch, Bd: int, m: int, shared: bool):
        """Each local position's gradient leaves (its row's, summed over
        the microbatches) and metric inputs (loss sum, aux, count)."""
        leaves = tree.leaves(params_like)
        bounds = [(0, m)] if shared else [(j * m // nd, (j + 1) * m // nd)
                                          for j in range(nd)]
        grads: Dict[int, list] = {}
        stats: Dict[int, torch.Tensor] = {}
        for qs in rows().values():
            home = mesh.device_at(qs[0])
            c = mesh.coords(qs[0])
            pod = c["pod"] if compress else 0
            lo, hi = bounds[0 if shared else
                            PL.mixed_radix(c, sum_axes, sizes)]
            view, flat, owners = row_view(leaves, qs)
            params = tree.unflatten(params_like, view)
            acc = None
            for i in range(n_mb):
                s0 = pod * Bd + i * m
                mb = {k: v[s0:s0 + m].to(home) for k, v in batch.items()}
                counts = [(mb["labels"][a:b] >= 0).float().sum()
                          for a, b in bounds]
                n_tok = counts[0]
                for cnt in counts[1:]:
                    n_tok = n_tok + cnt
                n_tok = torch.clamp_min(n_tok, 1.0)
                total, loss_sum, aux = row_loss(params, mb, lo, hi, n_tok,
                                                shared)
                g = torch.autograd.grad(total, flat, allow_unused=True)
                g = [torch.zeros_like(t) if x is None else x
                     for t, x in zip(flat, g)]
                del total
                if n_mb <= 1:
                    acc = g
                elif acc is None:
                    acc = [x.float() for x in g]
                else:
                    for a_, x in zip(acc, g):
                        a_.add_(x)
            if n_mb > 1:
                acc = [x / n_mb for x in acc]
            for q in qs:
                grads[q] = []
                stats[q] = torch.stack([loss_sum.float(), aux.float(),
                                        n_tok.float()]).to(mesh.device_at(q))
            for x, own in zip(acc, owners):
                for q in own:
                    grads[q].append(x.to(mesh.device_at(q)))
        return grads, stats

    def metrics_of(stats, shared: bool):
        """loss, aux_loss and tokens at each local position: the rows'
        loss sums over the global count (row 0's where every row holds
        the whole batch) and row 0's aux loss; the mean over the pods."""
        out = {}
        for q, parts in PL.all_gather(mesh, stats, sum_axes).items():
            total = parts[0][0]
            if not shared:
                for p in parts[1:]:
                    total = total + p[0]
            n_tok = parts[0][2]
            out[q] = torch.stack([total / n_tok, parts[0][1], n_tok])
        if compress:
            out = {q: sum(parts) / n_pods for q, parts in
                   PL.all_gather(mesh, out, ("pod",)).items()}
        return out

    def pod_sync(grads):
        """The compressed sum over each position's pod subgroup divided
        by the pod count: ``compressed_psum_tree``'s arithmetic, with
        one step a leaf over the pods and the model shards."""
        bits = tcfg.grad_compress_bits
        qmax = float(2 ** (bits - 1) - 1) / n_pods
        amax = {q: torch.stack([torch.max(torch.abs(g.float()))
                                for g in gs]) for q, gs in grads.items()}
        amax = {q: torch.stack(parts).amax(0) for q, parts in
                PL.all_gather(mesh, amax, ("pod", "model")).items()}
        steps = {q: _step(a, tcfg.grad_compress_bound, qmax)
                 for q, a in amax.items()}
        codes = {q: torch.cat([_codes(g.float(), steps[q][i], qmax,
                                      bits).reshape(-1)
                               for i, g in enumerate(gs)])
                 for q, gs in grads.items()}
        out = {}
        for q, parts in PL.all_gather(mesh, codes, ("pod",)).items():
            summed = parts[0]
            for p in parts[1:]:
                summed = summed + p            # exact: codes fit qmax
            summed = summed.split([g.numel() for g in grads[q]])
            out[q] = [(c.reshape(g.shape).float() * steps[q][i])
                      .to(g.dtype) / n_pods
                      for i, (c, g) in enumerate(zip(summed, grads[q]))]
        return out

    def global_norm(grads, leaves):
        """At each local position: a model-sharded leaf's shards summed
        in model order, a replicated leaf once; leaves added in order."""
        sq = {q: torch.stack([torch.sum(torch.square(g.float()))
                              for g in gs]) for q, gs in grads.items()}
        split = [PL.model_dim(s.sharding.spec) is not None for s in leaves]
        out = {}
        for q, parts in PL.all_gather(mesh, sq, ("model",)).items():
            per_leaf = []
            for i, is_split in enumerate(split):
                t = parts[0][i]
                if is_split:
                    for p in parts[1:]:
                        t = t + p[i]
                per_leaf.append(t)
            out[q] = torch.sqrt(sum(per_leaf))
        return out

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree.leaves(state.params)
        if any(s.mesh is not mesh for s in leaves):
            raise ValueError("the state is placed on another mesh than the "
                             "step's")
        Bd, m, shared = split(batch["tokens"].shape[0])
        grads, stats = compute(state.params, batch, Bd, m, shared)
        if nd > 1:
            summed = [PL.axis_sum(mesh, {q: gs[i] for q, gs in grads.items()},
                                  sum_axes, torch.float32)
                      for i in range(len(leaves))]
            grads = {q: [t[q] for t in summed] for q in grads}
        if compress:
            grads = pod_sync(grads)
        metrics = metrics_of(stats, shared)
        gnorm = global_norm(grads, leaves)
        opt = state.opt
        m_leaves, v_leaves = tree.leaves(opt.m), tree.leaves(opt.v)
        om, rels = {}, {}
        for q in grads:
            rels[q] = [_rel(PL.shard_slices(s.sharding, s.shape, q),
                            PL.shard_slices(mo.sharding, mo.shape, q))
                       for s, mo in zip(leaves, m_leaves)]
            _, new, om[q] = adamw_update(
                opt_cfg, AdamWState(opt.step.local[q],
                                    [mo.local[q] for mo in m_leaves],
                                    [v.local[q] for v in v_leaves]),
                [s.local[q][r] for s, r in zip(leaves, rels[q])],
                [g[r] for g, r in zip(grads[q], rels[q])],
                inplace=True, gnorm=gnorm[q])
            opt.step.local[q] = new.step
        # each param shard rebuilt from its positions' ZeRO-1 slices
        for i, (s, mo) in enumerate(zip(leaves, m_leaves)):
            zaxes = tuple(a for a in PL.spec_axes(mo.sharding.spec)
                          if a not in PL.spec_axes(s.sharding.spec))
            if not zaxes:
                continue
            got = PL.all_gather(mesh, {q: s.local[q][rels[q][i]]
                                       for q in grads}, zaxes)
            for q, parts in got.items():
                outer = PL.shard_slices(s.sharding, s.shape, q)
                for q2, part in zip(mesh.members(q, zaxes), parts):
                    if q2 != q:
                        s.local[q][_rel(outer, PL.shard_slices(
                            mo.sharding, mo.shape, q2))] = part
        q0 = next(iter(grads))
        return state, {"loss": metrics[q0][0], "aux_loss": metrics[q0][1],
                       "tokens": metrics[q0][2], **om[q0]}

    return train_step


def step_matmul_flops(cfg, rows: int, seq: int, tp: int = 1, *,
                      local: int = 1, remat: bool = True,
                      device: str = "cpu") -> int:
    """The matmul FLOPs of one train step of a data row's ``local``
    model shards (1: one position, as a rank computes; ``tp``: the
    whole row, as one process does), reckoned from the shapes: the
    count ``torch.utils.flop_counter`` gives for a row computing
    ``rows`` sequences of ``seq`` tokens (over all its microbatches) on
    a model axis of ``tp``, where a split layer (``models.sharding.
    tp_layout``) does 1 / tp of its work on each shard and the rest all
    of it once. A dense config without softcap or window. Each
    projection is 2 N a b FLOPs forward, again under ``remat``, and
    twice in the backward (input and weight), but the recompute skips
    the layer's last product (the checkpoint stops once it has every
    tensor the backward saved: the last local shard's w_down; a row
    spread over several cards of one process recomputes it, through
    ``models.model._FrameGate``, and is not reckoned here); attention's
    core runs ``kernels.flash``'s plain version forward (on the CPU: its
    256-row tiles, those above the diagonal skipped; on CUDA the kernel,
    which no counter sees) and the chunked oracle's recompute and
    gradient (6 products of 2 B H S T Dh) backward; the unembedding is
    outside remat."""
    if (cfg.family != "dense" or cfg.attn_softcap or cfg.final_softcap
            or cfg.local_global_period):
        raise NotImplementedError(f"{cfg.name}: the reckoning covers the "
                                  "plain dense family")
    layout = tp_layout(cfg, tp)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    N = rows * seq
    passes = 4 if remat else 3

    def share(kind):
        """(divisor of the work, times it runs)"""
        return (tp, local) if layout[kind] == "split" else (1, 1)
    (a_div, a_n), (m_div, m_n), (v_div, v_n) = (
        share("attention"), share("mlp"), share("unembed"))
    proj = 2 * N * d * (2 * H * Dh + 2 * Hk * Dh) // a_div
    fwd = 0
    if device == "cpu":
        for i0 in range(0, seq, 256):
            i1 = min(i0 + 256, seq)
            fwd += 2 * 2 * rows * (H // a_div) * (i1 - i0) * i1 * Dh
    core = (passes - 2) * fwd + 6 * 2 * rows * (H // a_div) * seq * seq * Dh
    ffn = 2 * N * d * ff // m_div          # each of w_gate, w_up, w_down
    layer = (a_n * (passes * proj + core) + m_n * passes * 3 * ffn
             - (passes - 3) * ffn)
    return cfg.n_layers * layer + v_n * 3 * 2 * N * d * V // v_div


__all__ = ["make_sharded_train_step", "step_matmul_flops"]
