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
  whole query heads at every tp (``heads_split``; each shard's heads
  from the weight columns ``placement.take_model`` fetches), the MLPs
  by ff, MoE experts by expert (or each expert's ff), the embedding and
  the unembedding by vocabulary, xLSTM's and hymba's recurrent layers
  by their columns (``models.recurrent``), Megatron's layout through
  ``placement.to_model``/``sum_model``; the logits stay vocab shards
  and the masked loss is the vocab-parallel one
  (``step._masked_nll_model``); remat recomputes a layer's collectives
  in the backward, in the forward's order on every rank; a replicated
  weight reaches a split region only through ``to_model``,
  ``split_model`` or ``take_model``, whose backwards sum over
  ``model``, so each rank's gradient of it is the whole one;
* the loss is the global mean: each row's masked sum over the global
  count of labels >= 0, so the rows' gradients sum to the one-device
  gradient; microbatches split the batch first, as the reference's scan
  does, and keep its mean of microbatch means;
* a MoE config's rows compute only their own rows and meet at every MoE
  layer, as the reference's partitioner runs them: the rows of a domain
  (the rows whose gradients sum exactly) advance in lockstep a layer at
  a time (``models.forward_rows``; in one process every local row, one
  backward through all their layers after each row's loss stage;
  across processes the rank's row), each embedding, attending and
  unembedding its own rows, and at
  each MoE layer the rows' normed inputs are gathered
  (``placement.gather_rows``, whose backward is the reduce-scatter in
  row order) so that every row routes the domain batch (the dense
  dispatch sets capacity, drops and the aux loss over every token) and
  keeps its own rows of the output; a row takes 1 / rows of the aux
  loss. The remat unit is one layer over the rows, so the recompute
  gathers again. Where the batch does not divide, each row runs the
  whole microbatch's forward instead;
* under ``layers.MOE_EP_MODE`` with the step's mesh ambient (``with
  mesh:``, as the reference's launcher jits under ``use_mesh``) the
  MoE layers run expert-parallel at the reference's partition: the
  rows advance in lockstep as above (a lone row too), and at each MoE
  layer every (data, model) position routes its row's tokens through
  its own experts, the tokens crossing by an all-to-all over ``model``
  (``layers.moe_ep_rows``; copies in one process, NCCL or gloo across
  processes); no expert leaf is built whole. A batch that does not
  divide over the rows runs so too, every row holding the whole
  microbatch: each position routes its row's share of the tokens
  (``moe_ffn_ep``'s split) and the rows' outputs meet
  (``placement.gather_rows``), so ranks give the one-process bits. A
  layer where the reference's ``moe_ffn_ep`` falls back
  (``layers.ep_shape``: ff not split in m slices, the tokens not split
  over the rows, or at most 4,096 tokens in the domain's microbatch)
  takes the gather above (or, every row holding the batch, routes it
  alone). The aux loss is every position's averaged over ``model`` and
  then over the batch axes, 1 / rows of it a row;
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
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import tree
from ..distributed import placement as PL
from ..distributed.compression import _codes, _step
from ..models import forward as model_forward
from ..models import forward_rows
from ..models import layers as _L
from ..models.layers import ep_shape
from ..models.model import unembed_shards
from ..launch.mesh import active_mesh
from ..models.sharding import (ambient_axes, axes_for_mesh, shard_heads,
                               tp_layout)
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

    def loss_of(params, own: Dict[str, torch.Tensor], h,
                n_tok: torch.Tensor, shared: bool):
        """(the row's loss term, its masked loss sum) from its final
        hidden states ``h``, its rows being ``own``."""
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
        return loss, loss_sum.detach()

    def aux_of(aux_loss, shared: bool):
        aux = tcfg.aux_loss_weight * aux_loss
        if (coupled or shared) and nd > 1:
            aux = aux / nd
        return aux

    def row_grads(params, mbs, spans, n_toks, shared: bool, meet, flat):
        """The gradient of every leaf of ``flat`` (None where unused) and
        each row's (loss sum, aux loss) of one microbatch: ``mbs`` the
        domain's microbatch on each row's home, ``spans`` each row's
        rows of it. With ``meet`` (a ``BatchRows``) the rows run in
        lockstep on their own rows and meet at every MoE layer
        (``models.forward_rows``): each row's loss from its final hidden
        states alone first (its gradient of them and of the
        unembedding: one row's logits live at a time), then one backward
        through every row's layers from those gradients and the rows'
        aux terms. Otherwise each row alone (a coupled MoE runs the
        whole microbatch and keeps its own rows)."""
        owns = [{k: v[lo:hi] for k, v in mb.items()}
                for mb, (lo, hi) in zip(mbs, spans)]
        if meet is None:
            (p,), (mb,), (own,), ((lo, hi),), (n,) = (params, mbs, owns,
                                                       spans, n_toks)
            out = model_forward(cfg, p, mb if coupled else own,
                                remat=tcfg.remat, logits_mode="hidden")
            h = out.logits
            if coupled and (lo, hi) != (0, h.shape[0]):
                h = h[lo:hi]
            loss, loss_sum = loss_of(p, own, h, n, shared)
            g = torch.autograd.grad(loss + aux_of(out.aux_loss, shared),
                                    flat, allow_unused=True)
            return g, [(loss_sum, out.aux_loss.detach())]
        outs = forward_rows(cfg, params, owns, meet, remat=tcfg.remat)
        roots, seeds, head, stats = [], [], [None] * len(flat), []
        for p, own, out, n in zip(params, owns, outs, n_toks):
            h = out.logits.detach().requires_grad_(True)
            loss, loss_sum = loss_of(p, own, h, n, shared)
            gh, *g = torch.autograd.grad(loss, [h] + flat,
                                         allow_unused=True)
            head = [x if y is None else y if x is None else x + y
                    for x, y in zip(head, g)]
            aux = aux_of(out.aux_loss, shared)
            roots += [out.logits, aux]
            seeds += [gh, torch.ones_like(aux)]
            stats.append((loss_sum, out.aux_loss.detach()))
        g = torch.autograd.grad(roots, flat, grad_outputs=seeds,
                                allow_unused=True)
        return [y if x is None else x if y is None else x + y
                for x, y in zip(g, head)], stats

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

    def expert_parallel() -> bool:
        """Whether the MoE layers run expert-parallel: under
        ``layers.MOE_EP_MODE`` with the step's mesh ambient (``with
        mesh:``), as the reference's launcher jits its step under
        ``use_mesh``; a layer still falls back where the reference's
        does (``blocks.moe_block_rows``)."""
        if not (coupled and _L.MOE_EP_MODE) or ambient_axes() is None:
            return False
        if active_mesh() is not mesh:
            raise ValueError("MOE_EP_MODE: the ambient mesh is not the "
                             "step's")
        return True

    def groups(lockstep: bool) -> List[List[List[int]]]:
        """The local rows that compute together, each a list of its
        positions: in lockstep every row of a domain (the rows one MoE
        layer routes: a pod's under compression), in row order; else
        each row alone."""
        if not lockstep:
            return [[qs] for qs in rows().values()]
        out: Dict[int, list] = {}
        for qs in rows().values():
            c = mesh.coords(qs[0])
            out.setdefault(c["pod"] if compress else 0, []).append(
                (PL.mixed_radix(c, sum_axes, sizes), qs))
        return [[qs for _, qs in sorted(g)] for g in out.values()]

    def compute(params_like, batch, Bd: int, m: int, shared: bool):
        """Each local position's gradient leaves (its row's, summed over
        the microbatches) and metric inputs (loss sum, aux, count)."""
        leaves = tree.leaves(params_like)
        bounds = [(0, m)] if shared else [(j * m // nd, (j + 1) * m // nd)
                                          for j in range(nd)]
        lockstep = coupled and (expert_parallel() or (not shared
                                                      and nd > 1))
        grads: Dict[int, list] = {}
        stats: Dict[int, torch.Tensor] = {}
        for group in groups(lockstep):
            homes = [mesh.device_at(qs[0]) for qs in group]
            c = mesh.coords(group[0][0])
            pod = c["pod"] if compress else 0
            meet = (PL.BatchRows(mesh, sum_axes, [qs[0] for qs in group],
                                 bounds * nd if shared else bounds, shared)
                    if lockstep else None)
            spans = (meet.ranges if lockstep else
                     [bounds[0 if shared else
                             PL.mixed_radix(c, sum_axes, sizes)]])
            views = [row_view(leaves, qs) for qs in group]
            params = [tree.unflatten(params_like, v) for v, _, _ in views]
            flat = [t for _, f, _ in views for t in f]
            acc = None
            for i in range(n_mb):
                s0 = pod * Bd + i * m
                mbs = [{k: v[s0:s0 + m].to(h) for k, v in batch.items()}
                       for h in homes]
                n_toks = []
                for mb in mbs:
                    counts = [(mb["labels"][a:b] >= 0).float().sum()
                              for a, b in bounds]
                    n_tok = counts[0]
                    for cnt in counts[1:]:
                        n_tok = n_tok + cnt
                    n_toks.append(torch.clamp_min(n_tok, 1.0))
                g, got = row_grads(params, mbs, spans, n_toks, shared,
                                   meet, flat)
                g = [torch.zeros_like(t) if x is None else x
                     for t, x in zip(flat, g)]
                del mbs
                if n_mb <= 1:
                    acc = g
                elif acc is None:
                    acc = [x.float() for x in g]
                else:
                    for a_, x in zip(acc, g):
                        a_.add_(x)
            if n_mb > 1:
                acc = [x / n_mb for x in acc]
            k = 0
            for qs, (_, f, owners), (loss_sum, aux), n_tok in zip(
                    group, views, got, n_toks):
                for q in qs:
                    grads[q] = []
                    stats[q] = torch.stack([loss_sum.float(), aux.float(),
                                            n_tok.float()]).to(
                                                mesh.device_at(q))
                for x, own in zip(acc[k:k + len(f)], owners):
                    for q in own:
                        grads[q].append(x.to(mesh.device_at(q)))
                k += len(f)
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
        placed = tree.leaves(state.params)
        if any(s.mesh is not mesh for s in placed):
            raise ValueError("the state is placed on another mesh than the "
                             "step's")
        # the leaves at their model split (FSDP's gathered over the batch
        # axes: a copy each; the others themselves)
        leaves = [PL.at_model_split(s) for s in placed]
        Bd, m, shared = split(batch["tokens"].shape[0])
        grads, stats = compute(tree.unflatten(state.params, leaves), batch,
                               Bd, m, shared)
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
        # each param shard rebuilt from its positions' ZeRO-1 slices: a
        # shard that is its moments' slice (FSDP's) copied from it, any
        # other from the model split rebuilt over the moments' axes
        for i, (p, s, mo) in enumerate(zip(placed, leaves, m_leaves)):
            if tuple(p.sharding.spec) == tuple(mo.sharding.spec):
                if p is not s:
                    for q in grads:
                        p.local[q].copy_(s.local[q][rels[q][i]])
                continue
            zaxes = tuple(a for a in PL.spec_axes(mo.sharding.spec)
                          if a not in PL.spec_axes(s.sharding.spec))
            got = PL.all_gather(mesh, {q: s.local[q][rels[q][i]]
                                       for q in grads}, zaxes) if zaxes else {}
            for q, parts in got.items():
                outer = PL.shard_slices(s.sharding, s.shape, q)
                for q2, part in zip(mesh.members(q, zaxes), parts):
                    if q2 != q:
                        s.local[q][_rel(outer, PL.shard_slices(
                            mo.sharding, mo.shape, q2))] = part
            if p is not s:
                for q in grads:
                    p.local[q].copy_(s.local[q][_rel(
                        PL.shard_slices(s.sharding, s.shape, q),
                        PL.shard_slices(p.sharding, p.shape, q))])
        q0 = next(iter(grads))
        return state, {"loss": metrics[q0][0], "aux_loss": metrics[q0][1],
                       "tokens": metrics[q0][2], **om[q0]}

    return train_step


def _scan_flops(passes: int, chunks: int, inter: int, intra: int,
                carry: int) -> int:
    """The matmul FLOPs of a chunkwise scan (``layers.mlstm_scan``,
    ``layers.ssm_scan``) over ``chunks`` chunks, run forward ``passes -
    2`` times and differentiated once, from one chunk's products:
    ``inter`` the readout of the carried state (no gradient to the zero
    state of the first chunk), ``intra`` the chunk's own products (each
    differentiated in both operands) and ``carry`` the state's update
    (nothing of the last chunk's reaches the loss)."""
    fwd = chunks * (inter + intra + carry)
    bwd = ((2 * chunks - 1) * inter + 2 * chunks * intra
           + 2 * (chunks - 1) * carry)
    return (passes - 2) * fwd + bwd


def step_matmul_flops(cfg, rows: int, seq: int, tp: int = 1, *,
                      local: int = 1, position: Optional[int] = None,
                      remat: bool = True, device: str = "cpu",
                      moe_rows: Optional[int] = None,
                      microbatches: int = 1,
                      ep_rows: Optional[int] = None) -> int:
    """The matmul FLOPs of one train step of a data row's ``local``
    model shards (1: one position, as a rank computes; ``tp``: the
    whole row, as one process does, the sum over its shards), reckoned
    from the shapes: the count ``torch.utils.flop_counter`` gives for a
    row computing ``rows`` sequences of ``seq`` tokens (over all its
    microbatches; llava's layers run its ``n_img_tokens`` image
    embeddings before them, whisper's encoder its ``enc_positions``
    frames) on a model axis of ``tp``, where a split layer
    (``models.sharding.tp_layout``) does its shard's part of the work on
    each shard and the rest all of it once. Attention splits by whole
    query heads (``sharding.shard_heads``), unevenly where the heads do
    not divide: one position's count is then that of the model
    coordinate ``position``, which must be given (never an average).
    Every family: dense (gemma2's softcaps and windows too), MoE, llava,
    whisper, xLSTM and hymba. Each projection is 2 N a b FLOPs forward,
    again under ``remat``, and twice in the backward (input and
    weight), but the recompute skips a layer's last product where
    nothing after it is saved (the checkpoint stops once it has every
    tensor the backward saved: the last local shard's w_down, or
    whisper's w2; gemma2's post-norm saves the sum of every shard's, so
    it skips none; a row spread over several cards of one process
    recomputes it, through ``models.model._FrameGate``, and is not
    reckoned here). Attention's core runs ``kernels.flash``'s plain
    version forward (on the CPU: its 256-row tiles, those above the
    diagonal skipped where it is causal; on ``meta`` its tiles of at
    least S / 8; on CUDA the kernel, which no counter sees) and the
    chunked oracle's recompute and gradient (6 products of 2 B H S T Dh)
    backward, H a shard's query heads; a softcap, or a window shorter
    than the sequence, runs the chunked oracle throughout, every chunk
    pair (2 such products a forward, 4 backward). Whisper's
    cross-attention projects its memory's k and v from the encoder's
    frames and attends to them unmasked. The recurrent scans count
    their chunks' products (``_scan_flops``): the mLSTM's per shard
    over its Dh / tp columns of v beside the whole q k^T, hymba's SSM
    per shard over the heads its columns span. Replicated projections
    (q, k and the gates of the mLSTM, hymba's dt/B/C) run once a row; a
    split hymba projects its fused output twice a shard (its heads' rows
    of wo, its own rows). The unembedding is outside remat (llava's
    over its image positions too, whose logits it drops). A MoE config
    (without softcaps) attends and unembeds its ``rows`` and routes
    ``moe_rows`` sequences at every MoE layer, once for each of
    ``microbatches`` (default: the row's own, ``rows`` over the
    microbatches; in lockstep the domain's microbatch): the f32 router
    (d x E) replicated on the row, the three expert products at the
    static capacity (``E x cap`` slots of 2 d ff each) split over
    ``model`` as ``tp_layout``'s "experts" says; the recompute runs all
    of them (the layer's last saved tensor is the combine's). With
    ``ep_rows`` the MoE layers run expert-parallel
    (``layers.moe_ep_rows``) over a domain of that many data rows, each
    routing its own ``rows`` over the microbatches: on each position the
    f32 router over the row's N_loc tokens and the E_loc x cap_loc slots
    of its virtual experts, three products of 2 d ff / m each
    (``layers.ep_shape``), under the same remat rule."""
    fam = cfg.family
    if fam not in ("dense", "ssm", "hybrid", "moe", "vlm", "audio") or (
            fam == "moe" and (cfg.attn_softcap or cfg.final_softcap)):
        raise NotImplementedError(f"{cfg.name}: no reckoning for family "
                                  f"{fam!r} with these options")
    layout = tp_layout(cfg, tp)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = seq + (cfg.n_img_tokens if fam == "vlm" else 0)
    N = rows * S
    passes = 4 if remat else 3

    def share(kind):
        """(divisor of the work, times it runs)"""
        return (tp, local) if layout[kind] == "split" else (1, 1)

    def mine(kind, per_shard: list, whole) -> list:
        """The values of the shards this count covers: every shard's
        (``local == tp``), ``position``'s, or the one value all share."""
        if layout[kind] != "split":
            return [whole]
        if local == tp:
            return per_shard
        if position is not None:
            return [per_shard[position]]
        if len(set(per_shard)) == 1:
            return per_shard[:1]
        raise ValueError(f"{cfg.name}: its shards at tp {tp} differ: give "
                         "the position")
    v_div, v_n = share("unembed")
    unembed = v_n * 3 * 2 * N * d * V // v_div
    if fam == "ssm":
        return _xlstm_flops(cfg, rows, seq, passes, *share("recurrent")) \
            + unembed

    def attention(heads: int, q_len: int, k_len: int, causal: bool = True,
                  window: int = 1 << 30) -> int:
        """The core of ``heads`` query heads over ``rows`` sequences."""
        core = 2 * rows * heads * q_len * k_len * Dh
        if cfg.attn_softcap or window < k_len:    # the chunked oracle
            return passes * 2 * core
        fwd = 0
        if device in ("cpu", "meta"):
            tile = 256 if device == "cpu" else max(256, -(-q_len // 8))
            for i0 in range(0, q_len, tile):
                i1 = min(i0 + tile, q_len)
                keys = min(k_len, i1) if causal else k_len
                fwd += 2 * 2 * rows * heads * (i1 - i0) * keys * Dh
        return (passes - 2) * fwd + 6 * core
    heads = mine("attention", [(s.q[1] - s.q[0], s.kv[1] - s.kv[0])
                               for s in shard_heads(H, Hk, tp)], (H, Hk))
    split = layout["attention"] == "split"

    def proj(n: int) -> List[int]:
        """Each counted shard's q, k, v and o projections over ``n``
        tokens (a whole hymba's fused wo is its own)."""
        q_and_o = 1 if fam == "hybrid" and not split else 2
        return [2 * n * d * Dh * (q_and_o * hq + 2 * hk) for hq, hk in heads]

    def mlp_of(n: int, products: int) -> int:
        """A split (or whole) MLP of ``products`` products over ``n``
        tokens; the recompute skips the last shard's last product unless
        a post-norm follows it."""
        m_div, m_n = share("mlp")
        one = 2 * n * d * ff // m_div
        skip = 0 if cfg.local_global_period else (passes - 3) * one
        return m_n * passes * products * one - skip
    if fam == "audio":
        Te = cfg.enc_positions
        enc = sum(passes * pr + attention(hq, Te, Te, causal=False)
                  for pr, (hq, _) in zip(proj(rows * Te), heads))
        # the cross-attention: q and o over the decoder's tokens, k and v
        # over the memory's frames
        cross = [2 * 2 * d * Dh * (N * hq + rows * Te * hk)
                 for hq, hk in heads]
        dec = sum(passes * (pr + cr) + attention(hq, S, S)
                  + attention(hq, S, Te, causal=False)
                  for pr, cr, (hq, _) in zip(proj(N), cross, heads))
        return (cfg.n_enc_layers * (enc + mlp_of(rows * Te, 2))
                + cfg.n_layers * (dec + mlp_of(N, 2)) + unembed)
    if fam == "moe" and ep_rows:
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        Nm = rows // microbatches * seq
        ep = ep_shape(Nm * ep_rows, ep_rows, tp, E, K, ff,
                      cfg.moe.capacity_factor)
        if ep is None:
            raise ValueError(f"{cfg.name}: expert parallelism falls back at "
                             f"{Nm * ep_rows} tokens over {ep_rows} rows")
        mlp = microbatches * passes * local * (
            2 * Nm * d * E + 3 * 2 * ep.e_loc * ep.cap_loc * d * ff // ep.m)
    elif fam == "moe":
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        Nm = (moe_rows or rows // microbatches) * seq
        cap = int(np.ceil(Nm * K / E * cfg.moe.capacity_factor / 8)) * 8
        e_div, e_n = (1, 1) if layout["experts"] == "whole" else (tp, local)
        mlp = microbatches * passes * (2 * Nm * d * E + e_n * 3 * 2 * E
                                       * cap * d * ff // e_div)
    elif fam != "hybrid":
        mlp = mlp_of(N, 3)
    from ..models.model import window_schedule
    if fam != "hybrid":
        return sum(sum(passes * pr + attention(hq, S, S, window=int(w))
                       for pr, (hq, _) in zip(proj(N), heads)) + mlp
                   for w in window_schedule(cfg)) + unembed
    r_div, r_n = share("recurrent")
    dtbc = 2 * N * d * (H + 2 * H * cfg.ssm_state)
    own = 2 * 2 * N * d * (H * Dh // r_div)          # ssm_in and wo
    n = H * Dh // r_div
    spans = mine("recurrent", [-(-(c0 + n) // Dh) - c0 // Dh
                               for c0 in range(0, H * Dh, n)], H)
    L = _chunk(seq)
    NS, c = cfg.ssm_state, seq // L
    scan = _scan_flops(passes, c, 2 * rows * L * sum(spans) * NS * Dh,
                       2 * rows * L * L * sum(spans) * Dh,
                       2 * rows * L * sum(spans) * NS * Dh)
    mlp = mlp_of(N, 3)
    return sum(passes * (dtbc + sum(proj(N)) + r_n * own) + sum(
        attention(hq, S, S, window=int(w)) for hq, _ in heads) + scan + mlp
        for w in window_schedule(cfg)) + unembed


def _chunk(seq: int) -> int:
    """The recurrent scans' chunk at ``seq`` positions."""
    from ..models.layers import _pick_chunk
    return _pick_chunk(seq, 256)


def _xlstm_flops(cfg, rows: int, seq: int, passes: int, div: int,
                 n: int) -> int:
    """``step_matmul_flops``' layers of xLSTM: each mLSTM's q, k and
    gate projections once, its v, z and down projections and its scan
    on each of ``n`` shards of Dh / ``div`` columns, each sLSTM's
    projections on ``n`` shards of d / ``div`` columns; the recompute
    skips each layer's last down-projection."""
    from ..models.model import _xlstm_groups
    d, H = cfg.d_model, cfg.n_heads
    D, N = d // H, rows * seq
    G, per = _xlstm_groups(cfg)
    down = 2 * N * d * d // div
    L = _chunk(seq)
    c = seq // L
    Dv = D // div
    scan = _scan_flops(passes, c, 2 * rows * L * H * Dv * D,
                       2 * rows * L * L * H * (Dv + D),
                       2 * rows * L * H * (Dv + 1) * D)
    mlstm = (passes * (2 * 2 * N * d * d + 2 * N * d * 2 * H + n * 3 * down)
             + n * scan - (passes - 3) * down)
    slstm = passes * n * 5 * down - (passes - 3) * down
    return G * ((per - 1) * mlstm + slstm)


__all__ = ["make_sharded_train_step", "step_matmul_flops"]
