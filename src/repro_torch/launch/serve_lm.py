"""LM serving launcher: batched greedy decoding with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch smollm-135m \\
      --smoke --batch 4 --prompt-len 16 --new-tokens 32

The flags are those of ``repro.launch.serve_lm``. The mesh is the
reference's choice (``repro/launch/serve_lm.py:38-39``,
``launch.mesh.launcher_mesh``): the 1 x 1 host mesh on one device,
otherwise ``make_production_mesh()`` over the processes of
``init_distributed`` or the visible cards; ``main(mesh=)`` takes a
smaller one. As in the reference no parameter is placed: the params
stay whole on each data row's device (a row is a position of the batch
axes), the requests split over the rows (every row takes them all
where they do not divide, and row 0's tokens are kept), and each row
runs ``serve.greedy_generate`` on its own requests. A MoE config's rows
decode in lockstep instead (``serve.greedy_generate_rows``): at every
MoE layer the rows' tokens meet (``placement.gather_rows``) and each row
routes the whole batch, as the reference's step does, so capacity and
drops, and the tokens, are the 1 x 1 run's at any batch. Across
processes the rows' tokens are all-gathered, so every rank returns the
whole batch's. ``--arch`` takes every config of ``configs`` (dense, gemma2,
MoE, llava, whisper, xLSTM and hymba). Like the reference launcher it
prefills token by token through decode steps: llava gets no image
embeddings and whisper's encoder memory stays the cache's zeros, as
there; xLSTM and hymba build their recurrent states this way. Decode
steps run the attention in plain torch, so for the decoder-only
families the launcher launches no kernel (the flash kernel runs where
the prompt goes through the full forward, in ``serve.make_prefill``;
``chip_smoke.py`` drives that path). Whisper's steps do: each layer's
cross-attention over the 1,500-frame memory is one flash launch a step.
Runs on CUDA; a caller of ``main`` may pass ``device="cpu"``."""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from .. import tree
from ..configs import get_config, get_smoke_config
from ..device import DeviceLike, resolve_device
from ..distributed.placement import BatchRows, all_gather, mixed_radix
from ..models import init_params
from ..models.sharding import axes_for_mesh
from ..serve import greedy_generate, greedy_generate_rows
from .mesh import launcher_mesh


def _sync(devs) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None, *, device: DeviceLike = None, mesh=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if mesh is None:
        mesh = launcher_mesh(resolve_device(device))
    local = mesh.local_positions()
    dev = mesh.device_at(local[0])
    ax = axes_for_mesh(mesh)
    dp = math.prod(mesh.shape[a] for a in ax.batch)
    # each data row of this process: its first position's device
    homes = {}
    for q in local:
        homes.setdefault(mixed_radix(mesh.coords(q), ax.batch, mesh.shape),
                         (q, mesh.device_at(q)))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = {dev: init_params(cfg, gen, dev)}
    for _, d in homes.values():
        if d not in params:
            params[d] = tree.tree_map(lambda t: t.to(d), params[dev])
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        .astype(np.int32))
    shared = args.batch % dp != 0
    per = args.batch if shared else args.batch // dp

    _sync([d for _, d in homes.values()])
    t0 = time.perf_counter()
    outs = {}
    with torch.inference_mode():
        if cfg.moe is not None and not shared and dp > 1:
            order = sorted(homes)
            meet = BatchRows(mesh, ax.batch, [homes[r][0] for r in order],
                             [(r * per, (r + 1) * per) for r in range(dp)])
            got = greedy_generate_rows(
                cfg, [params[homes[r][1]] for r in order],
                [prompt[lo:hi].to(d) for (lo, hi), d in
                 zip(meet.ranges, meet.homes)], args.new_tokens, meet)
            outs = dict(zip(meet.positions, got))
        else:
            for r, (q, d) in homes.items():
                lo = 0 if shared else r * per
                outs[q] = greedy_generate(cfg, params[d],
                                          prompt[lo:lo + per].to(d),
                                          args.new_tokens)
        _sync([d for _, d in homes.values()])
        if mesh.multi_process:
            (q,) = outs
            rows = all_gather(mesh, outs, ax.batch)[q]
        else:
            rows = [outs[homes[r][0]].to(homes[0][1]) for r in sorted(homes)]
    gen_tokens = rows[0] if shared else torch.cat(rows, 0)
    dt = time.perf_counter() - t0
    tput = args.batch * gen_tokens.shape[1] / dt
    if mesh.is_rank0():
        print(f"arch={cfg.name} device={dev} mesh={mesh.shape} "
              f"batch={args.batch} generated={gen_tokens.shape[1]} tok/req "
              f"in {dt:.2f}s ({tput:.1f} tok/s aggregate)")
        print("sample:", gen_tokens[0].cpu().numpy()[:16])
    return gen_tokens


if __name__ == "__main__":
    main()
