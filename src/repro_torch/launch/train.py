"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 --smoke --ckpt-dir /tmp/ckpt
  torchrun --nproc-per-node 256 -m repro_torch.launch.train ...

The flags are those of ``repro.launch.train`` plus ``--device`` (cuda
unless it says ``cpu``; without a GPU and without ``--device cpu`` the
launcher raises), where the chosen mesh lies; a mesh passed to ``main``
names its own devices. The mesh is the reference's choice
(``repro/launch/train.py:52-53``): the degenerate 1 x 1 host mesh
(``launch.mesh.make_host_mesh``) on one device, otherwise
``make_production_mesh()`` over the processes that ``init_distributed``
joins (torchrun's environment; a rank a position, raising without 256
of them) or over the visible cards of one process. ``main(mesh=)``
takes a smaller mesh instead (one process, or over a process group).
The state is placed as the reference's ``in_shardings`` place it:
params by ``specs.param_shardings``, AdamW's moments by
``specs.opt_state_shardings(zero1=)`` with ZeRO-1 past one position,
and ``make_train_step(mesh=)`` runs the sharded step (``train.sharded``);
on the 1 x 1 mesh it is bitwise the one-device step, and a one-pod mesh
makes ``--grad-compress`` change nothing, as in the reference.

It runs the token pipeline, checkpointing with auto-resume (a checkpoint
holds the gathered tensors and restores on any mesh) and the straggler
watchdog. The weights are drawn from ``--seed`` by ``torch.Generator``
(not the reference's numbers; every process draws them whole and keeps
its shards); llava gets zero ``image_embeds`` and whisper zero
``frames``, in bf16, as the reference launcher gives them. Rank 0 prints
the reference's log lines and closing JSON line ``{"final_loss",
"first_loss", "improved"}``; ``main`` returns a ``TrainRun`` (the
losses, each step's seconds, the checkpoints' seconds and bytes, each
position's resident bytes, and the final state, gathered)."""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import TokenPipeline
from ..device import _d2h, _h2d, full_precision_matmuls, resolve_device
from ..distributed import StepWatchdog
from ..distributed.placement import gather_tree, place_tree, resident_bytes
from ..train import (AdamWConfig, TrainState, TrainStepConfig,
                     init_train_state, make_train_step)
from . import specs as S
from .mesh import launcher_mesh


@dataclasses.dataclass
class TrainRun:
    """What one launcher run did: the loss of every step it ran (from
    ``start_step``), each step's seconds (host clock around the step and
    the read of its loss, which waits for the device), the checkpoints it
    saved as (step, seconds, bytes), the seconds of the restore under
    ``--resume`` (None without one), the final state gathered whole
    (on the 1 x 1 mesh its own tensors), the bytes of the placed state
    each of this process's mesh positions holds (flat position ->
    bytes), and the mesh."""
    losses: List[float]
    step_seconds: List[float]
    start_step: int
    saves: List[Tuple[int, float, int]]
    restore_seconds: Optional[float]
    state: TrainState
    resident_bytes: Dict[int, int]
    mesh: object


def main(argv=None, *, mesh=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if mesh is None:
        mesh = launcher_mesh(resolve_device(args.device))
    # the state is drawn whole on this process's first position's device
    dev = mesh.device_at(mesh.local_positions()[0])
    log = print if mesh.is_rank0() else (lambda *a, **k: None)
    log(f"arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M "
        f"device={dev} devices={mesh.size} mesh={mesh.shape}")
    if dev.type == "cuda":
        full_precision_matmuls()

    tcfg = TrainStepConfig(n_microbatches=args.microbatches,
                           grad_compress=args.grad_compress,
                           n_pods=mesh.shape.get("pod", 1))
    opt_cfg = AdamWConfig(lr_peak=args.lr,
                          warmup_steps=max(args.steps // 20, 5),
                          decay_steps=args.steps)
    step_fn = make_train_step(cfg, tcfg, opt_cfg, mesh=mesh)
    shardings = TrainState(
        params=S.param_shardings(cfg, mesh),
        opt=S.opt_state_shardings(cfg, mesh, zero1=mesh.size > 1))
    state = place_tree(init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev),
        shardings)

    pipe = TokenPipeline(vocab_size=cfg.vocab, batch=args.batch,
                         seq_len=args.seq, seed=args.seed)
    mgr = None
    start_step = 0
    restore_s = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
        if args.resume:
            try:
                t0 = time.perf_counter()
                state, start_step = mgr.restore_latest(state,
                                                       shardings=shardings)
                restore_s = time.perf_counter() - t0
                log(f"resumed from step {start_step}")
            except FileNotFoundError:
                log("no checkpoint found; starting fresh")

    wd = StepWatchdog()
    losses, seconds, saves = [], [], []
    for step in range(start_step, args.steps):
        batch = {k: _h2d(v, dev) for k, v in pipe.get_batch(step).items()}
        if cfg.n_img_tokens:
            batch["image_embeds"] = torch.zeros(
                (args.batch, cfg.n_img_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if cfg.enc_dec:
            batch["frames"] = torch.zeros(
                (args.batch, cfg.enc_positions, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        t0 = time.perf_counter()
        with wd.timed() as timer, mesh:
            state, metrics = step_fn(state, batch)
            loss = float(_d2h(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if timer.verdict == "rebalance":
            log(f"[watchdog] step {step}: persistent straggling — "
                "checkpoint + elastic restart recommended")
        if step % args.log_every == 0 or step == args.steps - 1:
            log(f"step {step:5d} loss={loss:.4f} "
                f"gnorm={float(_d2h(metrics['grad_norm'])):.3f} "
                f"lr={float(_d2h(metrics['lr'])):.2e}")
        if mgr:
            t0 = time.perf_counter()
            path = mgr.maybe_save(step + 1, state)
            if path is not None:
                saves.append((step + 1, time.perf_counter() - t0,
                              sum(f.stat().st_size
                                  for f in Path(path).iterdir())))

    if losses:
        log(json.dumps({"final_loss": losses[-1], "first_loss": losses[0],
                        "improved": losses[-1] < losses[0]}))
    return TrainRun(losses, seconds, start_step, saves, restore_s,
                    gather_tree(state), resident_bytes(state), mesh)


if __name__ == "__main__":
    main()
