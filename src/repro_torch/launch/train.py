"""Training launcher on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 --smoke --ckpt-dir /tmp/ckpt

The flags are those of ``repro.launch.train`` plus ``--device`` (cuda
unless it says ``cpu``; without a GPU and without ``--device cpu`` the
launcher raises). It runs the train stack of ``repro_torch.train``
(AdamW, the train step with remat, microbatches and the optional
compressed gradient sync), the token pipeline, checkpointing with
auto-resume and the straggler watchdog on the reference's degenerate
1 x 1 host mesh (``launch.mesh.make_host_mesh``), which has one pod, so
``--grad-compress`` changes nothing there, as in the reference. The
weights are drawn from ``--seed`` by ``torch.Generator`` (not the
reference's numbers); llava gets zero ``image_embeds`` and whisper zero
``frames``, in bf16, as the reference launcher gives them. It prints the
reference's log lines and closing JSON line ``{"final_loss",
"first_loss", "improved"}``; ``main`` returns a ``TrainRun`` (the
losses, each step's seconds, the checkpoints' seconds and bytes, and the
final state)."""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import TokenPipeline
from ..device import _d2h, _h2d, full_precision_matmuls, resolve_device
from ..distributed import StepWatchdog
from ..train import (AdamWConfig, TrainState, TrainStepConfig,
                     init_train_state, make_train_step)
from .mesh import make_host_mesh


@dataclasses.dataclass
class TrainRun:
    """What one launcher run did: the loss of every step it ran (from
    ``start_step``), each step's seconds (host clock around the step and
    the read of its loss, which waits for the device), the checkpoints it
    saved as (step, seconds, bytes), the seconds of the restore under
    ``--resume`` (None without one), and the final state."""
    losses: List[float]
    step_seconds: List[float]
    start_step: int
    saves: List[Tuple[int, float, int]]
    restore_seconds: Optional[float]
    state: TrainState


def main(argv=None) -> TrainRun:
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
    dev = resolve_device(args.device)
    mesh = make_host_mesh(dev)
    print(f"arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M "
          f"device={dev} mesh={mesh.shape}")
    if dev.type == "cuda":
        full_precision_matmuls()

    tcfg = TrainStepConfig(n_microbatches=args.microbatches,
                           grad_compress=args.grad_compress,
                           n_pods=mesh.shape.get("pod", 1))
    opt_cfg = AdamWConfig(lr_peak=args.lr,
                          warmup_steps=max(args.steps // 20, 5),
                          decay_steps=args.steps)
    step_fn = make_train_step(cfg, tcfg, opt_cfg, mesh=mesh)
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)

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
                state, start_step = mgr.restore_latest(state)
                restore_s = time.perf_counter() - t0
                print(f"resumed from step {start_step}")
            except FileNotFoundError:
                print("no checkpoint found; starting fresh")

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
        with wd.timed() as timer:
            state, metrics = step_fn(state, batch)
            loss = float(_d2h(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if timer.verdict == "rebalance":
            print(f"[watchdog] step {step}: persistent straggling — "
                  "checkpoint + elastic restart recommended")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={loss:.4f} "
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
        print(json.dumps({"final_loss": losses[-1],
                          "first_loss": losses[0],
                          "improved": losses[-1] < losses[0]}))
    return TrainRun(losses, seconds, start_step, saves, restore_s, state)


if __name__ == "__main__":
    main()
