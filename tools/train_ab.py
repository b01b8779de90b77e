#!/usr/bin/env python3
"""The one-device train step against the sharded step on one card, in
turns, with each step split.

    python3 tools/train_ab.py                 # smollm-135m, 8 x 2048, bf16
    python3 tools/train_ab.py --steps 6 --seq 1024

Three legs from one seeded state (chip_smoke's 11a cell): the plain
state through ``make_train_step`` (the one-device step), the state
placed on the 1 x 1 host mesh (the sharded step, as the launcher runs
it on one card), and the state placed on a (2, 2) ``("data", "model")``
mesh with every position on the card. They run in turns (one-device,
1 x 1, 2 x 2, 2 x 2, 1 x 1, one-device), each ``--steps`` steps of the
token pipeline's batches. A step is timed on the host clock with the
card synchronized around it, and split the same way into the backward
(every outermost ``torch.autograd.grad`` call, remat's recompute in
it), what follows the last one (the gradients' sum over the rows, the
norm, AdamW and the params' rebuild) and the rest (the rows' forwards
and losses). One JSON record a leg, then one with each leg's median
after the first step; the last line is ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def grad_clock(parts: dict):
    """Adds the synchronized seconds of every outermost
    ``torch.autograd.grad`` call (the backward, remat's recompute in it;
    the attention's backward calls it again inside) to ``parts`` and
    keeps the host time the last one ended."""
    import torch
    real = torch.autograd.grad
    depth = [0]

    def timed(*a, **k):
        if depth[0]:
            return real(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depth[0] += 1
        try:
            out = real(*a, **k)
        finally:
            depth[0] -= 1
        torch.cuda.synchronize()
        parts["last_end"] = time.perf_counter()
        parts["backward_s"] = parts.get("backward_s", 0.0) + \
            parts["last_end"] - t0
        return out
    torch.autograd.grad = timed
    try:
        yield
    finally:
        torch.autograd.grad = real


def leg(name: str, args, cfg) -> dict:
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import placement
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.train import (AdamWConfig, TrainState, TrainStepConfig,
                                   init_train_state, make_train_step)
    mesh = {"one-device": None, "1x1": make_host_mesh("cuda:0"),
            "2x2": make_mesh((2, 2), ("data", "model"),
                             devices=["cuda:0"] * 4)}[name]
    state = init_train_state(cfg, torch.Generator(device="cuda")
                             .manual_seed(args.seed), "cuda")
    if mesh is not None:
        state = placement.place_tree(state, TrainState(
            specs.param_shardings(cfg, mesh),
            specs.opt_state_shardings(cfg, mesh, zero1=mesh.size > 1)))
    fn = make_train_step(cfg, TrainStepConfig(), AdamWConfig(
        lr_peak=3e-4, warmup_steps=5, decay_steps=args.steps), mesh=mesh)
    pipe = TokenPipeline(vocab_size=cfg.vocab, batch=args.batch,
                         seq_len=args.seq, seed=args.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in pipe.get_batch(i).items()}
        parts: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with grad_clock(parts):
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = t1 - parts.pop("last_end")
        steps.append({"step_s": t1 - t0, "backward_s": parts["backward_s"],
                      "forward_loss_s": t1 - t0 - parts["backward_s"] - after,
                      "after_backward_s": after})
    del state
    torch.cuda.empty_cache()
    return {"leg": name, "steps": steps, "losses": losses,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.device import full_precision_matmuls
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    full_precision_matmuls()
    _build.build_all(("flash",))
    cfg = get_config("smollm-135m")
    runs: dict = {}
    for name in ("one-device", "1x1", "2x2", "2x2", "1x1", "one-device"):
        rec = leg(name, args, cfg)
        print(json.dumps(rec), flush=True)
        runs.setdefault(name, []).append(rec)
    summary = {}
    for name, recs in runs.items():
        later = [s for r in recs for s in r["steps"][1:]]
        summary[name] = {k: statistics.median(s[k] for s in later)
                         for k in later[0]}
        summary[name]["peak_device_bytes"] = max(
            r["peak_device_bytes"] for r in recs)
    print(json.dumps({"phase": "train_ab", "model": cfg.name,
                      "batch": args.batch, "seq": args.seq,
                      "steps": args.steps, "card": smi[0],
                      "median_after_first": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
