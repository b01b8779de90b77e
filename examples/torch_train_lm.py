"""Train a reduced smollm-135m on the PyTorch/CUDA port, as
``examples/train_lm.py`` trains it on ``repro``: the train launcher's
full stack (the mesh, AdamW, remat, fault-tolerant checkpointing: kill
it mid-run and re-run with --resume) at the smoke config.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --steps 200 --resume

It runs on the GPU unless ``--device cpu`` says otherwise; without a GPU
it raises instead of falling back to the CPU. On the card the smoke
config's 16-wide heads go through the ``flash`` kernel, twice a step
a layer (the forward and its remat recompute). Checkpoints go under
``--ckpt-dir`` (default ``repro_torch_ckpt_demo`` in the temporary
directory, ``$TMPDIR`` or ``/tmp``). A resume whose
checkpoint is already at ``--steps`` runs no step.

``main(argv)`` returns the launcher's ``TrainRun`` (its ``losses``,
``start_step``, checkpoint saves and final state).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt_demo"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    args = ["--arch", "smollm-135m", "--smoke", "--steps", str(a.steps),
            "--batch", "8", "--seq", "128", "--lr", "3e-3",
            "--ckpt-dir", a.ckpt_dir, "--ckpt-every", str(a.ckpt_every)]
    if a.device is not None:
        args += ["--device", a.device]
    if a.resume:
        args.append("--resume")
    run = train_main(args)
    if len(run.losses) > 1:
        assert run.losses[-1] < run.losses[0], \
            "training did not improve the loss"
    else:
        print(f"started at step {run.start_step} of {a.steps}: "
              f"{len(run.losses)} step(s) run")
    return run


if __name__ == "__main__":
    main()
