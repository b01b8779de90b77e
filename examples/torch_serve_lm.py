"""Batched LM serving with KV / recurrent-state caches on the
PyTorch/CUDA port, as ``examples/serve_lm.py`` runs it on ``repro``:
greedy decoding for three architecture families (dense GQA, xLSTM
recurrent state, hymba's hybrid ring-buffer sliding window) at their
smoke configs.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

It runs on the GPU unless ``--device cpu`` says otherwise; without a GPU
it raises instead of falling back to the CPU. ``greedy_generate``, like
the reference's, decodes token by token from position 0 through decode
steps only, and no decode step calls the flash kernel, so this example
launches no kernel of the port (``python -m repro_torch.launch.serve_lm``
serves a prefill through it).

``main(argv)`` returns each model's generated tokens.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import greedy_generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    tokens = {}
    for arch in ("smollm-135m", "xlstm-1.3b", "hymba-1.5b"):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        prompt = torch.as_tensor(
            np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 8)),
            dtype=torch.int32, device=dev)
        out = greedy_generate(cfg, params, prompt, n_new=8)
        assert out.shape == (2, 8), out.shape
        assert bool(torch.all((out >= 0) & (out < cfg.vocab)))
        # determinism: same prompt -> same continuation
        out2 = greedy_generate(cfg, params, prompt, n_new=8)
        assert bool(torch.equal(out, out2))
        tokens[cfg.name] = out.cpu().numpy()
        print(f"{cfg.name:18s} generated {out.shape[1]} tokens/req "
              f"(batch={out.shape[0]}): {tokens[cfg.name][0][:8]}")
    print("OK")
    return tokens


if __name__ == "__main__":
    main()
