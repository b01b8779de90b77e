"""LM serving launcher on one GPU: batched greedy decoding with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch smollm-135m \\
      --smoke --batch 4 --prompt-len 16 --new-tokens 32

The flags are those of ``repro.launch.serve_lm``; there is no mesh.
``--arch`` takes every config of ``configs`` (dense, gemma2, MoE, llava,
whisper, xLSTM and hymba). Like the reference launcher it prefills token
by token through decode steps (``serve.greedy_generate``): llava gets no
image embeddings and whisper's encoder memory stays the cache's zeros,
as there; xLSTM and hymba build their recurrent states this way. Decode
steps run the attention in plain torch, so for the decoder-only families
the launcher launches no kernel (the flash kernel runs where the prompt
goes through the full forward, in ``serve.make_prefill``;
``chip_smoke.py`` drives that path). Whisper's steps do: each layer's cross-attention over
the 1,500-frame memory is one flash launch a step. Runs on CUDA; a
caller of ``main`` may pass ``device="cpu"``."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import DeviceLike, resolve_device
from ..models import init_params
from ..serve import greedy_generate


def main(argv=None, *, device: DeviceLike = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        .astype(np.int32)).to(dev)

    t0 = time.perf_counter()
    with torch.inference_mode():
        gen_tokens = greedy_generate(cfg, params, prompt, args.new_tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tput = args.batch * gen_tokens.shape[1] / dt
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"generated={gen_tokens.shape[1]} tok/req in {dt:.2f}s "
          f"({tput:.1f} tok/s aggregate)")
    print("sample:", gen_tokens[0].cpu().numpy()[:16])
    return gen_tokens


if __name__ == "__main__":
    main()
