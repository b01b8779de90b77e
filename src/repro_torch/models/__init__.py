"""repro_torch.models — every family of ``repro.models`` in PyTorch
(dense, gemma2's local/global, MoE, the llava backbone, whisper's
encoder-decoder, and the recurrent xLSTM and hymba of ``recurrent``):
the reference's parameter dicts (blocks stacked on a leading layer axis),
activations (B, S, H, Dh), KV cache (L, B, T, Hk, Dh) and recurrent
states. Plain causal or full attention runs the hand-written flash kernel
(``kernels.flash``) on CUDA tensors; the recurrent scans are plain torch,
as the reference's are plain jnp. ``forward`` is differentiable for
every family (``forward(..., remat=True)`` recomputes each layer in the
backward), which ``train`` builds on. ``sharding`` holds the reference's
mesh axes and parameter sharding rules; its ``constrain_*`` hints are the
identity (no SPMD partitioner), and the expert-parallel MoE runs a
(data, model) position at a time over the ambient mesh
(``layers.moe_ffn_ep`` on the whole batch, ``layers.moe_ep_rows`` on a
position's own experts in the sharded step and the sharded serving).
``forward_rows`` and ``decode_step_model`` run data rows of every
family over placed params and (the decode step) a serving state split
as ``launch.specs.cache_shardings`` splits it."""
from . import recurrent
from .config import ArchConfig, MoEConfig, ShapeConfig, SHAPES, shape_by_name
from .model import (init_params, forward, decode_step, init_decode_cache,
                    window_schedule, ForwardOut, forward_rows,
                    decode_step_model, greedy_tokens)

__all__ = [
    "ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "shape_by_name",
    "init_params", "forward", "decode_step", "init_decode_cache",
    "window_schedule", "ForwardOut", "recurrent", "forward_rows",
    "decode_step_model", "greedy_tokens",
]
