"""repro_torch.models — every family of ``repro.models`` in PyTorch
(dense, gemma2's local/global, MoE, the llava backbone, whisper's
encoder-decoder, and the recurrent xLSTM and hymba of ``recurrent``):
the reference's parameter dicts (blocks stacked on a leading layer axis),
activations (B, S, H, Dh), KV cache (L, B, T, Hk, Dh) and recurrent
states. Plain causal or full attention runs the hand-written flash kernel
(``kernels.flash``) on CUDA tensors; the recurrent scans are plain torch,
as the reference's are plain jnp. Sharding is not ported: on one GPU the
reference's ``constrain_*`` calls are the identity, and ``moe_ffn_ep``
falls back to ``moe_ffn`` there."""
from . import recurrent
from .config import ArchConfig, MoEConfig, ShapeConfig, SHAPES, shape_by_name
from .model import (init_params, forward, decode_step, init_decode_cache,
                    window_schedule, ForwardOut)

__all__ = [
    "ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "shape_by_name",
    "init_params", "forward", "decode_step", "init_decode_cache",
    "window_schedule", "ForwardOut", "recurrent",
]
