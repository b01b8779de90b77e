"""repro_torch.models — the transformer families of ``repro.models`` in
PyTorch (dense, gemma2's local/global, MoE, the llava backbone and
whisper's encoder-decoder): the reference's parameter dicts (blocks
stacked on a leading layer axis), activations (B, S, H, Dh) and KV cache
(L, B, T, Hk, Dh). Plain causal or full attention runs the hand-written
flash kernel (``kernels.flash``) on CUDA tensors. Sharding is not
ported: on one GPU the reference's ``constrain_*`` calls are the
identity, and ``moe_ffn_ep`` falls back to ``moe_ffn`` there."""
from .config import ArchConfig, MoEConfig, ShapeConfig, SHAPES, shape_by_name
from .model import (init_params, forward, decode_step, init_decode_cache,
                    window_schedule, ForwardOut)

__all__ = [
    "ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "shape_by_name",
    "init_params", "forward", "decode_step", "init_decode_cache",
    "window_schedule", "ForwardOut",
]
