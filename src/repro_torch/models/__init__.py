"""repro_torch.models — the dense LM family of ``repro.models`` in
PyTorch: the reference's parameter dicts (blocks stacked on a leading
layer axis), activations (B, S, H, Dh) and KV cache (L, B, T, Hk, Dh).
The prefill's attention runs the hand-written flash kernel
(``kernels.flash``) on CUDA tensors. Sharding is not ported: on one GPU
the reference's ``constrain_*`` calls are the identity."""
from .config import ArchConfig, MoEConfig, ShapeConfig, SHAPES, shape_by_name
from .model import (init_params, forward, decode_step, init_decode_cache,
                    window_schedule, ForwardOut)

__all__ = [
    "ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "shape_by_name",
    "init_params", "forward", "decode_step", "init_decode_cache",
    "window_schedule", "ForwardOut",
]
