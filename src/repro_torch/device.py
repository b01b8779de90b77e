"""Device policy of the port.

Entry points take ``device=None``, which means ``cuda``. When CUDA is
absent and the caller did not ask for the CPU, they raise: there is no
silent CPU fallback, so a run that was meant for the GPU never
measures the CPU by accident. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .debug.guards import seam

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``None`` means
    ``cuda``; a CUDA device without a GPU raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is available: repro_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def full_precision_matmuls() -> dict:
    """Set the process-wide matmul flags the LM path's numerics assume and
    return them: no TF32 for f32 GEMMs or convolutions, and bf16 GEMMs
    reduce in f32, as the reference's XLA dots do (PyTorch's default lets
    cuBLAS reduce bf16 GEMMs in bf16). The serving factories call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return {"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": False,
            "cuda.matmul.allow_bf16_reduced_precision_reduction": False}


_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch float dtype matching a numpy dtype (or its name)."""
    import numpy as np
    name = np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"repro_torch serves float32/float64 fields, got {name}") from None


def _h2d(x, device) -> torch.Tensor:
    """The host->device seam: a numpy array (or scalar) copied into a new
    tensor on ``device``. The copy is also made for the CPU, so later
    in-place work never reaches the caller's array. ``debug.no_transfers``
    permits and counts it."""
    import numpy as np
    x = np.asarray(x)
    if not (x.flags.c_contiguous and x.flags.writeable):
        x = x.copy(order="C")
    with seam("h2d", x.nbytes):
        return torch.from_numpy(x).to(device=device, copy=True)


def _d2h(t: torch.Tensor):
    """The device->host seam: a tensor as a numpy array, permitted and
    counted by ``debug.no_transfers``."""
    with seam("d2h", t.numel() * t.element_size()):
        return t.detach().cpu().numpy()
