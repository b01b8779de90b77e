"""MSz on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors ``repro``'s module and function names so each
counterpart is easy to find, and produces bitwise-identical results:
direction codes, fix-source masks, MSS labels, int32 residual codes,
the corrected field ``g``, fix-loop iteration counts and every payload
byte. It imports ``torch`` and never ``jax`` or ``repro``.

This slice serves the main path: the MSS-preserving ``szlike`` round
trip (``compress.pipeline.compress_preserving_mss`` /
``decompress_preserving_mss``) in fused mode with DEFLATE entropy, on
the device path. Three hand-written CUDA kernels carry it
(``kernels.extrema``, ``kernels.fixpass``, ``kernels.lorenzo``); each
has a plain PyTorch version beside it that CPU tensors reach.

Entry points take ``device=None``, meaning CUDA; without a GPU they
raise unless the caller passes ``device="cpu"`` (``device.py``).
"""
