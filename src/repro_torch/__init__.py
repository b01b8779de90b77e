"""MSz on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors ``repro``'s module and function names so each
counterpart is easy to find. It imports ``torch`` and never ``jax`` or
``repro``. Two paths are served:

* The MSS-preserving ``szlike`` round trip
  (``compress.pipeline.compress_preserving_mss`` /
  ``decompress_preserving_mss``) in fused mode on the device path, with
  DEFLATE (``entropy="deflate"``, SZJ2) or on-device bitplane entropy
  (``entropy="device-pack"``, SZP1). It is bitwise the reference:
  direction codes, fix-source masks, MSS labels, int32 residual codes,
  the corrected field ``g``, fix-loop iteration counts and every payload
  byte. Kernels: ``kernels.extrema``, ``kernels.fixpass``,
  ``kernels.lorenzo`` and ``kernels.pack``.
* LM serving of the dense family (``models``, ``serve``): the prefill
  (``serve.make_prefill``, the full forward) and greedy decode
  (``serve.make_serve_step``) of smollm-135m, granite-8b and
  deepseek-coder-33b shaped configs. The prefill's attention is the
  ``kernels.flash`` kernel; the port meets a stated tolerance against
  the reference there, since the reference's Pallas kernel and its jnp
  oracle differ in bf16.

Each kernel is hand-written CUDA C++ with a plain PyTorch version beside
it that CPU tensors reach. Entry points take ``device=None``, meaning
CUDA; without a GPU they raise unless the caller passes ``device="cpu"``
(``device.py``).
"""
