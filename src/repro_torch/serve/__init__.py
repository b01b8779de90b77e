"""repro_torch.serve — LM serving: ``make_prefill`` (the full forward
through the flash kernel, then the KV cache), ``make_serve_step`` (one
greedy decode step) and ``greedy_generate``."""
from .step import greedy_generate, make_prefill, make_serve_step

__all__ = ["make_serve_step", "make_prefill", "greedy_generate"]
