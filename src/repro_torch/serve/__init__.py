"""repro_torch.serve — the request-batched topology-preserving
compression service (``serve.compression``) and LM serving:
``make_prefill`` (the full forward through the flash kernel, then the KV
cache), ``make_serve_step`` (one greedy decode step) and
``greedy_generate``."""
from .step import greedy_generate, make_prefill, make_serve_step
from .compression import (CompressionService, ServiceConfig,
                          ServiceOverloaded, start_stats_server)

__all__ = ["make_serve_step", "make_prefill", "greedy_generate",
           "CompressionService", "ServiceConfig", "ServiceOverloaded",
           "start_stats_server"]
