"""repro_torch.serve — the request-batched topology-preserving
compression service (``serve.compression``) and LM serving:
``make_prefill`` (the full forward through the flash kernel, then the KV
cache), ``make_serve_step`` (one greedy decode step) and
``greedy_generate`` (``greedy_generate_rows``: a MoE config's data rows
in lockstep)."""
from .step import (greedy_generate, greedy_generate_rows, make_prefill,
                   make_serve_step)
from .compression import (CompressionService, ServiceConfig,
                          ServiceOverloaded, start_stats_server)

__all__ = ["make_serve_step", "make_prefill", "greedy_generate",
           "greedy_generate_rows",
           "CompressionService", "ServiceConfig", "ServiceOverloaded",
           "start_stats_server"]
