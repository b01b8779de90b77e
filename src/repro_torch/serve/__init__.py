"""repro_torch.serve — the request-batched topology-preserving
compression service (``serve.compression``) and LM serving:
``make_prefill`` (the full forward through the flash kernel, then the KV
cache), ``make_serve_step`` (one greedy decode step) and
``greedy_generate`` (``greedy_generate_rows``: a MoE config's data rows
in lockstep), and the same at the reference's dry-run partition
(``serve.sharded``: ``make_sharded_prefill``, ``make_sharded_serve_step``
and ``greedy_generate_sharded`` over placed params and a placed KV
cache)."""
from .step import (greedy_generate, greedy_generate_rows, make_prefill,
                   make_serve_step)
from .sharded import (greedy_generate_sharded, make_sharded_prefill,
                      make_sharded_serve_step)
from .compression import (CompressionService, ServiceConfig,
                          ServiceOverloaded, start_stats_server)

__all__ = ["make_serve_step", "make_prefill", "greedy_generate",
           "greedy_generate_rows", "make_sharded_prefill",
           "make_sharded_serve_step", "greedy_generate_sharded",
           "CompressionService", "ServiceConfig", "ServiceOverloaded",
           "start_stats_server"]
