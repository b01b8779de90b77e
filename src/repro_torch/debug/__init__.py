"""Runtime sanitizers of the port (``debug.guards``): ``no_transfers``
raises at a host<->device transfer made outside the audited seams
(``device._h2d`` / ``_d2h``), and ``no_recompiles`` raises when a block
builds or loads kernels beyond its budget."""
from .guards import (RecompileError, TransferCounts, TransferError,
                     no_recompiles, no_transfers, note_compile,
                     sanitize_transfers, sanitizers_enabled)

__all__ = ["no_transfers", "no_recompiles", "RecompileError",
           "TransferError", "TransferCounts", "note_compile",
           "sanitize_transfers", "sanitizers_enabled"]
