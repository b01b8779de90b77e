"""repro_torch.distributed — the straggler watchdog the stream scheduler
folds in (``StepWatchdog``). The reference's mesh modules (the sharded
fix loop, compressed all-reduce) come with ROADMAP.md Queue 1 item 6
('Multi-GPU sharded fix loop')."""
from .straggler import StepWatchdog

__all__ = ["StepWatchdog"]
