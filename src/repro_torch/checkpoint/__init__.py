"""repro_torch.checkpoint — fault-tolerant checkpointing in the
reference's format (version 3), with optional error-bounded compressed
payloads; each package restores the other's checkpoints."""
from .manager import CheckpointManager, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
