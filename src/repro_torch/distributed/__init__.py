"""repro_torch.distributed — the block-sharded fix loop over a device
mesh (``shardfix``: 1D slab chains and 2D/3D block meshes with
overlapped halo exchange, in one process) and the straggler watchdog the
stream scheduler folds in (``StepWatchdog``). The compressed gradient
all-reduce of the reference comes with the training slice."""
from .shardfix import (BLOCK_AXES, BlockPlan, ShardedBackend,
                       active_data_mesh, block_halo, data_axis_size,
                       halo_exchange, halo_plan, plan_blocks, sharded_fix,
                       time_step_parts)
from .straggler import StepWatchdog

__all__ = ["StepWatchdog",
           "BLOCK_AXES", "BlockPlan", "ShardedBackend", "active_data_mesh",
           "block_halo", "data_axis_size", "halo_exchange", "halo_plan",
           "plan_blocks", "sharded_fix", "time_step_parts"]
