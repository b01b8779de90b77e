"""repro_torch.distributed — the block-sharded fix loop over a device
mesh (``shardfix``: 1D slab chains and 2D/3D block meshes with
overlapped halo exchange, in one process), the error-bounded compressed
gradient all-reduce of data-parallel training (``compression``: the
pods' int codes summed in one process or across processes), trees
placed on an LM mesh and the collectives over its axes (``placement``,
in one process or a rank a position) and the straggler watchdog the
stream scheduler and the train launcher fold in (``StepWatchdog``)."""
from .compression import (compressed_psum_tree, dequantize_tree,
                          make_grad_sync, quantize_tree)
from .shardfix import (BLOCK_AXES, BlockPlan, ShardedBackend,
                       active_data_mesh, block_halo, data_axis_size,
                       halo_exchange, halo_plan, plan_blocks, sharded_fix,
                       time_step_parts)
from .straggler import StepWatchdog

__all__ = ["compressed_psum_tree", "quantize_tree", "dequantize_tree",
           "make_grad_sync", "StepWatchdog",
           "BLOCK_AXES", "BlockPlan", "ShardedBackend", "active_data_mesh",
           "block_halo", "data_axis_size", "halo_exchange", "halo_plan",
           "plan_blocks", "sharded_fix", "time_step_parts"]
