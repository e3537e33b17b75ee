"""Multi-device pieces of the port.

- `sharding`: the named `DeviceGrid` the sharded serving placements lay
  their streams over (one controller process), and the `Sharded`
  row-block container.
- `finger_dist`: FINGER on an edge-sharded graph, one process a rank
  over `torch.distributed` (NCCL on the card, gloo on the CPU).
- `compression`: int8 error-feedback gradient compression.
"""
from repro_torch.distributed.compression import (
    compress_with_feedback,
    dequantize_int8,
    init_residuals,
    quantize_int8,
)
from repro_torch.distributed.finger_dist import (
    distributed_finger_state,
    distributed_power_iteration,
    shard_edge_list,
)
from repro_torch.distributed.sharding import (
    DeviceGrid,
    Sharded,
    concat_rows,
    each,
    make_grid,
    shard_index,
    split_rows,
)

__all__ = [
    "DeviceGrid", "Sharded", "compress_with_feedback", "concat_rows",
    "dequantize_int8", "distributed_finger_state",
    "distributed_power_iteration", "each", "init_residuals", "make_grid",
    "quantize_int8", "shard_edge_list", "shard_index", "split_rows",
]
