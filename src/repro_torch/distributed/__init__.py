"""Multi-device pieces of the port.

- `sharding`: the named `DeviceGrid` the sharded serving placements lay
  their streams over (one controller process), the `Sharded` row-block
  container, and the model-sharding rules (`ShardingRules` on a
  `DeviceMesh`, DTensor placements, the TP padding helpers).
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
    NO_SHARDING,
    DeviceGrid,
    NamedSharding,
    Sharded,
    ShardingRules,
    concat_rows,
    constrain,
    each,
    effective_heads,
    kv_heads_shardable,
    make_grid,
    multi_pod_rules,
    named_sharding,
    pad_to_multiple,
    padded_vocab,
    shard_index,
    single_pod_rules,
    split_rows,
)

__all__ = [
    "DeviceGrid", "NO_SHARDING", "NamedSharding", "Sharded",
    "ShardingRules", "compress_with_feedback", "concat_rows", "constrain",
    "dequantize_int8", "distributed_finger_state",
    "distributed_power_iteration", "each", "effective_heads",
    "init_residuals", "kv_heads_shardable", "make_grid", "multi_pod_rules",
    "named_sharding", "pad_to_multiple", "padded_vocab", "quantize_int8",
    "shard_edge_list", "shard_index", "single_pod_rules", "split_rows",
]
