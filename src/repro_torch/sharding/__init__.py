# repro_torch.sharding — name-based partitioning rules over parameter /
# input / decode-state trees as DTensor placements, divisibility-aware (a
# dim is sharded over a mesh dim only if evenly divisible; otherwise the
# next candidate or replication); counterpart of repro.sharding.

from repro_torch.sharding.partition import (
    ShardingPolicy, decode_state_specs, default_policy, input_specs_sharding,
    param_specs,
)

__all__ = ["param_specs", "input_specs_sharding", "decode_state_specs",
           "ShardingPolicy", "default_policy"]
