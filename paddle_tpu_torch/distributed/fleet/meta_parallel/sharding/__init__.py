"""ZeRO-3 and Paddle's group-sharded wrappers (``paddle_tpu.distributed.
fleet.meta_parallel.sharding`` counterpart)."""
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding.group_sharded import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    ParamSharder, group_sharded_parallel, pick_shard_axis,
)
