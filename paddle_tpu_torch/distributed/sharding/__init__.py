"""``paddle.distributed.sharding`` (``paddle_tpu.distributed.sharding``
counterpart; reference: python/paddle/distributed/sharding/
group_sharded.py)."""
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding.group_sharded import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    group_sharded_parallel,
)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def save_group_sharded_model(model, output, optimizer=None):
    """Not ported: the JAX package writes through ``framework.io_.save``,
    whose port is ROADMAP A9 (``framework/``)."""
    raise NotImplementedError("save_group_sharded_model needs the port of "
                              "framework.io_ (ROADMAP A9)")
