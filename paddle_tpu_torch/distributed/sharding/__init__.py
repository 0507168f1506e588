"""``paddle.distributed.sharding`` (``paddle_tpu.distributed.sharding``
counterpart; reference: python/paddle/distributed/sharding/
group_sharded.py)."""
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding.group_sharded import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    group_sharded_parallel,
)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def save_group_sharded_model(model, output, optimizer=None):
    """``<output>.pdmodel`` (the model's state dict) and, with an
    optimizer, ``<output>.pdopt`` (its state dict), through
    ``framework.io_.save`` in the JAX package's format. A ZeRO-3 model's
    ``state_dict()`` gathers the full parameters first (a collective:
    every rank of its group calls this); every rank writes the same
    files, so give each rank its own `output` or write from one."""
    from paddle_tpu_torch.framework.io_ import save

    save(model.state_dict(), output + ".pdmodel")
    if optimizer is not None:
        save(optimizer.state_dict(), output + ".pdopt")
