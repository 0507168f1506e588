"""Fleet base: the strategy."""
from paddle_tpu_torch.distributed.fleet.base.distributed_strategy import DistributedStrategy  # noqa: F401
