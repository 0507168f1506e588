from paddle_tpu_torch.distributed.auto_parallel.static.engine import (  # noqa: F401,E501
    Engine)

__all__ = ["Engine"]
