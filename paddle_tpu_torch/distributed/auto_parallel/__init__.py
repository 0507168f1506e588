"""Semi-automatic parallelism (``paddle_tpu.distributed.auto_parallel``
counterpart): placements, ``ProcessMesh``, DistTensors and ``DistModel``
(``api``), and the ``Engine`` loop (``static``)."""
from paddle_tpu_torch.distributed.auto_parallel.api import (  # noqa: F401
    DistModel, Partial, Placement, ProcessMesh, Replicate, Shard,
    dtensor_from_fn, dtensor_from_local, get_placements, reshard,
    shard_dataloader, shard_layer, shard_optimizer, shard_tensor, to_static,
    unshard_dtensor)
from paddle_tpu_torch.distributed.auto_parallel.static.engine import (  # noqa: F401,E501
    Engine)

__all__ = ["Engine"]
