"""Fleet utilities: the hybrid-parallel synchronisation helpers."""
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters, broadcast_ep_parameters, broadcast_mp_parameters,
    broadcast_sep_parameters, broadcast_sharding_parameters,
    fused_allreduce_gradients, sync_params_buffers,
)
