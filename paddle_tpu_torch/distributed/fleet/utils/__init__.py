"""Fleet utilities: the hybrid-parallel synchronisation helpers and the
Megatron sequence-parallel layers (``sequence_parallel_utils``)."""
from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util  # noqa: F401
from paddle_tpu_torch.distributed.fleet.utils import sequence_parallel_utils  # noqa: F401
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters, broadcast_ep_parameters, broadcast_mp_parameters,
    broadcast_sep_parameters, broadcast_sharding_parameters,
    fused_allreduce_gradients, sync_params_buffers,
)
