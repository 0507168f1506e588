"""Fleet utilities: the hybrid-parallel synchronisation helpers, the
Megatron sequence-parallel layers (``sequence_parallel_utils``),
``recompute`` and the filesystem abstraction (``fs``)."""
from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util  # noqa: F401
from paddle_tpu_torch.distributed.fleet.utils import sequence_parallel_utils  # noqa: F401
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters, broadcast_ep_parameters, broadcast_mp_parameters,
    broadcast_sep_parameters, broadcast_sharding_parameters,
    fused_allreduce_gradients, sync_params_buffers,
)
from paddle_tpu_torch.distributed.fleet.recompute import recompute  # noqa: F401

from paddle_tpu_torch.distributed.fleet.utils import fs  # noqa: E402,F401
from paddle_tpu_torch.distributed.fleet.utils.fs import FS, HDFSClient, LocalFS  # noqa: E402,F401
