"""Sharded, elastic checkpoints (``paddle_tpu.distributed.checkpoint``
counterpart, the same exports and the same ``paddle_tpu-dcp1`` files)."""
from paddle_tpu_torch.distributed.checkpoint.save_state_dict import save_state_dict  # noqa: F401
from paddle_tpu_torch.distributed.checkpoint.load_state_dict import (  # noqa: F401
    load_state_dict, read_global_state,
)
from paddle_tpu_torch.distributed.checkpoint.metadata import (  # noqa: F401
    LocalTensorIndex, LocalTensorMetadata, Metadata,
)
from paddle_tpu_torch.distributed.checkpoint import elastic  # noqa: F401
from paddle_tpu_torch.distributed.checkpoint.elastic import (  # noqa: F401
    CheckpointFaultInjected, CheckpointManager, Snapshot, capture,
    capture_model, capture_modules, install_hang_handler,
    install_preemption_handler, rename_arrays, restore,
)
