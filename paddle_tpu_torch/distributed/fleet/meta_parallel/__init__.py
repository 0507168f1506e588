"""Fleet's model wrappers (``paddle_tpu.distributed.fleet.meta_parallel``
counterpart): ``TensorParallel``, the pipeline (``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer``, ``PipelineParallel``), the mp
layers, the group-sharded (ZeRO) wrappers (``sharding``) and
``SegmentParallel`` (the sep axis)."""
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from paddle_tpu_torch.distributed.fleet.layers.mpu.random import get_rng_state_tracker  # noqa: F401
from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers.pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SegmentLayers, SharedLayerDesc,
)
from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel import PipelineParallel  # noqa: F401
from paddle_tpu_torch.distributed.fleet.meta_parallel.segment_parallel import SegmentParallel  # noqa: F401
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    group_sharded_parallel,
)
from paddle_tpu_torch.distributed.fleet.meta_parallel.tensor_parallel import TensorParallel  # noqa: F401
