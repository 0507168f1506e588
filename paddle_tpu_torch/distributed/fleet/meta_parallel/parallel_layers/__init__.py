"""Fleet's parallel layer lists (``paddle_tpu.distributed.fleet.
meta_parallel.parallel_layers`` counterpart): the pipeline's
``PipelineLayer``."""
from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers.pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SegmentLayers, SharedLayerDesc,
)
