"""Mixture-of-Experts (``paddle_tpu.incubate.distributed.models.moe``
counterpart): ``MoELayer`` with its gates and batched expert FFN, the
capacity dispatch and the dropless dispatch over the grouped-matmul
kernels, locally or with the experts split over a rank mesh's "ep" axis
(the tokens on all-to-all)."""
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
    ExpertFFN, GShardGate, MoELayer, NaiveGate, SwitchGate)

__all__ = ["ExpertFFN", "GShardGate", "MoELayer", "NaiveGate", "SwitchGate"]
