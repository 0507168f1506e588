"""Distributed utilities (``paddle_tpu.distributed.utils`` counterpart):
the MoE dispatch collectives."""
from paddle_tpu_torch.distributed.utils.moe_utils import (  # noqa: F401
    global_gather, global_scatter)

__all__ = ["global_scatter", "global_gather"]
