"""Layers and functional ops of the port (``paddle_tpu.nn`` counterpart)."""
from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn.layer.norm import RMSNorm

__all__ = ["functional", "RMSNorm", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue"]
