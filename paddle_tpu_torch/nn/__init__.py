"""Layers and functional ops of the port (``paddle_tpu.nn`` counterpart)."""
from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn.layer.norm import LayerNorm, RMSNorm

__all__ = ["functional", "LayerNorm", "RMSNorm", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue"]
