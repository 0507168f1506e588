"""RMSNorm layer (``paddle_tpu.nn.layer.norm.RMSNorm`` counterpart)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
