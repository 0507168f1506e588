"""Normalization layers (``paddle_tpu.nn.layer.norm`` counterpart):
RMSNorm and LayerNorm."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["RMSNorm", "LayerNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the last ``normalized_shape`` axes with parameters
    ``weight`` (ones) and ``bias`` (zeros), epsilon 1e-5 as paddle's."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)
