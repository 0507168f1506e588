"""Normalization layers (``paddle_tpu.nn.layer.norm`` counterpart).

``LayerNorm`` and ``RMSNorm`` are the Paddle API's: ``Layer``s with
``Parameter``s, over ``nn.functional`` on ``Tensor``s. ``TorchLayerNorm``
and ``TorchRMSNorm`` are the ``torch.nn.Module``s of the port's torch-level
models (``models/llama.py``, ``models/gpt_moe.py``), over the same
functions on torch tensors."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "TorchLayerNorm", "TorchRMSNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape, bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(Layer):
    """RMSNorm over the composite ``F.rms_norm`` (the fused kernel is
    ``ops.rmsnorm``, as in the JAX package)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], weight_attr, default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class TorchRMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class TorchLayerNorm(nn.Module):
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
