"""Common layers of the Paddle API (``paddle_tpu.nn.layer.common``
counterpart, up to ``Flatten``): ``Linear`` (weight ``[in, out]``, as in
Paddle and the JAX package; the port's torch-level models keep their own
``[out, in]``), ``Embedding``, the dropouts and ``Flatten``."""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "AlphaDropout",
           "Flatten"]


class Linear(Layer):
    """y = xW + b with W ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter(shape=[out_features],
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        from paddle_tpu_torch.nn import initializer as I

        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._value[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from paddle_tpu_torch.ops.manipulation import flatten

        return flatten(x, self.start_axis, self.stop_axis)
