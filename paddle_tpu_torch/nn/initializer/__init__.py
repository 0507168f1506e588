"""Weight initializers and ``ParamAttr`` (``paddle_tpu.nn.initializer``
counterpart). An initializer is a callable ``(shape, dtype) -> torch
tensor`` on the current device, drawing from the global generator
(``ops.random_state``), so ``paddle_tpu_torch.seed`` makes initialization
reproducible on each device (with torch's streams, not the JAX
package's)."""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core.device import current_device
from paddle_tpu_torch.core.dtype import to_torch_dtype
from paddle_tpu_torch.ops.random_state import default_generator

__all__ = [
    "ParamAttr", "Initializer", "Constant", "Normal", "TruncatedNormal",
    "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
    "KaimingUniform", "Assign", "Orthogonal", "calculate_gain",
]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:          # paddle linear weights are [in, out]
        return shape[0], shape[1]
    rf = int(np.prod(shape[2:]))  # conv [out_c, in_c, *k]
    return shape[1] * rf, shape[0] * rf


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError

    @staticmethod
    def _empty(shape, dtype):
        dev = current_device()
        return (torch.empty(tuple(shape), dtype=to_torch_dtype(dtype),
                            device=dev),
                default_generator.torch_generator(dev))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value,
                          dtype=to_torch_dtype(dtype),
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        out, g = self._empty(shape, dtype)
        return out.normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    """mean + std * a normal truncated to [a, b]."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        out, g = self._empty(shape, dtype)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, self.a, self.b,
                                    generator=g)
        return out.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        out, g = self._empty(shape, dtype)
        return out.uniform_(self.low, self.high, generator=g)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return Uniform(-limit, limit)(shape, dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return Normal(0.0, std)(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.gain = calculate_gain(nonlinearity, negative_slope)

    def __call__(self, shape, dtype):
        limit = self.gain * math.sqrt(3.0 / (self.fan_in or _fans(shape)[0]))
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.gain = calculate_gain(nonlinearity, negative_slope)

    def __call__(self, shape, dtype):
        std = self.gain / math.sqrt(self.fan_in or _fans(shape)[0])
        return Normal(0.0, std)(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        from paddle_tpu_torch.core.tensor import Tensor, to_tensor

        v = self.value
        t = to_tensor(v._value if isinstance(v, Tensor) else np.asarray(v),
                      dtype=dtype)._value
        return t.reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        out, g = self._empty(shape, dtype)
        return torch.nn.init.orthogonal_(out, self.gain, generator=g)


class ParamAttr:
    """A parameter's name, initializer, learning-rate scale, regularizer
    and trainability (``paddle.ParamAttr``)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip
