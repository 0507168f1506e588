"""Activation layers of the Paddle API
(``paddle_tpu.nn.layer.activation`` counterpart), each over the
``nn.functional`` activation of its name."""
from __future__ import annotations

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Swish", "Tanh",
           "Softmax", "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU",
           "Hardswish",
           "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
           "Softsign", "Tanhshrink", "ThresholdedReLU", "LogSigmoid", "Mish",
           "GLU", "PReLU", "Maxout"]


def _layer(fn_name, *defaults):
    class _Act(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            self._args = args if args else defaults
            self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return getattr(F, fn_name)(x, *self._args, **self._kwargs)

    _Act.__name__ = fn_name
    return _Act


ReLU = _layer("relu")
ReLU6 = _layer("relu6")
Sigmoid = _layer("sigmoid")
Silu = _layer("silu")
Swish = _layer("swish")
Tanh = _layer("tanh")
LogSigmoid = _layer("log_sigmoid")
Mish = _layer("mish")
Hardswish = _layer("hardswish")
Hardsigmoid = _layer("hardsigmoid")
Tanhshrink = _layer("tanhshrink")
Softsign = _layer("softsign")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()

    def forward(self, x):
        return F.softplus(x)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from paddle_tpu_torch.nn import initializer as I

        self.weight = self.create_parameter(
            [num_parameters], weight_attr, default_initializer=I.Constant(init)
        )

    def forward(self, x):
        return F.prelu(x, self.weight)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)
