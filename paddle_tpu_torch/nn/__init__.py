"""The Paddle ``nn`` API of the port (``paddle_tpu.nn`` counterpart):
``Layer`` and its containers, ``Parameter``, the common, activation, loss
and normalization layers, ``functional``, ``initializer``, ``ParamAttr``
and the gradient clips. ``nn.LayerNorm`` and ``nn.RMSNorm`` are Paddle
``Layer``s; the torch-level models' ``torch.nn.Module``s are
``nn.layer.norm.TorchLayerNorm`` and ``TorchRMSNorm``."""
from paddle_tpu_torch.nn import functional, initializer
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn.initializer import ParamAttr
from paddle_tpu_torch.nn.layer.activation import (
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, SELU,
    Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
    Tanhshrink, ThresholdedReLU)
from paddle_tpu_torch.nn.layer.common import (AlphaDropout, Dropout,
                                              Dropout2D, Embedding, Flatten,
                                              Linear)
from paddle_tpu_torch.nn.layer.layers import (Identity, Layer, LayerDict,
                                              LayerList, Parameter,
                                              ParameterList, Sequential)
from paddle_tpu_torch.nn.layer.loss import (BCELoss, BCEWithLogitsLoss,
                                            CrossEntropyLoss, KLDivLoss,
                                            L1Loss, MSELoss, NLLLoss,
                                            SmoothL1Loss)
from paddle_tpu_torch.nn.layer.norm import LayerNorm, RMSNorm

__all__ = [
    "functional", "initializer", "ParamAttr", "ClipGradByGlobalNorm",
    "ClipGradByNorm", "ClipGradByValue",
    "Layer", "Parameter", "Sequential", "LayerList", "ParameterList",
    "LayerDict", "Identity",
    "Linear", "Embedding", "Dropout", "Dropout2D", "AlphaDropout", "Flatten",
    "LayerNorm", "RMSNorm",
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "ThresholdedReLU",
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
]
