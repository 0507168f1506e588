"""Operators of the port (``paddle_tpu.ops`` counterpart): the Paddle op
library (creation, math, manipulation, reduction, comparison, linalg) on
torch, installed as ``Tensor`` methods and dunders with the JAX package's
names, ``seed``, and ``rmsnorm``, the fused RMSNorm kernel's public entry
(``paddle_tpu.ops.pallas.rmsnorm`` in the JAX package).

``tensor[idx] = value`` writes a parameter (a leaf that requires grad) in
place under ``no_grad``, so optimizers and views keep its storage; any
other tensor gets a new value, out of place and differentiable, rebound as
the JAX package's ``_set_value`` does."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply_op
from paddle_tpu_torch.ops import (comparison, creation, linalg,  # noqa: F401
                                  manipulation, math, reduction)
from paddle_tpu_torch.ops.comparison import *  # noqa: F401,F403
from paddle_tpu_torch.ops.creation import *  # noqa: F401,F403
from paddle_tpu_torch.ops.cuda.rmsnorm_kernel import rmsnorm  # noqa: F401
from paddle_tpu_torch.ops.linalg import *  # noqa: F401,F403
from paddle_tpu_torch.ops.manipulation import *  # noqa: F401,F403
from paddle_tpu_torch.ops.math import *  # noqa: F401,F403
from paddle_tpu_torch.ops.math import _operand
from paddle_tpu_torch.ops.random_state import seed  # noqa: F401
from paddle_tpu_torch.ops.reduction import *  # noqa: F401,F403

__all__ = sorted({*comparison.__all__, *creation.__all__, *linalg.__all__,
                  *manipulation.__all__, *math.__all__, *reduction.__all__,
                  "seed", "rmsnorm"})


def _coerce_index(idx):
    """Tensors inside an index expression as torch tensors (constants)."""
    if isinstance(idx, Tensor):
        return idx._value
    if isinstance(idx, tuple):
        return tuple(_coerce_index(i) for i in idx)
    if isinstance(idx, list):
        return torch.as_tensor(np.asarray(idx))
    return idx


def _getitem(self, idx):
    cidx = _coerce_index(idx)
    return apply_op(lambda v: v[cidx], self, name="getitem")


def _setitem(self, idx, value):
    cidx = _coerce_index(idx)
    v = self._value
    u = value._value if isinstance(value, Tensor) else value
    if v.requires_grad and v.grad_fn is None:
        with torch.no_grad():
            v[cidx] = u
        return

    def f(v, u):
        out = v.clone()
        out[cidx] = u
        return out

    self._value = apply_op(f, self, value, name="setitem")._value


_BINARY = {
    "__add__": math.add,
    "__sub__": math.subtract,
    "__mul__": math.multiply,
    "__truediv__": math.divide,
    "__floordiv__": math.floor_divide,
    "__mod__": math.remainder,
    "__matmul__": linalg.matmul,
    "__pow__": math.pow,
    "__lt__": comparison.less_than,
    "__le__": comparison.less_equal,
    "__gt__": comparison.greater_than,
    "__ge__": comparison.greater_equal,
    "__and__": comparison.logical_and,
    "__or__": comparison.logical_or,
    "__xor__": comparison.logical_xor,
}

_RBINARY = {
    "__radd__": lambda x, y: math.add(_operand(y, x), x),
    "__rsub__": lambda x, y: math.subtract(_operand(y, x), x),
    "__rmul__": lambda x, y: math.multiply(_operand(y, x), x),
    "__rtruediv__": lambda x, y: math.divide(_operand(y, x), x),
    "__rpow__": lambda x, y: math.pow(_operand(y, x), x),
    "__rmatmul__": lambda x, y: linalg.matmul(_operand(y, x), x),
}

_METHODS = [
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "exp", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "abs", "sign", "square", "reciprocal", "floor", "ceil", "round", "trunc",
    "sin", "cos", "tan", "tanh", "erf", "maximum", "minimum", "clip",
    "scale", "isnan", "isinf", "isfinite", "lerp", "expm1", "sinh", "cosh",
    "asin", "acos", "atan",
    # reduction
    "sum", "mean", "max", "min", "prod", "argmax", "argmin", "all", "any",
    "logsumexp", "std", "var", "cumsum", "cumprod", "median",
    # manipulation
    "reshape", "transpose", "squeeze", "unsqueeze", "flatten", "cast",
    "gather", "gather_nd", "scatter", "index_select", "tile", "expand",
    "expand_as", "broadcast_to", "flip", "roll", "split", "chunk", "topk",
    "sort", "argsort", "unbind", "numel", "take_along_axis",
    "put_along_axis", "masked_fill", "repeat_interleave", "pad", "where",
    "tensor_split", "view", "view_as", "moveaxis",
    # linalg
    "matmul", "mm", "bmm", "dot", "norm", "dist", "inv", "cholesky", "det",
    "outer", "kron", "mv",
    # comparison
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not", "allclose",
    "isclose", "equal_all", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not",
    # creation-ish
    "tril", "triu",
]


def install_tensor_methods():
    """Attach the op library to ``Tensor`` (the JAX package's
    ``ops/__init__.py`` installer, over the ops ported so far)."""
    g = globals()
    for name, fn in {**_BINARY, **_RBINARY}.items():
        setattr(Tensor, name, (lambda f: lambda self, other: f(self, other))(
            fn))
    Tensor.__neg__ = lambda self: math.neg(self)
    Tensor.__abs__ = lambda self: math.abs(self)
    Tensor.__invert__ = lambda self: comparison.logical_not(self)
    Tensor.__eq__ = lambda self, other: comparison.equal(self, other)
    Tensor.__ne__ = lambda self, other: comparison.not_equal(self, other)
    Tensor.__getitem__ = _getitem
    Tensor.__setitem__ = _setitem
    for name in _METHODS:
        fn = g.get(name)
        if fn is not None and not hasattr(Tensor, name):
            setattr(Tensor, name,
                    (lambda f: lambda self, *a, **k: f(self, *a, **k))(fn))
    Tensor.astype = lambda self, dtype: manipulation.cast(self, dtype)


install_tensor_methods()
