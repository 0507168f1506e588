"""Comparison, logical and bitwise ops of the Paddle API
(``paddle_tpu.ops.comparison`` counterpart)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply_op, to_tensor
from paddle_tpu_torch.ops.math import _operand

__all__ = [
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "is_empty",
]


def _t(x):
    return x if isinstance(x, Tensor) else to_tensor(x)


def _cmp(fn, name):
    def op(x, y, name=None):
        x = _t(x)
        return apply_op(fn, x, _operand(y, x), name=op.__name__)

    op.__name__ = name
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
logical_and = _cmp(torch.logical_and, "logical_and")
logical_or = _cmp(torch.logical_or, "logical_or")
logical_xor = _cmp(torch.logical_xor, "logical_xor")
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")


def logical_not(x):
    return apply_op(torch.logical_not, _t(x), name="logical_not")


def bitwise_not(x):
    return apply_op(torch.bitwise_not, _t(x), name="bitwise_not")


def equal_all(x, y):
    return apply_op(lambda a, b: torch.tensor(torch.equal(a, b),
                                              device=a.device),
                    _t(x), _t(y), name="equal_all")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return apply_op(lambda a, b: torch.tensor(
        torch.allclose(a, b, rtol, atol, equal_nan), device=a.device),
        _t(x), _t(y), name="allclose")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return apply_op(lambda a, b: torch.isclose(a, b, rtol, atol, equal_nan),
                    _t(x), _t(y), name="isclose")


def is_empty(x):
    return to_tensor(_t(x).size == 0)
