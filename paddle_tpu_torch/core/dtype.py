"""Paddle's dtype names on torch dtypes (``paddle_tpu.core.dtype``
counterpart).

A ``DType`` is a named wrapper over a ``torch.dtype`` (and, where numpy has
one, its numpy dtype) that prints as ``paddle_tpu_torch.float32`` and
compares equal to its name, its torch dtype and its numpy dtype. The default
floating dtype is float32 (``set_default_dtype``): Python floats become
float32, integer data keeps int64 and float64 numpy data stays float64, as
under the JAX package's x64 mode.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DType", "float16", "float32", "float64", "bfloat16", "int8", "int16",
    "int32", "int64", "uint8", "bool_", "complex64", "complex128",
    "convert_dtype", "to_torch_dtype", "set_default_dtype",
    "get_default_dtype", "is_floating_dtype", "is_integer_dtype",
]


class DType:
    """A framework dtype: a name, a ``torch.dtype`` and the numpy dtype
    (None for bfloat16, which numpy lacks)."""

    __slots__ = ("name", "torch_dtype", "np_dtype")

    def __init__(self, name: str, torch_dtype, np_dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_dtype = None if np_dtype is None else np.dtype(np_dtype)

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.torch_dtype == other.torch_dtype
        try:
            return self.torch_dtype == convert_dtype(other).torch_dtype
        except (TypeError, ValueError, KeyError):
            return NotImplemented

    def __hash__(self):
        return hash(self.torch_dtype)

    @property
    def itemsize(self):
        return torch.empty((), dtype=self.torch_dtype).element_size()

    @property
    def is_floating_point(self):
        return self.torch_dtype.is_floating_point


float16 = DType("float16", torch.float16, np.float16)
float32 = DType("float32", torch.float32, np.float32)
float64 = DType("float64", torch.float64, np.float64)
bfloat16 = DType("bfloat16", torch.bfloat16, None)
int8 = DType("int8", torch.int8, np.int8)
int16 = DType("int16", torch.int16, np.int16)
int32 = DType("int32", torch.int32, np.int32)
int64 = DType("int64", torch.int64, np.int64)
uint8 = DType("uint8", torch.uint8, np.uint8)
bool_ = DType("bool", torch.bool, np.bool_)
complex64 = DType("complex64", torch.complex64, np.complex64)
complex128 = DType("complex128", torch.complex128, np.complex128)

_ALL = [float16, float32, float64, bfloat16, int8, int16, int32, int64,
        uint8, bool_, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_TORCH = {d.torch_dtype: d for d in _ALL}
_BY_NP = {d.np_dtype: d for d in _ALL if d.np_dtype is not None}

_default_dtype = float32


def convert_dtype(dtype) -> DType | None:
    """Coerce a name, ``torch.dtype``, numpy dtype or ``DType`` into a
    ``DType``; None passes through."""
    if dtype is None or isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, torch.dtype):
        return _BY_TORCH[dtype]
    if isinstance(dtype, str):
        name = dtype.removeprefix("paddle.").removeprefix("torch.")
        if name in _BY_NAME:
            return _BY_NAME[name]
    npd = np.dtype(dtype)
    if npd.name == "bfloat16":            # ml_dtypes' bfloat16
        return bfloat16
    if npd not in _BY_NP:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _BY_NP[npd]


def to_torch_dtype(dtype):
    """Framework dtype -> ``torch.dtype``; None passes through."""
    if dtype is None:
        return None
    return convert_dtype(dtype).torch_dtype


def set_default_dtype(dtype):
    global _default_dtype
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_dtype = d


def get_default_dtype() -> DType:
    return _default_dtype


def is_floating_dtype(dtype) -> bool:
    return to_torch_dtype(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    d = to_torch_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)
