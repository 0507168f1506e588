"""Tensor creation ops of the Paddle API (``paddle_tpu.ops.creation``
counterpart), on the current device (``core.device``)."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import current_device
from paddle_tpu_torch.core.dtype import get_default_dtype, to_torch_dtype
from paddle_tpu_torch.core.tensor import Tensor, _unwrap, apply_op, to_tensor
from paddle_tpu_torch.ops.random_state import default_generator

__all__ = [
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "eye", "rand", "randn", "randint",
    "uniform", "normal", "randperm", "tril", "triu", "diag", "diagflat",
    "meshgrid", "to_tensor", "assign", "clone_detached", "tril_indices",
    "triu_indices", "one_hot",
]


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dt(dtype, default=None):
    d = to_torch_dtype(dtype)
    if d is None:
        d = default or get_default_dtype().torch_dtype
    return d


def _new(fn, shape, dtype, **kw):
    return Tensor(fn(_shape(shape), dtype=_dt(dtype), device=current_device(),
                     **kw))


def zeros(shape, dtype=None):
    return _new(torch.zeros, shape, dtype)


def ones(shape, dtype=None):
    return _new(torch.ones, shape, dtype)


def full(shape, fill_value, dtype=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    elif dtype is None and isinstance(fill_value, int):
        dtype = "int64"
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                             device=current_device()))


def empty(shape, dtype=None):
    return zeros(shape, dtype)


def _like(fn, x, dtype, *args):
    v = _unwrap(x)
    return Tensor(fn(v, *args, dtype=_dt(dtype, v.dtype)))


def zeros_like(x, dtype=None):
    return _like(torch.zeros_like, x, dtype)


def ones_like(x, dtype=None):
    return _like(torch.ones_like, x, dtype)


def full_like(x, fill_value, dtype=None):
    return _like(torch.full_like, x, dtype, fill_value)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    if dtype is None:
        floats = any(isinstance(v, float) for v in (start, end, step))
        dtype = get_default_dtype() if floats else "int64"
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=current_device()))


def linspace(start, stop, num, dtype=None):
    return Tensor(torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                                 device=current_device()))


def eye(num_rows, num_columns=None, dtype=None):
    return Tensor(torch.eye(num_rows, num_rows if num_columns is None
                            else num_columns, dtype=_dt(dtype),
                            device=current_device()))


def _gen():
    dev = current_device()
    return dev, default_generator.torch_generator(dev)


def rand(shape, dtype=None):
    dev, g = _gen()
    return Tensor(torch.rand(_shape(shape), generator=g, dtype=_dt(dtype),
                             device=dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    dev, g = _gen()
    if seed:
        g = torch.Generator(device=dev).manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return Tensor(out.uniform_(min, max, generator=g))


def randn(shape, dtype=None):
    dev, g = _gen()
    return Tensor(torch.randn(_shape(shape), generator=g, dtype=_dt(dtype),
                              device=dev))


def normal(mean=0.0, std=1.0, shape=None):
    dev, g = _gen()
    out = torch.empty(_shape(shape), dtype=_dt(None), device=dev)
    return Tensor(out.normal_(mean, std, generator=g))


def randint(low=0, high=None, shape=(1,), dtype=None):
    if high is None:
        low, high = 0, low
    dev, g = _gen()
    return Tensor(torch.randint(low, high, _shape(shape), generator=g,
                                dtype=_dt(dtype, torch.int64), device=dev))


def randperm(n, dtype=None):
    dev, g = _gen()
    return Tensor(torch.randperm(n, generator=g, device=dev,
                                 dtype=_dt(dtype, torch.int64)))


def tril(x, diagonal=0):
    return apply_op(lambda v: torch.tril(v, diagonal), x, name="tril")


def triu(x, diagonal=0):
    return apply_op(lambda v: torch.triu(v, diagonal), x, name="triu")


def diag(x, offset=0):
    return apply_op(lambda v: torch.diag(v, offset), x, name="diag")


def diagflat(x, offset=0):
    return apply_op(lambda v: torch.diagflat(v, offset), x, name="diagflat")


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    ts = [a if isinstance(a, Tensor) else to_tensor(a) for a in args]
    return list(apply_op(lambda *vs: torch.meshgrid(*vs, indexing="ij"), *ts,
                         name="meshgrid"))


def assign(x, output=None):
    val = x if isinstance(x, Tensor) else to_tensor(x)
    if output is not None:
        output._set_value(val)
        return output
    return Tensor(val._value.detach().clone())


def clone_detached(x):
    return Tensor(x._value.detach().clone())


def _indices(fn, row, col, offset):
    r, c = fn(row, offset, col)
    return to_tensor(np.stack([r, c]).astype(np.int64))


def tril_indices(row, col, offset=0):
    return _indices(np.tril_indices, row, col, offset)


def triu_indices(row, col, offset=0):
    return _indices(np.triu_indices, row, col, offset)


def one_hot(x, num_classes):
    return apply_op(lambda v: torch.nn.functional.one_hot(
        v.long(), num_classes).to(get_default_dtype().torch_dtype), x,
        name="one_hot")
