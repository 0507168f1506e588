"""Reduction ops of the Paddle API (``paddle_tpu.ops.reduction``
counterpart), Paddle's ``axis``/``keepdim`` names on torch reductions."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import to_torch_dtype
from paddle_tpu_torch.core.tensor import Tensor, apply_op, to_tensor

__all__ = [
    "sum", "mean", "max", "min", "prod", "argmax", "argmin", "all", "any",
    "logsumexp", "std", "var", "median", "amax", "amin", "count_nonzero",
    "nanmean", "nansum", "cumsum", "cumprod", "cummax", "cummin",
    "kthvalue", "mode",
]


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(v, axis):
    """torch's dim argument: every axis for None."""
    a = _axis(axis)
    return tuple(range(v.ndim)) if a is None else a


def sum(x, axis=None, dtype=None, keepdim=False):
    d = to_torch_dtype(dtype)
    return apply_op(lambda v: torch.sum(v, dim=_dims(v, axis),
                                        keepdim=keepdim, dtype=d),
                    x, name="sum")


def nansum(x, axis=None, dtype=None, keepdim=False):
    d = to_torch_dtype(dtype)
    return apply_op(lambda v: torch.nansum(v, dim=_dims(v, axis),
                                           keepdim=keepdim, dtype=d),
                    x, name="nansum")


def mean(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.mean(v, dim=_dims(v, axis),
                                         keepdim=keepdim), x, name="mean")


def nanmean(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.nanmean(v, dim=_dims(v, axis),
                                            keepdim=keepdim), x,
                    name="nanmean")


def max(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.amax(v, dim=_dims(v, axis),
                                         keepdim=keepdim), x, name="max")


def min(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.amin(v, dim=_dims(v, axis),
                                         keepdim=keepdim), x, name="min")


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None):
    d = to_torch_dtype(dtype)

    def f(v):
        a = _axis(axis)
        if a is None:
            out = torch.prod(v, dtype=d)
            return out.reshape([1] * v.ndim) if keepdim else out
        for ax in sorted(a if isinstance(a, tuple) else (a,),
                         key=lambda i: -(i % v.ndim)):
            v = torch.prod(v, dim=ax, keepdim=keepdim, dtype=d)
        return v

    return apply_op(f, x, name="prod")


def _arg(fn, x, axis, keepdim, dtype, name):
    d = to_torch_dtype(dtype) or torch.int64

    def f(v):
        a = _axis(axis)
        if a is None:
            out = fn(v.reshape(-1))
            return (out.reshape([1] * v.ndim) if keepdim else out).to(d)
        return fn(v, dim=a, keepdim=keepdim).to(d)

    return apply_op(f, x, name=name)


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype, "argmax")


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype, "argmin")


def all(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.all(v, dim=_dims(v, axis),
                                        keepdim=keepdim), x, name="all")


def any(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.any(v, dim=_dims(v, axis),
                                        keepdim=keepdim), x, name="any")


def logsumexp(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.logsumexp(v, dim=_dims(v, axis),
                                              keepdim=keepdim), x,
                    name="logsumexp")


def std(x, axis=None, unbiased=True, keepdim=False):
    return apply_op(lambda v: torch.std(v, dim=_dims(v, axis),
                                        correction=int(unbiased),
                                        keepdim=keepdim), x, name="std")


def var(x, axis=None, unbiased=True, keepdim=False):
    return apply_op(lambda v: torch.var(v, dim=_dims(v, axis),
                                        correction=int(unbiased),
                                        keepdim=keepdim), x, name="var")


def median(x, axis=None, keepdim=False):
    """The mean of the two middle values for an even count (numpy's and
    the JAX package's median; torch's returns the lower one)."""
    def f(v):
        a = _axis(axis)
        w = v.reshape(-1) if a is None else v
        d = 0 if a is None else a
        n = w.shape[d]
        s = torch.sort(w, dim=d).values
        mid = (s.narrow(d, (n - 1) // 2, 1) + s.narrow(d, n // 2, 1)) / 2
        if a is None:
            return mid.reshape([1] * v.ndim) if keepdim else mid.reshape(())
        return mid if keepdim else mid.squeeze(d)

    return apply_op(f, x, name="median")


def count_nonzero(x, axis=None, keepdim=False):
    return apply_op(lambda v: torch.sum(v != 0, dim=_dims(v, axis),
                                        keepdim=keepdim), x,
                    name="count_nonzero")


def cumsum(x, axis=None, dtype=None):
    d = to_torch_dtype(dtype)

    def f(v):
        if axis is None:
            return torch.cumsum(v.reshape(-1), 0, dtype=d)
        return torch.cumsum(v, int(axis), dtype=d)

    return apply_op(f, x, name="cumsum")


def cumprod(x, dim=None, dtype=None):
    d = to_torch_dtype(dtype)

    def f(v):
        if dim is None:
            return torch.cumprod(v.reshape(-1), 0, dtype=d)
        return torch.cumprod(v, int(dim), dtype=d)

    return apply_op(f, x, name="cumprod")


def _cum_compare(fn, x, axis, dtype, name):
    d = to_torch_dtype(dtype)

    def f(v):
        w = v.reshape(-1) if axis is None else v
        out = fn(w, 0 if axis is None else int(axis))
        return out.values, out.indices.to(d)

    return apply_op(f, x, name=name)


def cummax(x, axis=None, dtype="int64"):
    return _cum_compare(torch.cummax, x, axis, dtype, "cummax")


def cummin(x, axis=None, dtype="int64"):
    return _cum_compare(torch.cummin, x, axis, dtype, "cummin")


def kthvalue(x, k, axis=-1, keepdim=False):
    def f(v):
        out = torch.kthvalue(v, k, dim=axis, keepdim=keepdim)
        return out.values, out.indices

    return apply_op(f, x, name="kthvalue")


def mode(x, axis=-1, keepdim=False):
    """Host-side, as in the JAX package: the most frequent value (the
    smallest on a tie) and its first index."""
    vals = x.numpy()

    def _mode1d(a):
        u, c = np.unique(a, return_counts=True)
        return u[np.argmax(c)]

    out = np.apply_along_axis(_mode1d, axis, vals)
    idx = np.argmax(vals == np.expand_dims(out, axis), axis=axis)
    if keepdim:
        out = np.expand_dims(out, axis)
        idx = np.expand_dims(idx, axis)
    place = x.place
    return (to_tensor(out, place=place),
            to_tensor(idx.astype(np.int64), place=place))
