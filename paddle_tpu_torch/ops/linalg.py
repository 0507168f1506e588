"""Linear algebra ops of the Paddle API (``paddle_tpu.ops.linalg``
counterpart): the products (``matmul`` with ``transpose_x``/
``transpose_y``, ``mm``, ``bmm``, ``mv``, ``dot``, ``t``, ``outer``,
``inner``, ``einsum``, ``kron``, ``multi_dot``, ``tensordot`` in
manipulation), ``norm``/``dist`` and the dense factorizations and solves
on ``torch.linalg``. ``matmul`` is white-listed under O1 AMP (bf16)."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply_op, to_tensor

__all__ = [
    "matmul", "mm", "bmm", "dot", "t", "outer", "inner", "cross", "norm",
    "dist", "einsum", "matrix_power", "multi_dot", "cholesky", "qr", "svd",
    "eigh", "eigvalsh", "inv", "pinv", "solve", "triangular_solve", "det",
    "slogdet", "matrix_rank", "mv", "kron",
]


def _t_(x):
    return x if isinstance(x, Tensor) else to_tensor(x)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x and a.ndim >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply_op(f, _t_(x), _t_(y), name="matmul")


def mm(x, y):
    return matmul(x, y)


def bmm(x, y):
    return matmul(x, y)


def mv(x, vec):
    return apply_op(torch.matmul, _t_(x), _t_(vec), name="mv")


def dot(x, y):
    return apply_op(lambda a, b: torch.sum(a * b, dim=-1), _t_(x), _t_(y),
                    name="dot")


def t(x):
    x = _t_(x)
    if x.ndim < 2:
        return x
    return apply_op(lambda v: v.transpose(-1, -2), x, name="t")


def outer(x, y):
    return apply_op(torch.outer, _t_(x), _t_(y), name="outer")


def inner(x, y):
    return apply_op(torch.inner, _t_(x), _t_(y), name="inner")


def cross(x, y, axis=9):
    x = _t_(x)
    ax = axis if axis != 9 else next(   # paddle: the first axis of size 3
        i for i, s in enumerate(x.shape) if s == 3)
    return apply_op(lambda a, b: torch.linalg.cross(a, b, dim=ax), x,
                    _t_(y), name="cross")


def norm(x, p="fro", axis=None, keepdim=False):
    """The JAX package's vector norms over `axis` (all axes by default):
    'fro' and 2 are the square root of the sum of squares."""
    def f(v):
        dims = (tuple(range(v.ndim)) if axis is None
                else tuple(axis) if isinstance(axis, (list, tuple))
                else (axis,))
        if p == "fro" or (p == 2 and axis is None):
            return torch.sqrt(torch.sum(torch.square(v), dim=dims,
                                        keepdim=keepdim))
        if p in (np.inf, "inf"):
            return torch.amax(torch.abs(v), dim=dims, keepdim=keepdim)
        if p in (-np.inf, "-inf"):
            return torch.amin(torch.abs(v), dim=dims, keepdim=keepdim)
        if p == 0:
            return torch.sum((v != 0).to(v.dtype), dim=dims, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(v), p), dim=dims,
                                   keepdim=keepdim), 1.0 / p)

    return apply_op(f, _t_(x), name="norm")


def dist(x, y, p=2):
    return norm(_t_(x) - _t_(y), p=float(p) if p != np.inf else p)


def einsum(equation, *operands):
    return apply_op(lambda *vs: torch.einsum(equation, *vs),
                    *[_t_(o) for o in operands], name="einsum")


def matrix_power(x, n):
    return apply_op(lambda v: torch.linalg.matrix_power(v, n), _t_(x),
                    name="matrix_power")


def multi_dot(xs):
    return apply_op(lambda *vs: torch.linalg.multi_dot(vs),
                    *[_t_(x) for x in xs], name="multi_dot")


def cholesky(x, upper=False):
    return apply_op(lambda v: torch.linalg.cholesky(v, upper=upper), _t_(x),
                    name="cholesky")


def qr(x, mode="reduced"):
    return apply_op(lambda v: tuple(torch.linalg.qr(v, mode=mode)), _t_(x),
                    name="qr")


def svd(x, full_matrices=False):
    return apply_op(lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), _t_(x), name="svd")


def eigh(x, UPLO="L"):
    return apply_op(lambda v: tuple(torch.linalg.eigh(v, UPLO=UPLO)), _t_(x),
                    name="eigh")


def eigvalsh(x, UPLO="L"):
    return apply_op(lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO), _t_(x),
                    name="eigvalsh")


def inv(x):
    return apply_op(torch.linalg.inv, _t_(x), name="inv")


def pinv(x, rcond=1e-15, hermitian=False):
    return apply_op(lambda v: torch.linalg.pinv(v, rtol=rcond,
                                                hermitian=hermitian),
                    _t_(x), name="pinv")


def solve(x, y):
    return apply_op(torch.linalg.solve, _t_(x), _t_(y), name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    def f(a, b):
        if transpose:
            a, upper_ = a.transpose(-1, -2), not upper
        else:
            upper_ = upper
        return torch.linalg.solve_triangular(a, b, upper=upper_,
                                             unitriangular=unitriangular)

    return apply_op(f, _t_(x), _t_(y), name="triangular_solve")


def det(x):
    return apply_op(torch.linalg.det, _t_(x), name="det")


def slogdet(x):
    return apply_op(lambda v: tuple(torch.linalg.slogdet(v)), _t_(x),
                    name="slogdet")


def matrix_rank(x, tol=None, hermitian=False):
    return apply_op(lambda v: torch.linalg.matrix_rank(
        v, rtol=tol, hermitian=hermitian), _t_(x), name="matrix_rank")


def kron(x, y):
    return apply_op(torch.kron, _t_(x), _t_(y), name="kron")
