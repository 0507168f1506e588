"""Elementwise math ops of the Paddle API (``paddle_tpu.ops.math``
counterpart): each is a torch function run through ``apply_op`` under the
JAX package's op name. A Python scalar operand takes the tensor's dtype
first (``jnp.asarray(y, x.dtype)``), so ``int_tensor * 2.5`` multiplies by
2 and a bfloat16 tensor's scalar rounds to bfloat16, as in the JAX
package; integer true division gives float64, as under its x64 mode."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply_op, to_tensor

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "abs", "neg", "sign", "square", "reciprocal", "floor", "ceil",
    "round", "trunc", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv",
    "maximum", "minimum", "fmax", "fmin", "clip", "scale", "lerp", "isnan",
    "isinf", "isfinite", "nan_to_num", "logaddexp", "logit", "hypot",
    "deg2rad", "rad2deg", "frac", "multiply_", "add_", "scale_", "clip_",
    "increment", "stanh", "rsqrt_", "angle", "conj", "real", "imag",
]


def _operand(y, like: Tensor) -> Tensor:
    """`y` as a Tensor beside `like`: a Python scalar becomes a 0-d tensor
    of like's dtype on like's device (a fill there, no host sync)."""
    if isinstance(y, Tensor):
        return y
    v = like._value
    if isinstance(y, (bool, int, float, np.number, np.bool_)):
        return Tensor(torch.full((), y, dtype=v.dtype, device=v.device))
    return Tensor(torch.as_tensor(np.array(y), device=v.device))


def _as_tensor(x) -> Tensor:
    return x if isinstance(x, Tensor) else to_tensor(x)


def _binop(fn, name):
    def op(x, y, name=None):
        if not isinstance(x, Tensor):
            y = _as_tensor(y)
            x = _operand(x, y)
        else:
            y = _operand(y, x)
        return apply_op(fn, x, y, name=op.__name__)

    op.__name__ = name
    return op


def _unop(fn, name):
    def op(x, name=None):
        return apply_op(fn, _as_tensor(x), name=op.__name__)

    op.__name__ = name
    return op


def _true_divide(a, b):
    if not (a.dtype.is_floating_point or a.dtype.is_complex
            or b.dtype.is_floating_point or b.dtype.is_complex):
        return torch.div(a.double(), b.double())
    return torch.div(a, b)


add = _binop(torch.add, "add")
subtract = _binop(torch.sub, "subtract")
multiply = _binop(torch.mul, "multiply")
divide = _binop(_true_divide, "divide")
floor_divide = _binop(torch.floor_divide, "floor_divide")
remainder = _binop(torch.remainder, "remainder")
mod = remainder
maximum = _binop(torch.maximum, "maximum")
minimum = _binop(torch.minimum, "minimum")
fmax = _binop(torch.fmax, "fmax")
fmin = _binop(torch.fmin, "fmin")
atan2 = _binop(torch.atan2, "atan2")
logaddexp = _binop(torch.logaddexp, "logaddexp")
hypot = _binop(torch.hypot, "hypot")

exp = _unop(torch.exp, "exp")
expm1 = _unop(torch.expm1, "expm1")
log = _unop(torch.log, "log")
log2 = _unop(torch.log2, "log2")
log10 = _unop(torch.log10, "log10")
log1p = _unop(torch.log1p, "log1p")
sqrt = _unop(torch.sqrt, "sqrt")
rsqrt = _unop(torch.rsqrt, "rsqrt")
abs = _unop(torch.abs, "abs")
neg = _unop(torch.neg, "neg")
sign = _unop(torch.sign, "sign")
square = _unop(torch.square, "square")
reciprocal = _unop(torch.reciprocal, "reciprocal")
floor = _unop(torch.floor, "floor")
ceil = _unop(torch.ceil, "ceil")
round = _unop(torch.round, "round")
trunc = _unop(torch.trunc, "trunc")
sin = _unop(torch.sin, "sin")
cos = _unop(torch.cos, "cos")
tan = _unop(torch.tan, "tan")
asin = _unop(torch.asin, "asin")
acos = _unop(torch.acos, "acos")
atan = _unop(torch.atan, "atan")
sinh = _unop(torch.sinh, "sinh")
cosh = _unop(torch.cosh, "cosh")
tanh = _unop(torch.tanh, "tanh")
asinh = _unop(torch.asinh, "asinh")
acosh = _unop(torch.acosh, "acosh")
atanh = _unop(torch.atanh, "atanh")
erf = _unop(torch.erf, "erf")
erfinv = _unop(torch.erfinv, "erfinv")
isnan = _unop(torch.isnan, "isnan")
isinf = _unop(torch.isinf, "isinf")
isfinite = _unop(torch.isfinite, "isfinite")
deg2rad = _unop(torch.deg2rad, "deg2rad")
rad2deg = _unop(torch.rad2deg, "rad2deg")
angle = _unop(torch.angle, "angle")
conj = _unop(torch.conj_physical, "conj")
real = _unop(torch.real, "real")
imag = _unop(torch.imag, "imag")


def frac(x):
    return apply_op(lambda v: v - torch.trunc(v), x, name="frac")


def pow(x, y):
    if isinstance(y, Tensor):
        return apply_op(torch.pow, x, y, name="pow")
    return apply_op(lambda v: torch.pow(v, y), x, name="pow")


def clip(x, min=None, max=None):
    mn = min.item() if isinstance(min, Tensor) else min
    mx = max.item() if isinstance(max, Tensor) else max
    return apply_op(lambda v: torch.clamp(v, mn, mx), x, name="clip")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    s, b = float(scale), float(bias)

    def f(v):
        return v * s + b if bias_after_scale else (v + b) * s

    return apply_op(f, x, name="scale")


def lerp(x, y, weight):
    if isinstance(weight, Tensor):
        return apply_op(lambda a, b, w: a + w * (b - a), x, y, weight,
                        name="lerp")
    return apply_op(lambda a, b: a + weight * (b - a), x, y, name="lerp")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return apply_op(lambda v: torch.nan_to_num(v, nan, posinf, neginf), x,
                    name="nan_to_num")


def logit(x, eps=None):
    def f(v):
        u = torch.clamp(v, eps, 1 - eps) if eps else v
        return torch.log(u / (1 - u))

    return apply_op(f, x, name="logit")


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return apply_op(lambda v: scale_b * torch.tanh(scale_a * v), x,
                    name="stanh")


# ---- in-place variants (paddle's `op_`): rebind the result --------------
def _inplace(op):
    def f(x, *args, **kwargs):
        x._value = op(x, *args, **kwargs)._value
        return x

    return f


add_ = _inplace(add)
multiply_ = _inplace(multiply)
scale_ = _inplace(scale)
clip_ = _inplace(clip)
rsqrt_ = _inplace(rsqrt)


def increment(x, value=1.0):
    x._set_value(x._value + value)
    return x
