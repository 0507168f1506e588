"""Model inspection: ``paddle.summary`` and ``paddle.flops``
(``paddle_tpu.framework.inspection`` counterpart), on a Paddle-API
``Layer`` and on a ``torch.nn.Module``.

``summary`` prints a row per layer that holds parameters (its own only)
and returns the totals, as the JAX package does.

``flops`` runs the forward once on zeros of `input_size` and counts the
operations its ATen calls do, by the rule of XLA's cost analysis, which
the JAX package reads: a matrix product is 2 M K N (``addmm`` adds M N for
its bias), an arithmetic elementwise op (add, mul, max, relu, ...) one per
output element, a sum one per input element; transcendental functions
(exp, log, tanh, erf, rsqrt, ...) are counted apart by XLA and add none,
and so do copies, views and casts. The count equals the JAX package's on
nets of linear layers and such elementwise ops; XLA's count of a fused
or decomposed composite (a norm, GELU) may differ.
"""
from __future__ import annotations

import torch

__all__ = ["summary", "flops"]


def _own_params(layer):
    """(params, buffers) registered on `layer` itself (a Paddle-API Layer
    and a torch module both keep them in these dicts)."""
    return ([p for p in layer._parameters.values() if p is not None],
            [b for b in layer._buffers.values() if b is not None])


def _numel(p) -> int:
    return int(p.numel()) if isinstance(p, torch.Tensor) else int(p.size)


def _trainable(p) -> bool:
    if isinstance(p, torch.Tensor):
        return bool(p.requires_grad)
    return not p.stop_gradient


def _named_layers(net):
    if hasattr(net, "named_sublayers"):
        return list(net.named_sublayers(include_self=True))
    return list(net.named_modules())


def summary(net, input_size=None, dtypes=None, input=None):
    """A table of each layer's own parameters and the totals:
    ``{"total_params", "trainable_params"}``."""
    lines = [f"{'Layer (type)':<44}{'Param shape(s)':<28}{'Params':>10}",
             "=" * 82]
    total = 0
    trainable = 0
    for name, sub in _named_layers(net):
        own, buffers = _own_params(sub)
        if name == "":
            name = type(net).__name__
            if not own:
                continue
        if not own and not buffers:
            continue
        n = sum(_numel(p) for p in own)
        shapes = ", ".join(str(list(p.shape)) for p in own[:2])
        if len(own) > 2:
            shapes += ", ..."
        lines.append(f"{name + ' (' + type(sub).__name__ + ')':<44}"
                     f"{shapes:<28}{n:>10}")
        total += n
        trainable += sum(_numel(p) for p in own if _trainable(p))
    lines.append("=" * 82)
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    lines.append(f"Non-trainable params: {total - trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "erf", "erfc", "erfinv", "rsqrt", "sqrt", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "asinh",
    "acosh", "atanh", "pow", "logistic", "silu", "gelu", "softplus"}
_FREE = {"clone", "copy", "_to_copy", "to", "fill", "zeros_like",
         "ones_like", "full_like", "empty_like", "lift_fresh", "detach",
         "alias"}


def _mm_flops(func, args, out):
    name = func.overloadpacket.__name__
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * k * n
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * k * n + m * n
    if name == "bmm":
        b, m, k = args[0].shape
        return 2 * b * m * k * args[1].shape[2]
    if name == "baddbmm":
        b, m, k = args[1].shape
        n = args[2].shape[2]
        return 2 * b * m * k * n + b * m * n
    return None


def _count(func, args, out) -> int:
    mm = _mm_flops(func, args, out)
    if mm is not None:
        return int(mm)
    name = func.overloadpacket.__name__.rstrip("_")
    if name in _TRANSCENDENTAL or name in _FREE:
        return 0
    if name in ("sum", "mean"):
        n = int(args[0].numel())
        return n + (int(out.numel()) if name == "mean" else 0)
    if torch.Tag.pointwise in func.tags and isinstance(out, torch.Tensor):
        return int(out.numel())
    return 0


def flops(net, input_size, custom_ops=None, print_detail=False,
          dtype="float32"):
    """The forward's operation count on zeros of `input_size` (`dtype`;
    give "int64" for a model that takes token ids), by XLA's rule (see the
    module's docstring)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.core.dtype import to_torch_dtype
    from paddle_tpu_torch.core.tensor import Tensor

    paddle_layer = hasattr(net, "_sub_layers")
    params = net.parameters()
    first = params[0] if isinstance(params, list) else next(iter(params))
    dev = getattr(first, "_value", first).device
    x = torch.zeros(list(input_size), dtype=to_torch_dtype(dtype),
                    device=dev)
    total = [0]
    per_op: dict = {}

    class _Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            n = _count(func, args, out)
            if n:
                key = func.overloadpacket.__name__
                per_op[key] = per_op.get(key, 0) + n
                total[0] += n
            return out

    with torch.no_grad(), _Counter():
        net(Tensor(x) if paddle_layer else x)
    if print_detail:
        print(f"FLOPs (XLA's counting rule): {total[0]:,} for input "
              f"{list(input_size)}: {per_op}")
    return total[0]
