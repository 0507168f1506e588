"""AMP debugging (``paddle_tpu.amp.debugging`` counterpart):
``check_numerics``, ``TensorCheckerConfig``, ``enable/disable_tensor_checker``
and the operator stats, at the port's AMP seam (``amp.apply_seam``).

Operator stats count (op name, input dtype) pairs of the seam ops, as the
JAX package counts them at ``apply_op``; the tensor checker is the
``check_nan_inf`` flag, which makes every seam op check its output.
"""
from __future__ import annotations

import contextlib

import torch

from paddle_tpu_torch.core.flags import set_flags

__all__ = [
    "collect_operator_stats", "enable_operator_stats_collection",
    "disable_operator_stats_collection", "check_numerics",
    "TensorCheckerConfig", "enable_tensor_checker", "disable_tensor_checker",
    "DebugMode",
]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


_stats = None


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _count(name, vals):
    """One seam op into the stats: keyed by the first tensor input's
    dtype, '-' when it has none."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            key = (name, _dtype_name(v.dtype))
            break
    else:
        key = (name, "-")
    _stats[key] = _stats.get(key, 0) + 1


def _nan_check(name, out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for v in outs:
        if (isinstance(v, torch.Tensor) and v.dtype.is_floating_point
                and not bool(torch.isfinite(v).all())):
            raise FloatingPointError(
                f"nan/inf detected in output of op '{name}'")


def enable_operator_stats_collection():
    global _stats
    _stats = {}


def disable_operator_stats_collection():
    """Stop collecting and print the per-dtype op table; returns it as
    {op: {dtype: calls}}."""
    global _stats
    stats = _stats or {}
    _stats = None
    by_op: dict = {}
    for (name, dtype), n in stats.items():
        by_op.setdefault(name, {})[dtype] = n
    cols = ["float32", "bfloat16", "float16", "other"]
    print(f"{'op':<28}" + "".join(f"{c:>10}" for c in cols) + f"{'calls':>8}")
    for name in sorted(by_op):
        row = by_op[name]
        other = sum(v for k, v in row.items()
                    if k not in ("float32", "bfloat16", "float16"))
        out = [row.get("float32", 0), row.get("bfloat16", 0),
               row.get("float16", 0), other]
        print(f"{name:<28}" + "".join(f"{v:>10}" for v in out)
              + f"{sum(row.values()):>8}")
    return by_op


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def check_numerics(tensors, op_type="", var_name="", debug_mode=None):
    """Raise FloatingPointError on nan/inf in the given tensors, with the
    counts (``check_numerics``)."""
    ts = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    for i, t in enumerate(ts):
        v = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            n_nan = int(torch.isnan(v).sum())
            n_inf = int(torch.isinf(v).sum())
            raise FloatingPointError(
                f"check_numerics failed for {op_type or 'tensor'}"
                f"[{var_name or i}]: {n_nan} nan, {n_inf} inf "
                f"in shape {list(v.shape)}")
    return True


class TensorCheckerConfig:
    """Which mode and op scope the seam's checker enforces."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


def enable_tensor_checker(config: TensorCheckerConfig | None = None):
    if config is None or config.enable:
        set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    set_flags({"FLAGS_check_nan_inf": False})
