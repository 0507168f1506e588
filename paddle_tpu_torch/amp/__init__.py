"""Automatic mixed precision of the port (``paddle_tpu.amp`` counterpart):
``auto_cast``/``autocast``, ``decorate``, ``GradScaler``, the O1 lists
``white_list``/``black_list`` and ``is_bfloat16_supported``.

O1 casts by op name at the port's dispatch seam, with the JAX package's
lists (``paddle_tpu/amp/__init__.py:28-37``): the functions of
``nn.functional`` (``linear`` — so every ``Projection`` —, ``embedding``,
``rms_norm``, ``sdpa``, ``fused_linear_cross_entropy``, ``mean``) and the
model's ``rope`` call ``apply_seam(name, args)``, which consults the
thread-local ``_AmpState`` as JAX's ``_amp_cast_hook`` does inside
``apply_op``: a white-listed op's float inputs go to the AMP dtype, a
black-listed op's to fp32, others stay; under O2 every op but the black
list goes to the AMP dtype. ``torch.autocast`` is not used: its own lists
would cast other ops. O2's ``decorate`` casts the parameters and turns on
the optimizer's fp32 master weights (``multi_precision``).

``GradScaler`` is the JAX package's dynamic loss-scaling state machine:
``scale``, ``unscale_`` (one device flag over every gradient, read once),
``step`` skipping the update on a non-finite gradient, ``update`` with the
increase/decrease counters and the consecutive-skip guard
(``scaler_max_consecutive_skips``), ``state_dict``. ``TrainStep(
grad_scaler=...)`` drives the same machine inside its step.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from paddle_tpu_torch.core.flags import flag

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported", "white_list",
           "black_list", "apply_seam", "fp8", "debugging"]

# O1 lists (the JAX package's, reference amp_lists.py)
WHITE_LIST = {
    "matmul", "mm", "bmm", "einsum", "conv2d", "conv1d", "conv3d", "mv",
    "linear", "flash_attention", "sdpa",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp",
    "softmax_with_cross_entropy", "cross_entropy", "mean", "sum", "softmax",
    "log_softmax", "norm", "var", "std", "rsqrt", "sqrt", "divide", "pow",
    "erf", "erfinv", "cumsum",
}
_AMP_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def _to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[str(dtype)]


def _amp_cast_hook(op_name: str, vals):
    """The cast rule of one seam op (``_amp_cast_hook``): float inputs of a
    white-listed op to the AMP dtype, of a black-listed one to fp32 (O2:
    every op but the black list to the AMP dtype)."""
    if not _state.enabled:
        return vals
    if _state.level == "O2":
        if op_name in BLACK_LIST or op_name in _state.custom_black:
            target = torch.float32
        else:
            target = _state.dtype
    elif op_name in (_state.custom_white | (WHITE_LIST - _state.custom_black)):
        target = _state.dtype
    elif op_name in (BLACK_LIST | _state.custom_black):
        target = torch.float32
    else:
        return vals
    return tuple(v.to(target) if isinstance(v, torch.Tensor)
                 and v.dtype in _AMP_FLOATS and v.dtype != target else v
                 for v in vals)


def apply_seam(op_name: str, vals: tuple) -> tuple:
    """The dispatch seam every AMP-aware op of the port goes through with
    its tensor arguments: the AMP cast (``_amp_cast_hook``, looked up at
    call time) and the operator-stats count of ``amp.debugging``."""
    if _state.enabled:
        vals = _amp_cast_hook(op_name, vals)
    if debugging._stats is not None:
        debugging._count(op_name, vals)
    return vals


def check_outputs(op_name: str, out):
    """The tensor checker of ``amp.debugging`` on a seam op's output(s):
    raises FloatingPointError on nan/inf when ``check_nan_inf`` is on."""
    if flag("check_nan_inf"):
        debugging._nan_check(op_name, out)
    return out


def state_snapshot() -> tuple:
    """This thread's AMP state, for ``restored_state`` on another thread
    (autograd runs a CUDA backward, and so a remat recompute, on its own
    device thread)."""
    return (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)


@contextlib.contextmanager
def restored_state(snap: tuple):
    prev = state_snapshot()
    (_state.enabled, _state.dtype, _state.level, _state.custom_white,
     _state.custom_black) = snap
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = enable
    _state.dtype = _to_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


autocast = auto_cast


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every float parameter of `models` to the AMP dtype in place
    and turn on the fp32 master weights of `optimizers`
    (``multi_precision``; call before the first step). Returns `models`,
    or ``(models, optimizers)`` when optimizers are given."""
    d = _to_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    for m in model_list:
        for p in m.parameters():
            if p.dtype.is_floating_point:
                p.data = p.data.to(d)
    if optimizers is not None:
        opt_list = (optimizers if isinstance(optimizers, (list, tuple))
                    else [optimizers])
        for o in opt_list:
            if hasattr(o, "_use_master_weights"):
                o._use_master_weights = True
        return models, optimizers
    return models


def is_bfloat16_supported(place=None):
    if torch.cuda.is_available():
        return torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(place=None):
    return True


class GradScaler:
    """Dynamic loss scaling (the JAX package's ``GradScaler``): with float16
    the full dynamic-scale state machine, with bfloat16 an init scale of 1
    is the usual choice."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._consecutive_skips = 0
        self._skip_streak_warned = False
        # per-optimizer INIT/UNSCALED/STEPPED, so unscale_(opt); clip;
        # step(opt) divides by the scale once
        self._opt_states = {}

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        state = self._opt_states.get(id(optimizer), "INIT")
        if state == "UNSCALED":
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update().")
        if state == "STEPPED":
            raise RuntimeError("unscale_() is being called after step().")
        self._opt_states[id(optimizer)] = "UNSCALED"
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer._parameter_list():
            if p.grad is not None:
                p.grad.mul_(inv)
                b = ~torch.isfinite(p.grad).all()
                bad = b if bad is None else bad | b
        self._found_inf = bool(bad) if bad is not None else False

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer), "INIT")
        if state == "STEPPED":
            raise RuntimeError("step() has already been called since the "
                               "last update().")
        if state != "UNSCALED":
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._opt_states[id(optimizer)] = "STEPPED"
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def _track_skip_streak(self):
        if not self._found_inf:
            self._consecutive_skips = 0
            self._skip_streak_warned = False
            return
        self._consecutive_skips += 1
        limit = int(flag("scaler_max_consecutive_skips"))
        if not limit:
            return
        if self._consecutive_skips >= limit:
            raise FloatingPointError(
                f"GradScaler skipped {self._consecutive_skips} consecutive "
                f"steps on non-finite gradients: the model is almost "
                f"certainly permanently NaN and no further step can recover "
                f"it. Halting instead of skipping forever; roll back to a "
                f"healthy checkpoint. Limit is "
                f"FLAGS_scaler_max_consecutive_skips={limit} (0 disables).")
        if (not self._skip_streak_warned
                and self._consecutive_skips >= max(1, limit // 2)):
            self._skip_streak_warned = True
            import warnings

            warnings.warn(
                f"GradScaler has skipped {self._consecutive_skips} "
                f"consecutive steps on non-finite gradients (loss scale now "
                f"{self._scale:g}); training is making NO progress and will "
                f"halt at FLAGS_scaler_max_consecutive_skips={limit}")

    def update(self):
        self._opt_states.clear()
        if self._enable:
            self._track_skip_streak()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]


from paddle_tpu_torch.amp import debugging  # noqa: E402
from paddle_tpu_torch.amp import fp8  # noqa: E402,F401
from paddle_tpu_torch.amp.fp8 import fp8_autocast  # noqa: E402,F401
