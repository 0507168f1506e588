"""The Paddle-API eager ``Tensor`` on a torch tensor
(``paddle_tpu.core.tensor`` counterpart).

``Tensor._value`` is a ``torch.Tensor`` on the current device
(``core.device``). Every op runs through ``apply_op``, which unwraps its
arguments, passes them through the AMP seam under the op's JAX name (the
O1/O2 casts and the operator stats of ``amp.debugging``), runs the op's
torch function under torch autograd, checks the outputs when
``FLAGS_check_nan_inf`` is on, and wraps them. The graph is torch's: an
output stops gradients exactly when it does not require grad.

Paddle's autograd semantics on top of torch's:

- ``stop_gradient`` defaults to True and is ``not requires_grad`` of a
  leaf; an integer tensor (which torch cannot mark) keeps the flag itself.
- Setting ``stop_gradient = True`` on an op's output detaches it, so what
  is computed from it later gets no gradient through it.
- ``grad`` of a non-leaf is None unless ``retain_grads()`` was called;
  leaf gradients accumulate across backwards until ``clear_grad()``.
- ``register_hook(hook)`` calls ``hook`` with the gradient as a ``Tensor``
  and uses what it returns, if anything, instead.
- ``set_value``/``copy_`` write in place under ``no_grad`` when shape and
  dtype are unchanged, so a parameter keeps its storage (and optimizers
  and views keep seeing it); otherwise they rebind ``_value``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from paddle_tpu_torch.amp import apply_seam, check_outputs
from paddle_tpu_torch.autograd import tape as _tape
from paddle_tpu_torch.core import dtype as _dtype_mod
from paddle_tpu_torch.core.device import Place, current_device

__all__ = ["Tensor", "to_tensor", "apply_op", "is_tensor"]


def _differentiable(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


class _NoHook:
    def remove(self):
        pass


class Tensor:
    """Eager tensor with define-by-run autograd (torch's)."""

    __slots__ = ("_value", "_sg", "name", "persistable", "__weakref__",
                 "__dict__")

    def __init__(self, value, stop_gradient: bool | None = None,
                 name: str | None = None):
        if isinstance(value, Tensor):
            value = value._value
        self._value = value
        self._sg = True
        self.name = name
        self.persistable = False
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient

    # ---- autograd state ---------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        v = self._value
        if _differentiable(v.dtype):
            return not v.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, sg: bool):
        v = self._value
        if not _differentiable(v.dtype):
            self._sg = bool(sg)
        elif v.grad_fn is None:
            if v.requires_grad != (not sg):
                v.requires_grad_(not sg)
        elif sg:
            self._value = v.detach()

    @property
    def grad(self):
        v = self._value
        if v.grad_fn is not None and not v.retains_grad:
            return None
        g = v.grad
        return None if g is None else Tensor(g)

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else _unwrap(g)

    @property
    def _grad_node(self):
        return self._value.grad_fn

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    # ---- basic properties -------------------------------------------------
    @property
    def shape(self) -> list:
        return list(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.ndim

    @property
    def size(self) -> int:
        return self._value.numel()

    @property
    def dtype(self):
        return _dtype_mod.convert_dtype(self._value.dtype)

    @property
    def place(self) -> Place:
        dev = self._value.device
        return Place("cpu" if dev.type == "cpu" else "gpu", dev.index or 0)

    @property
    def T(self):
        return self.transpose(list(range(self.ndim))[::-1])

    @property
    def value(self):
        return self._value

    # ---- conversion -------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """The values as a numpy array (bfloat16 widens to float32:
        numpy has no bfloat16)."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def item(self):
        return self._value.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        return float(self._value.detach())

    def __int__(self):
        return int(self._value.detach())

    def __index__(self):
        return int(self._value.detach())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("truth value of a multi-element Tensor is "
                             "ambiguous")
        return bool(self._value)

    def __len__(self):
        if not self._value.shape:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"{self.numpy()})")

    def __hash__(self):
        return id(self)

    # ---- autograd ---------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        _tape.backward([self], [grad_tensor] if grad_tensor is not None
                       else None, retain_graph)

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def retain_grads(self):
        if self._value.grad_fn is not None:
            self._value.retain_grad()

    def register_hook(self, hook: Callable):
        """hook(grad: Tensor) -> Tensor | None, called once a backward with
        this tensor's whole gradient; returns a handle with .remove()."""
        if not self._value.requires_grad:
            return _NoHook()

        def torch_hook(g):
            new = hook(Tensor(g))
            return None if new is None else _unwrap(new)

        return self._value.register_hook(torch_hook)

    def detach(self) -> "Tensor":
        return Tensor(self._value.detach(), name=self.name)

    def clone(self) -> "Tensor":
        return apply_op(torch.clone, self, name="clone")

    # ---- value writes -----------------------------------------------------
    def _set_value(self, new_value):
        new = _unwrap(new_value)
        v = self._value
        if (isinstance(new, torch.Tensor) and new.shape == v.shape
                and new.dtype == v.dtype):
            with torch.no_grad():
                v.copy_(new)
            return
        if not isinstance(new, torch.Tensor):
            new = torch.as_tensor(np.asarray(new), device=v.device)
        self._value = new.detach().to(v.device).requires_grad_(
            v.requires_grad and v.grad_fn is None
            and _differentiable(new.dtype))

    def set_value(self, new_value):
        if not isinstance(new_value, (Tensor, torch.Tensor)):
            new_value = torch.as_tensor(
                np.asarray(new_value), device=self._value.device).to(
                    self._value.dtype)
        self._set_value(new_value)

    def copy_(self, other, blocking=True):
        self._set_value(other)
        return self

    # ---- device -----------------------------------------------------------
    def block_until_ready(self):
        if self._value.is_cuda:
            torch.cuda.synchronize(self._value.device)
        return self

    def element_size(self):
        return self._value.element_size()

    def cpu(self):
        return apply_op(lambda v: v.cpu(), self, name="memcpy_d2h",
                        seam=False)

    def cuda(self, device_id=None, blocking=True):
        dev = current_device("gpu" if device_id is None else f"gpu:"
                             f"{device_id}")
        return apply_op(lambda v: v.to(dev), self, name="memcpy_h2d",
                        seam=False)

    def pin_memory(self):
        return self

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> Tensor:
    """``paddle.to_tensor``: a new tensor on `place` (the current device by
    default) holding `data`. Python floats take the default float dtype;
    numpy arrays and integers keep theirs."""
    dev = current_device(place)
    tdt = _dtype_mod.to_torch_dtype(dtype)
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        val = data.detach().to(device=dev, dtype=tdt, copy=True)
    else:
        arr = data if isinstance(data, np.ndarray) else np.asarray(data)
        if (not isinstance(data, np.ndarray) and tdt is None
                and arr.dtype == np.float64):
            tdt = _dtype_mod.get_default_dtype().torch_dtype
        val = _from_numpy(arr).to(device=dev, dtype=tdt)
    return Tensor(val, stop_gradient=stop_gradient)


# ---------------------------------------------------------------------------
# Eager dispatch
# ---------------------------------------------------------------------------

def _unwrap(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (list, tuple)) and any(isinstance(a, Tensor)
                                            for a in x):
        return type(x)(_unwrap(a) for a in x)
    return x


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor(out)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return out


def apply_op(fn: Callable, *args, name: str | None = None,
             seam: bool = True, **kwargs):
    """Run one op eagerly: `fn(*args, **kwargs)` on the unwrapped torch
    tensors under torch autograd, its outputs wrapped as ``Tensor``s (a
    tuple for several). With `seam` the positional tensors first pass the
    AMP seam under `name` (casts, operator stats) and the outputs the
    nan/inf check; the functions of ``nn.functional`` that do both
    themselves pass ``seam=False``."""
    name = name or getattr(fn, "__name__", "op")
    vals = tuple(_unwrap(a) for a in args)
    if kwargs:
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    if seam:
        vals = apply_seam(name, vals)
        return _wrap(check_outputs(name, fn(*vals, **kwargs)))
    return _wrap(fn(*vals, **kwargs))
