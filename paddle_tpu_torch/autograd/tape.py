"""Grad mode and ``backward`` of the Paddle API on torch autograd
(``paddle_tpu.autograd.tape`` counterpart).

The JAX package records one ``GradNode`` per op and walks them itself; the
port's ops run under torch autograd, so the graph is torch's and
``backward`` is ``torch.autograd.backward``. What stays the JAX package's:
grad mode is one thread-local switch (torch's), a seed may be omitted only
for a one-element output, a ``stop_gradient`` output raises, a second
backward through a released graph raises (torch frees the saved tensors),
and the callbacks of ``register_post_backward_callback`` run after each
outermost backward (``on_error`` instead when it raised).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["backward", "grad_enabled", "no_grad", "enable_grad",
           "set_grad_enabled", "register_post_backward_callback"]


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))


class _GradMode(contextlib.ContextDecorator):
    """`paddle.no_grad` / `enable_grad`: a context manager and decorator
    over torch's thread-local grad mode."""

    def __init__(self, mode: bool):
        self._mode = mode
        self._prev = []

    def __enter__(self):
        self._prev.append(torch.is_grad_enabled())
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev.pop())
        return False


def no_grad():
    return _GradMode(False)


def enable_grad():
    return _GradMode(True)


_post_backward_callbacks: list = []
_backward_depth = [0]


def register_post_backward_callback(fn, on_error=None):
    """Register fn() to run after each outermost backward() completes (the
    reducer's finalize hook); when backward raises, on_error() runs
    instead, if given. Returns a handle with .remove()."""
    _post_backward_callbacks.append((fn, on_error))

    class _Handle:
        def remove(self):
            try:
                _post_backward_callbacks.remove((fn, on_error))
            except ValueError:
                pass

    return _Handle()


def _seeds(tensors, grad_tensors):
    from paddle_tpu_torch.core.tensor import Tensor

    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    vals, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if t.stop_gradient:
            raise RuntimeError(
                "cannot call backward() on a tensor with stop_gradient=True")
        if t.__dict__.get("_graph_released"):
            raise RuntimeError(
                "the graph of this tensor was already released; call "
                "backward with retain_graph=True to backprop through the "
                "same graph twice")
        v = t._value
        if g is None:
            if v.numel() != 1:
                raise RuntimeError(
                    f"grad must be provided for non-scalar backward seeds "
                    f"(got shape {list(v.shape)})")
            seed = torch.ones_like(v)
        elif isinstance(g, Tensor):
            seed = g._value
        else:
            seed = torch.as_tensor(g, dtype=v.dtype, device=v.device)
        vals.append(v)
        seeds.append(seed)
    return vals, seeds


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """Reverse-mode AD from `tensors` into the ``.grad`` of every leaf that
    does not stop gradients (accumulating across calls)."""
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(tensors, Tensor):
        tensors = [tensors]
    tensors = list(tensors)
    vals, seeds = _seeds(tensors, grad_tensors)
    _with_callbacks(lambda: torch.autograd.backward(
        vals, seeds, retain_graph=retain_graph))
    _release(tensors, retain_graph)


def _release(tensors, retain_graph):
    """Mark the roots of a backward that did not retain its graph: a
    second backward from them raises, as the JAX tape's released nodes
    do (torch raises only where the graph saved tensors)."""
    if not retain_graph:
        for t in tensors:
            if t._value.grad_fn is not None:
                t._graph_released = True


def _with_callbacks(run):
    """run() as one backward: the post-backward callbacks follow the
    outermost one (``on_error`` ones when it raised)."""
    _backward_depth[0] += 1
    ok = False
    try:
        out = run()
        ok = True
    finally:
        _backward_depth[0] -= 1
        if _backward_depth[0] == 0:
            for cb, on_error in list(_post_backward_callbacks):
                if ok:
                    cb()
                elif on_error is not None:
                    on_error()
    return out
