"""``PyLayer``: user-defined autograd ops of the Paddle API on
``torch.autograd.Function`` (``paddle_tpu.autograd.py_layer`` counterpart).

``forward(ctx, *args)`` runs without recording on the caller's ``Tensor``
arguments; ``backward(ctx, *grads)`` gets the outputs' gradients as
``Tensor``s and returns one gradient (or None) per ``Tensor`` argument, in
order. ``ctx.save_for_backward`` keeps tensors for the backward
(``ctx.saved_tensor``).
"""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Function(torch.autograd.Function):
    """One PyLayer call: ``vals`` are the call's arguments with every
    ``Tensor`` unwrapped, so torch links the outputs to them."""

    @staticmethod
    def forward(tctx, layer, ctx, args, kwargs, *vals):
        from paddle_tpu_torch.core.tensor import Tensor, _unwrap

        outs = layer.forward(ctx, *args, **kwargs)
        multi = isinstance(outs, (tuple, list))
        outs = list(outs) if multi else [outs]
        tctx.layer, tctx.ctx, ctx._multi = layer, ctx, multi
        tctx.is_tensor = [isinstance(a, Tensor) for a in args]
        vals = [_unwrap(o) if isinstance(o, Tensor) else torch.as_tensor(o)
                for o in outs]
        # an output that is an input unchanged must be a new tensor to
        # carry this node
        return tuple(v.view_as(v) for v in vals)

    @staticmethod
    def backward(tctx, *grads):
        from paddle_tpu_torch.core.tensor import Tensor, _unwrap

        gin = tctx.layer.backward(tctx.ctx, *[Tensor(g) for g in grads])
        if not isinstance(gin, (tuple, list)):
            gin = (gin,)
        it = iter(gin)
        out = []
        for is_t in tctx.is_tensor:
            g = next(it, None) if is_t else None
            out.append(None if g is None else _unwrap(g))
        return (None, None, None, None, *out)


class PyLayer:
    """Subclass with @staticmethod forward(ctx, *args) and
    backward(ctx, *grads)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        from paddle_tpu_torch.core.tensor import Tensor, _unwrap

        ctx = PyLayerContext()
        vals = [_unwrap(a) if isinstance(a, Tensor) else None for a in args]
        outs = _Function.apply(cls, ctx, args, kwargs, *vals)
        wrapped = tuple(Tensor(o) for o in outs)
        return wrapped if ctx._multi else wrapped[0]
