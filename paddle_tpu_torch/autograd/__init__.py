"""The Paddle autograd API on torch autograd (``paddle_tpu.autograd``
counterpart): ``backward``, grad mode, ``grad`` (``paddle.grad``, on
``torch.autograd.grad``, ``create_graph`` included), ``PyLayer``, and the
functional transforms ``jacobian``, ``hessian``, ``jvp`` and ``vjp`` on
``torch.func``."""
from __future__ import annotations

import torch
from torch.utils import _pytree

from paddle_tpu_torch.autograd import tape
from paddle_tpu_torch.autograd.py_layer import PyLayer, PyLayerContext
from paddle_tpu_torch.autograd.tape import (backward, enable_grad,
                                            grad_enabled, no_grad,
                                            register_post_backward_callback,
                                            set_grad_enabled)

__all__ = ["backward", "no_grad", "enable_grad", "set_grad_enabled",
           "grad_enabled", "register_post_backward_callback", "grad",
           "jacobian", "hessian", "jvp", "vjp", "PyLayer", "PyLayerContext"]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """The gradients of `outputs` with respect to `inputs`, leaving every
    ``.grad`` untouched. An input that receives no gradient (one that
    stops gradients, or is not on the path) raises unless `allow_unused`,
    which gives None for it. With `create_graph` the result is itself
    differentiable."""
    from paddle_tpu_torch.core.tensor import Tensor

    single = isinstance(inputs, Tensor)
    outs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    ins = [inputs] if single else list(inputs)
    vals, seeds = tape._seeds(outs, grad_outputs)
    live = [i for i, t in enumerate(ins) if t._value.requires_grad]
    retain = create_graph if retain_graph is None else bool(retain_graph)

    def run():
        return torch.autograd.grad(
            vals, [ins[i]._value for i in live], seeds, retain_graph=retain,
            create_graph=create_graph, allow_unused=True)

    got = dict(zip(live, tape._with_callbacks(run)))
    tape._release(outs, retain)
    grads = []
    for i in range(len(ins)):
        g = got.get(i)
        if g is None and not allow_unused:
            raise RuntimeError("one of the inputs received no gradient; pass "
                               "allow_unused=True to get None instead")
        grads.append(None if g is None else Tensor(g))
    return grads[0] if single else grads


def _functionalize(func, xs):
    """(f over torch tensors, the inputs' values, single) for the
    torch.func transforms."""
    from paddle_tpu_torch.core.tensor import Tensor, _unwrap

    single = isinstance(xs, Tensor)
    xs_l = [xs] if single else list(xs)

    def f(*arrs):
        outs = func(*[Tensor(a) for a in arrs])
        return _pytree.tree_map(_unwrap, outs)

    return f, [x._value for x in xs_l], single


def _wrap_tree(tree):
    from paddle_tpu_torch.core.tensor import Tensor

    return _pytree.tree_map(
        lambda o: Tensor(o) if isinstance(o, torch.Tensor) else o, tree)


def jacobian(func, xs, batch_axis=None):
    """Dense jacobian of `func` at `xs` (reverse mode)."""
    if not callable(func):
        raise NotImplementedError("jacobian takes a callable")
    f, vals, single = _functionalize(func, xs)
    jac = torch.func.jacrev(f, argnums=tuple(range(len(vals))))(*vals)
    return _wrap_tree(jac[0] if single else list(jac))


def hessian(func, xs, batch_axis=None):
    f, vals, single = _functionalize(func, xs)
    hess = torch.func.hessian(f, argnums=tuple(range(len(vals))))(*vals)
    if single:
        return _wrap_tree(hess[0][0])
    return [_wrap_tree(list(row)) for row in hess]


def jvp(func, xs, v=None):
    """Forward mode: (outputs, J v); `v` holds one tangent per input
    (ones by default)."""
    from paddle_tpu_torch.core.tensor import _unwrap

    f, vals, single = _functionalize(func, xs)
    if v is None:
        tangents = [torch.ones_like(x) for x in vals]
    else:
        tangents = [torch.as_tensor(_unwrap(t), device=x.device)
                    for t, x in zip([v] if single else list(v), vals)]
    out, tangent_out = torch.func.jvp(f, tuple(vals), tuple(tangents))
    return _wrap_tree(out), _wrap_tree(tangent_out)


def vjp(func, xs, v=None):
    """Reverse mode: (outputs, vᵀ J); `v` mirrors the outputs' structure
    (ones by default); a list `v` serves a tuple output."""
    from paddle_tpu_torch.core.tensor import _unwrap

    f, vals, single = _functionalize(func, xs)
    out, pullback = torch.func.vjp(f, *vals)
    leaves, spec = _pytree.tree_flatten(out)
    if v is None:
        cot = [torch.ones_like(o) for o in leaves]
    else:
        cot = [torch.as_tensor(_unwrap(t), device=o.device)
               for t, o in zip(_pytree.tree_leaves(v), leaves)]
    grads = pullback(_pytree.tree_unflatten(cot, spec))
    return _wrap_tree(out), _wrap_tree(grads[0] if single else list(grads))

