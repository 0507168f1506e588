"""Shape, layout and indexing ops of the Paddle API
(``paddle_tpu.ops.manipulation`` counterpart). ``reshape``, ``split``,
``chunk``, ``transpose`` and the other shape ops return torch views where
torch can (``chunk`` of a packed QKV projection hands attention strided
views); writes never go through them in place (``__setitem__`` rebinds,
see ``ops/__init__.py``)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import to_torch_dtype
from paddle_tpu_torch.core.tensor import Tensor, apply_op, to_tensor
from paddle_tpu_torch.ops.math import _operand

builtins_slice = builtins.slice

__all__ = [
    "reshape", "transpose", "concat", "stack", "split", "chunk", "squeeze",
    "unsqueeze", "flatten", "cast", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "index_select", "index_sample", "tile", "expand",
    "expand_as", "broadcast_to", "flip", "roll", "where", "masked_fill",
    "take_along_axis", "put_along_axis", "topk", "sort", "argsort", "unbind",
    "numel", "slice", "strided_slice", "unstack", "repeat_interleave",
    "moveaxis", "swapaxes", "as_real", "as_complex", "crop", "pad",
    "masked_select", "nonzero", "unique", "bincount", "searchsorted",
    "tensordot", "rot90", "atleast_1d", "atleast_2d", "atleast_3d",
    "view", "view_as", "tensor_split",
]


def _t(x):
    return x if isinstance(x, Tensor) else to_tensor(x)


def _int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    return tuple(_int(s) for s in shape)


def reshape(x, shape):
    s = _shape_list(shape)
    return apply_op(lambda v: torch.reshape(v, s), _t(x), name="reshape")


view = reshape


def view_as(x, other):
    return reshape(x, other.shape)


def transpose(x, perm):
    p = tuple(int(i) for i in perm)
    return apply_op(lambda v: v.permute(p), _t(x), name="transpose")


def moveaxis(x, source, destination):
    return apply_op(lambda v: torch.movedim(v, source, destination), _t(x),
                    name="moveaxis")


def swapaxes(x, axis1, axis2):
    return apply_op(lambda v: torch.swapaxes(v, axis1, axis2), _t(x),
                    name="swapaxes")


def concat(xs, axis=0):
    ax = _int(axis)
    return apply_op(lambda *vs: torch.cat(vs, dim=ax), *[_t(x) for x in xs],
                    name="concat")


def stack(xs, axis=0):
    return apply_op(lambda *vs: torch.stack(vs, dim=int(axis)),
                    *[_t(x) for x in xs], name="stack")


def split(x, num_or_sections, axis=0):
    x = _t(x)
    ax = _int(axis)
    dim = x._value.shape[ax]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if any(s == -1 for s in sizes):
            known = builtins.sum(s for s in sizes if s != -1)
            sizes = [dim - known if s == -1 else s for s in sizes]
    return list(apply_op(lambda v: torch.split(v, sizes, dim=ax), x,
                         name="split"))


def tensor_split(x, num_or_indices, axis=0):
    x = _t(x)
    dim = x._value.shape[axis]
    if isinstance(num_or_indices, int):
        base, rem = divmod(dim, num_or_indices)
        return split(x, [base + (1 if i < rem else 0)
                         for i in range(num_or_indices)], axis)
    idx = [0] + list(num_or_indices) + [dim]
    return split(x, [idx[i + 1] - idx[i] for i in range(len(idx) - 1)], axis)


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def squeeze(x, axis=None):
    x = _t(x)
    shape = x._value.shape
    if axis is None:
        ax = tuple(i for i, s in enumerate(shape) if s == 1)
    else:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        ax = tuple(int(a) for a in axes if shape[int(a)] == 1)
    return apply_op(lambda v: torch.squeeze(v, ax) if ax else v, x,
                    name="squeeze")


def unsqueeze(x, axis):
    x = _t(x)
    if isinstance(axis, (list, tuple)):
        nd = x._value.ndim + len(axis)
        ax = sorted(int(a) % nd for a in axis)
    else:
        ax = [_int(axis) % (x._value.ndim + 1)]

    def f(v):
        for a in ax:
            v = v.unsqueeze(a)
        return v

    return apply_op(f, x, name="unsqueeze")


def flatten(x, start_axis=0, stop_axis=-1):
    x = _t(x)
    nd = x._value.ndim
    if nd == 0:
        return reshape(x, [1])
    sa, ea = start_axis % nd, stop_axis % nd
    shape = list(x._value.shape)
    return reshape(x, shape[:sa] + [int(np.prod(shape[sa:ea + 1]))]
                   + shape[ea + 1:])


def cast(x, dtype):
    d = to_torch_dtype(dtype)
    return apply_op(lambda v: v.to(d), _t(x), name="cast")


def numel(x):
    return to_tensor(np.int64(_t(x).size), place=_t(x).place)


def gather(x, index, axis=0):
    ax = _int(axis)

    def f(v, i):
        out = torch.index_select(v, ax, i.reshape(-1).long())
        return out.squeeze(ax) if i.ndim == 0 else out

    return apply_op(f, _t(x), _t(index), name="gather")


def gather_nd(x, index):
    return apply_op(lambda v, i: v[tuple(i.long().movedim(-1, 0))], _t(x),
                    _t(index), name="gather_nd")


def index_select(x, index, axis=0):
    return apply_op(lambda v, i: torch.index_select(v, int(axis), i.long()),
                    _t(x), _t(index), name="index_select")


def index_sample(x, index):
    return apply_op(lambda v, i: torch.take_along_dim(v, i.long(), dim=1),
                    _t(x), _t(index), name="index_sample")


def scatter(x, index, updates, overwrite=True):
    return apply_op(lambda v, i, u: torch.index_put(
        v, (i.reshape(-1).long(),), u, accumulate=not overwrite),
        _t(x), _t(index), _t(updates), name="scatter")


def scatter_nd_add(x, index, updates):
    return apply_op(lambda v, i, u: torch.index_put(
        v, tuple(i.long().movedim(-1, 0)), u, accumulate=True),
        _t(x), _t(index), _t(updates), name="scatter_nd_add")


def take_along_axis(x, indices, axis, broadcast=True):
    return apply_op(lambda v, i: torch.take_along_dim(v, i.long(),
                                                      dim=int(axis)),
                    _t(x), _t(indices), name="take_along_axis")


def put_along_axis(x, indices, values, axis, reduce="assign"):
    def f(v, i, u):
        u = torch.broadcast_to(u.to(v.dtype), i.shape)
        if reduce == "add":
            return torch.scatter_add(v, int(axis), i.long(), u)
        return torch.scatter(v, int(axis), i.long(), u)

    x = _t(x)
    return apply_op(f, x, _t(indices), _operand(values, x),
                    name="put_along_axis")


def tile(x, repeat_times):
    r = _shape_list(repeat_times)
    return apply_op(lambda v: torch.tile(v, r), _t(x), name="tile")


def expand(x, shape):
    s = _shape_list(shape)
    x = _t(x)
    xs = list(x._value.shape)
    out = tuple(xs[i - (len(s) - len(xs))] if v == -1 else v
                for i, v in enumerate(s))
    return apply_op(lambda v: torch.broadcast_to(v, out), x, name="expand")


def expand_as(x, y):
    return expand(x, y.shape)


def broadcast_to(x, shape):
    return expand(x, shape)


def flip(x, axis):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    return apply_op(lambda v: torch.flip(v, ax), _t(x), name="flip")


def roll(x, shifts, axis=None):
    return apply_op(lambda v: torch.roll(v, shifts, axis), _t(x),
                    name="roll")


def where(condition, x=None, y=None):
    cond = _t(condition)
    if x is None and y is None:
        return nonzero(cond, as_tuple=False)
    if isinstance(x, Tensor):
        y = _operand(y, x)
    else:
        y = _t(y)
        x = _operand(x, y)
    return apply_op(torch.where, cond, x, y, name="where")


def masked_fill(x, mask, value):
    val = value.item() if isinstance(value, Tensor) else value
    return apply_op(lambda v, m: v.masked_fill(m, val), _t(x), _t(mask),
                    name="masked_fill")


def masked_select(x, mask):
    return apply_op(torch.masked_select, _t(x), _t(mask),
                    name="masked_select")


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(_t(x)._value)
    if as_tuple:
        return tuple(Tensor(c) for c in nz.unbind(1))
    return Tensor(nz)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """Host-side (numpy), as in the JAX package."""
    x = _t(x)
    res = np.unique(x.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return to_tensor(res, place=x.place)
    return tuple(to_tensor(r, place=x.place) for r in res)


def bincount(x, weights=None, minlength=0):
    if weights is None:
        return apply_op(lambda v: torch.bincount(v, minlength=minlength),
                        _t(x), name="bincount")
    return apply_op(lambda v, w: torch.bincount(v, w, minlength=minlength),
                    _t(x), _t(weights), name="bincount")


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return apply_op(lambda s, v: torch.searchsorted(
        s, v, right=right, out_int32=out_int32), _t(sorted_sequence),
        _t(values), name="searchsorted")


def topk(x, k, axis=-1, largest=True, sorted=True):
    kk = _int(k)

    def f(v):
        out = torch.topk(v, kk, dim=axis, largest=largest, sorted=sorted)
        return out.values, out.indices

    return apply_op(f, _t(x), name="topk")


def sort(x, axis=-1, descending=False):
    def f(v):
        out = torch.sort(v, dim=axis, stable=True).values
        return torch.flip(out, (axis,)) if descending else out

    return apply_op(f, _t(x), name="sort")


def argsort(x, axis=-1, descending=False):
    """A stable ascending argsort, reversed for `descending` (ties then
    come last index first, as in the JAX package)."""
    def f(v):
        idx = torch.argsort(v, dim=axis, stable=True)
        return torch.flip(idx, (axis,)) if descending else idx

    return apply_op(f, _t(x), name="argsort")


def unbind(x, axis=0):
    return list(apply_op(lambda v: torch.unbind(v, axis), _t(x),
                         name="unbind"))


unstack = unbind


def slice(x, axes, starts, ends):
    x = _t(x)
    idx = [builtins_slice(None)] * x._value.ndim
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins_slice(_int(st), _int(en))
    tid = tuple(idx)
    return apply_op(lambda v: v[tid], x, name="slice")


def strided_slice(x, axes, starts, ends, strides):
    x = _t(x)
    idx = [builtins_slice(None)] * x._value.ndim
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        if int(sr) < 0:
            raise NotImplementedError("negative strides are not ported")
        idx[ax] = builtins_slice(int(st), int(en), int(sr))
    tid = tuple(idx)
    return apply_op(lambda v: v[tid], x, name="strided_slice")


def repeat_interleave(x, repeats, axis=None):
    r = repeats._value if isinstance(repeats, Tensor) else repeats
    return apply_op(lambda v: torch.repeat_interleave(v, r, dim=axis), _t(x),
                    name="repeat_interleave")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    x = _t(x)
    nd = x._value.ndim
    pad = _shape_list(pad)
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle: pad the last len(pad)//2 spatial dims, innermost first
        cfg = [(0, 0)] * nd
        n = len(pad) // 2
        dims = (list(range(nd - n, nd))
                if data_format in ("NCHW", "NCL", "NCDHW")
                else list(range(1, 1 + n)))
        for i, d in enumerate(reversed(dims)):
            cfg[d] = (pad[2 * i], pad[2 * i + 1])
    flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "replicate", "circular": "circular"}[mode]

    def f(v):
        if tmode == "constant":
            return torch.nn.functional.pad(v, flat, value=value)
        return torch.nn.functional.pad(v, flat, mode=tmode)

    return apply_op(f, x, name="pad")


def crop(x, shape=None, offsets=None):
    x = _t(x)
    shape = _shape_list(shape)
    offsets = (_shape_list(offsets) if offsets is not None
               else (0,) * len(shape))
    idx = tuple(builtins_slice(o, o + s) for o, s in zip(offsets, shape))
    return apply_op(lambda v: v[idx], x, name="crop")


def tensordot(x, y, axes=2):
    return apply_op(lambda a, b: torch.tensordot(a, b, dims=axes), _t(x),
                    _t(y), name="tensordot")


def rot90(x, k=1, axes=(0, 1)):
    return apply_op(lambda v: torch.rot90(v, k, list(axes)), _t(x),
                    name="rot90")


def _atleast(fn, name, xs):
    outs = [apply_op(fn, _t(x), name=name) for x in xs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*xs):
    return _atleast(torch.atleast_1d, "atleast_1d", xs)


def atleast_2d(*xs):
    return _atleast(torch.atleast_2d, "atleast_2d", xs)


def atleast_3d(*xs):
    return _atleast(torch.atleast_3d, "atleast_3d", xs)


def as_real(x):
    return apply_op(torch.view_as_real, _t(x), name="as_real")


def as_complex(x):
    return apply_op(lambda v: torch.view_as_complex(v.contiguous()), _t(x),
                    name="as_complex")
