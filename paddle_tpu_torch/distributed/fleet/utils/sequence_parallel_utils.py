"""Megatron sequence parallelism inside the tensor-parallel group
(``paddle_tpu.distributed.fleet.utils.sequence_parallel_utils``
counterpart; reference: fleet/utils/sequence_parallel_utils.py,
``ScatterOp`` :85, ``AllGatherOp`` :111, ``ReduceScatterOp`` :127,
``register_sequence_parallel_allreduce_hooks`` :192,
``ColumnSequenceParallelLinear`` :427).

Between the tensor-parallel blocks the activations are split along the
sequence, dim 0 of a ``[S, B, H]`` tensor, over the mp group. The JAX
package writes the three paired collectives as ``custom_vjp`` functions
of ``lax`` collectives; here each is a ``torch.autograd.Function`` over
the port's collectives on this rank's block, with the same pairing:

* ``all_gather``: all-gather dim 0 forward, reduce-scatter backward;
* ``scatter``: keep this rank's block of dim 0 forward, all-gather
  backward;
* ``reduce_scatter``: reduce-scatter dim 0 forward, all-gather backward.

Over an mp group of one rank each is the identity. The group is the
hcg's (or the rank mesh's) mp group unless one is passed.

``ColumnSequenceParallelLinear`` all-gathers its sequence-split input and
applies its column block (weight ``[out / mp, in]``, rows ``[r out/mp,
(r+1) out/mp)`` of the full ``[out, in]``); ``RowSequenceParallelLinear``
applies its row block (weight ``[out, in / mp]``) to an input split
along the features and reduce-scatters the partial sums along the
sequence, then adds the replicated bias. Their shards carry
``mp_sharded`` and ``split_axis`` as the mp layers' do
(``fleet.layers.mpu.mp_layers``); ``models.convert.shard_linear`` cuts a
JAX layer's full ``[in, out]`` weight into a rank's shard. The row
layer's bias sees only this rank's segment of the sequence, so it is
marked ``sequence_parallel`` (as the reference marks it), and
``register_sequence_parallel_allreduce_hooks`` sums a marked parameter's
gradient over mp in the backward.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import _c_identity
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import \
    mp_group as _group_of
from paddle_tpu_torch.nn import functional as F

__all__ = ["ScatterOp", "AllGatherOp", "ReduceScatterOp", "scatter",
           "all_gather", "reduce_scatter", "identity_in_fwd_allreduce_in_bwd",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks"]


def _gather0(x, group):
    return torch.cat(collective.all_gather([], x.contiguous(), group=group),
                     0)


def _block0(x, group):
    n = x.shape[0]
    if n % group.nranks:
        raise ValueError(f"sequence dim {n} is not a multiple of the mp "
                         f"degree {group.nranks}")
    k = n // group.nranks
    return x[group.rank * k:(group.rank + 1) * k].contiguous()


def _reduce_scatter0(x, group):
    if x.shape[0] % group.nranks:
        raise ValueError(f"sequence dim {x.shape[0]} is not a multiple of "
                         f"the mp degree {group.nranks}")
    out = x.new_empty((x.shape[0] // group.nranks,) + tuple(x.shape[1:]))
    return collective.reduce_scatter(out, x.contiguous(), group=group)


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter0(g, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group), None


def _solo(group):
    return group is None or group.nranks == 1


def scatter(x, group=None):
    """This rank's block of dim 0 (all-gather in the backward)."""
    group = _group_of(group)
    return x if _solo(group) else _ScatterSeq.apply(x, group)


def all_gather(x, group=None):
    """The mp group's blocks joined along dim 0 (reduce-scatter in the
    backward)."""
    group = _group_of(group)
    return x if _solo(group) else _AllGatherSeq.apply(x, group)


def reduce_scatter(x, group=None):
    """This rank's block of dim 0 of the mp group's sum (all-gather in the
    backward)."""
    group = _group_of(group)
    return x if _solo(group) else _ReduceScatterSeq.apply(x, group)


class ScatterOp:
    apply = staticmethod(scatter)


class AllGatherOp:
    apply = staticmethod(all_gather)


class ReduceScatterOp:
    apply = staticmethod(reduce_scatter)


def identity_in_fwd_allreduce_in_bwd(x, group=None):
    return _c_identity(x, group)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter) -> bool:
    return getattr(parameter, "sequence_parallel", False) is True


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False,
        group=None):
    """Sum the gradient of every parameter marked
    ``mark_as_sequence_parallel_parameter`` over the mp group in the
    backward (a gradient hook a parameter; reference :192). Returns the
    hook handles."""
    group = _group_of(group)
    if _solo(group):
        return []

    def hook(g):
        g = g.contiguous().clone()
        collective.all_reduce(g, group=group)
        return g

    return [p.register_hook(hook) for p in model.parameters()
            if is_sequence_parallel_parameter(p)]


def _param(shape, fan_in, fan_out, device, dtype, split_axis):
    """A Xavier-normal parameter over the logical full fans (the JAX
    layers' initializer), marked as an mp shard."""
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
    with torch.no_grad():
        p.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)))
    if split_axis is not None:
        p.mp_sharded = True
        p.split_axis = split_axis
    return p


def _per_rank(n, group, what):
    world = 1 if group is None else group.nranks
    if n % world:
        raise ValueError(f"{what} {n} is not a multiple of the mp degree "
                         f"{world}")
    return n // world, world


class ColumnSequenceParallelLinear(nn.Module):
    """reference :427: all-gather the sequence, then this rank's block of
    output features (the output stays split along its last dim)."""

    torch_linear_layout = True    # weight [out, in] (checkpoint.layout)

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.group = _group_of(mp_group)
        per, world = _per_rank(out_features, self.group, "out_features")
        self.in_features, self.out_features = in_features, out_features
        split = 0 if world > 1 else None
        self.weight = _param((per, in_features), in_features, out_features,
                             device, dtype, split)
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(per, device=device,
                                                 dtype=dtype))
            if split is not None:
                self.bias.mp_sharded, self.bias.split_axis = True, 0

    def forward(self, x):
        return F.linear(all_gather(x, self.group), self.weight, self.bias)


class RowSequenceParallelLinear(nn.Module):
    """This rank's block of input features, the partial sums
    reduce-scattered along the sequence, then the bias (marked
    ``sequence_parallel``: its gradient needs the mp sum)."""

    torch_linear_layout = True    # weight [out, in] (checkpoint.layout)

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        self.group = _group_of(mp_group)
        per, world = _per_rank(in_features, self.group, "in_features")
        self.in_features, self.out_features = in_features, out_features
        self.weight = _param((out_features, per), in_features, out_features,
                             device, dtype, 1 if world > 1 else None)
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device,
                                                 dtype=dtype))
            if world > 1:
                mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        out = reduce_scatter(F.linear(x, self.weight, None), self.group)
        if self.bias is not None:
            out = out + self.bias
        return out
