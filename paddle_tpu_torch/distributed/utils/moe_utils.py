"""MoE dispatch collectives (``paddle_tpu.distributed.utils.moe_utils``
counterpart; reference: distributed/utils/moe_utils.py:20, CUDA ops
fluid/operators/collective/global_{scatter,gather}_op.*).

``global_scatter`` and ``global_gather`` are the tiled all-to-all over
the group's ranks: block j of dim 0 goes to rank j, and the blocks
received stand in rank order. The JAX package lowers both to
``lax.all_to_all(tiled=True)`` over the expert axis inside ``shard_map``;
here they are ``collective.all_to_all_single`` on the rank's own tensor
(gloo stages CUDA tensors through host memory), so ``collective.stats()``
counts their calls, bytes and host seconds under "all_to_all".

The tiled exchange is its own inverse, so the two are the same exchange,
and each is differentiable: its backward is the inverse exchange of the
cotangent. Every rank of the group must call them in the same order with
tensors of one shape. As in the JAX package, ``local_count`` and
``global_count`` are accepted and not used: the MoE layer sends static
worst-case buckets, so every block has one size. A group of one rank, or
None, is the identity.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed import collective

__all__ = ["global_scatter", "global_gather"]


def _exchange(x, group):
    if x.shape[0] % group.nranks:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not split into "
                         f"{group.nranks} equal blocks")
    x = x.contiguous()
    out = torch.empty_like(x)
    collective.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _exchange(dy, ctx.group), None


def _tiled_all_to_all(x, group):
    if group is None or group.nranks == 1:
        return x
    return _AllToAll.apply(x, group)


def global_scatter(x, local_count=None, global_count=None, group=None):
    """Dispatch block j of `x`'s dim 0 to rank j of `group` (reference
    moe_utils.py:20); returns the blocks received, in rank order."""
    return _tiled_all_to_all(x, group)


def global_gather(x, local_count=None, global_count=None, group=None):
    """The inverse of ``global_scatter``: block j goes back to rank j."""
    return _tiled_all_to_all(x, group)
