"""Tensor-parallel communication as autograd Functions
(``paddle_tpu.distributed.fleet.layers.mpu.mp_ops`` counterpart;
reference: fleet/layers/mpu/mp_ops.py).

The forward/backward pairs of the JAX package's ``custom_vjp`` ops
(``mp_ops.py:33-62``), each over the model-parallel group (the hcg's,
unless a group is passed):

* ``_c_identity``: identity forward, all-reduce backward (the input of
  a column-parallel layer);
* ``_mp_allreduce``: all-reduce forward, identity backward (the output of
  a row-parallel layer);
* ``_c_split``: keep this rank's block of the last dim forward,
  all-gather backward;
* ``_c_concat``: all-gather along the last dim forward, keep this rank's
  block backward.

Where the JAX ops run as ``lax`` collectives inside ``shard_map``, these
run the port's collectives (``distributed.collective``) on the rank's own
shard. Over a group of one rank each is the identity, with no
communication.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed import collective

__all__ = ["_c_identity", "_mp_allreduce", "_c_concat", "_c_split",
           "mp_group", "MP_AXIS"]

MP_AXIS = "mp"


def mp_group(group=None):
    """`group`, else the hcg's model-parallel group, else the global rank
    mesh's "mp" group, else None (no tensor parallelism)."""
    if group is not None:
        return group
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import get_mesh

    hcg = fleet._hcg[0]
    if hcg is not None:
        return hcg.get_model_parallel_group()
    mesh = get_mesh()
    return mesh.group("mp") if mesh is not None else None


def _solo(group) -> bool:
    return group is None or group.nranks == 1


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        collective.all_reduce(g, group=ctx.group)
        return g, None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        collective.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group):
    parts = collective.all_gather([], x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _block_last(x, group):
    n = x.shape[-1] // group.nranks
    return x[..., group.rank * n:(group.rank + 1) * n].contiguous()


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _block_last(g, ctx.group), None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        if x.shape[-1] % group.nranks:
            raise ValueError(f"_c_split: last dim {x.shape[-1]} is not a "
                             f"multiple of the mp degree {group.nranks}")
        return _block_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    group = mp_group(group)
    return tensor if _solo(group) else _CIdentity.apply(tensor, group)


def _mp_allreduce(tensor, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    group = mp_group(group)
    return tensor if _solo(group) else _MpAllreduce.apply(tensor, group)


def _c_concat(tensor, group=None):
    group = mp_group(group)
    return tensor if _solo(group) else _CConcat.apply(tensor, group)


def _c_split(tensor, group=None):
    group = mp_group(group)
    return tensor if _solo(group) else _CSplit.apply(tensor, group)
