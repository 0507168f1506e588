"""Hybrid-parallel gradient and parameter synchronisation
(``paddle_tpu.distributed.fleet.utils.hybrid_parallel_util`` counterpart;
reference: fleet/utils/hybrid_parallel_util.py, ``fused_allreduce_gradients``
:241, ``sync_params_buffers`` :190, ``broadcast_*_parameters``).

Every rank of the group calls each helper: they run collectives over the
hcg's groups (``distributed.collective``).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed import collective

__all__ = ["fused_allreduce_gradients", "broadcast_dp_parameters",
           "broadcast_mp_parameters", "broadcast_sep_parameters",
           "broadcast_sharding_parameters", "sync_params_buffers",
           "is_mp_sharded"]


def is_mp_sharded(p) -> bool:
    """A tensor-parallel shard (``mp_sharded``, set by the mp layers):
    its values differ across the mp group by design."""
    return getattr(p, "mp_sharded", False) is True


def fused_allreduce_gradients(parameter_list, hcg):
    """Average every gradient over the data-parallel group, bucketed like
    the reducer (25 MB a bucket, one dtype each): a parameter without a
    gradient joins as zeros, so all ranks run the same collectives."""
    from paddle_tpu_torch.distributed.reducer import assign_buckets

    g = hcg.get_data_parallel_group()
    if g.nranks == 1:
        return
    params = [p for p in parameter_list if p.requires_grad]
    with torch.no_grad():
        for b in assign_buckets(params, 25, 25):
            flat = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1).to(b.dtype) for p in b.params])
            collective.all_reduce(flat, group=g)
            flat.div_(g.nranks)
            off = 0
            for p, size, shape in zip(b.params, b.sizes, b.shapes):
                avg = flat[off:off + size].view(shape).to(p.dtype)
                if p.grad is None:
                    p.grad = avg.clone()
                else:
                    p.grad.copy_(avg)
                off += size


def sync_params_buffers(model, comm_group=None, src_rank=None,
                        is_model_parallel=False, skip_param=None):
    """Broadcast every parameter and buffer of `model` from global rank
    `src_rank` (the group's first when None) over `comm_group`;
    ``skip_param(p)`` exempts parameters whose per-rank values are
    authoritative (mp shards)."""
    g = comm_group if comm_group is not None else collective.get_group(0)
    if g.nranks == 1:
        return
    src = g.ranks[0] if src_rank is None else src_rank
    with torch.no_grad():
        for p in model.parameters():
            if skip_param is not None and skip_param(p):
                continue
            collective.broadcast(p.data, src=src, group=g)
        for b in model.buffers():
            collective.broadcast(b, src=src, group=g)


def broadcast_dp_parameters(model, hcg):
    sync_params_buffers(model, hcg.get_data_parallel_group())


def broadcast_mp_parameters(model, hcg):
    """The parameters and buffers replicated across the mp group (norms,
    row-parallel biases); the mp shards stay as they are."""
    sync_params_buffers(model, hcg.get_model_parallel_group(),
                        skip_param=is_mp_sharded)


def broadcast_sep_parameters(model, hcg):
    sync_params_buffers(model, hcg.get_sep_parallel_group())


def broadcast_sharding_parameters(model, hcg):
    """Replicas across the sharding group start from its first rank's
    parameters (ZeRO shards the optimizer state, not the model)."""
    sync_params_buffers(model, hcg.get_sharding_parallel_group())
