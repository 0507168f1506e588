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
           "broadcast_sharding_parameters", "broadcast_ep_parameters",
           "sync_params_buffers", "is_mp_sharded", "is_ep_sharded"]


def is_mp_sharded(p) -> bool:
    """A tensor-parallel shard (``mp_sharded``, set by the mp layers):
    its values differ across the mp group by design."""
    return getattr(p, "mp_sharded", False) is True


def is_ep_sharded(p) -> bool:
    """An expert-parallel shard (``ep_sharded``, set by ``ExpertFFN``):
    this rank's block of the experts, different across the ep group."""
    return getattr(p, "ep_sharded", False) is True


def fused_allreduce_gradients(parameter_list, hcg):
    """Average every gradient over the data-parallel group, bucketed like
    the reducer (25 MB a bucket, one dtype each): a parameter without a
    gradient joins as zeros, so all ranks run the same collectives.

    Under expert parallelism the ranks of the ep group hold different
    rows, so the average runs over dp x ep: a replicated parameter's
    gradient is summed over the dp x ep group, an expert's over the dp
    group only (its owner's gradient already sums every ep rank's
    contribution, through the all-to-all's backward), and both are
    divided by dp x ep.

    Under sequence parallelism the ranks of the sep group hold different
    segments of the same rows, and each one's loss is its share of the
    rows' mean: every gradient is summed over dp x sep and divided by dp
    (the JAX package's rule, "sep contribution unscaled"). Expert
    parallelism beside sep is refused where the step is built."""
    ep = hcg.get_expert_parallel_group()
    g = hcg.get_data_parallel_group()
    if hcg.get_sep_parallel_world_size() > 1:
        _allreduce_mean(parameter_list, hcg.get_dp_sep_parallel_group(),
                        g.nranks)
        return
    if ep.nranks == 1:
        _allreduce_mean(parameter_list, g, g.nranks)
        return
    params = [p for p in parameter_list if p.requires_grad]
    n = g.nranks * ep.nranks
    _allreduce_mean([p for p in params if not is_ep_sharded(p)],
                    hcg.get_dp_sharding_ep_parallel_group(), n)
    _allreduce_mean([p for p in params if is_ep_sharded(p)], g, n)


def _allreduce_mean(parameter_list, g, n):
    """Each gradient summed over group `g` and divided by `n`."""
    from paddle_tpu_torch.distributed.reducer import assign_buckets

    if g.nranks == 1 and n == 1:
        return
    params = [p for p in parameter_list if p.requires_grad]
    with torch.no_grad():
        for b in assign_buckets(params, 25, 25):
            flat = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1).to(b.dtype) for p in b.params])
            collective.all_reduce(flat, group=g)
            flat.div_(n)
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


def broadcast_ep_parameters(model, hcg):
    """The parameters replicated across the ep group (everything but the
    experts' blocks)."""
    sync_params_buffers(model, hcg.get_expert_parallel_group(),
                        skip_param=is_ep_sharded)


def broadcast_sharding_parameters(model, hcg):
    """Replicas across the sharding group start from its first rank's
    parameters (ZeRO shards the optimizer state, not the model)."""
    sync_params_buffers(model, hcg.get_sharding_parallel_group())
