"""Fleet, the hybrid-parallel facade (``paddle_tpu.distributed.fleet``
counterpart; reference: python/paddle/distributed/fleet, ``Fleet`` at
fleet/fleet.py:100, ``init`` :167, ``distributed_optimizer`` :1326,
fleet/model.py:140).

``init(strategy=...)`` builds the ``HybridCommunicateGroup`` of the
strategy's degrees over the joined process group (``init_parallel_env``
first; a world of one needs none); calling it again builds another. An
``ep_degree`` above 1 adds the expert axis, innermost (the JAX package's
fleet ignores ``ep_degree``; its MoE layer reads the mesh's "ep" axis).
``distributed_model`` applies the strategy's amp and recompute passes
(``_apply_strategy_passes``), then wraps by parallel mode:
``DataParallel`` over the dp group in data (and sharding) parallel mode,
``TensorParallel`` in tensor-parallel mode and under expert parallelism,
``PipelineParallel`` around a ``PipelineLayer`` when pp > 1 (1F1B, VPP
or ZB-H1 by ``pipeline_configs["schedule_mode"]``), and
``SegmentParallel`` under sequence parallelism without mp or pp (the
reference's SEGMENT_PARALLEL mode; the hybrid optimizer sums the
gradients over dp x sep at its step).
``distributed_optimizer`` wraps with ``HybridParallelOptimizer`` (dp
averaging, the hybrid clip with its norm summed over mp and pp, ZeRO-1/2
at ``sharding_configs["stage"]``, gradient merge). ``recompute`` is
activation recomputation (``fleet.recompute``); ``elastic`` the elastic
manager; ``utils.fs`` the filesystem abstraction.
"""
from __future__ import annotations

import functools

from paddle_tpu_torch.distributed.fleet.base.distributed_strategy import (  # noqa: F401
    DistributedStrategy)
from paddle_tpu_torch.distributed.fleet.rng import get_rng_state_tracker  # noqa: F401
from paddle_tpu_torch.distributed.fleet.topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode)

__all__ = ["DistributedStrategy", "init", "fleet",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "get_rng_state_tracker", "worker_index",
           "worker_num", "barrier_worker", "ParallelMode", "utils",
           "meta_parallel", "recompute"]

_hcg: list = [None]
_strategy: list = [None]


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    """reference fleet/fleet.py:167."""
    strategy = strategy or DistributedStrategy()
    _strategy[0] = strategy
    hc = strategy.hybrid_configs
    names = ["pipe", "data", "sharding", "sep", "model"]
    dims = [hc["pp_degree"], hc["dp_degree"], hc["sharding_degree"],
            hc["sep_degree"], hc["mp_degree"]]
    if int(hc.get("ep_degree", 1) or 1) > 1:
        # expert parallelism: the innermost axis, as "ep" follows the
        # others in the rank mesh
        names.append("expert")
        dims.append(int(hc["ep_degree"]))
    topo = CommunicateTopology(hybrid_group_names=names, dims=dims)
    _hcg[0] = HybridCommunicateGroup(topo)
    return _hcg[0]


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _hcg[0] is None:
        init()
    return _hcg[0]


def get_strategy() -> DistributedStrategy:
    return _strategy[0] or DistributedStrategy()


def reset():
    """Forget the hcg and the strategy (the next ``init`` builds anew)."""
    _hcg[0] = None
    _strategy[0] = None


def _apply_strategy_passes(model, strategy):
    """The strategy's model passes (reference fleet/meta_optimizers' amp
    and recompute): ``amp`` with ``use_pure_fp16`` casts the model to the
    amp dtype (O2, ``amp.decorate``). ``recompute`` wraps, with
    ``fleet.recompute``, every sublayer whose name contains one of
    ``recompute_configs["checkpoints"]`` (``named_modules`` of a torch
    module, ``named_sublayers`` of a Paddle-API ``Layer``) and marks it
    ``_recompute_wrapped``; a match inside a wrapped sublayer is left as
    it is (the JAX package wraps it too, nesting the remat, which here
    would run its forward once more a level). Given no patterns, a
    ``layer_remat_capable`` model gets ``remat_policy`` "full" (its
    layer loop recomputes every decoder layer; ``TrainStep`` reads it
    when given no ``remat`` of its own), where the JAX package wraps
    nothing: the same numbers in less memory."""
    if strategy is None:
        return model
    if getattr(strategy, "amp", False) and \
            strategy.amp_configs.get("use_pure_fp16"):
        from paddle_tpu_torch import amp

        model = amp.decorate(model, level="O2",
                             dtype=strategy.amp_configs.get("dtype",
                                                            "bfloat16"))
    if getattr(strategy, "recompute", False):
        patterns = list(strategy.recompute_configs.get("checkpoints") or [])
        if patterns:
            _wrap_recompute(model, patterns)
        elif getattr(model, "layer_remat_capable", False):
            model.remat_policy = "full"
    return model


def _wrap_recompute(model, patterns):
    from paddle_tpu_torch.distributed.fleet.recompute import recompute

    named = (model.named_modules() if hasattr(model, "named_modules")
             else model.named_sublayers())
    wrapped = []
    for name, sub in named:
        if not name or not any(p in name for p in patterns) or \
                any(name.startswith(w + ".") for w in wrapped):
            continue
        sub.forward = functools.partial(recompute, sub.forward)
        sub._recompute_wrapped = True
        wrapped.append(name)


def distributed_model(model):
    """reference fleet/model.py:140: wrap by parallel mode after the
    strategy's passes."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel, SegmentParallel, TensorParallel)
    from paddle_tpu_torch.distributed.parallel import DataParallel

    hcg = get_hybrid_communicate_group()
    strat = get_strategy()
    model = _apply_strategy_passes(model, strat)
    mode = hcg.get_parallel_mode()
    if mode == ParallelMode.PIPELINE_PARALLEL:
        if not isinstance(model, PipelineLayer):
            raise TypeError("pp > 1 needs the model as a PipelineLayer "
                            "(fleet.meta_parallel.PipelineLayer)")
        return PipelineParallel(model, hcg, strat)
    if mode == ParallelMode.TENSOR_PARALLEL:
        return TensorParallel(model, hcg, strat)
    if hcg.get_expert_parallel_world_size() > 1:
        # expert parallelism: the hybrid optimizer averages the gradients
        # at its step, the experts' apart from the rest
        return TensorParallel(model, hcg, strat)
    if hcg.get_sep_parallel_world_size() > 1:
        # sequence parallelism: the hybrid optimizer sums the gradients
        # over dp x sep at its step
        return SegmentParallel(model, hcg, strat)
    # data (and sharding) parallel: the reducer averages over dp; the
    # sharding optimizer reduces over the sharding group itself
    return DataParallel(
        model, group=hcg.get_data_parallel_group(),
        comm_buffer_size=(getattr(strat, "fuse_grad_size_in_MB", 25)
                          if getattr(strat, "fuse_all_reduce_ops", True)
                          else 25),
        last_comm_buffer_size=getattr(strat, "last_comm_group_size_MB", 1),
        find_unused_parameters=getattr(strat, "find_unused_parameters",
                                       False))


def distributed_optimizer(optimizer, strategy=None):
    """reference fleet/fleet.py:1326."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
        hybrid_parallel_optimizer import HybridParallelOptimizer

    return HybridParallelOptimizer(optimizer, get_hybrid_communicate_group(),
                                   strategy or get_strategy())


def worker_index():
    from paddle_tpu_torch.distributed.env import get_rank

    return get_rank()


def worker_num():
    from paddle_tpu_torch.distributed.env import get_world_size

    return get_world_size()


def barrier_worker():
    from paddle_tpu_torch.distributed.collective import barrier

    barrier()


class _FleetModule:
    """``fleet.fleet`` object parity."""

    init = staticmethod(init)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    worker_index = staticmethod(worker_index)
    worker_num = staticmethod(worker_num)
    barrier_worker = staticmethod(barrier_worker)
    get_hybrid_communicate_group = staticmethod(get_hybrid_communicate_group)


fleet = _FleetModule()

from paddle_tpu_torch.distributed.fleet import meta_parallel  # noqa: F401,E402
from paddle_tpu_torch.distributed.fleet import utils  # noqa: F401,E402
from paddle_tpu_torch.distributed.fleet.recompute import recompute  # noqa: F401,E402
