"""The semi-auto API's shard-optimizer wrapper (``paddle_tpu.distributed.
fleet.sharding_stages`` counterpart; reference: auto_parallel/api.py
``_ShardOptimizer`` :853 with the ``ShardingStage1/2/3`` placements
:1122/:1183/:1269), on the port's ``DygraphShardingOptimizer`` over the
rank mesh's group along the stage's ``axis_name``.

``ShardingStage1`` shards the optimizer state, ``ShardingStage2`` the
gradients too (reduce-scattered as the backward completes each), and
``ShardingStage3`` the parameters as well: each of the optimizer's
parameters becomes a held unit of its own (``meta_parallel.sharding.
group_sharded``) that persists as this rank's 1/N. The wrapper knows
the optimizer only, not the model, so it arms a module forward pre-hook
once a step: the first module call that reaches a sharded parameter
gathers them all and takes the hook away again, and the step
reduce-scatters their gradients, releases them before it updates the
shards, and arms the hook for the next forward. The hook holds the
wrapper weakly and goes with it.
"""
from __future__ import annotations

import weakref

import torch

from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding.group_sharded import (  # noqa: E501
    ParamSharder, _Groups, _solo)

__all__ = ["ShardOptimizerWrapper", "ShardingStage1", "ShardingStage2",
           "ShardingStage3"]


class ShardingStage1:
    stage = 1

    def __init__(self, axis_name="dp", mesh=None):
        self.axis_name = axis_name
        self.mesh = mesh


class ShardingStage2(ShardingStage1):
    stage = 2


class ShardingStage3(ShardingStage1):
    stage = 3


class ShardOptimizerWrapper:
    def __init__(self, optimizer, shard_fn=None):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
            dygraph_sharding_optimizer import DygraphShardingOptimizer
        from paddle_tpu_torch.distributed.mesh import get_mesh

        axis = getattr(shard_fn, "axis_name", "dp")
        mesh = getattr(shard_fn, "mesh", None) or get_mesh()
        group = (mesh.group(axis) if mesh is not None and axis in mesh.shape
                 else _solo())
        stage = getattr(shard_fn, "stage", 1)
        self.sharder = None
        self._disarm = None
        if stage == 3:
            self.sharder = ParamSharder(group)
            for name, p in zip(optimizer._names, optimizer._params):
                self.sharder.add_unit(name, p, [(name, p)])
            self._ids = frozenset(id(p) for u in self.sharder.units
                                  for p in u.params)
            self._arm()
        self._inner_opt = DygraphShardingOptimizer(
            optimizer, _Groups(group), stage=stage, sum_pp=False)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def _arm(self):
        """Hook the next module call that reaches a sharded parameter: it
        gathers them all and disarms the hook."""
        ref = weakref.ref(self)
        ids = self._ids

        def gather_before_use(module, args):
            w = ref()
            if w is not None and any(id(p) in ids
                                     for p in module.parameters()):
                w._disarm()
                w.sharder.begin()

        handle = torch.nn.modules.module.register_module_forward_pre_hook(
            gather_before_use)
        self._disarm = weakref.finalize(self, handle.remove)

    def step(self):
        self._inner_opt.step()
        if self._disarm is not None and not self._disarm.alive:
            self._arm()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad
