"""``HybridParallelOptimizer`` and the cross-group clip
(``paddle_tpu.distributed.fleet.meta_optimizers.hybrid_parallel_optimizer``
counterpart; reference: dygraph_optimizer/hybrid_parallel_optimizer.py,
``HybridParallelClipGrad`` :41, ``HybridParallelOptimizer`` :255).

* ``HybridParallelClipGrad``: the global gradient norm of the hybrid
  model. Squares of mp-sharded parameters' gradients are summed over the
  mp group, replicated ones counted once; under ZeRO (stages 1-3) the
  gradients are slices, each with its parameter's ``mp_sharded`` mark,
  so both sums run over the sharding group first; the total is
  summed over the pp group, whose stages hold different parameters (a
  shared-weight copy counts on the first stage holding it only,
  ``is_firstly_shared``). A caller whose pp ranks replicate one step
  (``TrainStep`` over a mesh with a pp axis) builds the optimizer with
  ``sum_pp=False``. Under expert parallelism the experts' blocks
  (``ep_sharded``) are summed over the ep group, every other parameter
  counted once. Gradients are already averaged over dp, so dp adds
  nothing, and summed over sep, where every rank then holds the same
  ones, so sep adds nothing either.
* ``HybridParallelOptimizer``: averages the gradients over the dp group
  when the model is not a ``DataParallel`` (whose reducer averaged them
  in backward), over dp x ep under expert parallelism (the experts'
  blocks summed over dp only, ``fused_allreduce_gradients``), summed over
  dp x sep and divided by dp under sequence parallelism, hands the step
  to ``DygraphShardingOptimizer`` when the
  sharding degree is above 1 (``sharding_configs["stage"]`` 1, 2 or 3;
  at 3 the ZeRO-3 sharded parameters' gradients arrive reduce-scattered
  and the step gathers no parameter back),
  merges ``gradient_merge_configs["k_steps"]`` steps' gradients into one
  update, and keeps the step's global norm (``last_grad_norm``, a device
  scalar), clipped or not.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.topology import ParallelMode
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (
    fused_allreduce_gradients, is_ep_sharded, is_mp_sharded)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, _factor

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "hybrid_global_norm"]


def hybrid_global_norm(params_grads, hcg, sharded: bool = False,
                       sum_pp: bool = True):
    """sqrt of the sum of squares of the hybrid model's gradients (fp32,
    a device scalar); every rank of the model calls it. `sum_pp`: the pp
    ranks hold different stages, so their squares are summed."""
    dev = next((g.device for _, g in params_grads if g is not None),
               torch.device("cpu"))
    # [mp shards, replicated, expert blocks]
    sq = torch.zeros(3, dtype=torch.float32, device=dev)
    for p, g in params_grads:
        if g is not None and getattr(p, "is_firstly_shared", True):
            slot = 0 if is_mp_sharded(p) else 2 if is_ep_sharded(p) else 1
            sq[slot] += g.float().square().sum()
    if sharded:
        collective.all_reduce(sq, group=hcg.get_sharding_parallel_group())
    mp = hcg.get_model_parallel_group()
    if mp.nranks > 1:
        dist_sq = sq[:1].clone()
        collective.all_reduce(dist_sq, group=mp)
        sq[0] = dist_sq[0]
    ep = hcg.get_expert_parallel_group()
    if ep.nranks > 1:
        expert_sq = sq[2:].clone()
        collective.all_reduce(expert_sq, group=ep)
        sq[2] = expert_sq[0]
    total = sq.sum()
    pp = hcg.get_pipe_parallel_group()
    if sum_pp and pp.nranks > 1:
        collective.all_reduce(total, group=pp)
    return torch.sqrt(total)


class HybridParallelClipGrad:
    """reference hybrid_parallel_optimizer.py:41: clip by the hybrid
    global norm."""

    def __init__(self, clip, hcg, sharded: bool = False,
                 sum_pp: bool = True):
        self._clip = clip
        self._hcg = hcg
        self._sharded = sharded
        self._sum_pp = sum_pp
        self.clip_norm = clip.clip_norm
        self.last_norm = None

    def __call__(self, params_grads):
        gn = hybrid_global_norm(params_grads, self._hcg, self._sharded,
                                self._sum_pp)
        self.last_norm = gn
        f = _factor(gn, self.clip_norm)
        return [(p, g if g is None else g * f.to(g.dtype))
                for p, g in params_grads]


class HybridParallelOptimizer:
    """reference hybrid_parallel_optimizer.py:255. `sum_pp=False` where
    the pp ranks replicate one step rather than hold different stages."""

    def __init__(self, optimizer, hcg, strategy=None, sum_pp: bool = True):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
            dygraph_sharding_optimizer import DygraphShardingOptimizer

        self._inner_opt = optimizer
        self._base_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._sum_pp = sum_pp
        self._sharding = hcg.get_sharding_parallel_world_size() > 1
        # under expert parallelism no reducer averaged the gradients in
        # backward (the model is a TensorParallel): the step does it
        # nor under sequence parallelism (the model is a SegmentParallel or
        # a TensorParallel): the step sums over dp x sep
        self._dp_enable = ((hcg.get_data_parallel_world_size() > 1
                            and hcg.get_parallel_mode()
                            != ParallelMode.DATA_PARALLEL)
                           or hcg.get_expert_parallel_world_size() > 1
                           or hcg.get_sep_parallel_world_size() > 1)
        self._gm_steps, self._gm_avg = 1, True
        if strategy is not None and getattr(strategy, "gradient_merge",
                                            False):
            cfg = strategy.gradient_merge_configs
            self._gm_steps = int(cfg.get("k_steps", 1))
            self._gm_avg = bool(cfg.get("avg", True))
        self._gm_buf, self._gm_count = {}, 0
        self.last_grad_norm = None
        stage = 1
        if strategy is not None and self._sharding:
            stage = int(strategy.sharding_configs.get("stage", 1))
        if self._sharding and stage >= 2 and self._gm_steps > 1:
            raise NotImplementedError(f"gradient merge with ZeRO-{stage} "
                                      f"is not ported yet (ROADMAP A8)")
        self._clip = None
        if isinstance(getattr(optimizer, "_grad_clip", None),
                      ClipGradByGlobalNorm):
            self._clip = HybridParallelClipGrad(optimizer._grad_clip, hcg,
                                                self._sharding, sum_pp)
            optimizer._grad_clip = self._clip
        self._params = list(optimizer._params)
        if self._sharding:
            self._inner_opt = DygraphShardingOptimizer(optimizer, hcg, stage,
                                                       sum_pp)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def _merge(self) -> bool:
        """Gradient merge: accumulate this micro step; True when the
        merged gradients are in place for an update."""
        self._gm_count += 1
        for p in self._params:
            if p.grad is not None:
                buf = self._gm_buf.get(id(p))
                self._gm_buf[id(p)] = (p.grad.detach().clone() if buf is None
                                       else buf.add_(p.grad))
        if self._gm_count < self._gm_steps:
            self.clear_grad()
            return False
        scale = 1.0 / self._gm_steps if self._gm_avg else 1.0
        for p in self._params:
            buf = self._gm_buf.get(id(p))
            if buf is not None:
                p.grad = buf.mul_(scale).to(p.dtype)
        self._gm_buf, self._gm_count = {}, 0
        return True

    @torch.no_grad()
    def step(self):
        if self._gm_steps > 1 and not self._merge():
            return
        if self._sharding:
            self._inner_opt.step()
            self.last_grad_norm = self._inner_opt.last_grad_norm
            return
        if self._dp_enable:
            fused_allreduce_gradients(self._params, self._hcg)
        if self._clip is None:
            self.last_grad_norm = hybrid_global_norm(
                [(p, p.grad) for p in self._params], self._hcg,
                sum_pp=self._sum_pp)
            self._base_opt.step()
        else:
            self._base_opt.step()
            self.last_grad_norm = self._clip.last_norm

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad()
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, s):
        return self._inner_opt.set_state_dict(s)
