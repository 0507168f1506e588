"""ZeRO-1 and ZeRO-2 (``paddle_tpu.distributed.fleet.meta_optimizers.
dygraph_sharding_optimizer`` counterpart; reference:
dygraph_optimizer/dygraph_sharding_optimizer.py:44, V2 with flat buffers
:566).

The JAX package shards the optimizer state over the "sharding" mesh axis
and lets GSPMD place the reduce-scatter and the all-gather. Here each
sharding rank owns a contiguous 1/N slice of every parameter (flattened,
padded with zeros to a multiple of N): its optimizer state covers that
slice only (the wrapped optimizer's parameters become the slices, in the
same order, so names and decay flags keep their index). A step
reduce-scatters each gradient over the sharding group (then averages the
slice over the dp group), divides by the data-parallel count, runs the
wrapped optimizer on the slices (the clip through
``HybridParallelClipGrad``) and all-gathers the updated slices into the
parameters. Adam's update is elementwise, so the slices' update is the
whole parameter's.

* ``stage=1``: the full gradients stay in ``p.grad`` until the step;
* ``stage=2``: each gradient is reduce-scattered as soon as backward
  completes it (``register_post_accumulate_grad_hook``) and ``p.grad`` is
  dropped, so a rank keeps its gradient slice only.

Zero padding stays zero: a zero gradient moves neither Adam's moments nor
a zero parameter. At stage 1 a parameter without a gradient joins as
zeros, so all ranks run the same collectives; stage 2 reduces in backward
and needs every rank to use the same parameters. ZeRO-3 is later work
(ROADMAP A8).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (
    is_mp_sharded)

__all__ = ["DygraphShardingOptimizer"]


class DygraphShardingOptimizer:
    def __init__(self, optimizer, hcg, stage: int = 1, sum_pp: bool = True):
        if stage not in (1, 2):
            raise NotImplementedError(
                f"sharding stage {stage}: the port has ZeRO-1 and ZeRO-2; "
                f"ZeRO-3 is later work (ROADMAP A8)")
        self._inner_opt = optimizer
        self._hcg = hcg
        self._sum_pp = sum_pp
        self.stage = stage
        self._group = hcg.get_sharding_parallel_group()
        self._dp_group = hcg.get_data_parallel_group()
        self._full = list(optimizer._params)
        n, r = self._group.nranks, self._group.rank
        self._per = [-(-p.numel() // n) for p in self._full]
        slices = []
        with torch.no_grad():
            for p, per in zip(self._full, self._per):
                s = self._flat(p.detach(), per)[r * per:(r + 1) * per].clone()
                s.requires_grad_(p.requires_grad)
                s.mp_sharded = is_mp_sharded(p)
                slices.append(s)
        self._slices = slices
        optimizer._entries = slices
        self._index = {id(p): i for i, p in enumerate(self._full)}
        self.last_grad_norm = None
        self._hooks = []
        if stage == 2:
            self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                           for p in self._full if p.requires_grad]

    def _flat(self, t, per):
        """`t` flattened and zero-padded to nranks x per elements."""
        flat = t.reshape(-1)
        pad = per * self._group.nranks - flat.numel()
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def _scatter(self, i, g):
        """This rank's slice of the sharding group's sum of gradient `g`."""
        out = g.new_empty(self._per[i])
        collective.reduce_scatter(out, self._flat(g, self._per[i]),
                                  group=self._group)
        return out

    @torch.no_grad()
    def _hook(self, p):
        i = self._index[id(p)]
        part = self._scatter(i, p.grad)
        s = self._slices[i]
        s.grad = part if s.grad is None else s.grad.add_(part)
        p.grad = None

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    @torch.no_grad()
    def reduce_gradients(self):
        """Each slice's gradient: the sharding group's sum (reduce-scattered
        here at stage 1, in backward at stage 2), summed over the dp group,
        divided by the data-parallel count."""
        denom = self._group.nranks * self._dp_group.nranks
        for i, (p, s) in enumerate(zip(self._full, self._slices)):
            if not p.requires_grad:
                continue
            if self.stage == 1:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                s.grad = self._scatter(i, g)
            elif s.grad is None:
                s.grad = torch.zeros(self._per[i], dtype=p.dtype,
                                     device=p.device)
            if self._dp_group.nranks > 1:
                collective.all_reduce(s.grad, group=self._dp_group)
            s.grad.div_(denom)

    @torch.no_grad()
    def step(self):
        """Reduce, update the slices, gather the parameters; keeps the
        hybrid global norm of the reduced gradients (``last_grad_norm``,
        the clip's when it clips by the global norm)."""
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
            hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                              hybrid_global_norm)

        n, r = self._group.nranks, self._group.rank
        for p, s, per in zip(self._full, self._slices, self._per):
            s.copy_(self._flat(p.detach(), per)[r * per:(r + 1) * per])
        self.reduce_gradients()
        clip = getattr(self._inner_opt, "_grad_clip", None)
        if not isinstance(clip, HybridParallelClipGrad):
            self.last_grad_norm = hybrid_global_norm(
                self.slice_grads(), self._hcg, sharded=True,
                sum_pp=self._sum_pp)
        self._inner_opt.step()
        if isinstance(clip, HybridParallelClipGrad):
            self.last_grad_norm = clip.last_norm
        for p, s in zip(self._full, self._slices):
            parts = collective.all_gather([], s.detach(), group=self._group)
            p.copy_(torch.cat(parts)[:p.numel()].view_as(p))

    def slice_grads(self):
        return [(s, s.grad) for s in self._slices if s.grad is not None]

    def clear_grad(self, set_to_zero=False):
        for t in self._full + self._slices:
            t.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, s):
        return self._inner_opt.set_state_dict(s)
