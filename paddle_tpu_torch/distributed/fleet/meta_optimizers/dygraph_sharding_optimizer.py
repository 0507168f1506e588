"""ZeRO-1, ZeRO-2 and ZeRO-3 (``paddle_tpu.distributed.fleet.
meta_optimizers.dygraph_sharding_optimizer`` counterpart; reference:
dygraph_optimizer/dygraph_sharding_optimizer.py:44, V2 with flat buffers
:566).

The JAX package shards the optimizer state over the "sharding" mesh axis
and lets GSPMD place the reduce-scatter and the all-gather. Here each
sharding rank owns a contiguous 1/N slice of every parameter (flattened,
padded with zeros to a multiple of N): its optimizer state covers that
slice only (the wrapped optimizer's parameters become the slices, in the
same order, so names and decay flags keep their index). A step
reduce-scatters each gradient over the sharding group (then averages the
slice over the dp group, and under expert parallelism a replicated
parameter's slice over the ep group), divides by the data-parallel
count, runs the
wrapped optimizer on the slices (the clip through
``HybridParallelClipGrad``) and all-gathers the updated slices into the
parameters. Adam's update is elementwise, so the slices' update is the
whole parameter's.

* ``stage=1``: the full gradients stay in ``p.grad`` until the step;
* ``stage=2``: each gradient is reduce-scattered as soon as backward
  completes it (``register_post_accumulate_grad_hook``) and ``p.grad`` is
  dropped, so a rank keeps its gradient slice only;
* ``stage=3``: a parameter that ZeRO-3 sharded (``meta_parallel.sharding.
  group_sharded``) is represented by its slice of its unit's shard. The
  layer loop (or the held unit's ``finish()``, which the step calls
  first) has already reduce-scattered its gradient into the shard's
  gradient; the step averages that over dp, updates the slices, which are
  views of the shard, and gathers nothing: the parameter stays sharded. A
  parameter that is not sharded takes the stage-1 route.

Under sequence parallelism the ranks of the sep group hold segments of
the same rows: each gradient is first summed over the sep group (stage 1
at the step, stage 2 in its hook), then reduce-scattered over the
sharding group, and sep adds nothing to the divisor. ZeRO-3 with sep is
refused where the step is built (ROADMAP A8).

Zero padding stays zero: a zero gradient moves neither Adam's moments nor
a zero parameter. At stage 1 a parameter without a gradient joins as
zeros, so all ranks run the same collectives; stage 2 reduces in backward
and needs every rank to use the same parameters.

``state_dict()`` gathers every parameter's state whole over the sharding
group, in the unsharded optimizer's layout, and ``set_state_dict()``
keeps this rank's slice of such a state: a sharded run resumes unsharded
and the other way round. An optimizer that already holds whole states
when it is wrapped (restored by ``checkpoint.elastic.restore`` before the
step was built) keeps this rank's slice of them the same way.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (
    is_ep_sharded, is_mp_sharded)

__all__ = ["DygraphShardingOptimizer"]


def _zero3_mark(p):
    return getattr(p, "_zero3", None)


class DygraphShardingOptimizer:
    def __init__(self, optimizer, hcg, stage: int = 1, sum_pp: bool = True):
        if stage not in (1, 2, 3):
            raise ValueError(f"sharding stage {stage}: expected 1, 2 or 3")
        self._inner_opt = optimizer
        self._hcg = hcg
        self._sum_pp = sum_pp
        self.stage = stage
        self._group = hcg.get_sharding_parallel_group()
        self._dp_group = hcg.get_data_parallel_group()
        ep = hcg.get_expert_parallel_group()
        self._ep_group = ep if ep.nranks > 1 else None
        sep = hcg.get_sep_parallel_group()
        self._sep_group = sep if sep.nranks > 1 else None
        self._full = list(optimizer._params)
        n, r = self._group.nranks, self._group.rank
        self._z3 = [_zero3_mark(p) is not None for p in self._full]
        self._per = [0 if z else -(-p.numel() // n)
                     for p, z in zip(self._full, self._z3)]
        units = {}
        slices = []
        with torch.no_grad():
            for p, per, z in zip(self._full, self._per, self._z3):
                if z:
                    u, bi, i = _zero3_mark(p)
                    if u.sharder.group.ranks != self._group.ranks:
                        raise ValueError(
                            f"unit {u.name!r} is sharded over ranks "
                            f"{u.sharder.group.ranks}, the optimizer over "
                            f"{self._group.ranks}")
                    units.setdefault(id(u), u)
                    slices.append(u.buckets[bi].slices[i])
                    continue
                s = self._flat(p.detach(), per)[r * per:(r + 1) * per].clone()
                s.requires_grad_(p.requires_grad)
                s.mp_sharded = is_mp_sharded(p)
                s.ep_sharded = is_ep_sharded(p)
                slices.append(s)
        if any(self._z3) and stage != 3:
            raise ValueError("the model's parameters are ZeRO-3 sharded; the "
                             "sharding optimizer needs stage 3")
        if any(self._z3) and self._ep_group is not None:
            raise NotImplementedError("ZeRO-3 under expert parallelism is "
                                      "not ported yet (ROADMAP A8)")
        self._units = list(units.values())
        self._sharders = []
        for u in self._units:
            if all(u.sharder is not s for s in self._sharders):
                self._sharders.append(u.sharder)
        self._slices = slices
        optimizer._entries = slices
        self._index = {id(p): i for i, p in enumerate(self._full)}
        self.last_grad_norm = None
        self._hooks = []
        if stage == 2:
            self.enable_grad_hooks()
        if optimizer._state:
            # whole-parameter states restored before sharding (an elastic
            # resume): each rank keeps its slice
            whole = {f"param_{i}": {k: v.detach().float().cpu().numpy()
                                    for k, v in st.items()}
                     for i, st in optimizer._state.items() if st}
            optimizer._state = {}
            self.set_state_dict({"step": optimizer._step_count, **whole})

    def enable_grad_hooks(self):
        """ZeRO-2: reduce-scatter each gradient of a parameter that is not
        ZeRO-3 sharded as soon as the backward completes it."""
        if self._hooks or self.stage == 3:
            return
        self.stage = 2
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                       for p, z in zip(self._full, self._z3)
                       if p.requires_grad and not z]

    def _flat(self, t, per):
        """`t` flattened and zero-padded to nranks x per elements."""
        flat = t.reshape(-1)
        pad = per * self._group.nranks - flat.numel()
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def _scatter(self, i, g):
        """This rank's slice of the sharding group's sum of gradient `g`
        (first summed over the sep group, in place)."""
        if self._sep_group is not None:
            collective.all_reduce(g, group=self._sep_group)
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
        here at stage 1, in backward at stage 2 and for ZeRO-3 units),
        summed over the dp group, divided by the data-parallel count.
        Under expert parallelism the ep ranks hold other rows too: a
        replicated parameter's slice is also summed over the ep group, an
        expert block's is not (its owner's gradient already sums the ep
        ranks' contributions), and both are divided by the count of
        ranks holding different rows."""
        ep = self._ep_group
        denom = (self._group.nranks * self._dp_group.nranks
                 * (ep.nranks if ep is not None else 1))
        for u in self._units:
            for b in u.buckets:
                if not b.shard.requires_grad:
                    continue
                if b.shard.grad is None:
                    b.shard.grad = torch.zeros_like(b.shard.detach())
                g = b.shard.grad
                if self._dp_group.nranks > 1:
                    collective.all_reduce(g, group=self._dp_group)
                g.div_(denom)
                for s, (a, e) in zip(b.slices, b.ranges):
                    if s.requires_grad:
                        s.grad = g[a:e]
        for i, (p, s) in enumerate(zip(self._full, self._slices)):
            if self._z3[i] or not p.requires_grad:
                continue
            if not self._hooks:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                s.grad = self._scatter(i, g)
            elif s.grad is None:
                s.grad = torch.zeros(self._per[i], dtype=p.dtype,
                                     device=p.device)
            if self._dp_group.nranks > 1:
                collective.all_reduce(s.grad, group=self._dp_group)
            if ep is not None and not is_ep_sharded(p):
                collective.all_reduce(s.grad, group=ep)
            s.grad.div_(denom)

    @torch.no_grad()
    def step(self):
        """Reduce, update the slices, gather the parameters that are not
        ZeRO-3 sharded; keeps the hybrid global norm of the reduced
        gradients (``last_grad_norm``, the clip's when it clips by the
        global norm)."""
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
            hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                              hybrid_global_norm)

        for sharder in self._sharders:
            sharder.finish()
        r = self._group.rank
        for p, s, per, z in zip(self._full, self._slices, self._per,
                                self._z3):
            if not z:
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
        for p, s, z in zip(self._full, self._slices, self._z3):
            if not z:
                parts = collective.all_gather([], s.detach(),
                                              group=self._group)
                p.copy_(torch.cat(parts)[:p.numel()].view_as(p))

    def slice_grads(self):
        return [(s, s.grad) for s in self._slices if s.grad is not None]

    def clear_grad(self, set_to_zero=False):
        for t in self._full + self._slices:
            t.grad = None
        for u in self._units:
            for b in u.buckets:
                b.shard.grad = None

    clear_gradients = clear_grad

    # ---- whole-parameter state ----------------------------------------------
    def _bucket_state(self, u, bi, key, cache):
        """The full padded flat of state `key` over bucket `bi` of unit `u`
        (each rank's slices' states laid into its shard range, gathered)."""
        ck = (id(u), bi, key)
        if ck not in cache:
            b = u.buckets[bi]
            local = torch.zeros(b.per, dtype=torch.float32,
                                device=b.device)
            for j, (a, e) in enumerate(b.ranges):
                st = self._inner_opt._state.get(
                    self._index[id(b.params[j])])
                if st is not None and e > a:
                    local[a:e] = st[key].reshape(-1).float()
            full = torch.empty(b.padded, dtype=torch.float32,
                               device=b.device)
            collective.all_gather_async(full, local, self._group).wait()
            cache[ck] = full
        return cache[ck]

    @torch.no_grad()
    def _whole(self, i, key, v, cache):
        p = self._full[i]
        if v.dim() == 0 or v.numel() != self._slices[i].numel():
            return v            # a state that is not per element
        if self._z3[i]:
            u, bi, j = _zero3_mark(p)
            b = u.buckets[bi]
            o, k = b.offsets[j], b.numels[j]
            return self._bucket_state(u, bi, key, cache)[o:o + k].view(
                b.shapes[j])
        parts = collective.all_gather([], v.float(), group=self._group)
        return torch.cat(parts)[:p.numel()].view(p.shape)

    def state_dict(self):
        """The wrapped optimizer's ``state_dict`` with each parameter's
        state whole (every rank of the sharding group calls it)."""
        sd = self._inner_opt.state_dict()
        cache = {}
        for i in range(len(self._full)):
            st = self._inner_opt._state.get(i)
            if st:
                sd[f"param_{i}"] = {
                    k: self._whole(i, k, v, cache).cpu().numpy()
                    for k, v in st.items()}
        return sd

    def set_state_dict(self, state):
        """Load a whole-parameter ``state_dict`` (this class's or the
        unsharded optimizer's), keeping this rank's slice of each state."""
        import numpy as np

        r = self._group.rank
        out = {k: v for k, v in state.items() if not k.startswith("param_")}
        for i, p in enumerate(self._full):
            saved = state.get(f"param_{i}")
            if saved is None:
                continue
            sl = {}
            for k, v in saved.items():
                v = np.asarray(v, np.float32)
                if v.ndim == 0:
                    sl[k] = v
                    continue
                if v.size == self._slices[i].numel():   # the slice is whole
                    sl[k] = v.reshape(-1)
                    continue
                flat = v.reshape(-1)
                if self._z3[i]:
                    u, bi, j = _zero3_mark(p)
                    b = u.buckets[bi]
                    a, e = b.ranges[j]
                    lo = r * b.per - b.offsets[j]
                    sl[k] = flat[lo + a:lo + e]
                else:
                    per = self._per[i]
                    pad = np.zeros(per * self._group.nranks - flat.size,
                                   np.float32)
                    sl[k] = np.concatenate([flat, pad])[r * per:(r + 1) * per]
            out[f"param_{i}"] = sl
        return self._inner_opt.set_state_dict(out)
