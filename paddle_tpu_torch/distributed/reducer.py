"""Bucketed data-parallel gradient averaging, the EagerReducer analog
(``paddle_tpu.distributed.reducer`` counterpart; reference:
paddle/fluid/distributed/collective/reducer.cc group assembly :512,
MarkVarReady :798, FusedAllReduceSchedule :1093).

* Buckets are fixed at wrap by ``assign_buckets``, the JAX package's rule:
  trainable parameters in reverse ``parameters()`` order (the expected
  backward order), one dtype a bucket, at most ``comm_buffer_size`` MB,
  the first bucket capped at ``last_comm_buffer_size`` MB so its
  collective starts early in backward. A parameter listed twice (a tied
  weight) takes one slot: autograd accumulates its gradient once per
  backward, so its hook fires once.
* ``register_post_accumulate_grad_hook`` marks a parameter ready once its
  gradient for this backward is complete; a complete bucket is flattened
  into one buffer and its all-reduce is started (``async_op``), while the
  rest of the backward runs.
* Buckets start in ascending index order behind a next-bucket pointer,
  as the JAX reducer does (``reducer.py:192``, :228-230): a bucket that
  completes early waits for its turn. Completion order may differ across
  ranks (``find_unused_parameters`` with rank-divergent usage); the
  sequence of collectives does not.
* At the end of the backward (a callback queued on autograd's engine by
  the first hook), buckets never completed are completed: with
  ``find_unused_parameters`` their missing gradients count as zeros; else
  the reducer raises, naming the parameters (all ranks must reduce the
  same buckets). Then every collective is waited for and each gradient
  replaced by the group average.
* With ``enabled`` False (``DataParallel.no_sync``) the hooks do nothing;
  the next synced backward's hooks see the whole accumulated gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Variable

from paddle_tpu_torch.distributed import collective

__all__ = ["GradReducer", "assign_buckets"]


class Bucket:
    __slots__ = ("index", "dtype", "params", "sizes", "shapes", "filled")

    def __init__(self, index, dtype):
        self.index = index
        self.dtype = dtype
        self.params, self.sizes, self.shapes = [], [], []
        self.filled = set()

    def nbytes(self):
        return sum(self.sizes) * torch.empty((), dtype=self.dtype)\
            .element_size()


def assign_buckets(params, comm_buffer_size=25, last_comm_buffer_size=1):
    """Fixed bucket assignment (the JAX package's ``assign_buckets``, :93):
    reverse order, trainable parameters only, one dtype a bucket, the
    first capped at `last_comm_buffer_size` MB, the others at
    `comm_buffer_size` MB."""
    buckets, cur_by_dtype, seen = [], {}, set()
    for p in reversed(list(params)):
        if not p.requires_grad or id(p) in seen:
            continue
        seen.add(id(p))
        b = cur_by_dtype.get(p.dtype)
        cap_mb = (last_comm_buffer_size
                  if b is not None and b.index == 0 or not buckets
                  else comm_buffer_size) or comm_buffer_size
        cap = max(int(cap_mb * (1 << 20)), 1)
        if b is None or b.nbytes() + p.numel() * p.element_size() > cap:
            b = Bucket(len(buckets), p.dtype)
            buckets.append(b)
            cur_by_dtype[p.dtype] = b
        b.params.append(p)
        b.sizes.append(p.numel())
        b.shapes.append(tuple(p.shape))
    return buckets


class GradReducer:
    def __init__(self, params, comm_buffer_size=25, last_comm_buffer_size=1,
                 group=None, find_unused_parameters=False):
        self._group = group if group is not None else collective.get_group(0)
        self.buckets = assign_buckets(params, comm_buffer_size,
                                      last_comm_buffer_size)
        self._slot = {}
        for b in self.buckets:
            for i, p in enumerate(b.params):
                self._slot[id(p)] = (b, i)
        self._find_unused = find_unused_parameters
        self.enabled = True
        self._next_bucket = 0
        self._ready = set()
        self._inflight = []        # (bucket, flat buffer, work, staged)
        self._queued = False
        # the last backward's completion and posting orders (bucket
        # indices; tests read them)
        self.completed: list[int] = []
        self.posted: list[int] = []
        self.stats = {"collectives": 0, "bytes": 0}
        self._handles = [p.register_post_accumulate_grad_hook(self._hook)
                         for b in self.buckets for p in b.params]

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    # -- backward side -------------------------------------------------------

    def _hook(self, p):
        if not self.enabled:
            return
        if not self._queued:
            self._queued = True
            self.completed, self.posted = [], []
            Variable._execution_engine.queue_callback(self._finalize)
        b, i = self._slot[id(p)]
        b.filled.add(i)
        if len(b.filled) == len(b.params):
            self._mark_ready(b)

    def _mark_ready(self, b):
        self.completed.append(b.index)
        self._ready.add(b.index)
        while self._next_bucket in self._ready:
            self._ready.discard(self._next_bucket)
            self._post(self.buckets[self._next_bucket])
            self._next_bucket += 1

    def _post(self, b):
        grads = [p.grad if p.grad is not None
                 else torch.zeros(shape, dtype=b.dtype, device=p.device)
                 for p, shape in zip(b.params, b.shapes)]
        flat = torch.cat([g.detach().reshape(-1).to(b.dtype) for g in grads])
        staged = collective._staged(self._group, flat)
        buf = flat.cpu() if staged else flat
        collective._count("all_reduce", buf.numel() * buf.element_size())
        work = dist.all_reduce(buf, group=self._group.pg, async_op=True)
        self._inflight.append((b, buf, work, flat.device))
        self.posted.append(b.index)
        self.stats["collectives"] += 1
        self.stats["bytes"] += buf.numel() * buf.element_size()

    def _finalize(self):
        self._queued = False
        unfinished = [b for b in self.buckets
                      if b.index >= self._next_bucket
                      and len(b.filled) < len(b.params)]
        if unfinished and not self._find_unused:
            names = [f"{tuple(b.shapes[i])}" for b in unfinished
                     for i in range(len(b.params)) if i not in b.filled]
            for _, _, work, _ in self._inflight:
                work.wait()
            self._reset()
            raise RuntimeError(
                f"DataParallel: the backward left {len(names)} parameter(s) "
                f"without a gradient (shapes {names[:5]}). All ranks must "
                f"reduce the same buckets or they deadlock; construct "
                f"DataParallel(find_unused_parameters=True) to zero-fill "
                f"them")
        for b in unfinished:       # missing gradients count as zeros
            b.filled = set(range(len(b.params)))
            self._mark_ready(b)
        try:
            with collective._timed("all_reduce"):
                self._write_back(self._group.nranks)
        finally:
            self._reset()

    def _write_back(self, n):
        """Wait for each bucket's collective and write the averages into
        the gradients."""
        for b, buf, work, dev in self._inflight:
            work.wait()
            avg = buf.to(dev).div_(n)
            off = 0
            for p, size, shape in zip(b.params, b.sizes, b.shapes):
                g = avg[off:off + size].view(shape).to(p.dtype)
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
                off += size

    def _reset(self):
        self._next_bucket = 0
        self._ready.clear()
        self._inflight = []
        for b in self.buckets:
            b.filled = set()
