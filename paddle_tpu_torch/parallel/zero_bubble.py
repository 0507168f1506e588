"""The ZB-H1 zero-bubble pipeline (``paddle_tpu.parallel.zero_bubble``
counterpart; reference: distributed/passes/pipeline_scheduler_pass/
pipeline_zero_bubble.py, Qi et al. 2023).

ZB-H1 splits a microbatch's backward into B (the activation gradient, on
the critical path between stages) and W (the weight gradient, which no
other stage waits for), and lets the W jobs fill 1F1B's drain bubble.
Each pp rank walks its column of ``zb_h1_schedule(S, M)`` tick by tick, on
``parallel.pipeline``'s engine and tick-matched hops.

The split is Paddle's: each linear's gradient is cut into its dX and dW
products (the JAX package cuts its backward jaxprs instead,
``zero_bubble.py:112``). While a stage's forward runs on an F tick, a
deferral sink sits at the ``F.linear`` seam: a product whose weight is a
leaf goes through ``_DeferredLinear``, whose backward (on the B tick)
computes dX at once, the bias gradient too, and queues ``(x, dy)``; the W
tick of that microbatch runs the queued ``dy^T x`` products and adds them
into ``.grad`` in the parameter's dtype, in microbatch order, as
autograd's accumulation would. Nothing is recomputed. Norm weights, the
embedding, the fused head's projection and anything else that is not a
linear keep their gradient in B. bf16 gradients may differ from 1F1B's
in their last bits (another order of the same sums), so ZB-H1 is held to
a rule, not to bit-equality.

JAX's restrictions are kept: remat is rejected (ZB-H1 is zero-recompute
by design, ``zero_bubble.py:202-214``); an mp or sep axis raises here
(``PipelineParallel`` falls back to 1F1B with a warning); a dp or
sharding axis replicates the batch (every data rank runs the whole
batch: correct math, no dp speedup).

With ``zero_axis=`` (JAX ``zero_bubble.py:259-295``) the stage's blocks
persist as this rank's 1/N of each block over the axis. They are
gathered once, at the start of a step, and stay full through every F, B
and W tick, since the B/W split needs stable weights; after the W ticks
their gradients are reduce-scattered into the shards and the full
buffers freed. Every rank of the axis computed the same gradient (the
batch is replicated), so the optimizer's division by the data ranks
turns the reduce-scatter's sum back into it.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from paddle_tpu_torch.parallel.pipeline import PipelinedTrainStep
from paddle_tpu_torch.parallel.pipeline_schedules import zb_h1_schedule
from paddle_tpu_torch.parallel.scan_layers import normalize_remat

__all__ = ["ZBH1PipelinedStep", "WGradSink", "run_zbh1"]


class _DeferredLinear(torch.autograd.Function):
    """y = x W^T + b whose backward returns dX (and db) and queues dW
    against `master`, the leaf parameter `weight` was cast from (under AMP;
    else `weight` itself)."""

    @staticmethod
    def forward(ctx, x, weight, bias, master, sink, mb):
        ctx.save_for_backward(x, weight)
        ctx.master, ctx.sink, ctx.mb = master, sink, mb
        ctx.has_bias = bias is not None
        return torch.nn.functional.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy.matmul(w) if ctx.needs_input_grad[0] else None
        db = None
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.reshape(-1, dy.shape[-1]).sum(0)
        ctx.sink.queue(ctx.mb, ctx.master, x, dy)
        return dx, None, db, None, None, None


class WGradSink:
    """The deferral: ``forward(m)`` installs it at the ``F.linear`` seam for
    microbatch m's stage forward; the backward queues each product's
    ``(w, x, dy)`` under m; ``run_w(m)`` runs them. ``stats`` counts the
    queued products, the ones run on W ticks, and the deferred weights
    whose ``.grad`` a B tick touched (none should be)."""

    def __init__(self):
        self.queues = {}
        self.weights = {}
        self.stats = {"queued": 0, "w_ran": 0, "b_touched": 0,
                      "w_ticks": []}

    @contextmanager
    def forward(self, mb):
        from paddle_tpu_torch.nn import functional as F

        prev = F._WGRAD.sink
        F._WGRAD.sink = _Bound(self, mb)
        try:
            yield
        finally:
            F._WGRAD.sink = prev

    @contextmanager
    def backward(self, mb):
        before = self._versions()
        yield
        self.stats["b_touched"] += sum(
            1 for k, v in self._versions().items() if before.get(k) != v)

    def _versions(self):
        return {id(w): (None if w.grad is None else
                        (id(w.grad), w.grad._version))
                for w in self.weights.values()}

    def queue(self, mb, w, x, dy):
        self.weights[id(w)] = w
        self.queues.setdefault(mb, []).append((w, x, dy))
        self.stats["queued"] += 1

    @torch.no_grad()
    def run_w(self, mb):
        """Microbatch mb's dW products, each cast to its parameter's dtype
        (a bf16 product of an fp32 master lands in fp32, as autograd's
        accumulation through the cast would put it)."""
        for w, x, dy in self.queues.pop(mb, []):
            dw = dy.reshape(-1, dy.shape[-1]).t().matmul(
                x.reshape(-1, x.shape[-1])).to(w.dtype)
            if w.grad is None:
                w.grad = dw
            else:
                w.grad.add_(dw)
            self.stats["w_ran"] += 1
        self.stats["w_ticks"].append(mb)


class _Bound:
    """The sink bound to one microbatch, as the seam calls it."""

    __slots__ = ("sink", "mb")

    def __init__(self, sink, mb):
        self.sink, self.mb = sink, mb

    def linear(self, x, weight, bias, master):
        return _DeferredLinear.apply(x, weight, bias, master, self.sink,
                                     self.mb)


def run_zbh1(engine, sched, ids, labels, extras=None, loss_scale=1.0):
    """One step's forward and backward on `engine` by the ZB-H1 table
    `sched`, the linears' dW deferred to the W ticks; the gradients land
    in ``.grad``. Returns (loss, the sink's stats)."""
    sink = WGradSink()
    engine.sink = sink
    try:
        loss = engine.forward_backward(ids, labels, extras, loss_scale,
                                       schedule=sched)
    finally:
        engine.sink = None
    if sink.queues:
        raise RuntimeError(f"ZB-H1: dW products of microbatches "
                           f"{sorted(sink.queues)} never ran")
    return loss, sink.stats


class ZBH1PipelinedStep(PipelinedTrainStep):
    """ZB-H1 for (embed, blocks, head) models on a rank mesh with a "pp"
    axis (and, replicating, dp): ``PipelinedTrainStep`` with V = 1, no
    remat, every data rank on the whole batch, and each step run by
    ``run_zbh1``. Stage-local as there: `blocks` are this rank's blocks;
    `embed_layer` is used on stage 0 and `head_layer` on the last.

    ``run(ids, labels)`` -> (loss, (embed_grads, block_grads,
    head_grads)): this rank's gradients (``block_grads[i]`` the i-th local
    block's, in parameter order; embed on stage 0 and head on the last
    stage, else empty), left in ``.grad`` as well; ``step(ids, labels)``
    (``__call__``) adds the optimizer update. `seed` and `debug` are
    accepted (JAX's dropout key and its per-tick tensor dump); the sink's
    per-step counts are ``last_stats``."""

    _replicate = True

    def __init__(self, embed_layer, blocks, head_layer, loss_fn, mesh=None,
                 num_micro: int = 2, seed: int = 0, optimizer=None,
                 debug: bool = False, remat=False, zero_axis=None,
                 fp8_policy=None):
        from paddle_tpu_torch.distributed.mesh import get_mesh

        policy = normalize_remat(remat)
        if policy != "none":
            raise ValueError(
                f"ZBH1PipelinedStep is zero-recompute by design; remat "
                f"policy {policy!r} is not applicable (use "
                f"PipelinedTrainStep for selective rematerialization)")
        mesh = mesh if mesh is not None else get_mesh()
        breaking = [a for a in ("mp", "sep")
                    if mesh is not None and mesh.shape.get(a, 1) > 1]
        if breaking:
            raise ValueError(f"ZB-H1 runs pp (+ replicated dp, sharding) "
                             f"meshes only; axes {breaking} are active (use "
                             f"1F1B)")
        super().__init__(embed_layer, blocks, head_layer, loss_fn,
                         optimizer=optimizer, mesh=mesh, num_micro=num_micro,
                         remat="none", seed=seed, zero_axis=zero_axis,
                         fp8_policy=fp8_policy)
        self.sched = zb_h1_schedule(self.S, self.M)
        self.T = len(self.sched["ticks"])
        self.last_stats = None

    def _forward_backward(self, ids, labels, extras):
        if self.sharder is not None:
            self.sharder.begin()      # the stage's blocks, full, once
        loss, self.last_stats = run_zbh1(self.engine, self.sched, ids,
                                         labels, extras)
        if self.sharder is not None:
            self.sharder.finish()     # reduce-scattered, freed
        return loss

    def run(self, ids, labels, *, segment_ids=None, position_ids=None):
        """With a zero axis a block's entry is its unit's shard gradients
        (the group's sum, one a dtype)."""
        loss = self._run(ids, labels, segment_ids, position_ids)

        def grads(mod):
            if self.sharder is not None and mod in self.blocks:
                return [b.shard.grad
                        for b in self.sharder.unit_of(mod).buckets]
            return [p.grad for p in mod.parameters()]

        return loss, (grads(self.embed) if self.stage == 0 else [],
                      [grads(b) for b in self.blocks],
                      grads(self.head) if self.stage == self.S - 1 else [])
