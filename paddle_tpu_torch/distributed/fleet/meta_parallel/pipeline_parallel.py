"""``PipelineParallel``, Fleet's pipeline wrapper
(``paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel``
counterpart; reference: fleet/meta_parallel/pipeline_parallel.py,
``PipelineParallel`` :149, ``train_batch`` :697,
``forward_backward_pipeline`` :459).

``fleet.distributed_model(PipelineLayer(...))`` returns it when the hcg's
pp degree is above 1. It runs the ``PipelineLayer``'s parts on this rank
through ``parallel.pipeline``'s engine: ``pipeline_configs
["schedule_mode"]`` picks 1F1B (the interleaved VPP forward with its
mirror backward when the layer has ``num_virtual_pipeline_stages`` > 1)
or ZB-H1 (``parallel.zero_bubble``'s W-gradient deferral), over
``accumulate_steps`` microbatches of the global batch. ZB-H1 with an mp
axis falls back to 1F1B with a warning, and replicates the batch over dp,
as the JAX package does (``pipeline_parallel.py:128-150``). A sep axis
above 1 raises (ROADMAP A8): nothing here splits the sequence.

``train_batch(data, optimizer, lr_scheduler, scaler)``: forward and
backward, the shared-weight gradient sum, then the optimizer (a
``HybridParallelOptimizer``: dp averaging, the hybrid clip with the
pp-summed norm). With a ``GradScaler`` the last stage's loss is scaled
before its backward, every rank unscales its gradients, and the found-inf
flag is agreed over all ranks before the step is taken or skipped.

One deliberate difference (``ROADMAP.md`` C): the JAX class degrades to
eager gradient accumulation when building its compiled step throws
(``pipeline_parallel.py:183-188``); the port runs its one schedule
runtime and lets errors raise.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers.\
    pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]


class PipelineParallel:
    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        from paddle_tpu_torch.parallel.pipeline import (PipelineEngine,
                                                        StagePart,
                                                        sync_replicas)
        from paddle_tpu_torch.parallel.pipeline_schedules import (
            zb_h1_schedule)

        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        if hcg.get_sep_parallel_world_size() > 1:
            raise NotImplementedError("sequence parallelism (sep > 1) under "
                                      "pp is not ported yet (ROADMAP A8)")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage_id = hcg.get_stage_id()
        self.total_loss = None
        mode = str(cfg.get("schedule_mode", "1F1B")).upper().replace("-", "")
        V = layers._num_virtual_pipeline_stages
        if mode == "ZBH1":
            breaking = [n for n, d in (
                ("mp", hcg.get_model_parallel_world_size()),
                ("sep", hcg.get_sep_parallel_world_size()),
                ("sharding", hcg.get_sharding_parallel_world_size()))
                if d > 1]
            if breaking or V > 1:
                warnings.warn(
                    f"schedule_mode=ZB-H1 supports pp (+ replicated dp) "
                    f"without virtual stages only; "
                    f"{breaking or ['virtual_pp']} active: using 1F1B")
                mode = "1F1B"
            elif hcg.get_data_parallel_world_size() > 1:
                warnings.warn(
                    "schedule_mode=ZB-H1 replicates the batch over dp "
                    "(correct math, no data-parallel speedup); use 1F1B "
                    "for dp scaling")
        self.schedule_mode = mode
        S = self.num_stages
        last_pos = S * V - 1
        remat = getattr(layers, "remat_policy", None) or "none"
        parts = [StagePart(p, [fn for _, fn in items],
                           [layers.is_block(i) for i, _ in items],
                           p == 0, p == last_pos)
                 for p, items in layers.parts()]
        self._engine = PipelineEngine(
            parts, layers._loss_fn, hcg, self.accumulate_steps,
            remat=remat if mode != "ZBH1" else "none",
            replicate=mode == "ZBH1", device=layers.device)
        self._zb_sched = (zb_h1_schedule(S, self.accumulate_steps)
                          if mode == "ZBH1" else None)
        self.last_zb_stats = None
        sync_replicas([layers], hcg)

    # ---- passthrough --------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def parameters(self):
        return self._layers.parameters()

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    load_state_dict = set_state_dict

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self

    # ---- scheduling ---------------------------------------------------------
    @staticmethod
    def _split(data):
        if isinstance(data, dict):
            ex = {k: data[k] for k in ("segment_ids", "position_ids")
                  if data.get(k) is not None}
            return data["input_ids"], data["labels"], ex
        x, y = data[0], data[1]
        return x, y, {}

    @staticmethod
    def _tensor(v):
        if hasattr(v, "_value") and not isinstance(v, (np.ndarray,
                                                       torch.Tensor)):
            v = v._value
        return v

    def forward_backward_pipeline(self, data, scaler=None):
        """This step's schedule (gradients accumulate in ``.grad``, the
        shared weights' summed over their stages); returns the loss, the
        same on every rank."""
        x, y, ex = self._split(data)
        x, y = self._tensor(x), self._tensor(y)
        scale = float(scaler._scale) if scaler is not None \
            and scaler.is_enable() else 1.0
        if self.schedule_mode == "ZBH1":
            from paddle_tpu_torch.parallel.zero_bubble import run_zbh1

            loss, self.last_zb_stats = run_zbh1(self._engine, self._zb_sched,
                                                x, y, ex, scale)
        else:
            if ex and self._layers._num_virtual_pipeline_stages > 1:
                raise ValueError("interleaved virtual-pp does not support "
                                 "packed-batch segment/position ids yet")
            loss = self._engine.forward_backward(x, y, ex, scale)
        self._layers.allreduce_shared_weight_gradients()
        self.total_loss = loss
        return loss

    @torch.no_grad()
    def _unscale_found_inf(self, optimizer, scaler) -> bool:
        """Unscale this rank's gradients; True when any rank holds a
        non-finite one (agreed over the world)."""
        from paddle_tpu_torch.distributed import collective
        from paddle_tpu_torch.distributed.env import get_world_size

        inv = 1.0 / float(scaler._scale)
        bad = torch.zeros((), dtype=torch.float32,
                          device=self._engine.device)
        for p in self._layers.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
                bad = torch.maximum(bad, (~torch.isfinite(p.grad).all())
                                    .float())
        if get_world_size() > 1:
            collective.all_reduce(bad, collective.ReduceOp.MAX)
        return bool(bad.item())

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """reference pipeline_parallel.py:697: one global batch (`data` is
        ``[ids, labels]`` or a dict with ``input_ids``, ``labels`` and the
        packed ids), ``accumulate_steps`` microbatches, one update."""
        self._layers.train()
        optimizer.clear_grad()
        if scaler is not None and not scaler.is_enable():
            scaler = None
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None:
            found = self._unscale_found_inf(optimizer, scaler)
            scaler._found_inf = found
            if found:
                # a skipped step still counts, as ``TrainStep``'s does
                base = getattr(optimizer, "_base_opt", optimizer)
                base._step_count += 1
            else:
                optimizer.step()
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forward of every microbatch through the stages; the mean
        loss (the same on every rank). Without `compute_loss` the last
        stage's loss is still what comes back: the head runs with the
        loss on the last stage."""
        self._layers.eval()
        x, y, ex = self._split(data)
        return self._engine.forward_backward(
            self._tensor(x), self._tensor(y), ex, train=False)
