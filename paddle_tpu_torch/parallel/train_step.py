"""The single-device training step (``paddle_tpu.parallel.train_step``
counterpart): ``TrainStep`` runs forward, loss, backward, gradient clip and
the optimizer update, eagerly, on the model's device.

Where ``CompiledTrainStep`` traces one XLA program, the port runs PyTorch
eagerly: the hand-written kernels launch from the model's forward and from
autograd's backward (flash dq/dkv, the fused head loss), cuBLAS takes the
projections. CUDA graphs over the step, remat, GradScaler and the meshes
of ``CompiledTrainStep`` are later work. Unlike ``CompiledTrainStep``,
whose compiled update never applies ``optimizer._grad_clip``, the port
applies it, as ``apply_optimizer_update`` and the eager ``AdamW.step`` do.
For a model with MoE layers, ``collect_metrics`` also keeps the summed
load-balance aux loss and dropped-token count (``moe_aux``,
``moe_dropped``), as ``CompiledTrainStep``'s step telemetry does.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.nn.clip import global_norm

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer)``; ``step(*batch)``
    or ``step(batch_dict)`` runs one step and returns the loss (a detached
    device scalar: reading it is the host sync).

    Batches are ``(*inputs, labels)``, called as ``model(*inputs)`` with
    ``loss_fn(out, labels)``, or one dict whose every entry is a model
    keyword (``input_ids``, ``labels``, ``segment_ids``, ``position_ids``),
    called as ``model(**batch)`` with ``loss_fn(out, batch["labels"])``; a
    model that computes its loss from ``labels`` (the fused head loss) pairs
    with ``loss_fn=lambda out, labels: out``. numpy arrays are moved to the
    model's device. ``collect_metrics`` keeps the step's loss and the
    global norm of the gradients before the clip, plus ``moe_aux`` and
    ``moe_dropped`` summed over the model's ``MoELayer``s when it has any;
    ``last_metrics()`` reads them (a host sync at read time only)."""

    def __init__(self, model, loss_fn, optimizer=None,
                 collect_metrics: bool = False):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.collect_metrics = collect_metrics
        self.device = next(model.parameters()).device
        self._steps = 0           # the step count when there is no optimizer
        self._metrics = None
        self._moe_layers = ([m for m in model.modules()
                             if isinstance(m, MoELayer)]
                            if collect_metrics else [])

    def _place(self, value):
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if isinstance(value, torch.Tensor):
            return value.to(self.device, non_blocking=True)
        return value

    def __call__(self, *batch):
        named = len(batch) == 1 and isinstance(batch[0], dict)
        if named and "labels" not in batch[0]:
            raise ValueError(
                "a dict batch must carry a 'labels' entry (it feeds both the "
                f"model and loss_fn); got keys {sorted(batch[0])}")
        self.model.train()
        if self.optimizer is not None:
            self.optimizer.clear_grad()
        if named:
            kwargs = {k: self._place(v) for k, v in batch[0].items()}
            out = self.model(**kwargs)
            labels = kwargs["labels"]
        else:
            args = [self._place(v) for v in batch]
            out = self.model(*args[:-1])
            labels = args[-1]
        loss = self.loss_fn(out, labels)
        moe = self._moe_stats()
        loss.backward()
        if self.collect_metrics:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            self._metrics = {"loss": loss.detach(),
                             "grad_norm": global_norm(grads), **moe}
        if self.optimizer is not None:
            self.optimizer.step()
            step = self.optimizer._step_count
        else:
            self._steps += 1
            step = self._steps
        if self.collect_metrics:
            self._metrics["step"] = step
        return loss.detach()

    def _moe_stats(self) -> dict:
        """{moe_aux, moe_dropped}: this forward's stats summed over the MoE
        layers, as device scalars (no host sync)."""
        if not self._moe_layers:
            return {}
        aux = sum(m.l_aux.detach().float() for m in self._moe_layers)
        dropped = sum(m.tokens_dropped.detach().float()
                      for m in self._moe_layers)
        return {"moe_aux": aux, "moe_dropped": dropped}

    def last_metrics(self) -> dict | None:
        """{step, loss, grad_norm[, moe_aux, moe_dropped]} of the last step as Python numbers, or
        None before the first step or with ``collect_metrics`` off.
        ``step`` is the optimizer's own step count (the one its bias
        correction uses), or the steps this object took without one."""
        if self._metrics is None:
            return None
        return {k: (float(v) if isinstance(v, torch.Tensor) else v)
                for k, v in self._metrics.items()}
