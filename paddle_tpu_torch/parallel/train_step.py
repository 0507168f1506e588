"""The single-device training step (``paddle_tpu.parallel.train_step``
counterpart): ``TrainStep`` runs forward, loss, backward, gradient clip and
the optimizer update, eagerly, on the model's device.

Where ``CompiledTrainStep`` traces one XLA program, the port runs PyTorch
eagerly: the hand-written kernels launch from the model's forward and from
autograd's backward (flash dq/dkv, the fused head loss), cuBLAS takes the
projections. The arguments of ``CompiledTrainStep`` it takes mean what
they mean there (``paddle_tpu/parallel/train_step.py:360-424``):

* ``remat``: a policy of ``scan_layers.REMAT_POLICIES`` (or a bool; None
  reads the model's ``remat_policy`` attribute, which fleet's recompute
  pass sets, else the ``remat_policy`` flag), applied per decoder layer
  by a ``layer_remat_capable`` model;
* ``scan_layers``: accepted (None reads the flag); the layers run
  unrolled;
* ``fp8_policy``: ``none|matmuls|matmuls+head`` (None reads the flag),
  delayed scaling with one amax-history set per ``F.linear`` callsite,
  created on the first call in call order; ``fp8_state_dict()`` and
  ``load_fp8_state()`` use the JAX package's layout;
* ``grad_scaler``: an ``amp.GradScaler``: the loss is scaled before the
  backward, the gradients unscaled in fp32, and a non-finite gradient
  skips the update of the parameters AND the moments (the step count
  still advances, as there) and keeps the old amax histories. The port
  reads the step's found-inf flag on the host once, where the JAX package
  settles it lazily, and advances the scaler at once: the scale sequence
  is JAX's after ``drain()``;
* ``metrics_every``/``dispatch_window`` (None read
  ``metrics_sync_every``/``async_dispatch_window``): ``step_async``
  returns a ``LossFuture`` and blocks on every k-th; at most `window`
  steps are in flight.

Hybrid parallelism, one process a rank: ``TrainStep`` takes a model and
optimizer that ``fleet.distributed_model``/``distributed_optimizer``
wrapped (local batches, the local loss), or ``mesh=`` (the port's rank
mesh, ``distributed.mesh.build_mesh``), ``zero_axis=``, ``zero_stage=``
and ``zero3_gather=`` as ``CompiledTrainStep`` takes them
(``paddle_tpu/parallel/train_step.py:425-443``), on the same machinery:
the hcg of the mesh's axes, ``distributed_model`` and a
``HybridParallelOptimizer`` with ZeRO-1, 2 or 3 over `zero_axis`
("sharding", or "dp" taken as the sharding axis; an axis the mesh lacks
warns and turns ZeRO off, as there). At ``zero_stage=3`` the model is a
``GroupShardedStage3``: each rank keeps 1/N of every unit's parameters,
the decoder layers run through the gather-ahead ZeRO-3 loop
(``zero3_gather`` "ahead" or "start", None reads the flag), and the
interior remat policies and fp8 raise, as in JAX. With ``mesh=`` a batch
is the global one, as there: each rank takes its block of rows along
the data axes (dp-major over dp x sharding) and the step returns the
mean of the data ranks' losses, the global loss when every rank holds as
many tokens. An "ep" axis (expert parallelism, for a model whose MoE
layers were built under the mesh) is a data axis too: the rows split
over dp x sharding x ep, dp-major, the model is a ``TensorParallel`` and
the hybrid optimizer averages each replicated parameter's gradient over
dp x ep and each expert block's over dp, divided by dp x ep (the owner's
gradient already sums its ep group's contributions through the
all-to-all's backward), so the ranks' gradients are the global mean
loss's; ZeRO-1/2 over "dp" shards the optimizer state over the dp group
of each ep coordinate. ep beside mp, pp or sep, and ZeRO-3 with ep,
raise (ROADMAP A8). JAX's ``CompiledTrainStep`` splits the batch over
dp only and the tokens over (dp, ep) inside the MoE layer, which agrees
token for token when the rows divide over dp x ep. A "sep" axis
(sequence parallelism) splits the SEQUENCE of every ``[B, S]`` batch
entry (dim 1: input ids, labels, segment and position ids) into
contiguous segments, rank r of the sep group taking segment r, as
``CompiledTrainStep`` shards dim 1 over "sep"; a length that does not
divide raises. The step publishes the sep group around the forward and
backward (``parallel.segments.sep_execution``): the LLaMA attention runs
ring attention over it, its RoPE positions are the segment's global
ones, and its criterion returns the rank's share of the rows' mean loss.
The model is a ``SegmentParallel`` (a ``TensorParallel`` beside mp), the
hybrid optimizer sums the gradients over dp x sep and divides by dp (the
sep sum before ZeRO-1/2's reduce-scatter), and the step returns the sum
of the sep ranks' losses averaged over the data ranks. Only a model
that declares ``supports_sep`` (``LlamaForCausalLM``) takes a sep axis,
and only with its own criterion's loss (the share it records, checked
at each step): any other model attends within its segment and means its
own tokens, so it raises, as do sep beside pp or ep and ZeRO-3 with sep
(ROADMAP A8). A pipeline axis in the mesh
(without sep) replicates the step over its ranks, as
``CompiledTrainStep`` does over such a mesh; pipelining is
``parallel.pipeline.PipelinedTrainStep``'s. A ``grad_scaler`` under a
fleet optimizer and fp8 or LoRA under mp > 1 raise (ROADMAP A8).
``last_metrics()``'s ``grad_norm`` is then the hybrid global norm
(``HybridParallelClipGrad``'s).

``anomaly_detector`` (an ``AnomalyDetector``, True for a flag-built one,
None reads the ``anomaly_detection`` flag, False is off): the step
computes a health flag on the device (a non-finite loss or gradient; with
a ``grad_scaler`` its found-inf flag) and an unhealthy step skips the
whole update (parameters, moments and fp8 histories keep their values,
the step count advances), as ``CompiledTrainStep`` does in its program.
The port reads the flag on the host once a step (all-reduced over the
ranks first, so every rank skips alike) and feeds the detector at once,
where the JAX package settles it lazily: ``settle_anomalies`` has nothing
left to settle. The ``step.grads`` fault point poisons a step as JAX's
does: the first floating batch entry times NaN, or, for token-only
batches, a NaN learning rate (the parameters are then poisoned and the
NEXT step's loss is non-finite). A dynamic GradScaler raises an unset
detector tolerance to 2, as there.

Elastic checkpoints (``distributed.checkpoint.elastic``):
``named_train_state()`` gives the training state under the JAX package's
names and layout (``model/<name>``, ``opt/<name>/<slot>`` keyed by the
parameter's name, ``fp8/<i>`` with ``fp8_layout``, the scaler in meta;
each rank's part at its global offset), and ``load_resume_extras``
restores what the model and optimizer do not hold: the step count, fp8
histories (a scanned JAX layout is unstacked), the GradScaler. The port's
step draws no random numbers: a ``rng/key`` that a JAX snapshot carries is
kept as it is and saved again, so a JAX snapshot round-trips.

A Paddle-API ``Layer`` (``models.gpt``, users' nets) trains as a torch
model does: the step wraps it in a ``PaddleLayerModule``, calls it and
the loss on ``Tensor``s, and backpropagates the loss's torch value.
``local_batch=True`` takes each batch as this data rank's rows already
(a loader that ``auto_parallel.shard_dataloader`` cut), so ``mesh=``
cuts nothing.

CUDA graphs over the step are later work. Unlike ``CompiledTrainStep``,
whose compiled update never applies ``optimizer._grad_clip``, the port
applies it, as ``apply_optimizer_update`` and the eager ``AdamW.step`` do.
With ``collect_metrics`` the step keeps its loss, the global norm of the
gradients (after the unscale, before the clip), ``skipped``, with fp8
``fp8_amax_max`` (the largest amax-history entry), and for a model with
MoE layers the summed load-balance aux loss and dropped-token count
(``moe_aux``, ``moe_dropped``), as ``CompiledTrainStep``'s step telemetry
does.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from paddle_tpu_torch.amp import fp8 as _fp8
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.io.device_feed import (DispatchWindow, LossFuture,
                                             step_event)
from paddle_tpu_torch.nn.clip import global_norm
from paddle_tpu_torch.parallel.scan_layers import (layer_execution,
                                                   normalize_remat)
from paddle_tpu_torch.parallel.segments import sep_execution, sep_loss

__all__ = ["TrainStep", "PaddleLayerModule"]

faults.register(
    "step.grads",
    "poison one training step (fire_check site in TrainStep): NaN-scales "
    "the first floating batch entry (NaN gradients: the health check "
    "catches it the SAME step and skips the update) or, for token-only "
    "batches, the learning rate (parameters poisoned: caught on the NEXT "
    "step's non-finite loss; only a rollback recovers)")


def _nan_poison(kwargs, args):
    """The ``step.grads`` chaos: the first floating batch entry (a dict
    batch's in sorted key order) times NaN. False when there is none."""
    if kwargs is not None:
        for k in sorted(kwargs):
            v = kwargs[k]
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                kwargs[k] = v * float("nan")
                return True
        return False
    for i, v in enumerate(args):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            args[i] = v * float("nan")
            return True
    return False


class PaddleLayerModule(torch.nn.Module):
    """A Paddle-API ``Layer`` seen as a ``torch.nn.Module``, so the step,
    ``DataParallel`` and the hybrid optimizer take it as they take a torch
    model. Each parameter's torch leaf becomes an ``nn.Parameter`` over
    the same storage, registered here (dots in names as ``__``) and set
    back as the ``Parameter``'s ``_value``, which the port's optimizers
    read at every step. ``forward`` wraps torch tensors as ``Tensor``s
    and returns what the layer returns."""

    def __init__(self, layer):
        super().__init__()
        self.__dict__["layer"] = layer
        for name, p in layer.named_parameters():
            leaf = p._value
            if not isinstance(leaf, torch.nn.Parameter):
                leaf = torch.nn.Parameter(leaf.detach(),
                                          requires_grad=leaf.requires_grad)
                p._value = leaf
            self.register_parameter(name.replace(".", "__"), leaf)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode:
            self.layer.train()
        else:
            self.layer.eval()
        return self

    @staticmethod
    def tensor(v):
        """`v` as the layer's API takes it: a torch tensor as a
        ``Tensor``."""
        from paddle_tpu_torch.core.tensor import Tensor

        return Tensor(v) if isinstance(v, torch.Tensor) else v

    def forward(self, *args, **kwargs):
        return self.layer(*[self.tensor(a) for a in args],
                          **{k: self.tensor(v) for k, v in kwargs.items()})


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
                 collect_metrics: bool = False, remat=None,
                 scan_layers=None, fp8_policy=None, grad_scaler=None,
                 metrics_every: int | None = None,
                 dispatch_window: int | None = None,
                 anomaly_detector=None, mesh=None, zero_axis=None,
                 zero_stage: int = 1, zero3_gather=None,
                 local_batch: bool = False):
        from paddle_tpu_torch.nn.layer.layers import Layer

        if isinstance(model, Layer):
            model = PaddleLayerModule(model)
        self._paddle = isinstance(model, PaddleLayerModule)
        self.local_batch = bool(local_batch)
        self._data_group = None
        self._sep_group = None
        self._loss_group = None
        self._zero3 = None
        if remat is None:
            remat = getattr(model, "remat_policy", None)
        self.remat_policy = normalize_remat(
            flag("remat_policy") if remat is None else remat)
        self.fp8_policy = _fp8.normalize_fp8_policy(
            flag("fp8_policy") if fp8_policy is None else fp8_policy)
        if mesh is not None or zero_axis is not None:
            model, optimizer = self._fleet_wrap(model, optimizer, mesh,
                                                zero_axis, zero_stage,
                                                zero3_gather)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._hybrid = hasattr(optimizer, "last_grad_norm")
        if self._hybrid and grad_scaler is not None \
                and grad_scaler.is_enable():
            raise NotImplementedError("a grad_scaler under a fleet "
                                      "optimizer is not ported yet (ROADMAP "
                                      "A8)")
        self.collect_metrics = collect_metrics
        self.device = next(model.parameters()).device
        self._layer_capable = bool(getattr(model, "layer_remat_capable",
                                           False))
        if self.remat_policy != "none" and not self._layer_capable:
            raise ValueError(
                f"remat={self.remat_policy!r} needs a layer_remat_capable "
                f"model (its layer loop applies the policy); GPT-MoE's "
                f"remat is later work (ROADMAP A5)")
        self.scan_layers = self._layer_capable and bool(
            flag("scan_layers") if scan_layers is None else scan_layers)
        self._fp8_hist_len = int(flag("fp8_amax_history_len"))
        self._fp8_states = None   # discovered by the first call
        self._scaler = (grad_scaler if grad_scaler is not None
                        and grad_scaler.is_enable() else None)
        self.metrics_every = int(flag("metrics_sync_every")
                                 if metrics_every is None else metrics_every)
        self._async_count = 0
        self._window = DispatchWindow(dispatch_window)
        self._steps = 0           # the step count when there is no optimizer
        self._metrics = None
        self._prev_wall = None
        self._moe_layers = ([m for m in model.modules()
                             if isinstance(m, MoELayer)]
                            if collect_metrics else [])
        self._anomaly_det = self._detector(anomaly_detector)
        self._rng_key = None      # a JAX snapshot's key, carried as it is

    def _detector(self, det):
        """None reads the flag, True builds a flag-configured detector,
        False is off, a detector is used as it is; a dynamic GradScaler
        raises an unset tolerance to 2 (its growth-interval overflows are
        expected)."""
        from paddle_tpu_torch.distributed.resilience.anomaly import (
            AnomalyDetector)

        if det is None:
            det = bool(flag("anomaly_detection"))
        if det is True:
            det = AnomalyDetector()
        if not isinstance(det, AnomalyDetector):
            return None
        if (self._scaler is not None and getattr(self._scaler, "_dynamic",
                                                 True)
                and not det.tolerance_explicit
                and det.nonfinite_tolerance == 0):
            det.nonfinite_tolerance = 2
        return det

    def _check_zero3(self, mode):
        """JAX's refusals of ZeRO-3 (``train_step.py:634-654``), before
        anything is sharded."""
        from paddle_tpu_torch.parallel.scan_layers import ScanShardInfo

        ScanShardInfo(None, mode)           # an unknown gather mode raises
        if self.remat_policy not in ("none", "full"):
            raise ValueError(
                f"zero_stage=3 sharded-weights scan re-gathers and "
                f"recomputes each layer in backward (its own 'full'-grade "
                f"schedule); remat policy {self.remat_policy!r} cannot "
                f"apply to the sharded stack - use remat='none'/'full', or "
                f"zero_stage<=2.")
        if self.fp8_policy != "none":
            raise ValueError(
                "fp8_policy cannot compose with the zero_stage=3 "
                "sharded-weights scan: its layer loop owns the layers' "
                "residuals and cotangents and cannot thread the "
                "delayed-scaling amax state. Use zero_stage<=2 "
                "(optimizer-state sharding) with fp8_policy, or "
                "fp8_policy='none' with zero_stage=3.")

    def _fleet_wrap(self, model, optimizer, mesh, zero_axis, zero_stage,
                    zero3_gather):
        """The hcg of `mesh`'s axes (ZeRO over `zero_axis`), the model
        through ``distributed_model`` and the optimizer through
        ``distributed_optimizer`` unless they are wrapped already; at
        ZeRO-3 the model is a ``GroupShardedStage3`` over the sharding
        group instead."""
        import warnings

        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
            hybrid_parallel_optimizer import HybridParallelOptimizer
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            TensorParallel)
        from paddle_tpu_torch.distributed.mesh import get_mesh
        from paddle_tpu_torch.distributed.parallel import DataParallel

        mesh = mesh if mesh is not None else get_mesh()
        if mesh is None:
            raise ValueError("zero_axis needs a rank mesh (mesh= or "
                             "distributed.mesh.build_mesh)")
        pp = mesh.shape.get("pp", 1)
        if zero_stage not in (1, 2, 3):
            raise ValueError(f"zero_stage={zero_stage}: expected 1, 2 or 3")
        if zero_axis is not None and zero_axis not in mesh.shape:
            # a typo'd axis must not silently train replicated at N x the
            # provisioned parameter memory
            warnings.warn(f"zero_axis={zero_axis!r} is not a mesh axis "
                          f"({tuple(mesh.shape)}); ZeRO sharding is OFF")
            zero_axis = None
        deg = {a: mesh.shape.get(a, 1) for a in ("dp", "sharding", "sep",
                                                 "mp")}
        ep = mesh.shape.get("ep", 1)
        if ep > 1:
            self._check_expert_parallel(model, mesh, pp, deg)
        if deg["sep"] > 1:
            self._check_sep(model, pp, zero_axis, zero_stage)
        if zero_axis not in (None, "dp", "sharding"):
            raise ValueError(f"zero_axis {zero_axis!r} names no data axis of "
                             f"the mesh {mesh.shape}")
        if zero_axis == "dp" and deg["sharding"] == 1:
            # ZeRO over the data axis: the same ranks as a sharding axis
            deg["sharding"], deg["dp"] = deg["dp"], 1
        zero3 = (zero_stage == 3 and zero_axis is not None
                 and deg["sharding"] > 1)
        if zero3 and ep > 1:
            raise NotImplementedError("ZeRO-3 under expert parallelism is not "
                                      "ported yet (ROADMAP A8); ep composes "
                                      "with ZeRO-1/2")
        if zero3:
            mode = str(flag("zero3_gather") if zero3_gather is None
                       else zero3_gather)
            self._check_zero3(mode)
            if isinstance(model, DataParallel):
                raise ValueError("ZeRO-3 reduces the gradients itself; pass "
                                 "the model unwrapped, not a DataParallel")
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {
            "dp_degree": deg["dp"], "mp_degree": deg["mp"],
            "pp_degree": pp, "sharding_degree": deg["sharding"],
            "sep_degree": deg["sep"], "ep_degree": ep}
        strategy.sharding_configs = {"stage": 3 if zero3 else
                                     min(int(zero_stage), 2)}
        hcg = fleet.init(strategy=strategy)
        # a pp axis: the pp ranks replicate the whole step, as
        # CompiledTrainStep's over such a mesh (pipelining is
        # PipelinedTrainStep's), so the global norm sums nothing over pp
        if zero3:
            from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding \
                import GroupShardedStage3

            if not isinstance(model, TensorParallel):
                model = TensorParallel(model, hcg, strategy)
            model = GroupShardedStage3(
                model, group=hcg.get_sharding_parallel_group(),
                pretrain_sync_models=False, zero3_gather=mode)
            self._zero3 = model.sharder
        elif (pp > 1 or ep > 1) and not isinstance(model, (DataParallel,
                                                            TensorParallel)):
            # ep: the optimizer averages at its step, the experts apart
            model = TensorParallel(model, hcg, strategy)
        elif not isinstance(model, (DataParallel, TensorParallel)):
            model = fleet.distributed_model(model)
        if optimizer is not None and not hasattr(optimizer,
                                                 "last_grad_norm"):
            optimizer = HybridParallelOptimizer(optimizer, hcg, strategy,
                                                sum_pp=False)
        # dp-major over dp x sharding (x ep): the fused group's member
        # order
        self._data_group = hcg.get_dp_sharding_ep_parallel_group()
        if deg["sep"] > 1:
            # the sep ranks hold segments of the data rank's rows: the loss
            # sums over them, then averages over the data ranks
            self._sep_group = hcg.get_sep_parallel_group()
            self._loss_group = hcg.get_dp_sharding_sep_parallel_group()
        return model, optimizer

    @staticmethod
    def _check_sep(model, pp, zero_axis, zero_stage):
        """What sequence parallelism composes with (dp, sharding with
        ZeRO-1/2, mp), and the models it takes."""
        from paddle_tpu_torch.distributed.fleet.meta_parallel.\
            segment_parallel import check_supports_sep
        from paddle_tpu_torch.distributed.parallel import DataParallel

        check_supports_sep(model)
        if pp > 1:
            raise NotImplementedError("sequence parallelism (sep > 1) beside "
                                      "pp is not ported yet (ROADMAP A8)")
        if zero_stage == 3 and zero_axis is not None:
            raise NotImplementedError("ZeRO-3 with sequence parallelism (sep "
                                      "> 1) is not ported yet (ROADMAP A8); "
                                      "sep composes with ZeRO-1/2")
        if isinstance(model, DataParallel):
            raise ValueError("under sequence parallelism the optimizer sums "
                             "the gradients over dp x sep; pass the model "
                             "unwrapped, not a DataParallel")

    @staticmethod
    def _check_expert_parallel(model, mesh, pp, deg):
        """What expert parallelism composes with (dp, sharding; ZeRO-1/2),
        and MoE layers built under this mesh's ep axis."""
        from paddle_tpu_torch.distributed.parallel import DataParallel

        beside = {a: n for a, n in (("mp", deg["mp"]), ("pp", pp),
                                    ("sep", deg["sep"])) if n > 1}
        if beside:
            raise NotImplementedError(
                f"expert parallelism beside {beside} is not ported yet "
                f"(ROADMAP A8): ep composes with dp and sharding")
        if isinstance(model, DataParallel):
            raise ValueError("under expert parallelism the optimizer "
                             "averages the gradients (the experts apart); "
                             "pass the model unwrapped, not a DataParallel")
        ranks = tuple(mesh.group("ep").ranks)
        for m in model.modules():
            if isinstance(m, MoELayer) and (
                    m.ep_degree != mesh.shape["ep"]
                    or tuple(m._ep_group.ranks) != ranks):
                raise ValueError(
                    f"an MoE layer holds ep block {m.ep_rank} of "
                    f"{m.ep_degree}, the mesh's ep axis is {mesh.shape['ep']} "
                    f"over ranks {ranks}: build the model after build_mesh")

    def _local_rows(self, value):
        """This data rank's block of rows (dim 0) of a global batch entry."""
        g = self._data_group
        if g is None or g.nranks == 1 or not hasattr(value, "shape") \
                or self.local_batch:
            return value
        n = value.shape[0]
        if n % g.nranks:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {g.nranks} data ranks (dp x sharding x "
                             f"ep)")
        k = n // g.nranks
        return value[g.rank * k:(g.rank + 1) * k]

    def _local_segment(self, value):
        """This sep rank's contiguous segment of the sequence (dim 1) of a
        [B, S, ...] batch entry."""
        g = self._sep_group
        if g is None or value.dim() < 2:
            return value
        s = value.shape[1]
        if s % g.nranks:
            raise ValueError(f"sequence length {s} not divisible by sep "
                             f"degree {g.nranks}")
        k = s // g.nranks
        return value[:, g.rank * k:(g.rank + 1) * k].contiguous()

    def _place(self, value):
        value = self._local_rows(value)
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if isinstance(value, torch.Tensor):
            return self._local_segment(value).to(self.device,
                                                 non_blocking=True)
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
        else:
            self.model.zero_grad(set_to_none=True)
        fp8_on = self.fp8_policy != "none"
        poison = faults.fire_check("step.grads")
        poison_lr = False
        fp8_ctx = _fp8.fp8_execution(
            self.fp8_policy, states=self._fp8_states or [],
            hist_len=self._fp8_hist_len, record=self._fp8_states is None)
        policy = self.remat_policy if self._layer_capable else "none"
        with fp8_ctx as sess, layer_execution(policy), \
                sep_execution(self._sep_group):
            if named:
                kwargs = {k: self._place(v) for k, v in batch[0].items()}
                poison_lr = poison and not _nan_poison(kwargs, None)
                out = self.model(**kwargs)
                labels = kwargs["labels"]
            else:
                args = [self._place(v) for v in batch]
                poison_lr = poison and not _nan_poison(None, args)
                out = self.model(*args[:-1])
                labels = args[-1]
            if self._paddle:
                labels = PaddleLayerModule.tensor(labels)
            loss = self.loss_fn(out, labels)
            loss = getattr(loss, "_value", loss)
            if self._sep_group is not None and loss is not sep_loss():
                raise ValueError(
                    "under sequence parallelism (sep > 1) the step trains on "
                    "the rank's share of the group's mean loss, which only "
                    "the model's own criterion (LlamaPretrainingCriterion) "
                    "computes; a loss_fn of its own would mean the rank's "
                    "segment alone (ROADMAP A8)")
            moe = self._moe_stats()
            if self._scaler is not None:
                # float16 loss scaling before the backward; the step
                # reports the unscaled loss
                (loss * self._scaler._scale).backward()
            else:
                loss.backward()
        if self._zero3 is not None:
            # the held units' gradients reduce-scattered, every full
            # buffer freed
            self._zero3.finish()
        if self._loss_group is not None:
            # the sep ranks' shares summed, the data ranks' means averaged
            from paddle_tpu_torch.distributed import collective

            loss = loss.detach().float().clone()
            collective.all_reduce(loss, group=self._loss_group)
            loss.div_(self._data_group.nranks)
        elif self._data_group is not None and self._data_group.nranks > 1:
            from paddle_tpu_torch.distributed import collective

            loss = loss.detach().float().clone()
            collective.all_reduce(loss, collective.ReduceOp.AVG,
                                  self._data_group)
        params = [p for p in self.model.parameters()
                  if p.requires_grad and p.grad is not None]
        found_inf = self._unscale(params) if self._scaler else None
        if self._anomaly_det is not None:
            found_inf = self._health(loss, found_inf)
        if fp8_on:
            # a skipped step keeps the old histories
            sess.commit(skip=found_inf)
            self._fp8_states = sess.states
        if self.collect_metrics:
            self._metrics = {
                "loss": loss.detach(),
                "grad_norm": (None if self._hybrid else
                              global_norm([p.grad for p in params])),
                "skipped": (found_inf.float() if found_inf is not None
                            else 0.0),
                **({"fp8_amax_max": sess.amax_max()} if fp8_on else {}),
                **moe}
        skipped = found_inf is not None and bool(found_inf)
        if self.optimizer is not None:
            from paddle_tpu_torch.distributed.checkpoint.elastic import (
                innermost_opt)

            base = innermost_opt(self.optimizer)[0]
            if skipped:
                base._step_count += 1
            elif poison_lr:
                # chaos: a NaN learning rate corrupts the parameters
                base.get_lr = lambda: float("nan")
                try:
                    self.optimizer.step()
                finally:
                    del base.get_lr
            else:
                self.optimizer.step()
            step = base._step_count
            if self.collect_metrics and self._hybrid:
                self._metrics["grad_norm"] = self.optimizer.last_grad_norm
        else:
            self._steps += 1
            step = self._steps
        if self._scaler is not None:
            self._scaler._found_inf = skipped
            self._scaler.update()
        if self._anomaly_det is not None:
            self._anomaly_det.observe(step, float(loss.detach()),
                                      float(skipped))
        if self.collect_metrics:
            self._metrics["step"] = step
            wall = time.perf_counter()
            if self._prev_wall is not None:
                self._metrics["host_step_ms"] = round(
                    (wall - self._prev_wall) * 1e3, 3)
            self._prev_wall = wall
        self._last_event = step_event(self.device)
        self._window.admit(self._last_event)
        return loss.detach()

    @torch.no_grad()
    def _health(self, loss, found_inf):
        """The device flag of an unhealthy step: a non-finite loss, or
        (without a scaler, whose found-inf flag covers them) a non-finite
        gradient, full or sharded; OR-ed over the ranks."""
        bad = (found_inf.clone() if found_inf is not None else
               torch.zeros((), dtype=torch.bool, device=self.device))
        bad |= ~torch.isfinite(loss.detach()).all()
        if found_inf is None:
            for g in self._grads():
                bad |= ~torch.isfinite(g).all()
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            from paddle_tpu_torch.distributed import collective

            flag_ = bad.float()
            collective.all_reduce(flag_, collective.ReduceOp.MAX)
            bad = flag_ > 0
        return bad

    def _grads(self):
        """Every gradient this rank holds before the update: the
        parameters', the ZeRO-1/2 slices' and the ZeRO-3 shards'."""
        gs = [p.grad for p in self.model.parameters() if p.grad is not None]
        if self.optimizer is not None:
            from paddle_tpu_torch.distributed.checkpoint.elastic import (
                innermost_opt)

            dso = innermost_opt(self.optimizer)[1]
            if dso is not None:
                gs += [s.grad for s in dso._slices if s.grad is not None]
                gs += [b.shard.grad for u in dso._units for b in u.buckets
                       if b.shard.grad is not None]
        return gs

    @torch.no_grad()
    def _unscale(self, params):
        """Gradients times 1/scale in fp32, cast back; the device flag of a
        non-finite one."""
        inv = float(np.float32(1.0) / np.float32(self._scaler._scale))
        bad = torch.zeros((), dtype=torch.bool, device=self.device)
        for p in params:
            g32 = p.grad.float() * inv
            bad |= ~torch.isfinite(g32).all()
            p.grad = g32.to(p.grad.dtype)
        return bad

    def step_async(self, *batch):
        """Run one step and return a ``LossFuture``; every
        `metrics_every`-th call waits for its step before returning (0:
        never), and at most the dispatch window of steps is in flight.
        ``drain()`` before timing or checkpointing."""
        loss = self(*batch)
        f = LossFuture(loss, self._last_event)
        self._async_count += 1
        if self.metrics_every and self._async_count % self.metrics_every == 0:
            f.block()
        return f

    def drain(self):
        """Wait until every step run so far has finished on the device."""
        self._window.drain()

    # -- anomaly detection ------------------------------------------------
    @property
    def anomaly_detector(self):
        return self._anomaly_det

    def settle_anomalies(self, block: bool = False):
        """The detector has seen every step already (the port reads each
        step's health flag at once); kept for the supervisor's loop."""

    @property
    def step_count(self) -> int:
        """The optimizer's step count (the one its bias correction uses),
        or the steps taken without one."""
        if self.optimizer is None:
            return self._steps
        from paddle_tpu_torch.distributed.checkpoint.elastic import (
            innermost_opt)

        return int(innermost_opt(self.optimizer)[0]._step_count)

    # -- elastic checkpoint interface ------------------------------------
    def named_train_state(self):
        """(arrays, meta) for elastic checkpointing, under the JAX
        package's layout-free names and layout, without a host sync:

        * ``model/<state-dict name>``: every parameter and persistent
          buffer, as this rank's ``LocalShards`` (its part at its global
          offset; a replicated value on its lowest holder only);
        * ``opt/<name>/<slot>``: the optimizer's moments keyed by the
          parameter's name (a ZeRO slice at its global offset);
        * ``rng/key``: carried from a JAX snapshot, when one was loaded;
        * meta: the step count, the fp8 callsite layout (with
          ``fp8/<i>`` amax histories in arrays), the GradScaler's scalars.

        The tensors are the live ones, which the next step overwrites in
        place: ``checkpoint.elastic.capture`` clones them."""
        from paddle_tpu_torch.distributed.checkpoint import layout
        from paddle_tpu_torch.distributed.checkpoint.elastic import (
            module_state)

        arrays, _ = module_state({"": self.model}, self.optimizer)
        first = layout.writes(set())
        meta = {"step": self.step_count}
        if self._rng_key is not None and first:
            arrays["rng/key"] = self._rng_key
        if self._fp8_states is not None:
            meta["fp8_layout"] = [["plain"]] * len(self._fp8_states)
            leaves = [st[k] for st in self._fp8_states
                      for k in sorted(_fp8.STATE_KEYS)]
            meta["fp8_leaves"] = len(leaves)
            if first:
                for i, leaf in enumerate(leaves):
                    arrays[f"fp8/{i:05d}"] = leaf.detach()
        if self._scaler is not None:
            meta["scaler"] = dict(self._scaler.state_dict())
        return arrays, meta

    def load_resume_extras(self, arrays, meta):
        """Restore what a (model, optimizer) restore cannot carry: the step
        count, the fp8 amax histories (a JAX snapshot's scanned layout
        unstacked), the GradScaler's scalars, and a JAX snapshot's RNG
        key. Parameters and moments go through ``checkpoint.elastic.
        restore``."""
        if "rng/key" in arrays:
            v = arrays["rng/key"]
            self._rng_key = (v.numpy() if isinstance(v, torch.Tensor)
                             else np.asarray(v)).copy()
        if "step" in meta:
            if self.optimizer is not None:
                from paddle_tpu_torch.distributed.checkpoint.elastic import (
                    innermost_opt)

                innermost_opt(self.optimizer)[0]._step_count = int(
                    meta["step"])
            else:
                self._steps = int(meta["step"])
        if meta.get("fp8_layout") is not None and self.fp8_policy != "none":
            from paddle_tpu_torch.models.convert import (
                fp8_state_from_paddle_tpu)

            it = iter(np.asarray(arrays[f"fp8/{i:05d}"], np.float32)
                      for i in range(int(meta.get("fp8_leaves", 0))))
            # the callsite dicts flattened in sorted-key order; a scanned
            # entry ("scan", L, k) holds k stacked callsites
            states = []
            for e in meta["fp8_layout"]:
                for _ in range(1 if e[0] == "plain" else int(e[2])):
                    states.append({k: next(it)
                                   for k in sorted(_fp8.STATE_KEYS)})
            self.load_fp8_state(fp8_state_from_paddle_tpu(
                {"layout": [tuple(e) for e in meta["fp8_layout"]],
                 "states": states}))
        if meta.get("scaler") is not None and self._scaler is not None:
            self._scaler.load_state_dict(dict(meta["scaler"]))

    def fp8_state_dict(self):
        """The delayed-scaling amax state, in the JAX package's layout:
        {"layout": [("plain",), ...], "states": [{x, w, g: numpy}, ...]};
        None before the first step (or with fp8 off)."""
        if self._fp8_states is None:
            return None
        return {"layout": [("plain",)] * len(self._fp8_states),
                "states": [{k: st[k].detach().cpu().numpy()
                            for k in _fp8.STATE_KEYS}
                           for st in self._fp8_states]}

    def load_fp8_state(self, snap):
        """Restore an ``fp8_state_dict()`` snapshot (before or after the
        first step). A layout with scanned groups (the JAX package's
        ``("scan", L, k)``) is unstacked by
        ``models.convert.fp8_state_from_paddle_tpu``."""
        if snap is None:
            return
        if any(tuple(e) != ("plain",) for e in snap["layout"]):
            raise ValueError("the port's fp8 layout is plain callsites; "
                             "convert a scanned layout with "
                             "models.convert.fp8_state_from_paddle_tpu")
        self._fp8_states = [
            {k: torch.from_numpy(np.array(st[k], np.float32))
             .to(self.device) for k in _fp8.STATE_KEYS}
            for st in snap["states"]]

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
        """{step, loss, grad_norm, skipped[, fp8_amax_max][, moe_aux,
        moe_dropped][, host_step_ms]} of the last step as Python numbers,
        or None before the first step or with ``collect_metrics`` off.
        ``step`` is the optimizer's own step count (the one its bias
        correction uses), or the steps this object took without one."""
        if self._metrics is None:
            return None
        return {k: (float(v) if isinstance(v, torch.Tensor) else v)
                for k, v in self._metrics.items()}
