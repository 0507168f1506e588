"""Self-healing training of the port (``paddle_tpu_torch.distributed.
resilience``, ``watchdog``, ``TrainStep(anomaly_detector=)``) against the
JAX package on the CPU, mirroring ``tests/test_resilience.py``'s
registry, ``AnomalyDetector``, step-detection, ``run_resilient``,
GradScaler-streak and watchdog classes.

* The fault registry: the training and checkpoint points register at
  import under the JAX package's names; one-shot, nth-hit, seeded
  probabilistic (the same firing sequence as JAX's for a seed), always,
  flag specs, config-time spec errors, the legacy ckpt flag.
* ``AnomalyDetector``: the same observation sequences through both
  packages' detectors give the same anomalies (kind, step, action,
  detail), pending anomaly, history and incidents.
* ``TrainStep`` detection: detection on leaves a healthy trajectory
  bit-identical; a NaN float batch skips the whole update the same step;
  on the tiny LLaMA a ``step.grads`` NaN learning rate is caught on the
  next step, as JAX's ``CompiledTrainStep`` catches it (the same
  anomalies); the flag and GradScaler tolerance rules.
* ``run_resilient`` on a tiny fp32 LLaMA (1 layer, hidden 64, vocab 256,
  batches 4 x 16 drawn per index, AdamW lr 1e-3, a snapshot every 2
  batches over 8): fault-free, a ``step.grads`` NaN at batch 4, a feeder
  crash, a killed save and a simulated hang each give the JAX package's
  incident sequence (events, batches, steps, cursors, rollback targets)
  and status, losses within rtol 1e-5 of JAX's run, and losses bit-equal
  to the port's own fault-free run. The one deliberate difference: the
  port reads the health flag the step it is made, where JAX settles it
  lazily, so after the NaN learning rate JAX may (by timing) commit a
  poisoned cadence snapshot, roll back to it and step back past it; the
  port rolls back to the clean snapshot at once (both end at step 4's). On the float-input MLP of the JAX
  tests (weights carried from JAX): the skip_batch policy (the same
  quarantine, one input pipeline), a persistent fault ending in
  ``ResilienceHalt``, the incident log as JSONL, a caller-owned log.
* The GradScaler's consecutive-skip guard, the watchdog's thread stacks.
"""
import json
import math
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch.distributed.store  # noqa: F401 (store.barrier)
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.distributed.checkpoint import elastic
from paddle_tpu_torch.distributed.resilience import (AnomalyDetector,
                                                     IncidentLog,
                                                     ResilienceHalt,
                                                     ResiliencePolicy,
                                                     faults, run_resilient)
from paddle_tpu_torch.io.device_feed import DeviceFeeder, FeederWorkerError
from paddle_tpu_torch.parallel import TrainStep

# the training-side points, as literals (the JAX registry-coverage test
# greps the tests for every registered name)
CHAOS_POINTS = [
    "ckpt.after_commit", "ckpt.after_metadata", "ckpt.after_shard_write",
    "ckpt.after_snapshot", "ckpt.before_commit", "ckpt.before_rename",
    "feeder.collate", "feeder.device_put", "step.grads", "store.barrier",
    "watchdog.hang",
]
LR = 1e-3
N = 8
IN_DIM, N_CLS = 8, 3


@pytest.fixture(autouse=True)
def _hygiene():
    faults.reset()
    yield
    faults.reset()
    set_flags({"fault_injection": "", "ckpt_fault_injection": "",
               "anomaly_detection": False, "anomaly_policy": "rollback"})
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("paddle_tpu_torch.ckpt",
                                  "paddle_tpu_torch.io"))]
    assert not left, f"threads outlived the test: {left}"


def _jax_faults():
    from paddle_tpu.distributed.resilience import faults as jax_faults

    return jax_faults


# -- the tiny LLaMA -----------------------------------------------------------
def _llama_batch(i):
    rng = np.random.RandomState(5000 + i)
    return {"input_ids": rng.randint(0, 256, (4, 16)).astype(np.int64),
            "labels": rng.randint(0, 256, (4, 16)).astype(np.int64)}


def _fused_loss(out, labels):
    return out


@pytest.fixture(scope="module")
def llama_named():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny

    paddle.seed(0)
    return {n: np.asarray(p._value) for n, p in
            JaxLlama(jax_tiny(num_hidden_layers=1)).named_parameters()}


def _port_llama_factory(named, n_total=N):
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW

    def make_data(start):
        return (_llama_batch(i) for i in range(start, n_total))

    def make_step(det, arrays=None, meta=None):
        model = from_paddle_tpu_params(
            named, llama_tiny_config(num_hidden_layers=1), device="cpu")
        opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                    weight_decay=0.01)
        if arrays is not None:
            elastic.restore(arrays, meta, model, opt)
        step = TrainStep(model, _fused_loss, opt, anomaly_detector=det,
                         metrics_every=0)
        if arrays is not None:
            step.load_resume_extras(arrays, meta)
        return step

    return make_step, make_data


def _jax_llama_factory(n_total=N):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.checkpoint import elastic as jel
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny
    from paddle_tpu.parallel import CompiledTrainStep

    def make_data(start):
        for i in range(start, n_total):
            b = _llama_batch(i)
            yield {k: v.astype(np.int32) for k, v in b.items()}

    def make_step(det, arrays=None, meta=None):
        paddle.seed(0)
        model = JaxLlama(jax_tiny(num_hidden_layers=1))
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=model.parameters(),
                                     weight_decay=0.01)
        if arrays is not None:
            jel.restore(arrays, meta, model, opt)
        step = CompiledTrainStep(model, _fused_loss, optimizer=opt,
                                 anomaly_detector=det, metrics_every=0)
        if arrays is not None:
            step.load_resume_extras(arrays, meta)
        return step

    return make_step, make_data


# -- the float-input MLP of the JAX tests -------------------------------------
def _mlp_data(i, batch=8):
    rng = np.random.RandomState(5000 + i)
    x = rng.randn(batch, IN_DIM).astype(np.float32)
    y = rng.randint(0, N_CLS, (batch,)).astype(np.int64)
    return x, y


@pytest.fixture(scope="module")
def mlp_named():
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn

    paddle.seed(7)
    net = jnn.Sequential(jnn.Linear(IN_DIM, 16), jnn.ReLU(),
                         jnn.Linear(16, N_CLS))
    return {n: np.asarray(p._value) for n, p in net.named_parameters()}


def _port_mlp(named):
    """The JAX MLP's weights in torch Linears ([out, in])."""
    net = torch.nn.Sequential(torch.nn.Linear(IN_DIM, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, N_CLS))
    with torch.no_grad():
        for n, p in net.named_parameters():
            v = named[n]
            p.copy_(torch.from_numpy(np.array(v.T if v.ndim == 2 else v)))
    return net


def _port_mlp_factory(named, n_total):
    from paddle_tpu_torch.optimizer import Adam

    def make_data(start):
        return (_mlp_data(i) for i in range(start, n_total))

    def make_step(det, arrays=None, meta=None):
        net = _port_mlp(named)
        opt = Adam(learning_rate=0.05, parameters=net.parameters())
        if arrays is not None:
            elastic.restore(arrays, meta, net, opt)
        step = TrainStep(net, torch.nn.functional.cross_entropy, opt,
                         anomaly_detector=det, metrics_every=0)
        if arrays is not None:
            step.load_resume_extras(arrays, meta)
        return step

    return make_step, make_data


def _jax_mlp_factory(n_total):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed.checkpoint import elastic as jel
    from paddle_tpu.parallel import CompiledTrainStep

    def make_data(start):
        return (_mlp_data(i) for i in range(start, n_total))

    def make_step(det, arrays=None, meta=None):
        paddle.seed(7)
        net = jnn.Sequential(jnn.Linear(IN_DIM, 16), jnn.ReLU(),
                             jnn.Linear(16, N_CLS))
        opt = paddle.optimizer.Adam(learning_rate=0.05,
                                    parameters=net.parameters())
        if arrays is not None:
            jel.restore(arrays, meta, net, opt)
        crit = jnn.CrossEntropyLoss()
        step = CompiledTrainStep(net, lambda o, l: crit(o, l), opt,
                                 anomaly_detector=det, metrics_every=0)
        if arrays is not None:
            step.load_resume_extras(arrays, meta)
        return step

    return make_step, make_data


# -- incidents as comparable data ---------------------------------------------
_FIELDS = ("event", "batch", "step", "cursor", "to_step", "kind", "action",
           "phase", "recurrences")


def _incidents(rep):
    """The incidents without times. A failed save's cursor is where the
    loop was when it reaped the writer's error (the writer thread's pace),
    and an anomaly's where JAX's lazily settled flag was read (the
    device's pace), so those cursors are left out."""
    return [{k: e[k] for k in _FIELDS if k in e
             and not (k == "cursor" and e["event"] in ("ckpt_save_failed",
                                                       "anomaly"))}
            for e in rep["incidents"]]


def _port_run(factory, tmp, point=None, policy=None, n=N, every=2,
              log=None, **arm):
    make_step, make_data = factory
    faults.reset()
    if point:
        faults.arm(point, **arm)
    try:
        return run_resilient(make_step, make_data, n, str(tmp),
                             policy=policy, ckpt_every=every, feed_depth=2,
                             device="cpu", incident_log=log)
    finally:
        faults.reset()


def _jax_run(factory, tmp, point=None, policy=None, n=N, every=2, **arm):
    from paddle_tpu.distributed.resilience import ResiliencePolicy as JPol
    from paddle_tpu.distributed.resilience import run_resilient as jax_run

    jf = _jax_faults()
    make_step, make_data = factory
    jf.reset()
    if point:
        jf.arm(point, **arm)
    jpol = None if policy is None else JPol(**vars(policy))
    try:
        return jax_run(make_step, make_data, n, str(tmp), policy=jpol,
                       ckpt_every=every, feed_depth=2)
    finally:
        jf.reset()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class TestFaultRegistry:
    def test_points_register_at_import(self):
        import paddle_tpu.distributed.checkpoint.elastic  # noqa: F401
        import paddle_tpu.distributed.resilience.supervisor  # noqa: F401
        import paddle_tpu.distributed.store  # noqa: F401
        import paddle_tpu.io.device_feed  # noqa: F401
        import paddle_tpu.parallel.train_step  # noqa: F401

        assert set(CHAOS_POINTS) <= set(faults.registered())
        jax_train = {p for p in _jax_faults().registered()
                     if not p.startswith("serving.")}
        assert jax_train == set(CHAOS_POINTS)
        docs = faults.describe()
        for p in CHAOS_POINTS:
            assert docs[p], f"{p} has no catalog doc"

    def test_unknown_point_raises(self):
        with pytest.raises(KeyError, match="no.such.point"):
            faults.point("no.such.point")
        with pytest.raises(KeyError, match="registered"):
            faults.arm("no.such.point")

    def test_one_shot_and_nth(self):
        faults.arm("feeder.collate")
        with pytest.raises(faults.FaultInjected) as ei:
            faults.point("feeder.collate")
        assert ei.value.point == "feeder.collate"
        faults.point("feeder.collate")
        assert faults.hits("feeder.collate") == 2
        assert faults.fired("feeder.collate") == 1
        faults.arm("feeder.device_put", mode="nth", nth=3)
        faults.point("feeder.device_put")
        faults.point("feeder.device_put")
        with pytest.raises(faults.FaultInjected):
            faults.point("feeder.device_put")
        faults.point("feeder.device_put")

    def test_probabilistic_sequence_equals_jax(self):
        jf = _jax_faults()
        faults.arm("step.grads", mode="prob", p=0.5, seed=123)
        a = [faults.fire_check("step.grads") for _ in range(32)]
        jf.reset()
        jf.arm("step.grads", mode="prob", p=0.5, seed=123)
        b = [jf.fire_check("step.grads") for _ in range(32)]
        jf.reset()
        assert a == b and any(a) and not all(a)

    def test_always_until_disarm(self):
        faults.arm("store.barrier", mode="always")
        for _ in range(3):
            with pytest.raises(faults.FaultInjected):
                faults.point("store.barrier")
        faults.disarm("store.barrier")
        faults.point("store.barrier")

    def test_flag_spec_arming(self):
        set_flags({"fault_injection": "feeder.collate:nth=2"})
        faults.point("feeder.collate")
        with pytest.raises(faults.FaultInjected):
            faults.point("feeder.collate")
        faults.point("feeder.collate")
        set_flags({"fault_injection": "feeder.collate"})
        with pytest.raises(faults.FaultInjected):
            faults.point("feeder.collate")

    def test_malformed_flag_spec_fails_at_config_time(self):
        set_flags({"fault_injection": "feeder.collate:nht=3"})
        with pytest.raises(ValueError, match="nht"):
            faults.check_flag_spec()
        set_flags({"fault_injection": "fedeer.collate:nth=1"})
        with pytest.raises(KeyError, match="fedeer"):
            faults.check_flag_spec()
        set_flags({"fault_injection": ""})
        faults.check_flag_spec()

    def test_legacy_ckpt_flag_still_arms(self):
        set_flags({"ckpt_fault_injection": "before_rename"})
        with pytest.raises(elastic.CheckpointFaultInjected,
                           match="before_rename"):
            elastic._maybe_inject("before_rename")
        with pytest.raises(elastic.CheckpointFaultInjected):
            elastic._maybe_inject("before_rename")   # always
        set_flags({"ckpt_fault_injection": ""})
        elastic._maybe_inject("before_rename")
        assert issubclass(elastic.CheckpointFaultInjected,
                          faults.FaultInjected)

    def test_new_flag_drives_ckpt_points_through_real_save(self, tmp_path):
        net = torch.nn.Linear(4, 2)
        set_flags({"fault_injection": "ckpt.before_rename"})
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            with pytest.raises(elastic.CheckpointFaultInjected,
                               match="ckpt.before_rename"):
                mgr.save(elastic.capture_model(net))
            set_flags({"fault_injection": ""})
            assert mgr.latest() is None
            mgr.save(elastic.capture_model(net))
            assert mgr.latest() is not None


# ---------------------------------------------------------------------------
# the detector, held to JAX's on the same observations
# ---------------------------------------------------------------------------

_DRIFT = [5.0 * 0.97 ** i + 0.01 * math.sin(i) for i in range(40)]
_SHIFT = ([1.0 + 0.01 * (i % 3) for i in range(16)]
          + [5.0 + 0.01 * (i % 3) for i in range(32)] + [5.0])
SCENARIOS = {
    "nonfinite": (dict(policy="rollback", min_history=4),
                  [(1, 1.0, 0.0), (2, 0.9, 1.0), (3, float("nan"), 0.0)]),
    "spike": (dict(policy="rollback", min_history=6, mad_k=8.0),
              [(i, l, 0.0) for i, l in
               enumerate([2.0, 1.9, 1.95, 1.85, 1.9, 1.8])]
              + [(7, 40.0, 0.0)]),
    "drift": (dict(policy="rollback", min_history=6, mad_k=8.0),
              [(i, l, 0.0) for i, l in enumerate(_DRIFT)]),
    "level_shift": (dict(policy="rollback", window=16, min_history=8,
                         mad_k=8.0),
                    [(i, l, 0.0) for i, l in enumerate(_SHIFT)]),
    "min_history": (dict(policy="rollback", min_history=8),
                    [(i, 1.0, 0.0) for i in range(5)] + [(6, 1000.0, 0.0)]),
    "tolerance": (dict(policy="rollback", min_history=4,
                       nonfinite_tolerance=2),
                  [(1, float("nan"), 1.0), (2, 1.0, 0.0),
                   (3, float("nan"), 1.0), (4, float("nan"), 1.0),
                   (5, float("nan"), 1.0)]),
    "skip_policy": (dict(policy="skip_batch", min_history=2),
                    [(1, 1.0, 0.0), (2, 1.1, 0.0), (3, float("inf"), 1.0)]),
}


def _feed(det, seq):
    """Each observation's anomaly (as JSON), clearing pending after each
    as the supervisor does."""
    out = []
    for step, loss, health in seq:
        a = det.observe(step, loss, health)
        out.append(None if a is None else a.to_json())
        det.clear_pending()
    return out


class TestAnomalyDetector:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_same_anomalies_as_jax(self, name):
        from paddle_tpu.distributed.resilience import (
            AnomalyDetector as JaxDetector)

        kw, seq = SCENARIOS[name]
        port, jax = AnomalyDetector(**kw), JaxDetector(**kw)
        assert _feed(port, seq) == _feed(jax, seq)
        assert list(port.history) == list(jax.history)
        assert [a.to_json() for a in port.incidents] == \
            [a.to_json() for a in jax.incidents]

    def test_pending_and_warn_policy(self):
        det = AnomalyDetector(policy="rollback", min_history=4)
        a = det.observe(2, 0.9, 1.0)
        assert a.kind == "nonfinite" and det.pending is a
        warn = AnomalyDetector(policy="warn", min_history=4)
        with pytest.warns(UserWarning, match="anomaly detected"):
            warn.observe(1, float("inf"), 1.0)
        assert warn.pending is None and len(warn.incidents) == 1

    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError, match="policy"):
            AnomalyDetector(policy="explode")

    def test_reset_history_keeps_incidents(self):
        det = AnomalyDetector(policy="rollback", min_history=2)
        det.observe(1, 1.0, 0.0)
        det.observe(2, float("nan"), 1.0)
        det.reset_history()
        assert len(det.history) == 0 and len(det.incidents) == 1


# ---------------------------------------------------------------------------
# detection in the step
# ---------------------------------------------------------------------------

class TestStepDetection:
    def _step(self, named, det):
        from paddle_tpu_torch.optimizer import Adam

        net = _port_mlp(named)
        opt = Adam(learning_rate=0.05, parameters=net.parameters())
        return TrainStep(net, torch.nn.functional.cross_entropy, opt,
                         anomaly_detector=det)

    def test_healthy_trajectory_bit_identical_with_detection(self,
                                                             mlp_named):
        det = AnomalyDetector(policy="rollback", min_history=4)
        s_on, s_off = self._step(mlp_named, det), self._step(mlp_named,
                                                              False)
        x, y = _mlp_data(0)
        on = [float(s_on(x, y)) for _ in range(4)]
        off = [float(s_off(x, y)) for _ in range(4)]
        assert on == off
        assert det.incidents == [] and len(det.history) == 4

    def test_nan_batch_skips_update_and_detects_same_step(self, mlp_named):
        det = AnomalyDetector(policy="rollback", min_history=4)
        step = self._step(mlp_named, det)
        x, y = _mlp_data(0)
        l0 = float(step(x, y))
        before = [p.detach().clone() for p in step.model.parameters()]
        moments = {i: {k: v.clone() for k, v in st.items()}
                   for i, st in step.optimizer._state.items()}
        faults.arm("step.grads")
        step(x, y)
        for a, b in zip(before, step.model.parameters()):
            assert torch.equal(a, b.detach())
        for i, st in moments.items():
            for k, v in st.items():
                assert torch.equal(v, step.optimizer._state[i][k])
        assert det.pending is not None and det.pending.kind == "nonfinite"
        assert det.pending.step == 2 and step.step_count == 2
        det.clear_pending()
        l2 = float(step(x, y))
        assert math.isfinite(l2) and l2 != l0

    def test_nan_lr_caught_next_step_as_jax(self, llama_named):
        """Token batches: ``step.grads`` poisons the learning rate; both
        packages see a finite loss that step and a non-finite one the
        next."""
        port_step, _ = _port_llama_factory(llama_named)
        jax_step, _ = _jax_llama_factory()
        got = {}
        for name, make, arm in (("port", port_step, faults.arm),
                                ("jax", jax_step, _jax_faults().arm)):
            det = (AnomalyDetector if name == "port" else
                   __import__("paddle_tpu.distributed.resilience",
                              fromlist=["AnomalyDetector"]
                              ).AnomalyDetector)(policy="rollback",
                                                 min_history=8)
            step = make(det)
            batch = _llama_batch(0)
            if name == "jax":
                batch = {k: v.astype(np.int32) for k, v in batch.items()}
            float(step(batch))
            arm("step.grads")
            float(step(batch))
            float(step(batch))
            if name == "jax":
                step.drain()
                _jax_faults().reset()
            got[name] = [a.to_json() for a in det.incidents]
        assert got["port"] and [
            {k: v for k, v in a.items() if k != "loss"} for a in got["port"]
        ] == [{k: v for k, v in a.items() if k != "loss"}
              for a in got["jax"]]

    def test_detector_property_and_flag_construction(self, mlp_named):
        set_flags({"anomaly_detection": True, "anomaly_policy": "warn"})
        step = self._step(mlp_named, None)
        assert step.anomaly_detector is not None
        assert step.anomaly_detector.policy == "warn"
        set_flags({"anomaly_detection": False, "anomaly_policy": "rollback"})
        assert self._step(mlp_named, None).anomaly_detector is None
        assert self._step(mlp_named, False).anomaly_detector is None

    def test_scaler_tolerance_rules(self, mlp_named):
        from paddle_tpu_torch.amp import GradScaler
        from paddle_tpu_torch.optimizer import Adam

        def build(det, scaler):
            net = _port_mlp(mlp_named)
            opt = Adam(learning_rate=0.01, parameters=net.parameters())
            TrainStep(net, torch.nn.functional.cross_entropy, opt,
                      anomaly_detector=det, grad_scaler=scaler)

        det = AnomalyDetector(policy="rollback")
        build(det, GradScaler(init_loss_scaling=8.0))
        assert det.nonfinite_tolerance == 2
        det = AnomalyDetector(policy="rollback", nonfinite_tolerance=0)
        build(det, GradScaler(init_loss_scaling=8.0))
        assert det.nonfinite_tolerance == 0
        det = AnomalyDetector(policy="rollback")
        build(det, GradScaler(init_loss_scaling=8.0,
                              use_dynamic_loss_scaling=False))
        assert det.nonfinite_tolerance == 0


# ---------------------------------------------------------------------------
# run_resilient against the JAX package's
# ---------------------------------------------------------------------------

CASES = {
    "fault_free": (None, {}),
    "nan_rollback": ("step.grads", dict(mode="nth", nth=5)),
    "feeder_crash": ("feeder.collate", dict(mode="nth", nth=6)),
    "killed_save": ("ckpt.before_rename", dict(mode="nth", nth=2)),
    "hang_restart": ("watchdog.hang", dict(mode="nth", nth=6)),
}


@pytest.fixture(scope="module")
def llama_runs(llama_named, tmp_path_factory):
    """Every case run by both packages (the JAX runs while nothing else
    does: its compiled steps are the slow part)."""
    out = {}
    for name, (point, arm) in CASES.items():
        tmp = tmp_path_factory.mktemp(name)
        out[name] = {
            "port": _port_run(_port_llama_factory(llama_named), tmp / "p",
                              point, **arm),
            "jax": _jax_run(_jax_llama_factory(), tmp / "j", point, **arm)}
    return out


class TestRunResilient:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_incidents_and_losses_match_jax(self, llama_runs, name):
        port, jax = llama_runs[name]["port"], llama_runs[name]["jax"]
        assert port["status"] == jax["status"] == "ok"
        for k in ("feeder_retries", "save_failures", "hang_restarts",
                  "quarantined", "cursor"):
            assert port[k] == jax[k], k
        if name != "nan_rollback":
            assert port["rollbacks"] == jax["rollbacks"]
            assert _incidents(port) == _incidents(jax)
        else:
            # the port reads the health flag the same step; JAX settles it
            # lazily, as its buffers become ready. When the flag settles
            # after the step-6 cadence save, that snapshot holds the
            # poisoned parameters: JAX rolls back there, meets the poison
            # again one step later and steps back past it to step 4, where
            # the port went at once; when it settles before, JAX's
            # incidents are the port's
            p, j = _incidents(port), _incidents(jax)
            assert [e["event"] for e in p] == ["anomaly", "rollback"]
            first = ("batch", "step", "kind", "action")
            assert {k: p[0][k] for k in first} == {k: j[0][k] for k in first}
            assert p[1] == j[-1] == {"event": "rollback", "to_step": 4,
                                     "cursor": 4}
            if len(j) != 2:
                assert [e["event"] for e in j] == ["anomaly", "rollback",
                                                   "anomaly", "rollback"]
                assert j[2]["step"] == j[1]["to_step"] + 1
        assert sorted(port["losses"]) == sorted(jax["losses"]) == list(
            range(N))
        np.testing.assert_allclose(
            [port["losses"][i] for i in range(N)],
            [jax["losses"][i] for i in range(N)], rtol=1e-5)

    @pytest.mark.parametrize("name", sorted(set(CASES) - {"fault_free"}))
    def test_recovery_replays_the_fault_free_run_bit_exactly(self,
                                                             llama_runs,
                                                             name):
        rep = llama_runs[name]["port"]
        assert rep["losses"] == llama_runs["fault_free"]["port"]["losses"]
        events = [e["event"] for e in rep["incidents"]]
        want = {"nan_rollback": ["anomaly", "rollback"],
                "feeder_crash": ["feeder_crash"],
                "killed_save": ["ckpt_save_failed"],
                "hang_restart": ["hang", "restart"]}[name]
        assert events == want
        if name == "nan_rollback":
            rb = rep["incidents"][1]
            assert rb["recovery_ms"] > 0 and rb["to_step"] == 4

    def test_killed_save_leaves_previous_committed(self, llama_named,
                                                   tmp_path):
        rep = _port_run(_port_llama_factory(llama_named), tmp_path,
                        "ckpt.before_rename", mode="nth", nth=2)
        assert rep["save_failures"] == 1
        mgr = elastic.CheckpointManager(str(tmp_path))
        assert mgr.latest() is not None
        mgr.load()

    def test_skip_batch_policy_quarantines_as_jax(self, mlp_named, tmp_path):
        calls = []
        make_step, make_data = _port_mlp_factory(mlp_named, 24)

        def counted(start):
            calls.append(start)
            return make_data(start)

        pol = ResiliencePolicy(anomaly="skip_batch")
        rep = _port_run((make_step, counted), tmp_path / "p", "step.grads",
                        policy=pol, n=24, every=6, mode="nth", nth=10)
        jrep = _jax_run(_jax_mlp_factory(24), tmp_path / "j", "step.grads",
                        policy=pol, n=24, every=6, mode="nth", nth=10)
        assert rep["status"] == "ok" and rep["rollbacks"] == 0
        assert rep["quarantined"] == jrep["quarantined"] == [9]
        assert 9 not in rep["losses"]
        assert calls == [0]          # one input pipeline for the run
        assert _incidents(rep) == _incidents(jrep)
        np.testing.assert_allclose(
            [rep["losses"][i] for i in sorted(rep["losses"])],
            [jrep["losses"][i] for i in sorted(jrep["losses"])], rtol=1e-5)

    def test_persistent_fault_halts_with_report(self, mlp_named, tmp_path):
        make_step, make_data = _port_mlp_factory(mlp_named, 24)
        faults.arm("step.grads", mode="always")
        with pytest.raises(ResilienceHalt) as ei:
            run_resilient(make_step, make_data, 24, str(tmp_path),
                          policy=ResiliencePolicy(max_rollbacks=2),
                          ckpt_every=6, feed_depth=2, device="cpu")
        faults.reset()
        report = ei.value.report
        events = [e["event"] for e in report["incidents"]]
        assert "rollback" in events and "quarantine" in events
        assert report["rollbacks"] >= 1 and report["quarantined"]

    def test_incident_log_is_jsonl_and_caller_owned(self, mlp_named,
                                                    tmp_path):
        log = IncidentLog(str(tmp_path / "log.jsonl"))
        rep = _port_run(_port_mlp_factory(mlp_named, 12), tmp_path / "ck",
                        "step.grads", n=12, every=3, log=log, mode="nth",
                        nth=5)
        assert log._f is not None     # still open for the next run
        log.emit("probe")
        log.close()
        lines = [json.loads(ln) for ln in open(tmp_path / "log.jsonl")]
        assert lines[:-1] == rep["incidents"]
        assert {"anomaly", "rollback"} <= {r["event"] for r in lines}
        assert all("ts" in r and "event" in r for r in lines)


# ---------------------------------------------------------------------------
# the GradScaler's skip streak, the watchdog
# ---------------------------------------------------------------------------

class TestGradScalerSkipStreak:
    def test_warn_then_halt_and_reset(self):
        from paddle_tpu_torch.amp import GradScaler

        set_flags({"scaler_max_consecutive_skips": 4})
        try:
            s = GradScaler(init_loss_scaling=8.0)
            s._found_inf = True
            with pytest.warns(UserWarning, match="consecutive"):
                s.update()
                s._found_inf = True
                s.update()
            s._found_inf = False
            s.update()
            assert s._consecutive_skips == 0
            for _ in range(3):
                s._found_inf = True
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    s.update()
            s._found_inf = True
            with pytest.raises(FloatingPointError,
                               match="scaler_max_consecutive_skips"):
                s.update()
        finally:
            set_flags({"scaler_max_consecutive_skips": 100})

    def test_step_streak_halts(self, mlp_named):
        from paddle_tpu_torch.amp import GradScaler
        from paddle_tpu_torch.optimizer import Adam

        set_flags({"scaler_max_consecutive_skips": 3})
        try:
            net = _port_mlp(mlp_named)
            with torch.no_grad():
                net[0].weight.mul_(float("nan"))
            opt = Adam(learning_rate=0.05, parameters=net.parameters())
            step = TrainStep(net, torch.nn.functional.cross_entropy, opt,
                             grad_scaler=GradScaler(init_loss_scaling=8.0))
            x, y = _mlp_data(0)
            with pytest.raises(FloatingPointError, match="permanently NaN"):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    for _ in range(8):
                        step(x, y)
        finally:
            set_flags({"scaler_max_consecutive_skips": 100})


class TestWatchdog:
    def test_diagnostics_name_where_threads_block(self):
        from paddle_tpu_torch.distributed import watchdog

        gate = threading.Event()

        def blocked_in_a_named_place():
            gate.wait(10.0)

        t = threading.Thread(target=blocked_in_a_named_place,
                             name="stuck-worker", daemon=True)
        t.start()
        time.sleep(0.05)
        try:
            diag = watchdog.CommTaskManager().diagnostics()
            mine = next(th for th in diag["threads"]
                        if th["name"] == "stuck-worker")
            joined = "\n".join(mine["stack"])
            assert "blocked_in_a_named_place" in joined and "wait" in joined
        finally:
            gate.set()
            t.join(5)

    def test_hang_report_carries_stacks_and_events_complete(self):
        from paddle_tpu_torch.distributed import watchdog

        mgr = watchdog.CommTaskManager(default_timeout_s=0.1,
                                       poll_interval_s=0.02)
        seen = []
        off = watchdog.add_hang_listener(lambda task, diag: seen.append(diag),
                                         manager=mgr)

        class Stalled:
            def __array__(self, dtype=None):
                time.sleep(0.5)
                return np.zeros((), np.float32)

        try:
            # a finished CPU step completes at once: no hang
            done = watchdog.watch_step(torch.ones(2), name="ok",
                                       timeout_s=5.0, manager=mgr)
            watchdog.watch_step(Stalled(), name="stuck", timeout_s=0.1,
                                manager=mgr)
            deadline = time.time() + 5
            while not seen and time.time() < deadline:
                time.sleep(0.02)
            assert done.done.wait(1.0)
            assert seen and seen[0]["task"]["name"] == "stuck"
            assert any(th["stack"] for th in seen[0]["threads"])
        finally:
            off()
            mgr.stop()
        time.sleep(0.6)

    def test_feeder_crash_carries_cursor_and_phase(self):
        def src():
            for i in range(6):
                yield (np.full((2, 2), i, np.float32),)

        faults.arm("feeder.device_put", mode="nth", nth=3)
        feeder = DeviceFeeder(src(), device="cpu", depth=2)
        got = []
        with pytest.raises(FeederWorkerError) as ei:
            for b in feeder:
                got.append(b)
        assert ei.value.phase == "device_put" and ei.value.batch_index == 2
        assert len(got) == 2 and not feeder._thread.is_alive()
