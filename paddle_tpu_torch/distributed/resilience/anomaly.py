"""Anomaly detection for the training step
(``paddle_tpu.distributed.resilience.anomaly`` counterpart).

Two tiers, split between the device and the host:

* **The health flag.** With detection on, ``TrainStep`` computes
  ``health = ~isfinite(loss) | any(~isfinite(grad))`` on the device (the
  GradScaler's found-inf convention) and an unhealthy step skips the
  whole optimizer update, so a NaN batch never poisons the parameters
  whatever the policy. The JAX package settles the flag on the host
  lazily; the port reads it once a step, as its GradScaler path does, and
  skips the update that same step.

* **Host-side loss-spike detection.** Finite losses feed a rolling window;
  a loss above ``median + mad_k * 1.4826 * MAD`` of the window is a spike
  (robust to a training curve's ordinary downward drift; MAD rather than
  stddev so one earlier outlier cannot widen the gate).

Escalation policies (``AnomalyDetector(policy=...)``, or the
``FLAGS_anomaly_policy`` default):

* ``warn``       — log the incident and go on (the update of a
                   non-finite step was skipped already).
* ``skip_batch`` — also quarantine the offending batch index so a replay
                   never feeds it again.
* ``rollback``   — request a rollback to the last committed elastic
                   checkpoint (the supervisor performs it).
* ``halt``       — request a structured halt.

The detector only RECORDS and CLASSIFIES; the supervisor
(``resilience.supervisor.run_resilient``) owns the recovery.
"""
from __future__ import annotations

import collections
import math
from dataclasses import dataclass, field

__all__ = ["Anomaly", "AnomalyDetector", "POLICIES"]

POLICIES = ("warn", "skip_batch", "rollback", "halt")


@dataclass
class Anomaly:
    """One detected incident, as data (feeds the JSONL incident log)."""

    kind: str                # "nonfinite" | "loss_spike"
    step: int                # the train-step counter the loss belongs to
    loss: float
    action: str              # the policy in force when it was detected
    detail: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"kind": self.kind, "step": int(self.step),
                "loss": None if math.isnan(self.loss) else float(self.loss),
                "action": self.action, **self.detail}


class AnomalyDetector:
    """Rolling-statistics anomaly detector + escalation bookkeeping.

    `observe(step, loss, health)` is called in dispatch order with SETTLED
    host values (TrainStep feeds it once a step). Healthy losses extend
    the rolling window; anomalies are recorded in `incidents` and — for
    policies beyond "warn" — parked in `pending` until the supervisor
    handles them (`clear_pending`). `reset_history()` drops the rolling
    window (after a rollback the poisoned timeline's losses must not gate
    the replayed one) while keeping the incident record."""

    def __init__(self, policy: str | None = None, window: int | None = None,
                 mad_k: float | None = None, min_history: int | None = None,
                 nonfinite_tolerance: int | None = None):
        from paddle_tpu_torch.core.flags import flag

        self.policy = str(flag("anomaly_policy") if policy is None
                          else policy)
        if self.policy not in POLICIES:
            raise ValueError(f"anomaly policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        self.window = int(flag("anomaly_window") if window is None
                          else window)
        self.mad_k = float(flag("anomaly_mad_k") if mad_k is None
                           else mad_k)
        self.min_history = int(flag("anomaly_min_history")
                               if min_history is None else min_history)
        # non-finite steps to TOLERATE (record, don't escalate) before a
        # streak escalates. 0 = escalate immediately. A step with a DYNAMIC
        # GradScaler raises an UNSET (None) tolerance to 2 automatically: a
        # loss-scale overflow at every growth interval is EXPECTED fp16
        # behavior — the scaler skips the update and halves the scale, so
        # only a streak (a model the scaler cannot bring back) is a real
        # anomaly. An explicit 0 is honored (tolerance_explicit).
        self.tolerance_explicit = nonfinite_tolerance is not None
        self.nonfinite_tolerance = int(nonfinite_tolerance or 0)
        self._nonfinite_streak = 0
        self.history: collections.deque = collections.deque(
            maxlen=max(self.window, 4))
        self.incidents: list[Anomaly] = []
        self.pending: Anomaly | None = None

    # -- classification -------------------------------------------------------
    def _spike_gate(self):
        """(median, threshold) of the current window, or None before
        min_history finite losses have been seen."""
        if len(self.history) < self.min_history:
            return None
        xs = sorted(self.history)
        n = len(xs)
        med = (xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2]))
        devs = sorted(abs(x - med) for x in xs)
        mad = (devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1]
                                                 + devs[n // 2]))
        # sigma floor: a perfectly flat window (MAD 0) must not flag the
        # first ulp of movement as a spike
        sigma = max(1.4826 * mad, 1e-6 * abs(med), 1e-12)
        return med, med + self.mad_k * sigma

    def observe(self, step: int, loss: float, health: float) -> Anomaly | None:
        """One settled step. Returns the Anomaly (also recorded) or None."""
        loss = float(loss)
        if float(health) > 0.0 or not math.isfinite(loss):
            self._nonfinite_streak += 1
            if self._nonfinite_streak <= self.nonfinite_tolerance:
                # scaler-managed overflow territory: record as data (the
                # update was skipped), escalate only a streak
                a = Anomaly("nonfinite", step, loss, "tolerated",
                            {"health": float(health),
                             "streak": self._nonfinite_streak})
                self.incidents.append(a)
                return a
            return self._record(Anomaly(
                "nonfinite", step, loss, self.policy,
                {"health": float(health),
                 "streak": self._nonfinite_streak}))
        self._nonfinite_streak = 0
        gate = self._spike_gate()
        # spikes enter the window too: median+MAD is robust to a few
        # outliers (one spike barely moves the gate), but a GENUINE level
        # shift (lr change, curriculum switch) must migrate the window so
        # the gate adapts instead of flagging every step forever
        self.history.append(loss)
        if gate is not None and loss > gate[1]:
            return self._record(Anomaly(
                "loss_spike", step, loss, self.policy,
                {"median": round(gate[0], 6),
                 "threshold": round(gate[1], 6)}))
        return None

    def _record(self, a: Anomaly) -> Anomaly:
        self.incidents.append(a)
        if self.policy == "warn":
            import warnings

            warnings.warn(
                f"anomaly detected at step {a.step}: {a.kind} "
                f"(loss={a.loss!r}); policy 'warn' — the unhealthy step's "
                f"optimizer update was skipped, training "
                f"continues")
        elif self.pending is None:  # first unhandled anomaly wins
            self.pending = a
        return a

    # -- supervisor interface -------------------------------------------------
    def clear_pending(self):
        self.pending = None

    def reset_history(self):
        """Forget the rolling loss window and the non-finite streak
        (rollback replays start clean)."""
        self.history.clear()
        self._nonfinite_streak = 0
