"""Self-healing training supervisor: detect -> decide -> recover
(``paddle_tpu.distributed.resilience.supervisor`` counterpart).

``run_resilient()`` owns one training run end to end and keeps it alive
through the faults a real cluster throws at it:

* **Anomalies** (a NaN/inf loss or gradient, a host-side loss spike): the
  step's health flag feeds an ``AnomalyDetector``; escalation follows its
  policy: warn / skip_batch (quarantine the batch index) / rollback /
  halt.
* **Rollback**: restore the last COMMITTED elastic checkpoint
  (``CheckpointManager.latest()/load()``), move the data cursor to the
  snapshot's ``batches`` position (the ``DeviceFeeder.batches_consumed``
  convention), skip quarantined batches, and continue. A replayed healthy
  segment repeats the fault-free trajectory bit for bit (parameters,
  moments and the step count restore exactly, and the step's kernels sum
  in a fixed order), so a transient fault costs time, never trajectory. A
  batch that anomalies AGAIN after a replay is quarantined as persistent
  poison, and a bounded rollback budget turns a persistent fault into a
  structured ``ResilienceHalt`` (with the incident report) instead of a
  loop.
* **Feeder crashes**: a ``FeederWorkerError`` (cursor and phase attached)
  is logged and the input pipeline rebuilt at the consumed cursor,
  bounded by ``max_feeder_retries``.
* **Checkpoint-save failures**: async save errors are reaped from their
  handles, logged, and retried at the next cadence; the previous committed
  snapshot stays loadable throughout.
* **Hangs / preemption**: the watchdog's hang listener runs the
  save-and-stop path; the supervisor then RESTARTS in-process from the
  checkpoint that path committed (a SIGTERM preemption ends the run with
  status "preempted"). The ``watchdog.hang`` fault point simulates a hung
  step.

Every event lands in a JSONL incident log (``IncidentLog``) and in the
event journal (``observability.events``): anomaly / rollback / quarantine
/ feeder_crash / ckpt_save_failed / hang / restart / halt records with
step, data cursor, cause and recovery time.

The batches go through the port's ``DeviceFeeder`` on the step's device
(``device=``, default ``step.device``); the JAX package's ``mesh=``
placement is not ported (ROADMAP A8).
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.distributed.resilience.anomaly import AnomalyDetector

__all__ = ["ResiliencePolicy", "ResilienceHalt", "IncidentLog",
           "run_resilient"]

faults.register(
    "watchdog.hang",
    "simulate a hung step: the supervisor registers a stalled readback "
    "with its watchdog, driving the real hang-listener save-and-exit path "
    "and the in-process restart (fire_check site)")


@dataclass
class ResiliencePolicy:
    """Budgets and escalation knobs for one supervised run."""

    anomaly: str = "rollback"        # AnomalyDetector policy
    max_rollbacks: int = 3           # total rollback budget for the run
    max_feeder_retries: int = 2      # input-pipeline rebuilds
    max_save_failures: int = 3       # failed checkpoint saves before halt
    hang_restart: bool = True        # hang -> in-process restart (vs exit)
    hang_timeout_s: float = 600.0    # watchdog timeout for watched steps


class ResilienceHalt(RuntimeError):
    """A persistent fault exhausted its budget: carries the structured
    incident report instead of looping forever."""

    def __init__(self, reason: str, report: dict):
        super().__init__(f"{reason}; incident report: "
                         f"{json.dumps(report, default=str)[:2000]}")
        self.report = report


class IncidentLog:
    """JSONL incident log: one self-describing line per event, flushed
    immediately (the log must survive the very crash it describes)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.events: list[dict] = []
        self._f = open(path, "a") if path else None

    def emit(self, event: str, **fields):
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        self.events.append(rec)
        if self._f is not None:
            self._f.write(json.dumps(rec, default=str) + "\n")
            self._f.flush()
        # every incident also lands in the event journal (one schema
        # across resilience and serving), with a severity by event class
        from paddle_tpu_torch.observability import events as _events

        severity = ("error" if event in ("halt", "hang", "ckpt_save_failed")
                    else "warn" if event in ("anomaly", "rollback",
                                             "quarantine", "feeder_crash",
                                             "feeder_retry", "restart")
                    else "info")
        _events.emit("resilience", event, severity=severity,
                     **{k: v for k, v in fields.items()
                        if k not in ("ts", "component", "severity")})
        return rec

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


class _Stalled:
    """A readback that never completes inside the watchdog timeout — the
    simulated hung collective behind the `watchdog.hang` fault point."""

    def __init__(self, sleep_s: float):
        self.sleep_s = sleep_s

    def __array__(self, dtype=None):
        import numpy as np

        time.sleep(self.sleep_s)
        return np.zeros((), np.float32)


def run_resilient(make_step, make_data, total_batches: int, ckpt_dir: str,
                  *, policy: ResiliencePolicy | None = None,
                  detector: AnomalyDetector | None = None,
                  ckpt_every: int = 8, feed_depth: int = 2,
                  device=None,
                  incident_log: IncidentLog | str | None = None,
                  store=None, world_size: int | None = None,
                  rank: int | None = None, watchdog_manager=None,
                  heartbeat: bool = False) -> dict:
    """Supervised training loop over `total_batches` batches.

    make_step(detector, arrays=None, meta=None) -> TrainStep:
        build (or, with a loaded snapshot, RESTORE then build) the step;
        the callable owns model/optimizer construction and must pass
        `anomaly_detector=detector` through, plus `load_resume_extras`
        when arrays are given. Called once at start and once per
        rollback/restart.
    make_data(start) -> iterator yielding batch `start`, `start+1`, ...
        (tuples `step(*batch)` or dicts `step(batch)`); MUST be
        deterministic by index for replays to be bit-exact.

    Returns a report dict: status ("ok" | "preempted" | raises
    ResilienceHalt), per-batch losses, incidents, recovery stats, and the
    checkpoint manager's per-save timings (``ckpt_timings``).
    """
    from paddle_tpu_torch.distributed import watchdog as wd_mod
    from paddle_tpu_torch.distributed.checkpoint import elastic
    from paddle_tpu_torch.io.device_feed import (DeviceFeeder,
                                                 FeederWorkerError,
                                                 LossFuture)

    pol = policy or ResiliencePolicy()
    det = detector or AnomalyDetector(policy=pol.anomaly)
    # a malformed FLAGS_fault_injection spec must fail HERE, not at the
    # first injection site hit (which may be the feeder worker thread,
    # where the ValueError would be wrapped as FeederWorkerError and
    # burn the feeder-retry budget on a config typo)
    faults.check_flag_spec()
    owns_log = not isinstance(incident_log, IncidentLog)
    log = (incident_log if isinstance(incident_log, IncidentLog)
           else IncidentLog(incident_log))
    mgr = elastic.CheckpointManager(ckpt_dir, store=store,
                                    world_size=world_size, rank=rank)
    wd = watchdog_manager or wd_mod.CommTaskManager(
        default_timeout_s=pol.hang_timeout_s, poll_interval_s=0.05)
    state = {"step": None, "cursor": 0}

    def _capture():
        return elastic.capture(state["step"],
                               cursor={"batches": state["cursor"]})

    hb = None
    if heartbeat and store is not None:
        from paddle_tpu_torch.distributed.store import RankHeartbeat

        hb = RankHeartbeat(store, mgr.job_id, mgr.rank)
    uninstall_hang = elastic.install_hang_handler(mgr, _capture,
                                                  watchdog_manager=wd)

    losses: dict[int, object] = {}     # batch idx -> LossFuture | float
    unsettled: deque[int] = deque()    # dispatch-ordered keys still futures
    stepmap: dict[int, int] = {}       # step counter -> batch idx
    quarantined: set[int] = set()
    anomaly_counts: dict[int, int] = {}
    save_handles: list = []
    counters = {"rollbacks": 0, "feeder_retries": 0, "save_failures": 0,
                "hang_restarts": 0}
    status = "ok"

    def _report():
        return {"status": status, "batches": total_batches,
                "cursor": state["cursor"], "quarantined": sorted(quarantined),
                "incidents": list(log.events), **counters}

    def _settle_losses():
        """Fold finished loss futures into plain floats so a long run holds
        O(run-ahead window) device buffers, not one per batch ever trained.
        Non-blocking: stops at the first still-computing future (dispatch
        order == completion order on one stream). Replays may re-enqueue an
        index whose earlier future already settled — the isinstance guard
        makes such duplicates a no-op."""
        while unsettled:
            f = losses.get(unsettled[0])
            if isinstance(f, LossFuture):
                if not f.ready():
                    break
                losses[unsettled[0]] = f.value()
            unsettled.popleft()
        if len(stepmap) > 512:
            # anomaly settling lags dispatch by at most the run-ahead
            # window, so steps far behind the newest are unreachable
            horizon = max(stepmap) - 256
            for s in [s for s in stepmap if s < horizon]:
                del stepmap[s]

    def _reap_saves(block=False):
        live = []
        for h in save_handles:
            if not h.done() and not block:
                live.append(h)
                continue
            try:
                h.wait()
                err = None
            except Exception as e:
                err = e
            if isinstance(err, FileExistsError):
                err = None  # a replay re-committed an already-durable step
            if err is not None:
                counters["save_failures"] += 1
                log.emit("ckpt_save_failed", step=h.step,
                         cursor=state["cursor"], cause=repr(err))
                if counters["save_failures"] > pol.max_save_failures:
                    raise ResilienceHalt(
                        f"checkpoint saves failed "
                        f"{counters['save_failures']} times", _report())
        save_handles[:] = live

    def _restore_from_latest(cause: str, anomaly=None,
                             before_step: int | None = None):
        """Rollback/restart: restore the newest committed snapshot (older
        than `before_step` when the previous rollback target itself looks
        poisoned), rebuild the step, move the data cursor to the snapshot's
        position. In-flight async saves are flushed FIRST so `latest()`
        reflects every commit that was already queued."""
        t0 = time.perf_counter()
        _reap_saves(block=True)
        candidates = [s for s in mgr.steps()
                      if before_step is None or s < before_step]
        if not candidates:
            raise ResilienceHalt(
                f"{cause} but no committed checkpoint "
                f"{'older than step ' + str(before_step) if before_step else ''} "
                f"exists to roll back to", _report())
        target = max(candidates)
        arrays, meta = mgr.load(target)
        new_cursor = int((meta.get("cursor") or {}).get("batches", 0))
        state["step"] = make_step(det, arrays, meta)
        state["cursor"] = new_cursor
        state["last_rb_step"] = target
        det.reset_history()
        det.clear_pending()
        rec = log.emit("rollback" if anomaly is not None else "restart",
                       to_step=target, cursor=new_cursor, cause=cause,
                       recovery_ms=round((time.perf_counter() - t0) * 1e3, 2))
        return rec

    def _handle_anomaly(a):
        """Escalate one settled anomaly. Returns True when the step was
        restored from a snapshot (the caller must rebuild the input
        pipeline at the rewound cursor); warn/skip_batch leave params,
        step and cursor untouched (the step's health skip already
        kept the poison out of the update) so the run continues in
        place."""
        idx = stepmap.get(a.step, state["cursor"] - 1)
        log.emit("anomaly", batch=idx, cursor=state["cursor"], **a.to_json())
        if a.action == "warn":
            det.clear_pending()
            return False
        if a.action == "halt":
            raise ResilienceHalt(
                f"anomaly at step {a.step} with policy 'halt'", _report())
        anomaly_counts[idx] = anomaly_counts.get(idx, 0) + 1
        if a.action == "skip_batch" or anomaly_counts[idx] >= 2:
            # persistent poison (or the skip policy): never feed it again
            quarantined.add(idx)
            log.emit("quarantine", batch=idx, step=a.step,
                     recurrences=anomaly_counts[idx])
            if a.action == "skip_batch":
                det.clear_pending()
                return False
        counters["rollbacks"] += 1
        if counters["rollbacks"] > pol.max_rollbacks:
            raise ResilienceHalt(
                f"rollback budget ({pol.max_rollbacks}) exhausted — "
                f"persistent fault", _report())
        state["step"].drain()
        # poison-window guard: an anomaly RIGHT after a restore means the
        # restored snapshot itself captured poisoned state (detection lag
        # can outrun the save cadence) — step back past it
        before = None
        last_rb = state.get("last_rb_step")
        if last_rb is not None and a.step <= last_rb + 2:
            before = last_rb
        _restore_from_latest(f"anomaly:{a.kind}@step{a.step}", anomaly=a,
                             before_step=before)
        return True

    try:
        state["step"] = make_step(det, None, None)
        # a step-0 snapshot so the very first anomaly has a rollback target
        mgr.save(_capture())
        def _maybe_simulate_hang():
            if faults.fire_check("watchdog.hang"):
                # drive the REAL hang machinery: a stalled readback under a
                # tight timeout fires the listener (save + request_preempt)
                wd_mod.watch_step(_Stalled(1.0), name="chaos_hung_step",
                                  timeout_s=0.15, manager=wd)
                deadline = time.time() + 30.0
                while not mgr.should_stop and time.time() < deadline:
                    time.sleep(0.02)

        while state["cursor"] < total_batches:
            if mgr.should_stop:
                reason = mgr.preempt_reason or ""
                if reason.startswith("hang") and pol.hang_restart:
                    counters["hang_restarts"] += 1
                    log.emit("hang", cursor=state["cursor"], cause=reason)
                    mgr.clear_preempt()
                    _restore_from_latest(reason)
                else:
                    log.emit("preempted", cursor=state["cursor"],
                             cause=reason)
                    status = "preempted"
                    break
            base = state["cursor"]
            feeder = DeviceFeeder(make_data(base),
                                  device=(device if device is not None
                                          else state["step"].device),
                                  depth=feed_depth)
            try:
                for batch in feeder:
                    idx = base + feeder.batches_consumed - 1
                    state["cursor"] = idx + 1
                    if idx in quarantined:
                        log.emit("skip_quarantined", batch=idx)
                        continue
                    step = state["step"]
                    if isinstance(batch, dict):
                        f = step.step_async(batch)
                    else:
                        f = step.step_async(*batch)
                    losses[idx] = f
                    unsettled.append(idx)
                    stepmap[step.step_count] = idx
                    _maybe_simulate_hang()
                    if mgr.should_stop:
                        break  # the outer loop restarts (hang) or exits
                    step.settle_anomalies()
                    _settle_losses()
                    if det.pending is not None:
                        if _handle_anomaly(det.pending):
                            break  # the feeder restarts at the new cursor
                    if ckpt_every and state["cursor"] % ckpt_every == 0:
                        save_handles.append(mgr.save_async(_capture()))
                    _reap_saves()
                else:
                    # stream exhausted: settle the run-ahead tail, then give
                    # late-settling anomalies one more escalation pass
                    state["step"].drain()
                    state["step"].settle_anomalies(block=True)
                    if det.pending is not None:
                        _handle_anomaly(det.pending)
            except FeederWorkerError as e:
                counters["feeder_retries"] += 1
                log.emit("feeder_crash", phase=e.phase,
                         batch=base + e.batch_index,
                         cursor=base + feeder.batches_consumed,
                         cause=repr(e.__cause__))
                if counters["feeder_retries"] > pol.max_feeder_retries:
                    raise ResilienceHalt(
                        f"feeder crashed {counters['feeder_retries']} "
                        f"times", _report()) from e
                state["cursor"] = base + feeder.batches_consumed
            finally:
                feeder.close()
        if status == "ok" and state["cursor"] >= total_batches:
            # errors are reaped (and counted) per handle; the manager's own
            # wait() would re-raise faults the budget already absorbed
            _reap_saves(block=True)
    finally:
        uninstall_hang()
        if watchdog_manager is None:
            wd.stop()
        if hb is not None:
            hb.stop()
        mgr.close()
        if owns_log:
            # only close logs this function opened: a caller-provided
            # IncidentLog may span several runs (closing it here would
            # silently stop persisting the next run's events)
            log.close()

    report = _report()
    report["ckpt_timings"] = list(mgr.timings)
    report["losses"] = {int(i): float(f) for i, f in sorted(losses.items())
                        if int(i) < total_batches
                        and int(i) not in quarantined}
    if losses:
        last = max(i for i in losses if int(i) not in quarantined)
        report["final_loss"] = float(losses[last])
    return report
