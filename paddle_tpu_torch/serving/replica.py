"""Serving replica: one ServingEngine behind the fleet transport seam
(``paddle_tpu.serving.replica`` counterpart).

The router never touches an engine directly — it speaks the three-method
transport protocol this module defines (`probe()` / `open_stream()` /
`replica_id`); `InProcessReplica` is an engine and its driver thread in
this process.

Failure vocabulary (what the router catches and fails over on):

* ``ReplicaDead``   — the replica's driver died (or its process was
  killed): probes and dispatches fail fast, open streams stop emitting.
* ``StreamGap``     — raised BY THE ROUTER when a stream produces no event
  within the gap timeout (a wedged replica, or a dropped dispatch).
* ``StreamCut``     — the transport died mid-stream (connection cut); the
  consumer must re-dispatch without double-emitting tokens.

Chaos points (armed via ``faults.arm()`` or ``FLAGS_fault_injection``):

* ``serving.replica.kill`` — kills the driver thread between steps, the
  in-process stand-in for a replica process dying mid-run.
* ``serving.replica.slow`` — stalls the driver one beat before the next
  step: a wedged-but-alive replica (liveness green, readiness degrading).
* ``serving.stream.cut``   — cuts one open token stream at the transport
  seam (consumer-visible connection death mid-stream).

Every background thread carries the ``paddle_tpu_torch.serving.`` name
prefix and is joined on close/kill.

Not ported yet: the heartbeat liveness of ``store=`` (a TCPStore
``RankHeartbeat``), which needs the port's ``distributed/store.py``
(ROADMAP A8); passing a store raises NotImplementedError. The JAX
module's HTTP client transport (``HTTPReplica``) waits for a caller
(ROADMAP A4).
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time

import numpy as np

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability import tracing as obs_tracing

__all__ = ["ReplicaError", "ReplicaDead", "StreamGap", "StreamCut",
           "InProcessReplica", "ReplicaStream"]


class ReplicaError(RuntimeError):
    """Base of the transport failure vocabulary: any dispatch/probe/stream
    failure the router treats as 'this replica failed me, fail over'."""


class ReplicaDead(ReplicaError):
    """The replica's driver is gone (crashed or killed)."""


class StreamGap(ReplicaError):
    """No stream event within the gap timeout — the request-level wedge
    signal (covers both a stalled replica and a dispatch lost in transit,
    which produce the same observable: silence)."""


class StreamCut(ReplicaError):
    """The transport died mid-stream."""


faults.register(
    "serving.replica.kill",
    "kill the replica's engine driver thread between decode steps — the "
    "in-process stand-in for a replica process dying mid-run; probes and "
    "new dispatches fail fast and open streams stop emitting")
faults.register(
    "serving.replica.slow",
    "stall the replica driver one beat before its next decode step — a "
    "wedged-but-alive replica whose liveness stays green while queue "
    "depth and oldest-wait-age degrade")
faults.register(
    "serving.stream.cut",
    "cut one open token stream at the transport seam — the consumer sees "
    "the connection die mid-stream and must fail over to a peer without "
    "double-emitting tokens")


class ReplicaStream:
    """One open token stream: the consumer half of a dispatch. Events are
    pulled with `next_event(timeout_s)` -> ``{"token": t}`` per token,
    ``{"done": True, ...}`` at completion, or None when nothing arrived
    within `timeout_s` (gap accounting is the CALLER's job — a None is a
    slice of silence, not a verdict). Raises ReplicaDead/StreamCut.
    `close()` cancels + releases the request's engine bookkeeping on every
    exit path — per-request state must never outlive the stream."""

    def __init__(self, rep: "InProcessReplica", req, q):
        self.replica = rep
        self.req = req
        self.q = q
        self._closed = False

    def next_event(self, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        while True:
            if faults.fire_check("serving.stream.cut"):
                self.close()
                raise StreamCut(
                    f"stream for rid {self.req.rid} cut at the transport "
                    f"seam (replica {self.replica.replica_id})")
            if self.replica.dead_cause is not None:
                raise ReplicaDead(
                    f"replica {self.replica.replica_id} died mid-stream: "
                    f"{self.replica.dead_cause}")
            try:
                tok = self.q.get(timeout=min(0.02, timeout_s))
            except queue_mod.Empty:
                if self.req.finished and self.q.empty():
                    return {"done": True, "state": self.req.state.value}
                if time.monotonic() >= deadline:
                    return None
                continue
            return {"token": int(tok)}

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self.replica.dead_cause is not None:
            return  # a dead process keeps no bookkeeping worth releasing
        with self.replica._lock:
            eng = self.replica.engine
            if not self.req.finished:
                eng.cancel(self.req.rid)
            eng.release(self.req.rid)


class InProcessReplica:
    """A ServingEngine + its driver thread behind the transport seam —
    the thread analog of one replica process, for tests and single-host
    fleets (several engines on one card, or one a card)."""

    def __init__(self, engine, replica_id: int = 0, store=None,
                 slow_stall_s: float = 0.25):
        # a malformed FLAGS_fault_injection spec must fail at replica
        # construction, not at whichever injection site the driver thread
        # hits first
        faults.check_flag_spec()
        self.engine = engine
        self.replica_id = int(replica_id)
        self.slow_stall_s = float(slow_stall_s)
        self.dead_cause: str | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        if store is not None:
            raise NotImplementedError(
                "replica heartbeats (store=) are not ported to "
                "paddle_tpu_torch yet: they need distributed/store.py "
                "(ROADMAP A8)")
        self._thread = threading.Thread(
            target=self._drive, daemon=True,
            name=f"paddle_tpu_torch.serving.replica.{self.replica_id}")
        self._thread.start()

    # ---- the driver loop --------------------------------------------------
    def _drive(self):
        while not self._stop.is_set():
            try:
                faults.point("serving.replica.kill")
                if faults.fire_check("serving.replica.slow"):
                    time.sleep(self.slow_stall_s)
                with self._lock:
                    busy = self.engine.busy
                    if busy:
                        self.engine.step()
            except BaseException as e:
                self._mark_dead(f"{type(e).__name__}: {e}")
                return
            if not busy:
                self._stop.wait(0.002)

    def _mark_dead(self, cause: str):
        self.dead_cause = cause
        self._stop.set()
        obs_events.emit("serving", "replica_dead", severity="error",
                        replica=self.replica_id, cause=cause)

    # ---- transport protocol ------------------------------------------------
    def probe(self) -> dict:
        """Readiness + liveness snapshot — the dict /stats serves over
        HTTP. Lock-free by design: a probe must answer while the driver
        holds the step lock (the monitoring reads are GIL-atomic ints)."""
        if self.dead_cause is not None:
            raise ReplicaDead(
                f"replica {self.replica_id} is dead: {self.dead_cause}")
        return {"ok": True, "replica": self.replica_id,
                **self.engine.stats()}

    def open_stream(self, payload: dict) -> ReplicaStream:
        """Dispatch one request; returns its ReplicaStream. Raises
        ReplicaDead (dead replica) or scheduler.QueueFull (bounded waiting
        queue pushed back — admission backpressure, not ill health)."""
        if self.dead_cause is not None:
            raise ReplicaDead(
                f"replica {self.replica_id} is dead: {self.dead_cause}")
        q = queue_mod.Queue()
        with obs_tracing.span(
                "replica.open_stream", component="replica",
                trace_id=(str(payload.get("trace")) if payload.get("trace")
                          else None),
                replica=self.replica_id):
            with self._lock:
                rid = self.engine.submit(
                    np.asarray(payload["prompt_ids"], np.int32),
                    max_new_tokens=int(payload.get("max_new_tokens", 16)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=int(payload.get("top_k", 0)),
                    top_p=float(payload.get("top_p", 1.0)),
                    eos_id=payload.get("eos_id"),
                    stream_cb=lambda req, tok: q.put(tok),
                    adapter=(str(payload["adapter"])
                             if payload.get("adapter") else None),
                    tenant=str(payload.get("tenant") or ""))
                req = self.engine.scheduler.get(rid)
                # the trace id rides the Request like the sampling knobs:
                # engine spans (prefill -> scheduler.admit -> decode step)
                # correlate with the router's without any signature change
                req.trace_id = str(payload.get("trace") or "")
        return ReplicaStream(self, req, q)

    # ---- lifecycle ---------------------------------------------------------
    def kill(self, cause: str = "killed"):
        """Simulated kill -9: the driver stops where it stands (between
        steps), open streams go silent-then-dead.
        The thread is still JOINED (thread hygiene) — a real kill reaps the
        whole process; here only the behavior is replicated, not the leak."""
        self.dead_cause = cause
        self._stop.set()
        self._thread.join(timeout=5.0)
        obs_events.emit("serving", "replica_dead", severity="error",
                        replica=self.replica_id, cause=cause)

    def close(self):
        """Graceful shutdown: join the driver."""
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False
