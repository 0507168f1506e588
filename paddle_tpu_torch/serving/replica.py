"""Serving replica: one ServingEngine behind the fleet transport seam
(``paddle_tpu.serving.replica`` counterpart).

The router never touches an engine directly — it speaks the three-method
transport protocol this module defines (`probe()` / `open_stream()` /
`replica_id`); `InProcessReplica` is an engine and its driver thread in
this process, `HTTPReplica` a client of a serving process's
``/healthz`` + ``/stats`` + ``/generate`` endpoints (``inference/serve.py``,
``ServingEngine.serve_http``). The router cannot tell them apart.

Failure vocabulary (what the router catches and fails over on):

* ``ReplicaDead``   — the replica's driver died (or its process was
  killed): probes and dispatches fail fast, open streams stop emitting.
* ``StreamGap``     — raised BY THE ROUTER when a stream produces no event
  within the gap timeout (a wedged replica, or a dropped dispatch).
* ``StreamCut``     — the transport died mid-stream (connection cut); the
  consumer must re-dispatch without double-emitting tokens.

Chaos points (armed via ``faults.arm()`` or ``FLAGS_fault_injection``):

* ``serving.replica.kill`` — kills the driver thread between steps, the
  in-process stand-in for a replica process dying mid-run (its heartbeat
  goes stale).
* ``serving.replica.slow`` — stalls the driver one beat before the next
  step: a wedged-but-alive replica (liveness green, readiness degrading).
* ``serving.stream.cut``   — cuts one open token stream at the transport
  seam (consumer-visible connection death mid-stream).

Every background thread carries the ``paddle_tpu_torch.serving.`` name
prefix and is joined on close/kill.
"""
from __future__ import annotations

import http.client
import json
import queue as queue_mod
import threading
import time

import numpy as np

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability import tracing as obs_tracing
from paddle_tpu_torch.serving.scheduler import QueueFull

__all__ = ["ReplicaError", "ReplicaDead", "StreamGap", "StreamCut",
           "InProcessReplica", "ReplicaStream", "HTTPReplica",
           "HTTPReplicaStream"]


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
    "new dispatches fail fast, open streams stop emitting, and the "
    "heartbeat goes stale (no clean-exit tombstone)")
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
    fleets (several engines on one card, or one a card). With a TCPStore
    the replica also beats a `RankHeartbeat` (rank == replica_id), so the
    router's liveness view is the same `dead_peers()` training uses: a
    kill leaves the heartbeat stale, a graceful close tombstones it."""

    def __init__(self, engine, replica_id: int = 0, store=None,
                 job_id: str = "serving-fleet",
                 heartbeat_interval_s: float | None = None,
                 slow_stall_s: float = 0.25):
        # a malformed FLAGS_fault_injection spec must fail at replica
        # construction, not at whichever injection site the driver thread
        # hits first
        faults.check_flag_spec()
        self.engine = engine
        self.replica_id = int(replica_id)
        self.job_id = job_id
        self.slow_stall_s = float(slow_stall_s)
        self.dead_cause: str | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._heartbeat = None
        if store is not None:
            from paddle_tpu_torch.distributed.store import RankHeartbeat

            self._heartbeat = RankHeartbeat(store, job_id, self.replica_id,
                                            interval_s=heartbeat_interval_s)
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
        if self._heartbeat is not None:
            # no tombstone: the heartbeat key goes STALE, so dead_peers()
            # names this replica a corpse (a close() exits cleanly)
            self._heartbeat.stop(mark_clean=False)

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
        steps), open streams go silent-then-dead, the heartbeat goes stale.
        The thread is still JOINED (thread hygiene) — a real kill reaps the
        whole process; here only the behavior is replicated, not the leak."""
        self.dead_cause = cause
        self._stop.set()
        self._thread.join(timeout=5.0)
        obs_events.emit("serving", "replica_dead", severity="error",
                        replica=self.replica_id, cause=cause)
        if self._heartbeat is not None:
            self._heartbeat.stop(mark_clean=False)

    def close(self):
        """Graceful shutdown: join the driver, tombstone the heartbeat
        (a clean exit: dead_peers() reports it gone, never a corpse)."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._heartbeat is not None:
            self._heartbeat.stop(mark_clean=True)
            self._heartbeat = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


class HTTPReplicaStream:
    """The HTTP half of `ReplicaStream`: one open /generate response. A
    reader thread drains the chunked ndjson body into a queue;
    `next_event` maps protocol lines into the vocabulary the in-process
    stream speaks — event dicts through, an in-stream ``queue_full`` as
    the typed `QueueFull`, a dead connection or a cut body as StreamCut.
    `close()` tears down the response and the connection (the server's
    generator teardown cancels and releases the request) and joins the
    reader."""

    def __init__(self, rep: "HTTPReplica", conn, resp):
        self.replica = rep
        self._conn = conn
        self._resp = resp
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._closed = False
        self._done_seen = False
        self._reader = threading.Thread(
            target=self._read, daemon=True,
            name=f"paddle_tpu_torch.serving.http.{rep.replica_id}.reader")
        self._reader.start()

    def _read(self):
        try:
            for raw in iter(self._resp.readline, b""):
                raw = raw.strip()
                if raw:
                    self._q.put(("event", raw))
            self._q.put(("eof", None))
        except Exception as e:
            # a close() racing the read lands here too: next_event is never
            # called after close, so the cut marker just drains
            self._q.put(("cut", f"{type(e).__name__}: {e}"))

    def next_event(self, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        while True:
            if faults.fire_check("serving.stream.cut"):
                self.close()
                raise StreamCut(
                    f"HTTP stream to replica {self.replica.replica_id} "
                    f"cut at the transport seam")
            try:
                kind, item = self._q.get(timeout=min(0.02, timeout_s))
            except queue_mod.Empty:
                if time.monotonic() >= deadline:
                    return None
                continue
            if kind == "cut" or (kind == "eof" and not self._done_seen):
                raise StreamCut(
                    f"HTTP stream to replica {self.replica.replica_id} "
                    f"died mid-stream: {item or 'connection closed'}")
            if kind == "eof":
                return {"done": True}   # a read past the terminal event
            try:
                ev = json.loads(item)
            except ValueError:
                raise StreamCut(
                    f"HTTP stream to replica {self.replica.replica_id}: "
                    f"malformed ndjson line {item[:80]!r}")
            if ev.get("done") or "error" in ev:
                self._done_seen = True
            if ev.get("error") == "queue_full":
                # the submit-race refusal arrives in-stream (the headers
                # were out): the 503 path's typed backpressure, no strike
                raise QueueFull(0, 0)
            return ev

    def close(self):
        if self._closed:
            return
        self._closed = True
        for closeable in (self._resp, self._conn):
            try:
                closeable.close()
            except Exception:
                pass
        self._reader.join(timeout=5.0)


class HTTPReplica:
    """The HTTP transport client behind the same three-method seam: speaks
    the ``/healthz`` + ``/stats`` + ``/generate`` ndjson protocol of
    ``inference/serve.py``, so a Router drives a serving process exactly as
    it drives an InProcessReplica (same failover, breaker and drain).
    Connections are per call: one cut stream never poisons a pooled
    socket, and a probe answers on a fresh socket while streams are
    open."""

    def __init__(self, host: str, port: int, replica_id: int = 0,
                 timeout_s: float = 5.0, stream_timeout_s: float = 60.0):
        faults.check_flag_spec()
        self.host = str(host)
        self.port = int(port)
        self.replica_id = int(replica_id)
        self.timeout_s = float(timeout_s)
        self.stream_timeout_s = float(stream_timeout_s)

    def _connect(self):
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)

    def _unreachable(self, e) -> ReplicaDead:
        return ReplicaDead(
            f"replica {self.replica_id} unreachable at "
            f"{self.host}:{self.port}: {type(e).__name__}: {e}")

    def probe(self) -> dict:
        """GET /healthz: the readiness dict InProcessReplica.probe returns
        (the server answers 503 once its driver died, which maps to
        ReplicaDead as a dead in-process driver does)."""
        try:
            conn = self._connect()
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                status, body = resp.status, resp.read()
            finally:
                conn.close()
        except (ConnectionError, OSError, http.client.HTTPException) as e:
            raise self._unreachable(e)
        try:
            st = json.loads(body)
        except ValueError:
            st = {}
        if status != 200 or not st.get("ok", False):
            raise ReplicaDead(
                f"replica {self.replica_id} unhealthy (HTTP {status}): "
                f"{st.get('error') or body[:120]!r}")
        st.setdefault("replica", self.replica_id)
        return st

    def open_stream(self, payload: dict) -> HTTPReplicaStream:
        """POST /generate; returns the streaming handle. A 503 refusal
        (bounded queue) raises QueueFull — backpressure, not ill health —
        a connection failure ReplicaDead, any other non-200 ReplicaError."""
        body = json.dumps(
            {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                 else v)
             for k, v in payload.items() if v is not None}).encode()
        try:
            conn = self._connect()
            with obs_tracing.span(
                    "replica.open_stream", component="replica",
                    trace_id=(str(payload.get("trace"))
                              if payload.get("trace") else None),
                    replica=self.replica_id, transport="http"):
                conn.request("POST", "/generate", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
        except (ConnectionError, OSError, http.client.HTTPException) as e:
            raise self._unreachable(e)
        if resp.status != 200:
            raw = resp.read()
            conn.close()
            if resp.status == 503:
                raise QueueFull(0, 0)
            raise ReplicaError(
                f"replica {self.replica_id} refused dispatch "
                f"(HTTP {resp.status}): {raw[:120]!r}")
        if conn.sock is not None:
            # token gaps are bounded by the router's gap timeout, not the
            # connect timeout: a slow decode step is not a socket death
            conn.sock.settimeout(self.stream_timeout_s)
        return HTTPReplicaStream(self, conn, resp)

    def close(self):
        """Stateless between calls: nothing pooled to tear down (the
        Router calls close(close_transports=True) uniformly)."""
