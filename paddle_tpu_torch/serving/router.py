"""Fleet-front router: health-aware dispatch over N serving replicas
(``paddle_tpu.serving.router`` counterpart).

The router sits in front of N replicas (the `replica.py` transport seam —
in-process engines, or HTTP clients of serving processes) and keeps the
self-healing guarantee for serving traffic: an accepted request either
completes or returns ONE clean typed error, never hangs, and a killed
replica costs bounded failover time, never correctness.

The machinery, in the order a request meets it:

1. **Admission control** — a hard in-flight cap; past it the request is
   refused with 503 + Retry-After BEFORE any replica dispatch (the
   `serve.py` front-end consults `admission_check` pre-headers).
2. **Shed policy** — past the aggregate-depth watermark the router caps
   `max_new_tokens` (degrade before drop); the done event carries
   ``"shed": true`` so callers know.
3. **Placement** — the request's placement key rendezvous-hashes onto a
   healthy replica (minimal remap on membership change). With
   ``router_placement=session`` (default) the key is the ``session`` id,
   so follow-up turns land on the replica holding their KV pages; with
   ``router_placement=prefix`` it is a digest of the prompt's first
   ``router_prefix_tokens`` ids, so requests SHARING a system prompt land
   where its pages already live (session id stays the tiebreak for
   promptless payloads). Unkeyed requests go to the least-loaded replica
   (router in-flight + probed queue depth + slot fill).
4. **Relay with failover** — events are relayed with a gap timeout; a
   dead/wedged replica, cut stream, or dropped dispatch triggers a
   bounded re-dispatch (exponential backoff, `dispatch_attempts` total)
   to a peer. The peer re-prefills from the prompt and the router skips
   the already-delivered prefix, so greedy streams continue EXACTLY
   (the eviction-equivalence contract); exhausted attempts yield one
   typed error event.
5. **Health monitor** — a background thread probes every replica each
   `probe_interval_s`. Consecutive probe/dispatch failures trip
   a per-replica circuit breaker (CLOSED -> OPEN -> HALF_OPEN -> CLOSED);
   tripping DRAINS the replica: its in-flight requests are signalled, in
   arrival order, to fail over to peers instead of timing out users.

Chaos: ``serving.dispatch.drop`` registers here (a dispatch lost in
transit — nothing ever arrives, detection bound = the gap timeout);
``serving.replica.kill/slow`` and ``serving.stream.cut`` live in
replica.py. All are driven by the fault registry / FLAGS_fault_injection.

Stream event contract (what `stream()` yields — also the ndjson lines of
the HTTP front-end): ``{"token": t}`` per token, then exactly one
terminal event — ``{"done": true, "tokens", "replica", "failovers"[,
"shed"]}`` or ``{"error": kind, "message", "tokens", "failovers"[,
"retry_after"]}`` with kind one of ``refused | tenant_limit |
queue_full | no_healthy_replica | timeout | failover_exhausted |
adapter_load_failed``.

Liveness (``store=``): with a TCPStore, each health pass first reads the
replicas' heartbeats (``distributed.store.dead_peers``, rank ==
replica_id, job ``job_id``); a replica whose heartbeat went stale trips
its breaker by name before any probe runs.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.lora.store import AdapterLoadError
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import tracing as obs_tracing
from paddle_tpu_torch.serving.replica import ReplicaError, StreamGap
from paddle_tpu_torch.serving.scheduler import QueueFull

__all__ = ["Router", "RouterConfig", "rendezvous_order", "backoff_delays"]


faults.register(
    "serving.dispatch.drop",
    "drop one router->replica dispatch in transit: the request is never "
    "submitted and no event ever arrives — the router must detect the "
    "silence within the gap timeout and re-dispatch to a peer")


def rendezvous_order(key: str, replica_ids) -> list:
    """Highest-random-weight (rendezvous) ranking of `replica_ids` for
    `key`: every (key, id) pair gets an independent uniform score, the
    ranking is the descending sort. Removing an id only reassigns the keys
    that ranked it FIRST (minimal remap); adding one steals only the keys
    that now rank it first — no ring, no global remap."""
    def score(rid):
        h = hashlib.blake2b(f"{key}\x00{rid}".encode(), digest_size=8)
        return int.from_bytes(h.digest(), "big")

    return sorted(replica_ids, key=lambda r: (-score(r), r))


def backoff_delays(attempts: int, initial_s: float, max_s: float) -> list:
    """The sleep before each failover re-dispatch: initial * 2^k, capped.
    `attempts` total dispatches -> attempts-1 delays (none before the
    first try)."""
    return [min(initial_s * (2 ** k), max_s) for k in range(attempts - 1)]


@dataclass
class RouterConfig:
    """Zero/negative fields resolve from the FLAGS_router_* knobs (the
    ServingConfig idiom), so fleet deployments are flag-driven and tests
    pin explicit values."""
    probe_interval_s: float = 0.0     # 0 -> FLAGS_router_probe_interval_s
    failure_threshold: int = 0        # 0 -> FLAGS_router_failure_threshold
    breaker_cooldown_s: float = 0.0   # 0 -> FLAGS_router_breaker_cooldown_s
    dispatch_attempts: int = 0        # 0 -> FLAGS_router_dispatch_attempts
    backoff_initial_s: float = 0.0    # 0 -> FLAGS_router_backoff_initial_s
    backoff_max_s: float = 0.0        # 0 -> FLAGS_router_backoff_max_s
    gap_timeout_s: float = 0.0        # 0 -> FLAGS_router_gap_timeout_s
    max_inflight: int = 0             # 0 -> FLAGS_router_max_inflight
    shed_queue_depth: int = -1        # <0 -> FLAGS_router_shed_queue_depth
    shed_max_new_tokens: int = 0      # 0 -> FLAGS_router_shed_max_new_tokens
    retry_after_s: float = 0.0        # 0 -> FLAGS_router_retry_after_s
    placement: str = ""               # "" -> FLAGS_router_placement
    prefix_tokens: int = 0            # 0 -> FLAGS_router_prefix_tokens
    tenant_max_inflight: int = -1     # <0 -> FLAGS_router_tenant_max_inflight
                                      #   (0 = no per-tenant cap)

    def resolved(self) -> "RouterConfig":
        from paddle_tpu_torch.core.flags import flag

        def pick(v, name, cast):
            return cast(v) if v > 0 else cast(flag(name))

        placement = (self.placement or str(flag("router_placement"))).lower()
        if placement not in ("session", "prefix", "adapter"):
            raise ValueError(f"router_placement must be 'session', "
                             f"'prefix' or 'adapter', got {placement!r}")

        return RouterConfig(
            probe_interval_s=pick(self.probe_interval_s,
                                  "router_probe_interval_s", float),
            failure_threshold=pick(self.failure_threshold,
                                   "router_failure_threshold", int),
            breaker_cooldown_s=pick(self.breaker_cooldown_s,
                                    "router_breaker_cooldown_s", float),
            dispatch_attempts=pick(self.dispatch_attempts,
                                   "router_dispatch_attempts", int),
            backoff_initial_s=pick(self.backoff_initial_s,
                                   "router_backoff_initial_s", float),
            backoff_max_s=pick(self.backoff_max_s,
                               "router_backoff_max_s", float),
            gap_timeout_s=pick(self.gap_timeout_s,
                               "router_gap_timeout_s", float),
            max_inflight=pick(self.max_inflight,
                              "router_max_inflight", int),
            shed_queue_depth=(int(self.shed_queue_depth)
                              if self.shed_queue_depth >= 0
                              else int(flag("router_shed_queue_depth"))),
            shed_max_new_tokens=pick(self.shed_max_new_tokens,
                                     "router_shed_max_new_tokens", int),
            retry_after_s=pick(self.retry_after_s,
                               "router_retry_after_s", float),
            placement=placement,
            prefix_tokens=pick(self.prefix_tokens,
                               "router_prefix_tokens", int),
            tenant_max_inflight=(int(self.tenant_max_inflight)
                                 if self.tenant_max_inflight >= 0
                                 else int(flag(
                                     "router_tenant_max_inflight"))))


_ROUTER_COUNTERS = ("accepted", "completed", "failed", "refused",
                    "failovers", "sheds", "drained", "tenant_refused")
_CIRCUIT_CODE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


def _register_router_metrics(router: "Router"):
    """Scrape-time collector: the router's monotonic counters mirror into
    `router_<name>_total` counters and each replica's breaker state into
    the `router_replica_circuit` gauge (0 closed / 1 half-open / 2 open)
    — the /metrics view of the SAME numbers stats() serves."""
    import weakref

    ref = weakref.ref(router)

    def collect(reg):
        r = ref()
        if r is None:
            return
        with r._lock:
            counts = {k: getattr(r, k) for k in _ROUTER_COUNTERS}
            circuits = {s.rid: (s.circuit, s.draining, s.dispatches)
                        for s in r._slots.values()}
            inflight = len(r._inflight)
        for k, v in counts.items():
            reg.counter(f"router_{k}_total",
                        f"router lifetime total: {k}")._default_child() \
                ._set_total(float(v))
        reg.gauge("router_in_flight",
                  "requests currently in flight through the router").set(
            float(inflight))
        for rid, (circuit, draining, dispatches) in circuits.items():
            reg.gauge("router_replica_circuit",
                      "replica breaker state: 0 closed, 1 half-open, "
                      "2 open", labels=("replica",)).labels(
                replica=str(rid)).set(_CIRCUIT_CODE[circuit])
            reg.gauge("router_replica_draining",
                      "1 while the replica is draining for maintenance",
                      labels=("replica",)).labels(
                replica=str(rid)).set(1.0 if draining else 0.0)
            reg.gauge("router_replica_dispatches",
                      "router-side in-flight dispatches on the replica",
                      labels=("replica",)).labels(
                replica=str(rid)).set(float(dispatches))

    obs_metrics.registry().add_collector(collect, owner=router)


@dataclass
class _Slot:
    """Per-replica router state: the circuit breaker + last probe view."""
    transport: object
    rid: int
    circuit: str = "closed"            # closed | open | half_open
    draining: bool = False
    consecutive_failures: int = 0
    opened_t: float = 0.0
    trips: int = 0
    last_cause: str = ""
    probe: dict = field(default_factory=dict)
    probe_err: str | None = None
    dispatches: int = 0                # router-side in-flight on this replica


@dataclass
class _Dispatch:
    """One accepted request's router-side context (dropped the moment its
    stream terminates — a failover must not retain per-request state)."""
    seq: int
    arrival_t: float
    abort: threading.Event
    abort_why: str = ""
    replica_id: int | None = None
    tenant: str = ""                   # fairness-cap accounting key


class _Drained(Exception):
    """Internal: this dispatch was signalled to leave its replica (breaker
    trip or explicit drain) — fail over now instead of waiting for the
    gap timeout."""


class Router:
    def __init__(self, transports, config: RouterConfig | None = None,
                 store=None, job_id: str = "serving-fleet",
                 dead_timeout_s: float | None = None,
                 start_monitor: bool = True):
        # a malformed chaos spec fails here, not at the first site hit
        faults.check_flag_spec()
        self.cfg = (config or RouterConfig()).resolved()
        self._slots: dict[int, _Slot] = {}
        for t in transports:
            rid = int(t.replica_id)
            if rid in self._slots:
                raise ValueError(f"duplicate replica_id {rid}")
            self._slots[rid] = _Slot(transport=t, rid=rid)
        if not self._slots:
            raise ValueError("router needs at least one replica transport")
        self._store = store
        self._job_id = job_id
        self._dead_timeout_s = dead_timeout_s
        self._hb_watch: dict = {}
        self._lock = threading.RLock()
        self._inflight: dict[int, _Dispatch] = {}
        self._seq = 0
        # counters (stats(): the operator's one-glance failure story)
        self.accepted = 0
        self.completed = 0
        self.failed = 0
        self.refused = 0
        self.failovers = 0
        self.sheds = 0
        self.drained = 0
        self.tenant_refused = 0
        # per-tenant in-flight counts (the fairness-cap ledger; tenant
        # field, adapter id fallback — entries die with their streams)
        self._tenant_inflight: dict[str, int] = {}
        self.monitor_errors: list[str] = []
        self._stop = threading.Event()
        _register_router_metrics(self)
        self._monitor_thread = None
        if start_monitor:
            self._monitor_thread = threading.Thread(
                target=self._monitor, daemon=True,
                name="paddle_tpu_torch.serving.router.monitor")
            self._monitor_thread.start()

    # ------------------------------------------------------------------
    # health monitoring + circuit breaking
    # ------------------------------------------------------------------
    def _monitor(self):
        while not self._stop.is_set():
            try:
                self.monitor_tick()
            except Exception as e:
                # a monitor crash must not kill health tracking silently;
                # keep ticking and surface the cause through stats()
                self.monitor_errors.append(f"{type(e).__name__}: {e}")
            self._stop.wait(self.cfg.probe_interval_s)

    def monitor_tick(self):
        """One health pass: heartbeat liveness first (a corpse trips its
        breaker at once), then a readiness probe per replica. OPEN
        circuits cool down for `breaker_cooldown_s`, then get ONE trial
        probe (HALF_OPEN): success closes, failure re-opens."""
        now = time.monotonic()
        if self._store is not None:
            from paddle_tpu_torch.distributed.store import dead_peers

            world = max(self._slots) + 1
            for d in dead_peers(self._store, self._job_id, world,
                                timeout_s=self._dead_timeout_s,
                                watch=self._hb_watch):
                # age None = never beat: a transport with no heartbeat
                # wired is not declared dead
                if d["age_s"] is None:
                    continue
                slot = self._slots.get(d["rank"])
                if slot is not None and slot.circuit != "open":
                    self._trip(slot, f"heartbeat stale ({d['age_s']}s)")
        for slot in list(self._slots.values()):
            went_half_open = False
            with self._lock:
                if slot.circuit == "open":
                    if now - slot.opened_t < self.cfg.breaker_cooldown_s:
                        continue            # still cooling: no probe
                    slot.circuit = "half_open"
                    went_half_open = True
            if went_half_open:
                # journal emits stay OUTSIDE the router lock (a slow
                # durable sink must not stall dispatch/admission)
                obs_events.emit("router", "circuit_half_open",
                                replica=slot.rid)
            try:
                p = dict(slot.transport.probe())
                if not p.get("ok", True):
                    raise ReplicaError(
                        f"replica {slot.rid} reports not-ok: {p}")
            except Exception as e:
                with self._lock:
                    slot.probe_err = f"{type(e).__name__}: {e}"
                    if slot.circuit == "half_open":
                        # failed its one trial: back to cooling
                        self._trip(slot, f"half-open trial failed: "
                                         f"{slot.probe_err}")
                    else:
                        slot.consecutive_failures += 1
                        if (slot.consecutive_failures
                                >= self.cfg.failure_threshold):
                            self._trip(slot, slot.probe_err)
                continue
            closed_now = False
            with self._lock:
                slot.probe = p
                slot.probe_err = None
                slot.consecutive_failures = 0
                if slot.circuit == "half_open":
                    slot.circuit = "closed"   # trial succeeded: recovered
                    closed_now = True
            if closed_now:
                obs_events.emit("router", "circuit_close",
                                replica=slot.rid)

    def _record_failure(self, slot: _Slot, cause: str):
        """A dispatch-path failure counts against the same breaker as a
        probe failure (the flag doc's contract)."""
        with self._lock:
            slot.consecutive_failures += 1
            if (slot.circuit == "closed" and
                    slot.consecutive_failures >= self.cfg.failure_threshold):
                self._trip(slot, cause)

    def _trip(self, slot: _Slot, cause: str):
        with self._lock:
            slot.circuit = "open"
            slot.opened_t = time.monotonic()
            slot.trips += 1
            slot.last_cause = cause
            self._drain_slot(slot, cause)
        obs_events.emit("router", "circuit_open", severity="error",
                        replica=slot.rid, cause=cause, trips=slot.trips)

    def _drain_slot(self, slot: _Slot, why: str) -> list:
        """Signal every in-flight dispatch bound to `slot`, OLDEST FIRST
        (arrival order), to fail over to a peer — users drain to peers
        instead of timing out. Returns the signalled dispatch seqs in
        signal order."""
        with self._lock:
            ctxs = sorted((c for c in self._inflight.values()
                           if c.replica_id == slot.rid),
                          key=lambda c: c.arrival_t)
            for c in ctxs:
                c.abort_why = why
                c.abort.set()
            self.drained += len(ctxs)
            return [c.seq for c in ctxs]

    def drain(self, replica_id: int, why: str = "draining") -> list:
        """Graceful drain for maintenance: stop placing new requests on
        the replica and re-dispatch its in-flight requests to peers (in
        arrival order). The replica stays probed; `undrain()` returns it
        to rotation."""
        slot = self._slots[int(replica_id)]
        with self._lock:
            slot.draining = True
        obs_events.emit("router", "drain", severity="warn",
                        replica=slot.rid, why=why)
        return self._drain_slot(slot, why)

    def undrain(self, replica_id: int):
        with self._lock:
            self._slots[int(replica_id)].draining = False

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def placement_key(self, payload: dict):
        """The rendezvous key for one request, per `cfg.placement`:

        * ``session`` — the session id (one user's turns stick to one
          replica and its KV pages).
        * ``prefix`` — a blake2b digest of the prompt's first
          ``prefix_tokens`` ids, so every request SHARING a system prompt
          hashes to the SAME key and lands on the replica already holding
          that prefix's pages (per-replica radix hits become a fleet-wide
          property). Session id remains the tiebreak for promptless
          payloads; a request with neither goes least-loaded (None).
        * ``adapter`` — the request's LoRA adapter id, so one tenant's
          requests land where their adapter is already resident in the
          AdapterStore slot pool (swap-ins become a once-per-replica
          cost, not a per-request one). Session fallback for adapterless
          requests.
        """
        session = payload.get("session")
        if self.cfg.placement == "adapter":
            adapter = payload.get("adapter")
            return f"adapter:{adapter}" if adapter else session
        if self.cfg.placement != "prefix":
            return session
        ids = payload.get("prompt_ids")
        if ids is None:
            return session
        n = max(int(self.cfg.prefix_tokens), 1)
        try:
            head = [int(t) for t in list(ids)[:n]]
        except (TypeError, ValueError):
            return session
        h = hashlib.blake2b(
            b"\x00".join(str(t).encode() for t in head), digest_size=8)
        return f"prefix:{h.hexdigest()}"

    def _pick(self, key, exclude) -> _Slot | None:
        with self._lock:
            # role-aware placement: PREFILL-role replicas never take
            # generate dispatches (they serve the KV-page handoff plane);
            # decode and mixed replicas form the dispatch pool
            cands = [s for s in self._slots.values()
                     if s.circuit == "closed" and not s.draining
                     and s.rid not in exclude
                     and s.probe.get("role", "mixed") != "prefill"]
            if not cands:
                return None
            if key is not None:
                # session affinity: rendezvous over the HEALTHY set only,
                # so membership change remaps the minimal key range
                first = rendezvous_order(str(key),
                                         [s.rid for s in cands])[0]
                return self._slots[first]

            def load(s: _Slot):
                return (s.dispatches
                        + int(s.probe.get("queue_depth", 0) or 0)
                        + float(s.probe.get("slot_fill", 0.0) or 0.0))

            return min(cands, key=lambda s: (load(s), s.rid))

    def _aggregate_depth(self) -> int:
        with self._lock:
            depth = len(self._inflight)
            for s in self._slots.values():
                if s.circuit == "closed":
                    depth += int(s.probe.get("queue_depth", 0) or 0)
            return depth

    # ------------------------------------------------------------------
    # admission + degradation
    # ------------------------------------------------------------------
    def admission_check(self, payload: dict) -> dict | None:
        """The serve.py `admit_fn` contract: None admits; a dict refuses
        BEFORE response headers with its status + Retry-After. Refusals
        happen at the router front door — no replica is touched."""
        with self._lock:
            if len(self._inflight) >= self.cfg.max_inflight:
                self.refused += 1
                return {"status": 503,
                        "retry_after": self.cfg.retry_after_s,
                        "message": f"router at max in-flight "
                                   f"({self.cfg.max_inflight})"}
        if self._pick(None, ()) is None:
            with self._lock:
                self.refused += 1
            return {"status": 503, "retry_after": self.cfg.retry_after_s,
                    "message": "no healthy replica"}
        return None

    # ------------------------------------------------------------------
    # the request path
    # ------------------------------------------------------------------
    def stream(self, payload: dict, deadline: float | None = None):
        """Generator of stream events for one request (the event contract
        in the module docstring). Always yields EXACTLY ONE terminal
        event — the zero-lost-requests guarantee lives here."""
        cfg = self.cfg
        tenant = str(payload.get("tenant") or payload.get("adapter") or "")
        with self._lock:
            # build the refusal under the lock, yield OUTSIDE it: a
            # generator suspends at yield, and suspending while holding
            # the router-wide lock would serialize every other request
            # (and the monitor) on the slowest refused client's socket
            if len(self._inflight) >= cfg.max_inflight:
                self.refused += 1
                rejected = {"error": "refused", "tokens": 0, "failovers": 0,
                            "retry_after": cfg.retry_after_s,
                            "message": f"router at max in-flight "
                                       f"({cfg.max_inflight})"}
            elif (tenant and cfg.tenant_max_inflight > 0
                  and self._tenant_inflight.get(tenant, 0)
                  >= cfg.tenant_max_inflight):
                # the per-tenant fairness cap: a flooding tenant is refused
                # with its OWN typed error while everyone else's admission
                # headroom stays intact
                self.tenant_refused += 1
                self.refused += 1
                rejected = {"error": "tenant_limit", "tokens": 0,
                            "failovers": 0,
                            "retry_after": cfg.retry_after_s,
                            "tenant": tenant,
                            "message": f"tenant {tenant!r} at max "
                                       f"in-flight "
                                       f"({cfg.tenant_max_inflight})"}
            else:
                rejected = None
                self._seq += 1
                ctx = _Dispatch(seq=self._seq, arrival_t=time.monotonic(),
                                abort=threading.Event(), tenant=tenant)
                self._inflight[ctx.seq] = ctx
                if tenant:
                    self._tenant_inflight[tenant] = \
                        self._tenant_inflight.get(tenant, 0) + 1
                self.accepted += 1
        if rejected is not None:
            yield rejected
            return
        payload = dict(payload)
        # the router MINTS the request's trace id (unless the caller sent
        # one): it rides payload["trace"] -> Request.trace_id -> every
        # replica/engine/scheduler/decode-step span
        trace = str(payload.get("trace") or "") or obs_tracing.new_trace_id()
        payload["trace"] = trace
        shed = False
        if self._aggregate_depth() > cfg.shed_queue_depth:
            if int(payload.get("max_new_tokens", 16)) > cfg.shed_max_new_tokens:
                payload["max_new_tokens"] = cfg.shed_max_new_tokens
                shed = True
                with self._lock:
                    self.sheds += 1
        # span covers the request's whole router residence (dispatches,
        # failovers, relay) — wall time as the CALLER experiences it.
        # bind=False: the generator suspends inside this `with`, and owning
        # the consumer thread's trace context across suspensions would
        # misattribute unrelated spans (and restore non-LIFO under
        # interleaved streams); the id still rides the span + payload.
        with obs_tracing.span("router.stream", component="router",
                              trace_id=trace, bind=False,
                              session=str(payload.get("session") or "")):
            yield from self._relay(payload, ctx, deadline, shed)

    def _relay(self, payload, ctx, deadline, shed):
        """The dispatch/failover relay loop of one accepted request (the
        body of `stream()` — split out so the tracing span wraps it)."""
        cfg = self.cfg
        key = self.placement_key(payload)
        delays = backoff_delays(cfg.dispatch_attempts, cfg.backoff_initial_s,
                                cfg.backoff_max_s)
        emitted, attempts = 0, 0
        excluded: set = set()
        last_err: Exception | None = None
        try:
            while True:
                if deadline is not None and time.monotonic() > deadline:
                    with self._lock:
                        self.failed += 1
                    yield {"error": "timeout", "tokens": emitted,
                           "failovers": max(0, attempts - 1),
                           "message": "request deadline exceeded"}
                    return
                slot = self._pick(key, excluded)
                if slot is None:
                    with self._lock:
                        self.failed += 1
                    yield {"error": "no_healthy_replica", "tokens": emitted,
                           "failovers": max(0, attempts - 1),
                           "retry_after": cfg.retry_after_s,
                           "message": (f"last failure: {last_err}"
                                       if last_err else
                                       "every replica circuit is open")}
                    return
                attempts += 1
                with self._lock:
                    ctx.replica_id = slot.rid
                    ctx.abort = threading.Event()  # stale drains don't carry
                    ctx.abort_why = ""
                    slot.dispatches += 1
                handle = None
                err: Exception | None = None
                try:
                    if faults.fire_check("serving.dispatch.drop"):
                        # the dispatch vanished in transit: nothing was
                        # submitted, nothing will ever arrive — the bound
                        # on detecting it is the gap timeout
                        ctx.abort.wait(cfg.gap_timeout_s)
                        if ctx.abort.is_set():
                            raise _Drained(ctx.abort_why)
                        raise StreamGap(
                            f"dispatch to replica {slot.rid} dropped "
                            f"(silent past {cfg.gap_timeout_s}s)")
                    handle = slot.transport.open_stream(payload)
                    skip = emitted
                    gap_deadline = time.monotonic() + cfg.gap_timeout_s
                    while True:
                        if ctx.abort.is_set():
                            raise _Drained(ctx.abort_why)
                        if (deadline is not None
                                and time.monotonic() > deadline):
                            with self._lock:
                                self.failed += 1
                            yield {"error": "timeout", "tokens": emitted,
                                   "failovers": attempts - 1,
                                   "message": "request deadline exceeded"}
                            return
                        ev = handle.next_event(0.05)
                        if ev is None:
                            if time.monotonic() > gap_deadline:
                                raise StreamGap(
                                    f"replica {slot.rid}: no stream event "
                                    f"within {cfg.gap_timeout_s}s")
                            continue
                        gap_deadline = time.monotonic() + cfg.gap_timeout_s
                        if "token" in ev:
                            if skip > 0:
                                skip -= 1  # failover replay of the
                                continue   # already-delivered prefix
                            emitted += 1
                            yield {"token": ev["token"]}
                        elif ev.get("done"):
                            with self._lock:
                                slot.consecutive_failures = 0
                                self.completed += 1
                            done = {"done": True, "tokens": emitted,
                                    "replica": slot.rid,
                                    "failovers": attempts - 1}
                            if shed:
                                done["shed"] = True
                            yield done
                            return
                        elif ev.get("error") == "adapter_load_failed":
                            # typed per-request adapter failure from the
                            # engine: the replica is healthy and no peer
                            # can do better (registration is store-wide)
                            # — ONE terminal event, no strike, no failover
                            with self._lock:
                                self.failed += 1
                            yield {"error": "adapter_load_failed",
                                   "tokens": emitted,
                                   "failovers": attempts - 1,
                                   "adapter": str(ev.get("adapter", "")),
                                   "message": str(ev.get("message", ""))}
                            return
                        elif "error" in ev:
                            raise ReplicaError(
                                f"replica {slot.rid} stream error: "
                                f"{ev['error']}")
                except AdapterLoadError as e:
                    # the in-process submit path raises directly (the HTTP
                    # path arrives as the stream event above): same typed
                    # terminal degradation, same no-strike contract
                    with self._lock:
                        self.failed += 1
                    yield {"error": "adapter_load_failed",
                           "tokens": emitted,
                           "failovers": attempts - 1,
                           "adapter": e.adapter_id, "message": str(e)}
                    return
                except QueueFull as e:
                    # bounded-queue pushback: admission backpressure from a
                    # busy peer, NOT ill health — no breaker strike
                    err = e
                    excluded.add(slot.rid)
                except _Drained as e:
                    err = e        # breaker already tripped / drain caller
                except (ReplicaError, ConnectionError, OSError) as e:
                    err = e
                    self._record_failure(slot, f"{type(e).__name__}: {e}")
                    excluded.add(slot.rid)
                finally:
                    with self._lock:
                        slot.dispatches -= 1
                    if handle is not None:
                        try:
                            handle.close()
                        except Exception as e:
                            self.monitor_errors.append(
                                f"stream close: {type(e).__name__}: {e}")
                last_err = err
                if attempts >= cfg.dispatch_attempts:
                    with self._lock:
                        self.failed += 1
                    out = {"error": "failover_exhausted", "tokens": emitted,
                           "failovers": attempts - 1,
                           "message": f"{type(last_err).__name__}: "
                                      f"{last_err}"}
                    if isinstance(last_err, QueueFull):
                        out["error"] = "queue_full"
                        out["retry_after"] = cfg.retry_after_s
                    yield out
                    return
                with self._lock:
                    self.failovers += 1
                obs_events.emit(
                    "router", "failover", severity="warn",
                    replica=slot.rid, attempt=attempts,
                    trace_id=str(payload.get("trace") or ""),
                    cause=f"{type(err).__name__}: {err}" if err else "")
                # responsive backoff: a drain wakes it
                ctx.abort.wait(delays[attempts - 1])
        finally:
            with self._lock:
                self._inflight.pop(ctx.seq, None)
                if ctx.tenant:
                    n = self._tenant_inflight.get(ctx.tenant, 0) - 1
                    if n > 0:
                        self._tenant_inflight[ctx.tenant] = n
                    else:
                        self._tenant_inflight.pop(ctx.tenant, None)

    def generate(self, payload: dict, deadline: float | None = None):
        """Synchronous convenience: drain one stream, return (tokens,
        terminal event)."""
        toks, terminal = [], None
        for ev in self.stream(payload, deadline=deadline):
            if "token" in ev:
                toks.append(ev["token"])
            else:
                terminal = ev
        return toks, terminal

    # ------------------------------------------------------------------
    # observability + HTTP front-end
    # ------------------------------------------------------------------
    def health(self) -> dict:
        with self._lock:
            circuits = {s.rid: s.circuit for s in self._slots.values()}
            healthy = [r for r, c in circuits.items()
                       if c == "closed" and not self._slots[r].draining]
            return {"ok": bool(healthy), "healthy": healthy,
                    "circuits": {str(k): v for k, v in circuits.items()},
                    "in_flight": len(self._inflight)}

    def stats(self) -> dict:
        with self._lock:
            return {
                "placement_mode": self.cfg.placement,
                "in_flight": len(self._inflight),
                "accepted": self.accepted, "completed": self.completed,
                "failed": self.failed, "refused": self.refused,
                "failovers": self.failovers, "sheds": self.sheds,
                "drained": self.drained,
                "tenant_refused": self.tenant_refused,
                "tenant_max_inflight": self.cfg.tenant_max_inflight,
                "tenants": dict(self._tenant_inflight),
                "monitor_errors": len(self.monitor_errors),
                "replicas": {
                    str(s.rid): {
                        "circuit": s.circuit, "draining": s.draining,
                        "dispatches": s.dispatches, "trips": s.trips,
                        "consecutive_failures": s.consecutive_failures,
                        "last_cause": s.last_cause,
                        # the placement snapshot: which pool this replica
                        # serves (prefill-role replicas never take
                        # generate dispatches)
                        "role": s.probe.get("role", "mixed"),
                        "probe": dict(s.probe),
                        "probe_err": s.probe_err,
                    } for s in self._slots.values()},
            }

    def serve_http(self, port: int, host: str = "127.0.0.1"):
        """The fleet front door: the SAME hardened serve.py chassis the
        single engine uses (bounded handler queue, 413/411, ndjson
        streaming), with router admission wired pre-headers and
        /healthz + /stats answering fleet-level health."""
        from paddle_tpu_torch.core.flags import flag
        from paddle_tpu_torch.inference.serve import build_http_server

        srv = build_http_server(
            port,
            generate_fn=lambda payload, deadline: self.stream(
                payload, deadline=deadline),
            queue_limit=int(flag("serving_queue_limit")),
            timeout_s=float(flag("serving_request_timeout_s")),
            max_body_bytes=int(flag("serving_max_body_mb")) << 20,
            host=host, admit_fn=self.admission_check,
            health_fn=self.health, stats_fn=self.stats,
            metrics_fn=lambda: obs_metrics.registry().prometheus_text())
        self._http_server = srv
        return srv

    def close(self, close_transports: bool = False):
        """Join the monitor (thread hygiene); optionally close the owned
        in-process replicas too."""
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
            self._monitor_thread = None
        srv = getattr(self, "_http_server", None)
        if srv is not None:
            # shutdown() blocks on an event only serve_forever() sets; if
            # the caller never started serving (built the server, then
            # errored out), a direct call would hang close() forever —
            # bound it instead
            t = threading.Thread(target=srv.shutdown, daemon=True)
            t.start()
            t.join(timeout=5.0)
            srv.server_close()
            self._http_server = None
        if close_transports:
            for s in self._slots.values():
                closer = getattr(s.transport, "close", None)
                if closer is not None:
                    closer()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False
