"""The port's fleet front on the CPU: the router and the in-process
replica, after the JAX package's ``test_router.py``.

* ``rendezvous_order``, ``backoff_delays`` and ``placement_key`` (session,
  prefix and adapter modes) equal to JAX's for the same inputs;
* the breaker (probe and dispatch failures, half-open trial), drain in
  arrival order, failover without a double emit, the gap timeout, queue
  pushback without a strike, admission refusal and shed, the tenant cap
  and adapter placement, on scripted transports;
* the replica's chaos points (kill, slow, stream cut) and the routed chaos
  matrix over a fleet of host-only engines (the port's real scheduler and
  allocator, tokens a function of prompt and index): zero lost requests,
  every stream equal to the fault-free one;
* two port engines with adapter stores behind ``Router(placement=
  "adapter")``: each adapter's requests on one replica, a replica killed
  mid-stream losing nothing with every greedy stream equal to the
  unrouted one, an unknown adapter as one ``adapter_load_failed`` event
  with no breaker strike, one trace id across router, replica and engine
  spans, and the Chrome export merging a device trace file;
* the HTTP front door (/generate, /healthz, /stats, /metrics);
* ``store=`` (heartbeats) is not ported and raises.

Every test resets the port's fault registry and tracing itself and checks
that no ``paddle_tpu_torch.serving`` thread outlives it.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving.router import Router as JaxRouter
from paddle_tpu.serving.router import RouterConfig as JaxRouterConfig
from paddle_tpu.serving.router import backoff_delays as jax_backoff_delays
from paddle_tpu.serving.router import rendezvous_order as jax_rendezvous
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.lora import AdapterStore, LoRAConfig, attach, detach
from paddle_tpu_torch.lora import export_adapter
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import events, tracing
from paddle_tpu_torch.observability.metrics import registry
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PageAllocator, QueueFull, Request,
                                      ServingConfig, ServingEngine)
from paddle_tpu_torch.serving.replica import (InProcessReplica, ReplicaDead,
                                              ReplicaError, StreamCut)
from paddle_tpu_torch.serving.router import (Router, RouterConfig,
                                             _Dispatch, backoff_delays,
                                             rendezvous_order)

SERVING_POINTS = ["serving.replica.kill", "serving.replica.slow",
                  "serving.dispatch.drop", "serving.stream.cut"]


@pytest.fixture(autouse=True)
def _port_hygiene():
    before = set(threading.enumerate())
    faults.reset()
    yield
    faults.reset()
    tracing.stop_tracing()
    tracing.reset()
    events.journal().clear()
    deadline = time.time() + 3.0

    def left():
        return [t for t in threading.enumerate()
                if t.name.startswith("paddle_tpu_torch.serving")
                and t not in before and t.is_alive()]

    while left() and time.time() < deadline:
        time.sleep(0.02)
    assert not left(), [t.name for t in left()]


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------
class FakeEngine:
    """Host-only engine behind the transport seam: the port's scheduler
    and allocator, tokens a function of (prompt, index) only, so a
    failover re-prefill on any replica reproduces the stream."""

    def __init__(self, num_pages=64, page_size=4, max_seq_len=64,
                 max_waiting=0, decode_batch=4, step_delay_s=0.0):
        self.decode_batch = decode_batch
        self.allocator = PageAllocator(num_pages, page_size)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, decode_batch, max_seq_len,
            max_waiting=max_waiting)
        self.step_delay_s = step_delay_s

    @staticmethod
    def token(prompt, i):
        return (int(np.sum(np.asarray(prompt, np.int64))) * 31 + 7 * i) % 997

    def submit(self, prompt, max_new_tokens=16, temperature=0.0, top_k=0,
               top_p=1.0, eos_id=None, stream_cb=None, adapter=None,
               tenant=""):
        return self.scheduler.submit(Request(
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=int(max_new_tokens), eos_id=eos_id,
            stream_cb=stream_cb, adapter=adapter, tenant=tenant))

    @property
    def busy(self):
        return not self.scheduler.idle

    def step(self):
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        for req in self.scheduler.admissions():
            self.scheduler.activate(req)
        self.scheduler.grow()
        for req in list(self.scheduler.running):
            tok = self.token(req.prompt, len(req.generated))
            req.generated.append(tok)
            if req.stream_cb is not None:
                req.stream_cb(req, tok)
            if len(req.generated) >= req.max_new_tokens:
                self.scheduler.finish(req)
        return bool(self.scheduler.running)

    def cancel(self, rid):
        return self.scheduler.cancel(rid)

    def release(self, rid):
        self.scheduler.release(rid)

    def stats(self):
        running = len(self.scheduler.running)
        return {"queue_depth": self.scheduler.queue_depth,
                "oldest_wait_age_s": self.scheduler.oldest_wait_age(),
                "slot_fill": running / max(self.decode_batch, 1),
                "free_pages": self.allocator.free_pages}


def _expected(prompt, n):
    return [FakeEngine.token(prompt, i) for i in range(n)]


class ScriptedStream:
    def __init__(self, events):
        self._events = list(events)
        self.closed = False

    def next_event(self, timeout_s):
        if not self._events:
            time.sleep(min(timeout_s, 0.005))
            return None
        ev = self._events.pop(0)
        if isinstance(ev, Exception):
            raise ev
        return ev

    def close(self):
        self.closed = True


class ScriptedReplica:
    def __init__(self, rid, stream_factory=None):
        self.replica_id = rid
        self.probe_result = {"ok": True, "queue_depth": 0, "slot_fill": 0.0}
        self.probe_exc = None
        self.stream_factory = stream_factory
        self.payloads = []
        self.handles = []

    def probe(self):
        if self.probe_exc is not None:
            raise self.probe_exc
        return dict(self.probe_result)

    def open_stream(self, payload):
        self.payloads.append(dict(payload))
        if self.stream_factory is not None:
            h = self.stream_factory(payload)
        else:
            toks = _expected(payload["prompt_ids"],
                             int(payload.get("max_new_tokens", 16)))
            h = ScriptedStream([{"token": t} for t in toks]
                               + [{"done": True}])
        self.handles.append(h)
        return h


def _cfg(**over):
    base = dict(probe_interval_s=0.01, failure_threshold=3,
                breaker_cooldown_s=0.05, dispatch_attempts=3,
                backoff_initial_s=0.005, backoff_max_s=0.02,
                gap_timeout_s=0.3, max_inflight=8, shed_queue_depth=10_000,
                shed_max_new_tokens=2, retry_after_s=0.25)
    base.update(over)
    return RouterConfig(**base)


def _payload(prompt, n=5, **kw):
    return {"prompt_ids": [int(t) for t in np.asarray(prompt).ravel()],
            "max_new_tokens": n, **kw}


# ---------------------------------------------------------------------------
# placement primitives against JAX
# ---------------------------------------------------------------------------
def test_rendezvous_and_backoff_equal_jax():
    for ids in ([0, 1, 2, 3], [5, 9, 2], [7]):
        for i in range(100):
            key = f"session-{i}"
            assert rendezvous_order(key, ids) == jax_rendezvous(key, ids)
    for args in ((4, 0.05, 0.15), (3, 0.1, 10.0), (1, 0.1, 1.0),
                 (6, 0.001, 0.01)):
        assert backoff_delays(*args) == jax_backoff_delays(*args)


@pytest.mark.parametrize("placement", ["session", "prefix", "adapter"])
def test_placement_key_equal_jax(placement):
    cfg = dict(placement=placement, prefix_tokens=4)
    ours = Router([ScriptedReplica(0)], RouterConfig(**cfg),
                  start_monitor=False)
    theirs = JaxRouter([ScriptedReplica(0)], JaxRouterConfig(**cfg),
                       start_monitor=False)
    try:
        for payload in ({"session": "u1", "prompt_ids": [1, 2, 3, 4, 5]},
                        {"prompt_ids": [1, 2, 3, 4, 9], "adapter": "ten-a"},
                        {"session": "u2", "adapter": "ten-b"}, {}):
            assert ours.placement_key(payload) == \
                theirs.placement_key(payload)
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------------------
# breaker, drain, failover, admission
# ---------------------------------------------------------------------------
def test_probe_failures_trip_then_half_open_closes():
    a, b = ScriptedReplica(0), ScriptedReplica(1)
    r = Router([a, b], _cfg(breaker_cooldown_s=0.03), start_monitor=False)
    try:
        a.probe_exc = ReplicaError("down")
        for i in range(3):
            r.monitor_tick()
            assert r.stats()["replicas"]["0"]["circuit"] == \
                ("open" if i >= 2 else "closed")
        assert r.health()["healthy"] == [1]
        time.sleep(0.04)
        r.monitor_tick()              # half-open trial fails -> re-open
        s = r.stats()["replicas"]["0"]
        assert s["circuit"] == "open" and s["trips"] == 2
        time.sleep(0.04)
        a.probe_exc = None
        r.monitor_tick()              # trial succeeds -> closed
        assert r.stats()["replicas"]["0"]["circuit"] == "closed"
        kinds = [e["event"] for e in events.journal().recent(16)]
        assert {"circuit_open", "circuit_half_open",
                "circuit_close"} <= set(kinds)
    finally:
        r.close()


def test_dispatch_failures_count_toward_breaker():
    def boom(payload):
        raise ReplicaError("dispatch refused")

    a, b = ScriptedReplica(0, stream_factory=boom), ScriptedReplica(1)
    r = Router([a, b], _cfg(failure_threshold=2), start_monitor=False)
    try:
        p = np.arange(1, 5)
        for _ in range(2):
            toks, term = r.generate(_payload(p))
            assert term["done"] and term["failovers"] == 1
            assert toks == _expected(p, 5)
        assert r.stats()["replicas"]["0"]["circuit"] == "open"
        toks, term = r.generate(_payload(p))
        assert term["failovers"] == 0 and term["replica"] == 1
    finally:
        r.close()


def test_trip_drains_inflight_oldest_first():
    a, b = ScriptedReplica(0), ScriptedReplica(1)
    r = Router([a, b], _cfg(), start_monitor=False)
    try:
        ctxs = {}
        for seq, (rid, at) in enumerate([(0, 3.0), (0, 1.0), (1, 0.5),
                                         (0, 2.0)]):
            c = _Dispatch(seq=seq, arrival_t=at, abort=threading.Event())
            c.replica_id = rid
            r._inflight[seq] = c
            ctxs[seq] = c
        assert r.drain(0, why="maintenance") == [1, 3, 0]
        assert not ctxs[2].abort.is_set()
        assert r._pick(None, ()).rid == 1
        r.undrain(0)
        assert r.stats()["replicas"]["0"]["draining"] is False
    finally:
        r._inflight.clear()
        r.close()


def test_mid_stream_cut_resumes_without_double_emit():
    p = np.arange(3, 9)

    def cut_after_2(payload):
        toks = _expected(payload["prompt_ids"],
                         int(payload["max_new_tokens"]))
        return ScriptedStream([{"token": toks[0]}, {"token": toks[1]},
                               StreamCut("connection died")])

    a, b = ScriptedReplica(0, stream_factory=cut_after_2), ScriptedReplica(1)
    r = Router([a, b], _cfg(), start_monitor=False)
    try:
        toks, term = r.generate(_payload(p, n=6))
        assert toks == _expected(p, 6)
        assert term["done"] and term["failovers"] == 1 and term["replica"] == 1
        assert a.handles[0].closed
        assert b.payloads[0]["prompt_ids"] == [int(t) for t in p]
        assert r._inflight == {}
    finally:
        r.close()


@pytest.mark.parametrize("kind", ["wedged", "queue_full"])
def test_gap_timeout_and_pushback_fail_over(kind):
    def wedged(payload):
        return ScriptedStream([])

    def full(payload):
        raise QueueFull(5, 5)

    a = ScriptedReplica(0, stream_factory=wedged if kind == "wedged"
                        else full)
    b = ScriptedReplica(1)
    r = Router([a, b], _cfg(gap_timeout_s=0.1), start_monitor=False)
    try:
        p = np.arange(1, 5)
        toks, term = r.generate(_payload(p))
        assert toks == _expected(p, 5) and term["failovers"] == 1
        # silence is a strike; pushback is not
        assert r.stats()["replicas"]["0"]["consecutive_failures"] == \
            (1 if kind == "wedged" else 0)
    finally:
        r.close()


def test_admission_refusal_and_shed():
    a = ScriptedReplica(0)
    r = Router([a], _cfg(max_inflight=2, shed_queue_depth=0,
                         shed_max_new_tokens=2), start_monitor=False)
    try:
        p = np.arange(1, 7)
        toks, term = r.generate(_payload(p, n=10))
        assert term.get("shed") is True and toks == _expected(p, 2)
        for seq in (91, 92):
            r._inflight[seq] = _Dispatch(seq=seq, arrival_t=0.0,
                                         abort=threading.Event())
        rej = r.admission_check({"prompt_ids": [1]})
        assert rej["status"] == 503
        assert rej["retry_after"] == pytest.approx(0.25)
        toks, term = r.generate(_payload(p))
        assert toks == [] and term["error"] == "refused"
    finally:
        r._inflight.clear()
        r.close()


def test_tenant_cap_and_adapter_placement():
    reps = [ScriptedReplica(i) for i in range(3)]
    r = Router(reps, _cfg(placement="adapter", tenant_max_inflight=1),
               start_monitor=False)
    try:
        assert r.placement_key({"adapter": "ten-a"}) == "adapter:ten-a"
        home = rendezvous_order("adapter:ten-a", [0, 1, 2])[0]
        for i in range(3):
            _, term = r.generate(_payload(np.arange(1, 4 + i),
                                          adapter="ten-a"))
            assert term["replica"] == home
        g = r.stream(_payload(np.arange(1, 4), n=30, tenant="acme"))
        next(g)                       # hold one stream of acme open
        try:
            _, term = r.generate(_payload(np.arange(1, 4), tenant="acme"))
            assert term["error"] == "tenant_limit"
            assert term["tenant"] == "acme"
            _, term = r.generate(_payload(np.arange(1, 4), n=2,
                                          tenant="zen"))
            assert term["done"]
        finally:
            g.close()
        st = r.stats()
        assert st["tenant_refused"] == 1 and st["tenants"] == {}
    finally:
        r.close()


# ---------------------------------------------------------------------------
# the in-process replica and the routed chaos matrix
# ---------------------------------------------------------------------------
def test_replica_stream_roundtrip_and_kill_point():
    rep = InProcessReplica(FakeEngine(), replica_id=3)
    try:
        assert rep._thread.name == "paddle_tpu_torch.serving.replica.3"
        pr = rep.probe()
        assert pr["ok"] is True and pr["replica"] == 3
        p = np.arange(1, 6)
        h = rep.open_stream(_payload(p, n=4))
        toks, done = [], None
        while done is None:
            ev = h.next_event(1.0)
            if ev is None:
                continue
            if "token" in ev:
                toks.append(ev["token"])
            else:
                done = ev
        h.close()
        assert toks == _expected(p, 4) and done["done"]
        assert rep.engine.scheduler._by_rid == {}
        faults.arm("serving.replica.kill")
        deadline = time.time() + 3.0
        while rep.dead_cause is None and time.time() < deadline:
            time.sleep(0.005)
        with pytest.raises(ReplicaDead):
            rep.probe()
        with pytest.raises(ReplicaDead):
            rep.open_stream(_payload(p))
    finally:
        rep.close()


def _fleet(n=3, step_delay_s=0.002, **cfg_over):
    engines = [FakeEngine(step_delay_s=step_delay_s) for _ in range(n)]
    reps = [InProcessReplica(e, replica_id=i) for i, e in enumerate(engines)]
    cfg = _cfg(probe_interval_s=0.03, failure_threshold=2,
               breaker_cooldown_s=0.25, dispatch_attempts=4,
               gap_timeout_s=0.5, max_inflight=64, **cfg_over)
    return engines, reps, Router(reps, cfg)


def _run_clients(router, payloads, spread_s=0.2):
    rng = np.random.RandomState(7)
    offsets = np.sort(rng.uniform(0.0, spread_s, len(payloads)))
    results = [None] * len(payloads)

    def client(i):
        time.sleep(float(offsets[i]))
        results[i] = router.generate(payloads[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads), "routed run hung"
    return results


@pytest.mark.parametrize("point", SERVING_POINTS)
def test_point_recovers_to_fault_free_streams(point):
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 500, int(n)).astype(np.int32)
               for n in rng.randint(3, 11, 10)]
    engines, reps, router = _fleet()
    try:
        faults.arm(point, mode="nth",
                   nth=5 if point == "serving.dispatch.drop" else 40)
        results = _run_clients(router, [_payload(p, n=6) for p in prompts])
        assert faults.fired(point) == 1, point
        for p, (toks, term) in zip(prompts, results):
            assert term.get("done") is True, (point, term)
            assert toks == _expected(p, 6)
    finally:
        router.close()
        for rep in reps:
            rep.close()
    assert router._inflight == {}
    for eng, rep in zip(engines, reps):
        if rep.dead_cause is None:
            eng.allocator.check_consistency()
            assert eng.allocator.used_pages == 0


def test_store_heartbeats_not_ported():
    with pytest.raises(NotImplementedError, match="A8"):
        InProcessReplica(FakeEngine(), replica_id=0, store=object())
    with pytest.raises(NotImplementedError, match="A8"):
        Router([ScriptedReplica(0)], _cfg(), store=object(),
               start_monitor=False)


# ---------------------------------------------------------------------------
# port engines with adapters behind the router
# ---------------------------------------------------------------------------
ENGINE = dict(page_size=4, num_pages=64, decode_batch=4, prefill_chunk=16,
              max_seq_len=64)


@pytest.fixture(scope="module")
def lora_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("router_lora")
    m = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                         device="cpu", seed=0)
    m.eval()
    paths = {}
    for i, aid in enumerate(("ten-a", "ten-b", "ten-c")):
        h = attach(m, LoRAConfig(rank=4, alpha=8.0, seed=i))
        rng = np.random.default_rng(i)
        for _, _, _, B in h.entries:
            B.data.copy_(torch_tensor(rng.standard_normal(tuple(B.shape))
                                      * 0.5))
        paths[aid] = str(d / f"{aid}.pdmodel")
        export_adapter(paths[aid], h, adapter_id=aid)
        detach(h)
    return m, paths


def torch_tensor(a):
    import torch

    return torch.from_numpy(np.asarray(a, np.float32))


def _engine(m, paths):
    store = AdapterStore(m, rank=4, slots=4)
    for aid, p in paths.items():
        store.register(aid, p)
    return ServingEngine(m, ServingConfig(**ENGINE), adapter_store=store,
                         device="cpu")


def _lora_payloads():
    rng = np.random.RandomState(5)
    adapters = [None, None, "ten-a", "ten-a", "ten-b", "ten-b", "ten-c",
                "ten-c"]
    return [_payload(rng.randint(1, 256, int(n)), n=12, adapter=a,
                     tenant=a or "base", session=f"s{i}")
            for i, (n, a) in enumerate(zip(rng.randint(4, 20, 8),
                                           adapters))]


def test_two_replicas_adapter_placement_kill_and_trace(lora_model, tmp_path):
    m, paths = lora_model
    payloads = _lora_payloads()
    ref = _engine(m, paths)
    want = []
    for pl in payloads:
        want.append(ref.generate([np.asarray(pl["prompt_ids"], np.int32)],
                                 max_new_tokens=12,
                                 adapter=pl["adapter"])[0])
    reps = [InProcessReplica(_engine(m, paths), replica_id=i)
            for i in range(2)]
    router = Router(reps, _cfg(placement="adapter", probe_interval_s=0.02,
                               failure_threshold=2, dispatch_attempts=4,
                               gap_timeout_s=5.0, max_inflight=64))
    tracing.start_tracing()
    try:
        results = _run_clients(router, payloads, spread_s=0.05)
        for pl, w, (toks, term) in zip(payloads, want, results):
            assert term.get("done") is True, term
            assert toks == w
        homes = {}
        for pl, (_, term) in zip(payloads, results):
            if pl["adapter"]:
                homes.setdefault(pl["adapter"], set()).add(term["replica"])
        assert all(len(v) == 1 for v in homes.values()), homes
        # an unknown adapter: one typed terminal event, no strike
        toks, term = router.generate(_payload([1, 2, 3], adapter="ghost"))
        assert toks == [] and term["error"] == "adapter_load_failed"
        assert all(s["consecutive_failures"] == 0
                   for s in router.stats()["replicas"].values())
        # kill replica 1 mid-run: nothing lost, every stream exact
        faults.arm("serving.replica.kill", mode="nth", nth=30)
        results = _run_clients(router, payloads, spread_s=0.05)
        assert faults.fired("serving.replica.kill") == 1
        assert sum(r.dead_cause is not None for r in reps) == 1
        for w, (toks, term) in zip(want, results):
            assert term.get("done") is True, term
            assert toks == w
    finally:
        spans = tracing.stop_tracing()
        router.close()
        for rep in reps:
            rep.close()
    by_trace = {}
    for ev in spans:
        tid = ev["args"].get("trace_id")
        for t in [tid] + list(ev["args"].get("trace_ids", [])):
            if t:
                by_trace.setdefault(t, set()).add(ev["args"].get(
                    "component"))
    assert any({"router", "replica", "engine"} <= c
               for c in by_trace.values())
    dev = tmp_path / "device.json"
    dev.write_text(json.dumps({"traceEvents": [
        {"name": "gmm_fwd_wgmma_kernel", "ph": "X", "ts": 1, "dur": 2,
         "pid": 1, "tid": 7}]}))
    tracing.start_tracing()
    tracing.record_span("host", 0, 1000, {"component": "engine"})
    tracing.stop_tracing()
    out = tracing.export_chrome(str(tmp_path / "trace.json"),
                                device_trace_dir=str(dev))
    assert out["device_events"] == 1 and out["host_events"] == 1


def test_http_front_door_with_metrics(lora_model):
    m, paths = lora_model
    reps = [InProcessReplica(_engine(m, paths), replica_id=i)
            for i in range(2)]
    router = Router(reps, _cfg(placement="adapter"))
    srv = router.serve_http(0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200
        assert sorted(json.loads(resp.read())["healthy"]) == [0, 1]
        body = json.dumps(_payload(np.arange(5, 11), n=4, adapter="ten-a",
                                   tenant="acme"))
        conn.request("POST", "/generate", body,
                     {"Content-Type": "application/json"})
        evs = [json.loads(x) for x in
               conn.getresponse().read().decode().splitlines()]
        assert len([e for e in evs if "token" in e]) == 4
        assert evs[-1]["done"] is True
        conn.request("GET", "/stats")
        st = json.loads(conn.getresponse().read())
        assert st["completed"] == 1 and st["placement_mode"] == "adapter"
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
    finally:
        srv.shutdown()
        t.join(timeout=5)
        router.close()
        for rep in reps:
            rep.close()
    for name in ("router_completed_total", "router_replica_circuit",
                 "lora_active_adapters", "lora_tokens_total",
                 "serving_engine_committed_tokens_total"):
        assert name in text, name
    assert registry().snapshot()["router_completed_total"]["samples"]
