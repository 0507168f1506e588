"""The port's HTTP replica transport on the CPU, after the JAX package's
``TestHTTPReplicaMatrix`` (``test_disagg.py``): `HTTPReplica` against live
endpoints of the port's ``inference/serve.py`` (``build_http_server`` over
host-only engines whose tokens are a function of prompt and index, so a
routed stream has an exact expected value), through the same router matrix
as ``InProcessReplica`` — probe and stream round trip, a dead endpoint as
``ReplicaDead``, a mid-stream fault and the ``serving.stream.cut`` chaos
point failing over exactly once, a dead endpoint tripping the breaker,
a 503 refusal excluded with no strike, a drain mid-stream.

Across packages: the port's `HTTPReplica` streaming from JAX's
``build_http_server`` and JAX's `HTTPReplica` streaming from the port's
give the events each package's own pair gives. And a port
``ServingEngine.serve_http`` endpoint behind ``HTTPReplica`` and the
router serves the engine's own greedy streams.
"""
import queue as queue_mod
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from paddle_tpu.distributed.resilience import faults as jax_faults
from paddle_tpu.serving.replica import HTTPReplica as JaxHTTPReplica
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.replica import (HTTPReplica,
                                              HTTPReplicaStream, ReplicaDead,
                                              StreamCut)
from paddle_tpu_torch.serving.router import Router
from paddle_tpu_torch.serving.scheduler import QueueFull

from test_torch_port_router import FakeEngine, _cfg, _expected, _payload


@pytest.fixture(autouse=True)
def _port_hygiene():
    before = set(threading.enumerate())
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    deadline = time.time() + 3.0

    def left():
        return [t for t in threading.enumerate()
                if t.name.startswith("paddle_tpu_torch.serving")
                and t not in before and t.is_alive()]

    while left() and time.time() < deadline:
        time.sleep(0.02)
    assert not left(), [t.name for t in left()]


def _serve_fake(eng, admit_fn=None, cut_after=None,
                build="paddle_tpu_torch"):
    """A live serve.py endpoint (the port's, or JAX's with
    ``build="paddle_tpu"``) over a host-only engine: the ndjson
    /generate + /healthz + /stats protocol ServingEngine.serve_http speaks.
    Returns (close, port)."""
    if build == "paddle_tpu":
        from paddle_tpu.inference.serve import build_http_server
    else:
        from paddle_tpu_torch.inference.serve import build_http_server

    lock = threading.Lock()
    stop = threading.Event()

    def generate_fn(payload, deadline):
        q = queue_mod.Queue()
        with lock:
            rid = eng.submit(np.asarray(payload["prompt_ids"], np.int32),
                             max_new_tokens=int(
                                 payload.get("max_new_tokens", 16)),
                             stream_cb=lambda req, tok: q.put(tok))
            req = eng.scheduler.get(rid)
        n = 0
        try:
            while True:
                if time.monotonic() > deadline:
                    yield {"rid": rid, "error": "timeout"}
                    return
                try:
                    tok = q.get(timeout=0.02)
                except queue_mod.Empty:
                    if req.finished and q.empty():
                        break
                    continue
                if cut_after is not None and n >= cut_after:
                    raise RuntimeError("injected transport fault")
                n += 1
                yield {"rid": rid, "token": int(tok)}
                if req.finished and q.empty():
                    break
            yield {"rid": rid, "done": True, "tokens": n}
        finally:
            with lock:
                if not req.finished:
                    eng.cancel(rid)
                eng.release(rid)

    def drive():
        while not stop.is_set():
            with lock:
                busy = not eng.scheduler.idle
                if busy:
                    eng.step()
            if not busy:
                time.sleep(0.002)

    srv = build_http_server(
        0, generate_fn=generate_fn, queue_limit=32, timeout_s=30.0,
        max_body_bytes=1 << 20, admit_fn=admit_fn,
        health_fn=lambda: {"ok": True, "role": "mixed", **eng.stats()},
        stats_fn=eng.stats)
    threads = [
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="paddle_tpu_torch.serving.test.http"),
        threading.Thread(target=drive, daemon=True,
                         name="paddle_tpu_torch.serving.test.driver"),
    ]
    for t in threads:
        t.start()

    def close():
        stop.set()
        srv.shutdown()
        srv.server_close()
        for t in threads:
            t.join(timeout=5.0)

    return close, srv.server_address[1]


@contextmanager
def _http_fleet(n=2, cut_after=None, admit0=None, step_delay_s=0.0):
    """N live endpoints wrapped in HTTPReplica transports; `cut_after` and
    `admit0` apply to endpoint 0 only (the fault target)."""
    engines = [FakeEngine(step_delay_s=step_delay_s) for _ in range(n)]
    closers, reps = [], []
    try:
        for i, eng in enumerate(engines):
            close, port = _serve_fake(
                eng, admit_fn=admit0 if i == 0 else None,
                cut_after=cut_after if i == 0 else None)
            closers.append(close)
            reps.append(HTTPReplica("127.0.0.1", port, replica_id=i,
                                    timeout_s=5.0))
        yield engines, reps, closers
    finally:
        for close in closers:
            close()


def _drain_stream(h, timeout_s=10.0):
    """Every event of one stream up to its terminal one (bounded)."""
    evs = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ev = h.next_event(0.5)
        if ev is None:
            continue
        evs.append(ev)
        if ev.get("done") or "error" in ev:
            break
    h.close()
    return evs


class TestHTTPReplicaMatrix:
    def test_probe_and_stream_roundtrip(self):
        with _http_fleet(n=1) as (engines, reps, _):
            rep = reps[0]
            pr = rep.probe()
            assert pr["ok"] is True and pr["replica"] == 0
            for k in ("queue_depth", "slot_fill", "free_pages"):
                assert k in pr, k
            p = np.arange(2, 8)
            evs = _drain_stream(rep.open_stream(_payload(p, n=4)))
            assert [e["token"] for e in evs if "token" in e] == \
                _expected(p, 4)
            assert evs[-1]["done"] and evs[-1]["tokens"] == 4
            # the endpoint's finally-block released engine bookkeeping
            deadline = time.time() + 2.0
            while engines[0].scheduler._by_rid and time.time() < deadline:
                time.sleep(0.01)
            assert engines[0].scheduler._by_rid == {}
            assert engines[0].allocator.used_pages == 0

    def test_dead_endpoint_probe_raises_replica_dead(self):
        with _http_fleet(n=1) as (_, reps, closers):
            closers[0]()
            closers.clear()            # already closed: skip double-close
            with pytest.raises(ReplicaDead):
                reps[0].probe()
            with pytest.raises(ReplicaDead):
                reps[0].open_stream(_payload(np.arange(1, 4)))

    def test_mid_stream_fault_fails_over_exactly_once(self):
        """Endpoint 0's stream dies after 2 tokens (the server surfaces
        the fault as a terminal error event): the router fails over and
        the client sees every token exactly once."""
        with _http_fleet(n=2, cut_after=2) as (_, reps, _c):
            evs = _drain_stream(reps[0].open_stream(
                _payload(np.arange(3, 9), n=6)))
            assert len([e for e in evs if "token" in e]) == 2
            assert "error" in evs[-1]
            r = Router(reps, _cfg(gap_timeout_s=2.0), start_monitor=False)
            try:
                p = np.arange(3, 9)
                toks, term = r.generate(_payload(p, n=6))
                assert toks == _expected(p, 6)
                assert term["done"] and term["failovers"] == 1
                assert term["replica"] == 1
                assert r._inflight == {}
            finally:
                r.close()

    def test_stream_cut_chaos_point_fails_over(self):
        """The transport chaos point fires inside the HTTP stream reader
        as it does for InProcessReplica."""
        with _http_fleet(n=2) as (_, reps, _c):
            r = Router(reps, _cfg(gap_timeout_s=2.0), start_monitor=False)
            try:
                faults.arm("serving.stream.cut")
                p = np.arange(5, 11)
                toks, term = r.generate(_payload(p, n=5))
                assert toks == _expected(p, 5)
                assert term["done"] and term["failovers"] == 1
                assert faults.fired("serving.stream.cut") == 1
            finally:
                r.close()

    def test_dead_endpoint_trips_breaker_routes_to_peer(self):
        with _http_fleet(n=2) as (_, reps, closers):
            r = Router(reps, _cfg(failure_threshold=2),
                       start_monitor=False)
            try:
                closers[0]()
                closers.pop(0)
                r.monitor_tick()
                r.monitor_tick()
                snap = r.stats()["replicas"]
                assert snap["0"]["circuit"] == "open"
                p = np.arange(4, 9)
                toks, term = r.generate(_payload(p))
                assert toks == _expected(p, 5)
                assert term["replica"] == 1 and term["failovers"] == 0
            finally:
                r.close()

    def test_queue_full_503_excluded_without_breaker_strike(self):
        refuse = {"status": 503, "retry_after": 0.1,
                  "message": "queue full"}
        with _http_fleet(n=2, admit0=lambda payload: refuse) \
                as (_, reps, _c):
            with pytest.raises(QueueFull):
                reps[0].open_stream(_payload(np.arange(6, 11)))
            r = Router(reps, _cfg(), start_monitor=False)
            try:
                p = np.arange(6, 11)
                toks, term = r.generate(_payload(p))
                assert toks == _expected(p, 5)
                assert term["replica"] == 1
                snap = r.stats()["replicas"]
                # backpressure is load, not ill health: no strike
                assert snap["0"]["consecutive_failures"] == 0
                assert snap["0"]["circuit"] == "closed"
            finally:
                r.close()

    def test_drain_mid_stream_fails_over(self):
        with _http_fleet(n=2, step_delay_s=0.01) as (_, reps, _c):
            r = Router(reps, _cfg(gap_timeout_s=2.0), start_monitor=False)
            try:
                p = np.arange(2, 9)
                out = {}

                def client():
                    out["r"] = r.generate(_payload(p, n=24))

                t = threading.Thread(target=client)
                t.start()
                # the router enters a request into _inflight before it binds
                # a replica; a drain in that window signals nothing, so
                # wait until the dispatch is bound to replica 0
                deadline = time.time() + 5.0
                while time.time() < deadline and not any(
                        c.replica_id == 0
                        for c in list(r._inflight.values())):
                    time.sleep(0.005)
                r.drain(0, why="maintenance")
                t.join(timeout=30.0)
                assert not t.is_alive()
                toks, term = out["r"]
                assert toks == _expected(p, 24)    # exactly once
                assert term["done"] and term["failovers"] == 1
                assert r.stats()["drained"] >= 1
                r.undrain(0)
            finally:
                r.close()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _events(rep_cls, server_build, p, n):
    """One stream's events through `rep_cls` on a `server_build`
    endpoint, with the per-engine rid dropped."""
    close, port = _serve_fake(FakeEngine(), build=server_build)
    try:
        rep = rep_cls("127.0.0.1", port, replica_id=0, timeout_s=5.0)
        probe = rep.probe()
        evs = _drain_stream(rep.open_stream(_payload(p, n=n)))
    finally:
        close()
    return probe, [{k: v for k, v in e.items() if k != "rid"} for e in evs]


@pytest.mark.parametrize("client,server", [
    ("port", "paddle_tpu"), ("jax", "paddle_tpu_torch")])
def test_cross_package_streams_equal(client, server):
    """The port's HTTPReplica on JAX's build_http_server, and JAX's on the
    port's: the events equal the port's own pair's."""
    p = np.arange(3, 12)
    rep_cls = HTTPReplica if client == "port" else JaxHTTPReplica
    probe, got = _events(rep_cls, server, p, 6)
    _, want = _events(HTTPReplica, "paddle_tpu_torch", p, 6)
    assert got == want
    assert [e["token"] for e in got if "token" in e] == _expected(p, 6)
    assert probe["ok"] and probe["replica"] == 0


def test_engine_serve_http_behind_router():
    """A port engine's serve_http endpoint behind HTTPReplica and the
    router: routed greedy streams equal the engine's own; a dead endpoint
    is ReplicaDead."""
    cfg = llama_tiny_config(num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    eng = ServingEngine(model, ServingConfig(
        page_size=4, num_pages=64, decode_batch=4, prefill_chunk=32,
        max_seq_len=64), device="cpu")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 12)]
    want = eng.generate(prompts, max_new_tokens=5)
    srv = eng.serve_http(0, block=False)
    rep = HTTPReplica("127.0.0.1", srv.server_address[1], replica_id=0,
                      timeout_s=5.0)
    r = Router([rep], _cfg(gap_timeout_s=5.0), start_monitor=False)
    try:
        assert rep.probe()["role"] == "mixed"
        got = [r.generate(_payload(p, n=5))[0] for p in prompts]
        assert got == want
    finally:
        r.close()
        eng.shutdown_http()
    with pytest.raises(ReplicaDead):
        rep.probe()
    assert eng.scheduler._by_rid == {}
    assert eng.allocator.used_pages == 0


class _Body:
    """A response body of fixed ndjson lines (then EOF)."""

    def __init__(self, lines):
        self._lines = list(lines)

    def readline(self):
        return self._lines.pop(0) if self._lines else b""

    def close(self):
        pass


@pytest.mark.parametrize("lines,want", [
    ([b'{"token": 7}\n', b'{"done": true}\n'], None),
    ([b'{"token": 7}\n'], StreamCut),              # body cut: no terminal
    ([b'not json\n'], StreamCut),
    ([b'{"error": "queue_full"}\n'], QueueFull)])
def test_stream_maps_protocol_lines(lines, want):
    """An HTTP stream maps a cut body or a malformed line to StreamCut and
    an in-stream queue_full to QueueFull, as JAX's does."""
    rep = HTTPReplica("127.0.0.1", 1, replica_id=3)
    h = HTTPReplicaStream(rep, _Body([]), _Body(lines))
    try:
        if want is None:
            assert _drain_stream(h) == [{"token": 7}, {"done": True}]
        else:
            with pytest.raises(want):
                _drain_stream(h)
    finally:
        h.close()
