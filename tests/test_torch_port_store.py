"""The port's TCPStore and rank liveness on the CPU, after the JAX
package's ``test_native_core.py`` (the store) and ``test_router.py:736``:

* SET/GET/ADD/DELETE/WAIT and the barrier on the native (``csrc/store.cc``)
  and the pure-Python backends; a wait's and a barrier's timeout name the
  missing keys and ranks; the ``store.barrier`` chaos point absorbed by a
  retry and escalated when it persists;
* wire compatibility both ways: a port client on a JAX server and a JAX
  client on a port server, each side native or Python;
* ``RankHeartbeat`` and ``dead_peers`` (beating, stale, absent, tombstone,
  ``watch``) read by the port's and JAX's ``dead_peers`` on the same
  store;
* a killed replica's heartbeat corpse trips the router's breaker by name;
  ``InProcessReplica(store=)`` beats, goes stale on a kill and tombstones
  on a close.

Every wait is bounded (heartbeats at 20 ms, timeouts under a second), and
no ``paddle_tpu_torch.store`` or ``.serving`` thread may outlive a test.
"""
import struct
import threading
import time

import pytest

from paddle_tpu.distributed import store as jax_store
from paddle_tpu_torch.core.native import available
from paddle_tpu_torch.distributed import store as port_store
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.distributed.store import (RankHeartbeat, TCPStore,
                                                dead_peers)
from paddle_tpu_torch.serving.replica import InProcessReplica
from paddle_tpu_torch.serving.router import Router

from test_torch_port_router import FakeEngine, _cfg

BACKENDS = ["native", "python"]
HB_S = 0.02              # heartbeat interval of every case


@pytest.fixture(autouse=True)
def _port_hygiene():
    before = set(threading.enumerate())
    faults.reset()
    yield
    faults.reset()
    deadline = time.time() + 3.0

    def left():
        return [t for t in threading.enumerate()
                if t.name.startswith(("paddle_tpu_torch.store",
                                      "paddle_tpu_torch.serving"))
                and t not in before and t.is_alive()]

    while left() and time.time() < deadline:
        time.sleep(0.02)
    assert not left(), [t.name for t in left()]


def _use(monkeypatch, module, backend):
    """Select a package's store backend: "python" hides the native
    library, so a master starts the Python server and the Python client."""
    if backend == "python":
        monkeypatch.setattr(module, "_native_lib", lambda: None)
    elif not available():
        pytest.skip("no C++ toolchain: the native store cannot build")


@pytest.fixture(params=BACKENDS)
def master(request, monkeypatch):
    _use(monkeypatch, port_store, request.param)
    s = TCPStore(is_master=True, timeout=5.0)
    assert s.native == (request.param == "native")
    yield s
    s.close()


def test_native_store_builds_and_is_the_default():
    """With a toolchain the store's default backend is the native one."""
    assert available()
    s = TCPStore(is_master=True, timeout=5.0)
    try:
        assert s.native
        assert s.port > 0
    finally:
        s.close()


def test_set_get_add_delete_wait(master):
    client = TCPStore("127.0.0.1", master.port, is_master=False, timeout=5.0)
    try:
        client.set("hello", b"world")
        assert master.get("hello") == b"world"
        assert client.get("missing", default=None) is None
        client.set("obj", {"a": 1})          # non-bytes values pickle
        assert master.get("obj") is not None
        assert client.add("ctr", 5) == 5
        assert master.add("ctr", 2) == 7
        assert client.add("ctr", -10) == -3
        big = bytes(range(256)) * 8192       # 2 MiB: past the get buffer
        client.set("big", big)
        assert master.get("big") == big
        assert master.wait("big", timeout=1.0) == big
        assert client.delete_key("hello")
        assert not client.delete_key("hello")
        assert master.get("hello") is None

        results = []
        t = threading.Thread(
            target=lambda: results.append(client.wait("late", timeout=5)))
        t.start()
        time.sleep(0.1)
        master.set("late", b"arrived")
        t.join(5)
        assert results == [b"arrived"]
        assert client.wait(["late", "big"], timeout=1.0) == [b"arrived", big]
        with pytest.raises(TimeoutError, match=r"missing keys \['nope'\]") \
                as e:
            client.wait(["late", "nope"], timeout=0.2)
        assert "arrived: ['late']" in str(e.value)
    finally:
        client.close()


def test_native_large_value_read_again_once_at_its_size():
    """A value past the native read buffer is read once more, at the size
    the library reports, by ``get`` and by ``wait`` (it used to be read
    again at 4x the buffer until it fit)."""
    if not available():
        pytest.skip("no C++ toolchain: the native store cannot build")
    s = TCPStore(is_master=True, timeout=5.0)
    lib, calls = s._native, []

    class Counting:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name == "pt_store_get":
                return lambda *a: calls.append((name, a[3])) or fn(*a)
            if name == "pt_store_wait":
                return lambda *a: calls.append((name, a[4])) or fn(*a)
            return fn

    try:
        big = bytes(range(256)) * (5 * 4096)      # 5 MiB
        s.set("big", big)
        s._native = Counting()
        assert s.get("big") == big
        assert calls == [("pt_store_get", 1 << 20),
                         ("pt_store_get", len(big))]
        calls.clear()
        assert s.wait("big", timeout=1.0) == big
        assert calls == [("pt_store_wait", 1 << 20),
                         ("pt_store_get", len(big))]
    finally:
        s._native = lib
        s.close()


def test_barrier(master):
    clients = [TCPStore("127.0.0.1", master.port, is_master=False,
                        timeout=5.0) for _ in range(3)]
    done = []

    def enter(c, i):
        c.barrier("b1", 3, timeout=5, rank=i)
        done.append(i)

    threads = [threading.Thread(target=enter, args=(c, i))
               for i, c in enumerate(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    try:
        assert sorted(done) == [0, 1, 2]
        # a rank that never comes is named
        with pytest.raises(TimeoutError, match=r"missing ranks \[1\]"):
            clients[0].barrier("b2", 2, timeout=0.1, rank=0, retries=0)
    finally:
        for c in clients:
            c.close()


def test_barrier_chaos_point(master):
    """A transient ``store.barrier`` fault is absorbed by one retry; a
    persistent one escalates as TimeoutError after every attempt."""
    faults.arm("store.barrier")
    master.barrier("once", 1, timeout=1.0, retries=1, retry_backoff=0.01)
    assert faults.fired("store.barrier") == 1
    faults.arm("store.barrier", mode="always")
    with pytest.raises(TimeoutError, match="2 attempt"):
        master.barrier("always", 1, timeout=1.0, retries=1,
                       retry_backoff=0.01)


# ---------------------------------------------------------------------------
# wire compatibility with the JAX package's store
# ---------------------------------------------------------------------------
def _roundtrip(server, client):
    client.set("k", b"v1")
    assert server.get("k") == b"v1"
    server.set("s", b"from-server")
    assert client.get("s") == b"from-server"
    assert client.add("n", 3) == 3 and server.add("n", 4) == 7
    assert client.wait("s", timeout=1.0) == b"from-server"
    with pytest.raises(TimeoutError):
        client.wait("never", timeout=0.1)
    assert client.delete_key("k") and server.get("k") is None
    done = []
    t = threading.Thread(target=lambda: (client.barrier("wire", 2, timeout=5,
                                                        rank=1),
                                         done.append(1)))
    t.start()
    server.barrier("wire", 2, timeout=5, rank=0)
    t.join(5)
    assert done == [1]


@pytest.mark.parametrize("client_backend", BACKENDS)
@pytest.mark.parametrize("server_backend", BACKENDS)
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_wire_compatible_with_jax_store(monkeypatch, server_pkg,
                                        server_backend, client_backend):
    if server_pkg == "jax":
        srv_mod, cli_mod = jax_store, port_store
    else:
        srv_mod, cli_mod = port_store, jax_store
    with monkeypatch.context() as m:
        _use(m, srv_mod, server_backend)
        server = srv_mod.TCPStore(is_master=True, timeout=5.0)
    try:
        with monkeypatch.context() as m:
            _use(m, cli_mod, client_backend)
            client = cli_mod.TCPStore("127.0.0.1", server.port,
                                      is_master=False, timeout=5.0)
        try:
            _roundtrip(server, client)
        finally:
            client.close()
    finally:
        server.close()


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------
def _verdict(rows):
    return [(d["rank"], d["age_s"] is None) for d in rows]


def test_dead_peers_equal_jax(master):
    """Rank 0 beats, rank 1 stopped without a tombstone (stale), rank 2
    never beat (absent), rank 3 left cleanly (tombstone): the port's and
    JAX's dead_peers name the same ranks on the same store, with and
    without a watch dict."""
    beating = RankHeartbeat(master, "job", 0, interval_s=HB_S)
    stale = RankHeartbeat(master, "job", 1, interval_s=HB_S)
    left = RankHeartbeat(master, "job", 3, interval_s=HB_S)
    try:
        time.sleep(0.1)
        assert beating.beats >= 1
        # the first watched poll only primes: nothing beating is dead
        pw, jw = {}, {}
        first = dead_peers(master, "job", 4, timeout_s=0.15, watch=pw)
        assert _verdict(first) == [(2, True)]
        assert _verdict(jax_store.dead_peers(master, "job", 4,
                                             timeout_s=0.15, watch=jw)) \
            == _verdict(first)
        stale.stop(mark_clean=False)
        left.stop(mark_clean=True)
        assert struct.unpack("<d", master.get("__hb__/job/3"))[0] \
            == float("inf")
        # rank 1 may have beaten after the priming poll; a watched poll
        # reads its last stamp now, so its age runs from the stop
        dead_peers(master, "job", 4, timeout_s=0.15, watch=pw)
        jax_store.dead_peers(master, "job", 4, timeout_s=0.15, watch=jw)
        time.sleep(0.3)
        want = [(1, False), (2, True)]
        assert _verdict(dead_peers(master, "job", 4, timeout_s=0.15)) == want
        assert _verdict(jax_store.dead_peers(master, "job", 4,
                                             timeout_s=0.15)) == want
        assert _verdict(dead_peers(master, "job", 4, timeout_s=0.15,
                                   watch=pw)) == want
        assert _verdict(jax_store.dead_peers(master, "job", 4,
                                             timeout_s=0.15,
                                             watch=jw)) == want
        assert 3 not in pw and 3 not in jw     # a tombstone leaves watch
        ages = {d["rank"]: d["age_s"] for d in dead_peers(
            master, "job", 4, timeout_s=0.15)}
        assert ages[1] > 0.15
    finally:
        beating.stop()


def test_heartbeat_corpse_trips_breaker_by_name():
    """A killed replica's heartbeat goes stale (no tombstone) and the
    monitor trips its breaker from dead_peers(): the probe path (threshold
    99) is not what trips it."""
    store = TCPStore(is_master=True, timeout=5.0)
    assert store.native
    engines = [FakeEngine(), FakeEngine()]
    reps = [InProcessReplica(e, replica_id=i, store=store,
                             heartbeat_interval_s=HB_S)
            for i, e in enumerate(engines)]
    r = Router(reps, _cfg(failure_threshold=99), store=store,
               dead_timeout_s=0.12, start_monitor=False)
    try:
        r.monitor_tick()                  # primes the beat watch
        time.sleep(0.05)
        r.monitor_tick()
        assert r.stats()["replicas"]["1"]["circuit"] == "closed"
        reps[1].kill()
        cause = None
        for _ in range(60):
            time.sleep(0.05)
            r.monitor_tick()
            s = r.stats()["replicas"]["1"]
            if s["circuit"] == "open":
                cause = s["last_cause"]
                break
        assert cause is not None and "heartbeat stale" in cause
        assert r.stats()["replicas"]["0"]["circuit"] == "closed"
        assert _verdict(dead_peers(store, "serving-fleet", 2,
                                   timeout_s=0.12)) == [(1, False)]
    finally:
        r.close()
        for rep in reps:
            rep.close()
        store.close()


def test_inprocess_replica_store(master):
    """A replica beats rank == replica_id under its job id; a kill leaves
    the key stale, a close writes the tombstone."""
    reps = [InProcessReplica(FakeEngine(), replica_id=i, store=master,
                             job_id="fleet", heartbeat_interval_s=HB_S)
            for i in range(3)]
    try:
        time.sleep(0.1)
        assert dead_peers(master, "fleet", 3, timeout_s=0.5) == []
        reps[2].kill()
        reps[0].close()
        time.sleep(0.3)
        assert _verdict(dead_peers(master, "fleet", 3, timeout_s=0.15)) \
            == [(2, False)]
        assert _verdict(jax_store.dead_peers(master, "fleet", 3,
                                             timeout_s=0.15)) == [(2, False)]
    finally:
        for rep in reps:
            rep.close()


def test_create_or_get_global_tcp_store(monkeypatch):
    """Without PADDLE_MASTER the global store is a local master, made
    once; with it, a client of that address."""
    monkeypatch.setattr(port_store, "_global_store", [None])
    monkeypatch.delenv("PADDLE_MASTER", raising=False)
    s = port_store.create_or_get_global_tcp_store()
    try:
        assert port_store.create_or_get_global_tcp_store() is s
        monkeypatch.setattr(port_store, "_global_store", [None])
        monkeypatch.setenv("PADDLE_MASTER", f"127.0.0.1:{s.port}")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
        c = port_store.create_or_get_global_tcp_store()
        try:
            c.set("g", b"1")
            assert s.get("g") == b"1"
        finally:
            c.close()
    finally:
        s.close()
