"""TCPStore rendezvous and rank liveness (``paddle_tpu.distributed.store``
counterpart; reference: phi/core/distributed/store/tcp_store.h:121).

Backed by the port's native C++ server and client (``csrc/store.cc``, built
by ``core/native.py``): a length-prefixed key-value protocol with a blocking
``wait`` and an atomic ``add``, the one the JAX package's native core
speaks, so either package's client talks to either package's server. A
pure-Python twin of server and client serves hosts without a C++ toolchain;
``TCPStore.native`` says which one a store runs.

`RankHeartbeat` keeps a rank's ``__hb__/<job>/<rank>`` key fresh and
`dead_peers` names the ranks whose key went stale: the liveness the serving
router reads for its replicas (``Router(store=)``,
``InProcessReplica(store=)``).
"""
from __future__ import annotations

import ctypes
import errno
import os
import pickle
import socket
import struct
import threading
import time

from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.core.native import lib as _native_lib
from paddle_tpu_torch.distributed.resilience import faults

__all__ = ["TCPStore", "create_or_get_global_tcp_store", "RankHeartbeat",
           "dead_peers"]

faults.register(
    "store.barrier",
    "flaky rendezvous transport: one barrier wait attempt fails (the "
    "bounded retry-with-backoff must absorb a transient fault; a "
    "persistent one escalates as TimeoutError)")

_OP_SET, _OP_GET, _OP_ADD, _OP_WAIT, _OP_DELETE = range(5)
# thread-name prefix of the store's own threads (server, heartbeats): the
# port's tests check that none outlives a test
THREAD_PREFIX = "paddle_tpu_torch.store"


def _too_large_size(buf) -> int:
    """The size of a value that did not fit a native read's buffer (the
    library writes it to the buffer's first 8 bytes)."""
    need = struct.unpack("<q", bytes(buf[:8]))[0]
    if need >= 1 << 31:
        raise ConnectionError("TCPStore get: value too large")
    return need


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        c = sock.recv(n - len(buf))
        if not c:
            raise ConnectionError("TCPStore: connection closed")
        buf += c
    return buf


class _PyStoreServer:
    """The pure-Python server: the native server's semantics and wire
    protocol, for hosts without a C++ toolchain."""

    def __init__(self, port=0):
        self.data = {}
        self.cv = threading.Condition()
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.sock.bind(("0.0.0.0", port))
        except OSError:
            self.sock.close()  # don't leak the fd on a failed bind
            raise
        self.port = self.sock.getsockname()[1]
        self.sock.listen(64)
        self._running = True
        self._conns: set = set()
        self._threads: list = []
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True,
            name=f"{THREAD_PREFIX}.server.{self.port}")
        self._accept_thread.start()

    def _accept(self):
        while self._running:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with self.cv:
                if not self._running:
                    conn.close()
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True,
                                 name=f"{THREAD_PREFIX}.server.{self.port}")
            self._threads.append(t)
            t.start()

    def _serve(self, conn):
        try:
            while True:
                op = _recv_exact(conn, 1)[0]
                klen = struct.unpack("<I", _recv_exact(conn, 4))[0]
                key = _recv_exact(conn, klen).decode()
                vlen = struct.unpack("<I", _recv_exact(conn, 4))[0]
                val = _recv_exact(conn, vlen)
                status, out = 0, b""
                with self.cv:
                    if op == _OP_SET:
                        self.data[key] = val
                        self.cv.notify_all()
                    elif op == _OP_GET:
                        if key in self.data:
                            out = self.data[key]
                        else:
                            status = 1
                    elif op == _OP_ADD:
                        cur = struct.unpack(
                            "<q", self.data.get(key, b"\0" * 8))[0]
                        cur += struct.unpack("<q", val)[0]
                        self.data[key] = out = struct.pack("<q", cur)
                        self.cv.notify_all()
                    elif op == _OP_WAIT:
                        timeout = struct.unpack("<q", val)[0] / 1000.0
                        ok = self.cv.wait_for(
                            lambda: key in self.data or not self._running,
                            timeout)
                        if ok and key in self.data:
                            out = self.data[key]
                        else:
                            status = 1
                    elif op == _OP_DELETE:
                        status = 0 if self.data.pop(key, None) is not None \
                            else 1
                conn.sendall(bytes([status]) + struct.pack("<I", len(out))
                             + out)
        except (ConnectionError, OSError):
            pass
        finally:
            with self.cv:
                self._conns.discard(conn)
            conn.close()

    def stop(self):
        """Stop accepting, end blocked waits, shut every open connection
        and join every thread."""
        with self.cv:
            self._running = False
            for conn in self._conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self.cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self._accept_thread.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=5.0)


class _PyClient:
    # connect backoff: first retry after INITIAL_BACKOFF_S, doubling to
    # MAX_BACKOFF_S, each attempt bounded by the remaining deadline
    INITIAL_BACKOFF_S = 0.05
    MAX_BACKOFF_S = 2.0

    def __init__(self, host, port, timeout_ms):
        deadline = time.time() + timeout_ms / 1000.0
        backoff = self.INITIAL_BACKOFF_S
        attempts = 0
        last = None
        while True:
            remaining = deadline - time.time()
            if remaining <= 0 and attempts > 0:
                break
            attempts += 1
            try:
                self.sock = socket.create_connection(
                    (host, port), timeout=max(min(remaining, 5.0), 0.05))
                self.sock.settimeout(None)
                self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                     1)
                self._lock = threading.Lock()
                return
            except OSError as e:
                last = e
                time.sleep(min(backoff, max(deadline - time.time(), 0)))
                backoff = min(backoff * 2, self.MAX_BACKOFF_S)
        raise ConnectionError(
            f"TCPStore: cannot reach {host}:{port} after {attempts} "
            f"attempts over {timeout_ms / 1000.0:.1f}s "
            f"(exponential backoff {self.INITIAL_BACKOFF_S}s->"
            f"{self.MAX_BACKOFF_S}s): {last}")

    def request(self, op, key, val):
        kb = key.encode()
        msg = (bytes([op]) + struct.pack("<I", len(kb)) + kb
               + struct.pack("<I", len(val)) + val)
        with self._lock:
            self.sock.sendall(msg)
            st = _recv_exact(self.sock, 1)[0]
            n = struct.unpack("<I", _recv_exact(self.sock, 4))[0]
            out = _recv_exact(self.sock, n)
        return st, out

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class TCPStore:
    """Key-value store client, with the server embedded on the master.

    ``native`` is True when the C++ client (and, on the master, the C++
    server) runs; a master that cannot start the native server falls back
    to the Python server and pairs it with the Python client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = True, world_size: int = 1,
                 timeout: float = 300.0):
        self.timeout_ms = int(timeout * 1000)
        self._native = _native_lib()
        self._server = None
        self._srv_py = None
        self.world_size = int(world_size)
        if is_master:
            if self._native is not None:
                self._server = self._native.pt_store_server_start(port)
                if self._server:
                    port = self._native.pt_store_server_port(self._server)
                else:
                    self._server = None
            if self._server is None:
                try:
                    self._srv_py = _PyStoreServer(port)
                    port = self._srv_py.port
                    self._native = None  # py server => py client pairing
                except OSError as e:
                    if e.errno != errno.EADDRINUSE:
                        raise
                    # the port is already hosted (a launcher runs the
                    # server for the whole job): client only
                    self._srv_py = None
        self.host = host
        self.port = port
        if self._native is not None:
            self._client = self._native.pt_store_client_connect(
                host.encode(), port, self.timeout_ms)
            if not self._client:
                self._stop_servers()
                raise ConnectionError(f"TCPStore: cannot reach {host}:{port}")
        else:
            self._client = _PyClient(host, port, self.timeout_ms)

    @property
    def native(self) -> bool:
        """True when this store's client (and server, if it hosts one) is
        the native C++ one."""
        return self._native is not None

    # -- API (the reference Store interface) ---------------------------------
    def set(self, key: str, value):
        data = value if isinstance(value, bytes) else pickle.dumps(value)
        if self._native is not None:
            arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            rc = self._native.pt_store_set(self._client, key.encode(), arr,
                                           len(data))
            if rc != 0:
                raise ConnectionError("TCPStore set failed")
        else:
            self._client.request(_OP_SET, key, data)

    def get(self, key: str, default=None):
        if self._native is not None:
            return self._native_get(key, 1 << 20, default)
        st, out = self._client.request(_OP_GET, key, b"")
        return out if st == 0 else default

    def _native_get(self, key: str, cap: int, default=None):
        while True:
            buf = (ctypes.c_uint8 * cap)()
            n = self._native.pt_store_get(self._client, key.encode(), buf,
                                          cap)
            if n == -1:
                return default
            if n == -3:
                # larger than the buffer: it stays server-side, and its
                # size is in the buffer's first 8 bytes
                cap = max(_too_large_size(buf), cap + 1)
                continue
            if n < 0:
                raise ConnectionError("TCPStore get failed")
            return ctypes.string_at(buf, n)

    def add(self, key: str, delta: int = 1) -> int:
        if self._native is not None:
            res = self._native.pt_store_add(self._client, key.encode(), delta)
            if res == -(2 ** 63):
                raise ConnectionError("TCPStore add failed")
            return int(res)
        _, out = self._client.request(_OP_ADD, key, struct.pack("<q", delta))
        return struct.unpack("<q", out)[0]

    def delete_key(self, key: str) -> bool:
        """Remove a consumed key so the server does not grow without bound
        (reference Store::deleteKey)."""
        if self._native is not None:
            return self._native.pt_store_delete(self._client,
                                                key.encode()) == 0
        st, _ = self._client.request(_OP_DELETE, key, b"")
        return st == 0

    def wait(self, keys, timeout: float | None = None):
        """Block until every key exists. ONE deadline is shared across the
        keys, and a timeout names exactly which keys never arrived (and
        which did)."""
        total_s = timeout or self.timeout_ms / 1000.0
        deadline = time.time() + total_s
        if isinstance(keys, str):
            keys = [keys]
        outs, missing = [], []
        for key in keys:
            # past the deadline each remaining key still gets a quick
            # existence probe, so the error lists ALL missing keys
            tmo = max(int((deadline - time.time()) * 1000), 1)
            if self._native is not None:
                buf = (ctypes.c_uint8 * (1 << 20))()
                n = self._native.pt_store_wait(self._client, key.encode(),
                                               tmo, buf, len(buf))
                if n == -1:
                    missing.append(key)
                    outs.append(None)
                    continue
                if n == -3:
                    # the key exists but exceeds the buffer: re-read it
                    # at its size
                    outs.append(self._native_get(key,
                                                 _too_large_size(buf)))
                    continue
                if n < 0:
                    raise ConnectionError("TCPStore wait failed")
                outs.append(ctypes.string_at(buf, n))
            else:
                st, out = self._client.request(_OP_WAIT, key,
                                               struct.pack("<q", tmo))
                if st != 0:
                    missing.append(key)
                    outs.append(None)
                    continue
                outs.append(out)
        if missing:
            arrived = [k for k, o in zip(keys, outs) if o is not None]
            raise TimeoutError(
                f"TCPStore wait timed out after {total_s:.1f}s: "
                f"missing keys {missing}"
                + (f" (arrived: {arrived})" if arrived else ""))
        return outs[0] if len(outs) == 1 else outs

    def barrier(self, name: str, world_size: int, timeout: float = 300.0,
                rank: int | None = None, retries: int | None = None,
                retry_backoff: float = 0.25):
        """All-arrive barrier. With `rank` given each participant also
        marks a per-rank key, so a timeout names the ranks that never came.
        A timed-out (or transiently failed) wait is retried `retries` times
        (None reads FLAGS_store_barrier_retries) with exponential backoff
        before the TimeoutError escalates; arrival registers once, so a
        retry never double-counts a rank."""
        if retries is None:
            retries = int(flag("store_barrier_retries"))
        n = self.add(f"__barrier__/{name}", 1)
        if rank is not None:
            self.set(f"__barrier_arrived__/{name}/{rank}", b"1")
        if n == world_size:
            self.set(f"__barrier_done__/{name}", b"1")
        backoff = retry_backoff
        for attempt in range(retries + 1):
            try:
                faults.point("store.barrier")
                self.wait(f"__barrier_done__/{name}", timeout)
                return
            except (TimeoutError, faults.FaultInjected, ConnectionError):
                if attempt >= retries:
                    break
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
        arrived_n = struct.unpack(
            "<q", self.get(f"__barrier__/{name}", b"\0" * 8))[0]
        detail = f"{arrived_n}/{world_size} ranks arrived"
        if rank is not None:
            present = [r for r in range(world_size) if self.get(
                f"__barrier_arrived__/{name}/{r}") is not None]
            absent = [r for r in range(world_size) if r not in present]
            detail += f"; missing ranks {absent} (arrived: {present})"
        raise TimeoutError(
            f"TCPStore barrier '{name}' timed out after {retries + 1} "
            f"attempt(s) of {timeout:.1f}s (backoff {retry_backoff}s->"
            f"{backoff:.2f}s): {detail}") from None

    def _stop_servers(self):
        if self._server:
            self._native.pt_store_server_stop(self._server)
            self._server = None
        if self._srv_py is not None:
            self._srv_py.stop()
            self._srv_py = None

    def close(self):
        if self._client:
            if self._native is not None:
                self._native.pt_store_client_close(self._client)
            else:
                self._client.close()
            self._client = None
        self._stop_servers()


# -- rank liveness -----------------------------------------------------------
HEARTBEAT_PREFIX = "__hb__"
HEARTBEAT_THREAD_PREFIX = f"{THREAD_PREFIX}.heartbeat"


class RankHeartbeat:
    """Per-rank liveness beacon: a thread refreshes ``__hb__/<job>/<rank>``
    with the wall clock every `interval_s` (None reads
    FLAGS_store_heartbeat_interval_s), so `dead_peers()` names a dead rank
    within about two intervals. `stop()` joins the thread and by default
    writes the clean-exit tombstone (+inf), so a rank that shut down
    cleanly (tombstone: not dead) reads apart from one that died (stale
    stamp: dead, with its age) and one that never came up (no key)."""

    def __init__(self, store: TCPStore, job_id: str, rank: int,
                 interval_s: float | None = None):
        if interval_s is None:
            interval_s = float(flag("store_heartbeat_interval_s"))
        self.store = store
        self.key = f"{HEARTBEAT_PREFIX}/{job_id}/{int(rank)}"
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self.beats = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"{HEARTBEAT_THREAD_PREFIX}.{job_id}.{rank}")
        self._thread.start()

    def _run(self):
        while True:
            try:
                self.store.set(self.key, struct.pack("<d", time.time()))
                self.beats += 1
            except (ConnectionError, OSError):
                # a dead store means the job is coming down; keep trying
                # until stopped so a recovered store sees us alive
                pass
            if self._stop.wait(self.interval_s):
                return

    def stop(self, mark_clean: bool = True):
        """Stop beating and join the thread; by default write the
        clean-exit tombstone (+inf) so this rank never reads as a corpse."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if mark_clean:
            try:
                self.store.set(self.key, struct.pack("<d", float("inf")))
            except (ConnectionError, OSError):
                pass  # the store is gone: nothing left to mark

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()
        return False


def dead_peers(store: TCPStore, job_id: str, world_size: int,
               timeout_s: float | None = None,
               watch: dict | None = None) -> list:
    """Name the ranks whose heartbeat is stale or absent:
    ``[{"rank", "age_s"}]``, age_s None for a rank that never beat. A rank
    that wrote the clean-exit tombstone is not dead: it left. `timeout_s`
    defaults to 2.5 heartbeat intervals.

    Without `watch` the age compares the rank's wall-clock stamp with the
    local clock, which a skewed peer clock breaks. A polling monitor passes
    `watch`, a dict it keeps between calls: the age is then the local time
    since the rank's stamp last CHANGED, so clock skew cancels; the first
    poll only primes the dict."""
    if timeout_s is None:
        timeout_s = 2.5 * float(flag("store_heartbeat_interval_s"))
    now = time.time()
    out = []
    for r in range(int(world_size)):
        raw = store.get(f"{HEARTBEAT_PREFIX}/{job_id}/{r}")
        if raw is None:
            out.append({"rank": r, "age_s": None})
            continue
        beat = struct.unpack("<d", raw)[0]
        if beat == float("inf"):
            if watch is not None:
                watch.pop(r, None)
            continue  # clean exit, not a corpse
        if watch is not None:
            prev = watch.get(r)
            if prev is None or prev[0] != beat:
                watch[r] = (beat, now)
                continue  # a fresh (or first-seen) beat: alive
            age = now - prev[1]
        else:
            age = now - beat
        if age > timeout_s:
            out.append({"rank": r, "age_s": round(age, 2)})
    return out


_global_store = [None]


def create_or_get_global_tcp_store() -> TCPStore:
    """The job's store (reference: parallel.py:1101): a client of
    ``PADDLE_MASTER`` (host:port), master on ``PADDLE_TRAINER_ID`` 0, or a
    local master without it."""
    if _global_store[0] is None:
        master = os.getenv("PADDLE_MASTER", "")
        rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        if master and ":" in master:
            host, port = master.rsplit(":", 1)
            _global_store[0] = TCPStore(host, int(port),
                                        is_master=(rank == 0))
        else:
            _global_store[0] = TCPStore(is_master=True)
    return _global_store[0]
