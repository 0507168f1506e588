"""The direct rank-to-rank TCP data plane of the host collectives
(``paddle_tpu.distributed.socket_plane`` counterpart).

Reference analog: the gloo data plane behind ProcessGroupGloo
(fluid/distributed/collective/process_group_gloo.h): the TCPStore serves
rendezvous only (tcp_store.h:121), and bulk payloads move over dedicated
rank-to-rank connections, not through the store's server.

Each rank runs one accept loop on an ephemeral port, published in the
job's store as ``<session>/sockaddr/<rank>``. Sending to a peer uses this
rank's lazily dialled outbound connection, fed by a sender thread per
peer: posting a send never blocks, so symmetric exchanges cannot deadlock
on full socket buffers. Receiving sorts the inbound frames into a queue
per (source rank, tag). A frame carries (tag, dtype, shape) and the raw
bytes, written and read in 1 MiB pieces.

``multiproc`` routes payloads above its threshold here: group allgather
and broadcast exchange payloads peer to peer, ``store_send`` and
``store_recv`` ship the body over the socket (the store keeps a routing
record), and group allreduce runs the ring reduce-scatter and allgather.
A rank is the launch contract's ``PADDLE_TRAINER_ID``.
"""
from __future__ import annotations

import atexit
import os
import pickle
import queue
import socket
import struct
import threading

import numpy as np

__all__ = ["plane", "SocketPlane", "THREAD_PREFIX"]

_CHUNK = 1 << 20                 # socket read and write granularity
THREAD_PREFIX = "paddle_tpu_torch.socket_plane"


def _send_all(sock, data) -> None:
    view = memoryview(data)
    while view:
        n = sock.send(view[:_CHUNK])
        view = view[n:]


def _recv_into(sock, view) -> None:
    n = view.nbytes
    got = 0
    while got < n:
        r = sock.recv_into(view[got:got + _CHUNK])
        if r == 0:
            raise ConnectionError("socket plane: peer closed connection")
        got += r


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


def _rank() -> int:
    return int(os.getenv("PADDLE_TRAINER_ID", "0"))


class SocketPlane:
    """One a process; started at its first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._listener = None
        self._port = None
        self._out: dict[int, tuple] = {}          # dst -> (queue, thread)
        self._out_err: dict[int, BaseException] = {}
        self._in: dict[tuple, queue.Queue] = {}   # (src, tag) -> frames
        self._in_lock = threading.Lock()
        self._started = False

    # -- bring-up ------------------------------------------------------------

    def _session(self) -> str:
        return os.getenv("PADDLE_JOB_SESSION", "s0")

    def _store(self):
        from paddle_tpu_torch.distributed.store import \
            create_or_get_global_tcp_store

        return create_or_get_global_tcp_store()

    def ensure_started(self):
        with self._lock:
            if self._started:
                return
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("0.0.0.0", 0))
            srv.listen(64)
            self._port = srv.getsockname()[1]
            self._listener = srv
            threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"{THREAD_PREFIX}.accept").start()
            self._store().set(f"{self._session()}/sockaddr/{_rank()}",
                              f"{self._local_host()}:{self._port}".encode())
            self._started = True
            atexit.register(self.flush)

    def _local_host(self) -> str:
        """This rank's address as its peers reach it: PADDLE_LOCAL_HOST
        when set, else the interface that routes to the job's master
        (a UDP connect, which sends no packet), else loopback."""
        h = os.getenv("PADDLE_LOCAL_HOST")
        if h:
            return h
        master = os.getenv("PADDLE_MASTER")
        if master and ":" in master:
            mhost, mport = master.rsplit(":", 1)
            try:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    s.connect((mhost, int(mport)))
                    addr = s.getsockname()[0]
                finally:
                    s.close()
                if addr:
                    return addr
            except OSError:
                pass
        return "127.0.0.1"

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._reader, args=(conn,), daemon=True,
                             name=f"{THREAD_PREFIX}.reader").start()

    def _reader(self, conn):
        try:
            src = struct.unpack("!i", _recv_exact(conn, 4))[0]
            while True:
                hlen = struct.unpack("!i", _recv_exact(conn, 4))[0]
                header = pickle.loads(_recv_exact(conn, hlen))
                # straight into the destination array: no staging copy on
                # the bandwidth path
                arr = np.empty(header["shape"], dtype=header["dtype"])
                _recv_into(conn, memoryview(arr).cast("B"))
                self._inbox(src, header["tag"]).put(arr)
        except (ConnectionError, OSError):
            return

    def _inbox(self, src: int, tag: str) -> queue.Queue:
        with self._in_lock:
            q = self._in.get((src, tag))
            if q is None:
                q = queue.Queue()
                self._in[(src, tag)] = q
            return q

    def _sender(self, dst: int) -> queue.Queue:
        with self._lock:
            ent = self._out.get(dst)
            if ent is not None:
                return ent[0]
            q: queue.Queue = queue.Queue()

            def run():
                try:
                    addr = self._store().wait(
                        f"{self._session()}/sockaddr/{dst}").decode()
                    host, port = addr.rsplit(":", 1)
                    sock = socket.create_connection((host, int(port)))
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    _send_all(sock, struct.pack("!i", _rank()))
                    while True:
                        item = q.get()
                        try:
                            if item is None:
                                sock.close()
                                return
                            tag, arr = item
                            header = pickle.dumps(
                                {"tag": tag, "dtype": str(arr.dtype),
                                 "shape": arr.shape, "nbytes": arr.nbytes})
                            _send_all(sock, struct.pack("!i", len(header)))
                            _send_all(sock, header)
                            _send_all(sock, memoryview(arr).cast("B"))
                        finally:
                            q.task_done()
                except BaseException as e:  # recorded; the next send raises
                    self._out_err[dst] = e
                    while True:   # a sink: later enqueues are drained, so
                        q.get()   # flush() and join() cannot hang
                        q.task_done()

            t = threading.Thread(target=run, daemon=True,
                                 name=f"{THREAD_PREFIX}.sender.{dst}")
            t.start()
            self._out[dst] = (q, t)
            return q

    # -- p2p -----------------------------------------------------------------

    def send(self, arr: np.ndarray, dst: int, tag: str):
        """Enqueue a private copy of `arr` and return: the caller may
        change `arr` at once. Delivery completes by the next ``flush()``
        or at the interpreter's exit; a dead sender thread raises on the
        next send."""
        self.ensure_started()
        err = self._out_err.get(dst)
        if err is not None:
            raise ConnectionError(
                f"socket plane: sender to rank {dst} died: {err!r}") from err
        self._sender(dst).put((tag, np.array(arr, order="C", copy=True)))

    def flush(self):
        """Block until every enqueued send has gone out."""
        for dst, (q, _t) in list(self._out.items()):
            q.join()
            err = self._out_err.get(dst)
            if err is not None:
                raise ConnectionError(
                    f"socket plane: sender to rank {dst} died: {err!r}"
                ) from err

    def recv(self, src: int, tag: str, timeout: float = 300.0) -> np.ndarray:
        self.ensure_started()
        try:
            out = self._inbox(src, tag).get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"socket plane: recv from rank {src} (tag {tag!r}) timed "
                f"out after {timeout}s: the peer died or never sent; check "
                "the peer's log") from None
        # tags are used once (sequence-numbered): drop the emptied inbox so
        # the dict cannot grow over a long run
        with self._in_lock:
            q = self._in.get((src, tag))
            if q is not None and q.empty():
                del self._in[(src, tag)]
        return out

    # -- collectives ---------------------------------------------------------

    def allgather(self, arr: np.ndarray, members, tag: str) -> np.ndarray:
        """Send to every peer, then collect: [len(members), *shape]."""
        self.ensure_started()
        me = _rank()
        arr = np.asarray(arr)
        for r in members:
            if r != me:
                self.send(arr, r, tag)
        return np.stack([arr if r == me else self.recv(r, tag)
                         for r in members])

    def broadcast(self, arr, src: int, members, tag: str) -> np.ndarray:
        self.ensure_started()
        if _rank() == src:
            a = np.asarray(arr)
            for r in members:
                if r != src:
                    self.send(a, r, tag)
            return a
        return self.recv(src, tag)

    def allreduce(self, arr: np.ndarray, members, tag: str,
                  op: str = "sum") -> np.ndarray:
        """Ring reduce-scatter, then ring allgather: 2 (n - 1) / n of the
        payload a link. Chunk c is reduced starting at member c and then
        member c + 1, c + 2, ... around the ring (mod n), each member
        adding its own chunk to the partial it received."""
        self.ensure_started()
        members = list(members)
        n = len(members)
        if n == 1:
            return np.asarray(arr)
        i = members.index(_rank())
        nxt, prv = members[(i + 1) % n], members[(i - 1) % n]
        flat = np.asarray(arr).reshape(-1)
        pad = (-len(flat)) % n
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
        chunks = [c.copy() for c in np.split(flat, n)]

        def combine(a, b):
            if op in ("sum", "avg"):
                return a + b
            if op == "max":
                return np.maximum(a, b)
            if op == "min":
                return np.minimum(a, b)
            if op == "prod":
                return a * b
            raise ValueError(f"unknown reduce op {op!r}")

        # reduce-scatter: after n - 1 steps chunk (i + 1) mod n is complete
        for s in range(n - 1):
            send_c = (i - s) % n
            recv_c = (i - s - 1) % n
            self.send(chunks[send_c], nxt, f"{tag}/rs{s}")
            chunks[recv_c] = combine(chunks[recv_c],
                                     self.recv(prv, f"{tag}/rs{s}"))
        # allgather the completed chunks around the ring
        for s in range(n - 1):
            send_c = (i - s + 1) % n
            recv_c = (i - s) % n
            self.send(chunks[send_c], nxt, f"{tag}/ag{s}")
            chunks[recv_c] = self.recv(prv, f"{tag}/ag{s}")
        out = np.concatenate(chunks)
        if pad:
            out = out[:-pad]
        if op == "avg":
            out = out / n
        return out.reshape(np.asarray(arr).shape)


_plane: SocketPlane | None = None
_plane_lock = threading.Lock()


def plane() -> SocketPlane:
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = SocketPlane()
        return _plane
