"""``paddle.distributed.rpc`` (``paddle_tpu.distributed.rpc`` counterpart;
reference: distributed/rpc/rpc.py, brpc with a master rendezvous there).

Remote execution over the job's TCPStore, with the JAX package's
semantics and key layout (not ``torch.distributed.rpc``): ``init_rpc``
registers ``rpc/worker/<name>`` and starts a serve thread that polls this
rank's inbox ``rpc/msg/<rank>/<seq>``; ``rpc_sync`` and ``rpc_async``
pickle (fn, args, kwargs) into the target's inbox and wait on
``rpc/res/<rank>/<seq>``. A function travels by its import path, so it
must be importable on the target. In a single process, or for a call to
oneself, the call runs locally.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos",
           "get_current_worker_info", "WorkerInfo", "THREAD_PREFIX"]

THREAD_PREFIX = "paddle_tpu_torch.rpc"
_POLL_S = 0.02          # the serve loop's inbox poll


@dataclass
class WorkerInfo:
    name: str
    rank: int
    ip: str = "127.0.0.1"
    port: int = 0


_workers: dict[str, WorkerInfo] = {}
_current: list = [None]
_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix=THREAD_PREFIX)
_serve_stop = threading.Event()
_serve_thread: list = [None]
_tls = threading.local()


def _cross_process() -> bool:
    from paddle_tpu_torch.distributed import multiproc

    return multiproc.cross_process_active()


def _store():
    """This thread's own client of the job's store: the serve loop and
    the async callers run on their own threads, and one store client
    socket shared between threads would interleave their requests."""
    from paddle_tpu_torch.distributed import multiproc
    from paddle_tpu_torch.distributed.store import TCPStore

    st = getattr(_tls, "store", None)
    if st is None:
        g = multiproc._store()
        st = TCPStore(g.host, g.port, is_master=False)
        _tls.store = st
    return st


def _serve_loop(rank: int):
    """Poll this rank's inbox, run each request, post its result. The
    consumed cursor lives in the store (``rpc/served/<rank>``), so a
    ``shutdown``/``init_rpc`` cycle resumes after the messages already
    served."""
    store = _store()
    nxt = store.add(f"rpc/served/{rank}", 0) + 1
    while not _serve_stop.is_set():
        payload = store.get(f"rpc/msg/{rank}/{nxt}")
        if payload is None:
            time.sleep(_POLL_S)
            continue
        _src, _seq, fn, args, kwargs = pickle.loads(payload)
        try:
            result = (True, fn(*args, **kwargs))
        except Exception as e:   # shipped back; the server keeps serving
            result = (False, f"{type(e).__name__}: {e}")
        store.set(f"rpc/res/{rank}/{nxt}", pickle.dumps(result))
        store.delete_key(f"rpc/msg/{rank}/{nxt}")
        store.add(f"rpc/served/{rank}", 1)
        nxt += 1


def init_rpc(name: str, rank: int | None = None,
             world_size: int | None = None,
             master_endpoint: str | None = None):
    """reference rpc.py ``init_rpc``: register and start serving."""
    if rank is None:
        rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
    info = WorkerInfo(name=name, rank=rank)
    _workers[name] = info
    _current[0] = info
    if _cross_process():
        if _serve_thread[0] is not None and _serve_thread[0].is_alive():
            # re-init: retire the serving thread first (two servers on one
            # inbox would race and run a request twice)
            _serve_stop.set()
            _serve_thread[0].join(2)
        _store().set(f"rpc/worker/{name}", pickle.dumps(info))
        _serve_stop.clear()
        t = threading.Thread(target=_serve_loop, args=(rank,), daemon=True,
                             name=f"{THREAD_PREFIX}.serve.{rank}")
        t.start()
        _serve_thread[0] = t
    return info


def _resolve(name: str) -> WorkerInfo:
    if name in _workers:
        return _workers[name]
    if _cross_process():
        info = pickle.loads(_store().wait(f"rpc/worker/{name}"))
        _workers[name] = info
        return info
    raise KeyError(f"unknown rpc worker '{name}'")


def _remote_call(info: WorkerInfo, fn, args, kwargs, timeout):
    store = _store()
    me = _current[0].rank if _current[0] else -1
    seq = store.add(f"rpc/q/{info.rank}", 1)
    store.set(f"rpc/msg/{info.rank}/{seq}",
              pickle.dumps((me, seq, fn, args, kwargs)))
    payload = store.wait(f"rpc/res/{info.rank}/{seq}", timeout=timeout)
    store.delete_key(f"rpc/res/{info.rank}/{seq}")
    ok, value = pickle.loads(payload)
    if not ok:
        raise RuntimeError(f"rpc to '{info.name}' failed remotely: {value}")
    return value


def _local(info: WorkerInfo) -> bool:
    me = _current[0]
    return not _cross_process() or (me is not None and info.rank == me.rank)


def rpc_sync(to: str, fn, args=None, kwargs=None, timeout=None):
    args, kwargs = args or (), kwargs or {}
    info = _resolve(to)
    if _local(info):
        return fn(*args, **kwargs)
    return _remote_call(info, fn, args, kwargs, timeout)


def rpc_async(to: str, fn, args=None, kwargs=None, timeout=None) -> Future:
    args, kwargs = args or (), kwargs or {}
    info = _resolve(to)
    if _local(info):
        return _pool.submit(fn, *args, **kwargs)
    return _pool.submit(_remote_call, info, fn, args, kwargs, timeout)


def shutdown():
    """reference rpc.py ``shutdown``: a barrier, so the requests in flight
    drain, then stop serving (also when the barrier raises)."""
    try:
        if _cross_process() and _current[0] is not None:
            from paddle_tpu_torch.distributed import multiproc

            multiproc.barrier()
    finally:
        _serve_stop.set()
        if _serve_thread[0] is not None:
            _serve_thread[0].join(2)
            _serve_thread[0] = None
        _workers.clear()
        _current[0] = None


def get_worker_info(name: str) -> WorkerInfo:
    return _resolve(name)


def get_all_worker_infos():
    return list(_workers.values())


def get_current_worker_info():
    return _current[0]
