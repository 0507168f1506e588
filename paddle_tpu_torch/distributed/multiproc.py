"""Host collectives between rank processes, on numpy arrays and Python
objects (``paddle_tpu.distributed.multiproc`` counterpart).

Reference analog: the ProcessGroup eager collectives
(fluid/distributed/collective/process_group.h:47) over a group of OS
processes, used for object collectives, metadata exchange and control
traffic. The tensors of training never come here: they ride
``torch.distributed`` (``collective``).

Every collective runs over the job's TCPStore (``store``) and, above
``_SOCKET_THRESHOLD`` bytes, the rank-to-rank socket plane
(``socket_plane``). Only the member ranks of a group enter a call, so a
collective over a subgroup cannot block the other ranks. The full world
is the group of every rank: where the JAX package moves the full world's
arrays through ``jax.experimental.multihost_utils``, the port has no such
runtime, and this module uses no ``torch.distributed``, so it works
before ``init_parallel_env`` as the store does. A rank and the world size
are the launch contract's ``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM``.

Keys are namespaced by the job session (``PADDLE_JOB_SESSION``, a fresh
one a launch, so the keys of an earlier launch are invisible) and deleted
after the last member has read them, so a long run does not grow the
store.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = [
    "num_processes", "cross_process_active", "allgather_np", "allreduce_np",
    "broadcast_np", "subgroup_allgather_np", "subgroup_allreduce_np",
    "subgroup_broadcast_np",
    "exchange_objects", "broadcast_object", "scatter_objects", "barrier",
    "subgroup_barrier", "store_send", "store_recv",
]

_counters: dict[str, int] = {}


def _next(tag: str) -> int:
    _counters[tag] = _counters.get(tag, 0) + 1
    return _counters[tag]


def _session() -> str:
    """The job session's key namespace (set by the launcher; a restart
    gets a new one, so an earlier incarnation's keys are dead)."""
    return os.getenv("PADDLE_JOB_SESSION", "s0")


def num_processes() -> int:
    return int(os.getenv("PADDLE_TRAINERS_NUM", "1") or 1)


def cross_process_active() -> bool:
    return num_processes() > 1


def _rank() -> int:
    return int(os.getenv("PADDLE_TRAINER_ID", "0") or 0)


def _world(ranks):
    return list(range(num_processes())) if ranks is None else ranks


# ---- array collectives; `ranks` None is the full world --------------------

def allgather_np(arr, ranks=None) -> np.ndarray:
    """Gather each member's array: [len(ranks), *shape]."""
    return subgroup_allgather_np(arr, _world(ranks))


def _reduce_rows(gathered: np.ndarray, op: str) -> np.ndarray:
    if op == "sum":
        return gathered.sum(0)
    if op == "avg":
        return gathered.mean(0)
    if op == "max":
        return gathered.max(0)
    if op == "min":
        return gathered.min(0)
    if op == "prod":
        return gathered.prod(0)
    raise ValueError(f"unknown reduce op {op!r}")


def allreduce_np(arr, op: str = "sum", ranks=None) -> np.ndarray:
    return subgroup_allreduce_np(arr, _world(ranks), op)


def broadcast_np(arr, src: int = 0, ranks=None) -> np.ndarray:
    return subgroup_broadcast_np(arr, src, _world(ranks))


def barrier(name: str | None = None, ranks=None) -> None:
    subgroup_barrier(_world(ranks))


# ---- group collectives over the TCPStore ----------------------------------

def _store():
    from paddle_tpu_torch.distributed.store import \
        create_or_get_global_tcp_store

    return create_or_get_global_tcp_store()


# payloads above this ride the rank-to-rank socket plane (gloo-style;
# socket_plane.py): the store stays a rendezvous and control channel and
# never carries tensors of megabytes through its one server socket
_SOCKET_THRESHOLD = int(os.getenv("PADDLE_SOCKET_THRESHOLD", str(1 << 20)))
_SOCKET_MARKER = b"\x01PT_SOCKET_PLANE"


def _plane():
    from paddle_tpu_torch.distributed.socket_plane import plane

    return plane()


def _gc_keys(store, keys: list[str], ack_key: str, nmembers: int) -> None:
    """The last member to finish deletes the exchange's keys and the ack
    counter, so a step's traffic cannot grow the store without bound."""
    if store.add(ack_key, 1) == nmembers:
        for k in keys:
            store.delete_key(k)
        store.delete_key(ack_key)


def _group_prefix(kind: str, ranks) -> tuple[str, list[int]]:
    members = sorted(int(r) for r in ranks)
    if _rank() not in members:
        raise RuntimeError(
            f"rank {_rank()} entered a {kind} over group {members} it is not "
            "a member of (ProcessGroup semantics: only members participate)")
    tag = "-".join(map(str, members))
    seq = _next(f"{kind}/{tag}")
    return f"{_session()}/{kind}/{tag}/{seq}", members


def subgroup_allgather_np(arr, ranks) -> np.ndarray:
    """Gather the members' arrays [len(ranks), *shape]; only members
    enter. Large payloads move rank to rank over the socket plane (every
    member has the same shape, so all take the same route)."""
    pre, members = _group_prefix("sg", ranks)
    arr = np.asarray(arr)
    if arr.nbytes > _SOCKET_THRESHOLD:
        return _plane().allgather(arr, members, tag=pre)
    store = _store()
    store.set(f"{pre}/{_rank()}", pickle.dumps(arr))
    rows = [pickle.loads(store.wait(f"{pre}/{r}")) for r in members]
    _gc_keys(store, [f"{pre}/{r}" for r in members], f"{pre}/acks",
             len(members))
    return np.stack(rows)


def subgroup_allreduce_np(arr, ranks, op: str = "sum") -> np.ndarray:
    """The ring allreduce over the socket plane for large payloads
    (``SocketPlane.allreduce``, whose chunk order fixes the sum's order);
    small ones take the store allgather and a local reduce."""
    arr = np.asarray(arr)
    if arr.nbytes > _SOCKET_THRESHOLD:
        pre, members = _group_prefix("sar", ranks)
        return _plane().allreduce(arr, members, tag=pre, op=op)
    return _reduce_rows(subgroup_allgather_np(arr, ranks), op)


def subgroup_broadcast_np(arr, src: int, ranks) -> np.ndarray:
    """Only the src rank's payload crosses the wire. The receivers learn
    its route (inline in the store, or the socket plane) from the store's
    record, so the src's payload size alone decides it."""
    pre, members = _group_prefix("sb", ranks)
    store = _store()
    if _rank() == src:
        out = np.asarray(arr)
        if out.nbytes > _SOCKET_THRESHOLD:
            store.set(f"{pre}/v", _SOCKET_MARKER)
            _plane().broadcast(out, src, members, tag=pre)
        else:
            store.set(f"{pre}/v", pickle.dumps(out))
    else:
        raw = store.wait(f"{pre}/v")
        out = (_plane().recv(src, tag=pre) if raw == _SOCKET_MARKER
               else pickle.loads(raw))
    _gc_keys(store, [f"{pre}/v"], f"{pre}/acks", len(members))
    return out


def subgroup_barrier(ranks) -> None:
    pre, members = _group_prefix("bar", ranks)
    store = _store()
    if store.add(f"{pre}/n", 1) == len(members):
        store.set(f"{pre}/done", b"1")
    store.wait(f"{pre}/done")
    _gc_keys(store, [f"{pre}/n", f"{pre}/done"], f"{pre}/acks",
             len(members))


# ---- object collectives and p2p over the TCPStore --------------------------

def exchange_objects(obj, ranks=None) -> list:
    """All-gather picklable objects through the TCPStore. `ranks` is a
    member list, or an int world size meaning ranks 0..n-1."""
    if isinstance(ranks, int):
        ranks = range(ranks)
    pre, members = _group_prefix("og", ranks if ranks else _world(None))
    store = _store()
    store.set(f"{pre}/{_rank()}", pickle.dumps(obj))
    out = [pickle.loads(store.wait(f"{pre}/{r}")) for r in members]
    _gc_keys(store, [f"{pre}/{r}" for r in members], f"{pre}/acks",
             len(members))
    return out


def broadcast_object(obj, src: int = 0, ranks=None):
    """Only the src rank's object crosses the wire."""
    pre, members = _group_prefix("ob", ranks if ranks else _world(None))
    store = _store()
    if _rank() == src:
        store.set(f"{pre}/v", pickle.dumps(obj))
        out = obj
    else:
        out = pickle.loads(store.wait(f"{pre}/v"))
    _gc_keys(store, [f"{pre}/v"], f"{pre}/acks", len(members))
    return out


def scatter_objects(objs, src: int = 0, ranks=None):
    """src hands each member only its own object (the reference's
    scatter_object_list): a store key a member, each read by its member
    alone. Objects go in group order (the order of `ranks`), not in
    sorted-rank order."""
    order = list(ranks) if ranks else _world(None)
    pre, members = _group_prefix("so", order)
    store = _store()
    if _rank() == src:
        if objs is None or len(objs) != len(order):
            raise ValueError(
                f"scatter_objects: need {len(order)} objects, got "
                f"{0 if objs is None else len(objs)}")
        for r, o in zip(order, objs):
            if r != src:
                store.set(f"{pre}/{r}", pickle.dumps(o))
        out = objs[order.index(src)]
    else:
        out = pickle.loads(store.wait(f"{pre}/{_rank()}"))
    _gc_keys(store, [f"{pre}/{r}" for r in order if r != src],
             f"{pre}/acks", len(members))
    return out


def store_send(arr, dst: int) -> None:
    """A send addressed to a peer (the reference's isend,
    process_group.h:205); the sequence of each (src, dst) pair matches
    each send with one recv. A large payload rides the socket plane, and
    its store key carries only the route."""
    seq = _next(f"p2p/{_rank()}->{dst}")
    key = f"{_session()}/p2p/{_rank()}->{dst}/{seq}"
    a = np.asarray(arr)
    if a.nbytes > _SOCKET_THRESHOLD:
        _plane().send(a, dst, tag=key)
        _store().set(key, _SOCKET_MARKER)
        return
    _store().set(key, pickle.dumps(a))


def store_recv(src: int):
    seq = _next(f"p2p/{src}->{_rank()}")
    store = _store()
    key = f"{_session()}/p2p/{src}->{_rank()}/{seq}"
    raw = store.wait(key)
    out = (_plane().recv(src, tag=key) if raw == _SOCKET_MARKER
           else pickle.loads(raw))
    store.delete_key(key)          # read exactly once: delete it now
    return out
