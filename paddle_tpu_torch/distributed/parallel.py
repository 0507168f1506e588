"""Parallel bring-up and ``DataParallel`` (``paddle_tpu.distributed.parallel``
counterpart; reference: distributed/parallel.py:945 ``init_parallel_env``,
:202 ``DataParallel`` with the C++ EagerReducer).

``init_parallel_env(backend=None)`` reads the launch contract
(``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``, ``PADDLE_MASTER`` =
host:port, ``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``) and joins the
``torch.distributed`` process group, rendezvousing on the port's
``TCPStore`` (``distributed.store``: rank 0 hosts it at ``PADDLE_MASTER``)
presented to c10d as a ``torch.distributed.Store``.

The backend: ``nccl`` for CUDA ranks that each own a device, ``gloo``
for CPU ranks. Ranks that share one card (several ranks on one device,
as on a one-card machine) must ask for ``backend="gloo"``; gloo then
carries their CUDA tensors through host memory. ``nccl`` over ranks that
share a device raises, and so does the default there: the backend never
changes silently. A rank's device is ``device`` when given, else
``cuda:(local_rank % device_count)`` with CUDA, else the CPU.

``DataParallel`` broadcasts the parameters and buffers from the group's
first rank at wrap and averages the gradients over the group in
backward, bucketed (``reducer.GradReducer``); ``no_sync`` accumulates
locally and the next synced backward reduces the whole accumulated
gradient.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import threading

import torch
import torch.distributed as dist
from torch import nn

from paddle_tpu_torch.distributed.env import ParallelEnv

__all__ = ["init_parallel_env", "is_initialized", "get_backend",
           "DataParallel", "current_device"]

_STATE: dict = {}


def _reset():
    _STATE.clear()


class _StoreAdapter(dist.Store):
    """The port's ``TCPStore`` behind c10d's ``Store`` interface. One lock
    serialises the client's socket across c10d's threads."""

    def __init__(self, store, timeout: float):
        super().__init__()
        self._s = store
        self._timeout = timeout
        self._lock = threading.Lock()

    @staticmethod
    def _bytes(value) -> bytes:
        if isinstance(value, str):
            return value.encode()
        return bytes(value)

    def set(self, key, value):
        with self._lock:
            self._s.set(key, self._bytes(value))

    def get(self, key):
        with self._lock:
            self._s.wait([key], timeout=self._timeout)
            return self._s.get(key)

    def add(self, key, delta):
        with self._lock:
            return self._s.add(key, int(delta))

    def wait(self, keys, timeout=None):
        t = (timeout.total_seconds()
             if isinstance(timeout, datetime.timedelta) else self._timeout)
        with self._lock:
            self._s.wait(list(keys), timeout=t)

    def check(self, keys):
        with self._lock:
            return all(self._s.get(k) is not None for k in keys)

    def delete_key(self, key):
        with self._lock:
            return self._s.delete_key(key)

    def compare_set(self, key, expected, desired):
        with self._lock:
            cur = self._s.get(key)
            exp = self._bytes(expected)
            if (cur is None and not exp) or cur == exp:
                self._s.set(key, self._bytes(desired))
                return self._bytes(desired)
            return cur if cur is not None else exp

    def set_timeout(self, timeout):
        self._timeout = timeout.total_seconds()

    def clone(self):
        """A second client of the same server (c10d gives one to each
        backend that talks to the store from its own threads). The clone
        is kept referenced here: c10d holds only its C++ side, and its
        Python methods must outlive the process group."""
        from paddle_tpu_torch.distributed.store import TCPStore

        c = _StoreAdapter(
            TCPStore(self._s.host, self._s.port, is_master=False,
                     world_size=self._s.world_size, timeout=self._timeout),
            self._timeout)
        _STATE.setdefault("clones", []).append(c)
        return c


def _local_size(world: int) -> int:
    return int(os.getenv("PADDLE_LOCAL_SIZE", str(world)))


def _pick_device(device, local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def _pick_backend(backend, device: torch.device, world: int) -> str:
    """The c10d backend; raises rather than change the one asked for."""
    shared = (device.type == "cuda"
              and _local_size(world) > torch.cuda.device_count())
    if backend is None:
        if device.type != "cuda":
            return "gloo"
        backend = "nccl"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend 'nccl' needs CUDA ranks; this rank's "
                             f"device is {device}")
        if shared:
            raise ValueError(
                f"backend 'nccl' needs one device per rank, but "
                f"{_local_size(world)} ranks share "
                f"{torch.cuda.device_count()} device(s) on this host; ranks "
                f"that share a card must ask for backend='gloo'")
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    return "gloo"


def init_parallel_env(backend=None, device=None, timeout: float = 300.0):
    """Join the process group of the launch contract; returns a
    ``ParallelEnv``. A world of one without ``PADDLE_MASTER`` hosts its own
    store. Calling it again in a joined process returns at once."""
    from paddle_tpu_torch.distributed.store import TCPStore

    if dist.is_initialized():
        return ParallelEnv()
    world = int(os.getenv("PADDLE_TRAINERS_NUM", "1") or 1)
    rank = int(os.getenv("PADDLE_TRAINER_ID", "0") or 0)
    local_rank = int(os.getenv("PADDLE_LOCAL_RANK", str(rank)))
    dev = _pick_device(device, local_rank)
    name = _pick_backend(backend, dev, world)
    master = os.getenv("PADDLE_MASTER", "")
    if master and ":" in master:
        host, port = master.rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=(rank == 0),
                         world_size=world, timeout=timeout)
    elif world == 1:
        store = TCPStore("127.0.0.1", 0, is_master=True, timeout=timeout)
    else:
        raise RuntimeError("a multi-rank init_parallel_env needs "
                           "PADDLE_MASTER (host:port of rank 0's store)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    adapter = _StoreAdapter(store, timeout)
    _STATE["adapter"] = adapter
    dist.init_process_group(
        name, store=adapter, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    _STATE.update(store=store, device=dev, backend=name)
    return ParallelEnv()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_backend() -> str:
    return _STATE.get("backend", "")


def current_device() -> torch.device:
    """This rank's device (the CPU before ``init_parallel_env``)."""
    return _STATE.get("device", torch.device("cpu"))


class DataParallel(nn.Module):
    """Wraps a module for data parallelism (reference parallel.py:202):
    parameters and buffers broadcast from the group's first rank at wrap,
    gradients averaged over the group during backward by a bucketed
    ``GradReducer`` (``comm_buffer_size`` MB buckets, the first capped at
    ``last_comm_buffer_size``; ``find_unused_parameters`` zero-fills the
    parameters a backward left without a gradient). A group of one rank
    wraps without communicating."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        from paddle_tpu_torch.distributed import collective
        from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util \
            import sync_params_buffers
        from paddle_tpu_torch.distributed.reducer import GradReducer

        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group if group is not None else \
            collective.get_group(0)
        self._reducer = None
        if self._group.nranks > 1:
            sync_params_buffers(layers, comm_group=self._group,
                                src_rank=self._group.ranks[0])
            self._reducer = GradReducer(
                [p for p in layers.parameters() if p.requires_grad],
                comm_buffer_size=comm_buffer_size or 25,
                last_comm_buffer_size=last_comm_buffer_size,
                group=self._group,
                find_unused_parameters=find_unused_parameters)

    @property
    def reducer(self):
        return self._reducer

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)

    @contextlib.contextmanager
    def no_sync(self):
        """Accumulate gradients locally; the first backward after the
        block reduces the whole accumulated gradient (reference
        parallel.py:312)."""
        r = self._reducer
        old = r.enabled if r is not None else None
        if r is not None:
            r.enabled = False
        try:
            yield
        finally:
            if r is not None:
                r.enabled = old

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._layers.load_state_dict(*args, **kwargs)

    set_state_dict = load_state_dict

    def scale_loss(self, loss):
        # gradients are averaged by the reducer, so the loss is not scaled
        return loss
