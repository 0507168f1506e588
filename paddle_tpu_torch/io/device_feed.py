"""Asynchronous device feed (``paddle_tpu.io.device_feed`` counterpart):
``DeviceFeeder``, ``prefetch_to_device``, ``LossFuture``,
``DispatchWindow``, ``FeederWorkerError``, ``interruptible_put`` and
``stop_and_join``.

A ``DeviceFeeder`` runs fetch and collate on a background thread and keeps
up to ``depth`` batches placed ahead of the training loop. For a CUDA
device the worker copies each leaf into a pinned host tensor and from there
to the card on a side stream, and records an event after the copies; the
consumer's stream waits on that event before it uses the batch, and each
leaf's ``record_stream`` tells the caching allocator that the consumer's
stream uses it, so the memory is not handed out again while that stream
still reads it. For the CPU device the leaves become CPU tensors. Worker
exceptions reach the consumer as ``FeederWorkerError`` with the batch
index and the phase (``collate`` or ``device_put``), the original as
``__cause__``; ``close()`` (also on exhaustion and by the context manager)
stops the worker, drains the queue and joins the thread. The fault points
``feeder.collate`` and ``feeder.device_put`` are the JAX package's.

Only the single-device layout is ported: a mesh (ROADMAP A8) raises.
``LossFuture`` and ``DispatchWindow`` are the step's run-ahead controls:
a step's loss is read on the host only when asked, and at most ``window``
steps are in flight (a CUDA event after each step; admitting one more
waits on the oldest).
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.distributed.resilience import faults

__all__ = ["DeviceFeeder", "FeederWorkerError", "prefetch_to_device",
           "LossFuture", "DispatchWindow", "interruptible_put",
           "stop_and_join"]

faults.register(
    "feeder.collate",
    "DeviceFeeder worker crash during fetch/collate of the next batch "
    "(a dataset/transform bug or a dying storage mount)")
faults.register(
    "feeder.device_put",
    "DeviceFeeder worker crash during the host->device placement of a "
    "collated batch")

# thread-name prefix of the port's io background threads
THREAD_PREFIX = "paddle_tpu_torch.io"


def interruptible_put(q: queue.Queue, item, stop: threading.Event,
                      poll: float = 0.05) -> bool:
    """Bounded put that stays interruptible: a producer blocked on a full
    queue re-checks `stop` every `poll` seconds. False when stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


def stop_and_join(q: queue.Queue, stop: threading.Event,
                  thread: threading.Thread, timeout: float = 5.0):
    """Producer teardown: signal stop, drain the queue so a blocked put
    wakes, then join the thread."""
    stop.set()
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
    if thread.is_alive() and thread is not threading.current_thread():
        thread.join(timeout=timeout)


def _tree_map(tree, fn):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(tree, out.append)
    return out


class LossFuture:
    """Deferred host read of a step's loss: ``float(f)`` / ``f.value()``
    waits for the step; ``ready()`` asks without waiting."""

    __slots__ = ("_value", "_event")

    def __init__(self, value, event=None):
        self._value = value
        self._event = event

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def value(self) -> float:
        return float(self._value)

    def block(self):
        if self._event is not None:
            self._event.synchronize()
        return self

    def __float__(self):
        return self.value()

    def __repr__(self):
        if self.ready():
            return f"LossFuture({float(self._value):.6g})"
        return "LossFuture(<pending>)"


def step_event(device):
    """A CUDA event recorded on `device`'s current stream (None for the
    CPU, where eager ops have finished when they return)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class DispatchWindow:
    """At most `window` un-fetched steps in flight: ``admit(event)`` queues
    a step's completion event and, past the window, waits on the oldest."""

    def __init__(self, window: int | None = None):
        if window is None:
            window = int(flag("async_dispatch_window"))
        self.window = max(int(window), 1)
        self._pending: collections.deque = collections.deque()

    def admit(self, event):
        self._pending.append(event)
        while len(self._pending) > self.window:
            ev = self._pending.popleft()
            if ev is not None:
                ev.synchronize()

    def drain(self):
        while self._pending:
            ev = self._pending.popleft()
            if ev is not None:
                ev.synchronize()

    def __len__(self):
        return len(self._pending)


class FeederWorkerError(RuntimeError):
    """A DeviceFeeder worker crash, raised in the consumer: ``batch_index``
    is the 0-based index of the batch being processed, ``phase`` is
    'collate' or 'device_put'; the original exception is ``__cause__``."""

    def __init__(self, phase: str, batch_index: int, cause: BaseException):
        super().__init__(
            f"DeviceFeeder worker crashed in {phase!r} of batch "
            f"{batch_index}: {cause!r}")
        self.phase = phase
        self.batch_index = batch_index


class _End:
    __slots__ = ()


class DeviceFeeder:
    """Fetch, collate and place an iterator's batches on a background
    thread, up to `depth` placed batches ahead (``prefetch_to_device_depth``
    by default). Batches keep their tuple/list/dict structure; numpy and
    tensor leaves arrive as tensors on `device`, other leaves as they
    are."""

    def __init__(self, iterator: Iterable, device=DEFAULT_DEVICE,
                 depth: int | None = None, mesh=None, batch_spec=None):
        if mesh is not None or batch_spec is not None:
            raise NotImplementedError(
                "DeviceFeeder places batches on one device; meshes and "
                "batch specs are ROADMAP A8")
        if depth is None:
            depth = int(flag("prefetch_to_device_depth")) or 2
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self.depth = depth
        self.batches_placed = 0
        self.leaves_transferred = 0
        self.batches_consumed = 0
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._it = iter(iterator)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"{THREAD_PREFIX}.DeviceFeeder")
        self._thread.start()

    # -- worker --------------------------------------------------------------
    def _host_leaf(self, v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if not isinstance(v, torch.Tensor):
            return v
        if self._cuda and not v.is_cuda:
            pinned = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            pinned.copy_(v)
            return pinned
        return v

    def _place_batch(self, batch):
        host = _tree_map(batch, self._host_leaf)
        if not self._cuda:
            placed, event = host, None
        else:
            with torch.cuda.stream(self._stream):
                placed = _tree_map(host, lambda v: v.to(
                    self.device, non_blocking=True)
                    if isinstance(v, torch.Tensor) else v)
                event = torch.cuda.Event()
                event.record(self._stream)
        self.leaves_transferred += sum(isinstance(v, torch.Tensor)
                                       for v in _leaves(placed))
        self.batches_placed += 1
        return placed, event

    def _run(self):
        phase = "collate"
        try:
            while not self._stop.is_set():
                phase = "collate"
                try:
                    faults.point("feeder.collate")
                    batch = next(self._it)
                except StopIteration:
                    break
                phase = "device_put"
                faults.point("feeder.device_put")
                item = self._place_batch(batch)
                if not interruptible_put(self._q, item, self._stop):
                    return
        except BaseException as e:
            err = FeederWorkerError(phase, self.batches_placed, e)
            err.__cause__ = e
            self._err = err
        finally:
            interruptible_put(self._q, _End, self._stop)

    # -- consumer ------------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _End:
            err = self._err
            self.close()
            if err is not None:
                self._err = None
                raise err
            raise StopIteration
        placed, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in _leaves(placed):
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)
        self.batches_consumed += 1
        return placed

    def close(self):
        """Stop the worker and join its thread (idempotent)."""
        stop_and_join(self._q, self._stop, self._thread)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(iterator: Iterable, device=DEFAULT_DEVICE,
                       depth: int = 2) -> DeviceFeeder:
    """Wrap `iterator` in a DeviceFeeder keeping `depth` placed batches
    ready; use it as a context manager (or exhaust it) so the worker
    thread is joined."""
    return DeviceFeeder(iterator, device=device, depth=depth)
