"""Collective/step watchdog (``paddle_tpu.distributed.watchdog``
counterpart).

Reference parity: `CommTaskManager` + `CommTask` async-failure watchdog
(phi/core/distributed/comm_task_manager.h:37, comm_task.h:36): a thread
that tracks in-flight work and times out hangs.

The watchable unit is the training STEP. ``watch_step`` registers one as a
task and a waiter thread observes its completion: it synchronizes a CUDA
event (a step's ``LossFuture`` event, an event given directly, or one
recorded on the current stream for a CUDA tensor), where the JAX package
blocks on the step's arrays; any other object is read with
``np.asarray``. A task that does not complete within its timeout fires the
hang callback and the listeners with the structured diagnostics (the hung
task, the last completed step, every in-flight task, every thread's Python
stack): the analog of an NCCL hang report. The manager's poll thread is
``paddle_tpu_torch.watchdog``, the waiters ``paddle_tpu_torch.watchdog.
waiter``.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["CommTask", "CommTaskManager", "watch_step", "thread_stacks",
           "dump_state", "add_hang_listener", "THREAD_PREFIX"]

THREAD_PREFIX = "paddle_tpu_torch.watchdog"


@dataclass
class CommTask:
    task_id: int
    name: str
    started_at: float
    timeout_s: float
    done: threading.Event = field(default_factory=threading.Event)

    def mark_done(self):
        self.done.set()

    def elapsed(self) -> float:
        return time.time() - self.started_at

    def timed_out(self) -> bool:
        return not self.done.is_set() and self.elapsed() > self.timeout_s


class CommTaskManager:
    """reference: comm_task_manager.h:37 (loop :55)."""

    def __init__(self, default_timeout_s: float = 600.0,
                 poll_interval_s: float = 1.0,
                 on_hang: Callable[[CommTask], None] | None = None):
        self.default_timeout = default_timeout_s
        self.poll = poll_interval_s
        self.on_hang = on_hang or self._default_on_hang
        self._tasks: dict[int, CommTask] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_completed: CommTask | None = None
        self.hangs: list[CommTask] = []
        # hang listeners receive (task, diagnostics) AFTER on_hang: the
        # elastic checkpointer's save-and-stop hook registers here
        self._listeners: list[Callable] = []

    @staticmethod
    def _default_on_hang(task: CommTask):
        import sys

        print(f"[paddle_tpu_torch watchdog] step '{task.name}' (id "
              f"{task.task_id}) has not completed after "
              f"{task.elapsed():.0f}s - possible collective hang / dead "
              f"host", file=sys.stderr)

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=THREAD_PREFIX)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.poll):
            with self._lock:
                tasks = list(self._tasks.values())
            for t in tasks:
                if t.done.is_set():
                    with self._lock:
                        self._tasks.pop(t.task_id, None)
                    self.last_completed = t
                elif t.timed_out():
                    self.hangs.append(t)
                    self.on_hang(t)
                    diag = self.diagnostics(t)
                    for fn in list(self._listeners):
                        try:
                            fn(t, diag)
                        except Exception:  # a broken listener must not
                            import traceback  # end the watchdog loop

                            traceback.print_exc()
                    with self._lock:
                        self._tasks.pop(t.task_id, None)

    def begin(self, name: str, timeout_s: float | None = None) -> CommTask:
        with self._lock:
            self._next_id += 1
            t = CommTask(self._next_id, name, time.time(),
                         timeout_s or self.default_timeout)
            self._tasks[t.task_id] = t
        return t

    def diagnostics(self, task: CommTask | None = None,
                    py_stacks: bool = True) -> dict:
        """Structured hang report: the hung task (name/elapsed/timeout),
        the LAST COMPLETED step, every in-flight task's name and elapsed
        time, the hang count and, with `py_stacks`, every live thread's
        Python stack (where each is blocked)."""
        with self._lock:
            in_flight = [
                {"id": t.task_id, "name": t.name,
                 "elapsed_s": round(t.elapsed(), 2),
                 "timeout_s": t.timeout_s, "done": t.done.is_set()}
                for t in self._tasks.values()]
        diag = {
            "task": ({"id": task.task_id, "name": task.name,
                      "elapsed_s": round(task.elapsed(), 2),
                      "timeout_s": task.timeout_s} if task else None),
            "last_completed": ({"id": self.last_completed.task_id,
                                "name": self.last_completed.name}
                               if self.last_completed else None),
            "in_flight": in_flight,
            "hang_count": len(self.hangs),
        }
        if py_stacks:
            diag["threads"] = thread_stacks()
        return diag


def thread_stacks() -> list:
    """Python stack dump of every live thread: ``[{"name", "ident",
    "daemon", "stack": ["file:line in fn: source", ...]}]`` (innermost
    frame LAST)."""
    import sys
    import traceback

    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        stack = [
            f"{os.path.basename(fs.filename)}:{fs.lineno} in {fs.name}: "
            f"{(fs.line or '').strip()}"
            for fs in traceback.extract_stack(frame)]
        out.append({"name": t.name if t else f"<thread-{ident}>",
                    "ident": ident,
                    "daemon": bool(t.daemon) if t else None,
                    "stack": stack})
    return out


_manager = CommTaskManager()


def _completion(obj):
    """A callable that returns once `obj`'s step has finished: a CUDA
    event's synchronize (the event itself, a LossFuture's, or one recorded
    now after a CUDA tensor's producer), else a host read."""
    import torch

    if isinstance(obj, torch.cuda.Event):
        return obj.synchronize
    ev = getattr(obj, "_event", None)
    if isinstance(ev, torch.cuda.Event):
        return ev.synchronize
    val = getattr(obj, "_value", obj)
    if isinstance(val, torch.Tensor):
        if val.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(val.device))
            return ev.synchronize
        return lambda: None
    import numpy as np

    return lambda: np.asarray(val)


def watch_step(arrays, name: str = "train_step", timeout_s: float = 600.0,
               manager: CommTaskManager | None = None) -> CommTask:
    """Register a dispatched step; a waiter thread marks it done when its
    completion events (see ``_completion``) are reached."""
    mgr = manager or _manager
    mgr.start()
    task = mgr.begin(name, timeout_s)
    waits = [_completion(a) for a in (arrays if isinstance(
        arrays, (list, tuple)) else [arrays])]

    def waiter():
        try:
            for w in waits:
                w()
        finally:
            task.mark_done()

    threading.Thread(target=waiter, daemon=True,
                     name=f"{THREAD_PREFIX}.waiter").start()
    return task


def _dump_path():
    return os.path.join(os.getenv("PADDLE_LOG_DIR", "."),
                        f"comm_task_dump_{os.getpid()}.json")


def dump_state(manager: CommTaskManager | None = None) -> dict:
    """Per-task state dump (reference CommTaskManager async debug report,
    comm_task_manager.h:37): the diagnostics plus pid and the hang
    history, also written as JSON to ``$PADDLE_LOG_DIR`` (default the
    working directory) so a dead job leaves a diagnosable file."""
    import json

    mgr = manager or _manager
    state = mgr.diagnostics()
    state.pop("task", None)  # no single hung task in a full dump
    state["pid"] = os.getpid()
    state["hangs"] = [{"id": t.task_id, "name": t.name,
                       "elapsed_s": round(t.elapsed(), 2)}
                      for t in mgr.hangs]
    try:
        with open(_dump_path(), "w") as f:
            json.dump(state, f, indent=2)
    except OSError:
        pass
    return state


def _on_hang_with_dump(task: CommTask):
    CommTaskManager._default_on_hang(task)
    state = dump_state()
    import sys

    print(f"[paddle_tpu_torch watchdog] state dump "
          f"({len(state['in_flight'])} in-flight) written to "
          f"{_dump_path()}", file=sys.stderr)


def add_hang_listener(fn: Callable, manager: CommTaskManager | None = None):
    """Register `fn(task, diagnostics)` to fire after a hang is detected.
    Returns an uninstall callable. The elastic checkpointer's save-and-stop
    hook (``checkpoint.elastic.install_hang_handler``) registers through
    here."""
    mgr = manager or _manager
    mgr._listeners.append(fn)

    def uninstall():
        try:
            mgr._listeners.remove(fn)
        except ValueError:
            pass

    return uninstall


_manager.on_hang = _on_hang_with_dump
