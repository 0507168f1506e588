"""Cross-component span tracing with trace-id propagation
(``paddle_tpu.observability.tracing`` counterpart).

Spans carry a **trace id** across component boundaries: the router mints
one per request, it rides the payload / the Request object (like sampling
knobs) through replica -> engine -> scheduler -> decode step, so ONE
exported Chrome/Perfetto file shows a request's full path across threads
and components.

Contract:

  * `start_tracing()` / `stop_tracing()` bound a collection window (the
    module-level `_ACTIVE` flag keeps the off-path to one attribute read);
  * `span(name, component=..., trace_id=..., **attrs)` context manager
    records a Chrome `X` (complete) event with `args = {trace_id,
    component, **attrs}`; `trace_id=None` inherits the thread's current
    trace context;
  * `trace_context(trace_id)` sets that thread-local context — a worker
    picking up request R wraps its work in `trace_context(R.trace_id)` and
    every span lands correlated;
  * `export_chrome(path, device_trace_dir=...)` writes one
    ``{"traceEvents": [...]}`` JSON, merging the Chrome-format device
    traces under `device_trace_dir` (a file, or a directory searched for
    ``**/*.json[.gz]``): what ``torch.profiler``'s
    ``export_chrome_trace`` or its ``tensorboard_trace_handler`` write,
    so host spans and the card's kernels share one timeline.

Everything here is dependency-free host code, importable from the
scheduler/router hot paths.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import threading
import time
import uuid

__all__ = ["start_tracing", "stop_tracing", "tracing_active", "span",
           "trace_context", "current_trace_id", "new_trace_id",
           "record_span", "export_chrome", "events_snapshot"]

_ACTIVE = False
_lock = threading.Lock()
_events: list[dict] = []
_MAX_EVENTS = 1_000_000  # hard cap: tracing must never OOM the host
_tls = threading.local()
# os.getpid() is a system call each time: cache it
_PID = os.getpid()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def tracing_active() -> bool:
    return _ACTIVE


def start_tracing():
    """Begin a collection window (clears previously collected spans)."""
    global _ACTIVE
    with _lock:
        _events.clear()
    _ACTIVE = True


def stop_tracing() -> list:
    """End the window; returns the collected Chrome events."""
    global _ACTIVE
    _ACTIVE = False
    with _lock:
        return list(_events)


def events_snapshot() -> list:
    with _lock:
        return list(_events)


def reset():
    """Stop collection AND drop collected events (test isolation —
    stop_tracing alone keeps them for export)."""
    global _ACTIVE
    _ACTIVE = False
    with _lock:
        _events.clear()


def current_trace_id() -> str | None:
    return getattr(_tls, "trace_id", None)


@contextlib.contextmanager
def trace_context(trace_id: str | None):
    """Bind `trace_id` as this thread's current trace — spans inside
    inherit it. None is a no-op bind."""
    prev = getattr(_tls, "trace_id", None)
    _tls.trace_id = trace_id if trace_id is not None else prev
    try:
        yield
    finally:
        _tls.trace_id = prev


def record_span(name: str, begin_ns: int, dur_ns: int,
                args: dict | None = None):
    """Low-level sink: one Chrome complete event; the thread's current
    trace id is attached when the caller didn't set one."""
    if not _ACTIVE:
        return
    a = dict(args) if args else {}
    if "trace_id" not in a:
        tid = getattr(_tls, "trace_id", None)
        if tid is not None:
            a["trace_id"] = tid
    ev = {"name": name, "ph": "X", "ts": begin_ns / 1e3,
          "dur": dur_ns / 1e3, "pid": _PID,
          "tid": threading.get_ident(), "args": a}
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(ev)


class span:
    """Context manager recording one span when tracing is active. With
    `bind=True` (default) the span also binds its trace id as the thread
    context for its duration, so nested spans correlate. Pass `bind=False` when the span wraps a GENERATOR's
    lifetime (e.g. the router's per-request stream): a suspended
    generator's `with` stays entered across unrelated work on the
    consumer thread, and interleaved generators would restore the
    thread-local non-LIFO — the span still CARRIES the id, it just must
    not own the thread context."""

    __slots__ = ("name", "component", "trace_id", "attrs", "bind",
                 "_begin", "_prev")

    def __init__(self, name: str, component: str = "",
                 trace_id: str | None = None, bind: bool = True, **attrs):
        self.name = name
        self.component = component
        self.trace_id = trace_id
        self.bind = bind
        self.attrs = attrs
        self._begin = None
        self._prev = None

    def __enter__(self):
        if _ACTIVE:
            self._begin = time.perf_counter_ns()
            if self.trace_id is not None and self.bind:
                self._prev = getattr(_tls, "trace_id", None)
                _tls.trace_id = self.trace_id
        return self

    def __exit__(self, *a):
        if self._begin is not None:
            args = dict(self.attrs)
            if self.component:
                args["component"] = self.component
            if self.trace_id is not None:
                args["trace_id"] = self.trace_id
                if self.bind:
                    _tls.trace_id = self._prev
            record_span(self.name, self._begin,
                        time.perf_counter_ns() - self._begin, args)
            self._begin = None
        return False


def _device_trace_events(device_trace: str) -> list:
    """Chrome events of the device traces at `device_trace`: one file, or
    every ``*.json`` / ``*.json.gz`` under a directory (``torch.profiler``
    writes ``{"traceEvents": [...]}``, ``export_chrome_trace`` to a path of
    the caller's choosing, ``tensorboard_trace_handler`` as
    ``<worker>.<ts>.pt.trace.json``). An unreadable file becomes one
    instant event naming it."""
    if os.path.isfile(device_trace):
        paths = [device_trace]
    else:
        paths = []
        for pat in ("**/*.json", "**/*.json.gz"):
            paths += sorted(glob.glob(os.path.join(device_trace, pat),
                                      recursive=True))
    out = []
    for p in paths:
        try:
            if p.endswith(".gz"):
                with gzip.open(p, "rt") as f:
                    data = json.load(f)
            else:
                with open(p) as f:
                    data = json.load(f)
        except (OSError, ValueError) as e:
            out.append({"name": f"device-trace-unreadable: {p}: {e}",
                        "ph": "i", "ts": 0, "pid": 0, "tid": 0, "s": "g"})
            continue
        evs = (data.get("traceEvents", data)
               if isinstance(data, dict) else data)
        if isinstance(evs, list):
            out.extend(e for e in evs if isinstance(e, dict))
    return out


def export_chrome(path: str, device_trace_dir: str | None = None,
                  extra_events: list | None = None) -> dict:
    """Write the collected spans (plus optional merged device trace and
    caller-supplied events) as ONE Chrome trace file. Returns summary
    counts {host_events, device_events, path}."""
    with _lock:
        events = list(_events)
    n_host = len(events)
    if extra_events:
        events.extend(extra_events)
    n_dev = 0
    if device_trace_dir is not None and os.path.exists(device_trace_dir):
        dev = _device_trace_events(device_trace_dir)
        n_dev = len(dev)
        events.extend(dev)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return {"host_events": n_host, "device_events": n_dev, "path": path}
