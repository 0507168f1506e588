"""Structured event journal: ONE schema for lifecycle events
(``paddle_tpu.observability.events`` counterpart, a copy of that module,
which needs no JAX).

Every lifecycle transition (in the port: the tuning plane's
``autotune``, ``autotune_skip`` and ``cache_reject``) lands here as one
record:

    {"ts": <epoch s>, "component": "tuning|serving|...",
     "event": "<snake_case name>", "severity": "info|warn|error",
     ...event-specific fields}

The journal is a bounded in-memory ring (`recent()` is the operator's
post-mortem view and what tests assert on) plus optional durable sinks:
`attach(path)` appends JSONL (flushed per event: the log must survive
the crash it describes), `attach(writer)` streams through a LogWriter-like
object. Every emit also counts in the metrics registry as
``events_total{component,event}``, as in the JAX module.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["EventJournal", "journal", "emit"]

SCHEMA_FIELDS = ("ts", "component", "event", "severity")
SEVERITIES = ("info", "warn", "error")


class EventJournal:
    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=maxlen)
        self._files: dict[str, object] = {}      # path -> open file
        self._writers: list = []                 # LogWriter-likes
        self.emitted = 0
        self.sink_errors: list[str] = []

    def _sink_error(self, sink, e):
        # a broken sink (full disk, closed writer) must never crash the
        # EMITTER — journal emits sit on recovery paths and
        # under component locks; record the failure and keep going
        import warnings

        msg = f"{type(e).__name__}: {e}"
        with self._lock:
            first = not self.sink_errors
            self.sink_errors.append(msg)
        if first:
            warnings.warn(f"event-journal sink failed ({msg}); events keep "
                          f"landing in the in-memory ring")

    def emit(self, component: str, event: str, severity: str = "info",
             **fields) -> dict:
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        for k in SCHEMA_FIELDS:
            if k in fields:
                raise ValueError(f"field {k!r} is part of the schema")
        rec = {"ts": round(time.time(), 3), "component": str(component),
               "event": str(event), "severity": severity, **fields}
        with self._lock:
            self._ring.append(rec)
            self.emitted += 1
            files = list(self._files.values())
            writers = list(self._writers)
        for f in files:
            try:
                f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
            except (OSError, ValueError) as e:
                self._sink_error(f, e)
        for w in writers:
            try:
                w.add_text(f"events/{component}/{event}",
                           json.dumps(rec, default=str))
            except (OSError, ValueError) as e:
                self._sink_error(w, e)
        from paddle_tpu_torch.observability import metrics as _m

        _m.registry().counter(
            "events_total", "structured journal events emitted",
            labels=("component", "event")).labels(
            component=component, event=event).inc()
        return rec

    def attach(self, sink):
        """`sink`: a filesystem path (JSONL, append, flushed per event) or
        a LogWriter-like with add_text()."""
        if isinstance(sink, str):
            with self._lock:
                if sink not in self._files:
                    self._files[sink] = open(sink, "a")
        else:
            with self._lock:
                self._writers.append(sink)

    def detach(self, sink):
        with self._lock:
            if isinstance(sink, str):
                f = self._files.pop(sink, None)
                if f is not None:
                    f.close()
            elif sink in self._writers:
                self._writers.remove(sink)

    def recent(self, n: int | None = None, component: str | None = None,
               event: str | None = None) -> list:
        with self._lock:
            recs = list(self._ring)
        if component is not None:
            recs = [r for r in recs if r["component"] == component]
        if event is not None:
            recs = [r for r in recs if r["event"] == event]
        return recs[-n:] if n else recs

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.emitted = 0

    def close(self):
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()
            self._writers.clear()


_default = EventJournal()


def journal() -> EventJournal:
    """The process-wide journal every component emits through."""
    return _default


def emit(component: str, event: str, severity: str = "info", **fields):
    """Shorthand for `journal().emit(...)` — the one-liner components
    call at lifecycle transitions."""
    return _default.emit(component, event, severity=severity, **fields)
