"""The port's observability plane (``paddle_tpu.observability``
counterpart):

* `metrics`  — the process-wide registry of labeled counters, gauges and
  histograms, with scrape-time collectors, ``snapshot()`` and Prometheus
  text (``GET /metrics`` of the serving front-ends);
* `tracing`  — spans carrying a trace id from the router through the
  replica and the engine to the decode step, exported as one Chrome file
  with ``torch.profiler``'s device traces merged in;
* `events`   — the structured event journal (tuning, serving, router).
"""
from paddle_tpu_torch.observability import events, metrics, tracing  # noqa: F401
from paddle_tpu_torch.observability.events import EventJournal, journal
from paddle_tpu_torch.observability.metrics import (Counter, Gauge, Histogram,
                                                    MetricsRegistry, registry)
from paddle_tpu_torch.observability.tracing import (current_trace_id,
                                                    export_chrome,
                                                    new_trace_id, span,
                                                    start_tracing,
                                                    stop_tracing,
                                                    trace_context,
                                                    tracing_active)

__all__ = [
    "metrics", "tracing", "events",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "registry",
    "span", "start_tracing", "stop_tracing", "tracing_active",
    "trace_context", "current_trace_id", "new_trace_id", "export_chrome",
    "EventJournal", "journal",
]
