"""Process-wide metrics registry — labeled counters / gauges / histograms
(``paddle_tpu.observability.metrics`` counterpart: a copy of that module,
which needs nothing but the standard library, so the two packages print
the same Prometheus text for the same registry operations).

This registry is the ONE place every component of the port reports
through:

  * **cheap updates** — child handles (`counter(...).labels(...)`) cache
    their value slot; updates take one striped lock (16 stripes keyed by
    the child's label hash), so concurrent decode/feeder/router threads
    never serialize on a single registry lock;
  * **collectors** — components that already keep their own honest
    counters (ServingEngine.stats(), Router.stats()) register a collector
    callback that maps them into gauges/counters AT SCRAPE TIME, so the
    hot path pays nothing. Collectors are owner-weakref'd: a dead engine's
    collector unregisters itself;
  * **snapshot()** — plain nested dicts for programmatic gates
    (bench_regression reads this);
  * **prometheus_text()** — text exposition format 0.0.4, served as
    ``GET /metrics`` by the serve.py chassis;
  * **export_jsonl()** — stream the snapshot into a LogWriter-like
    object (anything with ``add_scalar``/``add_text``).

The process-wide default lives behind `registry()`; tests isolate with
`MetricsRegistry()` instances or `registry().reset()`.
"""
from __future__ import annotations

import json
import math
import threading
import weakref

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram", "registry"]

_N_STRIPES = 16
_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    50.0, 100.0, 500.0, 1000.0, 5000.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape(v) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v) -> str:
    """HELP-line escaping per exposition format 0.0.4: ONLY backslash and
    newline (quotes stay literal — the label-value escaper would garble
    them in Prometheus/Grafana UIs)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Exposition-format number: integral values print without the trailing
    .0 (golden-test stable), non-finite as +Inf/-Inf/NaN."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Family:
    """One named metric family: children per label set. Label NAMES are
    fixed at registration; children are created on first `.labels()`."""

    kind = "untyped"

    def __init__(self, reg: "MetricsRegistry", name: str, help: str,
                 label_names: tuple):
        self._reg = reg
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: dict[tuple, object] = {}

    def labels(self, **labels):
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._reg._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child(self._reg._stripe(key))
                    self._children[key] = child
        return child

    def _default_child(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; use "
                f".labels(...)")
        return self.labels()

    def samples(self):
        """[(label_dict, child)] in stable (sorted label key) order."""
        return [(dict(k), c) for k, c in sorted(self._children.items())]


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    def _set_total(self, v: float):
        """Mirror a monotonic source (e.g. Router.completed) at scrape
        time — collector-only API. A LOWER value is accepted as a source
        reset (engine.reset_stats() between bench arms): standard
        Prometheus counter-reset semantics, which rate() handles."""
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Family):
    kind = "counter"

    def _make_child(self, lock):
        return _CounterChild(lock)

    def inc(self, n: float = 1.0):
        self._default_child().inc(n)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0):
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self, lock):
        return _GaugeChild(lock)

    def set(self, v: float):
        self._default_child().set(v)

    def inc(self, n: float = 1.0):
        self._default_child().inc(n)

    def dec(self, n: float = 1.0):
        self._default_child().dec(n)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, lock, bounds):
        self._lock = lock
        self.bounds = bounds                # ascending, +Inf implicit
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        v = float(v)
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def cumulative(self):
        """[(le, cumulative_count)] including the +Inf bucket."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        out, acc = [], 0
        for b, c in zip(self.bounds, counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), total))
        return out

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile estimate from the buckets (the
        p99 the bench gates read — honest to bucket resolution)."""
        cum = self.cumulative()
        if not self.count:
            return 0.0
        target = q * self.count
        lo = 0.0
        prev = 0
        for le, acc in cum:
            if acc >= target:
                if math.isinf(le):
                    return lo  # best estimate: the last finite bound
                span = acc - prev
                frac = (target - prev) / span if span else 1.0
                return lo + (le - lo) * frac
            lo, prev = (0.0 if math.isinf(le) else le), acc
        return lo


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, reg, name, help, label_names,
                 buckets=_DEFAULT_BUCKETS):
        super().__init__(reg, name, help, label_names)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _make_child(self, lock):
        return _HistogramChild(lock, self.buckets)

    def observe(self, v: float):
        self._default_child().observe(v)

    def quantile(self, q: float) -> float:
        return self._default_child().quantile(q)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        # [(fn, owner_weakref|None)] — owner-dead collectors are dropped
        self._collectors: list = []

    def _stripe(self, key) -> threading.Lock:
        return self._stripes[hash(key) % _N_STRIPES]

    def _get_or_create(self, cls, name, help, labels, **kw):
        fam = self._families.get(name)
        if fam is not None:
            if not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(self, name, help, tuple(labels), **kw)
                self._families[name] = fam
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}")
            return fam

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    # -- collectors ----------------------------------------------------------
    def add_collector(self, fn, owner=None):
        """`fn(registry)` runs before every snapshot/exposition. With
        `owner`, the collector lives exactly as long as the owner object
        (weakref) — a closed engine stops being scraped without explicit
        unregistration."""
        ref = weakref.ref(owner) if owner is not None else None
        with self._lock:
            self._collectors.append((fn, ref))

    def run_collectors(self):
        with self._lock:
            entries = list(self._collectors)
        dead = []
        for fn, ref in entries:
            if ref is not None and ref() is None:
                dead.append((fn, ref))
                continue
            fn(self)  # a broken collector should fail loudly, not hide
        if dead:
            with self._lock:
                self._collectors = [e for e in self._collectors
                                    if e not in dead]

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """{name: {"type", "help", "samples": [{"labels", ...}]}} — counters
        and gauges carry "value"; histograms carry "sum"/"count"/"buckets"
        ([le, cumulative] pairs) and a convenience "p50"/"p99"."""
        self.run_collectors()
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            samples = []
            for labels, child in fam.samples():
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels, "sum": child.sum,
                        "count": child.count,
                        "buckets": [["+Inf" if math.isinf(le) else le, c]
                                    for le, c in child.cumulative()],
                        "p50": child.quantile(0.50),
                        "p99": child.quantile(0.99)})
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "samples": samples}
        return out

    def prometheus_text(self) -> str:
        """Text exposition format 0.0.4 (the `GET /metrics` body)."""
        self.run_collectors()
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, child in fam.samples():
                base = ",".join(f'{k}="{_escape(v)}"'
                                for k, v in sorted(labels.items()))
                if fam.kind == "histogram":
                    # cumulative buckets, then sum/count (the format's
                    # required order)
                    for le, c in child.cumulative():
                        ls = (base + "," if base else "") + \
                            f'le="{_fmt(le)}"'
                        lines.append(f"{name}_bucket{{{ls}}} {c}")
                    lab = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{lab} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{lab} {child.count}")
                else:
                    lab = f"{{{base}}}" if base else ""
                    lines.append(f"{name}{lab} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def export_jsonl(self, writer, step: int = 0):
        """Write the snapshot through a LogWriter: one scalar event per
        counter/gauge sample (tag = name{labels}) and one text event per
        histogram (the full bucket table as JSON)."""
        snap = self.snapshot()
        for name, fam in snap.items():
            for s in fam["samples"]:
                base = ",".join(f'{k}={v}'
                                for k, v in sorted(s["labels"].items()))
                tag = f"{name}{{{base}}}" if base else name
                if fam["type"] == "histogram":
                    writer.add_text(tag, json.dumps(
                        {k: s[k] for k in ("sum", "count", "buckets",
                                           "p50", "p99")}), step)
                else:
                    writer.add_scalar(tag, s["value"], step)
        writer.flush()

    def reset(self):
        """Drop every family and collector (test isolation)."""
        with self._lock:
            self._families.clear()
            self._collectors.clear()


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry every component reports through."""
    return _default
