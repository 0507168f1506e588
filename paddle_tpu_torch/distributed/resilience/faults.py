"""Fault-injection registry (``paddle_tpu.distributed.resilience.faults``
counterpart, the same vocabulary and trigger modes).

Subsystems register NAMED injection points where their code can fail and
call them on their hot path. Two site styles:

* ``faults.point("serving.replica.kill")`` — RAISES the point's exception
  class when armed and triggered (the stand-in for a crashed thread at
  that exact boundary);
* ``faults.fire_check("serving.kv.promote_fail")`` — returns True when
  armed and triggered, and the site implements the failure itself.

Arming, from code or from the ``FLAGS_fault_injection`` flag:

* ``faults.arm(name)`` — one-shot: fires on the next hit only;
* ``faults.arm(name, mode="nth", nth=8)`` — fires on the nth hit after
  arming;
* ``faults.arm(name, mode="prob", p=0.05, seed=7)`` — fires each hit with
  probability p from a SEEDED rng (deterministic chaos runs);
* ``faults.arm(name, mode="always")`` — fires on every hit until
  ``faults.disarm(name)``;
* ``FLAGS_fault_injection="serving.stream.cut"`` or
  ``"serving.replica.kill:nth=8;serving.lora.swap_fail:p=0.5,seed=7"`` —
  the same specs as a flag (';'-separated); ``check_flag_spec()`` parses
  it at construction (the replica and the router call it), so a typo
  fails there and not at the first site hit.

An arm() or a hit on an unregistered name raises KeyError. ``hits()`` and
``fired()`` count a point's hits and firings since ``reset()``, which
disarms everything and zeroes the counters.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

__all__ = [
    "FaultInjected", "register", "registered", "describe", "arm", "disarm",
    "reset", "point", "fire_check", "hits", "fired", "armed",
    "check_flag_spec",
]


class FaultInjected(RuntimeError):
    """Raised by an armed `point()` — the simulated kill/crash/corruption at
    that exact boundary. Subsystems may register subclasses (e.g. the
    checkpoint layer's CheckpointFaultInjected) so existing handlers keep
    catching their own fault type."""

    def __init__(self, point_name: str):
        super().__init__(point_name)
        self.point = point_name


@dataclass
class _Point:
    name: str
    doc: str
    exc: type
    hits: int = 0
    fired: int = 0


@dataclass
class _Arming:
    mode: str = "once"          # once | nth | prob | always
    nth: int = 1
    p: float = 0.0
    seen: int = 0               # hits observed since this arming
    spent: bool = False         # a once/nth arming that already fired
    exc: type | None = None     # overrides the point's registered class
    rng: random.Random = field(default_factory=lambda: random.Random(0))


_LOCK = threading.RLock()       # sites run on feeder/writer threads too
_REGISTRY: dict[str, _Point] = {}
_ARMED: dict[str, _Arming] = {}
# parsed cache of the FLAGS_fault_injection spec: (raw_string, {name: _Arming})
_FLAG_CACHE: tuple = ("", {})


def register(name: str, doc: str = "", exc: type = FaultInjected) -> str:
    """Declare an injection point (idempotent; called at import time by the
    module that owns the site). `exc` is the exception `point()` raises."""
    with _LOCK:
        pt = _REGISTRY.get(name)
        if pt is None:
            _REGISTRY[name] = _Point(name, doc, exc)
        else:  # re-import: refresh the declaration, keep the counters
            pt.doc = doc or pt.doc
            pt.exc = exc
    return name


def registered() -> tuple:
    """All registered point names (only sites whose modules are imported)."""
    with _LOCK:
        return tuple(sorted(_REGISTRY))


def describe() -> dict:
    """name -> one-line doc, the fault-point catalog."""
    with _LOCK:
        return {n: p.doc for n, p in sorted(_REGISTRY.items())}


def arm(name: str, mode: str = "once", nth: int = 1, p: float = 0.0,
        seed: int = 0, exc: type | None = None):
    """Arm a registered point from code. See the module docstring for the
    trigger modes."""
    if mode not in ("once", "nth", "prob", "always"):
        raise ValueError(f"unknown fault trigger mode {mode!r}")
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(
                f"unknown fault point {name!r}; registered: "
                f"{sorted(_REGISTRY)}")
        _ARMED[name] = _Arming(mode=mode, nth=int(nth), p=float(p), exc=exc,
                               rng=random.Random(seed))


def disarm(name: str | None = None):
    """Disarm one point (or all with no argument)."""
    with _LOCK:
        if name is None:
            _ARMED.clear()
        else:
            _ARMED.pop(name, None)


def reset():
    """Disarm everything and zero the hit/fired counters (test hygiene)."""
    global _FLAG_CACHE
    with _LOCK:
        _ARMED.clear()
        _FLAG_CACHE = ("", {})
        for pt in _REGISTRY.values():
            pt.hits = 0
            pt.fired = 0


def hits(name: str) -> int:
    with _LOCK:
        return _REGISTRY[name].hits


def fired(name: str) -> int:
    with _LOCK:
        return _REGISTRY[name].fired


def armed(name: str) -> bool:
    """True if the point currently has ANY live arming (API or flag
    spec)."""
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unknown fault point {name!r}")
        return _effective_arming(_REGISTRY[name]) is not None


def _parse_flag_spec(raw: str) -> dict:
    """``"name"`` / ``"name:nth=3"`` / ``"a;b:p=0.1,seed=7"`` -> armings."""
    out: dict[str, _Arming] = {}
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, opts = part.partition(":")
        kw = {"mode": "once", "nth": 1, "p": 0.0, "seed": 0}
        for opt in filter(None, (o.strip() for o in opts.split(","))):
            k, _, v = opt.partition("=")
            if k == "nth":
                kw.update(mode="nth", nth=int(v))
            elif k == "p":
                kw.update(mode="prob", p=float(v))
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "mode" or (k in ("once", "always") and not v):
                kw["mode"] = v or k
            else:
                raise ValueError(
                    f"bad FLAGS_fault_injection option {opt!r} in {part!r}")
        # a typo'd spec must fail loudly, not silently never fire — the
        # same contract arm() enforces on the API path
        if kw["mode"] not in ("once", "nth", "prob", "always"):
            raise ValueError(
                f"bad FLAGS_fault_injection mode {kw['mode']!r} in "
                f"{part!r} (once|nth|prob|always)")
        if kw["mode"] == "prob" and not kw["p"] > 0.0:
            raise ValueError(
                f"FLAGS_fault_injection prob arming needs p>0 in {part!r}")
        seed = kw.pop("seed")
        out[name.strip()] = _Arming(rng=random.Random(seed), **kw)
    return out


def check_flag_spec():
    """Parse FLAGS_fault_injection NOW so a malformed spec fails at
    configuration time. Without this the lazy parse inside `_evaluate`
    surfaces the ValueError at whichever injection site is hit first —
    e.g. on a replica's driver thread, where it would read as a replica
    death. The replica and the router call this at construction."""
    from paddle_tpu_torch.core.flags import flag

    global _FLAG_CACHE
    with _LOCK:
        raw = str(flag("fault_injection"))
        if raw != _FLAG_CACHE[0]:
            _FLAG_CACHE = (raw, _parse_flag_spec(raw))
        # arm()'s loud-failure contract for names too: a typo'd point in
        # the flag would otherwise silently never fire and the chaos run
        # would report a clean pass while testing nothing. Re-checked on
        # every call (not only on parse) — the registry may have grown
        # since the spec was first cached.
        unknown = sorted(n for n in _FLAG_CACHE[1] if n not in _REGISTRY)
        if unknown:
            raise KeyError(
                f"FLAGS_fault_injection names unknown fault point(s) "
                f"{unknown}; registered: {sorted(_REGISTRY)} (points "
                f"register at import of the module that owns the site)")


def _effective_arming(pt: _Point):
    """Resolution order: API arming > FLAGS_fault_injection spec. Called
    under _LOCK."""
    global _FLAG_CACHE
    a = _ARMED.get(pt.name)
    if a is not None:
        return None if a.spent else a
    from paddle_tpu_torch.core.flags import flag

    raw = str(flag("fault_injection"))
    if raw != _FLAG_CACHE[0]:
        # armings (and their once/nth progress) live as long as the flag
        # string is unchanged; any flag edit re-arms from scratch
        _FLAG_CACHE = (raw, _parse_flag_spec(raw))
    a = _FLAG_CACHE[1].get(pt.name)
    return None if a is None or a.spent else a


def _evaluate(name: str):
    """One hit at `name`: returns the exception CLASS to raise (or True for
    a non-raising trigger resolution) — None when the point stays quiet."""
    with _LOCK:
        pt = _REGISTRY.get(name)
        if pt is None:
            raise KeyError(
                f"unregistered fault point {name!r} hit; register() it at "
                f"import time of the module that owns the site")
        pt.hits += 1
        a = _effective_arming(pt)
        if a is None:
            return None
        a.seen += 1
        fire = False
        if a.mode == "once":
            fire, a.spent = True, True
        elif a.mode == "nth":
            if a.seen >= a.nth:
                fire, a.spent = True, True
        elif a.mode == "prob":
            fire = a.rng.random() < a.p
        elif a.mode == "always":
            fire = True
        if not fire:
            return None
        pt.fired += 1
        return a.exc or pt.exc


def point(name: str):
    """Injection site: raises the point's exception when armed + triggered,
    otherwise returns immediately (one dict lookup + counter on the quiet
    path)."""
    exc = _evaluate(name)
    if exc is not None:
        raise exc(name)


def fire_check(name: str) -> bool:
    """Injection site for CORRUPTION points: True when armed + triggered;
    the caller implements the corruption (poisoned batch, stalled readback)
    instead of raising."""
    return _evaluate(name) is not None
