"""Fault-injection registry (``paddle_tpu.distributed.resilience.faults``
counterpart, the subset the serving sites need).

Subsystems register NAMED injection points where their code can fail and
call them on their hot path; tests arm a point to make it fire:

* ``faults.fire_check("serving.kv.promote_fail")`` returns True when the
  point is armed and triggered, and the site implements the failure;
* ``faults.arm(name)`` fires on the next hit, once (``mode="once"``);
  ``faults.arm(name, mode="always")`` fires on every hit until
  ``faults.disarm(name)`` (what the speculative verify's
  ``serving.spec.verify_mismatch`` chaos runs);
* ``faults.fired(name)`` counts the hits that fired since the last
  ``faults.reset()``, which disarms every point and zeroes the counts.

The JAX module's ``nth`` and ``prob`` trigger modes, arming from the
``FLAGS_fault_injection`` flag, the raising ``point()`` sites and the
per-point hit counters are not ported: no ported site uses them.
"""
from __future__ import annotations

import threading

__all__ = ["register", "arm", "disarm", "reset", "fire_check", "fired"]

_LOCK = threading.RLock()
_REGISTRY: dict[str, str] = {}          # point name -> what it simulates
_ARMED: dict[str, str] = {}             # armed point -> "once" | "always"
_FIRED: dict[str, int] = {}             # point -> hits that fired


def register(name: str, doc: str = "") -> str:
    """Declare an injection point (idempotent; called at import time by the
    module that owns the site)."""
    with _LOCK:
        _REGISTRY[name] = doc or _REGISTRY.get(name, "")
    return name


def arm(name: str, mode: str = "once"):
    """Arm a registered point: ``once`` fires on its next hit only,
    ``always`` on every hit until disarmed."""
    if mode not in ("once", "always"):
        raise ValueError(f"unknown fault trigger mode {mode!r} (the port "
                         f"arms once|always)")
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unknown fault point {name!r}; registered: "
                           f"{sorted(_REGISTRY)}")
        _ARMED[name] = mode


def disarm(name: str | None = None):
    """Disarm one point (or every point with no argument)."""
    with _LOCK:
        if name is None:
            _ARMED.clear()
        else:
            _ARMED.pop(name, None)


def reset():
    """Disarm every point and zero the fired counts."""
    with _LOCK:
        _ARMED.clear()
        _FIRED.clear()


def fired(name: str) -> int:
    """Hits at `name` that fired since the last ``reset()``."""
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unknown fault point {name!r}")
        return _FIRED.get(name, 0)


def fire_check(name: str) -> bool:
    """One hit at `name`: True when the point is armed (a ``once`` arming
    is spent by it)."""
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unregistered fault point {name!r} hit; "
                           f"register() it at import time of the module "
                           f"that owns the site")
        mode = _ARMED.get(name)
        if mode is None:
            return False
        if mode == "once":
            del _ARMED[name]
        _FIRED[name] = _FIRED.get(name, 0) + 1
        return True
