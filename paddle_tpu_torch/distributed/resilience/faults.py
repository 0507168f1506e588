"""Fault-injection registry (``paddle_tpu.distributed.resilience.faults``
counterpart, the subset the serving host tier needs).

Subsystems register NAMED injection points where their code can fail and
call them on their hot path; tests arm a point to make it fire:

* ``faults.fire_check("serving.kv.promote_fail")`` returns True when the
  point is armed and triggered, and the site implements the failure;
* ``faults.arm(name)`` fires on the next hit, once (the JAX module's
  ``mode="once"``);
* ``faults.reset()`` disarms every point.

The JAX module's other trigger modes (``nth``, ``prob``, ``always``),
arming from the ``FLAGS_fault_injection`` flag, the raising ``point()``
sites and the hit counters are not ported: no ported site uses them.
"""
from __future__ import annotations

import threading

__all__ = ["register", "arm", "reset", "fire_check"]

_LOCK = threading.RLock()
_REGISTRY: dict[str, str] = {}          # point name -> what it simulates
_ARMED: set[str] = set()                # points that fire on their next hit


def register(name: str, doc: str = "") -> str:
    """Declare an injection point (idempotent; called at import time by the
    module that owns the site)."""
    with _LOCK:
        _REGISTRY[name] = doc or _REGISTRY.get(name, "")
    return name


def arm(name: str):
    """Arm a registered point to fire on its next hit, once."""
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unknown fault point {name!r}; registered: "
                           f"{sorted(_REGISTRY)}")
        _ARMED.add(name)


def reset():
    """Disarm every point."""
    with _LOCK:
        _ARMED.clear()


def fire_check(name: str) -> bool:
    """One hit at `name`: True when the point is armed (which disarms it)."""
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"unregistered fault point {name!r} hit; "
                           f"register() it at import time of the module "
                           f"that owns the site")
        if name not in _ARMED:
            return False
        _ARMED.discard(name)
        return True
