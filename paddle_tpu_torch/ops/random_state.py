"""The Paddle API's global random state (``paddle_tpu.ops.random_state``
counterpart): ``paddle.seed`` and the port's explicit generators.

A ``Generator`` holds one seed and, lazily, one ``torch.Generator`` per
device seeded from it, so every random op of the Paddle API (creation ops,
initializers, dropout) is reproducible from ``seed()`` on each device. The
streams are torch's (Philox on CUDA, Mersenne Twister on the CPU), not the
JAX package's threefry: the same seed gives other numbers there, and on
the card other numbers than on the CPU. torch's own global generator is
left alone.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "default_generator", "Generator", "active_generator"]


class Generator:
    def __init__(self, seed_: int = 0):
        self._lock = threading.Lock()
        self._seed = int(seed_)
        self._gens: dict = {}

    def manual_seed(self, seed_: int):
        with self._lock:
            self._seed = int(seed_)
            self._gens = {}
        return self

    def initial_seed(self) -> int:
        return self._seed

    def torch_generator(self, device: torch.device) -> torch.Generator:
        """The ``torch.Generator`` of `device`, seeded at first use."""
        key = (device.type, device.index or 0)
        with self._lock:
            gen = self._gens.get(key)
            if gen is None:
                gen = torch.Generator(device=device).manual_seed(self._seed)
                self._gens[key] = gen
            return gen

    def get_state(self) -> dict:
        """A snapshot: the seed and each device generator's state."""
        with self._lock:
            return {"seed": self._seed,
                    "states": {k: g.get_state() for k, g in
                               self._gens.items()}}

    def set_state(self, state: dict):
        """Restore a ``get_state()`` snapshot: the same seed, and each
        device generator where it was (one drawn from since is reseeded
        at its next use)."""
        with self._lock:
            self._seed = int(state["seed"])
            self._gens = {}
            for (kind, index), st in state["states"].items():
                dev = torch.device(kind, index) if kind != "cpu" else \
                    torch.device("cpu")
                gen = torch.Generator(device=dev)
                gen.set_state(st)
                self._gens[(kind, index)] = gen


default_generator = Generator(0)

# the generator a ``fleet`` RNG-tracker scope (``rng_state``) has made
# current on this thread, else None
_active = threading.local()


def active_generator(device: torch.device) -> torch.Generator:
    """The generator random ops draw from on `device`: the one of the
    innermost RNG-tracker scope of this thread, else the global one."""
    fn = getattr(_active, "fn", None)
    if fn is not None:
        return fn(device)
    return default_generator.torch_generator(device)


def seed(s: int):
    """``paddle.seed``: reseed the global generator."""
    return default_generator.manual_seed(s)
