"""Parallel-aware RNG state tracking (``paddle_tpu.distributed.fleet.rng``
counterpart; reference: fleet/layers/mpu/random.py:34
``RNGStatesTracker``, :99 ``get_rng_state_tracker``).

A named stream is a seed and, per device, an explicit ``torch.Generator``
seeded from it; ``rng_state(name)`` makes the stream current on this
thread, so the dropout inside the scope draws from it
(``ops.random_state.active_generator``). Tensor-parallel ranks add the
stream with their own seeds (``model_parallel_random_seed``): each mp
rank draws its own dropout masks, reproducibly, where the JAX package
folds the mesh-axis index into one key inside ``shard_map``.
"""
from __future__ import annotations

import contextlib

import torch

from paddle_tpu_torch.ops import random_state

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG",
           "model_parallel_rng"]

MODEL_PARALLEL_RNG = "model_parallel_rng"
model_parallel_rng = MODEL_PARALLEL_RNG


class RNGStatesTracker:
    def __init__(self):
        self.reset()

    def reset(self):
        self.states_: dict[str, dict] = {}
        self.seeds_: dict[str, int] = {}

    def add(self, name: str, seed: int):
        if int(seed) in self.seeds_.values():
            raise ValueError(f"seed {seed} already exists")
        if name in self.seeds_:
            raise ValueError(f"state {name} already exists")
        self.seeds_[name] = int(seed)
        self.states_[name] = {}

    def _generator(self, name: str, device: torch.device) -> torch.Generator:
        gens = self.states_[name]
        key = (device.type, device.index or 0)
        if key not in gens:
            gens[key] = torch.Generator(device=device).manual_seed(
                self.seeds_[name])
        return gens[key]

    def get_states_tracker(self):
        """{name: (seed, {device key: generator state})}."""
        return {n: (self.seeds_[n], {k: g.get_state()
                                     for k, g in self.states_[n].items()})
                for n in self.seeds_}

    def set_states_tracker(self, states):
        self.reset()
        for name, (seed, gens) in states.items():
            self.seeds_[name] = int(seed)
            self.states_[name] = {}
            for (dtype_, idx), st in gens.items():
                g = self._generator(name, torch.device(dtype_, idx))
                g.set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self.seeds_:
            raise ValueError(f"state {name} does not exist (add it first, "
                             f"e.g. by model_parallel_random_seed)")
        prev = getattr(random_state._active, "fn", None)
        random_state._active.fn = lambda dev: self._generator(name, dev)
        try:
            yield
        finally:
            random_state._active.fn = prev


_GLOBAL_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _GLOBAL_TRACKER


def model_parallel_random_seed(seed: int | None = None):
    """reference mpu/random.py ``model_parallel_random_seed``: the global
    seed for replicated randomness, and the tracker's
    ``model_parallel_rng`` stream seeded per mp rank."""
    import numpy as np

    from paddle_tpu_torch.distributed import fleet

    rank = fleet.get_hybrid_communicate_group().get_model_parallel_rank()
    if seed:
        global_seed, local_seed = int(seed), int(seed) * 1024 + rank * 100
    else:
        global_seed = int(np.random.randint(0, 655350))
        local_seed = int(np.random.randint(rank * 10000,
                                           (rank + 1) * 10000 - 1))
    _GLOBAL_TRACKER.reset()
    _GLOBAL_TRACKER.add(MODEL_PARALLEL_RNG, local_seed)
    random_state.seed(global_seed)
