"""``paddle.distributed.spawn`` (``paddle_tpu.distributed.spawn``
counterpart; reference: distributed/spawn.py).

``spawn(func, args, nprocs)`` starts `nprocs` processes (the ``spawn``
start method: no state of the parent is forked) and runs ``func(*args)``
in each with the launch contract in its environment:
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
``PADDLE_LOCAL_SIZE`` and ``PADDLE_MASTER`` on a free loopback port, so
``func`` calls ``init_parallel_env()``. With ``join`` it waits for all of
them: a rank that exits non-zero, or a run past ``timeout`` seconds, kills
the rest and raises. ``nprocs`` of -1 or 0 runs ``func`` once in this
process; 1 or more start that many processes.
"""
from __future__ import annotations

import multiprocessing
import os
import socket
import time

__all__ = ["spawn", "free_port", "SpawnContext"]


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port nothing listens on right now."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _run(func, args, env):
    os.environ.update(env)
    func(*args)


class SpawnContext:
    """The started ranks; ``join(timeout)`` waits for them."""

    def __init__(self, procs):
        self.processes = procs

    def join(self, timeout: float | None = None):
        """Wait for every rank. Raises RuntimeError, after killing the
        others, when a rank exits non-zero or `timeout` seconds pass."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in self.processes]
                bad = [(r, c) for r, c in enumerate(codes)
                       if c is not None and c != 0]
                if bad:
                    raise RuntimeError(f"spawned rank(s) failed: "
                                       f"{', '.join(f'rank {r} exit {c}' for r, c in bad)}")
                if all(c == 0 for c in codes):
                    return True
                if deadline is not None and time.monotonic() > deadline:
                    hung = [r for r, c in enumerate(codes) if c is None]
                    raise RuntimeError(f"spawned rank(s) {hung} still running "
                                       f"after {timeout} s")
                self.processes[codes.index(None)].join(0.05)
        except BaseException:
            self.terminate()
            raise

    def terminate(self):
        for p in self.processes:
            if p.is_alive():
                p.kill()
        for p in self.processes:
            p.join(10)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False,
          timeout: float | None = None, env=None, **options):
    """Run ``func(*args)`` in `nprocs` new processes (see the module
    docstring); `env` adds variables to every rank's environment. Returns
    the ``SpawnContext``."""
    if nprocs in (-1, 0):
        func(*args)
        return None
    ctx = multiprocessing.get_context("spawn")
    master = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(nprocs):
        rank_env = {"PADDLE_TRAINER_ID": str(rank),
                    "PADDLE_TRAINERS_NUM": str(nprocs),
                    "PADDLE_LOCAL_RANK": str(rank),
                    "PADDLE_LOCAL_SIZE": str(nprocs),
                    "PADDLE_MASTER": master, **(env or {})}
        p = ctx.Process(target=_run, args=(func, args, rank_env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs)
    if join:
        context.join(timeout)
    return context
