"""Iteration-level (continuous-batching) scheduler
(``paddle_tpu.serving.scheduler`` counterpart; observability spans and
events, prefix adoption and the speculative write horizon wait for later
slices).

Requests join and leave the decode batch BETWEEN decode steps:
`admissions()` fills free decode slots from the waiting queue whenever the
allocator can back the whole context plus one step, `grow()` extends page
chains one decode step ahead, and page exhaustion triggers copy-free
eviction of the youngest running request, which re-queues at the FRONT to
be re-prefilled (prompt + tokens generated so far).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from paddle_tpu_torch.serving.kv_cache import PageAllocator

__all__ = ["Request", "RequestState", "ContinuousBatchingScheduler",
           "QueueFull"]


class QueueFull(RuntimeError):
    """Typed admission refusal: the WAITING queue is at its bound (the
    HTTP front-end maps it to 503 + Retry-After)."""

    def __init__(self, depth: int, limit: int):
        super().__init__(
            f"serving waiting queue full: {depth} queued >= "
            f"serving_waiting_queue_limit={limit}")
        self.depth = depth
        self.limit = limit


class RequestState(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"


_rid_counter = itertools.count()


@dataclass(eq=False)          # identity semantics: requests hold ndarrays
class Request:
    prompt: np.ndarray                      # int32 prompt token ids
    max_new_tokens: int = 16
    temperature: float = 0.0                # <= 0 -> greedy
    top_k: int = 0                          # <= 0 -> off
    top_p: float = 1.0                      # >= 1 -> off
    eos_id: int | None = None
    stream_cb: object = None                # callable(request, token) or None
    rid: int = field(default_factory=lambda: next(_rid_counter))
    state: RequestState = RequestState.WAITING
    generated: list = field(default_factory=list)
    arrival_t: float = field(default_factory=time.perf_counter)
    token_times: list = field(default_factory=list)
    evictions: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")

    @property
    def context(self) -> np.ndarray:
        """prompt + generated — what an eviction must re-prefill."""
        if not self.generated:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.generated, np.int32)])

    @property
    def total_len(self) -> int:
        return int(self.prompt.size) + len(self.generated)

    @property
    def finished(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED)


class ContinuousBatchingScheduler:
    def __init__(self, allocator: PageAllocator, max_batch: int,
                 max_seq_len: int, max_waiting: int = 0):
        self.allocator = allocator
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        # bound on NEW submissions only: eviction re-queues bypass it, so
        # a full queue can never deadlock an eviction. 0 = unbounded.
        self.max_waiting = int(max_waiting)
        self.waiting: list[Request] = []
        self.running: list[Request] = []        # admission order == age
        self._by_rid: dict[int, Request] = {}

    def submit(self, req: Request) -> int:
        limit = self.max_seq_len
        if req.prompt.size + req.max_new_tokens > limit:
            raise ValueError(
                f"request needs {req.prompt.size + req.max_new_tokens} "
                f"tokens > serving_max_seq_len={limit}")
        if self.max_waiting and len(self.waiting) >= self.max_waiting:
            raise QueueFull(len(self.waiting), self.max_waiting)
        self.waiting.append(req)
        self._by_rid[req.rid] = req
        return req.rid

    def get(self, rid: int) -> Request:
        return self._by_rid[rid]

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def oldest_wait_age(self) -> float:
        waiting = list(self.waiting)
        if not waiting:
            return 0.0
        now = time.perf_counter()
        return max(now - r.arrival_t for r in waiting)

    def admissions(self, limit: int = 0) -> list[Request]:
        """Pop waiting requests into free decode slots while the allocator
        can back each FULL context plus one decode step; `limit` caps the
        pops (0 = fill every slot). Admitted requests must be prefilled by
        the engine before the next decode step."""
        admitted = []
        while (self.waiting and
               len(self.running) + len(admitted) < self.max_batch and
               (not limit or len(admitted) < limit)):
            req = self.waiting[0]
            if not self.allocator.ensure(req.rid, req.total_len + 1):
                break                       # exhausted: keep FIFO order
            self.waiting.pop(0)
            req.state = RequestState.RUNNING
            admitted.append(req)
        return admitted

    def activate(self, req: Request):
        self.running.append(req)

    def grow(self) -> list[Request]:
        """Before a decode step every running request's chain must cover
        its context + the token the step writes. On exhaustion evict the
        YOUNGEST running request and retry (the requester itself can be
        the victim). Returns the evicted requests."""
        evicted = []
        for req in list(self.running):
            while req in self.running and not self.allocator.ensure(
                    req.rid, min(req.total_len, self.max_seq_len)):
                victim = self.running[-1]
                self._evict(victim)
                evicted.append(victim)
        return evicted

    def _evict(self, victim: Request):
        self.allocator.free_request(victim.rid)
        self.running.remove(victim)
        victim.state = RequestState.WAITING
        victim.evictions += 1
        self.waiting.insert(0, victim)

    def finish(self, req: Request, state: RequestState = RequestState.FINISHED):
        self.allocator.free_request(req.rid)
        if req in self.running:
            self.running.remove(req)
        req.state = state

    def cancel(self, rid: int) -> bool:
        req = self._by_rid.get(rid)
        if req is None or req.finished:
            return False
        if req in self.waiting:
            self.waiting.remove(req)
        self.finish(req, RequestState.CANCELLED)
        return True

    def release(self, rid: int):
        """Drop a FINISHED/CANCELLED request's bookkeeping entry."""
        req = self._by_rid.get(rid)
        if req is not None and req.finished:
            del self._by_rid[rid]
