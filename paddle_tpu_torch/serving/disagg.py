"""Disaggregated prefill/decode: prefill workers and the KV-page handoff
(``paddle_tpu.serving.disagg`` counterpart).

A DECODE-side engine admits a request, allocating its page chain in its own
pool, and POSTS a `PrefillJob` to the `HandoffChannel` instead of
prefilling inline. A `PrefillWorker` thread drains the channel, packs the
waiting prompts into ``[1, frame]`` segment-id flash frames (the engine's
packed prefill, first-fit over 32-aligned rows), runs them and delivers a
typed `KVHandoff` back; the decode side ingests it and activates the
request. Decode steps never wait behind prefill chunks.

Two handoff modes:

  * ``alias`` (the default): worker and decode engine share ONE page pool,
    so the prefill writes land in the pages the decode side already
    allocated and the handoff carries no bytes: it is the activation
    itself. The worker's device work runs under the engine's step lock, on
    the device's default stream the decode loop uses too.
  * ``copy``: the worker owns a side pool and a `PageAllocator`, prefills
    there, copies each page to host tensors (codes and scales together:
    the bytes a cross-host transport streams), and the decode side writes
    them into its chain.

Exactly-once recovery: a job whose worker died, whose handoff was dropped
or whose handoff is overdue is RECLAIMED: the decode side re-prefills it
locally into the same chain. Page writes are idempotent overwrites into
pages the request owns either way, so a worker killed mid-handoff
(``serving.prefill.kill``) or a dropped delivery (``serving.handoff.drop``)
gives the streams of a fault-free run: none lost, none activated twice
(`_pending_handoff` is popped exactly once, on the decode thread).

A worker's death is never swallowed: any exception on its thread (an
asynchronous CUDA error included) ends the worker, marks its in-flight
jobs failed and leaves its cause in ``dead_cause``; the decode side
reclaims those jobs.

Chaos points:

  * ``serving.prefill.kill`` — raises on the worker thread BETWEEN the
    device prefill and the handoff delivery (mid-handoff): the worker
    dies, its in-flight jobs mark failed, decode reclaims.
  * ``serving.handoff.drop`` — silently discards one delivered handoff:
    the decode side must time out and reclaim, never wedge.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.serving.kv_cache import PageAllocator

__all__ = ["PrefillJob", "KVHandoff", "HandoffChannel", "PrefillWorker",
           "build_disagg"]

faults.register(
    "serving.prefill.kill",
    "kills a prefill worker thread mid-handoff (after the device prefill, "
    "before the KVHandoff delivery): its in-flight jobs mark failed and "
    "the decode side must reclaim by re-prefilling locally — exactly-once "
    "streams, bit-equal to fault-free")
faults.register(
    "serving.handoff.drop",
    "silently discards one delivered KV-page handoff: the decode side "
    "must detect the overdue job (serving_handoff_timeout_s) and reclaim "
    "by re-prefilling locally, never wedge a stream")


@dataclass
class PrefillJob:
    """One posted prefill: the request's full prompt context and the page
    chain the decode side already allocated for it (a snapshot row; the
    allocator is only touched on the decode thread)."""
    rid: int
    tokens: np.ndarray            # int32 [L] full context to prefill
    page_row: np.ndarray          # int32 [pages_per_seq] chain snapshot
    posted_t: float
    trace_id: str = ""
    cancelled: bool = False       # set by decode: skip if not yet started
    failed: bool = False          # set by a dying worker: reclaim me


@dataclass
class KVHandoff:
    """One finished prefill, worker -> decode. ``pages`` is None in alias
    mode (the bytes are already in the shared pool) or, in copy mode, one
    dict of host tensors a page (pool name -> [L, Hkv, ps(, D)])."""
    rid: int
    n_pages: int
    ms: float                     # device-inclusive ms attributed to it
                                  # (the wait for the step lock excluded)
    worker: str
    pages: list | None = None


class HandoffChannel:
    """The decode<->prefill seam: a job queue (decode posts, workers take)
    and a done queue (workers deliver, decode drains). Plain
    condition-variable queues; a cross-host deployment would put a
    transport behind this same four-method surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs: deque = deque()
        self._done: deque = deque()
        self._jobs_cv = threading.Condition(self._lock)
        self._done_cv = threading.Condition(self._lock)
        self._workers: list = []
        self.posted = 0
        self.delivered = 0
        self.dropped = 0

    # ---- decode side -------------------------------------------------
    def post(self, job: PrefillJob):
        with self._lock:
            self._jobs.append(job)
            self.posted += 1
            self._jobs_cv.notify()

    def take_done(self, wait_s: float = 0.0) -> list:
        with self._lock:
            if not self._done and wait_s > 0:
                self._done_cv.wait(wait_s)
            out = list(self._done)
            self._done.clear()
            return out

    # ---- worker side -------------------------------------------------
    def take_jobs(self, max_jobs: int, timeout_s: float = 0.02) -> list:
        with self._lock:
            if not self._jobs:
                self._jobs_cv.wait(timeout_s)
            out = []
            while self._jobs and len(out) < max_jobs:
                job = self._jobs.popleft()
                if not job.cancelled:
                    out.append(job)
            return out

    def deliver(self, handoff: KVHandoff):
        if faults.fire_check("serving.handoff.drop"):
            # the handoff vanishes in transit; the decode side must
            # reclaim on timeout, never wedge
            self.dropped += 1
            obs_events.emit("serving", "handoff_drop", severity="warn",
                            rid=int(handoff.rid), worker=handoff.worker)
            return
        with self._lock:
            self._done.append(handoff)
            self.delivered += 1
            self._done_cv.notify()

    # ---- worker registry ---------------------------------------------
    def register_worker(self, worker: "PrefillWorker"):
        with self._lock:
            self._workers.append(worker)

    def workers_alive(self) -> bool:
        return any(w.alive for w in list(self._workers))

    def stats(self) -> dict:
        with self._lock:
            return {"posted": self.posted, "delivered": self.delivered,
                    "dropped": self.dropped, "queued": len(self._jobs),
                    "workers": len(self._workers),
                    "workers_alive": sum(w.alive for w in self._workers)}


_worker_seq = itertools.count()


class PrefillWorker:
    """One prefill worker thread draining a `HandoffChannel` into an
    engine's packed prefill. ``mode="alias"`` writes straight into the
    decode engine's pools under its step lock; ``mode="copy"`` prefills a
    private side pool and ships each page's bytes as host tensors."""

    def __init__(self, engine, channel: HandoffChannel, *,
                 mode: str = "alias", max_jobs: int = 0, name: str = ""):
        if mode not in ("alias", "copy"):
            raise ValueError(f"handoff mode must be alias/copy, "
                             f"got {mode!r}")
        self.engine = engine
        self.channel = channel
        self.mode = mode
        self.max_jobs = int(max_jobs or engine.decode_batch)
        self.name = name or f"w{next(_worker_seq)}"
        self.alive = True
        self.dead_cause: str | None = None
        self._stop = False
        self._current: list = []
        if mode == "copy":
            # a side pool just big enough for one taken batch of packed
            # frames (+ the reserved null page): the worker's private
            # staging memory, freed job by job after extraction
            ps = engine.page_size
            side_pages = 1 + self.max_jobs * -(-engine.pack_frame // ps)
            self._alloc = PageAllocator(side_pages, ps)
            self._cache = {
                name: torch.zeros(a.shape[:2] + (side_pages,) + a.shape[3:],
                                  dtype=a.dtype, device=a.device)
                for name, a in engine._cache.items()}
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"paddle_tpu_torch.serving.prefill.{self.name}")
        channel.register_worker(self)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop:
                jobs = self.channel.take_jobs(self.max_jobs, timeout_s=0.02)
                if jobs:
                    self._process(jobs)
        except BaseException as e:  # noqa: BLE001 — the worker's corpse
            # must be observable: failed jobs reclaim, probes see a dead
            # worker, the channel stops being post-worthy
            self.dead_cause = f"{type(e).__name__}: {e}"
            for job in self._current:
                job.failed = True
            obs_events.emit("serving", "prefill_worker_died",
                            severity="error", worker=self.name,
                            cause=self.dead_cause,
                            jobs_failed=len(self._current))
        finally:
            self.alive = False

    def _process(self, jobs: list):
        # _current stays set across an exception so the death handler in
        # _run marks exactly these jobs failed (the reclaim trigger)
        self._current = jobs
        if self.mode == "alias":
            ms = self.engine.prefill_jobs(jobs)
            # mid-handoff: the device writes are done, the handoffs are
            # not delivered — the exactly-once window
            faults.point("serving.prefill.kill")
            per = ms / max(len(jobs), 1)
            ps = self.engine.page_size
            for job in jobs:
                self.channel.deliver(KVHandoff(
                    rid=job.rid, n_pages=-(-int(job.tokens.size) // ps),
                    ms=per, worker=self.name))
        else:
            payloads, ms = self._prefill_copy(jobs)
            faults.point("serving.prefill.kill")
            for job, pages in zip(jobs, payloads):
                self.channel.deliver(KVHandoff(
                    rid=job.rid, n_pages=len(pages), ms=ms,
                    worker=self.name, pages=pages))
        self._current = []

    def _prefill_copy(self, jobs: list):
        """Copy mode: prefill the jobs' prompts into the side pool (the
        same packed frames), then copy each page's bytes to the host. The
        engine's step lock serializes the device work against the decode
        loop; the ms (the wait for the lock excluded) are device-inclusive,
        as the copies to the host block."""
        eng = self.engine
        ps = eng.page_size
        with eng._step_lock:
            t0 = time.perf_counter()
            keys = []
            for job in jobs:
                key = ("prefill_worker", self.name, job.rid)
                if not self._alloc.ensure(key, int(job.tokens.size)):
                    raise RuntimeError(
                        f"prefill worker side pool too small for "
                        f"{int(job.tokens.size)}-token job")
                keys.append(key)
            items = [(job.tokens,
                      self._alloc.page_table_row(key, eng.pages_per_seq))
                     for job, key in zip(jobs, keys)]
            for frame in eng._plan_frames(items, lambda it: it[0].size):
                self._cache = eng.packed_prefill_cache(self._cache, frame)
            payloads = []
            for job, key in zip(jobs, keys):
                chain = self._alloc.chain(key)
                chain = chain[:-(-int(job.tokens.size) // ps)]
                payloads.append([eng._extract_page(self._cache, page)
                                 for page in chain])
                self._alloc.free_request(key)
            ms = (time.perf_counter() - t0) * 1e3 / max(len(jobs), 1)
        return payloads, ms

    def close(self):
        self._stop = True
        self._thread.join(timeout=5.0)
        self.alive = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def build_disagg(engine, n_workers: int = 1, *, mode: str = "alias",
                 timeout_s: float | None = None):
    """Attach a fresh `HandoffChannel` to `engine` (which becomes the
    decode side whatever its configured role) and start `n_workers`
    prefill workers on it. Returns ``(channel, [workers])``; the caller
    closes the workers."""
    channel = HandoffChannel()
    engine.attach_prefill(channel, timeout_s=timeout_s)
    workers = [PrefillWorker(engine, channel, mode=mode)
               for _ in range(n_workers)]
    return channel, workers
