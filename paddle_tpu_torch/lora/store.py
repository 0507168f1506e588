"""Serving-side adapter pool: host registry + device slots, LRU + refcounts
(``paddle_tpu.lora.store`` counterpart).

Registered adapters live on the host (the cold tier, kept while
registered); a fixed pool of ``G`` device slots per target projection
(``a [G, d_in, r]`` / ``b [G, r, d_out]`` tensors on the model's device,
the ``alpha/r`` scale baked into B) backs every serving dispatch.
`acquire()` pins an adapter into a slot (host-to-device swap-in on a miss,
timed and journaled), `release()` unpins it, and a full pool evicts the
least-recently-used slot that no request pins.

Two differences from the JAX store, both forced by PyTorch's in-place
tensors:

* **No torn views.** The JAX pools are immutable arrays a dispatch
  snapshots. Here the pool tensors are written in place, so a hot swap of
  a resident adapter only stages its new factors: the serving engine
  writes them (`apply_swaps`) at the start of its next step, on its own
  thread, before any dispatch. A swap from another thread therefore never
  waits for a step and lands between two steps, never between two layers
  of one. A load into a free or evicted slot is written at once: no
  in-flight row reads an unpinned slot.
* **Rank padding.** The grouped-matmul kernel takes bf16 operands whose
  widths are multiples of 8, so the pools' rank is ``rank`` rounded up to
  a multiple of 8 (``pool_rank``) on every device; the extra columns of A
  and rows of B stay zero and add exact zeros to the delta.

`AdapterLoadError` is a typed PER-REQUEST error (unknown id, a pool pinned
full, or the ``serving.lora.swap_fail`` chaos point): the engine raises it
at submit, the replica passes it on, and the router turns it into one
terminal ``adapter_load_failed`` stream event.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref

import torch

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.lora import seam
from paddle_tpu_torch.lora.adapter import (DEFAULT_TARGETS, as_tensor,
                                           find_targets, target_dims)
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability import metrics as obs_metrics

__all__ = ["AdapterStore", "AdapterLoadError"]

faults.register(
    "serving.lora.swap_fail",
    "fail one adapter host->device swap-in at the AdapterStore: the "
    "request that needed it gets a typed AdapterLoadError (the router "
    "surfaces ONE terminal adapter_load_failed event, no breaker strike, "
    "no failover); other tenants' streams and the decode loop never "
    "notice")


class AdapterLoadError(RuntimeError):
    """Typed per-request adapter failure (unknown id / pool pinned full /
    swap-in failed): degrades the ONE request that asked, never the
    engine, the batch, or the stream transport."""

    def __init__(self, adapter_id: str, reason: str):
        super().__init__(f"adapter {adapter_id!r} failed to load: {reason}")
        self.adapter_id = str(adapter_id)
        self.reason = reason


_store_seq = itertools.count()


def _register_store_metrics(store: "AdapterStore"):
    """Scrape-time collector: residency, swap totals and latency mirror
    into the registry; the weakref owner unhooks a collected store."""
    ref = weakref.ref(store)

    def collect(reg):
        s = ref()
        if s is None:
            return
        snap = s.residency()
        reg.gauge("lora_active_adapters",
                  "adapters resident in the device slot pool",
                  labels=("store",)).labels(store=s._metrics_id).set(
            float(len(snap["resident"])))
        reg.gauge("lora_registered_adapters",
                  "adapters registered in the host (cold) registry",
                  labels=("store",)).labels(store=s._metrics_id).set(
            float(snap["registered"]))
        reg.counter("lora_swap_total",
                    "adapter host->device swap-ins (pool loads + hot swaps)",
                    labels=("store",)).labels(
            store=s._metrics_id)._set_total(float(snap["swaps"]))
        reg.counter("lora_evictions_total",
                    "adapter slots evicted (LRU, refcount 0 only)",
                    labels=("store",)).labels(
            store=s._metrics_id)._set_total(float(snap["evictions"]))
        reg.gauge("lora_swap_ms",
                  "mean adapter swap-in latency (ms)",
                  labels=("store",)).labels(store=s._metrics_id).set(
            float(snap["swap_ms_mean"]))

    obs_metrics.registry().add_collector(collect, owner=store)


class AdapterStore:
    """Fixed-slot device adapter pool over a host registry for ONE base
    model's target projections (shapes discovered from the model — the
    traversal `lora.attach` runs, so exported artifacts line up by
    construction). ``dtype`` defaults to the first target weight's."""

    def __init__(self, model, *, rank: int, targets=DEFAULT_TARGETS,
                 slots: int = 0, dtype=None):
        from paddle_tpu_torch.core.flags import flag

        self.rank = int(rank)
        if self.rank <= 0:
            raise ValueError(f"adapter rank must be positive, got {rank}")
        self.num_slots = int(slots or flag("serving_adapter_slots"))
        if self.num_slots <= 0:
            raise ValueError(f"adapter pool needs >= 1 slot, got "
                             f"{self.num_slots}")
        self.targets = tuple(targets)
        found = find_targets(model, self.targets)
        self._names = [n for n, _ in found]
        self._wids = [id(w) for _, w in found]
        self._dims = [target_dims(w) for _, w in found]
        w0 = found[0][1]
        self.device = w0.device
        self.dtype = (w0.dtype if dtype is None else dtype
                      if isinstance(dtype, torch.dtype)
                      else getattr(torch, str(dtype)))
        # the pools' rank: a multiple of 8, the kernel's bf16 granularity
        self.pool_rank = -(-self.rank // 8) * 8
        g, rp = self.num_slots, self.pool_rank
        self._a = [torch.zeros((g, di, rp), dtype=self.dtype,
                               device=self.device) for di, _ in self._dims]
        self._b = [torch.zeros((g, rp, do), dtype=self.dtype,
                               device=self.device) for _, do in self._dims]
        # the serving binding's pool map: the tensors are written in place,
        # so the map is built once
        self._pool_map = {wid: (a, b)
                          for wid, a, b in zip(self._wids, self._a, self._b)}
        # host registry (cold tier): adapter id -> per-target (A, B*scale)
        self._host: dict[str, list] = {}
        # adapter id -> versions of its weights so far (bumped when a new
        # version reaches the pools): a request's prefix-index namespace,
        # so pages written under replaced weights never match
        self._generation: dict[str, int] = {}
        # resident slots whose adapter was re-registered: rewritten by the
        # engine's next `apply_swaps`
        self._staged: set[int] = set()
        self._slot_adapter: list[str | None] = [None] * g
        self._slot_by_id: dict[str, int] = {}
        self._refs = [0] * g
        self._tick = 0
        self._last_used = [0] * g
        self.swaps = 0
        self.swap_ms_total = 0.0
        self.evictions = 0
        self.load_failures = 0
        self._lock = threading.Lock()
        self._metrics_id = str(next(_store_seq))
        _register_store_metrics(self)

    # ---- registry (the cold tier) -----------------------------------------
    def register(self, adapter_id: str, source):
        """Register (or HOT-SWAP) an adapter: `source` is an artifact path
        or a `load_adapter()` blob. Validates rank, target coverage and
        factor shapes against the model-derived pool layout. If the id is
        RESIDENT, the new factors are staged and the engine writes them at
        the start of its next step: live requests decode through the new
        weights from that step on. Never waits for a running step."""
        if isinstance(source, str):
            from paddle_tpu_torch.lora.adapter import load_adapter
            source = load_adapter(source)
        meta, weights = source["adapter"], source["weights"]
        if int(meta["rank"]) != self.rank:
            raise ValueError(f"adapter {adapter_id!r}: rank {meta['rank']} "
                             f"!= store rank {self.rank}")
        missing = [n for n in self._names if n not in weights]
        if missing:
            raise ValueError(f"adapter {adapter_id!r} is missing factors "
                             f"for targets {missing}")
        scale = float(meta.get("alpha", self.rank)) / float(self.rank)
        rows = []
        pin = self.device.type == "cuda"
        for n, (di, do) in zip(self._names, self._dims):
            a, b = (as_tensor(t) for t in weights[n])
            if tuple(a.shape) != (di, self.rank) \
                    or tuple(b.shape) != (self.rank, do):
                raise ValueError(
                    f"adapter {adapter_id!r} target {n!r}: factor shapes "
                    f"{tuple(a.shape)}/{tuple(b.shape)} do not match the "
                    f"pool layout ({(di, self.rank)}/{(self.rank, do)})")
            a = a.to(self.dtype)
            b = (b.float() * scale).to(self.dtype)
            rows.append((a.pin_memory() if pin else a,
                         b.pin_memory() if pin else b))
        aid = str(adapter_id)
        with self._lock:
            self._host[aid] = rows
            slot = self._slot_by_id.get(aid)
            if slot is not None:          # hot swap under live traffic
                self._staged.add(slot)
            else:
                self._bump(aid)

    def apply_swaps(self):
        """Write the staged hot swaps into their slots. The serving engine
        calls this on its own thread at the start of each step, before any
        dispatch, so every layer of a step reads one version."""
        if not self._staged:
            return
        with self._lock:
            for slot in sorted(self._staged):
                aid = self._slot_adapter[slot]
                self._write_slot(slot, aid, reason="hot_swap")
                self._bump(aid)
            self._staged.clear()

    def _bump(self, aid: str):
        self._generation[aid] = self._generation.get(aid, 0) + 1

    def unregister(self, adapter_id: str):
        """Drop an adapter from the registry (and its slot when unpinned);
        a pinned adapter cannot be dropped mid-request."""
        aid = str(adapter_id)
        with self._lock:
            slot = self._slot_by_id.get(aid)
            if slot is not None:
                if self._refs[slot] > 0:
                    raise ValueError(f"adapter {aid!r} is pinned by "
                                     f"{self._refs[slot]} in-flight "
                                     f"request(s)")
                self._free_slot(slot)
            self._host.pop(aid, None)

    def namespace(self, adapter_id: str):
        """The prefix-index namespace of `adapter_id`'s current weights:
        (id, weight generation: bumped when new weights reach the pools)."""
        with self._lock:
            return (str(adapter_id), self._generation.get(str(adapter_id), 0))

    # ---- slot lifecycle (refcounted, LRU) ---------------------------------
    def acquire(self, adapter_id: str) -> int:
        """Pin `adapter_id` into a slot for one request (host-to-device
        swap-in on a miss) and return the slot id, stable until the
        matching `release()`. Raises `AdapterLoadError` on an unknown id, a
        fully pinned pool, or a chaos-failed swap."""
        aid = str(adapter_id)
        with self._lock:
            if aid not in self._host:
                self.load_failures += 1
                raise AdapterLoadError(aid, "not registered with the "
                                            "AdapterStore")
            slot = self._slot_by_id.get(aid)
            if slot is not None:
                self._refs[slot] += 1
                self._tick += 1
                self._last_used[slot] = self._tick
                return slot
            if faults.fire_check("serving.lora.swap_fail"):
                self.load_failures += 1
                raise AdapterLoadError(
                    aid, "host->device swap-in failed "
                         "(serving.lora.swap_fail)")
            slot = self._pick_slot()
            if slot is None:
                self.load_failures += 1
                raise AdapterLoadError(
                    aid, f"adapter pool exhausted: all {self.num_slots} "
                         f"slots pinned by in-flight requests")
            victim = self._slot_adapter[slot]
            if victim is not None:
                self._free_slot(slot)
                self.evictions += 1
                obs_events.emit("serving", "adapter_evict", severity="info",
                                adapter=victim, slot=slot,
                                store=self._metrics_id)
            self._write_slot(slot, aid, reason="load")
            self._refs[slot] = 1
            self._tick += 1
            self._last_used[slot] = self._tick
            return slot

    def release(self, adapter_id: str):
        aid = str(adapter_id)
        with self._lock:
            slot = self._slot_by_id.get(aid)
            if slot is not None and self._refs[slot] > 0:
                self._refs[slot] -= 1
                self._tick += 1
                self._last_used[slot] = self._tick

    def slot_of(self, adapter_id: str) -> int:
        """Resident slot of a PINNED adapter (the engine packs it into the
        per-row slot ids of each dispatch)."""
        with self._lock:
            slot = self._slot_by_id.get(str(adapter_id))
            if slot is None:
                raise KeyError(f"adapter {adapter_id!r} is not resident")
            return slot

    def _pick_slot(self):
        free = [i for i, a in enumerate(self._slot_adapter) if a is None]
        if free:
            return free[0]
        idle = [i for i in range(self.num_slots) if self._refs[i] == 0]
        if not idle:
            return None
        return min(idle, key=lambda i: self._last_used[i])

    def _free_slot(self, slot: int):
        aid = self._slot_adapter[slot]
        if aid is not None:
            self._slot_by_id.pop(aid, None)
            if slot in self._staged:      # its next load is the new version
                self._staged.discard(slot)
                self._bump(aid)
        self._slot_adapter[slot] = None
        self._refs[slot] = 0

    @torch.no_grad()
    def _write_slot(self, slot: int, adapter_id: str, reason: str):
        """The swap-in: copy one adapter's factors into row `slot` of every
        target's pools (the first ``rank`` columns of A and rows of B; the
        padding stays zero). Timed to the copies' completion and
        journaled: the latency a cold tenant pays once."""
        t0 = time.perf_counter()
        r = self.rank
        for i, (a, b) in enumerate(self._host[adapter_id]):
            self._a[i][slot, :, :r].copy_(a, non_blocking=True)
            self._b[i][slot, :r].copy_(b, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._slot_adapter[slot] = adapter_id
        self._slot_by_id[adapter_id] = slot
        ms = (time.perf_counter() - t0) * 1e3
        self.swaps += 1
        self.swap_ms_total += ms
        obs_events.emit("serving", "adapter_swap", severity="info",
                        adapter=adapter_id, slot=slot, reason=reason,
                        ms=round(ms, 3), store=self._metrics_id)

    # ---- what a dispatch consumes ------------------------------------------
    def bind(self, slots):
        """Context manager around one model call: exposes the pools and
        the per-batch-row slot ids (an int32 tensor on the pools' device)
        to the projections through the seam."""
        return seam.serve_bind(seam.ServeBinding(self._pool_map, slots,
                                                 self.num_slots))

    def validate_model(self, model):
        """The engine's construction check: the store must have been built
        against THIS model object (weight identity keys the seam)."""
        ids = {id(p) for p in model.parameters()}
        if not all(w in ids for w in self._wids):
            raise ValueError(
                "AdapterStore was built for a different model instance; "
                "construct it from the model the engine serves")

    # ---- observability -----------------------------------------------------
    @property
    def swap_ms_mean(self) -> float:
        return self.swap_ms_total / self.swaps if self.swaps else 0.0

    def residency(self) -> dict:
        """The /stats adapter snapshot: who is resident where, pinned by
        how many requests, plus swap and eviction totals. Lock-free (GIL-
        atomic copies), so a probe never waits on a swap-in."""
        by_id = dict(self._slot_by_id)
        refs = list(self._refs)
        return {
            "slots": self.num_slots,
            "rank": self.rank,
            "pool_rank": self.pool_rank,
            "registered": len(self._host),
            "resident": [a for a in list(self._slot_adapter)
                         if a is not None],
            "refs": {a: refs[s] for a, s in by_id.items()},
            "swaps": self.swaps,
            "swap_ms_mean": round(self.swap_ms_mean, 3),
            "evictions": self.evictions,
            "load_failures": self.load_failures,
        }
