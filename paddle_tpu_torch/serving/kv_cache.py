"""Block-granular KV-cache page allocator, host side, with refcounted
copy-on-write prefix sharing and a host cold tier
(``paddle_tpu.serving.kv_cache`` counterpart: the same operations give the
same page numbers, tier copies and counters).

The device pools are ``[layers, kv_heads, num_pages, page_size, head_dim]``
tensors owned by the serving engine; this module owns the index space: a
free list of fixed-size pages and per-request page chains (a request's
context occupies its chain's pages in order). Page 0 is the reserved NULL
page: never allocated, it backs the dead slots of every page-table row.

Prefix sharing: a page holding a committed FULL page of tokens can be
registered in a prefix index keyed by the exact token bytes of the prefix
it completes (one probe per page_size stride is a radix walk; equal bytes
are the match, so two prefixes never alias), within a namespace: pages
written under a LoRA adapter hold K/V that depend on it, so they are keyed
by (namespace, bytes) and match only lookups of the same namespace (the
JAX index keys tokens alone and lets a base request adopt an adapter's
pages). Demoted entries keep their key, namespace included. Admission
adopts the longest indexed prefix of a new context (refcounted shared
pages) and prefill runs only the unmatched tail. A write into a shared page copies on write
(`make_writable` hands the engine (src, dst) pairs to copy on the device).
Eviction is copy-free: freeing a chain decrefs its pages.

Host cold tier (``host_pages > 0``): an indexed page whose last holder frees
it goes COLD (it keeps its index entry and its device bytes). Under
allocation pressure the oldest cold page is reclaimed: its entry demotes to
a host slot (the engine drains the device-to-host copy via `take_tier_ops`
before any device write can touch the page) or is dropped when the host
pool is full. A prefix match on a host-resident entry PROMOTES it into a
fresh device page (host-to-device copy queued). The
``serving.kv.promote_fail`` fault point makes a promotion lose its host
entry instead: the match stops there and the request re-prefills the tail.
"""
from __future__ import annotations

from collections import OrderedDict, deque

import numpy as np

from paddle_tpu_torch.distributed.resilience import faults

__all__ = ["PageAllocator", "kv_page_bytes", "pages_for_budget", "NULL_PAGE"]

NULL_PAGE = 0


faults.register(
    "serving.kv.promote_fail",
    "a host->HBM KV page promotion fails: the demoted prefix entry is "
    "lost, the radix match stops at that depth and the request "
    "degrades to re-prefilling the unmatched tail — never wedges")


def kv_page_bytes(num_layers: int, num_kv_heads: int, page_size: int,
                  head_dim: int, dtype_bytes=2) -> int:
    """K+V bytes ONE page costs across the whole layer stack (the unit of
    the serving memory budget). `dtype_bytes` is the pool's itemsize, or
    any numpy dtype spec: an int8 pool under a bf16 model halves page
    bytes, doubling the pages a budget buys. Quantized pools carry their
    per-slot-per-head fp32 scales separately (4/head_dim of the pool bytes,
    reported by the engine as `kv_scale_bytes`)."""
    if not isinstance(dtype_bytes, int):
        dtype_bytes = int(np.dtype(dtype_bytes).itemsize)
    if min(num_layers, num_kv_heads, page_size, head_dim,
           dtype_bytes) <= 0:
        raise ValueError(
            f"kv_page_bytes needs positive dimensions, got layers="
            f"{num_layers} kv_heads={num_kv_heads} page_size={page_size} "
            f"head_dim={head_dim} dtype_bytes={dtype_bytes}")
    return 2 * num_layers * num_kv_heads * page_size * head_dim * dtype_bytes


def pages_for_budget(budget_bytes: int, page_bytes: int) -> int:
    """Pool size (incl. the null page) fitting `budget_bytes`. Raises on
    budgets that cannot back a working pool — a zero/negative budget, or a
    budget smaller than TWO pages (null + one usable) — instead of handing
    the engine a pool it will die on later with an opaque allocator error.
    """
    if page_bytes <= 0:
        raise ValueError(f"page_bytes must be positive, got {page_bytes}")
    if budget_bytes <= 0:
        raise ValueError(
            f"KV budget must be positive, got {budget_bytes} bytes "
            f"(check serving_hbm_budget_mb)")
    pages = budget_bytes // page_bytes
    if pages < 2:
        raise ValueError(
            f"KV budget of {budget_bytes} bytes buys {pages} page(s) of "
            f"{page_bytes} bytes — the pool needs >= 2 (the reserved null "
            f"page plus one usable); raise serving_hbm_budget_mb or lower "
            f"serving_page_size/model KV width")
    return pages


def _prefix_key(tokens: np.ndarray, depth: int, page_size: int,
                namespace=None):
    """Index key of the prefix that ends with full page `depth`: the exact
    token bytes (not a digest — equality IS the match, collisions are
    structurally impossible). Under a `namespace` (an adapter's pages) the
    key is the pair (namespace, bytes), which never equals a base key nor
    one of another namespace."""
    key = np.ascontiguousarray(
        tokens[:(depth + 1) * page_size], np.int32).tobytes()
    return key if namespace is None else (namespace, key)


class PageAllocator:
    """Refcounted free-list page allocator with per-request chains and a
    shared-prefix index.

    Invariants (asserted by `check_consistency`): a page's refcount equals
    the number of chains holding it; the free list and the refcounted pages
    partition the non-null pool; the null page belongs to no chain; every
    indexed prefix page is allocated; chain growth and prefix adoption are
    all-or-nothing (a request either gets every page its context needs or
    the allocator reports exhaustion and the scheduler evicts/queues).
    """

    def __init__(self, num_pages: int, page_size: int, host_pages: int = 0):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is the reserved null "
                             f"page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got {host_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.host_pages = int(host_pages)
        self._free = deque(range(1, num_pages))
        self._chains: dict[object, list[int]] = {}
        self._holders: dict[int, set] = {}      # page -> rids (refcount)
        self._prefix_index: dict[bytes, int] = {}   # token prefix -> page
        self._page_prefix: dict[int, bytes] = {}    # page -> its index key
        # host cold tier (active iff host_pages > 0): COLD pages are
        # HBM-resident, indexed, refcount-0 pages retained past their last
        # holder (insertion order == demotion order under pressure); host
        # slots hold demoted pages' bytes, owned by the engine's pinned
        # host store — this map is pure index bookkeeping
        self._cold: "OrderedDict[int, bytes]" = OrderedDict()
        self._host_index: dict[bytes, int] = {}     # token prefix -> slot
        self._host_prefix: dict[int, bytes] = {}    # slot -> its index key
        self._host_free = deque(range(self.host_pages))
        # cross-tier page copies the ENGINE must apply: demotions (hbm
        # page -> host slot, D2H) queued by reclaim, promotions (host slot
        # -> hbm page, H2D) queued by match; drained via take_tier_ops()
        # BEFORE any device write can touch the pages involved
        self._pending_demote: list[tuple[int, int]] = []
        self._pending_promote: list[tuple[int, int]] = []
        # host slots read by a pending promotion stay reserved until the
        # engine drains the copy (a demotion reusing the slot first would
        # overwrite the bytes the promotion is about to read)
        self._promote_slots_pending: list[int] = []
        self.prefix_matches = 0                 # admissions that hit
        self.prefix_tokens_matched = 0          # tokens skipped via the index
        self.cow_copies = 0                     # copy-on-write page copies
        self.demotions = 0                      # cold pages moved to host
        self.promotions = 0                     # host pages restored to HBM
        self.cold_hits = 0                      # matches on cold HBM pages
        self.dropped_cold = 0                   # cold pages lost (host full)
        self.promote_failures = 0               # chaos: promote_fail fires

    # ---- capacity ---------------------------------------------------------
    @property
    def tier_enabled(self) -> bool:
        return self.host_pages > 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cold_pages(self) -> int:
        return len(self._cold)

    def _promote_locked(self) -> set:
        """Cold pages whose H2D restore is still QUEUED: their HBM bytes
        are stale until the engine drains take_tier_ops, so reclaiming
        (and demoting!) one would ship garbage to the host tier."""
        return {p for _, p in self._pending_promote if p in self._cold}

    @property
    def reclaimable_pages(self) -> int:
        """Pages an allocation can draw on: truly free + cold (reclaiming a
        cold page demotes or drops its index entry, never blocks), minus
        cold pages locked by a pending promotion."""
        return (len(self._free) + len(self._cold)
                - len(self._promote_locked()))

    @property
    def host_used(self) -> int:
        return (self.host_pages - len(self._host_free)
                - len(self._promote_slots_pending))

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / max(self.num_pages - 1, 1)

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size) if tokens > 0 else 0

    # ---- chains -----------------------------------------------------------
    def chain(self, rid) -> list[int]:
        return list(self._chains.get(rid, ()))

    def is_shared(self, page: int) -> bool:
        return len(self._holders.get(page, ())) > 1

    def _alloc_one(self, rid, protect=()) -> int:
        if not self._free:
            self._reclaim_cold(protect)
        page = self._free.popleft()
        assert page not in self._holders and page != NULL_PAGE, \
            f"page {page} double-allocated"
        self._holders[page] = {rid}
        return page

    def _reclaim_cold(self, protect=()):
        """Turn the oldest unprotected COLD page back into a free page:
        its index entry demotes to a host slot (D2H copy queued for the
        engine) or is dropped when the host pool is full. `protect` guards
        pages a caller already matched/adopted in the same operation;
        promote-locked pages (restore still queued) are never victims."""
        locked = {p for _, p in self._pending_promote}
        for page in self._cold:
            if page not in protect and page not in locked:
                break
        else:
            raise IndexError("no reclaimable cold page")
        key = self._cold.pop(page)
        assert self._page_prefix.pop(page, None) == key \
            and self._prefix_index.pop(key, None) == page, \
            f"cold page {page} out of sync with the prefix index"
        if not self._host_free and self._host_index:
            # host pool full: evict the OLDEST demoted entry to make room
            # (the incoming page went cold more recently); a stale pending
            # demote into the recycled slot is applied in queue order, so
            # the new occupant's bytes land last
            k0, s0 = next(iter(self._host_index.items()))
            del self._host_index[k0]
            del self._host_prefix[s0]
            self._host_free.append(s0)
            self.dropped_cold += 1
        if self._host_free:
            slot = self._host_free.popleft()
            self._host_index[key] = slot
            self._host_prefix[slot] = key
            self._pending_demote.append((page, slot))
            self.demotions += 1
        else:
            self.dropped_cold += 1
        self._free.append(page)

    def _release_one(self, page: int, rid):
        holders = self._holders.get(page)
        assert holders is not None and rid in holders, \
            f"page {page} released by {rid!r} but held by " \
            f"{sorted(map(repr, holders or ()))}"
        holders.discard(rid)
        if not holders:
            del self._holders[page]
            key = self._page_prefix.get(page)
            if (key is not None and self.tier_enabled
                    and self._prefix_index.get(key) == page):
                # cold retention: the indexed full page outlives its last
                # holder — reclaimed lazily (demote-to-host) under pressure
                self._cold[page] = key
                return
            self._page_prefix.pop(page, None)
            if key is not None and self._prefix_index.get(key) == page:
                del self._prefix_index[key]
            self._free.append(page)

    def ensure(self, rid, total_tokens: int, adopt: list[int] | None = None) \
            -> bool:
        """Grow request `rid`'s chain until it covers `total_tokens` tokens.
        `adopt` (admission only — the chain must be empty) links the given
        already-allocated SHARED prefix pages in front before topping up
        with fresh pages. All-or-nothing: on exhaustion nothing is
        allocated or adopted and False is returned (the scheduler then
        evicts or queues)."""
        chain = self._chains.setdefault(rid, [])
        if adopt:
            assert not chain, \
                f"prefix adoption into a non-empty chain of {rid!r}"
            for page in adopt:
                assert (page in self._holders or page in self._cold) \
                    and page != NULL_PAGE, \
                    f"adopting unallocated page {page}"
        # ONE exhaustion check before ANY mutation (adoption consumes no
        # free pages, so the fresh-page shortfall is known up front):
        # all-or-nothing needs no rollback path. Cold pages count as
        # available (reclaiming one demotes/drops its index entry) EXCEPT
        # the ones this very call adopts and the promote-locked ones
        # (pending H2D restore — not reclaimable until the drain).
        need = (self.pages_for(total_tokens) - len(chain)
                - (len(adopt) if adopt else 0))
        adopt_set = set(adopt) if adopt else set()
        locked = self._promote_locked()
        avail = len(self._free) + len(self._cold) \
            - sum(1 for p in self._cold
                  if p in adopt_set or p in locked)
        if need > avail:
            if not chain:
                del self._chains[rid]
            return False
        if adopt:
            for page in adopt:
                if page in self._cold:
                    # adopting a COLD page revives it copy-free: it leaves
                    # the cold set and is refcounted like any shared page
                    # (its index entry survives untouched)
                    del self._cold[page]
                    self._holders[page] = {rid}
                    self.cold_hits += 1
                else:
                    self._holders[page].add(rid)
                chain.append(page)
            self.prefix_matches += 1
            self.prefix_tokens_matched += len(adopt) * self.page_size
        for _ in range(max(need, 0)):
            chain.append(self._alloc_one(rid))
        return True

    def free_request(self, rid) -> int:
        """Decref `rid`'s whole chain (request completion, cancellation, or
        copy-free eviction); pages still held by prefix sharers survive,
        the rest return to the free list. Returns the chain length."""
        chain = self._chains.pop(rid, [])
        for page in chain:
            self._release_one(page, rid)
        return len(chain)

    def page_table_row(self, rid, pages_per_seq: int) -> np.ndarray:
        """The request's kernel-facing page-table row: its chain, padded
        with the null page."""
        chain = self._chains.get(rid, ())
        if len(chain) > pages_per_seq:
            raise ValueError(f"request {rid!r} chain ({len(chain)} pages) "
                             f"exceeds pages_per_seq={pages_per_seq}")
        row = np.full(pages_per_seq, NULL_PAGE, np.int32)
        row[:len(chain)] = chain
        return row

    # ---- prefix sharing ---------------------------------------------------
    def match_prefix(self, tokens, namespace=None) -> tuple[list[int], int]:
        """Longest indexed prefix of `tokens`, in whole committed pages:
        returns (pages, matched_token_count). The radix walk is one index
        probe per page_size stride, keyed by the exact token bytes. A depth
        resident only in the HOST tier is PROMOTED mid-walk (fresh HBM page
        + pending H2D restore; the matcher then adopts it like any cold
        page), so the caller never sees tiers — unless the
        serving.kv.promote_fail chaos point fires, which loses the host
        entry and stops the walk (the request re-prefills the tail). Only
        pages registered under the same `namespace` match."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        pages: list[int] = []
        ps = self.page_size
        depth = 0
        while (depth + 1) * ps <= tokens.size:
            key = _prefix_key(tokens, depth, ps, namespace)
            page = self._prefix_index.get(key)
            if page is None and key in self._host_index:
                page = self._promote(key, protect=frozenset(pages))
            if page is None:
                break
            pages.append(page)
            depth += 1
        return pages, depth * ps

    def _promote(self, key: bytes, protect=frozenset()) -> int | None:
        """Restore a host-resident prefix entry into a fresh HBM page: the
        H2D copy is queued for the engine and the entry re-enters the index
        as a COLD page (refcount 0) — adoption then refcounts it exactly
        like a resident radix hit, and a failed admission leaves a
        consistent cold page rather than a leak. Returns None when no HBM
        page can be reclaimed (or the chaos point eats the host entry)."""
        slot = self._host_index[key]
        if faults.fire_check("serving.kv.promote_fail"):
            # chaos: the restore path failed — the host entry is LOST (its
            # bytes are unreachable) and the caller's walk stops here; the
            # admission degrades to re-prefilling the unmatched tail
            del self._host_index[key]
            del self._host_prefix[slot]
            self._host_free.append(slot)
            self.promote_failures += 1
            return None
        locked = {p for _, p in self._pending_promote}
        if not self._free and not any(p not in protect and p not in locked
                                      for p in self._cold):
            return None
        page = self._free.popleft() if self._free else None
        if page is None:
            self._reclaim_cold(protect)
            page = self._free.popleft()
            if key not in self._host_index:
                # reclaiming demoted INTO a full host pool and the FIFO
                # drop evicted this very entry — the bytes are gone, so
                # hand the page back and degrade to a miss
                self._free.appendleft(page)
                return None
        del self._host_index[key]
        del self._host_prefix[slot]
        # the slot stays reserved (not free) until take_tier_ops drains
        # the restore copy — see _promote_slots_pending
        self._promote_slots_pending.append(slot)
        self._pending_promote.append((slot, page))
        self._prefix_index[key] = page
        self._page_prefix[page] = key
        self._cold[page] = key
        self.promotions += 1
        return page

    def take_tier_ops(self) -> tuple[list[tuple[int, int]],
                                     list[tuple[int, int]]]:
        """Drain the pending cross-tier copies: (demotions [(hbm_page,
        host_slot)...], promotions [(host_slot, hbm_page)...]). The engine
        must apply them in THAT order — demotions first (their source pages
        were handed back to the free list and will be rewritten), then
        promotions (whose source slots a same-batch demotion can never
        alias: slots read by promotions are only returned to the host free
        list here, after the demotion list was fixed) — and must drain
        BEFORE dispatching any program that writes the pages involved."""
        demote, promote = self._pending_demote, self._pending_promote
        self._pending_demote, self._pending_promote = [], []
        self._host_free.extend(self._promote_slots_pending)
        self._promote_slots_pending = []
        return demote, promote

    def register_prefix(self, rid, tokens, namespace=None) -> int:
        """Index `rid`'s chain pages that hold FULL pages of the committed
        `tokens` (the request's context at registration) under
        `namespace`. Depths already indexed keep their first registrant
        (the matcher adopted those very pages, so re-registering is a
        no-op). Returns newly indexed pages.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        chain = self._chains.get(rid, ())
        ps = self.page_size
        new = 0
        for depth in range(min(tokens.size // ps, len(chain))):
            key = _prefix_key(tokens, depth, ps, namespace)
            if key in self._prefix_index:
                continue
            page = chain[depth]
            if page in self._page_prefix:       # already indexed under
                continue                        # another (stale) prefix
            slot = self._host_index.pop(key, None)
            if slot is not None:
                # a freshly committed HBM copy supersedes the demoted one:
                # drop the host entry (its slot may be reused immediately —
                # any stale pending demote into it is applied in queue
                # order, so the new occupant's bytes land last)
                del self._host_prefix[slot]
                self._host_free.append(slot)
            self._prefix_index[key] = page
            self._page_prefix[page] = key
            new += 1
        return new

    def make_writable(self, rid, first_token: int, last_token: int) \
            -> list[tuple[int, int]] | None:
        """Copy-on-write: every chain page of `rid` covering token positions
        [first_token, last_token] that is SHARED gets replaced by a fresh
        page; returns the (src, dst) pairs the engine must copy device-side
        (src keeps the sharers and its index entry; dst is private to
        `rid`). Returns None on pool exhaustion with NOTHING changed (the
        scheduler then evicts and retries) — all-or-nothing like `ensure`.
        """
        chain = self._chains.get(rid)
        if not chain or last_token < first_token:
            return []
        ps = self.page_size
        lo = max(first_token // ps, 0)
        hi = min(last_token // ps, len(chain) - 1)
        shared_idx = [i for i in range(lo, hi + 1)
                      if self.is_shared(chain[i])]
        if len(shared_idx) > self.reclaimable_pages:
            return None
        copies = []
        for i in shared_idx:
            src = chain[i]
            dst = self._alloc_one(rid)
            self._release_one(src, rid)
            chain[i] = dst
            copies.append((src, dst))
        self.cow_copies += len(copies)
        return copies

    # ---- invariants -------------------------------------------------------
    def check_consistency(self):
        """Test hook: every allocated page refcounted by exactly the chains
        that contain it; free list, refcounted pages and COLD pages
        partition the non-null pool; the prefix index points only at
        allocated-or-cold pages; the host tier's slot bookkeeping (index,
        backrefs, free list, promote-reserved slots) partitions the host
        pool with keys disjoint from the HBM index."""
        seen: dict[int, set] = {}
        for rid, chain in self._chains.items():
            for page in chain:
                assert page != NULL_PAGE, f"null page in chain of {rid!r}"
                assert page not in seen or rid not in seen[page], \
                    f"page {page} appears twice in chain of {rid!r}"
                seen.setdefault(page, set()).add(rid)
        assert seen.keys() == self._holders.keys(), \
            "holder map out of sync with chains"
        for page, rids in seen.items():
            assert rids == self._holders[page], \
                f"page {page} refcount {sorted(map(repr, self._holders[page]))} " \
                f"!= chains holding it {sorted(map(repr, rids))}"
        free = set(self._free)
        cold = set(self._cold)
        assert len(free) == len(self._free), "free list duplicates"
        assert not (free & set(seen)), "free list overlaps a live chain"
        assert not (cold & free) and not (cold & set(seen)), \
            "cold pages overlap the free list or a live chain"
        assert len(free) + len(seen) + len(cold) == self.num_pages - 1, \
            "pages leaked or duplicated"
        for page, key in self._cold.items():
            assert self._page_prefix.get(page) == key \
                and self._prefix_index.get(key) == page, \
                f"cold page {page} out of sync with the prefix index"
        for key, page in self._prefix_index.items():
            assert page in self._holders or page in self._cold, \
                f"prefix index points at freed page {page}"
            assert self._page_prefix.get(page) == key, \
                f"prefix backref out of sync for page {page}"
        for page in self._page_prefix:
            assert page in self._holders or page in self._cold, \
                f"prefix backref holds freed page {page}"
        # ---- host tier ----
        host_free = set(self._host_free)
        pending = set(self._promote_slots_pending)
        assert len(host_free) == len(self._host_free), \
            "host free list duplicates"
        assert len(pending) == len(self._promote_slots_pending), \
            "promote-reserved slot duplicates"
        held = set(self._host_prefix)
        assert not (host_free & held) and not (pending & held) \
            and not (host_free & pending), "host slot in two states"
        assert len(host_free) + len(held) + len(pending) == self.host_pages, \
            "host slots leaked or duplicated"
        assert {k: s for s, k in self._host_prefix.items()} \
            == self._host_index, "host index/backref out of sync"
        assert not (set(self._host_index) & set(self._prefix_index)), \
            "prefix resident in BOTH tiers"
        for page, slot in self._pending_demote:
            # a pending demote may be STALE (register_prefix of a fresher
            # HBM copy freed its slot; a later demote may re-take it and a
            # match may even promote-reserve it before one drain — queue
            # order at the drain keeps the bytes right: demote writes land
            # before promote reads), so the only hard invariant is that
            # the slot is accounted for in the partition above
            assert slot in host_free or slot in held or slot in pending, \
                f"pending demotion into untracked host slot {slot}"
        for slot, page in self._pending_promote:
            assert slot in pending, \
                f"pending promotion from unreserved host slot {slot}"
            assert page in self._cold or page in self._holders, \
                f"pending promotion into unallocated page {page}"
