"""Block-granular KV-cache page allocator, host side
(``paddle_tpu.serving.kv_cache`` counterpart, without prefix sharing,
copy-on-write or the host tier, which later slices port).

The device pools are ``[layers, kv_heads, num_pages, page_size, head_dim]``
tensors owned by the serving engine; this module owns the index space: a
free list of fixed-size pages and per-request page chains (a request's
context occupies its chain's pages in order). Page 0 is the reserved NULL
page: never allocated, it backs the dead slots of every page-table row.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["PageAllocator", "kv_page_bytes", "pages_for_budget", "NULL_PAGE"]

NULL_PAGE = 0


def kv_page_bytes(num_layers: int, num_kv_heads: int, page_size: int,
                  head_dim: int, dtype_bytes=2) -> int:
    """K+V bytes ONE page costs across the whole layer stack (the unit of
    the serving memory budget). `dtype_bytes` is the pool's itemsize, or
    any numpy dtype spec."""
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
    """Pool size (incl. the null page) fitting `budget_bytes`; raises when
    the budget cannot back the null page plus one usable page."""
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


class PageAllocator:
    """Free-list page allocator with per-request chains.

    Invariants (asserted by `check_consistency`): every allocated page
    belongs to exactly one chain; the free list and the chains partition
    the non-null pool; the null page belongs to no chain; chain growth is
    all-or-nothing.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is the reserved null "
                             f"page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = deque(range(1, num_pages))
        self._chains: dict[object, list[int]] = {}
        self._owner: dict[int, object] = {}     # page -> rid

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / max(self.num_pages - 1, 1)

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size) if tokens > 0 else 0

    def chain(self, rid) -> list[int]:
        return list(self._chains.get(rid, ()))

    def ensure(self, rid, total_tokens: int) -> bool:
        """Grow `rid`'s chain until it covers `total_tokens` tokens.
        All-or-nothing: on exhaustion nothing is allocated and False is
        returned (the scheduler then evicts or queues)."""
        chain = self._chains.setdefault(rid, [])
        need = self.pages_for(total_tokens) - len(chain)
        if need > len(self._free):
            if not chain:
                del self._chains[rid]
            return False
        for _ in range(max(need, 0)):
            page = self._free.popleft()
            assert page not in self._owner and page != NULL_PAGE, \
                f"page {page} double-allocated"
            self._owner[page] = rid
            chain.append(page)
        return True

    def free_request(self, rid) -> int:
        """Return `rid`'s whole chain to the free list (completion,
        cancellation or copy-free eviction). Returns the chain length."""
        chain = self._chains.pop(rid, [])
        for page in chain:
            del self._owner[page]
            self._free.append(page)
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

    def check_consistency(self):
        """Test hook: chains and the free list partition the non-null pool
        and the owner map matches the chains."""
        seen: dict[int, object] = {}
        for rid, chain in self._chains.items():
            for page in chain:
                assert page != NULL_PAGE, f"null page in chain of {rid!r}"
                assert page not in seen, \
                    f"page {page} in chains of {seen.get(page)!r} and {rid!r}"
                seen[page] = rid
        assert seen == self._owner, "owner map out of sync with chains"
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicates"
        assert NULL_PAGE not in free, "null page on the free list"
        assert not (free & set(seen)), "free list overlaps a live chain"
        assert len(free) + len(seen) == self.num_pages - 1, \
            "pages leaked or duplicated"
