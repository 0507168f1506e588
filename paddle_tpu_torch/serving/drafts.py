"""Self-drafting n-gram proposer for speculative decoding (host side;
``paddle_tpu.serving.drafts`` counterpart, the port's own copy).

No second model: each request carries a suffix-match table built from its
OWN committed stream (prompt + generated tokens). An order-n entry maps
the last n committed tokens to the token that followed them the last time
that n-gram appeared; proposing K drafts walks the tables greedily,
highest order first, simulating its own extensions so a whole predicted
run (a loop, a copied span, boilerplate) drafts in one step. The verify
pass makes correctness unconditional — a bad draft costs nothing but its
slot in the [batch, K+1] frame — so the proposer optimizes HIT RATE only:
latest occurrence wins (adapts to phase changes), and a miss falls back to
repeating the last token (cheap, and right for degenerate loops).

Cost per committed token is O(max_order) dict updates; per step,
O(K * max_order) lookups — microseconds against a decode dispatch, and
measured anyway (`draft_ms`) so the bench can report draft overhead
honestly.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NGramProposer"]


class NGramProposer:
    """Per-request suffix-match draft tables. `max_order` bounds the n-gram
    length (longest-match-first lookup); `min_order` >= 1."""

    def __init__(self, max_order: int = 3, min_order: int = 1):
        if not 1 <= min_order <= max_order:
            raise ValueError(f"need 1 <= min_order <= max_order, got "
                             f"{min_order}..{max_order}")
        self.max_order = int(max_order)
        self.min_order = int(min_order)
        # rid -> (tables per order, rolling suffix of the committed stream)
        self._state: dict[int, tuple[list[dict], list[int]]] = {}

    # ---- stream maintenance ----------------------------------------------
    def add_request(self, rid: int, tokens) -> None:
        """(Re)seed `rid`'s tables from its committed stream — the prompt
        at submission, or prompt + generated on an eviction re-prefill
        (idempotent: tables are a pure function of the stream)."""
        tables = [dict() for _ in range(self.max_order)]
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        for i in range(1, len(toks)):
            self._observe_into(tables, toks[:i], toks[i])
        self._state[rid] = (tables, toks[-self.max_order:])

    def _observe_into(self, tables, prefix, nxt):
        for order in range(self.min_order, self.max_order + 1):
            if len(prefix) >= order:
                tables[order - 1][tuple(prefix[-order:])] = nxt

    def observe(self, rid: int, token: int) -> None:
        """Fold one committed token into `rid`'s tables."""
        state = self._state.get(rid)
        if state is None:
            return
        tables, suffix = state
        self._observe_into(tables, suffix, int(token))
        suffix.append(int(token))
        del suffix[:-self.max_order]

    def drop(self, rid: int) -> None:
        self._state.pop(rid, None)

    # ---- proposal ---------------------------------------------------------
    def propose(self, rid: int, k: int) -> list[int]:
        """K draft tokens continuing `rid`'s committed stream: per draft,
        the longest-order table hit on the (simulated) suffix, else repeat
        the last token. Always returns exactly k valid token ids."""
        state = self._state.get(rid)
        if state is None or k <= 0:
            return [0] * max(k, 0)
        tables, suffix = state
        sim = list(suffix)
        out = []
        for _ in range(k):
            nxt = None
            for order in range(min(self.max_order, len(sim)),
                               self.min_order - 1, -1):
                nxt = tables[order - 1].get(tuple(sim[-order:]))
                if nxt is not None:
                    break
            if nxt is None:
                nxt = sim[-1] if sim else 0
            out.append(nxt)
            sim.append(nxt)
        return out
