"""Pipeline schedule tables: FThenB, 1F1B, ZB-H1
(``paddle_tpu.parallel.pipeline_schedules`` counterpart; reference: the
static pipeline scheduler passes ``pipeline_fthenb.py``,
``pipeline_1f1b.py``, ``pipeline_zero_bubble.py`` under
python/paddle/distributed/passes/pipeline_scheduler_pass/, which emit
per-rank job lists of {FORWARD, BACKWARD, (B, W)} per microbatch).

The JAX package runs its 1F1B pipeline as one differentiated scan and
uses these tables for analysis and for ZB-H1. The port's runtimes
(``parallel.pipeline``, ``parallel.zero_bubble``) run them: each pp rank
walks its column of the table, tick by tick.

Each generator returns a dict:
  ticks: list[list[(op, mb, chunk)]] indexed [t][rank]; op in
         {"F", "B", "W", None} (for 1F1B/FThenB, "B" includes W).
  bubble_fraction(sched, rank): fraction of idle (None) ticks.
  peak_activations(sched, rank): max number of microbatches whose forward
         residuals are live at once on that rank.
All schedules are validated by `check_schedule` for data-dependency order:
F(mb) on rank r needs F(mb) on r-1 done; B(mb) on r needs B(mb) on r+1 and
F(mb) on r; W(mb) on r needs B(mb) on r.
"""
from __future__ import annotations

__all__ = ["fthenb_schedule", "one_f_one_b_schedule", "zb_h1_schedule",
           "check_schedule", "bubble_fraction", "peak_activations"]


def _empty(T, S):
    return [[None for _ in range(S)] for _ in range(T)]


def fthenb_schedule(S: int, M: int):
    """All forwards, then all backwards (reference pipeline_fthenb.py).
    Simple and bubble-equal to 1F1B, but every rank holds ALL M microbatch
    activations at the forward peak."""
    ticks = []
    T_f = M + S - 1
    for t in range(T_f):
        row = [None] * S
        for r in range(S):
            mb = t - r
            if 0 <= mb < M:
                row[r] = ("F", mb, 0)
        ticks.append(row)
    for t in range(M + S - 1):
        row = [None] * S
        for r in range(S):
            mb = t - (S - 1 - r)
            if 0 <= mb < M:
                row[r] = ("B", mb, 0)
        ticks.append(row)
    return {"name": "FThenB", "S": S, "M": M, "ticks": ticks}


def one_f_one_b_schedule(S: int, M: int):
    """1F1B (reference pipeline_1f1b.py / PipelineParallel:459): each rank
    runs at most S in-flight forwards before alternating F/B steady state.
    Backward costs one tick here (B includes W), so a backward tick on rank r
    for mb m is scheduled only after rank r+1 finished B(m)."""
    # simulate per-rank queues on a shared tick clock
    ticks = []
    f_done = [[-1] * M for _ in range(S)]   # tick when F(mb) finished on r
    b_done = [[-1] * M for _ in range(S)]
    next_f = [0] * S
    next_b = [0] * S
    warmup = [min(S - r, M) for r in range(S)]  # in-flight cap per rank
    t = 0
    while any(next_b[r] < M for r in range(S)) and t < 4 * (M + S) + 8:
        row = [None] * S
        for r in range(S):
            mb_b = next_b[r]
            can_b = (mb_b < M and f_done[r][mb_b] >= 0 and f_done[r][mb_b] < t
                     and (r == S - 1 or (b_done[r + 1][mb_b] >= 0
                                         and b_done[r + 1][mb_b] < t)))
            in_flight = next_f[r] - next_b[r]
            mb_f = next_f[r]
            # the in-flight cap IS 1F1B's memory bound: idle rather than run
            # an (S+1)-th forward
            can_f = (mb_f < M and in_flight < warmup[r]
                     and (r == 0 or (f_done[r - 1][mb_f] >= 0
                                     and f_done[r - 1][mb_f] < t)))
            # steady state: prefer B once warmup forwards are in flight
            if can_b and (in_flight >= warmup[r] or not can_f):
                row[r] = ("B", mb_b, 0)
                b_done[r][mb_b] = t
                next_b[r] += 1
            elif can_f:
                row[r] = ("F", mb_f, 0)
                f_done[r][mb_f] = t
                next_f[r] += 1
        ticks.append(row)
        t += 1
    return {"name": "1F1B", "S": S, "M": M, "ticks": ticks}


def zb_h1_schedule(S: int, M: int):
    """ZB-H1 (reference pipeline_zero_bubble.py, Qi et al. 2023): backward
    splits into B (activation grad, on the critical path) and W (weight
    grad, no downstream dependence). W jobs fill the drain bubble, so with
    F=B=W=1 tick the steady bubble shrinks toward (S-1)/3 of 1F1B's."""
    ticks = []
    f_done = [[-1] * M for _ in range(S)]
    b_done = [[-1] * M for _ in range(S)]
    w_done = [[-1] * M for _ in range(S)]
    next_f = [0] * S
    next_b = [0] * S
    next_w = [0] * S
    warmup = [min(S - r, M) for r in range(S)]
    t = 0
    while any(next_w[r] < M for r in range(S)) and t < 6 * (M + S) + 12:
        row = [None] * S
        for r in range(S):
            mb_b = next_b[r]
            can_b = (mb_b < M and 0 <= f_done[r][mb_b] < t
                     and (r == S - 1 or 0 <= b_done[r + 1][mb_b] < t))
            in_flight = next_f[r] - next_b[r]
            mb_f = next_f[r]
            can_f = (mb_f < M and in_flight < warmup[r]
                     and (r == 0 or 0 <= f_done[r - 1][mb_f] < t))
            mb_w = next_w[r]
            can_w = mb_w < M and 0 <= b_done[r][mb_w] < t
            # priority: B when enough in flight (frees activations) > F > W
            # (W is bubble filler — it has no downstream consumer)
            if can_b and (in_flight >= warmup[r] or not can_f):
                row[r] = ("B", mb_b, 0)
                b_done[r][mb_b] = t
                next_b[r] += 1
            elif can_f:
                row[r] = ("F", mb_f, 0)
                f_done[r][mb_f] = t
                next_f[r] += 1
            elif can_w:
                row[r] = ("W", mb_w, 0)
                w_done[r][mb_w] = t
                next_w[r] += 1
        ticks.append(row)
        t += 1
    return {"name": "ZB-H1", "S": S, "M": M, "ticks": ticks}


def check_schedule(sched) -> None:
    """Validate data-dependency order; raises AssertionError on violation."""
    S, M, ticks = sched["S"], sched["M"], sched["ticks"]
    f_done = [[-1] * M for _ in range(S)]
    b_done = [[-1] * M for _ in range(S)]
    w_done = [[-1] * M for _ in range(S)]
    for t, row in enumerate(ticks):
        for r, job in enumerate(row):
            if job is None:
                continue
            op, mb, _ = job
            if op == "F":
                assert f_done[r][mb] == -1, f"duplicate F({mb}) on rank {r}"
                assert r == 0 or 0 <= f_done[r - 1][mb] < t, \
                    f"F({mb}) on {r} before upstream F at t={t}"
                f_done[r][mb] = t
            elif op == "B":
                assert 0 <= f_done[r][mb] < t, f"B({mb}) before F on {r}"
                assert r == S - 1 or 0 <= b_done[r + 1][mb] < t, \
                    f"B({mb}) on {r} before downstream B at t={t}"
                assert b_done[r][mb] == -1
                b_done[r][mb] = t
            elif op == "W":
                assert 0 <= b_done[r][mb] < t, f"W({mb}) before B on {r}"
                w_done[r][mb] = t
    has_w = any(job is not None and job[0] == "W"
                for row in ticks for job in row)
    for r in range(S):
        for m in range(M):
            assert f_done[r][m] >= 0 and b_done[r][m] >= 0, \
                f"missing F/B for mb {m} on rank {r}"
            if has_w:
                assert w_done[r][m] >= 0, f"missing W for mb {m} on rank {r}"


def bubble_fraction(sched, rank=None) -> float:
    """Idle-tick fraction (averaged over ranks unless one is given)."""
    ticks, S = sched["ticks"], sched["S"]
    ranks = range(S) if rank is None else [rank]
    idle = total = 0
    for r in ranks:
        for row in ticks:
            total += 1
            if row[r] is None:
                idle += 1
    return idle / max(total, 1)


def peak_activations(sched, rank=0) -> int:
    """Max microbatches whose forward residuals are live on `rank` (freed
    when the rank finishes the job that consumes them: B for F-residuals)."""
    live = set()
    peak = 0
    for row in sched["ticks"]:
        job = row[rank]
        if job is not None:
            op, mb, _ = job
            if op == "F":
                live.add(mb)
            elif op == "B":
                live.discard(mb)
            peak = max(peak, len(live))
    return peak
