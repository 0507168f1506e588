"""Block-size autotuner: search each kernel's legal block lattice by timing
real launches, persist the winners in the JSON tuning cache
(``paddle_tpu.tuning.autotune`` counterpart).

Search space: per kernel, the block values the port's kernel can launch
on Hopper, where the JAX package bounds TPU tiles by the VMEM budget:

* rmsnorm: the row blocks ``ROW_BLOCKS`` (8 to 512 rows, all under the
  kernel's ``MAX_BLOCK_ROWS``), clamped to the row count;
* grouped_matmul: the power-of-two divisors of ``n_rows`` up to 128, as in
  JAX. In the port the value is the row alignment the dropless dispatcher
  pads each expert's bucket to (the CUDA tile is fixed), so the runner
  times the grouped matmul over the dispatcher's bucket layout for a
  seeded routing: a larger block pads more rows, a smaller one leaves more
  kernel tiles straddling two experts;
* paged_attention: page sizes 8 to 128 up to ``max_seq_len``, as in JAX;
  the paged kernel takes any page size;
* fused_ce: token chunks of the backward's recomputed logits tiles (64 to
  4096 tokens, clamped to ``n_tokens``), ``chunk_vocab`` the heuristic's:
  the port reads no vocab chunk. On the card the runner times the bf16
  head the models train (the backward's kernels, ``ce_bwd``) at the 7B
  head's hidden size unless a dtype is given; an fp32 search would time
  the fp32 ``torch.matmul`` route instead.

flash_fwd and flash_bwd have no lattice: each kernel is compiled for one
tile (bf16: the forward 64 x 64 at head_dim 128 and 128 x 64 at 64, the
backward 64 x 64, q x k) until the kernels are templated on tiles.

Each candidate is validated by its call site's own check, then timed
through the kernel's public entry point under a `trial_blocks` override,
so the dispatch path being tuned is the path being timed. Runners take an
explicit device (default "cuda"). On the card a candidate's time is device
time: the call is captured into a CUDA graph and its replays are timed
between two CUDA events, without the wrappers' host work (which is as
long as a small kernel, and a call of many launches would fill the
device's launch queue). On the CPU the runners take the plain
versions, which exercises search, persist, load and dispatch, but CPU
timings rank nothing. A runner that times a backward enters
``torch.enable_grad()`` itself (a dispatch-time search can start inside an
autograd Function's forward, where grad is off) and differentiates fresh
leaves with ``torch.autograd.grad``, so the caller's graph is untouched.
"""
from __future__ import annotations

import time

import torch

__all__ = ["candidate_blocks", "candidate_kernels", "make_runner",
           "autotune_kernel", "autotune_report"]

_GMM_ROW_BLOCKS = (8, 16, 32, 64, 128)
_PAGE_SIZES = (8, 16, 32, 64, 128)
_CE_CHUNK_TOKENS = (64, 256, 1024, 4096)
_CE_HIDDEN = 4096          # the fused_ce runner's hidden size on the card


def candidate_kernels() -> list[str]:
    """The resolver entries that have a lattice to search."""
    from paddle_tpu_torch.tuning.blocks import KERNELS

    return [k for k, spec in KERNELS.items() if spec.tunable]


def candidate_blocks(kernel: str, geometry: dict,
                     dtype: str = "") -> list[dict]:
    """The legal lattice for one (kernel, geometry). Every entry is a full
    values dict the resolver can consume."""
    if kernel == "grouped_matmul":
        m = int(geometry["n_rows"])
        out = [b for b in _GMM_ROW_BLOCKS if b <= m and m % b == 0]
        return [{"block_rows": b} for b in out or [m]]
    if kernel == "fused_ce":
        from paddle_tpu_torch.ops.cuda.fused_ce import resolve_chunks

        n, v = int(geometry["n_tokens"]), int(geometry["vocab"])
        cv = resolve_chunks(n, v)[1]
        cts = sorted({max(1, min(n, t)) for t in _CE_CHUNK_TOKENS})
        return [{"chunk_tokens": ct, "chunk_vocab": cv} for ct in cts]
    if kernel == "rmsnorm":
        from paddle_tpu_torch.ops.cuda.rmsnorm_kernel import ROW_BLOCKS

        rows = max(int(geometry["rows"]), 1)
        return [{"block_rows": b}
                for b in sorted({min(rows, b) for b in ROW_BLOCKS})]
    if kernel == "paged_attention":
        s = int(geometry["max_seq_len"])
        return [{"page_size": p} for p in _PAGE_SIZES if p <= s]
    raise ValueError(f"no candidate lattice for kernel {kernel!r} "
                     f"(searchable: {candidate_kernels()}; the flash "
                     f"kernels are compiled for one tile)")


def _validator(kernel: str):
    """The check each kernel's call site runs on resolved values; a
    candidate that fails it is never launched."""
    if kernel == "rmsnorm":
        from paddle_tpu_torch.ops.cuda.rmsnorm_kernel import validate_blocks

        return validate_blocks
    param, multiple_of = {"grouped_matmul": ("block_rows", "n_rows"),
                          "fused_ce": ("chunk_tokens", None),
                          "paged_attention": ("page_size", None)}[kernel]

    def validate(values, geometry):
        v = int(values[param])
        n = int(geometry[multiple_of]) if multiple_of else v
        if v <= 0 or n % v:
            raise ValueError(f"{kernel}: {param}={v} must be positive"
                             + (f" and divide {multiple_of}={n}"
                                if multiple_of else ""))

    return validate


# ---------------------------------------------------------------------------
# runners: values -> one invocation of the real public entry point
# ---------------------------------------------------------------------------


def make_runner(kernel: str, geometry: dict, dtype: str = "",
                device="cuda"):
    """run(values) executing the kernel once through its public entry point
    (under the caller's ``trial_blocks``) on `device`, without waiting for
    the device. Inputs come from a fixed-seed generator of their own, so a
    search leaves the global random state alone."""
    from paddle_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    dt = getattr(torch, dtype) if dtype else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dt)

    if kernel == "grouped_matmul":
        from paddle_tpu_torch.incubate.distributed.models.moe.dropless import \
            ragged_layout
        from paddle_tpu_torch.ops.cuda.grouped_matmul import (
            grouped_matmul, pick_block_rows)

        m, g = int(geometry["n_rows"]), int(geometry["num_groups"])
        width = 128
        w = randn(g, width, width, scale=0.1)
        # one expert per routed token copy, as the dispatcher sees them
        experts = torch.randint(0, g, (m,), generator=gen, device=dev)
        layouts = {}                # block rows -> (bucket buffer, gids)

        def run(values):
            bm = pick_block_rows(m, g, dev)
            if bm not in layouts:   # built by the warm-up run, not timed
                gbuf = ragged_layout(experts, g, bm)[3]
                layouts[bm] = randn(gbuf.shape[0], width), gbuf
            x, gbuf = layouts[bm]
            return grouped_matmul(x, w, gbuf)

        return run

    if kernel == "fused_ce":
        from paddle_tpu_torch.nn.functional import fused_linear_cross_entropy

        n, v = int(geometry["n_tokens"]), int(geometry["vocab"])
        if dev.type == "cuda":
            # the geometry has no hidden size: time the LLaMA-7B head's,
            # in bf16 unless a dtype is given (the kernels' dtype)
            h, dt = _CE_HIDDEN, getattr(torch, dtype or "bfloat16")
        else:
            h = 64
        x = randn(n, h)
        w = randn(v, h, scale=0.02)
        labels = torch.arange(n, device=dev) % v

        def run(values):
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                ww = w.detach().requires_grad_()
                loss = fused_linear_cross_entropy(xx, ww, labels)
                return torch.autograd.grad(loss, (xx, ww))

        return run

    if kernel == "rmsnorm":
        from paddle_tpu_torch.ops.cuda.rmsnorm_kernel import rmsnorm

        rows, d = int(geometry["rows"]), int(geometry["d"])
        x = randn(rows, d)
        w = randn(d)
        dy = randn(rows, d)

        def run(values):
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                ww = w.detach().requires_grad_()
                y = rmsnorm(xx, ww)
                return torch.autograd.grad(y, (xx, ww), dy)

        return run

    if kernel == "paged_attention":
        from paddle_tpu_torch.ops.cuda.paged_attention import paged_attention

        h, d = int(geometry["num_kv_heads"]), int(geometry["head_dim"])
        s = int(geometry["max_seq_len"])
        q = randn(2, h, d)
        lens = torch.tensor([s, s // 2 + 1], dtype=torch.int32, device=dev)
        pools = {}                  # page size -> (pool, page table)

        def run(values):
            ps = int(values["page_size"])
            if ps not in pools:     # built by the warm-up run, not timed
                pages_per_seq = -(-s // ps)
                table = torch.arange(1, pages_per_seq + 1, dtype=torch.int32,
                                     device=dev)[None].repeat(2, 1)
                # + the null page and one of slack
                pools[ps] = randn(h, pages_per_seq + 2, ps, d), table
            kp, table = pools[ps]
            return paged_attention(q, kp, kp, table, lens)

        return run

    raise ValueError(f"no runner for kernel {kernel!r}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _graph_ms(run, values, trials: int, reps: int) -> float:
    """Device ms per call of run(values): the call is captured once into a
    CUDA graph (the wrappers' host work runs at capture) and replayed
    `reps` times between two CUDA events, `trials` times; the minimum.
    One launch a replay keeps the device fed whatever the call's launch
    count or host time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(values)                 # warm on the side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(values)
    graph.replay()
    best = float("inf")
    for _ in range(max(1, trials)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    from paddle_tpu_torch.ops import cuda as port_cuda

    return port_cuda.launch_counts()


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def autotune_kernel(kernel: str, geometry: dict, *, dtype: str = "",
                    cache=None, trials: int = 5, reps: int = 10,
                    candidates: list | None = None,
                    device="cuda") -> dict | None:
    """Time every legal candidate on `device`, persist the winner in `cache`
    (a TuningCache), return {"values", "ms", "candidates", "timings",
    "launches"} or None when no candidate survives. Each candidate is
    validated and run once to warm; on the card it is then timed on the
    device alone (``_graph_ms``: `trials` times `reps` graph replays), on
    the CPU as `trials` single calls on the host clock. The minimum ranks.
    ``timings`` lists every candidate's ms; ``launches`` counts, by
    kernel, the launches the search's wrapper calls made (a graph replay
    re-runs its captured launches uncounted). A candidate that fails,
    to launch or to be captured, is skipped with an ``autotune_skip``
    journal event."""
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.observability import events as _events
    from paddle_tpu_torch.tuning import blocks

    cands = candidates if candidates is not None \
        else candidate_blocks(kernel, geometry, dtype)
    dev = resolve_device(device)
    run = make_runner(kernel, geometry, dtype, dev)
    validate = _validator(kernel)
    before = _launches()
    best_values, best_ms, timings = None, float("inf"), []
    for values in cands:
        with blocks.trial_blocks(kernel, values):
            try:
                validate(values, geometry)
                run(values)                 # warm: first loads, allocations
                _sync(dev)
                if dev.type == "cuda":
                    ms = _graph_ms(run, values, trials, reps)
                else:
                    ms = float("inf")
                    for _ in range(max(1, trials)):
                        t0 = time.perf_counter()
                        run(values)
                        ms = min(ms, (time.perf_counter() - t0) * 1e3)
            except Exception as e:
                _events.emit("tuning", "autotune_skip", severity="warn",
                             kernel=kernel, values=dict(values),
                             error=str(e)[:200])
                continue
        blocks.bump_counter("autotune_trials")
        timings.append({"values": dict(values), "ms": ms})
        if ms < best_ms:
            best_values, best_ms = dict(values), ms
    launches = {k: n - before.get(k, 0) for k, n in _launches().items()
                if n != before.get(k, 0)}
    if best_values is None:
        return None
    key = blocks.cache_key(kernel, geometry, dtype, blocks.platform_of(dev))
    if cache is not None:
        cache.store(key, best_values, ms=best_ms, trials=len(cands))
    _events.emit("tuning", "autotune", kernel=kernel, key=key,
                 values=best_values, ms=round(best_ms, 4),
                 candidates=len(cands), timings=timings, launches=launches)
    return {"values": best_values, "ms": best_ms, "candidates": len(cands),
            "timings": timings, "launches": launches}


def autotune_report(geometries: dict, *, cache_dir: str, dtype: str = "",
                    trials: int = 5, reps: int = 10, device="cuda") -> dict:
    """Batch entry: {kernel: geometry} -> {cache key: winner}, persisted
    under `cache_dir`. The offline face of the search FLAGS_autotune=search
    runs at dispatch time; it always searches."""
    from paddle_tpu_torch.tuning.blocks import (TuningCache, cache_key,
                                                platform_of)

    cache = TuningCache.load(cache_dir)
    out = {}
    for kernel, geometry in geometries.items():
        won = autotune_kernel(kernel, geometry, dtype=dtype, cache=cache,
                              trials=trials, reps=reps, device=device)
        if won is not None:
            out[cache_key(kernel, geometry, dtype,
                          platform_of(device))] = won
    return out
