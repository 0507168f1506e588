"""The LoRA dispatch seam: what the model's projections consult per call
(``paddle_tpu.lora.seam`` counterpart).

Two registration planes share one lookup point, ``delta(weight, x)``:

* TRAIN plane — `adapter.attach()` registers per-weight A/B Parameters
  keyed by ``id(weight)`` (the ``nn.Parameter`` object a projection holds
  is stable). The projection adds ``scale * (x @ A) @ B``, which autograd
  differentiates like any other parameter.
* SERVE plane — a thread-local `ServeBinding` the serving engine installs
  around each model call: per-weight adapter POOLS (``[G, d_in, r]`` /
  ``[G, r, d_out]``, the ``alpha / r`` scale baked into B) plus the
  per-batch-row slot ids. The delta gathers each row's adapter through two
  grouped products, so one dispatch serves any mix of adapters.

`active()` is the one branch a projection pays when nothing is attached
or bound. This module imports only the standard library and torch; the
grouped-matmul wrapper loads on the first serve delta.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["TrainEntry", "ServeBinding", "train_register", "train_clear",
           "serve_bind", "active", "serve_delta", "delta"]


class TrainEntry:
    """One adapted weight's train-mode factors (A [in, r], B [r, out]
    Parameters) and the baked ``alpha / rank`` scale."""

    __slots__ = ("A", "B", "scale")

    def __init__(self, A, B, scale: float):
        self.A = A
        self.B = B
        self.scale = float(scale)


class ServeBinding:
    """The serve-mode view a projection reads: ``pools[id(weight)] ->
    (a_pool, b_pool)`` tensors on the model's device, per-batch-row
    ``slots`` (int32 on that device; ``num_slots`` marks rows without an
    adapter — the grouped matmul's trash id, an exact zero delta)."""

    __slots__ = ("pools", "slots", "num_slots")

    def __init__(self, pools: dict, slots, num_slots: int):
        self.pools = pools
        self.slots = slots
        self.num_slots = int(num_slots)


_train_entries: dict[int, TrainEntry] = {}
_tls = threading.local()


def train_register(wid: int, entry: TrainEntry):
    _train_entries[wid] = entry


def train_clear(wids):
    for wid in wids:
        _train_entries.pop(wid, None)


@contextmanager
def serve_bind(binding: ServeBinding):
    prev = getattr(_tls, "binding", None)
    _tls.binding = binding
    try:
        yield binding
    finally:
        _tls.binding = prev


def active() -> bool:
    """The one-branch check a projection pays when no adapter is attached
    or bound anywhere (the common case)."""
    return bool(_train_entries) or getattr(_tls, "binding", None) is not None


def serve_delta(v, a_pool, b_pool, binding: ServeBinding):
    """Per-row adapter delta of one projection, fp32 ``[..., d_out]``:
    flatten ``v [..., d]`` to rows, repeat the per-batch-row slot ids over
    the token dim (row ``b*T + t`` belongs to batch row ``b``, so a
    ``[B, K+1]`` verify frame and a ``[1, T]`` prefill chunk work alike),
    then two grouped products: ``h = v.to(A) @ A[slot]`` and ``h.to(B) @
    B[slot]``. On a CUDA tensor both run the hand-written grouped-matmul
    kernel (``gmm_fwd``) and a failure raises; on the CPU, its plain
    version. Exact per row for ANY slot mix: rows carrying the trash id
    ``num_slots`` get an exact zero."""
    from paddle_tpu_torch.ops.cuda.grouped_matmul import (
        gmm_fwd, grouped_matmul_reference)

    shape = v.shape
    rows = v.reshape(-1, shape[-1])
    slots = binding.slots
    reps = rows.shape[0] // slots.shape[0]
    gids = slots.repeat_interleave(reps) if reps > 1 else slots
    product = gmm_fwd if rows.is_cuda else grouped_matmul_reference
    h = product(rows.to(a_pool.dtype), a_pool, gids)
    out = product(h.to(b_pool.dtype), b_pool, gids)
    return out.reshape(tuple(shape[:-1]) + (b_pool.shape[-1],))


def delta(weight, x):
    """The adapter delta for the projection holding `weight` applied to
    `x`, or None when neither plane covers it: the serve binding's pools
    first (fp32, the caller casts), then the train plane's factors
    (``scale * (x @ A) @ B`` in x's dtype, differentiable)."""
    sb = getattr(_tls, "binding", None)
    if sb is not None:
        pool = sb.pools.get(id(weight))
        if pool is not None:
            return serve_delta(x, pool[0], pool[1], sb)
    entry = _train_entries.get(id(weight))
    if entry is not None:
        return entry.scale * ((x @ entry.A) @ entry.B)
    return None
