"""Flag registry of the port (``paddle_tpu.core.flags`` counterpart).

Same names, types and defaults as the JAX package for the flags the port
reads; ``FLAGS_<name>`` in the environment overrides a default. A flag set
by that variable or by ``set_flags`` counts as explicitly set
(``flag_explicit``), which is how the tuning resolver tells an override of
a flag whose default is a real value (``serving_page_size``) from the
default.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any

__all__ = ["define_flag", "flag", "flag_explicit", "set_flags"]

_lock = threading.Lock()


@dataclass
class _Flag:
    name: str
    type: type
    default: Any
    help: str
    value: Any
    explicit: bool = False


_REGISTRY: dict[str, _Flag] = {}


def _coerce(typ: type, raw: Any) -> Any:
    if typ is bool:
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return typ(raw)


def define_flag(name: str, default: Any, help: str = "",
                type: type | None = None):
    """Register a flag; environment variable FLAGS_<name> overrides the
    default."""
    typ = type or (bool if isinstance(default, bool) else default.__class__)
    with _lock:
        if name in _REGISTRY:
            return _REGISTRY[name]
        env = os.environ.get(f"FLAGS_{name}")
        value = default if env is None else _coerce(typ, env)
        f = _Flag(name, typ, default, help, value, env is not None)
        _REGISTRY[name] = f
        return f


def flag(name: str):
    return _REGISTRY[name].value


def set_flags(flags: dict) -> None:
    """Update registered flags by name (with or without the FLAGS_
    prefix), as ``paddle.set_flags``."""
    for key, val in flags.items():
        name = key[6:] if key.startswith("FLAGS_") else key
        with _lock:
            if name not in _REGISTRY:
                raise KeyError(f"unknown flag: {key}")
            f = _REGISTRY[name]
            f.value = _coerce(f.type, val)
            f.explicit = True


def flag_explicit(name: str) -> bool:
    """True when the flag was set by the user (``FLAGS_<name>`` at
    definition or a ``set_flags`` call), not left at its default."""
    return _REGISTRY[name].explicit


define_flag("serving_page_size", 16,
            "KV-cache page size in tokens (page granularity of the paged "
            "decode kernel and the serving allocator)", type=int)
define_flag("serving_num_pages", 0,
            "total KV-cache pages (page 0 is the reserved null page); 0 = "
            "derive from serving_hbm_budget_mb and the model geometry",
            type=int)
define_flag("serving_hbm_budget_mb", 64,
            "device-memory budget of the paged KV cache when "
            "serving_num_pages=0", type=int)
define_flag("serving_decode_batch", 8,
            "fixed decode-batch width: every decode step runs this many "
            "slots, inactive ones as len-0 rows", type=int)
define_flag("serving_prefill_chunk", 256,
            "max tokens per prefill chunk", type=int)
define_flag("serving_max_seq_len", 0,
            "max context (prompt + generated) of a request; 0 = the "
            "model's max_position_embeddings", type=int)
define_flag("serving_prefill_pack", 1,
            "pack admissions arriving together into one segment-id prefill "
            "frame (first-fit over 32-aligned rows); 0 = always chunked",
            type=int)
define_flag("serving_pack_frame", 0,
            "packed-prefill frame length in tokens (rounded down to 32); "
            "0 = serving_prefill_chunk", type=int)
define_flag("serving_prefix_sharing", 1,
            "copy-on-write shared-prefix KV page reuse: admission matches "
            "the longest committed full-page prefix of the new context in "
            "the allocator's radix index and links those pages (refcounted) "
            "into the new chain, so prefill runs only the unmatched tail; "
            "writes into shared pages copy on write. 0 = off", type=int)
define_flag("serving_kv_cache_dtype", "model",
            "KV page-pool storage: 'model' stores pages in the weight dtype, "
            "'int8'/'fp8' store codes (int8, float8_e4m3fn) with fp32 "
            "per-slot-per-head absmax scales in side pools, dequantized "
            "inside the paged kernel", type=str)
define_flag("serving_host_cache_mb", 0,
            "host-RAM cold tier for committed KV pages: when > 0, indexed "
            "pages whose last holder frees them stay cold and demote to a "
            "host pool of this many MB (pinned on CUDA) under pressure; a "
            "later prefix match promotes them back; 0 = off", type=int)
define_flag("serving_waiting_queue_limit", 128,
            "bound on the scheduler's waiting queue (QueueFull past it); "
            "0 = unbounded", type=int)
define_flag("serving_queue_limit", 32,
            "bounded HTTP handler queue (503 past it)", type=int)
define_flag("serving_request_timeout_s", 60.0,
            "per-request wall-clock budget of the HTTP front-end",
            type=float)
define_flag("serving_max_body_mb", 8,
            "Content-Length cap of the HTTP front-end", type=int)
define_flag("router_retry_after_s", 1.0,
            "Retry-After seconds advertised on admission-control 503s",
            type=float)
define_flag("use_fused_head_loss", True,
            "LlamaForCausalLM with labels computes the head projection and "
            "CE in one chunked fused op (no [tokens, vocab] logits); False "
            "restores the unfused logits + cross_entropy path")
define_flag("fused_ce_chunk_tokens", 0,
            "fused-CE token chunk of the backward's recomputed logits tiles "
            "(0 = auto: tuning cache, then ~4M-element tiles)", type=int)
define_flag("moe_dispatch", "capacity",
            "default MoELayer dispatch mode, consulted when the layer is "
            "constructed with dispatch=None: 'capacity' (fixed [E, C, d] "
            "buckets, overflow tokens dropped and counted) or 'dropless' "
            "(sort-based ragged dispatch through the grouped-matmul "
            "kernels: no capacity, no drops)")
# Kept for parity with the JAX package's flag of the same name. In the port
# it changes padding only: the CUDA grouped-matmul tile is fixed (128 rows
# bf16, 64 fp32) and exact for any layout, whatever this value is.
define_flag("moe_block_rows", 0,
            "row alignment of the dropless MoE dispatch's expert buckets "
            "(0 = auto: tuning cache, then 128, stepping down for small "
            "problems); also the "
            "grouped matmul's row-count granularity", type=int)
define_flag("rmsnorm_block_rows", 0,
            "RMSNorm kernel row-block override (0 = auto: tuning cache, "
            "then the smallest block that keeps the grid within 1024 "
            "blocks, clamped to the row count)", type=int)
define_flag("autotune", "off",
            "block-size tuning mode of the shared kernel resolver "
            "(tuning.blocks.resolve_blocks): 'off' = flags and heuristics "
            "only, 'load' = consult the JSON tuning cache under "
            "FLAGS_tuning_cache_dir and fall back to the heuristic on a "
            "miss, 'search' = on a miss also time the legal block lattice "
            "on the card now, persist the winner, and use it")
define_flag("tuning_cache_dir", "",
            "directory of the JSON block-shape tuning cache read by "
            "FLAGS_autotune=load|search; empty disables the cache tier")
