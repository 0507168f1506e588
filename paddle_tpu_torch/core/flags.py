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
define_flag("fault_injection", "",
            "unified fault-injection spec: ';'-separated armings of "
            "registered points, each 'name[:opts]' with opts nth=K | p=X "
            "| seed=N | mode=once|always (default one-shot), e.g. "
            "'feeder.collate' or 'ckpt.before_rename:nth=8;"
            "step.grads:p=0.05,seed=7'. Catalog: "
            "distributed.resilience.faults.describe()")
define_flag("router_probe_interval_s", 0.25,
            "router health-monitor cadence: each replica's health()/"
            "readiness (queue depth, slot fill, retraces) is probed this "
            "often, and heartbeat liveness (dead_peers) is re-read on the "
            "same tick", type=float)
define_flag("router_failure_threshold", 3,
            "consecutive dispatch/probe failures that trip a replica's "
            "circuit breaker OPEN (dispatches stop routing to it)",
            type=int)
define_flag("router_breaker_cooldown_s", 1.0,
            "seconds an OPEN replica circuit waits before HALF-OPEN: one "
            "trial dispatch is let through; success closes the circuit, "
            "failure re-opens it for another cooldown", type=float)
define_flag("router_dispatch_attempts", 3,
            "total dispatch attempts per request (first try + failover "
            "re-dispatches); past this the request returns ONE typed "
            "error event instead of retrying forever", type=int)
define_flag("router_backoff_initial_s", 0.05,
            "first failover re-dispatch backoff; doubles per retry up to "
            "router_backoff_max_s", type=float)
define_flag("router_backoff_max_s", 1.0,
            "failover re-dispatch backoff ceiling", type=float)
define_flag("router_gap_timeout_s", 5.0,
            "max silence between consecutive stream events from a "
            "replica before the router declares it wedged FOR THIS "
            "REQUEST and fails over (also the detection bound for a "
            "dropped dispatch)", type=float)
define_flag("router_max_inflight", 64,
            "router admission cap: requests in flight across all "
            "replicas; past it new requests are refused with 503 + "
            "Retry-After at admission (before any replica dispatch)",
            type=int)
define_flag("router_shed_queue_depth", 32,
            "overload shed watermark: when aggregate depth (router "
            "in-flight + probed replica queue depths) exceeds this, the "
            "shed policy caps max_new_tokens instead of dropping "
            "requests", type=int)
define_flag("router_shed_max_new_tokens", 32,
            "max_new_tokens cap applied by the shed policy under "
            "overload (degrade before drop)", type=int)
define_flag("router_retry_after_s", 1.0,
            "Retry-After seconds advertised on admission-control 503s",
            type=float)
define_flag("router_placement", "session",
            "replica placement key: 'session' rendezvous-hashes the "
            "session id (one user sticks to one replica), "
            "'prefix' rendezvous-hashes a bounded digest of the prompt's "
            "first router_prefix_tokens ids (session id as tiebreak when "
            "no prompt is present), so requests sharing a system prompt "
            "land where its KV pages already live and the per-replica "
            "prefix-hit rate becomes a fleet-wide property; 'adapter' "
            "rendezvous-hashes the request's LoRA adapter id (session "
            "fallback when none), so one tenant's requests land where "
            "their adapter is already resident in the slot pool")
define_flag("router_prefix_tokens", 64,
            "prompt-prefix digest length (tokens) for "
            "router_placement=prefix: long enough to separate distinct "
            "system prompts, short enough that a shared preamble maps all "
            "its requests to one digest", type=int)
define_flag("router_tenant_max_inflight", 0,
            "per-tenant in-flight fairness cap at router admission: one "
            "tenant (request 'tenant' field, adapter id fallback) may hold "
            "at most this many concurrent streams — past it the request is "
            "refused with a typed 'tenant_limit' event + Retry-After, so a "
            "flooding tenant cannot starve the shared engine; 0 = off",
            type=int)
define_flag("serving_adapter_slots", 16,
            "LoRA AdapterStore device slot-pool size: how many adapters can "
            "be RESIDENT (servable) at once per engine; registered "
            "adapters beyond this page host<->device on demand (LRU over "
            "refcount-0 slots, pinned slots never evicted)", type=int)
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
