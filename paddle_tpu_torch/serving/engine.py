"""The serving engine: paged KV cache + continuous-batching decode
(``paddle_tpu.serving.engine`` counterpart, ``mixed`` role).

Same scheduling as the JAX engine, run eagerly by PyTorch:

  * every decode step runs the fixed ``[decode_batch]`` slot layout —
    token ids, context lens, page tables and sampling knobs are tensors,
    inactive slots are len-0 rows the paged kernel writes zeros for;
  * admissions arriving together are PACKED into one ``[1, frame]``
    segment-id prefill frame (first-fit over 32-aligned rows, one page
    chain per segment); prompts longer than the frame, solo arrivals and
    requests that adopted a shared prefix run chunked prefill, one request
    at a time in chunks of ``prefill_chunk`` tokens from the first
    unmatched token, with chunk and context lengths rounded up to
    power-of-two buckets as in the JAX engine;
  * a prefill writes every prompt token's K/V; the first decode step
    re-feeds the last prompt token at its own position (the rewrite that
    mints the first generated token), so prefill never samples;
  * prefix sharing (``serving_prefix_sharing``, on by default): a request's
    committed full pages are registered in the allocator's prefix index
    after its prefill, later admissions adopt them, and a decode write into
    a shared page copies it first;
  * the KV hierarchy: ``kv_cache_dtype`` "int8"/"fp8" stores codes
    (``torch.int8``, ``torch.float8_e4m3fn``) with fp32 per-slot-per-head
    scales in side pools, dequantized inside the paged kernel;
    ``host_cache_mb`` keeps cold indexed pages in a host store (pinned on
    CUDA) they demote to under pressure and promote back from on a prefix
    match;
  * speculative decoding (``spec_k`` = K > 0): the n-gram proposer drafts
    up to K tokens a request from its own committed stream, and each step
    runs ONE ``[decode_batch, K + 1]`` verify frame through the paged
    kernel (query i sees keys < len + i; slots past a row's draft window
    write the null page). Position i samples with the generator state
    plain decode would hold after i commits; the drafts that equal the
    frame's own samples are accepted, plus the first sample that differs,
    so every stream equals plain decode's.

  * multi-tenant LoRA (``adapter_store=``): a request names an adapter
    (``submit(adapter=, tenant=)``), pinned in the store's device slot pool
    from submit to release. Each dispatch binds the per-row slot ids (the
    store's trash id for base rows and empty slots): the decode and verify
    frames carry one id a batch row, a chunked prefill one for its
    request, and a packed prefill frame holds one adapter only (a change
    of adapter flushes the frame). The projections add each row's delta
    through the grouped-matmul kernel. Pages written under an adapter are
    indexed in its own prefix namespace (adapter id and weight
    generation), so no other adapter and no base request adopts them.
    A hot swap from another thread is staged by the store and written at
    the start of the next step, so it lands between steps and never
    waits for one.

Ordering contract, as in the JAX engine: queued tier copies (demotes, then
promotes), then copy-on-write copies, then any prefill or decode write.

On CUDA both attention paths run the port's hand-written Hopper kernels
(``ops/cuda``); the K/V pools are updated in place. A scrape-time
collector mirrors ``stats()`` into the metrics registry (``GET /metrics``),
and prefill, packed-prefill and decode/verify steps record spans carrying
the requests' trace ids while tracing is on.

Not ported yet (raise NotImplementedError): the prefill/decode roles.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.distributed.resilience import faults
# importing the store registers the serving.lora.swap_fail chaos point
from paddle_tpu_torch.lora.store import AdapterLoadError
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import tracing as obs_tracing
from paddle_tpu_torch.quantization import raw_bytes
from paddle_tpu_torch.serving.drafts import NGramProposer
from paddle_tpu_torch.serving.kv_cache import (PageAllocator, kv_page_bytes,
                                               pages_for_budget)
from paddle_tpu_torch.serving.sampling import (request_generator,
                                               sample_frame, sample_tokens)
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                QueueFull, Request)

__all__ = ["ServingConfig", "ServingEngine"]

faults.register(
    "serving.spec.verify_mismatch",
    "forces a speculative verify step to reject every draft (every row's "
    "window zeroed): the engine must degrade to plain one-token decode "
    "for the step (same stream, lower throughput), never wedge")


@dataclass
class ServingConfig:
    page_size: int = 0              # 0 -> FLAGS_serving_page_size
    num_pages: int = 0              # 0 -> FLAGS_serving_num_pages, then
                                    #      derive from hbm_budget_mb
    hbm_budget_mb: int = 0          # 0 -> FLAGS_serving_hbm_budget_mb
    decode_batch: int = 0           # 0 -> FLAGS_serving_decode_batch
    prefill_chunk: int = 0          # 0 -> FLAGS_serving_prefill_chunk
    max_seq_len: int = 0            # 0 -> FLAGS_serving_max_seq_len or model
    kv_dtype: object = None         # None -> model param dtype
    kv_cache_dtype: str = ""        # "" -> FLAGS_serving_kv_cache_dtype
                                    #   ("model" | "int8" | "fp8")
    host_cache_mb: int = -1         # <0 -> FLAGS_serving_host_cache_mb
    sample_seed: int = 0
    max_waiting: int = 0            # 0 -> FLAGS_serving_waiting_queue_limit
    spec_k: int = 0                 # speculative draft window K (0 off)
    prefix_sharing: bool | None = None  # None -> FLAGS_serving_prefix_sharing
    role: str = "mixed"             # only "mixed" is ported
    prefill_pack: bool | None = None    # None -> FLAGS_serving_prefill_pack
    pack_frame: int = 0             # 0 -> FLAGS_serving_pack_frame,
                                    #      then prefill_chunk

    def check_ported(self):
        if (self.role or "mixed").lower() != "mixed":
            raise NotImplementedError(
                f"not ported to paddle_tpu_torch yet: role={self.role!r}")


# KV storage modes that keep codes, and the pool dtype of each
_CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

_engine_seq = itertools.count()
# stats() fields mirrored as serving_engine_<name> gauges, and engine
# totals mirrored as serving_engine_<name>_total counters (the JAX
# engine's names)
_ENGINE_GAUGES = (
    "queue_depth", "oldest_wait_age_s", "in_flight", "slot_fill",
    "free_pages", "spec_k", "accepted_tokens_per_step", "prefix_hit_rate",
    "cow_copies", "prefill_batch_fill")
_ENGINE_COUNTERS = {
    "committed_tokens": "_committed_tokens",
    "decode_steps": "_decode_steps",
    "prefix_matched_tokens": "_prefix_matched_tokens",
}


def _register_engine_metrics(engine: "ServingEngine"):
    """Scrape-time collector (``paddle_tpu/serving/engine.py:173``): the
    engine's stats, KV tier occupancy and per-tenant committed tokens
    mirror into the registry when /metrics is read, so the decode loop pays
    nothing; the weakref owner unhooks a collected engine."""
    ref = weakref.ref(engine)

    def collect(reg):
        eng = ref()
        if eng is None:
            return
        st = eng.stats()
        for k in _ENGINE_GAUGES:
            reg.gauge(f"serving_engine_{k}",
                      f"ServingEngine.stats()['{k}']",
                      labels=("engine",)).labels(
                engine=eng._metrics_id).set(float(st.get(k, 0) or 0))
        for name, attr in _ENGINE_COUNTERS.items():
            reg.counter(f"serving_engine_{name}_total",
                        f"monotonic engine total: {name}",
                        labels=("engine",)).labels(
                engine=eng._metrics_id)._set_total(
                float(getattr(eng, attr)))
        alloc = eng.allocator
        tiers = reg.gauge("kv_tier_pages",
                          "KV pages resident per tier (hbm counts held + "
                          "cold committed pages; host counts demoted "
                          "pages in the host pool)",
                          labels=("engine", "tier"))
        tiers.labels(engine=eng._metrics_id, tier="hbm").set(
            float(eng.num_pages - 1 - alloc.free_pages))
        tiers.labels(engine=eng._metrics_id, tier="host").set(
            float(alloc.host_used))
        reg.counter("kv_demotions_total",
                    "KV pages demoted device -> host (tier evictions)",
                    labels=("engine",)).labels(
            engine=eng._metrics_id)._set_total(float(alloc.demotions))
        reg.counter("kv_promotions_total",
                    "KV pages promoted host -> device (radix-hit restores)",
                    labels=("engine",)).labels(
            engine=eng._metrics_id)._set_total(float(alloc.promotions))
        reg.gauge("kv_cache_dtype",
                  "KV page-pool storage mode (one-hot by dtype label)",
                  labels=("engine", "dtype")).labels(
            engine=eng._metrics_id,
            dtype=st.get("kv_cache_dtype", "unknown")).set(1.0)
        reg.gauge("serving_engine_role",
                  "engine serving role (one-hot by role label)",
                  labels=("engine", "role")).labels(
            engine=eng._metrics_id, role=st.get("role", "mixed")).set(1.0)
        # multi-tenant LoRA billing: committed tokens per tenant (the
        # AdapterStore registers its own residency and swap collector)
        tok = reg.counter("lora_tokens_total",
                          "committed tokens per tenant (tenant field, "
                          "adapter id fallback)",
                          labels=("engine", "tenant"))
        for tenant, n in st.get("tenant_tokens", {}).items():
            tok.labels(engine=eng._metrics_id,
                       tenant=tenant)._set_total(float(n))

    obs_metrics.registry().add_collector(collect, owner=engine)


def _buckets(lo: int, hi: int) -> list[int]:
    """Power-of-two sizes in [lo, hi] plus hi itself."""
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


def _bucket(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


class ServingEngine:
    """Continuous-batching generation over a decode-capable model (the
    port's ``LlamaForCausalLM``). ``device`` defaults to "cuda" and must be
    where the model's weights are. ``adapter_store`` (an ``AdapterStore``
    built from this model) enables per-request LoRA adapters."""

    def __init__(self, model, config: ServingConfig | None = None,
                 adapter_store=None, device=DEFAULT_DEVICE):
        self.config = config or ServingConfig()
        self.config.check_ported()
        self.device = resolve_device(device)
        wdev = next(model.parameters()).device
        if wdev != self.device:
            raise ValueError(f"model weights are on {wdev}, engine device "
                             f"is {self.device}")
        self.model = model
        # multi-tenant LoRA: per-row adapter slot ids + the store's pools
        self.adapters = adapter_store
        if adapter_store is not None:
            adapter_store.validate_model(model)
        mcfg = model.config
        self.num_layers = int(mcfg.num_hidden_layers)
        self.num_kv_heads = int(mcfg.num_key_value_heads)
        self.head_dim = int(mcfg.hidden_size) // int(mcfg.num_attention_heads)
        cfg = self.config
        self.page_size = int(cfg.page_size or flag("serving_page_size"))
        self.decode_batch = int(cfg.decode_batch
                                or flag("serving_decode_batch"))
        self.prefill_chunk = int(cfg.prefill_chunk
                                 or flag("serving_prefill_chunk"))
        self.max_seq_len = int(cfg.max_seq_len or flag("serving_max_seq_len")
                               or mcfg.max_position_embeddings)
        self.max_waiting = int(cfg.max_waiting
                               or flag("serving_waiting_queue_limit"))
        self.spec_k = int(cfg.spec_k)
        if self.spec_k < 0:
            raise ValueError(f"serving_spec_k must be >= 0, "
                             f"got {self.spec_k}")
        self.role = "mixed"
        rope_limit = int(mcfg.rope_max_position
                         or mcfg.max_position_embeddings)
        if self.max_seq_len > rope_limit:
            raise ValueError(
                f"serving_max_seq_len={self.max_seq_len} exceeds the hoisted "
                f"RoPE table (rope_max_position={rope_limit}); raise "
                f"LlamaConfig.rope_max_position to serve longer contexts")
        if cfg.page_size == 0:
            # the page size is the paged kernel's K-block granularity, so
            # it resolves through the shared helper like every kernel block
            # knob: explicit FLAGS_serving_page_size > tuned entry > the
            # flag's default (engine.py:294-308 of the JAX package)
            from paddle_tpu_torch.tuning.blocks import resolve_blocks

            heur = self.page_size
            res = resolve_blocks(
                "paged_attention",
                {"num_kv_heads": self.num_kv_heads,
                 "head_dim": self.head_dim,
                 "max_seq_len": self.max_seq_len},
                default=lambda g: (heur,), device=self.device)
            self.page_size = int(res.values["page_size"])
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)

        self.prefix_sharing = bool(flag("serving_prefix_sharing")
                                   if cfg.prefix_sharing is None
                                   else cfg.prefix_sharing)
        # KV storage mode: "model" keeps pages in the weight (or kv_dtype)
        # dtype; "int8"/"fp8" keep codes with fp32 per-slot-per-head absmax
        # scales in side pools, so a page costs 1 byte a value
        kv_mode = (cfg.kv_cache_dtype
                   or flag("serving_kv_cache_dtype")).lower()
        if kv_mode not in ("model", "int8", "fp8"):
            raise ValueError(f"serving_kv_cache_dtype must be one of "
                             f"model/int8/fp8, got {kv_mode!r}")
        self.kv_mode = kv_mode
        self.kv_quantized = kv_mode != "model"
        self.kv_dtype = (_CODE_DTYPES[kv_mode] if self.kv_quantized
                         else cfg.kv_dtype or next(model.parameters()).dtype)
        page_bytes = kv_page_bytes(self.num_layers, self.num_kv_heads,
                                   self.page_size, self.head_dim,
                                   torch.empty((), dtype=self.kv_dtype)
                                   .element_size())
        budget_mb = int(cfg.hbm_budget_mb or flag("serving_hbm_budget_mb"))
        num_pages = (cfg.num_pages or flag("serving_num_pages")
                     or pages_for_budget(budget_mb << 20, page_bytes))
        if num_pages - 1 < self.pages_per_seq:
            raise ValueError(
                f"KV pool of {num_pages} pages cannot hold ONE max-length "
                f"request ({self.pages_per_seq} pages); raise "
                f"serving_num_pages/serving_hbm_budget_mb or lower "
                f"serving_max_seq_len")
        self.num_pages = int(num_pages)
        self.kv_cache_bytes = page_bytes * self.num_pages
        # fp32 scale side pools (k + v), reported apart from the page
        # budget: 4 bytes a slot and head
        scale_page_bytes = (2 * self.num_layers * self.num_kv_heads
                            * self.page_size * 4) if self.kv_quantized else 0
        self.kv_scale_bytes = scale_page_bytes * self.num_pages
        # host cold tier, sized over full page bytes (codes + scales)
        host_mb = int(cfg.host_cache_mb if cfg.host_cache_mb >= 0
                      else flag("serving_host_cache_mb"))
        self.host_pages = ((host_mb << 20) // (page_bytes + scale_page_bytes)
                           if host_mb > 0 else 0)

        self.allocator = PageAllocator(self.num_pages, self.page_size,
                                       host_pages=self.host_pages)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, self.decode_batch, self.max_seq_len,
            max_waiting=self.max_waiting, prefix_sharing=self.prefix_sharing,
            spec_k=self.spec_k, namespace_fn=self._prefix_namespace)
        self._proposer = NGramProposer()
        shape = (self.num_layers, self.num_kv_heads, self.num_pages,
                 self.page_size, self.head_dim)
        # the K/V page pools, written in place by every prefill and decode
        # step (the JAX engine donates a functional cache pytree instead);
        # the model's decode path quantizes on write when "k_scale" is there
        self._cache = {"k": torch.zeros(shape, dtype=self.kv_dtype,
                                        device=self.device),
                       "v": torch.zeros(shape, dtype=self.kv_dtype,
                                        device=self.device)}
        if self.kv_quantized:
            for name in ("k_scale", "v_scale"):
                self._cache[name] = torch.zeros(shape[:4],
                                                dtype=torch.float32,
                                                device=self.device)
        # host store of demoted pages, one slot a page ([slot, L, Hkv, ps(,
        # D)] per pool, so a page is one contiguous row); pinned on CUDA so
        # the blocking tier copies are DMA
        pin = self.device.type == "cuda"
        self._host_store = {
            name: torch.zeros((self.host_pages,) + tuple(a.shape[:2])
                              + tuple(a.shape[3:]), dtype=a.dtype,
                              pin_memory=pin)
            for name, a in self._cache.items()} if self.host_pages else {}
        self._tier_ms = {"demote": 0.0, "promote": 0.0}

        self._chunk_buckets = _buckets(min(8, self.prefill_chunk),
                                       self.prefill_chunk)
        self._ctx_buckets = _buckets(min(32, self._ctx_cap()),
                                     self._ctx_cap())
        self._gens: dict[int, torch.Generator] = {}
        self._submit_seq = 0           # per-engine sample-stream identity
        # packed prefill: same-arrival short prompts share ONE [1, frame]
        # segment-id frame; segment starts stay 32-row aligned
        self.prefill_pack = bool(flag("serving_prefill_pack")
                                 if cfg.prefill_pack is None
                                 else cfg.prefill_pack)
        self.pack_align = 32
        frame = min(int(cfg.pack_frame or flag("serving_pack_frame")
                        or self.prefill_chunk), self._ctx_cap())
        self.pack_frame = max(self.pack_align,
                              (frame // self.pack_align) * self.pack_align)
        self._pack_buckets = _buckets(min(64, self.pack_frame),
                                      self.pack_frame)
        self._pack_frames = 0
        self._pack_reqs = 0
        self._pack_fill_tokens = 0
        self._pack_frame_tokens = 0
        self._prefill_tokens = 0
        self._prefix_admit_tokens = 0
        self._prefix_matched_tokens = 0
        # committed counts real tokens delivered, steps the decode/verify
        # dispatches, slot steps the occupied slots summed over them, and
        # draft_ms the proposer's host time
        self._committed_tokens = 0
        self._decode_steps = 0
        self._slot_steps = 0
        self._draft_ms = 0.0
        # per-tenant committed tokens (tenant field, adapter id fallback):
        # the lora_tokens_total{tenant=} counter's source
        self._tenant_tokens: dict[str, int] = {}
        self._http_lock = threading.Lock()
        self._step_lock = threading.RLock()
        self._http_stop = False
        self._http_error: str | None = None
        self._http_driver = None
        self._http_thread = None
        self._http_server = None
        self._metrics_id = str(next(_engine_seq))
        _register_engine_metrics(self)

    def _ctx_cap(self) -> int:
        return self.pages_per_seq * self.page_size

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # multi-tenant LoRA
    # ------------------------------------------------------------------
    def _prefix_namespace(self, req: Request):
        """The prefix-index namespace of `req` at its admission: None for
        the base model (tokens alone, the JAX engine's key), the adapter
        id and its weight generation otherwise."""
        if not req.adapter or self.adapters is None:
            return None
        return self.adapters.namespace(req.adapter)

    def _adapter_bind(self, reqs, rows: int):
        """The LoRA binding of one model call over `rows` batch rows, row
        i serving ``reqs[i]`` (rows past the list, and base requests,
        carry the trash id: an exact zero delta). A no-op context for an
        engine without a store, and for a call whose rows are all base
        (their deltas would all be exact zeros)."""
        if self.adapters is None or not any(
                r is not None and r.adapter for r in reqs):
            return contextlib.nullcontext()
        ids = np.full(rows, self.adapters.num_slots, np.int32)
        for i, req in enumerate(reqs):
            if req is not None and req.adapter:
                ids[i] = self.adapters.slot_of(req.adapter)
        return self.adapters.bind(self._tensor(ids))

    def _bill_tenant(self, req: Request):
        key = req.tenant or req.adapter
        if key:
            self._tenant_tokens[key] = self._tenant_tokens.get(key, 0) + 1

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: int | None = None, stream_cb=None,
               adapter: str | None = None, tenant: str = "") -> int:
        """Queue one request; returns its rid. With ``adapter`` the request
        decodes through that LoRA adapter, pinned in the store's slot pool
        until `release`; a failed load raises `AdapterLoadError` here and
        queues nothing."""
        if adapter and self.adapters is None:
            raise AdapterLoadError(
                adapter, "engine was constructed without an AdapterStore")
        if adapter:
            # pin BEFORE the scheduler sees the request: the slot must be
            # resident for every dispatch it rides (unpinned on the
            # QueueFull race below and in release())
            self.adapters.acquire(adapter)
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      eos_id=eos_id, stream_cb=stream_cb,
                      adapter=adapter or None, tenant=tenant)
        with self._step_lock:
            try:
                rid = self.scheduler.submit(req)
            except Exception:
                if adapter:
                    self.adapters.release(adapter)
                raise
            # keyed by per-engine submission ORDER: the same request
            # sequence with the same seed reproduces the same streams
            self._gens[rid] = request_generator(self.config.sample_seed,
                                                self._submit_seq)
            self._submit_seq += 1
            if self.spec_k > 0:
                self._proposer.add_request(rid, req.prompt)
        return rid

    def cancel(self, rid: int) -> bool:
        return self.scheduler.cancel(rid)

    def configure_speculation(self, spec_k: int):
        """Change the draft window between steps of one engine (A/B runs
        on the same pools and requests). Turning K on while requests are
        live reseeds the proposer from each committed stream: plain decode
        neither seeds nor feeds it, and the tables are a pure function of
        the stream."""
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        with self._step_lock:
            turning_on = spec_k > 0 and self.spec_k == 0
            self.spec_k = int(spec_k)
            self.scheduler.spec_k = int(spec_k)
            if turning_on:
                for rid, req in self.scheduler._by_rid.items():
                    self._proposer.add_request(rid, req.context)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _run_prefill(self, req: Request):
        with obs_tracing.span("engine.prefill", component="engine",
                              trace_id=(req.trace_id or None), rid=req.rid,
                              tokens=int(req.context.size),
                              matched=int(req.matched_tokens)):
            self._run_prefill_inner(req)

    @torch.inference_mode()
    def _run_prefill_inner(self, req: Request):
        """Chunked prefill of one request's context from its first
        unmatched token: adopted shared pages already hold the matched
        prefix, and each chunk's attention gathers the whole context back
        from the pages, shared ones included. A full match skips prefill;
        the first decode step's rewrite of the last token (copied first if
        its page is shared) keeps the stream exact."""
        ctx = req.context
        total = int(ctx.size)
        row = self._tensor(self.allocator.page_table_row(
            req.rid, self.pages_per_seq))[None]
        cap = self._ctx_cap()
        off = int(req.matched_tokens)
        self._prefix_admit_tokens += total
        self._prefix_matched_tokens += off
        self._prefill_tokens += total - off
        while off < total:
            t = min(self.prefill_chunk, total - off)
            cpad = _bucket(t, self._chunk_buckets)
            ctx_pad = _bucket(min(off + cpad, cap), self._ctx_buckets)
            ids = np.zeros(cpad, np.int64)
            ids[:t] = ctx[off:off + t]
            # pad tokens of the final chunk clamp to the last valid
            # position: they write the one not-yet-valid slot cap-1
            # (rewritten by decode before it is ever readable)
            positions = np.minimum(off + np.arange(cpad), cap - 1)
            with self._adapter_bind([req], 1):
                self.model.llama.decode_forward(
                    self._tensor(ids)[None], self._cache, row,
                    self._tensor(np.array([off + t], np.int32)),
                    self._tensor(positions)[None], ctx_pad=ctx_pad)
            off += t

    def _plan_frames(self, seq, length_of):
        """First-fit split into pack frames: each segment consumes
        ceil(len/32)*32 aligned rows, and a segment that would overflow
        the frame starts the next one."""
        frames, cur, used = [], [], 0
        for x in seq:
            rows = -(-int(length_of(x)) // self.pack_align) * self.pack_align
            if cur and used + rows > self.pack_frame:
                frames.append(cur)
                cur, used = [], 0
            cur.append(x)
            used += rows
        if cur:
            frames.append(cur)
        return frames

    @torch.inference_mode()
    def packed_prefill_cache(self, cache, items, req=None):
        """Device work of ONE packed multi-prompt prefill frame: `items` is
        a list of (tokens int32 [L], page_row int32) pairs. Pads and
        inter-segment gap rows carry the null segment id (the all-null
        table row), so their K/V writes land in the reserved null page and
        the segment mask keeps them out of every real segment. The frame
        holds one adapter, `req`'s (None or a base request: none)."""
        align, ps = self.pack_align, self.page_size
        used = sum(-(-int(t.size) // align) * align for t, _ in items)
        fpad = _bucket(used, self._pack_buckets)
        n_seg = fpad // align       # frame capacity in 32-row segments
        n_pages = -(-fpad // ps)
        ids = np.zeros(fpad, np.int64)
        seg = np.full(fpad, n_seg, np.int32)
        pos = np.zeros(fpad, np.int64)
        tables = np.zeros((n_seg + 1, n_pages), np.int32)
        off = filled = 0
        for j, (toks, row) in enumerate(items):
            t = int(toks.size)
            ids[off:off + t] = toks
            seg[off:off + t] = j
            pos[off:off + t] = np.arange(t)
            n = min(n_pages, int(np.asarray(row).size))
            tables[j, :n] = np.asarray(row)[:n]
            off += -(-t // align) * align
            filled += t
        with self._adapter_bind([req], 1):
            _, cache = self.model.llama.decode_forward(
                self._tensor(ids)[None], cache, self._tensor(tables),
                self._tensor(np.ones(1, np.int32)), self._tensor(pos)[None],
                segment_ids=self._tensor(seg)[None])
        self._pack_frames += 1
        self._pack_reqs += len(items)
        self._pack_fill_tokens += filled
        self._pack_frame_tokens += fpad
        self._prefill_tokens += filled
        return cache

    def _run_prefill_packed(self, reqs):
        self._prefix_admit_tokens += sum(int(r.context.size) for r in reqs)
        items = [(np.asarray(r.context, np.int32),
                  self.allocator.page_table_row(r.rid, self.pages_per_seq))
                 for r in reqs]
        with obs_tracing.span(
                "engine.prefill_packed", component="engine",
                reqs=len(reqs), tokens=sum(int(t.size) for t, _ in items),
                trace_ids=[r.trace_id for r in reqs if r.trace_id]):
            self._cache = self.packed_prefill_cache(self._cache, items,
                                                    req=reqs[0])

    @torch.inference_mode()
    def _decode_once(self, active, finisher):
        """Pack `active` requests into the fixed decode-batch layout, run
        ONE decode step and apply the sampled tokens. `finisher(req)`
        releases a request that just hit its stop condition."""
        b, pmax = self.decode_batch, self.pages_per_seq
        ids = np.zeros(b, np.int64)
        lens = np.zeros(b, np.int32)
        pt = np.zeros((b, pmax), np.int32)
        temp = np.zeros(b, np.float32)
        top_k = np.zeros(b, np.int32)
        top_p = np.ones(b, np.float32)
        gens = [None] * b
        for i, req in enumerate(active):
            ids[i] = (req.generated[-1] if req.generated
                      else int(req.prompt[-1]))
            lens[i] = req.total_len
            pt[i] = self.allocator.page_table_row(req.rid, pmax)
            gens[i] = self._gens[req.rid]
            temp[i] = req.temperature
            top_k[i] = req.top_k
            top_p[i] = req.top_p
        positions = np.maximum(lens - 1, 0).astype(np.int64)
        with self._adapter_bind(active, b):
            logits, _ = self.model.decode_forward(
                self._tensor(ids)[:, None], self._cache, self._tensor(pt),
                self._tensor(lens), self._tensor(positions)[:, None])
        tokens = sample_tokens(logits[:, 0], gens, self._tensor(temp),
                               self._tensor(top_k), self._tensor(top_p))
        toks = tokens.cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(active):
            tok = int(toks[i])
            req.generated.append(tok)
            req.token_times.append(now)
            self._bill_tenant(req)
            if req.stream_cb is not None:
                req.stream_cb(req, tok)
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens):
                finisher(req)
        self._committed_tokens += len(active)
        self._slot_steps += len(active)
        self._decode_steps += 1

    @torch.inference_mode()
    def _verify_once(self, active, finisher):
        """The speculative sibling of `_decode_once`: pack `active` into
        the fixed ``[decode_batch, K + 1]`` verify frame (the last
        committed token, then up to K drafts), run ONE frame through the
        model and commit each row's accepted drafts plus the first sample
        that differs from its draft (1..K+1 tokens a row). A row's draft
        window stops at its remaining budget and the context cap; frame
        slots past it write the null page."""
        b, pmax, k = self.decode_batch, self.pages_per_seq, self.spec_k
        t_frame = k + 1
        cap = self._ctx_cap()
        ids = np.zeros((b, t_frame), np.int64)
        drafts = np.zeros((b, k), np.int64)
        n_spec = np.zeros(b, np.int32)
        lens = np.zeros(b, np.int32)
        pt = np.zeros((b, pmax), np.int32)
        temp = np.zeros(b, np.float32)
        top_k = np.zeros(b, np.int32)
        top_p = np.ones(b, np.float32)
        gens = [None] * b
        # chaos: a forced full rejection, every window zeroed; the frame
        # degrades to plain one-token decode for the step
        chaos_reject = faults.fire_check("serving.spec.verify_mismatch")
        t_draft = time.perf_counter()
        for i, req in enumerate(active):
            ids[i, 0] = (req.generated[-1] if req.generated
                         else int(req.prompt[-1]))
            lens[i] = req.total_len
            pt[i] = self.allocator.page_table_row(req.rid, pmax)
            gens[i] = self._gens[req.rid]
            temp[i] = req.temperature
            top_k[i] = req.top_k
            top_p[i] = req.top_p
            # commits are the window + 1 at most, and the frame writes up
            # to position total_len - 1 + window
            n = min(k, req.max_new_tokens - len(req.generated) - 1,
                    cap - req.total_len)
            if chaos_reject or n <= 0:
                continue
            prop = self._proposer.propose(req.rid, n)
            drafts[i, :n] = prop
            ids[i, 1:1 + n] = prop
            n_spec[i] = n
        self._draft_ms += (time.perf_counter() - t_draft) * 1e3
        offs = np.arange(t_frame)[None]
        positions = np.maximum(lens - 1, 0)[:, None] + offs      # [B, T]
        write_mask = ((offs <= n_spec[:, None]) & (positions < cap)
                      & (lens > 0)[:, None])
        # a masked slot's query is dropped and its K/V go to the null
        # page; its position only has to index the RoPE table and the
        # page table (every unmasked one is below max_seq_len)
        positions = np.minimum(positions, self.max_seq_len - 1)
        with self._adapter_bind(active, b):
            logits, _ = self.model.decode_forward(
                self._tensor(ids), self._cache, self._tensor(pt),
                self._tensor(lens), self._tensor(positions),
                write_mask=self._tensor(write_mask), verify=True)
        tokens, states = sample_frame(logits, gens, self._tensor(temp),
                                      self._tensor(top_k),
                                      self._tensor(top_p))
        toks = tokens.cpu().numpy()
        # a draft is accepted iff it equals the sample at its position
        # (the point-mass rejection rule); the commits are the accepted
        # run and the first sample after it
        match = (toks[:, :k] == drafts) & (np.arange(k)[None]
                                           < n_spec[:, None])
        accepted = np.cumprod(match, axis=1).sum(axis=1)
        now = time.perf_counter()
        for i, req in enumerate(active):
            # the generator stands where plain decode's would after the
            # row's accepted + 1 commits
            gens[i].set_state(states[i][int(accepted[i])])
            for tok in toks[i, :int(accepted[i]) + 1]:
                tok = int(tok)
                req.generated.append(tok)
                req.token_times.append(now)
                self._committed_tokens += 1
                self._bill_tenant(req)
                self._proposer.observe(req.rid, tok)
                if req.stream_cb is not None:
                    req.stream_cb(req, tok)
                if ((req.eos_id is not None and tok == req.eos_id)
                        or len(req.generated) >= req.max_new_tokens):
                    finisher(req)
                    break
        self._slot_steps += len(active)
        self._decode_steps += 1

    @torch.inference_mode()
    def _apply_cow(self):
        """Apply the scheduler's pending copy-on-write page copies on the
        device, in every pool (codes and scales split together): src keeps
        its sharers, dst is the writer's private copy."""
        copies = self.scheduler.pending_cow
        if not copies:
            return
        self.scheduler.pending_cow = []
        src = self._tensor(np.array([c[0] for c in copies], np.int64))
        dst = self._tensor(np.array([c[1] for c in copies], np.int64))
        for a in self._cache.values():
            a = raw_bytes(a)
            a.index_copy_(2, dst, a.index_select(2, src))

    @torch.inference_mode()
    def _apply_tier_ops(self):
        """Drain the allocator's queued tier copies: demotes first (a
        reclaimed cold page's bytes move to the host store BEFORE anything
        overwrites the device page), then promotes (a host page restores
        into its fresh pool page). Both are blocking copies, so a demoted
        page's bytes are on the host before the page can be reused."""
        if not self.allocator.tier_enabled:
            return
        demotes, promotes = self.allocator.take_tier_ops()
        t0 = time.perf_counter()
        for page, slot in demotes:
            for name, store in self._host_store.items():
                raw_bytes(store[slot]).copy_(
                    raw_bytes(self._cache[name][:, :, page]))
        t1 = time.perf_counter()
        for slot, page in promotes:
            for name, store in self._host_store.items():
                raw_bytes(self._cache[name][:, :, page]).copy_(
                    raw_bytes(store[slot]))
        if promotes and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._tier_ms["demote"] += (t1 - t0) * 1e3
        self._tier_ms["promote"] += (time.perf_counter() - t1) * 1e3

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------
    def _packable(self, req: Request) -> bool:
        return (self.prefill_pack and req.matched_tokens == 0
                and int(req.context.size) <= self.pack_frame)

    def _pack_collides(self, head: Request, batch) -> bool:
        """Would the waiting head prefix-match a collected but unflushed
        batch member of its prefix namespace? Its pages register only at
        the flush, so the caller flushes first to keep the adoption."""
        if not self.prefix_sharing:
            return False
        ns = self._prefix_namespace(head)
        batch = [r for r in batch if r.prefix_namespace == ns]
        ps = self.page_size
        ctx = head.context
        if int(ctx.size) < ps:
            return False
        h = np.asarray(ctx[:ps])
        return any(int(r.context.size) >= ps
                   and np.array_equal(np.asarray(r.context[:ps]), h)
                   for r in batch)

    def _admit(self):
        """Drain the waiting queue into prefills: packable admissions
        (fresh full prompts that fit the pack frame) collect into a batch
        flushed as packed frames; everything else (adopted-prefix tails,
        prompts longer than the frame, a head that would prefix-match a
        collected member) flushes the batch first and runs the chunked
        path. A request's pages are registered before the next prefix
        match runs, and queued tier copies land before any prefill
        writes."""
        batch: list[Request] = []

        def flush():
            if not batch:
                return
            self._apply_tier_ops()
            for frame in self._plan_frames(batch, lambda r: r.context.size):
                if len(frame) == 1:
                    # a frame of one gains nothing over the chunked path
                    self._run_prefill(frame[0])
                else:
                    self._run_prefill_packed(frame)
            for r in batch:
                if self.prefix_sharing:
                    self.allocator.register_prefix(
                        r.rid, r.context, namespace=r.prefix_namespace)
                self.scheduler.activate(r)
            batch.clear()

        while True:
            if len(self.scheduler.running) + len(batch) >= self.decode_batch:
                break
            head = (self.scheduler.waiting[0]
                    if self.scheduler.waiting else None)
            if head is None:
                break
            if batch and self._pack_collides(head, batch):
                flush()
                continue
            admitted = self.scheduler.admissions(limit=1)
            if not admitted:
                break
            req = admitted[0]
            if self._packable(req):
                # a packed frame binds one adapter: a change flushes it
                if batch and ((req.adapter or None)
                              != (batch[0].adapter or None)):
                    flush()
                batch.append(req)
                continue
            flush()
            # tier copies queued by this admission's match (promotions) and
            # allocation (demotions) land before the tail prefill writes
            self._apply_tier_ops()
            self._run_prefill(req)
            if self.prefix_sharing:
                # the committed context becomes matchable once written
                self.allocator.register_prefix(
                    req.rid, req.context, namespace=req.prefix_namespace)
            self.scheduler.activate(req)
        flush()

    @property
    def busy(self) -> bool:
        return not self.scheduler.idle

    def step(self) -> bool:
        """One scheduler iteration: admissions (+ their packed/chunked
        prefills and prefix registration), chain growth/eviction, tier and
        copy-on-write copies, then ONE decode step (a verify frame when
        ``spec_k`` > 0). Returns False when nothing is running. With an
        adapter store the step first writes the store's staged hot swaps:
        a swap lands between two steps, never between two layers."""
        with self._step_lock:
            if self.adapters is not None:
                self.adapters.apply_swaps()
            self._admit()
            self.scheduler.grow()
            self._apply_tier_ops()      # grow's reclaims demote first
            self._apply_cow()
            running = list(self.scheduler.running)
            if not running:
                if self.scheduler.waiting:
                    blocked = self.scheduler.waiting[0]
                    raise RuntimeError(
                        f"serving deadlock: request {blocked.rid} "
                        f"({blocked.total_len + 1} tokens) cannot be "
                        f"admitted with {self.allocator.free_pages} free "
                        f"pages ({self.allocator.reclaimable_pages} "
                        f"reclaimable incl. cold) and nothing left to "
                        f"evict")
                return False
            once = (self._verify_once if self.spec_k > 0
                    else self._decode_once)
            if obs_tracing.tracing_active():
                # one span a dispatch, carrying every active request's
                # trace id: the decode-step end of the router -> replica
                # -> engine chain
                with obs_tracing.span(
                        "engine.verify_step" if self.spec_k > 0
                        else "engine.decode_step", component="engine",
                        slots=len(running),
                        trace_ids=[r.trace_id for r in running
                                   if r.trace_id],
                        rids=[r.rid for r in running]):
                    once(running, self.scheduler.finish)
            else:
                once(running, self.scheduler.finish)
            return True

    def run_until_idle(self, max_steps: int = 1_000_000):
        steps = 0
        while self.busy:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"serving loop exceeded {max_steps} steps")
        return steps

    def release(self, rid: int):
        """Drop a finished request's bookkeeping (scheduler entry,
        generator, draft tables, adapter slot pin)."""
        req = self.scheduler._by_rid.get(rid)
        if (req is not None and req.finished and req.adapter
                and self.adapters is not None):
            # unpin exactly once: scheduler.release drops the entry of a
            # finished request, so a second release is a no-op
            self.adapters.release(req.adapter)
        self.scheduler.release(rid)
        self._gens.pop(rid, None)
        self._proposer.drop(rid)

    def generate(self, prompts, max_new_tokens: int = 16, **kw):
        """Synchronous convenience: submit all, run to completion, return
        the generated token lists in submission order."""
        rids = [self.submit(p, max_new_tokens=max_new_tokens, **kw)
                for p in prompts]
        self.run_until_idle()
        outs = [list(self.scheduler.get(r).generated) for r in rids]
        for r in rids:
            self.release(r)
        return outs

    # ------------------------------------------------------------------
    # HTTP front-end (inference/serve.py's /generate)
    # ------------------------------------------------------------------
    def _http_generate(self, payload: dict, deadline: float):
        """Generator of stream events for one /generate request: the
        driver thread turns the scheduler, per-token callbacks land in a
        queue, and this generator drains it until completion or deadline
        (a deadline cancels the request so its pages free at once)."""
        import queue as queue_mod

        q = queue_mod.Queue()
        adapter_err = None
        with self._http_lock:
            try:
                rid = self.submit(
                    np.asarray(payload["prompt_ids"], np.int32),
                    max_new_tokens=int(payload.get("max_new_tokens", 16)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=int(payload.get("top_k", 0)),
                    top_p=float(payload.get("top_p", 1.0)),
                    eos_id=payload.get("eos_id"),
                    stream_cb=lambda req, tok: q.put(tok),
                    adapter=payload.get("adapter"),
                    tenant=str(payload.get("tenant") or ""))
            except QueueFull:
                rid = None
            except AdapterLoadError as e:
                # a failed adapter load is ONE typed terminal event for
                # this request; the engine and other streams go on
                rid = None
                adapter_err = e
            else:
                req = self.scheduler.get(rid)
                req.trace_id = str(payload.get("trace") or "")
        if rid is None:
            if adapter_err is not None:
                yield {"error": "adapter_load_failed",
                       "adapter": adapter_err.adapter_id,
                       "message": str(adapter_err)}
            else:
                yield {"error": "queue_full",
                       "retry_after": float(flag("router_retry_after_s"))}
            return
        n = 0
        try:
            while True:
                if time.monotonic() > deadline:
                    yield {"rid": rid, "error": "timeout", "tokens": n}
                    return
                if self._http_error is not None:
                    yield {"rid": rid, "error": self._http_error,
                           "tokens": n}
                    return
                try:
                    tok = q.get(timeout=0.05)
                except queue_mod.Empty:
                    if req.finished and q.empty():
                        break
                    continue
                n += 1
                yield {"rid": rid, "token": int(tok)}
                if req.finished and q.empty():
                    break
            yield {"rid": rid, "done": True, "tokens": n,
                   "state": req.state.value}
        finally:
            # normal completion, timeout, driver error and client
            # disconnect alike: an abandoned request frees its slot now
            with self._http_lock:
                if not req.finished:
                    self.cancel(rid)
                self.release(rid)

    def _drive_http(self):
        while not self._http_stop:
            try:
                with self._http_lock:
                    busy = self.busy
                    if busy:
                        self.step()
            except Exception as e:  # surface through every open stream
                self._http_error = (f"serving driver died: "
                                    f"{type(e).__name__}: {e}")
                return
            if not busy:
                time.sleep(0.002)

    def _http_admit(self, payload: dict) -> dict | None:
        depth = self.scheduler.queue_depth
        if self.max_waiting and depth >= self.max_waiting:
            return {"status": 503,
                    "retry_after": float(flag("router_retry_after_s")),
                    "message": f"serving waiting queue full ({depth} "
                               f"queued >= {self.max_waiting})"}
        return None

    def _http_health(self) -> dict:
        h = {"ok": self._http_error is None, **self.stats()}
        if self._http_error is not None:
            h["error"] = self._http_error
        return h

    def serve_http(self, port: int, block: bool = True):
        """Serve POST /generate (streaming ndjson token events; payload
        keys ``adapter`` and ``tenant`` select a LoRA adapter), GET
        /healthz, /stats and /metrics (the registry's Prometheus text).
        The scheduler runs on a driver thread; with
        ``block=False`` the listener runs on a thread too and the server
        is returned (``shutdown_http`` stops both)."""
        from paddle_tpu_torch.inference.serve import build_http_server

        srv = build_http_server(
            port, generate_fn=self._http_generate,
            queue_limit=int(flag("serving_queue_limit")),
            timeout_s=float(flag("serving_request_timeout_s")),
            max_body_bytes=int(flag("serving_max_body_mb")) << 20,
            admit_fn=self._http_admit, health_fn=self._http_health,
            stats_fn=self.stats,
            metrics_fn=lambda: obs_metrics.registry().prometheus_text())
        self._http_stop = False
        self._http_error = None
        self._http_server = srv
        self._http_driver = threading.Thread(
            target=self._drive_http, name="paddle_tpu_torch.serving.driver",
            daemon=True)
        self._http_driver.start()
        if block:
            try:
                srv.serve_forever()
            finally:
                self.shutdown_http()
            return srv
        self._http_thread = threading.Thread(
            target=srv.serve_forever, name="paddle_tpu_torch.serving.http",
            daemon=True)
        self._http_thread.start()
        return srv

    def shutdown_http(self):
        self._http_stop = True
        if self._http_driver is not None:
            self._http_driver.join(timeout=5.0)
            self._http_driver = None
        srv = self._http_server
        if srv is not None:
            if self._http_thread is not None:
                srv.shutdown()
                self._http_thread.join(timeout=5.0)
                self._http_thread = None
            srv.server_close()
            self._http_server = None

    # ------------------------------------------------------------------
    # instrumentation
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Readiness snapshot served at /stats (a subset of the JAX
        engine's fields). Lock-free: every read is a GIL-atomic int or a
        list snapshot."""
        running = len(self.scheduler.running)
        return {
            "queue_depth": self.scheduler.queue_depth,
            "oldest_wait_age_s": round(self.scheduler.oldest_wait_age(), 4),
            "in_flight": running + self.scheduler.queue_depth,
            "slot_fill": round(running / max(self.decode_batch, 1), 4),
            "free_pages": self.allocator.free_pages,
            "waiting_limit": self.max_waiting,
            "spec_k": self.spec_k,
            "accepted_tokens_per_step": self.accepted_tokens_per_step,
            "draft_ms_total": round(self._draft_ms, 3),
            "prefix_hit_rate": self.prefix_hit_rate,
            "cow_copies": self.allocator.cow_copies,
            "kv_cache_dtype": (self.kv_mode if self.kv_quantized
                               else str(self.kv_dtype).replace("torch.", "")),
            "kv_scale_bytes": self.kv_scale_bytes,
            "kv_cold_pages": self.allocator.cold_pages,
            "kv_host_pages": self.host_pages,
            "kv_host_used": self.allocator.host_used,
            "kv_demotions": self.allocator.demotions,
            "kv_promotions": self.allocator.promotions,
            "kv_cold_hits": self.allocator.cold_hits,
            "kv_dropped_cold": self.allocator.dropped_cold,
            "kv_promote_failures": self.allocator.promote_failures,
            "kv_demote_ms_total": round(self._tier_ms["demote"], 3),
            "kv_promote_ms_total": round(self._tier_ms["promote"], 3),
            "prefix_matches": self.allocator.prefix_matches,
            "prefix_tokens_matched": self.allocator.prefix_tokens_matched,
            "role": self.role,
            "device": str(self.device),
            "prefill_batch_fill": self.prefill_batch_fill,
            "prefill_packed_frames": self._pack_frames,
            "prefill_packed_requests": self._pack_reqs,
            "prefill_tokens": self._prefill_tokens,
            "committed_tokens": self._committed_tokens,
            "decode_steps": self._decode_steps,
            # multi-tenant LoRA: adapter residency + per-tenant billing
            "lora": (self.adapters.residency()
                     if self.adapters is not None else {}),
            "tenant_tokens": dict(self._tenant_tokens),
        }

    @property
    def accepted_tokens_per_step(self) -> float:
        """Committed tokens per occupied slot per dispatch: 1.0 for plain
        decode, up to K + 1 when every draft is accepted."""
        return round(self._committed_tokens / self._slot_steps, 4) \
            if self._slot_steps else 0.0

    def reset_stats(self):
        """Zero the engine's token, step, draft and prefill counters and
        the allocator's sharing counters (between A/B arms on one
        engine)."""
        self._committed_tokens = 0
        self._decode_steps = 0
        self._slot_steps = 0
        self._draft_ms = 0.0
        self._prefill_tokens = 0
        self._prefix_admit_tokens = 0
        self._prefix_matched_tokens = 0
        self._pack_frames = 0
        self._pack_reqs = 0
        self._pack_fill_tokens = 0
        self._pack_frame_tokens = 0
        self.allocator.cow_copies = 0
        self.allocator.prefix_matches = 0
        self.allocator.prefix_tokens_matched = 0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admission context tokens covered by adopted shared
        prefix pages (prefill skipped for exactly these tokens)."""
        return round(self._prefix_matched_tokens
                     / self._prefix_admit_tokens, 4) \
            if self._prefix_admit_tokens else 0.0

    @property
    def prefill_batch_fill(self) -> float:
        """Mean packed-frame fill: real prompt tokens over padded frame
        rows across packed prefill frames (0.0 before the first)."""
        return round(self._pack_fill_tokens / self._pack_frame_tokens, 4) \
            if self._pack_frame_tokens else 0.0
