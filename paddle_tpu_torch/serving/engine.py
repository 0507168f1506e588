"""The serving engine: paged KV cache + continuous-batching decode
(``paddle_tpu.serving.engine`` counterpart, ``mixed`` role).

Same scheduling as the JAX engine, run eagerly by PyTorch:

  * every decode step runs the fixed ``[decode_batch]`` slot layout —
    token ids, context lens, page tables and sampling knobs are tensors,
    inactive slots are len-0 rows the paged kernel writes zeros for;
  * admissions arriving together are PACKED into one ``[1, frame]``
    segment-id prefill frame (first-fit over 32-aligned rows, one page
    chain per segment); prompts longer than the frame and solo arrivals
    run chunked prefill, one request at a time in chunks of
    ``prefill_chunk`` tokens, with chunk and context lengths rounded up to
    power-of-two buckets as in the JAX engine;
  * a prefill writes every prompt token's K/V; the first decode step
    re-feeds the last prompt token at its own position (the rewrite that
    mints the first generated token), so prefill never samples.

On CUDA both attention paths run the port's hand-written Hopper kernels
(``ops/cuda``); the K/V pools are updated in place.

Not ported yet (raise NotImplementedError): speculative decoding
(``spec_k > 0``), prefix sharing, quantized KV pools, the host cache tier,
the prefill/decode roles and LoRA adapters.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.serving.kv_cache import (PageAllocator, kv_page_bytes,
                                               pages_for_budget)
from paddle_tpu_torch.serving.sampling import request_generator, sample_tokens
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                QueueFull, Request)

__all__ = ["ServingConfig", "ServingEngine"]


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
    kv_cache_dtype: str = "model"   # only "model" is ported
    host_cache_mb: int = 0          # only 0 is ported
    sample_seed: int = 0
    max_waiting: int = 0            # 0 -> FLAGS_serving_waiting_queue_limit
    spec_k: int = 0                 # only 0 is ported
    prefix_sharing: bool = False    # only False is ported
    role: str = "mixed"             # only "mixed" is ported
    prefill_pack: bool | None = None    # None -> FLAGS_serving_prefill_pack
    pack_frame: int = 0             # 0 -> FLAGS_serving_pack_frame,
                                    #      then prefill_chunk

    def check_ported(self):
        unported = []
        if self.spec_k:
            unported.append(f"spec_k={self.spec_k} (speculative decoding)")
        if self.prefix_sharing:
            unported.append("prefix_sharing=True")
        if (self.kv_cache_dtype or "model").lower() != "model":
            unported.append(f"kv_cache_dtype={self.kv_cache_dtype!r}")
        if self.host_cache_mb > 0:
            unported.append(f"host_cache_mb={self.host_cache_mb}")
        if (self.role or "mixed").lower() != "mixed":
            unported.append(f"role={self.role!r}")
        if unported:
            raise NotImplementedError(
                "not ported to paddle_tpu_torch yet: " + ", ".join(unported))


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
    where the model's weights are."""

    def __init__(self, model, config: ServingConfig | None = None,
                 adapter_store=None, device=DEFAULT_DEVICE):
        if adapter_store is not None:
            raise NotImplementedError(
                "LoRA adapter serving is not ported to paddle_tpu_torch yet")
        self.config = config or ServingConfig()
        self.config.check_ported()
        self.device = resolve_device(device)
        wdev = next(model.parameters()).device
        if wdev != self.device:
            raise ValueError(f"model weights are on {wdev}, engine device "
                             f"is {self.device}")
        self.model = model
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
        self.spec_k = 0
        self.role = "mixed"
        rope_limit = int(mcfg.rope_max_position
                         or mcfg.max_position_embeddings)
        if self.max_seq_len > rope_limit:
            raise ValueError(
                f"serving_max_seq_len={self.max_seq_len} exceeds the hoisted "
                f"RoPE table (rope_max_position={rope_limit}); raise "
                f"LlamaConfig.rope_max_position to serve longer contexts")
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)

        self.kv_dtype = cfg.kv_dtype or next(model.parameters()).dtype
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

        self.allocator = PageAllocator(self.num_pages, self.page_size)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, self.decode_batch, self.max_seq_len,
            max_waiting=self.max_waiting)
        shape = (self.num_layers, self.num_kv_heads, self.num_pages,
                 self.page_size, self.head_dim)
        # the K/V page pools, written in place by every prefill and decode
        # step (the JAX engine donates a functional cache pytree instead)
        self._cache = {"k": torch.zeros(shape, dtype=self.kv_dtype,
                                        device=self.device),
                       "v": torch.zeros(shape, dtype=self.kv_dtype,
                                        device=self.device)}

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
        self._committed_tokens = 0
        self._decode_steps = 0
        self._http_lock = threading.Lock()
        self._step_lock = threading.RLock()
        self._http_stop = False
        self._http_error: str | None = None
        self._http_driver = None
        self._http_thread = None
        self._http_server = None

    def _ctx_cap(self) -> int:
        return self.pages_per_seq * self.page_size

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: int | None = None, stream_cb=None) -> int:
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      eos_id=eos_id, stream_cb=stream_cb)
        with self._step_lock:
            rid = self.scheduler.submit(req)
            # keyed by per-engine submission ORDER: the same request
            # sequence with the same seed reproduces the same streams
            self._gens[rid] = request_generator(self.config.sample_seed,
                                                self._submit_seq)
            self._submit_seq += 1
        return rid

    def cancel(self, rid: int) -> bool:
        return self.scheduler.cancel(rid)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _run_prefill(self, req: Request):
        """Chunked prefill of one request's whole context."""
        ctx = req.context
        total = int(ctx.size)
        row = self._tensor(self.allocator.page_table_row(
            req.rid, self.pages_per_seq))[None]
        cap = self._ctx_cap()
        off = 0
        self._prefill_tokens += total
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
    def packed_prefill_cache(self, cache, items):
        """Device work of ONE packed multi-prompt prefill frame: `items` is
        a list of (tokens int32 [L], page_row int32) pairs. Pads and
        inter-segment gap rows carry the null segment id (the all-null
        table row), so their K/V writes land in the reserved null page and
        the segment mask keeps them out of every real segment."""
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
        items = [(np.asarray(r.context, np.int32),
                  self.allocator.page_table_row(r.rid, self.pages_per_seq))
                 for r in reqs]
        self._cache = self.packed_prefill_cache(self._cache, items)

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
            if req.stream_cb is not None:
                req.stream_cb(req, tok)
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens):
                finisher(req)
        self._committed_tokens += len(active)
        self._decode_steps += 1

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------
    def _packable(self, req: Request) -> bool:
        return self.prefill_pack and int(req.context.size) <= self.pack_frame

    def _admit(self):
        """Drain the waiting queue into prefills: packable admissions
        collect into a batch flushed as packed frames; everything else
        flushes the batch first and runs the chunked path."""
        batch: list[Request] = []

        def flush():
            if not batch:
                return
            for frame in self._plan_frames(batch, lambda r: r.context.size):
                if len(frame) == 1:
                    # a frame of one gains nothing over the chunked path
                    self._run_prefill(frame[0])
                else:
                    self._run_prefill_packed(frame)
            for r in batch:
                self.scheduler.activate(r)
            batch.clear()

        while True:
            if len(self.scheduler.running) + len(batch) >= self.decode_batch:
                break
            if not self.scheduler.waiting:
                break
            admitted = self.scheduler.admissions(limit=1)
            if not admitted:
                break
            req = admitted[0]
            if self._packable(req):
                batch.append(req)
                continue
            flush()
            self._run_prefill(req)
            self.scheduler.activate(req)
        flush()

    @property
    def busy(self) -> bool:
        return not self.scheduler.idle

    def step(self) -> bool:
        """One scheduler iteration: admissions (+ their packed/chunked
        prefills), chain growth/eviction, then ONE decode step. Returns
        False when nothing is running."""
        with self._step_lock:
            self._admit()
            self.scheduler.grow()
            running = list(self.scheduler.running)
            if not running:
                if self.scheduler.waiting:
                    blocked = self.scheduler.waiting[0]
                    raise RuntimeError(
                        f"serving deadlock: request {blocked.rid} "
                        f"({blocked.total_len + 1} tokens) cannot be "
                        f"admitted with {self.allocator.free_pages} free "
                        f"pages and nothing left to evict")
                return False
            self._decode_once(running, self.scheduler.finish)
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
        """Drop a finished request's bookkeeping (scheduler entry and
        generator)."""
        self.scheduler.release(rid)
        self._gens.pop(rid, None)

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
        with self._http_lock:
            try:
                rid = self.submit(
                    np.asarray(payload["prompt_ids"], np.int32),
                    max_new_tokens=int(payload.get("max_new_tokens", 16)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=int(payload.get("top_k", 0)),
                    top_p=float(payload.get("top_p", 1.0)),
                    eos_id=payload.get("eos_id"),
                    stream_cb=lambda req, tok: q.put(tok))
            except QueueFull:
                rid = None
            else:
                req = self.scheduler.get(rid)
        if rid is None:
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
        """Serve POST /generate (streaming ndjson token events), GET
        /healthz and /stats. The scheduler runs on a driver thread; with
        ``block=False`` the listener runs on a thread too and the server
        is returned (``shutdown_http`` stops both)."""
        from paddle_tpu_torch.inference.serve import build_http_server

        srv = build_http_server(
            port, generate_fn=self._http_generate,
            queue_limit=int(flag("serving_queue_limit")),
            timeout_s=float(flag("serving_request_timeout_s")),
            max_body_bytes=int(flag("serving_max_body_mb")) << 20,
            admit_fn=self._http_admit, health_fn=self._http_health,
            stats_fn=self.stats)
        self._http_stop = False
        self._http_error = None
        self._http_server = srv
        self._http_driver = threading.Thread(
            target=self._drive_http, name="paddle_tpu.serving.torch_driver",
            daemon=True)
        self._http_driver.start()
        if block:
            try:
                srv.serve_forever()
            finally:
                self.shutdown_http()
            return srv
        self._http_thread = threading.Thread(
            target=srv.serve_forever, name="paddle_tpu.serving.torch_http",
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
            "kv_cache_dtype": str(self.kv_dtype).replace("torch.", ""),
            "role": self.role,
            "device": str(self.device),
            "prefill_batch_fill": self.prefill_batch_fill,
            "prefill_packed_frames": self._pack_frames,
            "prefill_packed_requests": self._pack_reqs,
            "prefill_tokens": self._prefill_tokens,
            "committed_tokens": self._committed_tokens,
            "decode_steps": self._decode_steps,
        }

    @property
    def prefill_batch_fill(self) -> float:
        """Mean packed-frame fill: real prompt tokens over padded frame
        rows across packed prefill frames (0.0 before the first)."""
        return round(self._pack_fill_tokens / self._pack_frame_tokens, 4) \
            if self._pack_frame_tokens else 0.0
