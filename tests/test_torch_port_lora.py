"""The port's multi-tenant LoRA on the CPU, held against the JAX package on
the same weights and the same adapter files.

* ``serve_delta``'s plain path against JAX ``serve_delta`` (its CPU route,
  the xla backend at block_rows 1) on unsorted slot ids with trash rows,
  fp32 within 1e-5; trash rows exactly zero;
* adapter artifacts written by JAX read by the port (fp32 and bf16) and
  the port's read by JAX, member bytes equal; target paths and GQA shapes
  (``k_proj``/``v_proj`` are not square, so a swapped [out, in] fails);
* greedy streams and page tables of a mixed base + 2-adapter batch equal
  to the JAX engine's, prefix sharing off, fp32 GQA, spec_k 0 and 2, and
  mixed equal to each request served alone in the port;
* the reference's cross-adapter prefix adoption (the JAX engine with
  sharing on hands an adapter request the base request's K/V pages, and
  back) shown, and the port's namespaced index keeping both streams equal
  to the requests served alone;
* the store: LRU, pinned exhaustion, unknown id, ``serving.lora.swap_fail``,
  rank padding (rank 4 and 12 padded to 8 and 16: the same streams), the
  hot swap and its new prefix namespace, and a swap thread racing a decode
  loop (every step sees one version of the weights);
* the train plane: the attached forward and 3 ``TrainStep`` steps against
  3 ``CompiledTrainStep`` steps (base frozen, no grad clip), and
  ``lora_from_paddle_tpu``;
* the metrics registry's Prometheus text equal byte for byte across the
  packages for the same operations; the engine's /metrics, the typed
  ``adapter_load_failed`` event over HTTP; imports without JAX.
"""
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.lora import AdapterStore as JaxAdapterStore
from paddle_tpu.lora import LoRAConfig as JaxLoRAConfig
from paddle_tpu.lora import attach as jax_attach
from paddle_tpu.lora import detach as jax_detach
from paddle_tpu.lora import export_adapter as jax_export_adapter
from paddle_tpu.lora import find_targets as jax_find_targets
from paddle_tpu.lora import load_adapter as jax_load_adapter
from paddle_tpu.lora.seam import ServeBinding as JaxServeBinding
from paddle_tpu.lora.seam import serve_delta as jax_serve_delta
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serving.engine import ServingConfig as JaxServingConfig
from paddle_tpu.serving.engine import ServingEngine as JaxServingEngine
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.lora import (AdapterLoadError, AdapterStore,
                                   LoRAConfig, attach, detach,
                                   export_adapter, find_targets,
                                   load_adapter, seam)
from paddle_tpu_torch.models import from_paddle_tpu_params
from paddle_tpu_torch.models.convert import lora_from_paddle_tpu
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.observability import events, tracing
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

RANK = 4
MODEL = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             use_parallel_cross_entropy=False)
ENGINE = dict(page_size=4, num_pages=64, decode_batch=4, prefill_chunk=16,
              max_seq_len=64, pack_frame=64)
# base, a, b, a, base, b: the first four fill the batch (5 and 12 would
# share a packed frame but change adapter, so each flushes alone), the
# last two arrive as slots free up
PROMPT_LENS = [5, 12, 20, 9, 33, 7]
ADAPTERS = [None, "ten-a", "ten-b", "ten-a", None, "ten-b"]


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The port's own fault registry, tracing and journal start and end
    clean, and no paddle_tpu_torch.serving thread outlives a test."""
    before = set(threading.enumerate())
    faults.reset()
    yield
    faults.reset()
    tracing.stop_tracing()
    tracing.reset()
    events.journal().clear()
    left = [t for t in threading.enumerate()
            if t.name.startswith("paddle_tpu_torch.serving")
            and t not in before and t.is_alive()]
    assert not left, [t.name for t in left]


def _jax_adapter(jm, path, aid, seed, rank=RANK, scale=0.3, dtype=None):
    """A distinct non-trivial adapter without training: attach, randomize
    B, export, detach (detach restores the model bit for bit)."""
    h = jax_attach(jm, JaxLoRAConfig(rank=rank, alpha=2.0 * rank, seed=seed,
                                     dtype=dtype))
    r = np.random.default_rng(seed)
    for _, _, _, B in h.entries:
        B.set_value((r.standard_normal(tuple(B.shape)) * scale)
                    .astype(np.asarray(B._value).dtype))
    jax_export_adapter(path, h, adapter_id=aid)
    jax_detach(h)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(**MODEL))
    jm.eval()
    for aid, seed in (("ten-a", 7), ("ten-b", 13)):
        _jax_adapter(jm, str(d / f"{aid}.pdmodel"), aid, seed)
    tm = from_paddle_tpu_params(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        LlamaConfig(**MODEL), device="cpu")
    tm.eval()
    return jm, tm, d


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, n).astype(np.int32) for n in lens]


def _port_store(tm, d, **kw):
    store = AdapterStore(tm, rank=RANK, slots=4, **kw)
    for aid in ("ten-a", "ten-b"):
        store.register(aid, str(d / f"{aid}.pdmodel"))
    return store


def _serve(eng, prompts, adapters, n=6):
    rids = [eng.submit(p, max_new_tokens=n, adapter=a)
            for p, a in zip(prompts, adapters)]
    eng.run_until_idle()
    out = [list(eng.scheduler.get(r).generated) for r in rids]
    for r in rids:
        eng.release(r)
    return out


def _alone(eng, prompts, adapters, n=6):
    return [_serve(eng, [p], [a], n)[0] for p, a in zip(prompts, adapters)]


# ---------------------------------------------------------------------------
# the seam
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frame", [1, 3])
def test_serve_delta_plain_matches_jax(frame):
    rng = np.random.default_rng(0)
    g, d, r, dout, b = 4, 16, RANK, 24, 8
    a_pool = rng.standard_normal((g, d, r)).astype(np.float32)
    b_pool = rng.standard_normal((g, r, dout)).astype(np.float32)
    v = rng.standard_normal((b, frame, d)).astype(np.float32)
    slots = np.array([0, 3, 1, g, 2, 0, g, 3], np.int32)     # unsorted
    want = np.asarray(jax_serve_delta(
        jnp.asarray(v), jnp.asarray(a_pool), jnp.asarray(b_pool),
        JaxServeBinding({}, jnp.asarray(slots), g)))
    got = seam.serve_delta(torch.from_numpy(v), torch.from_numpy(a_pool),
                           torch.from_numpy(b_pool),
                           seam.ServeBinding({}, torch.from_numpy(slots), g))
    assert got.dtype == torch.float32 and got.shape == (b, frame, dout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not got[3].any() and not got[6].any()      # trash: exact zero
    assert got[0].abs().sum() > 0


def test_find_targets_paths_and_gqa_dims(pair):
    jm, tm, d = pair
    jpaths = [p for p, _ in jax_find_targets(jm, ("q_proj", "k_proj",
                                                  "v_proj", "o_proj"))]
    assert [p for p, _ in find_targets(tm, ("q_proj", "k_proj", "v_proj",
                                            "o_proj"))] == jpaths
    store = AdapterStore(tm, rank=RANK, slots=2)
    # GQA: k_proj maps 32 -> 16, so (d_in, d_out) must be (in, out); the
    # pools' rank is RANK padded to 8
    assert store._dims[1] == (32, 16) and store.pool_rank == 8
    assert [tuple(a.shape) for a in store._a[:2]] == [(2, 32, 8), (2, 32, 8)]
    assert tuple(store._b[1].shape) == (2, 8, 16)
    blob = load_adapter(str(d / "ten-a.pdmodel"))
    k = jpaths[1]
    a, b = blob["weights"][k]
    swapped = dict(blob["weights"])
    swapped[k] = (np.ascontiguousarray(b.T), np.ascontiguousarray(a.T))
    with pytest.raises(ValueError, match="do not match"):
        store.register("swapped", {"adapter": blob["adapter"],
                                   "weights": swapped})


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: (json.loads(z.read(n)) if n.endswith(".json")
                    else z.read(n)) for n in z.namelist()}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_artifacts_cross_packages(pair, tmp_path, dtype):
    jm, tm, _ = pair
    jpath, tpath = str(tmp_path / "j.pdmodel"), str(tmp_path / "t.pdmodel")
    _jax_adapter(jm, jpath, "acme", seed=3, dtype=dtype)
    want = jax_load_adapter(jpath)
    got = load_adapter(jpath)
    assert got["adapter"] == want["adapter"]
    for name, (wa, wb) in want["weights"].items():
        for w, t in zip((wa, wb), got["weights"][name]):
            if dtype == "bfloat16":
                assert t.dtype == torch.bfloat16
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
            else:
                assert np.array_equal(np.asarray(t), np.asarray(w))
    # the port writes the same members from the same factors, and JAX
    # reads them back
    h = attach(tm, LoRAConfig(rank=RANK, alpha=2.0 * RANK,
                              dtype=dtype and torch.bfloat16))
    try:
        lora_from_paddle_tpu(got, tm)
        export_adapter(tpath, h, adapter_id="acme")
    finally:
        detach(h)
    mj, mt = _members(jpath), _members(tpath)
    assert mt == mj
    back = jax_load_adapter(tpath)
    for name, (wa, wb) in want["weights"].items():
        ba, bb = back["weights"][name]
        assert np.array_equal(np.asarray(ba), np.asarray(wa))
        assert np.array_equal(np.asarray(bb), np.asarray(wb))


# ---------------------------------------------------------------------------
# serving against the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec_k", [0, 2])
def test_mixed_batch_streams_and_page_tables_equal_jax(pair, spec_k):
    jm, tm, d = pair
    jstore = JaxAdapterStore(jm, rank=RANK, slots=4)
    for aid in ("ten-a", "ten-b"):
        jstore.register(aid, str(d / f"{aid}.pdmodel"))
    jeng = JaxServingEngine(jm, JaxServingConfig(
        prefix_sharing=False, spec_k=spec_k, **ENGINE),
        adapter_store=jstore)
    teng = ServingEngine(tm, ServingConfig(prefix_sharing=False,
                                           spec_k=spec_k, **ENGINE),
                         adapter_store=_port_store(tm, d), device="cpu")
    prompts = _prompts()
    jr = [jeng.submit(p, max_new_tokens=8, adapter=a, tenant=a or "")
          for p, a in zip(prompts, ADAPTERS)]
    tr = [teng.submit(p, max_new_tokens=8, adapter=a, tenant=a or "")
          for p, a in zip(prompts, ADAPTERS)]
    jeng.step()
    teng.step()
    assert len(jeng.scheduler.running) == len(teng.scheduler.running) == 4
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(
            jeng.allocator.page_table_row(a, jeng.pages_per_seq),
            teng.allocator.page_table_row(b, teng.pages_per_seq))
    jeng.run_until_idle()
    teng.run_until_idle()
    want = [list(jeng.scheduler.get(r).generated) for r in jr]
    got = [list(teng.scheduler.get(r).generated) for r in tr]
    assert got == want
    # the adapters are live: an adapter changes its request's stream
    assert got[1] != _serve(teng, [prompts[1]], [None], 8)[0]
    st = teng.stats()
    assert st["tenant_tokens"] == jeng.stats()["tenant_tokens"]
    assert st["lora"]["resident"] == ["ten-a", "ten-b"]
    for r in tr:
        teng.release(r)
    assert all(v == 0 for v in teng.stats()["lora"]["refs"].values())
    teng.allocator.check_consistency()


def test_mixed_batch_equals_sequential_in_port(pair):
    _, tm, d = pair
    eng = ServingEngine(tm, ServingConfig(**ENGINE),
                        adapter_store=_port_store(tm, d), device="cpu")
    prompts = _prompts(1)
    mixed = _serve(eng, prompts, ADAPTERS)
    assert mixed == _alone(eng, prompts, ADAPTERS)


def test_cross_adapter_prefix_adoption_jax_vs_port_namespace(pair, tmp_path):
    """One 35-token prompt, served as a base request and, one engine step
    later, as an adapter request (rank 8, B scaled by 0.5), prefix sharing
    on at page 16. The JAX index (tokens alone) hands the second request
    the first one's two full K/V pages, in both orders, and its stream
    differs from the request served alone. The port's index keeps the
    adapter's pages in their own namespace: no adoption, streams equal to
    the requests served alone, which equal JAX's alone."""
    jm, tm, _ = pair
    path = str(tmp_path / "x.pdmodel")
    _jax_adapter(jm, path, "x", seed=7, rank=8, scale=0.5)
    prompt = np.random.RandomState(3).randint(1, 128, 35).astype(np.int32)
    kw = dict(page_size=16, num_pages=64, decode_batch=4, prefill_chunk=16,
              max_seq_len=64)

    def run(make, order, sharing):
        eng = make(sharing)
        first, second = order
        rids = {first: eng.submit(prompt, max_new_tokens=6, adapter=first)}
        eng.step()
        rids[second] = eng.submit(prompt, max_new_tokens=6, adapter=second)
        eng.run_until_idle()
        return ({k: list(eng.scheduler.get(r).generated)
                 for k, r in rids.items()},
                eng.allocator.prefix_tokens_matched)

    def jax_engine(sharing):
        store = JaxAdapterStore(jm, rank=8, slots=2)
        store.register("x", path)
        return JaxServingEngine(jm, JaxServingConfig(
            prefix_sharing=sharing, **kw), adapter_store=store)

    def port_engine(sharing):
        store = AdapterStore(tm, rank=8, slots=2)
        store.register("x", path)
        return ServingEngine(tm, ServingConfig(prefix_sharing=sharing, **kw),
                             adapter_store=store, device="cpu")

    alone, matched = run(jax_engine, (None, "x"), False)
    assert matched == 0
    shared, matched = run(jax_engine, (None, "x"), True)
    assert matched == 32 and shared["x"] != alone["x"]
    shared, matched = run(jax_engine, ("x", None), True)
    assert matched == 32 and shared[None] != alone[None]
    for order in ((None, "x"), ("x", None)):
        got, matched = run(port_engine, order, True)
        assert matched == 0 and got == alone, order
    assert run(port_engine, (None, "x"), False)[0] == alone


def test_same_adapter_still_shares_and_hot_swap_starts_a_namespace(
        pair, tmp_path):
    """A second request of one adapter adopts the first one's full prefix
    pages while it runs; after a hot swap of that adapter, a new request
    adopts none of the pages written under the old weights, and its
    stream equals the new weights' on a fresh engine."""
    jm, tm, d = pair
    p2 = str(tmp_path / "a2.pdmodel")
    _jax_adapter(jm, p2, "ten-a", seed=99)
    store = _port_store(tm, d)
    kw = {**ENGINE, "page_size": 8}
    eng = ServingEngine(tm, ServingConfig(**kw), adapter_store=store,
                        device="cpu")
    prompt = _prompts(5, [27])[0]
    r1 = eng.submit(prompt, max_new_tokens=20, adapter="ten-a")
    eng.step()
    r2 = eng.submit(prompt, max_new_tokens=6, adapter="ten-a")
    eng.step()
    assert eng.allocator.prefix_tokens_matched == 24
    store.register("ten-a", p2)                 # hot swap
    r3 = eng.submit(prompt, max_new_tokens=6, adapter="ten-a")
    eng.step()
    assert eng.allocator.prefix_tokens_matched == 24
    eng.run_until_idle()
    swapped = list(eng.scheduler.get(r3).generated)
    for r in (r1, r2, r3):
        eng.release(r)
    fresh_store = AdapterStore(tm, rank=RANK, slots=2)
    fresh_store.register("ten-a", p2)
    fresh = ServingEngine(tm, ServingConfig(**kw), adapter_store=fresh_store,
                          device="cpu")
    assert swapped == _serve(fresh, [prompt], ["ten-a"])[0]
    assert swapped != _serve(eng, [prompt], [None])[0]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
def test_store_lru_pinning_unknown_and_swap_fail(pair, tmp_path):
    jm, tm, d = pair
    store = _port_store(tm, d)
    eng = ServingEngine(tm, ServingConfig(**ENGINE), adapter_store=store,
                        device="cpu")
    for i in range(4):
        _jax_adapter(jm, str(tmp_path / f"ev{i}.pdmodel"), f"ev{i}",
                     seed=20 + i)
        store.register(f"ev{i}", str(tmp_path / f"ev{i}.pdmodel"))
    p = np.arange(3, 9, dtype=np.int32)
    with pytest.raises(AdapterLoadError, match="not registered"):
        eng.submit(p, adapter="ghost")
    for aid in ("ten-a", "ten-b", "ev0", "ev1", "ev2", "ev3"):
        _serve(eng, [p], [aid], 2)      # 6 adapters through 4 slots
    assert store.evictions == 2
    snap = store.residency()
    assert len(snap["resident"]) == 4 and not any(snap["refs"].values())
    held = [eng.submit(p, max_new_tokens=30, adapter=a)
            for a in ("ev0", "ev1", "ev2", "ev3")]
    with pytest.raises(AdapterLoadError, match="pool exhausted"):
        eng.submit(p, adapter="ten-a")
    for r in held:
        eng.cancel(r)
        eng.release(r)
    assert len(_serve(eng, [p], ["ten-a"], 2)[0]) == 2
    # swap_fail: a typed error for the request that needed a swap-in;
    # resident adapters and base traffic go on, and the failure counts
    base = _serve(eng, [p], [None], 4)[0]
    fails = store.load_failures
    faults.arm("serving.lora.swap_fail", mode="always")
    held = eng.submit(p, max_new_tokens=4, adapter="ten-a")
    with pytest.raises(AdapterLoadError, match="swap_fail"):
        eng.submit(p, adapter="ten-b")
    other = eng.submit(p, max_new_tokens=4)
    eng.run_until_idle()
    faults.disarm("serving.lora.swap_fail")
    assert list(eng.scheduler.get(other).generated) == base
    assert len(eng.scheduler.get(held).generated) == 4
    eng.release(held)
    eng.release(other)
    assert store.load_failures == fails + 1
    assert faults.fired("serving.lora.swap_fail") == 1
    assert len(_serve(eng, [p], ["ten-b"], 2)[0]) == 2
    kinds = [e["event"] for e in events.journal().recent(64)]
    assert "adapter_swap" in kinds and "adapter_evict" in kinds


@pytest.mark.parametrize("rank", [4, 12])
def test_rank_padding_keeps_streams(pair, tmp_path, rank):
    """The pools' rank rounded up to a multiple of 8 (what the kernel's
    bf16 operands take) with zero columns of A and rows of B: the port's
    streams equal the JAX engine's over its unpadded rank-4/12 pools."""
    jm, tm, _ = pair
    path = str(tmp_path / "r.pdmodel")
    _jax_adapter(jm, path, "r", seed=5, rank=rank)
    store = AdapterStore(tm, rank=rank, slots=2)
    store.register("r", path)
    assert store.pool_rank == -(-rank // 8) * 8 != rank
    assert not store._a[0][:, :, rank:].any()
    eng = ServingEngine(tm, ServingConfig(prefix_sharing=False, **ENGINE),
                        adapter_store=store, device="cpu")
    jstore = JaxAdapterStore(jm, rank=rank, slots=2)
    jstore.register("r", path)
    jeng = JaxServingEngine(jm, JaxServingConfig(prefix_sharing=False,
                                                 **ENGINE),
                            adapter_store=jstore)
    prompts, adapters = _prompts(2, [9, 14, 9]), ["r", None, "r"]
    got = _serve(eng, prompts, adapters)
    jr = [jeng.submit(p, max_new_tokens=6, adapter=a)
          for p, a in zip(prompts, adapters)]
    jeng.run_until_idle()
    assert got == [list(jeng.scheduler.get(r).generated) for r in jr]
    assert got[0] != _serve(eng, prompts[:1], [None])[0]


def test_hot_swap_racing_decode_never_tears_a_step(pair, monkeypatch):
    """A thread re-registers a resident adapter back and forth (versions
    marked by A[0, 0] = 1 or 2 in every target), with no pause, while an
    InProcessReplica's driver decodes through it with no pause either:
    every step's projections all see one version, both versions were
    seen, and swaps landed while the stream ran (a swap never waits for
    the driver to go idle)."""
    from paddle_tpu_torch.serving import InProcessReplica

    jm, tm, d = pair
    blobs = []
    for mark in (1.0, 2.0):
        blob = load_adapter(str(d / "ten-a.pdmodel"))
        weights = {}
        for name, (a, b) in blob["weights"].items():
            a = np.array(a)
            a[0, 0] = mark
            weights[name] = (a, b)
        blobs.append({"adapter": blob["adapter"], "weights": weights})
    store = AdapterStore(tm, rank=RANK, slots=2)
    store.register("ten-a", blobs[0])
    eng = ServingEngine(tm, ServingConfig(**ENGINE), adapter_store=store,
                        device="cpu")
    seen, step_marks = [], []
    real = seam.serve_delta
    real_step = eng.step

    def spy(v, a_pool, b_pool, binding):
        slot = int(binding.slots[0])
        if slot < binding.num_slots:
            seen.append(float(a_pool[slot, 0, 0]))
        return real(v, a_pool, b_pool, binding)

    def step():
        seen.clear()
        out = real_step()
        if seen:
            step_marks.append(set(seen))
        return out

    monkeypatch.setattr(seam, "serve_delta", spy)
    eng.step = step
    stop = threading.Event()
    swaps = []

    def swapper():
        i = 1
        while not stop.is_set():
            store.register("ten-a", blobs[i % 2])
            swaps.append(time.monotonic())
            i += 1

    t = threading.Thread(target=swapper)
    with InProcessReplica(eng, replica_id=0) as rep:
        stream = rep.open_stream({"prompt_ids": _prompts(4, [6])[0].tolist(),
                                  "max_new_tokens": 40, "adapter": "ten-a"})
        t.start()
        try:
            tokens, ev = 0, None
            t0 = time.monotonic()
            while ev is None or "done" not in ev:
                ev = stream.next_event(30.0)
                assert ev is not None, "stream stalled"
                tokens += "token" in ev
            t1 = time.monotonic()
        finally:
            stop.set()
            t.join()
            stream.close()
    assert tokens == 40
    assert all(len(m) == 1 for m in step_marks), step_marks
    assert {next(iter(m)) for m in step_marks} == {1.0, 2.0}
    assert sum(t0 <= ts <= t1 for ts in swaps) >= 2


# ---------------------------------------------------------------------------
# the train plane
# ---------------------------------------------------------------------------
def _packed_batch(seed):
    from paddle_tpu.io.packing import pack_examples

    rng = np.random.RandomState(seed)
    docs = [rng.randint(1, 128, n).astype(np.int32)
            for n in (9, 30, 14, 5, 22, 17, 40, 11)]
    return next(pack_examples(docs, seq_len=64, batch_size=2))


def test_train_plane_matches_compiled_train_step():
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu.parallel.train_step import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(**MODEL))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, LlamaConfig(**MODEL), device="cpu")
    cfg = dict(rank=RANK, alpha=8.0, seed=1)
    jh = jax_attach(jm, JaxLoRAConfig(**cfg))
    th = attach(tm, LoRAConfig(**cfg))
    for (jp, _, ja, _), (tp, _, ta, tb) in zip(jh.entries, th.entries):
        assert jp == tp
        assert np.array_equal(ta.detach().numpy(), np.asarray(ja._value))
        assert not tb.any()
    assert sum(p.requires_grad for p in tm.parameters()) == 2 * len(
        th.entries)
    # the attached forward with a non-zero B, then back to B = 0
    rng = np.random.default_rng(4)
    for _, _, _, B in jh.entries:
        B.set_value((rng.standard_normal(tuple(B.shape)) * 0.2)
                    .astype(np.float32))
    lora_from_paddle_tpu(jh, tm)
    ids = np.random.RandomState(0).randint(0, 128, (2, 12))
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for _, _, _, B in jh.entries:
        B.set_value(np.zeros(tuple(B.shape), np.float32))
    lora_from_paddle_tpu(jh, tm)

    jopt = JaxAdamW(learning_rate=1e-2, parameters=jm.parameters(),
                    weight_decay=0.01)
    jstep = CompiledTrainStep(jm, lambda out, lab: out, optimizer=jopt)
    opt = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                weight_decay=0.01)
    step = TrainStep(tm, lambda out, lab: out, opt)
    batch = _packed_batch(2)
    jl = [float(jstep(batch)) for _ in range(3)]
    tl = [float(step(batch)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    jstep.sync_params_to_model()
    for (_, _, ja, jb), (_, _, ta, tb) in zip(jh.entries, th.entries):
        np.testing.assert_allclose(ta.detach().numpy(),
                                   np.asarray(ja._value), rtol=0, atol=2e-5)
        np.testing.assert_allclose(tb.detach().numpy(),
                                   np.asarray(jb._value), rtol=0, atol=2e-5)
    # the base stayed frozen, and detach restores the model
    for n, p in tm.named_parameters():
        if not n.startswith("_lora_host"):
            want = named[n].T if n.endswith("_proj.weight") or \
                n == "lm_head.weight" else named[n]
            assert np.array_equal(p.detach().numpy(), want), n
    detach(th)
    jax_detach(jh)
    assert all(p.requires_grad for p in tm.parameters())
    assert not seam.active()


# ---------------------------------------------------------------------------
# observability, HTTP, imports
# ---------------------------------------------------------------------------
def test_prometheus_text_equal_across_packages():
    texts = []
    for reg in (JaxRegistry(), MetricsRegistry()):
        c = reg.counter("lora_tokens_total", "tokens per tenant",
                        labels=("engine", "tenant"))
        c.labels(engine="0", tenant="acme").inc(5)
        c.labels(engine="0", tenant='we"ird\\n').inc()
        reg.gauge("lora_active_adapters", "resident",
                  labels=("store",)).labels(store="0").set(3)
        h = reg.histogram("router_latency_s", "latency",
                          buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        reg.add_collector(lambda r: r.gauge("router_in_flight", "n").set(2))
        texts.append((reg.prometheus_text(), reg.snapshot()))
    assert texts[0][0] == texts[1][0]
    assert texts[0][1] == texts[1][1]


def test_http_adapter_stream_metrics_and_typed_failure(pair):
    _, tm, d = pair
    eng = ServingEngine(tm, ServingConfig(**ENGINE),
                        adapter_store=_port_store(tm, d), device="cpu")
    prompt = _prompts(3, [11])[0]
    want = _serve(eng, [prompt], ["ten-b"], 5)[0]
    srv = eng.serve_http(0, block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=30)

        def post(payload):
            conn.request("POST", "/generate", json.dumps(payload),
                         {"Content-Type": "application/json"})
            return [json.loads(x) for x in
                    conn.getresponse().read().decode().splitlines()]

        evs = post({"prompt_ids": prompt.tolist(), "max_new_tokens": 5,
                    "adapter": "ten-b", "tenant": "acme"})
        bad = post({"prompt_ids": prompt.tolist(), "adapter": "ghost"})
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        ctype, text = resp.getheader("Content-Type"), resp.read().decode()
        conn.close()
    finally:
        eng.shutdown_http()
    assert [e["token"] for e in evs[:-1]] == want and evs[-1]["done"]
    assert bad == [{"error": "adapter_load_failed", "adapter": "ghost",
                    "message": bad[0]["message"]}]
    assert ctype.startswith("text/plain; version=0.0.4")
    for name in ("lora_active_adapters", "lora_swap_total", "lora_swap_ms",
                 "lora_tokens_total", "serving_engine_committed_tokens_total"):
        assert name in text, name
    assert 'tenant="acme"' in text
    assert eng.stats()["tenant_tokens"]["acme"] == 5


def test_lora_and_router_import_no_jax():
    code = ("import sys, paddle_tpu_torch.lora, "
            "paddle_tpu_torch.lora.store, paddle_tpu_torch.serving.router\n"
            "print(sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'paddle_tpu.')) or k == 'paddle_tpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, env=env)
    assert out.stdout.strip() == "[]", out.stdout
