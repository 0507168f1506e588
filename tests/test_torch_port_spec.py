"""Speculative decoding in the port on the CPU (the kernels' plain
versions), against the JAX package on the same weights:

* ``decode_forward(verify=True, write_mask=...)`` over fp32, int8 and fp8
  pools: the frame's logits within 1e-5 of JAX's, the pools equal (fp32
  within 1e-5; codes equal or one quantization step apart, scales within
  1e-6 relative), masked entries written to the null page only;
* the engine at ``spec_k`` 1-4 over fp32, int8 and fp8 pools with prefix
  sharing on, stepped in lockstep with the JAX engine: equal greedy
  streams, page tables, tokens committed per row per step (the accepted
  counts) and allocator counters;
* the JAX engine's speculative tests within the port: K=1 equals plain
  decode, sampled streams equal plain decode's bit for bit, turning K on
  mid-flight reseeds the proposer, copy-on-write at ``spec_k`` 2 leaves
  the sharer's bytes unchanged, the ``serving.spec.verify_mismatch``
  chaos site (mode ``always``) commits exactly one token a step with the
  same stream; GQA 8:1 at ``spec_k`` 8 serves;
* ``NGramProposer`` equal to JAX's on random streams;
* a frame of more than ``MAX_FRAME_ROWS`` rows a kv head (GQA 8:1, spec_k
  8) cut into chunks equals the whole frame on the plain version (fp32,
  1e-6), and the kernel wrapper launches once a chunk with the chunk's
  lens.
"""
import ctypes

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as jax_faults
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving.drafts import NGramProposer as JaxProposer
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.models import from_paddle_tpu_params, llama_tiny_config
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.serving import (NGramProposer, ServingConfig,
                                      ServingEngine)

TOL = 1e-5
JAX_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
CODES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
ENGINE = dict(page_size=4, num_pages=64, decode_batch=4, prefill_chunk=8,
              max_seq_len=64)
CHAOS = "serving.spec.verify_mismatch"


def _pair(jax_cfg, port_cfg):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(**jax_cfg))
    jm.eval()
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(**port_cfg),
                                device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """2 layers, hidden 64, 4 query heads on 2 kv heads."""
    return _pair(dict(num_key_value_heads=2), dict(num_key_value_heads=2))


def _prompts(seed, lens, vocab=256, shared=12):
    """Prompts behind one shared system prompt of `shared` tokens."""
    rng = np.random.RandomState(seed)
    sysp = rng.randint(1, vocab, shared).astype(np.int32)
    return [np.concatenate([sysp, rng.randint(1, vocab, n).astype(np.int32)])
            for n in lens]


# ---------------------------------------------------------------------------
# the model's verify frame
# ---------------------------------------------------------------------------
def _same_pools(jc, tc, mode):
    for name in ("k", "v"):
        j = np.asarray(jc[name]).astype(np.float32)
        t = tc[name]
        if mode == "model":
            np.testing.assert_allclose(t.numpy(), j, rtol=TOL, atol=TOL)
            continue
        if mode == "fp8":
            t = t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
            step = np.maximum(np.abs(j) / 8, 2.0 ** -9)   # one e4m3 step
        else:
            t, step = t.numpy(), np.ones_like(j)
        assert np.all(np.abs(j - t.astype(np.float32)) <= step), name
    if mode != "model":
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("mode", ["model", "int8", "fp8"])
def test_verify_frame_logits_and_pools_equal_jax(models, mode):
    """A prefill chunk of two rows, then a [2, 4] verify frame whose
    write_mask drops row 0's last slot and all of row 1 past its first:
    logits within 1e-5, pools as `_same_pools`; the masked slots' K/V land
    in the null page 0, and only there."""
    jm, tm = models
    cfg = tm.config
    L, hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    d = cfg.hidden_size // cfg.num_attention_heads
    P, ps = 12, 4
    if mode == "model":
        jc = {n: jnp.zeros((L, hkv, P, ps, d), jnp.float32)
              for n in ("k", "v")}
        tc = {n: torch.zeros((L, hkv, P, ps, d)) for n in ("k", "v")}
    else:
        jc = {n: jnp.zeros((L, hkv, P, ps, d), JAX_CODES[mode])
              for n in ("k", "v")}
        tc = {n: torch.zeros((L, hkv, P, ps, d), dtype=CODES[mode])
              for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            jc[n] = jnp.zeros((L, hkv, P, ps), jnp.float32)
            tc[n] = torch.zeros((L, hkv, P, ps))
    rng = np.random.RandomState(3)
    pt = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    ctx = rng.randint(1, 256, (2, 8)).astype(np.int32)
    lens_pre = np.array([8, 8], np.int32)
    frame = rng.randint(1, 256, (2, 4)).astype(np.int32)
    lens = np.array([9, 9], np.int32)
    pos = 8 + np.arange(4, dtype=np.int32)[None].repeat(2, 0)
    mask = np.array([[True, True, True, False],
                     [True, False, False, False]])
    with torch.inference_mode():
        _, jc = jm.llama.decode_forward(
            paddle.to_tensor(ctx), jc, jnp.asarray(pt),
            jnp.asarray(lens_pre),
            jnp.asarray(np.arange(8, dtype=np.int32)[None].repeat(2, 0)),
            ctx_pad=16)
        _, tc = tm.llama.decode_forward(
            torch.from_numpy(ctx).long(), tc, torch.from_numpy(pt),
            torch.from_numpy(lens_pre),
            torch.arange(8)[None].repeat(2, 1), ctx_pad=16)
        jl, jc = jm.decode_forward(
            paddle.to_tensor(frame), jc, jnp.asarray(pt), jnp.asarray(lens),
            jnp.asarray(pos), write_mask=jnp.asarray(mask), verify=True)
        before = {n: a.clone() for n, a in tc.items()}
        tl, tc = tm.decode_forward(
            torch.from_numpy(frame).long(), tc, torch.from_numpy(pt),
            torch.from_numpy(lens), torch.from_numpy(pos).long(),
            write_mask=torch.from_numpy(mask), verify=True)
    jl = np.asarray(jl._value if hasattr(jl, "_value") else jl)
    assert tl.shape == (2, 4, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    _same_pools(jc, tc, mode)
    # the unmasked slots were written (row 0 positions 8-10: page 3 slots
    # 0-2; row 1 position 8: page 7 slot 0); the masked ones (row 0
    # position 11, row 1 positions 9-11) went to page 0 and nowhere else
    name = "k" if mode == "model" else "k_scale"
    diff = tc[name] != before[name]
    if mode == "model":
        diff = diff.any(-1)
    hit = {tuple(x) for x in diff.any(0).any(0).nonzero().tolist()}
    live = {(3, 0), (3, 1), (3, 2), (7, 0)}
    assert live <= hit <= live | {(0, 1), (0, 2), (0, 3)}, hit


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
def _lockstep(jeng, teng, prompts, max_new_tokens):
    """Submit to both and step in lockstep; after every step the page
    tables and each row's committed count (what the step accepted) must
    be equal. Returns the port's streams."""
    jr = [jeng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    tr = [teng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    while jeng.busy or teng.busy:
        jeng.step()
        teng.step()
        teng.allocator.check_consistency()
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(
                jeng.allocator.page_table_row(a, jeng.pages_per_seq),
                teng.allocator.page_table_row(b, teng.pages_per_seq))
            assert len(jeng.scheduler.get(a).generated) == \
                len(teng.scheduler.get(b).generated)
    want = [list(jeng.scheduler.get(r).generated) for r in jr]
    got = [list(teng.scheduler.get(r).generated) for r in tr]
    assert got == want
    for a, b in zip(jr, tr):
        jeng.release(a)
        teng.release(b)
    return got


@pytest.mark.parametrize("mode", ["model", "int8", "fp8"])
def test_speculative_engine_equals_jax(models, mode):
    """One engine pair a pool mode, K switched 1 -> 4 between waves (the
    JAX engine caches a verify program a K): equal streams, page tables,
    accepted counts and counters at every K."""
    jm, tm = models
    kw = dict(ENGINE, kv_cache_dtype=mode, prefix_sharing=True, spec_k=1)
    jeng = JaxServingEngine(jm, JaxServingConfig(**kw))
    teng = ServingEngine(tm, ServingConfig(**kw), device="cpu")
    for k in (1, 2, 3, 4):
        jeng.configure_speculation(spec_k=k)
        teng.configure_speculation(spec_k=k)
        jeng.reset_stats()
        teng.reset_stats()
        prompts = _prompts(10 + k, (3, 6, 9, 4))
        _lockstep(jeng, teng, prompts, max_new_tokens=14)
        js, ts = jeng.stats(), teng.stats()
        for key in ("accepted_tokens_per_step", "spec_k", "prefix_hit_rate",
                    "cow_copies"):
            assert js[key] == ts[key], (k, key, js[key], ts[key])
        assert jeng._committed_tokens == teng._committed_tokens
        assert jeng._decode_steps == teng._decode_steps
    teng.allocator.check_consistency()
    assert teng.allocator.free_pages == teng.num_pages - 1
    assert teng.stats()["kv_cache_dtype"] == jeng.stats()["kv_cache_dtype"]


def test_accepted_tokens_pass_one_on_a_repeating_stream(models):
    """A prompt that repeats a span drafts from its own tables: verify
    steps commit more than one token on average, with the stream of
    plain decode."""
    _, tm = models
    span = np.random.RandomState(5).randint(1, 256, 6).astype(np.int32)
    prompt = np.tile(span, 4)
    plain = ServingEngine(tm, ServingConfig(**ENGINE), device="cpu")
    spec = ServingEngine(tm, ServingConfig(**ENGINE, spec_k=4),
                         device="cpu")
    want = plain.generate([prompt], max_new_tokens=20)
    assert spec.generate([prompt], max_new_tokens=20) == want
    assert spec.accepted_tokens_per_step > 1.0
    assert spec.stats()["decode_steps"] < plain.stats()["decode_steps"]


# ---------------------------------------------------------------------------
# the JAX engine's speculative tests, within the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(models):
    _, tm = models
    kw = dict(ENGINE, prefix_sharing=True)
    return (ServingEngine(tm, ServingConfig(**kw), device="cpu"),
            ServingEngine(tm, ServingConfig(**kw, spec_k=3), device="cpu"))


def _aligned(*engines, seq=1000):
    """Pin the submission counters: generators are keyed by order."""
    for e in engines:
        e._submit_seq = seq


def test_k1_equals_plain_decode(engines):
    base, spec = engines
    prompts = _prompts(13, (4, 8))
    want = base.generate(prompts, max_new_tokens=9)
    spec.configure_speculation(spec_k=1)
    try:
        got = spec.generate(prompts, max_new_tokens=9)
    finally:
        spec.configure_speculation(spec_k=3)
    assert got == want and all(len(o) == 9 for o in got)


def test_temperature_streams_bit_equal_plain_decode(engines):
    base, spec = engines
    prompts = _prompts(12, (5, 9, 7))
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=24, top_p=0.9)
    _aligned(base, spec)
    want = base.generate(prompts, **kw)
    spec.reset_stats()
    got = spec.generate(prompts, **kw)
    assert got == want
    assert spec.accepted_tokens_per_step >= 1.0


def test_turning_speculation_on_mid_flight_reseeds(engines):
    base, spec = engines
    prompt = _prompts(15, (7,))[0]
    want = base.generate([prompt], max_new_tokens=12)[0]
    spec.configure_speculation(spec_k=0)
    try:
        rid = spec.submit(prompt, max_new_tokens=12)
        for _ in range(4):                      # plain-decode opening
            spec.step()
        assert rid not in spec._proposer._state
        spec.configure_speculation(spec_k=3)
        assert rid in spec._proposer._state     # reseeded mid-flight
        spec.run_until_idle()
    finally:
        spec.configure_speculation(spec_k=3)
    got = list(spec.scheduler.get(rid).generated)
    spec.release(rid)
    assert got == want
    assert rid not in spec._proposer._state
    spec.allocator.check_consistency()


def test_cow_at_spec_k2_leaves_sharer_bytes_identical(models):
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(**ENGINE, spec_k=2,
                                          prefix_sharing=True),
                        device="cpu")
    prompt = np.random.RandomState(15).randint(1, 256, 16).astype(np.int32)
    ra = eng.submit(prompt, max_new_tokens=40)
    eng.step()                                  # admit and prefill A
    a_pages = eng.allocator.chain(ra)[:4]
    before = {n: a[:, :, a_pages].clone() for n, a in eng._cache.items()}
    rb = eng.submit(prompt, max_new_tokens=8)   # a full 4-page match
    req_b = eng.scheduler.get(rb)
    while not req_b.finished:
        eng.step()
    assert req_b.matched_tokens == 16
    assert eng.allocator.cow_copies >= 1
    assert eng.allocator.chain(ra)[:4] == a_pages
    for n, a in eng._cache.items():
        assert torch.equal(a[:, :, a_pages], before[n]), n
    eng.cancel(ra)
    eng.allocator.check_consistency()
    req_a = eng.scheduler.get(ra)
    assert req_a.generated[:len(req_b.generated)] == req_b.generated


@pytest.fixture
def chaos():
    faults.reset()
    yield
    faults.reset()


def test_verify_mismatch_chaos_commits_one_token_a_step(engines, chaos):
    base, spec = engines
    prompts = _prompts(16, (5, 7))
    want = base.generate(prompts, max_new_tokens=8)
    spec.reset_stats()
    faults.arm(CHAOS, mode="always")
    try:
        got = spec.generate(prompts, max_new_tokens=8)
    finally:
        faults.disarm(CHAOS)
    assert got == want
    assert faults.fired(CHAOS) == spec.stats()["decode_steps"] > 0
    assert spec.accepted_tokens_per_step == 1.0


def test_fault_arming_modes_equal_jax(chaos):
    """once and always, disarm and fired, hit by hit against the JAX
    registry."""
    jax_faults.reset()
    try:
        for mode in ("once", "always"):
            jax_faults.arm(CHAOS, mode=mode)
            faults.arm(CHAOS, mode=mode)
            got = [faults.fire_check(CHAOS) for _ in range(5)]
            assert got == [jax_faults.fire_check(CHAOS) for _ in range(5)]
            jax_faults.disarm(CHAOS)
            faults.disarm(CHAOS)
            assert not faults.fire_check(CHAOS)
            assert faults.fired(CHAOS) == jax_faults.fired(CHAOS)
        with pytest.raises(ValueError, match="mode"):
            faults.arm(CHAOS, mode="nth")
    finally:
        jax_faults.reset()


def test_spec_k_at_gqa_8_to_1_serves_any_k():
    """GQA 8:1 (8 query heads on one kv head): K 8 gives a frame of 72
    rows a kv head, past the kernel's 64; on the CPU the plain version
    takes it whole. Streams equal plain decode's; a negative K raises."""
    _, tm = _pair(dict(num_attention_heads=8, num_key_value_heads=1),
                  dict(num_attention_heads=8, num_key_value_heads=1))
    prompts = _prompts(17, (5, 11))
    want = ServingEngine(tm, ServingConfig(**ENGINE), device="cpu") \
        .generate(prompts, max_new_tokens=10)
    for k in (8, 12):
        eng = ServingEngine(tm, ServingConfig(**ENGINE, spec_k=k),
                            device="cpu")
        assert eng.generate(prompts, max_new_tokens=10) == want
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tm, ServingConfig(**ENGINE, spec_k=-1), device="cpu")


# ---------------------------------------------------------------------------
# the proposer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_order, min_order", [(3, 1), (2, 2), (4, 1)])
def test_proposer_equals_jax(max_order, min_order):
    rng = np.random.RandomState(max_order * 10 + min_order)
    mine = NGramProposer(max_order, min_order)
    ref = JaxProposer(max_order, min_order)
    for rid in range(6):
        vocab = int(rng.choice([4, 16, 256]))
        stream = rng.randint(0, vocab, int(rng.randint(1, 40)))
        mine.add_request(rid, stream)
        ref.add_request(rid, stream)
        for _ in range(30):
            k = int(rng.randint(0, 7))
            assert mine.propose(rid, k) == ref.propose(rid, k)
            tok = int(rng.randint(0, vocab))
            mine.observe(rid, tok)
            ref.observe(rid, tok)
        mine.drop(rid)
        ref.drop(rid)
        assert mine.propose(rid, 3) == ref.propose(rid, 3) == [0, 0, 0]
    with pytest.raises(ValueError):
        NGramProposer(1, 2)


# ---------------------------------------------------------------------------
# frames past the kernel's rows
# ---------------------------------------------------------------------------
def _frame_inputs(t, hq, hkv, d=64, ps=16, b=3, seed=4):
    rng = np.random.RandomState(seed)
    pages = 12
    k = torch.from_numpy(rng.standard_normal((hkv, b * pages + 1, ps, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((hkv, b * pages + 1, ps, d))
                         .astype(np.float32))
    pt = torch.from_numpy(
        (1 + np.arange(b * pages).reshape(b, pages)).astype(np.int32))
    lens = torch.tensor([37, 0, 150], dtype=torch.int32)[:b]
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d))
                         .astype(np.float32))
    return q, k, v, pt, lens


@pytest.mark.parametrize("t, hq, hkv", [(9, 8, 1), (9, 16, 2), (13, 32, 4),
                                        (65, 4, 4), (3, 8, 1)])
def test_split_frame_equals_the_whole_frame(t, hq, hkv):
    q, k, v, pt, lens = _frame_inputs(t, hq, hkv)
    group = hq // hkv
    chunks = pa.frame_chunks(t, group)
    assert [t0 for t0, _ in chunks] == list(range(0, t, chunks[0][1]))
    assert sum(tc for _, tc in chunks) == t
    assert all(tc * group <= pa.MAX_FRAME_ROWS for _, tc in chunks)
    assert (len(chunks) > 1) == (t * group > pa.MAX_FRAME_ROWS)
    whole = pa.paged_attention_reference(q, k, v, pt, lens)
    split = pa._by_chunks(pa.paged_attention_reference, q, k, v, pt, lens)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not split[1].any()                   # the inactive row


def test_wrapper_launches_once_a_chunk(monkeypatch):
    """GQA 8:1 at T 9: two launches, T 8 then T 1 with lens + 8 (0 kept
    for the inactive row), their outputs laid back along T."""
    seen = []

    def decode(*args):
        # (q, k, v, k_scales, v_scales, page_table, lens, out, ws_acc,
        #  ws_ml, B, T, Hq, ...) as ptt_paged_decode takes them
        lens_ptr, out_ptr, b, tq, hq = args[6], args[7], args[10], \
            args[11], args[12]
        lens = (ctypes.c_int32 * b).from_address(lens_ptr)
        seen.append((tq, list(lens)))
        out = np.ctypeslib.as_array(
            (ctypes.c_float * (b * tq * hq * 64)).from_address(out_ptr))
        out[:] = len(seen)
        return 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(pa, "_lib", lambda: (decode, lambda *a: 1))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    q, k, v, pt, lens = _frame_inputs(9, 8, 1)
    pa.reset_launches()
    out = pa._launch(q, k, v, pt, lens, None)
    assert seen == [(8, [37, 0, 150]), (1, [45, 0, 158])]
    assert pa.launch_counts()["paged_decode"] == 2
    assert out.shape == q.shape
    assert (out[:, :8] == 1).all() and (out[:, 8:] == 2).all()
