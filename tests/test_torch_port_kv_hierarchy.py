"""The port's KV memory hierarchy on the CPU, against the JAX package on the
same inputs:

* the quantized paged decode's plain version (int8 and fp8 codes with fp32
  per-slot-per-head scales, decode and a T = 3 frame, a len-0 row) against
  the JAX ``paged_attention_reference`` with scales, fp32 <= 1e-5 (the
  quantized Pallas kernel cannot run here: its ``x64_off`` import fails);
* ``kv_page_scales`` equal to the JAX observer's, and the model's
  quantize-on-write (one packed frame and one chunk through both decode
  paths): codes equal or one step apart, scales within 1e-6 relative;
* the allocator: the JAX ``TestHostTierAllocator`` sequences, the 400-step
  aliasing fuzz included, run op by op against both allocators with equal
  chains, tier copies and counters after every op;
* the engine on a tiny LLaMA in four configurations (int8, fp8, prefix
  sharing over a shared prompt, a host tier that demotes and promotes) and
  under promote-fail chaos: equal greedy streams, page tables and allocator
  counters; quantized codes within one step and scales within 1e-5
  relative of the JAX engine's after a whole run;
* a bf16 model over bf16, int8 and fp8 pools through the packed, chunked
  and decode paths: logits within 2^-5 of each row's max of the JAX bf16
  model's; bf16 int8/fp8 engines: equal page tables, first tokens and
  counters;
* the visit counters' plain versions: the flash counter equal to the JAX
  ``segment_block_visit_counts`` in interpret mode on packed segment ids at
  two block shapes, the page counter equal to ceil(len / page_size).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as jax_faults
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.ops.pallas.flash_attention import \
    segment_block_visit_counts as jax_segment_visits
from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention_reference as jax_paged_reference
from paddle_tpu.quantization import \
    AbsmaxChannelWiseObserver as JaxObserver
from paddle_tpu.serving import PageAllocator as JaxAllocator
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.models import from_paddle_tpu_params, llama_tiny_config
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda.flash_attention import (
    segment_block_visit_counts, segment_block_visit_reference)
from paddle_tpu_torch.ops.cuda.paged_attention import (
    page_visit_counts, paged_attention, paged_attention_reference)
from paddle_tpu_torch.quantization import (AbsmaxChannelWiseObserver,
                                          quantize_kv)
from paddle_tpu_torch.serving import (PageAllocator, ServingConfig,
                                      ServingEngine)

TOL = 1e-5
QMAX = {"int8": 127.0, "fp8": 448.0}
CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


# ---------------------------------------------------------------------------
# quantized paged attention, plain version
# ---------------------------------------------------------------------------
def _quantize_np(x, mode):
    """numpy quantize-on-write: per-slot-per-head absmax over head_dim."""
    sc = np.maximum(np.abs(x).max(-1) / QMAX[mode], 1e-8).astype(np.float32)
    q = x / sc[..., None]
    if mode == "int8":
        return np.clip(np.round(q), -127, 127).astype(np.int8), sc
    return q.astype(ml_dtypes.float8_e4m3fn), sc


def _to_torch(codes):
    if codes.dtype == np.int8:
        return torch.from_numpy(codes)
    return torch.from_numpy(codes.view(np.uint8)).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("t", [1, 3])
def test_quantized_plain_version_matches_jax_reference(mode, t):
    rng = np.random.RandomState(7)
    b, hq, hkv, ps, d, pages = 4, 4, 2, 8, 16, 14
    kf = rng.standard_normal((hkv, pages, ps, d)).astype(np.float32)
    vf = rng.standard_normal((hkv, pages, ps, d)).astype(np.float32)
    (kc, ks), (vc, vs) = _quantize_np(kf, mode), _quantize_np(vf, mode)
    pt = np.zeros((b, 4), np.int32)
    pt[0, :3] = [3, 1, 7]
    pt[1, :2] = [2, 9]
    pt[3, :4] = [4, 5, 6, 8]
    lens = np.array([19, 9, 0, 29], np.int32)
    qshape = (b, hq, d) if t == 1 else (b, t, hq, d)
    q = rng.standard_normal(qshape).astype(np.float32)
    want = np.asarray(jax_paged_reference(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pt),
        jnp.asarray(lens), k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs)))
    before = port_cuda.launch_counts()
    got = paged_attention(torch.from_numpy(q), _to_torch(kc), _to_torch(vc),
                          torch.from_numpy(pt), torch.from_numpy(lens),
                          k_scales=torch.from_numpy(ks),
                          v_scales=torch.from_numpy(vs))
    assert port_cuda.launch_counts() == before      # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert np.all(got.numpy()[2] == 0)               # the len-0 row


def test_quantized_scales_contract():
    k = torch.zeros((2, 5, 4, 16), dtype=torch.int8)
    q = torch.zeros((1, 2, 16))
    pt = torch.ones((1, 2), dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    sc = torch.ones((2, 5, 4))
    with pytest.raises(ValueError, match="go together"):
        paged_attention_reference(q, k, k, pt, lens, v_scales=sc)
    with pytest.raises(ValueError, match="go together"):
        paged_attention_reference(q, k, k, pt, lens, k_scales=sc)
    with pytest.raises(ValueError, match=r"\[Hkv, P, page_size\]"):
        paged_attention_reference(q, k, k, pt, lens, k_scales=sc,
                                  v_scales=torch.ones((2, 5, 3)))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_kv_page_scales_equal_jax(dtype):
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((3, 5, 2, 16)) * 2).astype(dtype)
    xt = torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16 if dtype is ml_dtypes.bfloat16 else torch.float32)
    for qmax in (127.0, 448.0):
        want = np.asarray(JaxObserver.kv_page_scales(jnp.asarray(x),
                                                     qmax=qmax))
        got = AbsmaxChannelWiseObserver.kv_page_scales(xt, qmax=qmax)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_kv_codes_equal_numpy(mode):
    """The port's quantize-on-write gives the numpy (ml_dtypes) codes bit
    for bit, and an e4m3 value a rounding step above 448 casts to 448 in
    both, never to NaN."""
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((3, 7, 2, 16)) * 3).astype(np.float32)
    want_codes, want_scales = _quantize_np(x, mode)
    codes, scales = quantize_kv(torch.from_numpy(x), CODE_DTYPES[mode])
    assert codes.dtype == CODE_DTYPES[mode]
    np.testing.assert_array_equal(scales.numpy(), want_scales)
    np.testing.assert_array_equal(codes.view(torch.uint8 if mode == "fp8"
                                             else torch.int8).numpy(),
                                  want_codes.view(np.uint8 if mode == "fp8"
                                                  else np.int8))
    if mode == "fp8":
        edge = np.array([448.0, np.nextafter(np.float32(448), 500), 463.0],
                        np.float32)
        got = torch.from_numpy(edge).to(torch.float8_e4m3fn).float().numpy()
        np.testing.assert_array_equal(got, [448.0, 448.0, 448.0])
        np.testing.assert_array_equal(
            edge.astype(ml_dtypes.float8_e4m3fn).astype(np.float32), got)


# ---------------------------------------------------------------------------
# allocator: op by op against the JAX allocator
# ---------------------------------------------------------------------------
class _Pair:
    """Both allocators driven by the same operations; every operation's
    result, every chain, the pending tier copies and every counter must be
    equal, and both must stay consistent."""

    COUNTERS = ("prefix_matches", "prefix_tokens_matched", "cow_copies",
                "demotions", "promotions", "cold_hits", "dropped_cold",
                "promote_failures", "free_pages", "cold_pages", "host_used",
                "reclaimable_pages", "used_pages")

    def __init__(self, num_pages, page_size, host_pages):
        self.j = JaxAllocator(num_pages, page_size, host_pages=host_pages)
        self.t = PageAllocator(num_pages, page_size, host_pages=host_pages)
        self.rids: set = set()

    def __getattr__(self, name):
        def call(*args, **kw):
            if name in ("ensure", "free_request", "make_writable",
                        "register_prefix"):
                self.rids.add(args[0])
            a = getattr(self.j, name)(*args, **kw)
            b = getattr(self.t, name)(*args, **kw)
            assert a == b, (name, args, a, b)
            self.check()
            return b
        return call

    def check(self):
        for alloc in (self.j, self.t):
            alloc.check_consistency()
        for c in self.COUNTERS:
            assert getattr(self.j, c) == getattr(self.t, c), c
        for rid in self.rids:
            assert self.j.chain(rid) == self.t.chain(rid), rid
        assert self.j._pending_demote == self.t._pending_demote
        assert self.j._pending_promote == self.t._pending_promote


@pytest.fixture
def chaos():
    jax_faults.reset()
    faults.reset()
    yield lambda: (jax_faults.arm("serving.kv.promote_fail", mode="once"),
                   faults.arm("serving.kv.promote_fail"))
    jax_faults.reset()
    faults.reset()


def test_fault_arming_once_equals_jax(chaos):
    """An armed point fires on its next hit only, as JAX's mode="once"
    does, and fires again after it is re-armed."""
    name = "serving.kv.promote_fail"
    for _ in range(2):
        jax_faults.arm(name, mode="once")
        faults.arm(name)
        got = [faults.fire_check(name) for _ in range(8)]
        assert got == [jax_faults.fire_check(name) for _ in range(8)]
        assert got == [True] + [False] * 7
    faults.arm(name)
    faults.reset()
    assert not faults.fire_check(name)


def test_fault_registry_rejects_unknown_points():
    with pytest.raises(KeyError):
        faults.arm("serving.kv.no_such_point")
    with pytest.raises(KeyError):
        faults.fire_check("serving.kv.no_such_point")


def _toks(*vals):
    return np.asarray(vals, np.int32)


def _seq_demote_promote(a, _):
    toks = _toks(1, 2, 3, 4)
    assert a.ensure("A", 4)
    a.register_prefix("A", toks)
    a.free_request("A")
    a.ensure("B", 2 * a.t.free_pages + 2 * a.t.cold_pages)
    a.take_tier_ops()
    a.free_request("B")
    adopt, matched = a.match_prefix(toks)
    assert matched == 4
    assert a.ensure("C", 5, adopt=adopt)
    a.take_tier_ops()


def _seq_shared_refcounts(a, _):
    toks = _toks(5, 6, 7, 8)
    a.ensure("A", 4)
    a.register_prefix("A", toks)
    adopt, _m = a.match_prefix(toks)
    a.ensure("B", 5, adopt=adopt)
    a.free_request("A")
    assert not a.ensure("HOG", 2 * (a.t.free_pages + 1))


def _seq_cow_after_promote(a, _):
    toks = _toks(1, 2, 3, 4)
    a.ensure("A", 4)
    a.register_prefix("A", toks)
    a.free_request("A")
    a.ensure("B", 2 * a.t.reclaimable_pages)
    a.free_request("B")
    a.take_tier_ops()
    adopt, _m = a.match_prefix(toks)
    a.ensure("C", 4, adopt=adopt)
    assert a.make_writable("C", 0, 3) == []
    a.take_tier_ops()


def _seq_promote_fail(a, arm):
    toks = _toks(9, 8, 7, 6)
    a.ensure("A", 4)
    a.register_prefix("A", toks)
    a.free_request("A")
    a.ensure("B", 2 * a.t.reclaimable_pages)
    a.free_request("B")
    a.take_tier_ops()
    arm()
    assert a.match_prefix(toks) == ([], 0)
    assert a.t.promote_failures == 1
    a.ensure("C", 4)


def _seq_host_full(a, _):
    for rid, t in (("A", _toks(1, 2)), ("B", _toks(3, 4))):
        a.ensure(rid, 2)
        a.register_prefix(rid, t)
        a.free_request(rid)
    a.ensure("HOG", 2 * a.t.reclaimable_pages)
    assert a.t.host_used == 1


@pytest.mark.parametrize("seq, geometry", [
    (_seq_demote_promote, (6, 2, 4)),
    (_seq_shared_refcounts, (8, 2, 4)),
    (_seq_cow_after_promote, (6, 2, 4)),
    (_seq_promote_fail, (6, 2, 4)),
    (_seq_host_full, (12, 2, 1)),
], ids=["demote_promote", "shared_refcounts", "cow_after_promote",
        "promote_fail", "host_full"])
def test_host_tier_sequences_equal_jax(seq, geometry, chaos):
    pair = _Pair(*geometry)
    seq(pair, chaos)
    pair.check()


def test_aliasing_fuzz_with_tier_transitions_equal_jax():
    """The JAX 400-op fuzz (adoption, registration, growth, CoW, eviction,
    demote/promote through a host tier small enough to thrash), op by op
    on both allocators."""
    a = _Pair(24, 2, 6)
    rng = np.random.RandomState(16)
    live: dict[int, np.ndarray] = {}
    corpus = [rng.randint(1, 9, 12).astype(np.int32) for _ in range(4)]
    for _ in range(400):
        rid = int(rng.randint(10))
        op = rng.rand()
        if rid in live and op < 0.25:
            a.free_request(rid)
            del live[rid]
        elif rid not in live:
            base = corpus[rng.randint(len(corpus))]
            n = int(rng.randint(2, base.size + 1))
            toks = base[:n].copy()
            if rng.rand() < 0.3:
                toks[-1] = rng.randint(1, 9)
            pages, _m = a.match_prefix(toks)
            if a.ensure(rid, toks.size, adopt=pages or None):
                live[rid] = toks
                a.register_prefix(rid, toks)
        else:
            toks = live[rid]
            if rng.rand() < 0.5:
                grown = np.concatenate(
                    [toks, rng.randint(1, 9, 2).astype(np.int32)])
                if a.ensure(rid, grown.size):
                    live[rid] = grown
            else:
                a.make_writable(rid, max(toks.size - 2, 0), toks.size - 1)
        if rng.rand() < 0.1:
            a.take_tier_ops()
    assert a.t.demotions > 0 and a.t.promotions > 0
    for rid in list(live):
        a.free_request(rid)
    a.take_tier_ops()


# ---------------------------------------------------------------------------
# engine: port vs JAX on a tiny LLaMA
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(num_key_value_heads=2))
    jm.eval()
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(
        num_key_value_heads=2), device="cpu")
    return jm, tm


SMALL = dict(page_size=4, num_pages=64, decode_batch=4, prefill_chunk=8,
             max_seq_len=64)
TIGHT = dict(page_size=4, num_pages=12, decode_batch=2, prefill_chunk=8,
             max_seq_len=32)
ALLOC_COUNTERS = ("prefix_matches", "prefix_tokens_matched", "cow_copies",
                  "demotions", "promotions", "cold_hits", "dropped_cold",
                  "promote_failures", "free_pages", "cold_pages",
                  "host_used")


def _engines(models, **kw):
    jm, tm = models
    return (JaxServingEngine(jm, JaxServingConfig(spec_k=0, **kw)),
            ServingEngine(tm, ServingConfig(**kw), device="cpu"))


def _run_both(jeng, teng, prompts, max_new_tokens=6):
    """Submit to both, step both in lockstep (page tables compared after
    every step), run to completion; returns the port's streams."""
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
    want = [list(jeng.scheduler.get(r).generated) for r in jr]
    got = [list(teng.scheduler.get(r).generated) for r in tr]
    assert got == want
    for a, b in zip(jr, tr):
        jeng.release(a)
        teng.release(b)
    return got


def _same_counters(jeng, teng):
    for c in ALLOC_COUNTERS:
        assert getattr(jeng.allocator, c) == getattr(teng.allocator, c), c
    js, ts = jeng.stats(), teng.stats()
    for k in ("prefix_hit_rate", "cow_copies", "kv_cache_dtype",
              "kv_scale_bytes", "kv_host_pages", "kv_host_used",
              "kv_demotions", "kv_promotions", "kv_cold_hits",
              "kv_promote_failures", "prefill_packed_frames"):
        assert js[k] == ts[k], (k, js[k], ts[k])


def _same_pools(jcache, tcache, mode, scale_rtol):
    """Codes equal or one quantization step apart; scales within
    `scale_rtol` relative."""
    for name in ("k", "v"):
        j = np.asarray(jcache[name]).astype(np.float32)
        t = tcache[name]
        if mode == "fp8":
            t = t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
            # one e4m3 step at value x is at most 2^-3 of |x| (2^-9 among
            # the subnormals)
            step = np.maximum(np.abs(j) / 8, 2.0 ** -9)
        else:
            t, step = t.numpy(), np.ones_like(j)
        assert np.all(np.abs(j - t.astype(np.float32)) <= step), name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]),
                                   rtol=scale_rtol, atol=0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_on_write_equals_jax(models, mode):
    """One packed two-prompt frame and one chunk of a third prompt through
    both models' decode path into quantized pools: codes equal or one step
    apart, scales within 1e-6 relative (K/V come out of fp32 products taken
    in other orders)."""
    jm, tm = models
    cfg = tm.config
    L, hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    d = cfg.hidden_size // cfg.num_attention_heads
    P, ps = 12, 4
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[mode]
    tdt = CODE_DTYPES[mode]
    jc = {n: jnp.zeros((L, hkv, P, ps, d), jdt) for n in ("k", "v")}
    tc = {n: torch.zeros((L, hkv, P, ps, d), dtype=tdt) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        jc[n] = jnp.zeros((L, hkv, P, ps), jnp.float32)
        tc[n] = torch.zeros((L, hkv, P, ps))
    rng = np.random.RandomState(6)
    # a packed frame: prompts of 5 and 7 tokens at 32-aligned rows
    ids = np.zeros((1, 64), np.int32)
    seg = np.full((1, 64), 2, np.int32)
    pos = np.zeros((1, 64), np.int32)
    for j, (off, n) in enumerate(((0, 5), (32, 7))):
        ids[0, off:off + n] = rng.randint(1, 256, n)
        seg[0, off:off + n] = j
        pos[0, off:off + n] = np.arange(n)
    tables = np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0]], np.int32)
    chunk = rng.randint(1, 256, (1, 8)).astype(np.int32)
    row = np.array([[5, 6, 0, 0]], np.int32)
    with torch.inference_mode():
        for call in (
                dict(ids=ids, pt=tables, lens=np.ones(1, np.int32), pos=pos,
                     kw=dict(segment_ids=seg)),
                dict(ids=chunk, pt=row, lens=np.array([8], np.int32),
                     pos=np.arange(8, dtype=np.int32)[None],
                     kw=dict(ctx_pad=16))):
            _, jc = jm.llama.decode_forward(
                paddle.to_tensor(call["ids"]), jc, jnp.asarray(call["pt"]),
                jnp.asarray(call["lens"]), jnp.asarray(call["pos"]),
                **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in call["kw"].items()})
            _, tc = tm.llama.decode_forward(
                torch.from_numpy(call["ids"]).long(), tc,
                torch.from_numpy(call["pt"]), torch.from_numpy(call["lens"]),
                torch.from_numpy(call["pos"]).long(),
                **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                       else v) for k, v in call["kw"].items()})
    # the written slots: 5 + 7 in the frame's pages 1-4, 8 in pages 5-6
    assert int((tc["k_scale"][:, :, 1:7] > 0).sum()) == 20 * L * hkv
    _same_pools(jc, tc, mode, scale_rtol=1e-6)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_engine_equals_jax(models, mode):
    jeng, teng = _engines(models, kv_cache_dtype=mode, prefix_sharing=False,
                          **SMALL)
    assert teng.kv_dtype == CODE_DTYPES[mode]
    assert teng.num_pages == jeng.num_pages
    assert teng.kv_scale_bytes == jeng.kv_scale_bytes > 0
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, n).astype(np.int32)
               for n in (7, 13, 21, 5, 30)]
    _run_both(jeng, teng, prompts, max_new_tokens=8)
    _same_counters(jeng, teng)
    # after 8 decode steps through both 2-layer models the fp32 K/V drift
    # by more ulps than one prefill call's (held to 1e-6 above)
    _same_pools(jeng._cache, teng._cache, mode, scale_rtol=1e-5)
    assert teng.stats()["kv_cache_dtype"] == mode


@pytest.fixture(scope="module")
def bf16_models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(num_key_value_heads=2))
    jm.to(dtype="bfloat16")
    jm.eval()
    named = {n: np.asarray(p._value).astype(np.float32)
             for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(
        num_key_value_heads=2, dtype="bfloat16"), device="cpu")
    return jm, tm


# Both packages round activations, K/V and logits to bf16, in other
# orders: at |logit| near 2 one bf16 step is 2^-6, and the bf16-pool run
# already differs by one such step (0.011 of the row's max); a code one
# step apart (2^-7 of the slot's absmax for int8, 2^-3 of the value for
# e4m3) adds a step or two (int8 0.011, fp8 0.020). A lost or misapplied
# scale moves the logits by their own size.
BF16_LOGIT_RTOL = 2.0 ** -5


@pytest.mark.parametrize("mode", ["model", "int8", "fp8"])
def test_bf16_quantized_decode_logits_equal_jax(bf16_models, mode):
    """The bf16 model over bf16, int8 or fp8 pools, through the three
    paths of the serving forward: a packed two-prompt frame (in-frame K/V
    dequantized in bf16), a chunk of a third prompt (the gathered context
    dequantized in bf16) and a decode step of all three (bf16 q through
    the quantized paged plain version). Every row's logits within
    BF16_LOGIT_RTOL of its max |logit| of the JAX model's."""
    jm, tm = bf16_models
    cfg = tm.config
    L, hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    d = cfg.hidden_size // cfg.num_attention_heads
    P, ps = 12, 4
    jdt = {"model": jnp.bfloat16, "int8": jnp.int8,
           "fp8": jnp.float8_e4m3fn}[mode]
    tdt = dict(CODE_DTYPES, model=torch.bfloat16)[mode]
    jc = {n: jnp.zeros((L, hkv, P, ps, d), jdt) for n in ("k", "v")}
    tc = {n: torch.zeros((L, hkv, P, ps, d), dtype=tdt) for n in ("k", "v")}
    if mode != "model":
        for n in ("k_scale", "v_scale"):
            jc[n] = jnp.zeros((L, hkv, P, ps), jnp.float32)
            tc[n] = torch.zeros((L, hkv, P, ps))
    rng = np.random.RandomState(6)
    ids = np.zeros((1, 64), np.int32)
    seg = np.full((1, 64), 2, np.int32)
    pos = np.zeros((1, 64), np.int32)
    for j, (off, n) in enumerate(((0, 5), (32, 7))):
        ids[0, off:off + n] = rng.randint(1, 256, n)
        seg[0, off:off + n] = j
        pos[0, off:off + n] = np.arange(n)
    calls = [
        dict(ids=ids, pt=np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0]],
                                  np.int32),
             lens=np.ones(1, np.int32), pos=pos, kw=dict(segment_ids=seg)),
        dict(ids=rng.randint(1, 256, (1, 8)).astype(np.int32),
             pt=np.array([[5, 6, 0, 0]], np.int32),
             lens=np.array([8], np.int32),
             pos=np.arange(8, dtype=np.int32)[None], kw=dict(ctx_pad=16)),
        dict(ids=rng.randint(1, 256, (3, 1)).astype(np.int32),
             pt=np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 7, 0]],
                         np.int32),
             lens=np.array([6, 8, 9], np.int32),
             pos=np.array([[5], [7], [8]], np.int32), kw={})]
    with torch.inference_mode():
        for call in calls:
            jl, jc = jm.decode_forward(
                paddle.to_tensor(call["ids"]), jc, jnp.asarray(call["pt"]),
                jnp.asarray(call["lens"]), jnp.asarray(call["pos"]),
                **{k: jnp.asarray(v) for k, v in call["kw"].items()
                   if isinstance(v, np.ndarray)},
                **{k: v for k, v in call["kw"].items()
                   if not isinstance(v, np.ndarray)})
            tl, tc = tm.decode_forward(
                torch.from_numpy(call["ids"]).long(), tc,
                torch.from_numpy(call["pt"]), torch.from_numpy(call["lens"]),
                torch.from_numpy(call["pos"]).long(),
                **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                       else v) for k, v in call["kw"].items()})
            want = np.asarray(jl._value).astype(np.float32)
            got = tl.float().numpy()
            row_err = np.abs(got - want).max(-1)
            assert np.all(row_err <= BF16_LOGIT_RTOL
                          * np.abs(want).max(-1)), row_err.max()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_bf16_quantized_engine_first_tokens_equal_jax(bf16_models, mode):
    """bf16 engines over int8/fp8 pools, port against JAX: equal page
    tables, equal first tokens (the first decode step's argmax, after
    packed and chunked prefill), equal allocator counters. Later tokens
    may part where two logits lie within the bf16 noise held above."""
    jm, tm = bf16_models
    jeng = JaxServingEngine(jm, JaxServingConfig(
        spec_k=0, kv_cache_dtype=mode, prefix_sharing=False, **SMALL))
    teng = ServingEngine(tm, ServingConfig(
        kv_cache_dtype=mode, prefix_sharing=False, **SMALL), device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, n).astype(np.int32)
               for n in (7, 13, 21, 5, 30)]
    jr = [jeng.submit(p, max_new_tokens=4) for p in prompts]
    tr = [teng.submit(p, max_new_tokens=4) for p in prompts]
    while jeng.busy or teng.busy:
        jeng.step()
        teng.step()
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(
                jeng.allocator.page_table_row(a, jeng.pages_per_seq),
                teng.allocator.page_table_row(b, teng.pages_per_seq))
    want = [list(jeng.scheduler.get(r).generated) for r in jr]
    got = [list(teng.scheduler.get(r).generated) for r in tr]
    assert [g[0] for g in got] == [w[0] for w in want]
    assert all(len(g) == 4 for g in got)
    _same_counters(jeng, teng)


def test_quantized_pools_double_the_pages_of_a_budget(models):
    _, tm = models
    kw = dict(SMALL, num_pages=0, hbm_budget_mb=1)
    plain = ServingEngine(tm, ServingConfig(kv_cache_dtype="model", **kw),
                          device="cpu")
    i8 = ServingEngine(tm, ServingConfig(kv_cache_dtype="int8", **kw),
                       device="cpu")
    # fp32 model: 4 bytes a value against 1
    assert i8.num_pages >= 1.9 * plain.num_pages
    # k and v scales: 2 layers x 2 kv heads x 4 slots x 4 bytes a page
    assert i8.kv_scale_bytes == 2 * 2 * 2 * 4 * 4 * i8.num_pages


def test_prefix_sharing_engine_equals_jax(models):
    """Requests sharing a 16-token system prompt: the second admission
    adopts the first's registered pages, prefill covers the tails, and the
    full-match request's last-token rewrite copies its shared page."""
    jeng, teng = _engines(models, prefix_sharing=True, **SMALL)
    rng = np.random.RandomState(4)
    system = rng.randint(1, 256, 16).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, 256, n)
                               .astype(np.int32)]) for n in (5, 11, 0, 3)]
    _run_both(jeng, teng, prompts[:1])              # registers the prompt
    _run_both(jeng, teng, prompts[1:])
    _same_counters(jeng, teng)
    assert teng.allocator.prefix_matches > 0
    assert teng.allocator.cow_copies > 0
    assert teng.stats()["prefix_hit_rate"] > 0
    assert teng.stats()["prefill_tokens"] < sum(p.size for p in prompts)


@pytest.mark.parametrize("mode", ["model", "int8"])
def test_host_tier_engine_equals_jax(models, mode):
    """Fill the pool so a finished request's committed pages demote to the
    host, then re-admit its prompt: the match promotes them and the stream
    is the same, in both packages."""
    jeng, teng = _engines(models, host_cache_mb=64, kv_cache_dtype=mode,
                          **TIGHT)
    assert teng.host_pages == jeng.host_pages > 0
    assert set(teng._host_store) == set(jeng._host_store)
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 256, 12).astype(np.int32)
    fillers = [rng.randint(1, 256, 12).astype(np.int32) for _ in range(2)]
    first = _run_both(jeng, teng, [prompt])[0]
    _run_both(jeng, teng, fillers)
    assert teng.allocator.demotions > 0 and teng.stats()["kv_host_used"] > 0
    again = _run_both(jeng, teng, [prompt])[0]
    assert teng.allocator.promotions > 0
    assert again == first
    _same_counters(jeng, teng)


def test_promote_fail_chaos_equals_jax(models, chaos):
    jeng, teng = _engines(models, host_cache_mb=64, **TIGHT)
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, 256, 12).astype(np.int32)
    fillers = [rng.randint(1, 256, 12).astype(np.int32) for _ in range(2)]
    first = _run_both(jeng, teng, [prompt])[0]
    _run_both(jeng, teng, fillers)
    chaos()
    again = _run_both(jeng, teng, [prompt])[0]
    assert again == first
    assert teng.allocator.promote_failures == 1
    _same_counters(jeng, teng)


def test_tier_round_trip_restores_pages_byte_exact(models):
    """A promoted page holds the demoted page's bytes, codes and scales."""
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(host_cache_mb=64,
                                          kv_cache_dtype="fp8", **TIGHT),
                        device="cpu")
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 256, 13).astype(np.int32)      # 3 full pages
    rid = eng.submit(prompt, max_new_tokens=2)
    eng.step()
    pages = eng.allocator.chain(rid)[:3]
    eng.run_until_idle()
    eng.release(rid)
    snap = {n: a[:, :, pages].clone() for n, a in eng._cache.items()}
    # two 28-token fillers run one after the other (8 of the 11 usable
    # pages each): the second reclaims the oldest cold pages, the prompt's
    eng.generate([rng.randint(1, 256, 28).astype(np.int32)
                  for _ in range(2)], max_new_tokens=4)
    assert eng.allocator.demotions >= 3
    rid = eng.submit(prompt, max_new_tokens=2)
    eng.step()
    assert eng.allocator.promotions >= 3
    new = eng.allocator.chain(rid)[:3]
    for n, a in eng._cache.items():
        assert torch.equal(a[:, :, new].view(torch.uint8)
                           if a.element_size() == 1 else a[:, :, new],
                           snap[n].view(torch.uint8)
                           if a.element_size() == 1 else snap[n]), n
    eng.run_until_idle()


# ---------------------------------------------------------------------------
# visit counters
# ---------------------------------------------------------------------------
def _packed_segments(lens, frame, align=32):
    seg = np.full((1, frame), len(lens), np.int32)
    off = 0
    for j, n in enumerate(lens):
        seg[0, off:off + n] = j
        off += -(-n // align) * align
    return seg


@pytest.mark.parametrize("block_q, block_k", [(64, 32), (32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_visit_counts_equal_jax(block_q, block_k, causal):
    seg = np.concatenate([_packed_segments([17, 60, 100, 30], 256),
                          _packed_segments([200, 5], 256),
                          np.zeros((1, 256), np.int32)])
    want = np.asarray(jax_segment_visits(seg, block_q, block_k,
                                         causal=causal, interpret=True))
    got = segment_block_visit_counts(torch.from_numpy(seg), block_q,
                                     block_k, causal)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        segment_block_visit_reference(torch.from_numpy(seg), block_q,
                                      block_k, causal).numpy(), want)


def test_flash_visit_counts_need_whole_blocks():
    with pytest.raises(ValueError, match="multiple"):
        segment_block_visit_counts(torch.zeros((1, 96), dtype=torch.int32))


def test_page_visit_counts_equal_closed_form():
    lens = np.array([0, 1, 15, 16, 17, 100, 255, 256], np.int32)
    got = page_visit_counts(torch.from_numpy(lens), 16, 16)
    np.testing.assert_array_equal(got.numpy(), -(-lens // 16))
    # rows longer than the table are bounded by pages_per_seq
    got = page_visit_counts(torch.from_numpy(lens), 16, 4)
    np.testing.assert_array_equal(got.numpy(), np.minimum(-(-lens // 16), 4))


def test_engine_packed_frame_segments_count_visits(models):
    """The segment ids a packed prefill frame hands the model are the
    32-row aligned layout, and the flash visit counter over them, at
    the fp32 kernel's 64 x 32 blocks, admits both K blocks of the frame's
    causal pair."""
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(**dict(SMALL, pack_frame=64,
                                                 prefill_chunk=16)),
                        device="cpu")
    frames = []
    forward = tm.llama.decode_forward

    def record(*args, segment_ids=None, **kw):
        if segment_ids is not None:
            frames.append(segment_ids.clone())
        return forward(*args, segment_ids=segment_ids, **kw)

    tm.llama.decode_forward = record
    try:
        eng.generate([np.arange(1, 6, dtype=np.int32),
                      np.arange(20, 32, dtype=np.int32)], max_new_tokens=2)
    finally:
        del tm.llama.decode_forward
    assert eng.stats()["prefill_packed_frames"] == len(frames) == 1
    np.testing.assert_array_equal(frames[0].numpy(),
                                  _packed_segments([5, 12], 64))
    counts = segment_block_visit_counts(frames[0], 64, 32)
    assert counts.shape == (1, 1) and int(counts[0, 0]) == 2
