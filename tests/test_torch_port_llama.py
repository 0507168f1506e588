"""The port's LLaMA against the JAX package on the CPU, same weights:
``from_paddle_tpu_params`` on a ``llama_tiny_config(num_key_value_heads=2)``
JAX model, then full-sequence logits, and ``decode_forward`` prefill
(chunked and packed) followed by decode steps over the paged cache, all
fp32 <= 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.parallel.train_step import functional_call
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu_torch.models import from_paddle_tpu_params, llama_tiny_config
from paddle_tpu_torch.models.llama import LlamaForCausalLM

TOL = 1e-4
PS, PAGES = 4, 12            # page size, pool pages (incl. the null page)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(num_key_value_heads=2))
    jm.eval()
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(
        num_key_value_heads=2), device="cpu")
    return jm, tm


def _cache(cfg):
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, PAGES, PS, hd)
    return np.zeros(shape, np.float32)


_jitted = {}


def _jax_decode(jm, cache, ids, pt, lens, pos, ctx_pad=None, **kw):
    """The JAX decode_forward, jitted as the JAX engine runs it (eager
    dispatch compiles every op of every new shape one by one)."""
    if ctx_pad not in _jitted:
        def fn(params, cache, ids, pt, lens, pos, kw):
            logits, cache = functional_call(
                jm, params, (ids,), dict(cache=cache, page_table=pt,
                                         context_lens=lens,
                                         position_ids=pos, ctx_pad=ctx_pad,
                                         **kw),
                training=False, method="decode_forward")
            return logits._value, cache

        _jitted[ctx_pad] = jax.jit(fn)
    params = [p._value for p in jm.parameters()]
    logits, cache = _jitted[ctx_pad](
        params, cache, jnp.asarray(ids), jnp.asarray(pt), jnp.asarray(lens),
        jnp.asarray(pos), {k: jnp.asarray(v) for k, v in kw.items()})
    return np.asarray(logits), cache


def _port_decode(tm, cache, ids, pt, lens, pos, **kw):
    t = lambda a: torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        logits, cache = tm.decode_forward(
            t(ids), cache, t(pt), t(lens), t(pos),
            **{k: (t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
    return logits.numpy(), cache


def test_convert_transposes_linears(pair):
    jm, tm = pair
    jw = np.asarray(dict(jm.named_parameters())[
        "llama.layers.0.self_attn.k_proj.weight"]._value)
    tw = tm.llama.layers[0].self_attn.k_proj.weight.detach().numpy()
    assert jw.shape == (64, 32) and tw.shape == (32, 64)
    np.testing.assert_array_equal(jw.T, tw)


def test_convert_rejects_missing_names(pair):
    jm, _ = pair
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    named.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        from_paddle_tpu_params(named, llama_tiny_config(
            num_key_value_heads=2), device="cpu")


def test_full_sequence_logits(pair):
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 256, (2, 24)).astype(np.int64)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_chunked_prefill_then_decode_logits(pair):
    jm, tm = pair
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 256, 10).astype(np.int64)
    pt = np.array([[3, 7, 1, 9, 0, 0]], np.int32)
    jc = {"k": jnp.zeros(_cache(tm.config).shape),
          "v": jnp.zeros(_cache(tm.config).shape)}
    tc = {"k": torch.zeros(_cache(tm.config).shape),
          "v": torch.zeros(_cache(tm.config).shape)}
    # two chunks: 8 tokens (ctx_pad 8), then 2 tokens padded to 4 (ctx 16)
    for off, cpad, ctx_pad in ((0, 8, 8), (8, 4, 16)):
        t = min(cpad, 10 - off)
        ids = np.zeros((1, cpad), np.int64)
        ids[0, :t] = prompt[off:off + t]
        pos = np.minimum(off + np.arange(cpad), 6 * PS - 1)[None]
        lens = np.array([off + t], np.int32)
        want, jc = _jax_decode(jm, jc, ids, pt, lens, pos, ctx_pad=ctx_pad)
        got, tc = _port_decode(tm, tc, ids, pt, lens, pos, ctx_pad=ctx_pad)
        np.testing.assert_allclose(got[0, :t], want[0, :t], atol=TOL, rtol=0)
    # decode: the last prompt token is re-fed at its own position, then
    # two generated tokens
    toks = [int(prompt[-1]), 17, 99]
    for i, tok in enumerate(toks):
        n = 10 + i
        ids = np.array([[tok], [0]], np.int64)
        pt2 = np.concatenate([pt, np.zeros_like(pt)])
        lens = np.array([n, 0], np.int32)
        pos = np.array([[n - 1], [0]], np.int64)
        want, jc = _jax_decode(jm, jc, ids, pt2, lens, pos)
        got, tc = _port_decode(tm, tc, ids, pt2, lens, pos)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    live = [3, 7, 1]                  # pages holding positions 0..11
    np.testing.assert_allclose(tc["k"][:, :, live].numpy(),
                               np.asarray(jc["k"])[:, :, live], atol=TOL,
                               rtol=0)


def test_packed_prefill_frame_logits_and_pages(pair):
    jm, tm = pair
    rng = np.random.RandomState(2)
    lens_ = [5, 11]
    frame, align = 64, 32
    ids = np.zeros((1, frame), np.int64)
    seg = np.full((1, frame), frame // align, np.int32)
    pos = np.zeros((1, frame), np.int64)
    tables = np.zeros((frame // align + 1, frame // PS), np.int32)
    chains = [[2, 5], [4, 8, 10]]
    off = 0
    for j, n in enumerate(lens_):
        ids[0, off:off + n] = rng.randint(1, 256, n)
        seg[0, off:off + n] = j
        pos[0, off:off + n] = np.arange(n)
        tables[j, :len(chains[j])] = chains[j]
        off += align
    jc = {"k": jnp.zeros(_cache(tm.config).shape),
          "v": jnp.zeros(_cache(tm.config).shape)}
    tc = {"k": torch.zeros(_cache(tm.config).shape),
          "v": torch.zeros(_cache(tm.config).shape)}
    one = np.ones(1, np.int32)
    want, jc = _jax_decode(jm, jc, ids, tables, one, pos, segment_ids=seg)
    got, tc = _port_decode(tm, tc, ids, tables, one, pos, segment_ids=seg)
    real = seg[0] < frame // align
    np.testing.assert_allclose(got[0, real], want[0, real], atol=TOL, rtol=0)
    live = [2, 5, 4, 8, 10]
    np.testing.assert_allclose(tc["v"][:, :, live].numpy(),
                               np.asarray(jc["v"])[:, :, live], atol=TOL,
                               rtol=0)


def test_functional_ops_match_jax():
    import paddle_tpu.nn.functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.RandomState(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)     # paddle [in, out]
    g = rng.standard_normal(16).astype(np.float32)
    ids = rng.randint(0, 8, (2, 4))
    table = rng.standard_normal((8, 16)).astype(np.float32)
    jt = paddle.to_tensor
    tt = torch.from_numpy
    pairs = [
        (JF.linear(jt(x), jt(w)), TF.linear(tt(x), tt(w.T.copy()))),
        (JF.embedding(jt(ids), jt(table)), TF.embedding(tt(ids), tt(table))),
        (JF.rms_norm(jt(x), jt(g), 1e-5), TF.rms_norm(tt(x), tt(g), 1e-5)),
        (JF.silu(jt(x)), TF.silu(tt(x))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   atol=TOL, rtol=0)
    with pytest.raises(NotImplementedError):
        TF.scaled_dot_product_attention(tt(x[None]), tt(x[None]),
                                        tt(x[None]), attn_mask=tt(x))
    with pytest.raises(NotImplementedError):
        TF.scaled_dot_product_attention(tt(x[None]), tt(x[None]),
                                        tt(x[None]), dropout_p=0.1)


def test_rope_limit_raises():
    m = LlamaForCausalLM(llama_tiny_config(max_position_embeddings=16),
                         device="cpu", seed=0)
    with pytest.raises(ValueError, match="rope_max_position"):
        m(torch.zeros(1, 17, dtype=torch.int64))
    with pytest.raises(ValueError, match="rope_max_position"):
        m(torch.zeros(1, 4, dtype=torch.int64),
          position_ids=torch.full((1, 4), 16))


def test_seeded_init_is_reproducible():
    a = LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=3)
    b = LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
