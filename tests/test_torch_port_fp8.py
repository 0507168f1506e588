"""The port's fp8 matmuls (``amp.fp8``) against the JAX package's, on the
CPU (the products run the plain version: the codes widened to fp32).

* quantized codes bit-equal to JAX's (compared as uint8) for e4m3 and
  e5m2, with values past the format's max and scales from histories of
  zeros, inf and NaN; ``delayed_scale``/``update_history`` equal;
* ``fp8_matmul``, and ``fp8_dot`` (delayed) and ``fp8_dot_current``
  forward, dx and dW, within 1e-5 relative (of each tensor's max
  |value|) of JAX's (``jax.vjp``) on the same inputs and histories, and
  the updated histories equal (JAX returns them as the cotangents of the
  histories);
* the fused CE under ``matmuls+head`` (``Fp8LinearCrossEntropy``) at V
  1000 with a ragged last token chunk: per-token loss, dx and dW within
  1e-4 relative (of each tensor's max |value|) of JAX's ``tokens`` variant
  under ``fp8_autocast('matmuls+head')``, and neither ``ce_stats`` nor
  ``ce_bwd`` called.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.amp import fp8 as jfp8
from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy_loss
from paddle_tpu_torch.amp import fp8
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import fused_ce

HISTS = {
    "zeros": np.zeros(8, np.float32),
    "small": np.array([0.5, 3.0, 0.25, 0, 0, 0, 0, 0], np.float32),
    "inf": np.array([1.0, np.inf, 2.0, 0, 0, 0, 0, 0], np.float32),
    "nan": np.array([np.nan, 4.0, 0, 0, 0, 0, 0, 0], np.float32),
    "large": np.array([700.0, 6e4, 0, 0, 0, 0, 0, 0], np.float32),
}
FORMATS = {"e4m3": (fp8.E4M3, jnp.float8_e4m3fn, fp8.E4M3_MAX),
           "e5m2": (fp8.E5M2, jnp.float8_e5m2, fp8.E5M2_MAX)}


def _values(seed=0):
    rng = np.random.RandomState(seed)
    v = (rng.standard_normal(4096) * 50).astype(np.float32)
    v[:6] = [1e6, -1e6, 448.5, -57345.0, 1e-9, 0.0]   # past the max, tiny
    return v


@pytest.mark.parametrize("hist", sorted(HISTS))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_codes_bit_equal_jax(fmt, hist):
    tdt, jdt, fmax = FORMATS[fmt]
    v, h = _values(), HISTS[hist]
    js = jfp8.delayed_scale(jnp.asarray(h), fmax)
    ts = fp8.delayed_scale(torch.from_numpy(h), fmax)
    assert float(ts) == float(js)
    want = np.asarray(jfp8._quant(jnp.asarray(v), js, fmax, jdt)).view(
        np.uint8)
    got = fp8.quantize(torch.from_numpy(v), ts, fmax, tdt).view(
        torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    # and the current scale of the values themselves
    js, ts = jfp8._current_scale(jnp.asarray(v), fmax), \
        fp8.current_scale(torch.from_numpy(v), fmax)
    assert float(ts) == float(js)
    # update_history with a finite, an inf and a nan amax
    for amax in (17.5, np.inf, np.nan):
        np.testing.assert_array_equal(
            fp8.update_history(torch.from_numpy(h),
                               torch.tensor(amax)).numpy(),
            np.asarray(jfp8.update_history(jnp.asarray(h),
                                           jnp.float32(amax))))


def _rel(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


@pytest.mark.parametrize("delayed", [True, False], ids=["delayed",
                                                        "current"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_dot_matches_jax(delayed, dtype):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 24, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.1).astype(np.float32)  # [K, N]
    g = (rng.standard_normal((2, 24, 40)) * 1e-3).astype(np.float32)
    hist = {"x": np.array([3.5, 2.0, 0, 0], np.float32),
            "w": np.array([0.2, 0.5, 0, 0], np.float32),
            "g": np.array([np.inf, 2e-3, 0, 0], np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx, jw, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, g))
    if delayed:
        hs = tuple(jnp.asarray(hist[k]) for k in ("x", "w", "g"))
        out, vjp = jax.vjp(lambda a, b, *h: jfp8.fp8_dot(a, b, *h), jx, jw,
                           *hs)
        jdx, jdw, nhx, nhw, nhg = vjp(jg)
    else:
        out, vjp = jax.vjp(jfp8.fp8_dot_current, jx, jw)
        jdx, jdw = vjp(jg)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32)).T.copy()).to(
        tdt)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    st = {k: torch.from_numpy(hist[k].copy()) for k in hist}
    y = fp8.fp8_dot(tx, tw, st) if delayed else fp8.fp8_dot_current(tx, tw)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(np.array(jg.astype(jnp.float32))).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    _rel(y.float().detach().numpy(), np.asarray(out, np.float32), tol, "y")
    _rel(tx.grad.float().numpy(), np.asarray(jdx, np.float32), tol, "dx")
    _rel(tw.grad.float().numpy().T, np.asarray(jdw, np.float32), tol, "dw")
    if delayed:
        for k, nh in (("x", nhx), ("w", nhw), ("g", nhg)):
            np.testing.assert_array_equal(st["n" + k].numpy(),
                                          np.asarray(nh), err_msg=k)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_ce_matmuls_head_matches_jax(smoothing):
    rng = np.random.RandomState(2)
    n, h, v, chunk = 100, 64, 1000, 48          # chunks 48, 48, 4
    x = rng.standard_normal((n, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.05).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[::7] = -100
    ct = rng.uniform(0.5, 1.5, n).astype(np.float32)

    def jloss(a, b):
        with jfp8.fp8_autocast("matmuls+head"):
            return fused_linear_cross_entropy_loss(
                a, b, jnp.asarray(labels), chunk_tokens=chunk,
                label_smoothing=smoothing, variant="tokens")

    jl, vjp = jax.vjp(jloss, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(ct))
    fused_ce.reset_launches()
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w.T.copy()).requires_grad_(True)
    with fp8.fp8_autocast("matmuls+head"):
        tl = F.fused_linear_cross_entropy(
            tx, tw, torch.from_numpy(labels), reduction="none",
            label_smoothing=smoothing, chunk_tokens=chunk)
    tl.backward(torch.from_numpy(ct))
    assert fused_ce.launch_counts() == {"ce_stats": 0, "ce_bwd": 0}
    _rel(tl.detach().numpy(), np.asarray(jl), 1e-4, "loss")
    _rel(tx.grad.numpy(), np.asarray(jdx), 1e-4, "dx")
    _rel(tw.grad.numpy().T, np.asarray(jdw), 1e-4, "dw")
    # the same call without the session is the unquantized loss
    with torch.no_grad():
        plain = F.fused_linear_cross_entropy(
            tx, tw, torch.from_numpy(labels), reduction="none",
            label_smoothing=smoothing, chunk_tokens=chunk)
    assert not torch.equal(plain, tl.detach())


def test_fp8_matmul_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.standard_normal((40, 64)).astype(np.float32)
    b = (rng.standard_normal((64, 24)) * 3).astype(np.float32)
    for a_dt, ja_dt in ((None, None), (fp8.E5M2, jnp.float8_e5m2)):
        want = np.asarray(jfp8.fp8_matmul(jnp.asarray(a), jnp.asarray(b),
                                          a_dtype=ja_dt))
        got = fp8.fp8_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             a_dtype=a_dt).numpy()
        _rel(got, want, 1e-5)


def test_policies_and_sessions():
    assert fp8.normalize_fp8_policy(None) == "none"
    assert fp8.normalize_fp8_policy(True) == "matmuls"
    with pytest.raises(ValueError):
        fp8.normalize_fp8_policy("all")
    x, w = torch.ones(2, 16), torch.ones(8, 16)
    with fp8.fp8_execution("matmuls") as s:
        assert fp8.linear_fp8_enabled(x, w) and not fp8.head_fp8_enabled()
        with fp8.head_scope():
            assert not fp8.linear_fp8_enabled(x, w)
        assert s.next_state() is None           # stateless: current scaling
    with fp8.fp8_execution("matmuls+head", states=[], record=True) as s:
        with fp8.head_scope():
            assert fp8.linear_fp8_enabled(x, w) and fp8.head_fp8_enabled()
        a, b = s.next_state(), s.next_state()
        assert len(s.states) == 2 and a is not b
        with s.rewind(0):
            assert s.next_state() is a
        assert s.cursor == 2
    with fp8.fp8_execution("matmuls", states=[a]) as s:
        s.next_state()
        with pytest.raises(RuntimeError, match="diverged"):
            s.next_state()
    assert fp8.current_session() is None
    assert ml_dtypes.float8_e4m3fn(448.0) == fp8.E4M3_MAX
