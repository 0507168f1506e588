"""The numerics of the flash backward's tensor-core (bf16) kernels, on the
CPU.

The bf16 kernels of ``paddle_tpu_torch/ops/cuda/csrc/flash_bwd.cu`` compute
S = (Q·Kᵀ)·scale and dP = dO·Vᵀ as exact bf16 products summed in fp32, then
round P (for dV = Pᵀ·dO) and P·(dP − delta) (for dQ and dK) to bf16 before
the second products, and scale dQ and dK in fp32 at the end. The kernels
run only on the card (``chip_smoke.py``); ``_bwd_bf16_rounded`` below
evaluates the plain formulas with the rounding exactly where the kernels
round, so the rounding choice is held here to ``chip_smoke.py``'s bf16
rule: every row (one head of one position, over head_dim) within 2^-7 of
its own max |ref| plus 1e-6, and the whole output within 1e-2.

* small sizes (S 48-256; causal, GQA 4:1, a packed frame of 3 segments,
  head_dim 64 and 128): against ``jax.grad`` through the Pallas
  ``flash_attention_bhsd`` in interpret mode (the dq and dkv kernels
  themselves);
* S 1024 causal and a ragged S of 1000: against the port's fp32 plain
  version ``flash_attention_bwd_reference``, which
  ``test_torch_port_train_kernels.py`` holds against JAX (interpret mode
  is too slow at these lengths).

Inputs are bf16-representable values made with numpy from a seed, std 0.5
as ``chip_smoke.py`` draws them.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import flash_attention_bhsd
from paddle_tpu_torch.ops.cuda.flash_attention import (
    _mask, flash_attention_bwd_reference, flash_attention_reference)

ROW_RTOL = 2.0 ** -7      # chip_smoke.py RTOL["bfloat16"]
ROW_ATOL = 1e-6           # chip_smoke.py ATOL
WHOLE_TOL = 1e-2          # chip_smoke.py TOL["bfloat16"]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bwd_bf16_rounded(q, k, v, out, lse, do, causal, segment_ids=None):
    """(dq, dk, dv) fp32 as the bf16 kernels compute them: fp32 P and
    dP, then P and P·(dP − delta) rounded to bf16 for the products with
    dO, K and Q, and dq, dk scaled at the end. Arguments as
    ``flash_attention_bwd_reference`` (fp32 tensors)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)

    def heads(t, n):                     # [B, S, H, D] -> [B, Hkv, n, S, D]
        return t.permute(0, 2, 1, 3).reshape(b, hkv, n, s, d)

    qf, dof, of = heads(q, g), heads(do, g), heads(out, g)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    delta = (dof * of).sum(-1, keepdim=True)
    valid = _mask(s, causal, segment_ids, q.device)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qf, kf) * scale
    p = torch.where(valid, torch.exp(scores - lse.reshape(b, hkv, g, s, 1)),
                    torch.zeros(()))
    dp = torch.einsum("bhgsd,bhtd->bhgst", dof, vf)
    ds = _bf16(p * (dp - delta))
    p = _bf16(p)
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, kf) * scale
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qf) * scale
    dv = torch.einsum("bhgst,bhgsd->bhtd", p, dof)

    def back(t, n):
        return t.reshape(b, n, s, d).permute(0, 2, 1, 3)

    return back(dq, hq), back(dk, hkv), back(dv, hkv)


def _inputs(seed, b, s, hq, hkv, d, nseg):
    rng = np.random.RandomState(seed)

    def draw(h):
        x = rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
        return _bf16(torch.from_numpy(x))

    q, k, v, do = draw(hq), draw(hkv), draw(hkv), draw(hq)
    seg = None
    if nseg:
        # packed rows: nseg documents with boundaries off the 64-row tiles
        cuts = np.sort(rng.choice(np.arange(1, s), nseg - 1, replace=False))
        seg = torch.from_numpy(
            np.searchsorted(cuts, np.arange(s), side="right")
            .astype(np.int32)[None].repeat(b, 0))
    return q, k, v, do, seg


def _hold(got, ref, name):
    err = (got - ref).abs()
    row_err, row_max = err.amax(-1), ref.abs().amax(-1)
    bad = row_err > ROW_RTOL * row_max + ROW_ATOL
    assert not bool(bad.any()), (
        f"d{name}: {int(bad.sum())} rows over 2^-7 of their max |ref|, "
        f"worst {float((row_err / row_max.clamp_min(ROW_ATOL)).max()):.3g}")
    assert float(err.max()) <= WHOLE_TOL, f"d{name}: {float(err.max())}"


def _jax_grads(q, k, v, do, causal, seg):
    """jax.grad of sum(out * do) through the Pallas kernels (interpret)."""
    t = lambda a: jnp.asarray(np.swapaxes(a.numpy(), 1, 2))  # [B, H, S, D]

    def f(qh, kh, vh):
        out = flash_attention_bhsd(qh, kh, vh, causal=causal,
                                   segment_ids=None if seg is None
                                   else jnp.asarray(seg.numpy()),
                                   interpret=True)
        return jnp.sum(out * t(do))

    grads = jax.grad(f, argnums=(0, 1, 2))(t(q), t(k), t(v))
    return [torch.from_numpy(np.swapaxes(np.asarray(g), 1, 2).copy())
            for g in grads]


SMALL = {
    "causal_s128_d128": dict(b=1, s=128, hq=2, hkv=2, d=128, causal=True,
                             nseg=0),
    "causal_s256_d64": dict(b=1, s=256, hq=2, hkv=2, d=64, causal=True,
                            nseg=0),
    "gqa4_s128_d128": dict(b=1, s=128, hq=4, hkv=1, d=128, causal=True,
                           nseg=0),
    "packed3_gqa4_s192_d64": dict(b=2, s=192, hq=4, hkv=1, d=64,
                                  causal=True, nseg=3),
    "noncausal_s48_d64": dict(b=1, s=48, hq=2, hkv=2, d=64, causal=False,
                              nseg=0),
}


@pytest.mark.parametrize("case", list(SMALL.values()), ids=list(SMALL))
def test_bf16_rounding_holds_against_jax_grad_interpret(case):
    c = dict(case)
    causal = c.pop("causal")
    q, k, v, do, seg = _inputs(7, **c)
    want = _jax_grads(q, k, v, do, causal, seg)
    out, lse = flash_attention_reference(q, k, v, causal=causal,
                                         segment_ids=seg)
    got = _bwd_bf16_rounded(q, k, v, out, lse, do, causal, seg)
    for name, g, w in zip("qkv", got, want):
        _hold(g, w, name)


LONG = {
    "causal_s1024_d128": dict(b=1, s=1024, hq=2, hkv=2, d=128, nseg=0),
    "ragged_s1000_gqa2_d128": dict(b=1, s=1000, hq=2, hkv=1, d=128, nseg=0),
    "ragged_s1000_packed3_d64": dict(b=1, s=1000, hq=2, hkv=2, d=64, nseg=3),
}


@pytest.mark.parametrize("case", list(LONG.values()), ids=list(LONG))
def test_bf16_rounding_holds_against_fp32_plain_version(case):
    q, k, v, do, seg = _inputs(11, **case)
    out, lse = flash_attention_reference(q, k, v, causal=True,
                                         segment_ids=seg)
    out = _bf16(out)               # the forward kernel's bf16 output
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True,
                                         segment_ids=seg)
    got = _bwd_bf16_rounded(q, k, v, out, lse, do, True, seg)
    for name, g, w in zip("qkv", got, want):
        _hold(g, w, name)
    # the rounding is really there: the two differ beyond fp32 noise
    assert float((got[2] - want[2]).abs().max()) > 1e-5
