"""The numerics of the flash forward's tensor-core (bf16) kernel, on the CPU.

The bf16 kernel of ``paddle_tpu_torch/ops/cuda/csrc/flash_fwd.cu`` walks
64-key K/V tiles with an online softmax held in its fp32 accumulators: S =
Q·Kᵀ as exact bf16 products summed in fp32, scaled in fp32 (exp2 with
scale·log2(e) folded in); a running max m and, per tile, alpha = exp(m_old
− m_new) rescaling the running sum l and the output; P rounded to bf16 for
P·V while l sums the unrounded fp32 P; the output normalised by 1/l in
fp32 and rounded to bf16 once; lse = m + log(l). The kernel runs only on
the card (``chip_smoke.py``); ``_fwd_bf16_tiled`` below runs the same
recurrence with the rounding exactly where the kernel rounds, so the
design is held here to ``chip_smoke.py``'s bf16 rule: every row (one head
of one position, over head_dim) within 2^-7 of its own max |ref| plus
1e-6, the whole output within 1e-2, and lse within 1e-3.

* small sizes (S 48-256; causal, non-causal, GQA 4:1, a packed frame of 3
  segments with boundaries off the tiles, head_dim 64 and 128): against
  the Pallas ``_fwd_kernel`` in interpret mode (``flash_attention_bhsd``
  for the output, ``_flash_fwd``, which launches the kernel, for lse);
* S 1024 causal and a ragged S of 1000: against the port's fp32 plain
  version ``flash_attention_reference`` (interpret mode is too slow at
  these lengths).

The plain versions in ``ops/cuda/flash_attention.py`` stay fp32; the
tiled helper lives here. Inputs are bf16-representable values made with
numpy from a seed, std 0.5 as ``chip_smoke.py`` draws them.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd,
                                                   flash_attention_bhsd)
from paddle_tpu_torch.ops.cuda.flash_attention import (
    FWD_BLOCK_K, _mask, flash_attention_reference)

ROW_RTOL = 2.0 ** -7      # chip_smoke.py RTOL["bfloat16"]
ROW_ATOL = 1e-6           # chip_smoke.py ATOL
WHOLE_TOL = 1e-2          # chip_smoke.py TOL["bfloat16"]
LSE_TOL = 1e-3            # chip_smoke.py run_flash_case
LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fwd_bf16_tiled(q, k, v, causal, segment_ids=None, block_k=FWD_BLOCK_K):
    """(out [B, S, Hq, D] bf16-valued fp32, lse [B, Hq, S] fp32) as the bf16
    kernel computes them, one 64-key tile at a time. q, k, v: fp32 tensors
    [B, S, H, D] holding bf16-representable values."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * LOG2E
    qh = q.permute(0, 2, 1, 3).reshape(b, hkv, g, s, d)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    valid = _mask(s, causal, segment_ids, q.device)    # [B|1, 1, 1, S, S]
    m = torch.full((b, hkv, g, s, 1), NEG_INF)   # running max, raw scores
    l = torch.zeros((b, hkv, g, s, 1))
    acc = torch.zeros((b, hkv, g, s, d))
    for k0 in range(0, s, block_k):
        sc = torch.einsum("bhgsd,bhtd->bhgst", qh, kh[:, :, k0:k0 + block_k])
        vis = valid[..., k0:k0 + block_k]
        mx = torch.maximum(m, torch.where(vis, sc, NEG_INF)
                           .amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * sl2)
        p = torch.where(vis, torch.exp2(sc * sl2 - mx * sl2),
                        torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd", _bf16(p),
                                         vh[:, :, k0:k0 + block_k])
        m = mx
    lc = l.clamp_min(1e-30)
    out = _bf16(acc / lc).reshape(b, hq, s, d).permute(0, 2, 1, 3)
    lse = (m * scale + torch.log(lc)).reshape(b, hq, s)
    return out, lse


def _inputs(seed, b, s, hq, hkv, d, nseg):
    rng = np.random.RandomState(seed)

    def draw(h):
        x = rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
        return _bf16(torch.from_numpy(x))

    q, k, v = draw(hq), draw(hkv), draw(hkv)
    seg = None
    if nseg:
        # packed rows: nseg documents with boundaries off the 64-key and
        # 128-row tiles
        cuts = np.sort(rng.choice(np.arange(1, s), nseg - 1, replace=False))
        seg = torch.from_numpy(
            np.searchsorted(cuts, np.arange(s), side="right")
            .astype(np.int32)[None].repeat(b, 0))
    return q, k, v, seg


def _hold(out, lse, ref, ref_lse):
    err = (out - ref).abs()
    row_err, row_max = err.amax(-1), ref.abs().amax(-1)
    bad = row_err > ROW_RTOL * row_max + ROW_ATOL
    assert not bool(bad.any()), (
        f"{int(bad.sum())} rows over 2^-7 of their max |ref|, worst "
        f"{float((row_err / row_max.clamp_min(ROW_ATOL)).max()):.3g}")
    assert float(err.max()) <= WHOLE_TOL, float(err.max())
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL


def _jax_fwd(q, k, v, causal, seg):
    """(out [B, S, Hq, D], lse [B, Hq, S]) of the Pallas forward kernel in
    interpret mode, fp32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    t = lambda a: jnp.asarray(np.swapaxes(a.numpy(), 1, 2))  # [B, H, S, D]
    jseg = None if seg is None else jnp.asarray(seg.numpy())
    out = flash_attention_bhsd(t(q), t(k), t(v), causal=causal,
                               segment_ids=jseg, interpret=True)
    _, lse = _flash_fwd(t(q).reshape(b * hq, s, d),
                        t(k).reshape(b * hkv, s, d),
                        t(v).reshape(b * hkv, s, d), jseg, causal,
                        1.0 / math.sqrt(d), hq // hkv, hq, True)
    return (torch.from_numpy(np.swapaxes(np.asarray(out), 1, 2).copy()),
            torch.from_numpy(np.asarray(lse).reshape(b, hq, s).copy()))


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
    "noncausal_s256_d128": dict(b=1, s=256, hq=2, hkv=2, d=128,
                                causal=False, nseg=0),
}


@pytest.mark.parametrize("case", list(SMALL.values()), ids=list(SMALL))
def test_bf16_tiles_hold_against_pallas_interpret(case):
    c = dict(case)
    causal = c.pop("causal")
    q, k, v, seg = _inputs(7, **c)
    ref, ref_lse = _jax_fwd(q, k, v, causal, seg)
    out, lse = _fwd_bf16_tiled(q, k, v, causal, seg)
    _hold(out, lse, ref, ref_lse)


LONG = {
    "causal_s1024_d128": dict(b=1, s=1024, hq=2, hkv=2, d=128, nseg=0),
    "ragged_s1000_gqa2_d128": dict(b=1, s=1000, hq=2, hkv=1, d=128, nseg=0),
    "ragged_s1000_packed3_d64": dict(b=1, s=1000, hq=2, hkv=2, d=64, nseg=3),
}


@pytest.mark.parametrize("case", list(LONG.values()), ids=list(LONG))
def test_bf16_tiles_hold_against_fp32_plain_version(case):
    q, k, v, seg = _inputs(11, **case)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                             segment_ids=seg)
    out, lse = _fwd_bf16_tiled(q, k, v, True, seg)
    _hold(out, lse, ref, ref_lse)
    # the rounding of P is really there: the output differs from the fp32
    # plain version's rounded to bf16
    assert float((out - _bf16(ref)).abs().max()) > 0
