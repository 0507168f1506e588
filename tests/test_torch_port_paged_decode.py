"""The numerics of the paged decode's tensor-core (bf16 q) kernel, on the CPU.

``paged_decode_kernel_mma`` of ``paddle_tpu_torch/ops/cuda/csrc/
paged_attention.cu`` cuts each row's keys into 256-key splits and each
split into 16-key stages; consumer warp w of 4 takes stages w, w + 4, ...
and keeps its own online softmax: S = Q·Kᵀ as exact bf16 products summed in
fp32, for int8/fp8 pools times the key's fp32 scale (s_j = (q·c_j)·ks_j);
exp2 with scale·log2(e) folded in; P rounded to bf16 for P·V while l sums
the unrounded fp32 p_j. Against the codes of a quantized pool, P·V takes
p_j·vs_j as two bf16 pieces, hi = bf16(p_j·vs_j) and lo = bf16(p_j·vs_j −
hi): one piece alone would add up to 2^-9 of a value to the output's own
rounding, past the quantized rule below (a check here shows it).
The warps merge in warp order, each scaled by exp2((m_w − M)·scale·log2 e),
and ``paged_combine_kernel`` merges the splits in split order. The kernel
runs only on the card (``chip_smoke.py``); ``_kernel_schedule`` below runs
the same schedule with the rounding where the kernel rounds, and is held
here to ``chip_smoke.py``'s rules against the JAX package's
``paged_attention_reference`` (the Pallas ``_decode_kernel`` cannot run on
this tree's jax, whose ``x64_off`` import fails):

* bf16 pools: every row (one head of one query, over head_dim) within 2^-7
  of its own max |ref| plus 1e-6, and the whole output within 1e-2;
* int8 and fp8 pools: the same row rule, and the error beyond 2^-8 of
  |ref| (bf16 rounding of the output) within 1e-3.

Two exact checks beside: every int8 code and every finite e4m3 code widens
to bf16 exactly, by the kernel's own routes (the fp32 magic-number trick,
the e4m3 -> f16 conversion); and the stages the schedule reads cover
exactly the pages that ``page_visit_reference`` counts. The port's plain
version ``paged_attention_reference`` stays fp32. Inputs are made with
numpy from a seed.
"""
import math
import re

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention_reference as jax_paged_reference
from paddle_tpu_torch.ops.cuda import paged_attention as pa

ROW_RTOL = 2.0 ** -7      # chip_smoke.py RTOL["bfloat16"]
ROW_ATOL = 1e-6           # chip_smoke.py ATOL
WHOLE_TOL = 1e-2          # chip_smoke.py TOL["bfloat16"]
QUANT_EXCESS = 1e-3       # chip_smoke.py QBF16_EXCESS
LOG2E = 1.4426950408889634
NEG_INF = -1e30
SPLIT_KEYS = 256          # paged_attention.cu kMmaSplitKeys
STAGE_KEYS = 16           # kStageKeys
CONSUMERS = 4             # kConsumers


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _kernel_schedule(q, kp, vp, pt, lens, ks=None, vs=None, pieces=2):
    """(out [B, T, Hq, D] bf16-valued fp32, pages read: one set of page-
    table indices a row) as the tensor-core kernel computes them. q: fp32
    [B, T, Hq, D] holding bf16 values; kp/vp: fp32 [Hkv, P, ps, D] (bf16
    values, or codes when the [Hkv, P, ps] scales ks/vs are given);
    `pieces`: the bf16 pieces of p_j vs_j (the kernel's 2, or 1)."""
    nb, nt, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    group, pps = hq // hkv, pt.shape[1]
    tg = nt * group
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * LOG2E
    quant = ks is not None
    # a kv head's frame rows r = t * group + g, as the kernel tiles them
    qg = (q.reshape(nb, nt, hkv, group, d).permute(0, 2, 1, 3, 4)
          .reshape(nb, hkv, tg, d))
    frame = torch.arange(tg) // group
    n_splits = max(1, -(-pps * ps // SPLIT_KEYS))
    out = torch.zeros(nb, hkv, tg, d)
    pages = []
    for b in range(nb):
        ln = int(lens[b])
        n_keys = min(ln + nt - 1, pps * ps) if ln > 0 else 0
        limit = torch.clamp(ln + frame, max=n_keys)[:, None]     # [tg, 1]
        read, parts = set(), []
        for sp in range(n_splits):
            k_begin = sp * SPLIT_KEYS
            k_end = min(n_keys, k_begin + SPLIT_KEYS)
            if k_begin >= k_end:     # (max -inf, sum 0): the combine skips
                continue
            m = torch.full((CONSUMERS, hkv, tg, 1), NEG_INF)
            l = torch.zeros((CONSUMERS, hkv, tg, 1))
            acc = torch.zeros((CONSUMERS, hkv, tg, d))
            for i, k0 in enumerate(range(k_begin, k_end, STAGE_KEYS)):
                w = i % CONSUMERS
                pos = torch.arange(k0, min(k0 + STAGE_KEYS, k_end))
                page = pos // ps
                read.update(page.tolist())
                pid, slot = pt[b, page].long(), pos % ps
                s = torch.einsum("hrd,hkd->hrk", qg[b], kp[:, pid, slot])
                if quant:
                    s = s * ks[:, pid, slot][:, None, :]
                valid = pos[None, :] < limit                     # [tg, k]
                mx = torch.maximum(m[w], torch.where(valid, s, NEG_INF)
                                   .amax(-1, keepdim=True))
                alpha = torch.exp2((m[w] - mx) * sl2)
                p = torch.where(valid, torch.exp2(s * sl2 - mx * sl2),
                                torch.zeros(()))
                l[w] = l[w] * alpha + p.sum(-1, keepdim=True)
                vv = vp[:, pid, slot]
                if quant:    # p_j vs_j as two bf16 pieces, hi then lo
                    pv = p * vs[:, pid, slot][:, None, :]
                    hi = _bf16(pv)
                    o = torch.einsum("hrk,hkd->hrd", hi, vv)
                    if pieces == 2:
                        o = o + torch.einsum("hrk,hkd->hrd", _bf16(pv - hi),
                                             vv)
                else:
                    o = torch.einsum("hrk,hkd->hrd", _bf16(p), vv)
                acc[w] = acc[w] * alpha + o
                m[w] = mx
            # the warps merge in warp order
            mm = m.amax(0)
            f = torch.exp2((m - mm) * sl2)
            a, s_l = acc[0] * f[0], l[0] * f[0]
            for w in range(1, CONSUMERS):
                a, s_l = a + acc[w] * f[w], s_l + l[w] * f[w]
            parts.append((mm * scale, s_l, a))
        pages.append(read)
        if ln <= 0:
            continue
        # paged_combine_kernel: the splits in split order
        mx = torch.full((hkv, tg, 1), NEG_INF)
        for ms, s_l, _ in parts:
            mx = torch.where(s_l > 0, torch.maximum(mx, ms), mx)
        num, den = torch.zeros(hkv, tg, d), torch.zeros(hkv, tg, 1)
        for ms, s_l, a in parts:
            wgt = torch.where(s_l > 0, torch.exp(ms - mx), torch.zeros(()))
            num, den = num + a * wgt, den + s_l * wgt
        out[b] = num / den.clamp_min(1e-30)
    out = (_bf16(out).reshape(nb, hkv, nt, group, d).permute(0, 2, 1, 3, 4)
           .reshape(nb, nt, hq, d))
    return out, pages


def _lens(ps):
    # len 0, 1, a page less one, a page, a page and one, one split and
    # one, about 600
    return [0, 1, ps - 1, ps, ps + 1, SPLIT_KEYS + 1, 600]


def _inputs(seed, t, hq, hkv, d, ps, mode):
    """q, pools (and scales for codes), page table and lens, as numpy."""
    rng = np.random.RandomState(seed)
    lens = np.array(_lens(ps), np.int32)
    b = len(lens)
    pps = -(-(int(lens.max()) + t - 1) // ps) + 1
    n_pages = b * pps + 1                   # page 0: the null page
    pt = (rng.permutation(n_pages - 1)[:b * pps] + 1).reshape(b, pps)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32) * 0.5
    q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    shape = (hkv, n_pages, ps, d)
    if mode == "bf16":
        k, v = (
            (rng.standard_normal(shape) * 0.5).astype(ml_dtypes.bfloat16)
            .astype(np.float32) for _ in range(2))
        return q, k, v, None, None, pt.astype(np.int32), lens
    if mode == "int8":
        k, v = (rng.randint(-127, 128, shape).astype(np.int8)
                for _ in range(2))
    else:
        k, v = ((rng.standard_normal(shape) * 40).astype(
            ml_dtypes.float8_e4m3fn) for _ in range(2))
    ks, vs = ((np.abs(rng.standard_normal(shape[:3])) * 0.01 + 1e-3)
              .astype(np.float32) for _ in range(2))
    return q, k, v, ks, vs, pt.astype(np.int32), lens


def _run(q, k, v, ks, vs, pt, lens, pieces=2):
    """(the kernel's schedule, the JAX reference, pages read)."""
    scales = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                        v_scales=jnp.asarray(vs))
    ref = torch.from_numpy(np.array(jax_paged_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(lens), **scales), dtype=np.float32))
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    out, pages = _kernel_schedule(
        f(q), f(k), f(v), torch.from_numpy(pt), torch.from_numpy(lens),
        None if ks is None else f(ks), None if vs is None else f(vs), pieces)
    return out, ref, pages


def _hold_rows(out, ref):
    err = (out - ref).abs()
    row_err, row_max = err.amax(-1), ref.abs().amax(-1)
    bad = row_err > ROW_RTOL * row_max + ROW_ATOL
    assert not bool(bad.any()), (
        f"{int(bad.sum())} rows over 2^-7 of their max |ref|, worst "
        f"{float((row_err / row_max.clamp_min(ROW_ATOL)).max()):.3g}")
    return err


# label: (T, Hq, Hkv, D, page size)
BF16 = {
    "mha_d128_ps16": (1, 4, 4, 128, 16),
    "gqa4_d64_ps8": (1, 8, 2, 64, 8),
    "frame3_gqa8_d128_ps64": (3, 8, 1, 128, 64),   # 24 rows, 2 tiles
    "frame8_gqa8_d64_ps16": (8, 8, 1, 64, 16),     # 64 rows, 4 tiles
}


@pytest.mark.parametrize("case", list(BF16.values()), ids=list(BF16))
def test_bf16_pools_hold_against_jax_reference(case):
    t, hq, hkv, d, ps = case
    out, ref, _ = _run(*_inputs(3, t, hq, hkv, d, ps, "bf16"))
    err = _hold_rows(out, ref)
    assert float(err.max()) <= WHOLE_TOL, float(err.max())
    assert bool((out[0] == 0).all())                 # the len-0 row
    # the rounding of P is really there: not the fp32 result rounded
    assert float((out - _bf16(ref)).abs().max()) > 0


QUANT = {
    "mha_d128_ps16": (1, 4, 4, 128, 16),
    "gqa4_d64_ps8": (1, 8, 2, 64, 8),
    "frame8_gqa8_d128_ps64": (8, 8, 1, 128, 64),
}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("case", list(QUANT.values()), ids=list(QUANT))
def test_quantized_pools_hold_against_jax_reference(case, mode):
    t, hq, hkv, d, ps = case
    out, ref, _ = _run(*_inputs(5, t, hq, hkv, d, ps, mode))
    err = _hold_rows(out, ref)
    excess = float((err - ref.abs() * 2.0 ** -8).max())
    assert excess <= QUANT_EXCESS, excess
    assert bool((out[0] == 0).all())


def test_one_bf16_piece_of_p_vs_breaks_the_quantized_rule():
    # why the kernel takes p_j vs_j as two pieces: with one, a row of one
    # key near |value| 1 already misses the rule
    out, ref, _ = _run(*_inputs(5, 1, 4, 4, 128, 16, "int8"), pieces=1)
    excess = float(((out - ref).abs() - ref.abs() * 2.0 ** -8).max())
    assert excess > QUANT_EXCESS, excess


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("t", [1, 3])
def test_stages_read_exactly_the_admitted_pages(ps, t):
    q, k, v, _, _, pt, lens = _inputs(1, t, 2, 1, 64, ps, "bf16")
    _, pages = _kernel_schedule(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pt), torch.from_numpy(lens))
    # the last query's keys [0, len + T - 2]: pages 0 .. n - 1, no other
    keys = torch.from_numpy(np.where(lens > 0, lens + t - 1, 0))
    want = pa.page_visit_reference(keys, ps, pt.shape[1])
    assert [len(p) for p in pages] == want.tolist()
    assert all(p == set(range(len(p))) for p in pages)
    if t == 1:       # plain decode: exactly the counter's own lens
        assert want.tolist() == pa.page_visit_reference(
            torch.from_numpy(lens), ps, pt.shape[1]).tolist()


def test_codes_widen_to_bf16_exactly():
    # int8: code + 128 as the low byte of the fp32 2^23 + (code + 128),
    # minus 2^23 + 128, then rounded to bf16 (paged_attention.cu widen16)
    codes = np.arange(-128, 128, dtype=np.int32)
    bits = (0x4B000000 | ((codes + 256) & 0xFF) ^ 0x80).astype(np.uint32)
    f = bits.view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, codes.astype(np.float32))
    b = torch.from_numpy(f).to(torch.bfloat16).float().numpy()
    assert np.array_equal(b, codes.astype(np.float32))
    # e4m3: every finite code through fp16 (the hardware's e4m3x2 -> f16x2)
    # to fp32 to bf16
    e = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    exact = e.astype(np.float32)
    finite = np.isfinite(exact)
    assert int(finite.sum()) == 254               # 0x7F and 0xFF are NaN
    h = e.astype(np.float16).astype(np.float32)
    b = torch.from_numpy(h[finite]).to(torch.bfloat16).float().numpy()
    assert np.array_equal(b, exact[finite])


@pytest.mark.parametrize("ps,want", [(4, pa.ROUTE_CUDA_CORE),
                                     (12, pa.ROUTE_CUDA_CORE),
                                     (8, pa.ROUTE_MMA), (16, pa.ROUTE_MMA)])
def test_bf16_q_routes_by_page_size(ps, want):
    # the tensor-core kernel's ring stages take 8-key halves of one page;
    # any other page size runs the CUDA-core kernel, as fp32 q always does
    assert pa.kernel_route(torch.bfloat16, ps) == want
    assert pa.kernel_route(torch.float32, ps) == pa.ROUTE_CUDA_CORE


def _cu_const(name):
    from paddle_tpu_torch.ops.cuda import _build

    src = open(f"{_build.CSRC_DIR}/paged_attention.cu").read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _kernel_splits(route, pages_per_seq, ps, t):
    """ptt_paged_splits of paged_attention.cu: the tensor-core kernel's
    splits of kMmaSplitKeys keys, the CUDA-core kernel's of kSplitKeys
    over the frame's pages_per_seq * ps + T - 1 keys."""
    if route == pa.ROUTE_MMA:
        keys, per = pages_per_seq * ps, _cu_const("kMmaSplitKeys")
    else:
        keys, per = pages_per_seq * ps + t - 1, _cu_const("kSplitKeys")
    return -(-keys // per) if keys > per else 1


@pytest.mark.parametrize("ps", [4, 8, 12, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_count_and_launch_name_the_same_kernel(monkeypatch, ps,
                                                     dtype):
    # the wrapper sizes the split-K workspace for the kernel it launches:
    # one route goes to ptt_paged_splits and to ptt_paged_decode alike
    seen = {}

    def splits(pages_per_seq, page_size, t, route):
        seen["splits_route"] = route
        return _kernel_splits(route, pages_per_seq, page_size, t)

    def decode(*args):
        seen["decode_route"] = args[20]
        return 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(pa, "_lib", lambda: (decode, splits))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    b, t, hq, hkv, d, pps = 2, 3, 8, 2, 64, 200
    q = torch.zeros((b, t, hq, d), dtype=dtype)
    kp = torch.zeros((hkv, b * pps + 1, ps, d), dtype=dtype)
    pt = torch.ones((b, pps), dtype=torch.int32)
    lens = torch.full((b,), 5, dtype=torch.int32)
    captured = {}
    real_empty = torch.empty

    def empty(shape, **kw):
        out = real_empty(shape, **kw)
        captured.setdefault("ws", []).append(tuple(shape))
        return out

    monkeypatch.setattr(torch, "empty", empty)
    pa.reset_launches()
    pa._launch(q, kp, kp, pt, lens, None)
    route = pa.kernel_route(dtype, ps)
    assert seen["splits_route"] == seen["decode_route"] == route
    n = _kernel_splits(route, pps, ps, t)
    assert captured["ws"] == [(b, hkv, n, t * hq // hkv, d),
                              (b, hkv, n, t * hq // hkv, 2)]
    assert pa.launch_counts()["paged_decode"] == 1
    if dtype == torch.bfloat16 and ps in (4, 12):
        # 512-key splits with the frame's T - 1 extra keys, not 256
        assert n == -(-(pps * ps + t - 1) // 512)


@pytest.mark.parametrize("mode", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("ps", [4, 12])
def test_plain_version_at_page_sizes_off_the_mma_kernel(ps, mode):
    # the pools that the CUDA-core kernel serves for bf16 q: the port's
    # plain version (what chip_smoke.py holds that kernel against) equals
    # JAX's reference at fp32, frames and GQA included
    q, k, v, ks, vs, pt, lens = _inputs(7, 3, 8, 2, 64, ps, mode)
    scales = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                        v_scales=jnp.asarray(vs))
    ref = np.array(jax_paged_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(lens), **scales), dtype=np.float32)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    tsc = {} if ks is None else dict(k_scales=f(ks), v_scales=f(vs))
    got = pa.paged_attention(f(q), f(k), f(v), torch.from_numpy(pt),
                             torch.from_numpy(lens), **tsc)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    # bf16 q (the engine's dtype) returns that result rounded to bf16
    got16 = pa.paged_attention(f(q).bfloat16(), f(k), f(v),
                               torch.from_numpy(pt), torch.from_numpy(lens),
                               **tsc) if ks is not None else \
        pa.paged_attention(f(q).bfloat16(), f(k).bfloat16(),
                           f(v).bfloat16(), torch.from_numpy(pt),
                           torch.from_numpy(lens))
    assert got16.dtype == torch.bfloat16
    _hold_rows(got16.float(), torch.from_numpy(ref))
