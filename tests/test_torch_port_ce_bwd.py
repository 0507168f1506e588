"""The fused-CE backward's Hopper kernels (``csrc/ce_bwd.cu``), on the CPU.

The kernels run only on the card (``chip_smoke.py``). Here ``_kernel_bwd``
repeats their arithmetic: per token chunk of the resolved ``chunk_tokens``
rounded up to the 128-token tile (rows past N read as zeros, as TMA
fills them), the logits of bf16 x and W with fp32 sums, d in fp32 as
the epilogue forms it (exp2 of (logit - lse)·log2 e, coef, the one-hot
and smoothing terms, columns past V zeroed), d split into bf16 pieces
(hi = bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid)), dx = Σ_p d_p·W
and dW = Σ_chunks Σ_p d_pᵀ·x. It is held to the fp32 rule (each row within
1e-5 of its own max |ref|, a row of zeros exactly) against ``jax.vjp`` of
``paddle_tpu.ops.pallas.fused_ce.fused_linear_cross_entropy_loss`` with
``variant="tokens"``, over label smoothing, z-loss, ``ignore_index``, a
label = V, a ragged N and a V that is not a multiple of 256.

Beside it: three pieces hold the rule and two do not; the pieces
reproduce d exactly; ``FusedLinearCrossEntropy``'s CPU gradients equal
``ce_bwd_reference``; the wrapper's plan (chunk, row stride, dx's split)
and its errors, raised before any CUDA call. Inputs are made with numpy
from a seed.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy_loss
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import fused_ce as fc

RULE = 1e-5               # chip_smoke.py CE_BWD_RTOL: fp32, per row
LOG2E = 1.4426950408889634
IGN = -100
TILE = 128                # tokens a kernel tile (csrc/sm90.cuh kBM)


def _pieces(d, n):
    """d as n bf16 pieces, each rounded to nearest from what is left."""
    out, rest = [], d
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def _kernel_dlogits(x, w, labels, lse, ct, ignore, eps, z, c0, cr):
    """The dlogits kernel's d for the chunk of cr rows from c0 (fp32)."""
    n, h = x.shape
    v = w.shape[0]
    rows = min(cr, n - c0)
    xc = torch.zeros(cr, h)
    xc[:rows] = x[c0:c0 + rows].float()
    lab = torch.full((cr,), -1, dtype=torch.long)
    lab[:rows] = labels[c0:c0 + rows]
    lc, ctv = torch.zeros(cr), torch.zeros(cr)
    lc[:rows] = lse[c0:c0 + rows]
    ctv[:rows] = torch.where(labels[c0:c0 + rows] != ignore,
                             ct[c0:c0 + rows], 0.0)
    coef = ctv * (1.0 + 2.0 * z * lc) if z else ctv
    logits = xc @ w.float().T
    d = torch.exp2((logits - lc[:, None]) * LOG2E) * coef[:, None]
    d = d + torch.where(torch.arange(v)[None] == lab[:, None],
                        (-(1.0 - eps) * ctv)[:, None], 0.0)
    return d - (np.float32(eps / v) * ctv)[:, None], xc, rows


def _kernel_bwd(x, w, labels, lse, ct, ignore=IGN, eps=0.0, z=0.0,
                chunk=0, pieces=3):
    """(dx, dW) fp32 as the kernels compute them."""
    n, h = x.shape
    v = w.shape[0]
    cr = fc._bwd_plan(n, v, h, fc.resolve_chunks(n, v, chunk)[0], 132)["cr"]
    wf = w.float()
    dx, dw = torch.zeros(n, h), torch.zeros(v, h)
    for c0 in range(0, n, cr):
        d, xc, rows = _kernel_dlogits(x, w, labels, lse, ct, ignore, eps, z,
                                      c0, cr)
        ps = _pieces(d, pieces)
        dx[c0:c0 + rows] = sum(p @ wf for p in ps)[:rows]
        dw += sum(p.T @ xc for p in ps)
    return dx, dw


def _rule(got, ref):
    """max over rows of |got - ref| / max |ref| (a zero row must be
    exactly zero), and whether every row holds the fp32 rule."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max(-1)
    top = np.abs(ref).max(-1)
    worst = float(np.max(np.where(top > 0, err / np.where(top > 0, top, 1),
                                  np.where(err > 0, np.inf, 0.0))))
    return worst, bool(np.all(err <= RULE * top))


def _data(seed, n, h, v, std=0.25, ignored=False, label_v=False):
    """bf16-valued x [N, H] and W [V, H], labels, a cotangent (the mean's
    1/N scaled by 0.5-1.5 a token) and the forward's lse."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)
                         ).bfloat16()
    w = torch.from_numpy((rng.standard_normal((v, h)) * std)
                         .astype(np.float32)).bfloat16()
    lab = rng.randint(0, v, n)
    if ignored:
        lab[::7] = IGN
    if label_v:
        lab[3] = v                   # past the vocab: matches no column
    ct = ((rng.rand(n) + 0.5) / n).astype(np.float32)
    labels = torch.from_numpy(lab)
    m, s, _, _ = fc.ce_stats_reference(x.float(), w.float(), labels)
    return x, w, labels, torch.from_numpy(ct), m + torch.log(s)


def _jax_grads(x, w, labels, ct, ignore, eps, z, chunk):
    """(dx, dW [V, H]) of jax.vjp of the token-chunked JAX loss, fp32."""
    xj = jnp.asarray(x.float().numpy())
    wj = jnp.asarray(w.float().numpy().T)       # JAX takes [H, V]

    def loss(xx, ww):
        return fused_linear_cross_entropy_loss(
            xx, ww, jnp.asarray(labels.numpy().astype(np.int32)),
            ignore_index=ignore, label_smoothing=eps, z_loss=z,
            chunk_tokens=chunk, variant="tokens")

    _, vjp = jax.vjp(loss, xj, wj)
    dx, dw = vjp(jnp.asarray(ct.numpy()))
    return np.asarray(dx), np.asarray(dw).T


CASES = {
    "plain": dict(n=256, h=64, v=1000),
    "label_smoothing": dict(n=256, h=64, v=1000, eps=0.1),
    "z_loss": dict(n=256, h=64, v=1000, z=1e-2),
    "smoothing_and_z_loss": dict(n=256, h=64, v=1000, eps=0.1, z=1e-2),
    "ignore_index": dict(n=256, h=64, v=1000, ignored=True),
    "label_v": dict(n=256, h=64, v=1000, label_v=True),
    "ragged_n": dict(n=300, h=64, v=1000, ignored=True, chunk=64),
    "v_not_256": dict(n=200, h=64, v=130, eps=0.1, ignored=True,
                      label_v=True, chunk=100),
}


def _case(name, seed=0):
    kw = dict(CASES[name])
    eps, z, chunk = kw.pop("eps", 0.0), kw.pop("z", 0.0), kw.pop("chunk", 0)
    x, w, labels, ct, lse = _data(seed, **kw)
    return x, w, labels, ct, lse, eps, z, chunk


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_arithmetic_matches_jax_vjp(name):
    x, w, labels, ct, lse, eps, z, chunk = _case(name)
    dx, dw = _kernel_bwd(x, w, labels, lse, ct, IGN, eps, z, chunk)
    jdx, jdw = _jax_grads(x, w, labels, ct, IGN, eps, z, chunk or 64)
    for got, ref in ((dx, jdx), (dw, jdw)):
        worst, ok = _rule(got.numpy(), ref)
        assert ok, (name, worst)
    ignored = labels.numpy() == IGN
    assert not dx.numpy()[ignored].any()


def _twins(seed, n=1024, h=64, v=64, sep=0.1):
    """A head whose vocabulary rows come in near-identical pairs (as a
    trained head keeps a word's cased and uncased forms), and tokens that
    give both rows of their label's pair about a third of p: dx = d·W then
    cancels (p_label - 1)·W_label against p_twin·W_twin, so the row is
    about `sep` of its terms, and an error of the pieces in d is that
    much larger against the row's own max."""
    rng = np.random.RandomState(seed)
    w = np.repeat(rng.standard_normal((v // 2, h)) / np.sqrt(h), 2, axis=0)
    w[1::2] += sep * rng.standard_normal((v // 2, h)) / np.sqrt(h)
    lab = 2 * rng.randint(0, v // 2, n) + rng.randint(0, 2, n)
    beta = np.log(v) + rng.uniform(-0.5, 0.5, n)
    x = beta[:, None] * w[lab] / (w[lab] ** 2).sum(-1, keepdims=True)
    x = torch.from_numpy(x.astype(np.float32)).bfloat16()
    w = torch.from_numpy(w.astype(np.float32)).bfloat16()
    labels = torch.from_numpy(lab)
    ct = torch.from_numpy(((rng.rand(n) + 0.5) / n).astype(np.float32))
    m, s, _, _ = fc.ce_stats_reference(x.float(), w.float(), labels)
    return x, w, labels, ct, m + torch.log(s)


def test_three_bf16_pieces_hold_the_rule_and_two_do_not():
    """Two pieces leave up to 2^-17 of d (|d| in [0.5, 1)) and three
    2^-25. On the plain cases both stay under the rule (two at up to
    0.9e-5); where dx cancels, as with near-identical vocabulary rows,
    two pieces break it and three hold it."""
    x, w, labels, ct, lse = _twins(1)
    jdx, jdw = _jax_grads(x, w, labels, ct, IGN, 0.0, 0.0, 256)
    p_label = torch.exp((x.float() @ w.float().T).gather(
        1, labels[:, None])[:, 0] - lse)
    assert 0.2 < float(p_label.median()) < 0.5
    three = _kernel_bwd(x, w, labels, lse, ct, chunk=256, pieces=3)
    two = _kernel_bwd(x, w, labels, lse, ct, chunk=256, pieces=2)
    worst3 = [_rule(g.numpy(), r) for g, r in zip(three, (jdx, jdw))]
    worst2 = [_rule(g.numpy(), r) for g, r in zip(two, (jdx, jdw))]
    assert all(ok for _, ok in worst3), worst3
    assert not worst2[0][1], worst2                     # dx breaks it
    assert worst2[0][0] > 4 * worst3[0][0], (worst2, worst3)


def test_pieces_reproduce_d_exactly():
    """hi + mid + lo == d for every d the cases make: exact for |d| >=
    2^-110 (lo's last bit stays at or above bf16's least subnormal,
    2^-133); below that (|d| < 1.3e-33, not made by these cases or a
    training step's softmax) lo may lose bits, an error under 2^-133."""
    seen = 0
    for name in sorted(CASES):
        x, w, labels, ct, lse, eps, z, chunk = _case(name)
        n, h = x.shape
        cr = fc._bwd_plan(n, w.shape[0], h,
                          fc.resolve_chunks(n, w.shape[0], chunk)[0],
                          132)["cr"]
        for c0 in range(0, n, cr):
            d = _kernel_dlogits(x, w, labels, lse, ct, IGN, eps, z, c0,
                                cr)[0]
            hi, mid, lo = _pieces(d, 3)
            for p in (hi, mid, lo):   # each piece is a bf16 value
                assert torch.equal(p, p.to(torch.bfloat16).float())
            big = d.abs() >= 2.0 ** -110
            assert torch.equal(((hi + mid) + lo)[big], d[big])
            assert bool((hi[d == 0] == 0).all() and (lo[d == 0] == 0).all())
            seen += int(big.sum())
            assert int(((d != 0) & ~big).sum()) == 0, name
    assert seen > 0


def test_fused_ce_cpu_gradients_equal_ce_bwd_reference():
    x, w, labels, ct, lse, eps, z, chunk = _case("smoothing_and_z_loss")
    xf = x.float().requires_grad_()
    wf = w.float().requires_grad_()
    nll = fc.FusedLinearCrossEntropy.apply(xf, wf, labels, IGN, eps, z, 64)
    nll.backward(ct)
    m, s, _, _ = fc.ce_stats(xf.detach(), wf.detach(), labels)
    rdx, rdw = fc.ce_bwd_reference(xf.detach(), wf.detach(), labels,
                                   m + torch.log(s), ct, IGN, eps, z, 64)
    assert torch.equal(xf.grad, rdx) and torch.equal(wf.grad, rdw)
    fc.reset_launches()
    got = fc.ce_bwd(xf.detach(), wf.detach(), labels, m + torch.log(s), ct,
                    IGN, eps, z, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, (rdx, rdw)))
    assert fc.LAUNCHES["ce_bwd"] == 0 and fc.ROUTE_CALLS["ce_bwd_fp32"] == 0


def test_ce_bwd_reference_in_fp64_is_the_fp32_function():
    x, w, labels, ct, lse, eps, z, chunk = _case("ragged_n")
    r32 = fc.ce_bwd_reference(x, w, labels, lse, ct, IGN, eps, z, chunk)
    r64 = fc.ce_bwd_reference(x.double(), w.double(), labels, lse.double(),
                              ct.double(), IGN, eps, z, chunk)
    assert r32[0].dtype == torch.float32 and r64[0].dtype == torch.float64
    for a, b in zip(r32, r64):
        assert _rule(a.numpy(), b.numpy())[1]


def _src_const(name):
    src = open(f"{_build.CSRC_DIR}/ce_bwd.cu").read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_plan_rounds_the_chunk_pads_v_and_splits_dx_to_fill_the_card():
    assert fc._BWD_BN == _src_const("kBN")
    assert fc._BWD_PIECES == _src_const("kPieces")
    # the LLaMA step: chunk 131 -> 256 tokens, 2 x 32 dx tiles for 132 SMs
    p = fc._bwd_plan(4096, 32000, 4096, 131, 132)
    assert p == dict(cr=256, vp=32000, splits=2, per=250)
    assert fc._bwd_plan(4096, 32000, 4096, 1024, 132)["splits"] == 1
    assert fc._bwd_plan(4096, 32000, 4096, 4096, 132)["cr"] == 4096
    assert fc._bwd_plan(4096, 32001, 4096, 131, 132)["vp"] == 32008
    assert fc._bwd_plan(200, 130, 64, 100, 132) == dict(cr=128, vp=136,
                                                        splits=3, per=1)
    for n, v, h, c in [(4096, 32000, 4096, 131), (1000, 32000, 4096, 1000),
                       (300, 1000, 256, 64), (5, 9, 8, 5)]:
        p = fc._bwd_plan(n, v, h, c, 132)
        ksteps = -(-v // fc._BWD_BK)
        assert p["cr"] % TILE == 0 and p["cr"] >= min(c, n)
        assert p["vp"] % 8 == 0 and p["vp"] >= v
        assert p["splits"] * p["per"] >= ksteps
        assert (p["splits"] - 1) * p["per"] < ksteps


def test_launch_errors_raise_before_any_cuda_call():
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    w = torch.zeros(8, 16, dtype=torch.bfloat16)
    lab = torch.zeros(4, dtype=torch.int64)
    lse = ct = torch.zeros(4)
    args = (lab, lse, ct, IGN, 0.0, 0.0, 4)
    with pytest.raises(TypeError, match="bf16 x and w"):
        fc._launch_bwd(x.float(), w.float(), *args)
    with pytest.raises(TypeError, match="bf16 x and w"):
        fc._launch_bwd(x, w.float(), *args)
    with pytest.raises(ValueError, match="multiple of 8"):
        fc._launch_bwd(torch.zeros(4, 12, dtype=torch.bfloat16),
                       torch.zeros(8, 12, dtype=torch.bfloat16), *args)
    with pytest.raises(ValueError, match=r"lse and ct must be \[N\]"):
        fc._launch_bwd(x, w, lab, torch.zeros(3), ct, IGN, 0.0, 0.0, 4)
    with pytest.raises(ValueError, match=r"w \[V, H\]"):
        fc._launch_bwd(x, torch.zeros(8, 8, dtype=torch.bfloat16), *args)
    with pytest.raises(TypeError, match="integer class labels"):
        fc._launch_bwd(x, w, lse, lse, ct, IGN, 0.0, 0.0, 4)
