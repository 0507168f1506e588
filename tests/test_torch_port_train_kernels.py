"""The training slice's kernel modules on the CPU: the plain PyTorch
versions of the flash backward and the fused-CE statistics kernels against
the JAX package.

* flash backward: ``flash_attention_bwd_reference`` (and the autograd
  ``FlashAttention`` around it) vs ``jax.grad`` through the Pallas
  ``flash_attention_bhsd`` run in interpret mode (the dq and dkv kernels
  themselves): causal, non-causal, GQA, segmented, fp32, rtol 2e-3 /
  atol 2e-4 as ``tests/test_flash_attention.py`` holds the Pallas grads;
* fused CE: ``FusedLinearCrossEntropy`` vs the JAX
  ``fused_linear_cross_entropy_loss(variant="tokens")`` (the Pallas variant
  fails with an ImportError on this jax), loss, dx and dW, with
  ignore_index, label smoothing, z-loss and a ragged N in small chunks,
  fp32 rtol/atol 2e-5 as ``tests/test_fused_cross_entropy.py``;
* the wrappers take the plain path for CPU tensors and count no launch.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import flash_attention_bhsd
from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy_loss
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda.flash_attention import (
    FlashAttention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_reference)
from paddle_tpu_torch.ops.cuda.fused_ce import (FusedLinearCrossEntropy,
                                                ce_stats, ce_stats_reference,
                                                resolve_chunks)

FLASH_TOL = dict(rtol=2e-3, atol=2e-4)
CE_TOL = dict(rtol=2e-5, atol=2e-5)
IGN = -100


def _qkv(rng, b, s, hq, hkv, d):
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _jax_flash_grads(q, k, v, do, causal, seg):
    """jax.grad of sum(out * do) through the Pallas kernels (interpret)."""
    t = lambda a: jnp.asarray(np.swapaxes(a, 1, 2))      # -> [B, H, S, D]

    def f(qh, kh, vh):
        out = flash_attention_bhsd(qh, kh, vh, causal=causal,
                                   segment_ids=None if seg is None
                                   else jnp.asarray(seg), interpret=True)
        return jnp.sum(out * t(do))

    grads = jax.grad(f, argnums=(0, 1, 2))(t(q), t(k), t(v))
    return [np.swapaxes(np.asarray(g), 1, 2) for g in grads]


FLASH_CASES = [
    dict(b=2, s=64, hq=4, hkv=4, d=32, causal=True, nseg=0),
    dict(b=2, s=64, hq=4, hkv=4, d=32, causal=False, nseg=0),
    dict(b=1, s=64, hq=4, hkv=2, d=32, causal=True, nseg=0),
    dict(b=2, s=64, hq=4, hkv=2, d=32, causal=True, nseg=3),
    dict(b=1, s=48, hq=2, hkv=1, d=64, causal=False, nseg=2),
]
FLASH_IDS = ["causal", "noncausal", "gqa4_2", "segmented_gqa",
             "segmented_nc"]


def _flash_inputs(case, seed):
    rng = np.random.RandomState(seed)
    q, k, v = _qkv(rng, case["b"], case["s"], case["hq"], case["hkv"],
                   case["d"])
    do = rng.standard_normal(q.shape).astype(np.float32)
    seg = None
    if case["nseg"]:
        # packed rows: non-decreasing segment ids, as the packer emits
        seg = np.sort(rng.randint(0, case["nseg"], (case["b"], case["s"])),
                      axis=1).astype(np.int32)
    return q, k, v, do, seg


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_bwd_reference_matches_pallas_interpret(case):
    q, k, v, do, seg = _flash_inputs(case, 17)
    want = _jax_flash_grads(q, k, v, do, case["causal"], seg)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    out, lse = flash_attention_reference(tq, tk, tv, causal=case["causal"],
                                         segment_ids=tseg)
    got = flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                        causal=case["causal"],
                                        segment_ids=tseg)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}",
                                   **FLASH_TOL)


@pytest.mark.parametrize("case", FLASH_CASES[2:4], ids=FLASH_IDS[2:4])
def test_flash_autograd_matches_autograd_of_forward_reference(case):
    """FlashAttention's explicit backward equals torch autograd through the
    plain forward (fp32 math, tighter than the cross-package tolerance)."""
    q, k, v, do, seg = _flash_inputs(case, 5)
    tseg = None if seg is None else torch.from_numpy(seg)

    def grads(fn):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*xs) * torch.from_numpy(do)).sum().backward()
        return [x.grad for x in xs]

    got = grads(lambda a, b, c: FlashAttention.apply(a, b, c, True, None,
                                                     tseg))
    want = grads(lambda a, b, c: flash_attention_reference(
        a, b, c, causal=True, segment_ids=tseg)[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_sdpa_is_differentiable_and_keeps_inference_path():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 16, 4, 2, 16))
    q.requires_grad_()
    out = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0
    with torch.no_grad():
        ref = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert ref.grad_fn is None and torch.equal(ref, out.detach())


def _ce_data(seed, n, h, v, ignored=True):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) / np.sqrt(h)).astype(np.float32)
    lab = rng.randint(0, v, n).astype(np.int32)
    if ignored:
        lab[::5] = IGN
    ct = rng.standard_normal(n).astype(np.float32)
    return x, w, lab, ct


def _jax_ce(x, w, lab, ct, **kw):
    def f(xv, wv):
        nll = fused_linear_cross_entropy_loss(xv, wv, jnp.asarray(lab),
                                              variant="tokens", mp_axis=None,
                                              **kw)
        return jnp.sum(nll * jnp.asarray(ct)), nll

    (_, nll), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(jnp.asarray(x),
                                                          jnp.asarray(w))
    return np.asarray(nll), np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("case", [
    dict(n=24, h=16, v=50),
    dict(n=24, h=16, v=50, label_smoothing=0.1),
    dict(n=24, h=16, v=50, z_loss=1e-3),
    dict(n=24, h=16, v=50, label_smoothing=0.2, z_loss=1e-4),
    dict(n=37, h=32, v=130, chunk_tokens=7),
], ids=["plain", "smoothing", "zloss", "smoothing_zloss", "ragged_chunks"])
def test_fused_ce_matches_jax_tokens_variant(case):
    kw = {k: case[k] for k in ("label_smoothing", "z_loss", "chunk_tokens")
          if k in case}
    x, w, lab, ct = _ce_data(3, case["n"], case["h"], case["v"])
    nll_j, dx_j, dw_j = _jax_ce(x, w, lab, ct, **kw)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()     # port [V, H]
    nll = FusedLinearCrossEntropy.apply(
        tx, tw, torch.from_numpy(lab), IGN, kw.get("label_smoothing", 0.0),
        kw.get("z_loss", 0.0), kw.get("chunk_tokens", 0))
    (nll * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), nll_j, **CE_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), dx_j, **CE_TOL)
    np.testing.assert_allclose(tw.grad.numpy().T, dw_j, **CE_TOL)
    ignored = lab == IGN
    assert not nll.detach().numpy()[ignored].any()
    assert not tx.grad.numpy()[ignored].any()


def test_fused_linear_cross_entropy_reductions():
    x, w, lab, _ = _ce_data(4, 20, 16, 40)
    tx, tw, tl = torch.from_numpy(x), torch.from_numpy(w.T.copy()), \
        torch.from_numpy(lab)
    per = TF.fused_linear_cross_entropy(tx, tw, tl, reduction="none")
    valid = lab != IGN
    np.testing.assert_allclose(
        TF.fused_linear_cross_entropy(tx, tw, tl).item(),
        per.sum().item() / valid.sum(), rtol=1e-6)
    np.testing.assert_allclose(
        TF.fused_linear_cross_entropy(tx, tw, tl, reduction="sum").item(),
        per.sum().item(), rtol=1e-6)
    # the unfused loss on materialized logits gives the same values
    logits = tx @ tw.T
    np.testing.assert_allclose(per.numpy(), TF.parallel_cross_entropy(
        logits, tl).numpy(), **CE_TOL)
    np.testing.assert_allclose(
        TF.fused_linear_cross_entropy(tx, tw, tl).item(),
        TF.cross_entropy(logits, tl).item(), **CE_TOL)


def test_ce_stats_reference_matches_numpy_and_ignores_out_of_range():
    x, w, lab, _ = _ce_data(6, 19, 16, 33)
    lab[3] = 33                      # past the vocab: matches no column
    logits = x.astype(np.float64) @ w.astype(np.float64)
    m, s, t, sl = ce_stats_reference(torch.from_numpy(x),
                                     torch.from_numpy(w.T.copy()),
                                     torch.from_numpy(lab), chunk_tokens=4)
    hit = (lab >= 0) & (lab < 33)
    want_t = np.where(hit, logits[np.arange(19), np.clip(lab, 0, 32)], 0.0)
    np.testing.assert_allclose(m.numpy(), logits.max(-1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        (m + torch.log(s)).numpy(),
        np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1))
        + logits.max(-1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), want_t, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sl.numpy(), logits.sum(-1), rtol=1e-5,
                               atol=1e-5)


def test_resolve_chunks_matches_jax():
    from paddle_tpu.ops.pallas.fused_ce import resolve_chunks as jax_chunks

    for args in [(4096, 32000), (24, 50), (37, 130, 7), (10, 10, 0, 3),
                 (1, 1 << 23)]:
        assert resolve_chunks(*args) == jax_chunks(*args), args


def test_train_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    port_cuda.reset_launch_counts()
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 32, 4, 2, 16))
    out, lse = flash_attention_reference(q, k, v, causal=True)
    do = torch.ones_like(out)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x, w, lab, _ = _ce_data(9, 10, 16, 20)
    args = (torch.from_numpy(x), torch.from_numpy(w.T.copy()),
            torch.from_numpy(lab))
    assert all(torch.equal(a, b) for a, b in zip(ce_stats(*args),
                                                 ce_stats_reference(*args)))
    assert port_cuda.launch_counts() == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "paged_decode": 0, "ce_stats": 0, "gmm_fwd": 0, "gmm_dw": 0,
        "gmm_visit": 0}


def test_train_kernel_shape_errors_raise():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8), q,
                            segment_ids=torch.zeros(1, 7))
    with pytest.raises(ValueError, match=r"w \[V, H\]"):
        ce_stats(torch.zeros(4, 16), torch.zeros(16, 8),
                 torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="integer class labels"):
        ce_stats(torch.zeros(4, 16), torch.zeros(8, 16), torch.zeros(4))
