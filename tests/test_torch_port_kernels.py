"""The port's kernel modules on the CPU: the plain PyTorch versions of the
two hand-written Hopper kernels against the JAX package.

* flash forward: ``flash_attention_reference`` vs the Pallas
  ``flash_attention_bhsd`` run in interpret mode (causal, non-causal, GQA,
  packed segments), fp32 <= 1e-5;
* paged decode: ``paged_attention_reference`` vs the JAX
  ``paged_attention_reference`` (the paged Pallas kernel cannot run in
  interpret mode with the installed jax: its ``x64_off`` import fails),
  decode, T = 3 frames, GQA and len-0 rows, fp32 <= 1e-5;
* the wrappers take the plain path for CPU tensors and count no launch.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import flash_attention_bhsd
from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention_reference as jax_paged_reference
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_reference,
    segment_block_visit_counts)
from paddle_tpu_torch.ops.cuda.paged_attention import (
    page_visit_counts, paged_attention, paged_attention_reference)

TOL = 1e-5


def _qkv(rng, b, s, hq, hkv, d):
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _jax_flash(q, k, v, causal, seg):
    # the Pallas kernel's layout is [B, H, S, D]
    t = lambda a: jnp.asarray(np.swapaxes(a, 1, 2))
    out = flash_attention_bhsd(t(q), t(k), t(v), causal=causal,
                               segment_ids=None if seg is None
                               else jnp.asarray(seg), interpret=True)
    return np.swapaxes(np.asarray(out), 1, 2)


@pytest.mark.parametrize("case", [
    dict(b=2, s=64, hq=4, hkv=4, d=32, causal=True, nseg=0),
    dict(b=2, s=64, hq=4, hkv=4, d=32, causal=False, nseg=0),
    dict(b=1, s=64, hq=4, hkv=2, d=32, causal=True, nseg=0),
    dict(b=2, s=64, hq=4, hkv=2, d=32, causal=True, nseg=3),
    dict(b=1, s=48, hq=2, hkv=1, d=64, causal=False, nseg=2),
], ids=["causal", "noncausal", "gqa4_2", "segmented_gqa", "segmented_nc"])
def test_flash_reference_matches_pallas_interpret(case):
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, case["b"], case["s"], case["hq"], case["hkv"],
                   case["d"])
    seg = None
    if case["nseg"]:
        # packed rows: non-decreasing segment ids, as the packer emits
        seg = np.sort(rng.randint(0, case["nseg"], (case["b"], case["s"])),
                      axis=1).astype(np.int32)
    want = _jax_flash(q, k, v, case["causal"], seg)
    got, lse = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=case["causal"],
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert lse.shape == (case["b"], case["hq"], case["s"])
    assert torch.isfinite(lse).all()


def test_flash_lse_is_logsumexp_of_scaled_scores():
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 1, 16, 2, 2, 8)
    _, lse = flash_attention_reference(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=True)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    s = np.where(np.tril(np.ones((16, 16), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=TOL, rtol=0)


def _paged_inputs(rng, b, t, hq, hkv, d, ps, pages_per_seq, lens):
    num_pages = b * pages_per_seq + 1
    k = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    v = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))[:b * pages_per_seq]
    pt = perm.reshape(b, pages_per_seq).astype(np.int32)
    shape = (b, hq, d) if t == 1 else (b, t, hq, d)
    q = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, pt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("case", [
    dict(b=4, t=1, hq=4, hkv=4, lens=[5, 0, 17, 32]),
    dict(b=3, t=3, hq=4, hkv=4, lens=[1, 9, 20]),
    dict(b=4, t=1, hq=8, hkv=2, lens=[0, 3, 31, 12]),
    dict(b=2, t=3, hq=8, hkv=2, lens=[0, 14]),
], ids=["decode", "frame3", "gqa", "gqa_frame3_len0"])
def test_paged_reference_matches_jax_reference(case):
    rng = np.random.RandomState(11)
    q, k, v, pt, lens = _paged_inputs(rng, case["b"], case["t"], case["hq"],
                                      case["hkv"], 16, 4, 9, case["lens"])
    want = np.asarray(jax_paged_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(lens)))
    got = paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pt), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    for i, n in enumerate(case["lens"]):
        if n == 0:
            assert not got[i].any()


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    port_cuda.reset_launch_counts()
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 32, 4, 2, 16))
    seg = torch.zeros(1, 32, dtype=torch.int32)
    seg[:, 20:] = 1
    out, lse = flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                             segment_ids=seg)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    qp, kp, vp, pt, lens = (torch.from_numpy(a) for a in _paged_inputs(
        rng, 2, 1, 4, 2, 16, 4, 5, [3, 7]))
    assert torch.equal(paged_attention(qp, kp, vp, pt, lens),
                       paged_attention_reference(qp, kp, vp, pt, lens))
    assert page_visit_counts(lens, 4, 5).tolist() == [1, 2]
    assert segment_block_visit_counts(
        torch.zeros(1, 128, dtype=torch.int32)).tolist() == [[1, 2]]
    assert port_cuda.launch_counts() == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_visit": 0, "paged_decode": 0, "paged_decode_int8": 0,
        "paged_decode_fp8": 0, "paged_visit": 0, "ce_stats": 0, "ce_bwd": 0,
        "gmm_fwd": 0, "gmm_fwd_tf32": 0, "gmm_dw": 0, "gmm_visit": 0,
        "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "rmsnorm_dw": 0}


def test_shape_errors_raise():
    q = torch.zeros(1, 8, 3, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention_fwd(q, q, q, segment_ids=torch.zeros(1, 7))
    pools = torch.zeros(2, 5, 4, 16)
    with pytest.raises(ValueError, match="page_table"):
        paged_attention(torch.zeros(2, 4, 16), pools, pools,
                        torch.zeros(3, 2, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32))
