"""The port's RMSNorm op (``paddle_tpu_torch.ops.rmsnorm``) on the CPU,
where its wrappers run the kernels' plain versions, against the JAX
package's kernel.

The JAX Pallas ``rmsnorm`` cannot run on this tree, not even in interpret
mode (its ``_compat.x64_off`` import fails, ROADMAP C1), so:

* the forward is held against the TPU kernel's own body,
  ``_rmsnorm_fwd_kernel``, run on numpy arrays as its refs: fp32 within
  1e-5 (the sum of x^2 runs in another order), bf16 (``ml_dtypes``
  arrays) within 2^-8 of max |ref| (at most one bf16 rounding apart);
* the backward body calls ``pl.program_id`` and cannot run outside a
  kernel, so dx and dw are held against ``jax.vjp`` of the kernel's formula
  (``rmsnorm_kernel.py:19-23, :55-63``) in fp32, within 1e-5 of each
  tensor's max |ref|, with several row blocks and a ragged last block.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas.rmsnorm_kernel import _rmsnorm_fwd_kernel
from paddle_tpu_torch import ops as port_ops
from paddle_tpu_torch.core.flags import _REGISTRY, set_flags
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda import rmsnorm_kernel as rk
from paddle_tpu_torch.tuning import last_resolution, trial_blocks

EPS = 1e-6


@pytest.fixture(autouse=True)
def _flag_hygiene():
    f = _REGISTRY["rmsnorm_block_rows"]
    saved = (f.value, f.explicit)
    yield
    f.value, f.explicit = saved


def _data(seed, rows, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, d).astype(np.float32),
            rs.randn(d).astype(np.float32),
            rs.randn(rows, d).astype(np.float32))


def _jax_kernel_fwd(x, w):
    out = np.empty_like(x)
    _rmsnorm_fwd_kernel(x, w.reshape(1, -1), out, eps=EPS)
    return out


def _formula(x, w):
    """The kernels' formula (rmsnorm_kernel.py:47-51) in fp32."""
    xf = x.astype(jnp.float32)
    rstd = jax.lax.rsqrt(jnp.mean(xf * xf, -1, keepdims=True) + EPS)
    return xf * rstd * w.astype(jnp.float32)


def _jax_vjp(x, w, dy):
    _, vjp = jax.vjp(_formula, jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("rows,d", [(64, 128), (100, 100), (3, 7),
                                    (33, 4096)])
def test_forward_matches_jax_kernel_body_fp32(rows, d):
    x, w, _ = _data(0, rows, d)
    want = _jax_kernel_fwd(x, w)
    got = port_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("w_bf16", [True, False])
def test_forward_matches_jax_kernel_body_bf16(w_bf16):
    x, w, _ = _data(1, 64, 256)
    xb = x.astype(ml_dtypes.bfloat16)
    wb = w.astype(ml_dtypes.bfloat16) if w_bf16 else w
    want = _jax_kernel_fwd(xb, wb).astype(np.float32)
    tx = torch.from_numpy(xb.astype(np.float32)).bfloat16()
    tw = torch.from_numpy(np.asarray(wb, np.float32))
    got = port_ops.rmsnorm(tx, tw.bfloat16() if w_bf16 else tw)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("rows,d,block_rows", [
    (64, 128, 0),        # one resolved block
    (64, 128, 16),       # four blocks: dw summed over their partials
    (100, 100, 32),      # ragged: the last block holds 4 real rows
    (5, 40, 1024),       # a block larger than the rows
])
def test_backward_matches_jax_vjp(rows, d, block_rows):
    x, w, dy = _data(2, rows, d)
    want_dx, want_dw = _jax_vjp(x, w, dy)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = port_ops.rmsnorm(tx, tw, EPS, block_rows)
    y.backward(torch.from_numpy(dy))
    for got, want in ((tx.grad, want_dx), (tw.grad, want_dw)):
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def test_block_partials_sum_in_order():
    """The plain backward follows the kernels' dw structure: one fp32
    partial per block of rows (the ragged block over its real rows), summed
    over blocks by the dw kernel's plain version."""
    x, w, dy = _data(3, 100, 24)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    dx, dw = rk.rmsnorm_bwd(tx, tw, tdy, EPS, 32)
    rstd = torch.rsqrt((tx * tx).mean(-1, keepdim=True) + EPS)
    contrib = tdy * tx * rstd
    parts = torch.stack([contrib[i:i + 32].sum(0) for i in range(0, 100, 32)])
    assert torch.equal(dw, rk.rmsnorm_dw_reference(parts, torch.float32))
    assert torch.equal(dw, rk.rmsnorm_dw(parts, torch.float32))
    assert dx.shape == tx.shape and dw.shape == tw.shape


def test_bf16_differs_from_the_composite_by_one_rounding():
    """The kernel rounds once, after the multiply by w; the composite
    ``F.rms_norm`` (``functional/__init__.py:669``) rounds the normalized
    value to bf16 first, then multiplies by the bf16 weight. In bf16 the
    two differ, by at most about one bf16 rounding of the result (2^-7 of
    |x * rstd * w|, plus the smallest normal bf16 near zero)."""
    x, w, _ = _data(4, 64, 256)
    xb, wb = x.astype(ml_dtypes.bfloat16), w.astype(ml_dtypes.bfloat16)
    comp = np.asarray(JF.rms_norm(paddle.to_tensor(jnp.asarray(xb)),
                                  paddle.to_tensor(jnp.asarray(wb)),
                                  EPS)._value).astype(np.float32)
    got = port_ops.rmsnorm(torch.from_numpy(xb.astype(np.float32)).bfloat16(),
                           torch.from_numpy(wb.astype(np.float32)).bfloat16(),
                           EPS).float().numpy()
    exact = np.asarray(_formula(jnp.asarray(xb), jnp.asarray(wb)))
    diff = np.abs(got - comp)
    assert (diff > 0).any()                 # a real difference
    assert (diff <= 2.0 ** -7 * np.abs(exact) + 2.0 ** -126).all()
    # the kernel's rounding is the nearer one
    assert np.abs(got - exact).sum() <= np.abs(comp - exact).sum()


def test_block_rows_resolves_once_in_the_forward():
    """The backward reuses the forward's row block: a trial override seen
    by the forward holds for the backward run outside it (autograd's CUDA
    backward runs on another thread, where the trial is not set)."""
    x, w, dy = _data(5, 64, 32)
    tx = torch.from_numpy(x).requires_grad_()
    with trial_blocks("rmsnorm", {"block_rows": 16}):
        y = port_ops.rmsnorm(tx, torch.from_numpy(w))
    assert last_resolution("rmsnorm").provenance == "trial"
    assert y.grad_fn.block_rows == 16
    y.backward(torch.from_numpy(dy))
    assert last_resolution("rmsnorm").provenance == "trial"  # not again


def test_block_rows_heuristic_flag_and_limits():
    assert [rk.pick_block_rows(r, 64) for r in (5, 4096, 8192, 100000)] \
        == [5, 8, 8, 128]
    assert last_resolution("rmsnorm").provenance == "default"
    set_flags({"rmsnorm_block_rows": 32})
    assert rk.pick_block_rows(4096, 64) == 32
    assert last_resolution("rmsnorm").provenance == "flag"
    set_flags({"rmsnorm_block_rows": 4096})
    with pytest.raises(ValueError, match="1..1024"):
        rk.pick_block_rows(4096, 64)
    assert rk.pick_block_rows(100, 64) == 100   # clamped to the rows
    with pytest.raises(ValueError, match="1..1024"):
        rk.rmsnorm_fwd(torch.zeros(2048, 8), torch.ones(8), block_rows=2048)


def test_cpu_path_launches_nothing_and_bad_inputs_raise():
    port_cuda.reset_launch_counts()
    x, w, dy = _data(6, 16, 8)
    tx = torch.from_numpy(x).requires_grad_()
    port_ops.rmsnorm(tx, torch.from_numpy(w)).backward(torch.from_numpy(dy))
    counts = port_cuda.launch_counts()
    assert {k: counts[k] for k in ("rmsnorm_fwd", "rmsnorm_bwd",
                                   "rmsnorm_dw")} == {
        "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "rmsnorm_dw": 0}
    with pytest.raises(ValueError, match=r"\[rows, d\]"):
        port_ops.rmsnorm(torch.zeros(4, 8), torch.ones(7))
    with pytest.raises(ValueError, match=r"\[rows, d\]"):
        port_ops.rmsnorm(torch.zeros(2, 4, 8), torch.ones(8))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        port_ops.rmsnorm(torch.zeros(4, 8, dtype=torch.float16),
                         torch.ones(8))
    with pytest.raises(ValueError, match="dy must match"):
        rk.rmsnorm_bwd(torch.zeros(4, 8), torch.ones(8), torch.zeros(4, 7))
