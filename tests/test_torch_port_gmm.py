"""The port's grouped matmul against the JAX package on the CPU.

On CPU tensors ``grouped_matmul`` runs the kernels' plain versions
(``grouped_matmul_reference``, ``grouped_matmul_dw_reference``, the visit
predicate in torch); the hand-written CUDA kernels are held against those
on the card by ``chip_smoke.py``. Here:

* y, dx and dw against JAX ``grouped_matmul(backend="xla")`` (``jax.grad``
  for dx, dw) on dispatcher (block-aligned) layouts with trash rows: fp32
  rtol/atol 1e-5, bf16 inputs 1e-3 (values kept below 0.25 so one bf16
  rounding step of the cast gradients stays inside the tolerance). The
  Pallas kernel cannot run on this tree (ROADMAP C.1), and the XLA twin is
  exact only for block-aligned layouts, so
* an unaligned grouped layout (groups straddling blocks, an empty group,
  trash rows) is held against a numpy per-row reference, fp32 1e-5;
* ``expected_visit_counts`` and the visit plain version against JAX's
  ``expected_visit_counts``; ``pick_block_rows`` against JAX's, flag
  override included; the row-count error.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.ops.pallas.grouped_matmul import \
    expected_visit_counts as jax_expected_visit_counts
from paddle_tpu.ops.pallas.grouped_matmul import \
    grouped_matmul as jax_grouped_matmul
from paddle_tpu.ops.pallas.grouped_matmul import \
    pick_block_rows as jax_pick_block_rows
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda import grouped_matmul as gm


def _aligned_gids(rs, n_blocks, bm, G, trash_blocks=1):
    """The dispatcher's layout: each bm-row block belongs to one group, the
    last blocks are trash."""
    blk = np.sort(rs.randint(0, G, n_blocks - trash_blocks))
    blk = np.concatenate([blk, np.full(trash_blocks, G)])
    return np.repeat(blk, bm).astype(np.int32)


def _unaligned_gids(G=5, trash=11):
    """Groups of 13, 0, 21, 7 and 30 rows (group 1 empty) then trash: 82
    rows, 8-row blocks spanning up to three groups."""
    sizes = [13, 0, 21, 7, 30]
    gids = np.concatenate([np.full(n, g) for g, n in enumerate(sizes)]
                          + [np.full(trash, G)])
    return gids.astype(np.int32)


def _numpy_rows(x, w, gids):
    G = w.shape[0]
    y = np.zeros((x.shape[0], w.shape[2]), np.float64)
    for i, g in enumerate(gids):
        if g < G:
            y[i] = x[i].astype(np.float64) @ w[g].astype(np.float64)
    return y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_xla_twin_on_dispatcher_layout(dtype):
    rs = np.random.RandomState(0)
    bm, G, d, h = 8, 4, 16, 24
    gids = _aligned_gids(rs, 12, bm, G, trash_blocks=2)
    m = gids.size
    x = (rs.randn(m, d) * 0.5).astype(np.float32)
    w = (rs.randn(G, d, h) * 0.1).astype(np.float32)
    ct = (rs.randn(m, h) * 0.05).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)

    def f(xv, wv):
        return jax_grouped_matmul(xv, wv, jnp.asarray(gids), block_rows=bm,
                                  backend="xla")

    jy = f(jx, jw)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(f(a, b) * ct),
                        argnums=(0, 1))(jx, jw)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)
    tx.requires_grad_()
    tw.requires_grad_()
    ty = gm.grouped_matmul(tx, tw, torch.from_numpy(gids), block_rows=bm)
    (ty * torch.from_numpy(ct)).sum().backward()
    assert ty.dtype == torch.float32 and tx.grad.dtype == tdt
    assert tw.grad.dtype == tdt
    tol = 1e-3 if dtype == "bfloat16" else 1e-5
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    np.testing.assert_allclose(ty.detach().numpy(), f32(jy), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               f32(jdx.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               f32(jdw.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    # trash rows give zero outputs and zero input gradients
    trash = gids == G
    assert not ty.detach().numpy()[trash].any()
    assert not tx.grad.float().numpy()[trash].any()


def test_unaligned_layout_matches_numpy_per_row_reference():
    rs = np.random.RandomState(1)
    gids = _unaligned_gids()
    G, m, d, h = 5, gids.size - (gids.size % 8), 16, 24
    gids = gids[:m]
    x = rs.randn(m, d).astype(np.float32)
    w = rs.randn(G, d, h).astype(np.float32)
    dy = rs.randn(m, h).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tg = torch.from_numpy(gids)
    y = gm.grouped_matmul(tx, tw, tg, block_rows=8)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), _numpy_rows(x, w, gids),
                               rtol=1e-5, atol=1e-5)
    # dx[i] = dy[i] @ w[g]^T; dw[g] = x_g^T dy_g, zeros for the empty group
    wt = np.swapaxes(w, 1, 2)
    np.testing.assert_allclose(tx.grad.numpy(), _numpy_rows(dy, wt, gids),
                               rtol=1e-5, atol=1e-5)
    want = np.stack([x[gids == g].T.astype(np.float64) @ dy[gids == g]
                     for g in range(G)])
    np.testing.assert_allclose(tw.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not tw.grad[1].any()
    # the kernels' plain versions directly
    np.testing.assert_allclose(
        gm.grouped_matmul_dw_reference(tx.detach(), torch.from_numpy(dy),
                                       tg, G).numpy(), want, rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("bm", [8, 16])
def test_visit_counts_match_jax_predicate(layout, bm):
    rs = np.random.RandomState(2)
    G = 5 if layout == "unaligned" else 4
    gids = (_unaligned_gids() if layout == "unaligned"
            else _aligned_gids(rs, 10, 16, G))
    gids = gids[:gids.size - gids.size % bm]
    want = jax_expected_visit_counts(gids, G, bm)
    got = gm.grouped_matmul_visit_counts(torch.from_numpy(gids), G, bm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gm.expected_visit_counts(gids, G, bm),
                                  want)
    if layout == "aligned":
        # one group per real block, none for trash blocks
        real = gids.reshape(-1, bm)[:, 0] < G
        np.testing.assert_array_equal(want, real.astype(np.int32))


@pytest.fixture
def block_rows_flag():
    yield
    set_flags({"moe_block_rows": 0})
    jax_set_flags({"moe_block_rows": 0})


@pytest.mark.parametrize("n_rows,groups", [(16384, 8), (1000, 8), (256, 8),
                                           (64, 4), (7, 3), (0, 1)])
def test_pick_block_rows_matches_jax(n_rows, groups, block_rows_flag):
    assert gm.pick_block_rows(n_rows, groups) == \
        jax_pick_block_rows(n_rows, groups)
    set_flags({"moe_block_rows": 16})
    jax_set_flags({"moe_block_rows": 16})
    assert gm.pick_block_rows(n_rows, groups) == 16 == \
        jax_pick_block_rows(n_rows, groups)


def test_row_count_error_names_its_source(block_rows_flag):
    x, w = torch.zeros(12, 8), torch.zeros(2, 8, 8)
    gids = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="caller-supplied"):
        gm.grouped_matmul(x, w, gids, block_rows=8)
    with pytest.raises(ValueError, match="auto-picked"):
        gm.grouped_matmul(x, w, gids)
    set_flags({"moe_block_rows": 5})
    with pytest.raises(ValueError, match="FLAGS_moe_block_rows override"):
        gm.grouped_matmul(x, w, gids)
    with pytest.raises(ValueError, match="gids shape"):
        gm.grouped_matmul(x, w, gids[:4])


def test_cpu_tensors_launch_no_kernel_and_counters_register():
    port_cuda.reset_launch_counts()
    rs = np.random.RandomState(3)
    gids = torch.from_numpy(_aligned_gids(rs, 4, 8, 2))
    x = torch.randn(32, 8, requires_grad=True)
    w = torch.randn(2, 8, 8, requires_grad=True)
    gm.grouped_matmul(x, w, gids).sum().backward()
    gm.grouped_matmul_visit_counts(gids, 2, 8)
    counts = port_cuda.launch_counts()
    assert {"gmm_fwd", "gmm_dw", "gmm_visit"} <= set(counts)
    assert not any(counts.values())
