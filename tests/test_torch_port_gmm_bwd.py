"""The grouped matmul's fp32 backward on Hopper's tensor cores, on the CPU.

``paddle_tpu_torch/ops/cuda/csrc/grouped_matmul.cu`` computes the JAX
VJP's fp32 products (dx = dy . w[g]^T, dw[g] = x_g^T dy_g) as split TF32
on ``csrc/sm90.cuh``: each fp32 A value a = hi + lo, hi = tf32(a) rounded
as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero: the low
13 bits of the fp32 pattern rounded away), lo = tf32(a - hi); a . b is
hi . b + lo . b, plus hi . b_lo when b is not exact in TF32 (a bf16 value
is, so the main path takes 2 passes). The kernels run only on the card
(``chip_smoke.py``); the helpers below compute what they compute, tile by
tile, on inputs made with numpy from a seed:

* dx (``gmm_fwd_tf32_kernel``): per 128-row tile, one full-tile product
  for each group the predicate admits over 32-deep stages, B = w[g] as it
  lies (K-major for this product), only that group's rows stored, trash
  rows zero;
* dw (``gmm_dw_tf32_kernel``): per group, dw[g]^T = dy_g^T . x_g over the
  32-row chunks whose gid range admits g, the rows of other groups zeroed
  in A before the split, B = x^T; a group with no rows gives zeros.

They are held against ``jax.vjp`` of ``grouped_matmul(backend="xla")`` on
block-aligned layouts at ``tests/test_torch_port_gmm.py``'s fp32
tolerance (1e-5) and, row by row, at 1e-5 of each row's max |ref|, a rule
that one TF32 pass fails; and against the plain versions and a numpy
per-row reference on an unaligned layout. Then the wrappers' layout work:
the K-major operands (``tf32_operand`` and the dw transpose pass's x^T,
``_dw_operand`` here), the pass count they derive from the dtypes, and
the dw walk's chunk ranges (``_dw_chunk_ranges``) against the JAX
predicate (``expected_visit_counts`` at the chunk depth).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.grouped_matmul import \
    grouped_matmul as jax_grouped_matmul
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

TILE_M = 128           # csrc/sm90.cuh kBM
DEPTH = 32             # csrc/sm90.cuh kBK32: fp32 values a stage
CHUNK = 32             # csrc/grouped_matmul.cu kChunk: token rows a dw stage
TOL = 1e-5             # tests/test_torch_port_gmm.py, fp32


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float()


def _rna(a):
    """cvt.rna.tf32.f32 on the bit pattern: add half of the 13 dropped
    bits' weight to the magnitude, then clear them."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u.astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(
        np.uint32).view(np.float32)


def _split(t):
    hi = torch.from_numpy(_rna(t.numpy()))
    return hi, torch.from_numpy(_rna((t - hi).numpy()))


def _stage(acc, a, b, b_lo=None, passes=3):
    """One stage of the consumers' products: acc + hi . b, then + lo . b
    (passes >= 2), then + hi . b_lo (passes 3, b_lo given), fp32. a
    [rows, k], b and b_lo [k, cols]. passes 1 is a single TF32 product."""
    hi, lo = _split(a)
    acc = acc + hi @ b
    if passes >= 2:
        acc = acc + lo @ b
    if passes >= 3 and b_lo is not None:
        acc = acc + hi @ b_lo
    return acc


def _split_product(a, b, b_lo=None, passes=3):
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], DEPTH):
        s = slice(k0, k0 + DEPTH)
        acc = _stage(acc, a[:, s], b[s], None if b_lo is None else b_lo[s],
                     passes)
    return acc


def _dw_operand(x):
    """gmm_dw's B operand as its transpose kernel makes it on the card:
    ``x^T`` [d, M] in fp32 with the wrapper's row stride (M rounded up to a
    multiple of 4 for TMA's 16-byte strides; the columns past M are never
    read), split when x is fp32: (hi, lo or None, passes)."""
    m, d = x.shape
    buf = torch.zeros((d, gm._dw_ld(m)), dtype=torch.float32)
    buf[:, :m] = x.T
    if x.dtype == torch.bfloat16:
        return buf[:, :m], None, 2
    hi, lo = gm.tf32_split(buf)
    return hi[:, :m], lo[:, :m], 3


def _dw_chunk_ranges(gids):
    """The dw walk's pre-pass (``gmm_dw_walk_kernel``): per 32-row chunk,
    the (min, max) gid of its rows (int32 [chunks, 2]; the last chunk may
    be short). A tile of group g walks the chunks with min <= g <= max,
    the shared predicate."""
    g = gids.to(torch.int32)
    pad = -g.shape[0] % CHUNK
    big = torch.iinfo(torch.int32).max
    lo = torch.cat([g, g.new_full((pad,), big)]).reshape(-1, CHUNK)
    hi = torch.cat([g, g.new_full((pad,), -big)]).reshape(-1, CHUNK)
    return torch.stack([lo.amin(1), hi.amax(1)], 1)


def _dx_tiled(dy, w, gids, passes=None):
    """dx [M, d] = dy . w[g]^T as the forward kernel computes it, over the
    wrapper's B operand (``tf32_operand``: w as it lies, [G, d (N),
    h (K)]) in the wrapper's passes, or in `passes` (1: one TF32 product;
    2 drops an fp32 B's third)."""
    m, num_groups = dy.shape[0], w.shape[0]
    hi, lo, wrapper_passes = gm.tf32_operand(w)
    passes = passes or wrapper_passes
    out = torch.full((m, w.shape[1]), float("nan"))
    for m0 in range(0, m, TILE_M):
        g = gids[m0:m0 + TILE_M]
        gfull = torch.cat([g, torch.full((TILE_M - len(g),), num_groups,
                                         dtype=g.dtype)])
        for grp in range(num_groups):
            if not int(gfull.min()) <= grp <= int(gfull.max()):
                continue
            b_lo = lo[grp].T if lo is not None else None
            prod = _split_product(dy[m0:m0 + TILE_M], hi[grp].T, b_lo,
                                  passes)
            sel = g == grp
            out[m0:m0 + TILE_M][sel] = prod[sel]
        out[m0:m0 + TILE_M][(g < 0) | (g >= num_groups)] = 0.0
    return out


def _dw_tiled(x, dy, gids, num_groups, passes=None):
    """dw [G, d, h] as the dw kernel computes it: dw[g]^T over the chunks
    whose range (``_dw_chunk_ranges``) admits g, rows of other groups
    zeroed in A = dy_g^T, B = the x^T of ``_dw_operand``, in its passes or
    in `passes` (as ``_dx_tiled``)."""
    hi, lo, operand_passes = _dw_operand(x)               # [d, M (K)]
    passes = passes or operand_passes
    out = torch.zeros((num_groups, x.shape[1], dy.shape[1]))
    for grp in range(num_groups):
        acc = torch.zeros((dy.shape[1], x.shape[1]))
        for ci, (g0, g1) in enumerate(_dw_chunk_ranges(gids).tolist()):
            if not g0 <= grp <= g1:
                continue
            rows = slice(ci * CHUNK, (ci + 1) * CHUNK)
            a = torch.where((gids[rows] == grp)[None, :], dy[rows].T, 0.0)
            b_lo = lo[:, rows].T if lo is not None else None
            acc = _stage(acc, a, hi[:, rows].T, b_lo, passes)
        out[grp] = acc.T
    return out


def _aligned_gids(rs, n_blocks, bm, num_groups, trash_blocks=1, skip=()):
    keep = [g for g in range(num_groups) if g not in skip]
    blk = np.sort(rs.choice(keep, n_blocks - trash_blocks))
    blk = np.concatenate([blk, np.full(trash_blocks, num_groups)])
    return np.repeat(blk, bm).astype(np.int32)


def _layout(name):
    """(gids, groups, block_rows or None when unaligned)."""
    rs = np.random.RandomState(11)
    if name == "aligned_bm128":
        return _aligned_gids(rs, 5, 128, 4), 4, 128
    if name == "aligned_bm64":           # 128-row tiles hold two groups
        return _aligned_gids(rs, 10, 64, 4, trash_blocks=2), 4, 64
    if name == "aligned_bm8":            # 32-row chunks hold several
        return _aligned_gids(rs, 40, 8, 5, trash_blocks=3), 5, 8
    if name == "empty_group":            # group 2 has no rows
        return _aligned_gids(rs, 6, 128, 4, skip=(2,)), 4, 128
    if name == "unaligned_82":           # groups of 13, 0, 21, 7, 30 rows
        sizes = [13, 0, 21, 7, 30]
        g = np.concatenate([np.full(n, i) for i, n in enumerate(sizes)]
                           + [np.full(11, 5)])
        return g.astype(np.int32), 5, None
    raise KeyError(name)


ALIGNED = ["aligned_bm128", "aligned_bm64", "aligned_bm8", "empty_group"]


def _inputs(seed, gids, num_groups, d, h):
    """x and w bf16 (as the model's are), dy fp32 of gradient scale."""
    rs = np.random.RandomState(seed)
    x = _bf16(rs.randn(len(gids), d)).to(torch.bfloat16)
    w = _bf16(rs.randn(num_groups, d, h) * 0.02).to(torch.bfloat16)
    dy = torch.from_numpy((rs.randn(len(gids), h) * 1e-3).astype(np.float32))
    return x, w, dy


def _rows_ok(out, ref):
    """chip_smoke.py's fp32 row rule at this file's tolerance: each row
    (the last axis) within TOL of its own max |ref|, so an error is
    measured against the values it sits among."""
    err = np.abs(np.asarray(out, np.float64) - ref).max(-1)
    return bool((err <= TOL * np.abs(ref).max(-1)).all())


def _jax_vjp(x, w, dy, gids, bm):
    def f(a, b):
        return jax_grouped_matmul(a, b, jnp.asarray(gids), block_rows=bm,
                                  backend="xla")

    _, vjp = jax.vjp(f, jnp.asarray(x.float().numpy()),
                     jnp.asarray(w.float().numpy()))
    jdx, jdw = vjp(jnp.asarray(dy.numpy()))
    return np.asarray(jdx, np.float32), np.asarray(jdw, np.float32)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

def test_tf32_round_is_cvt_rna():
    one = 1.0
    cases = {one + 2.0 ** -11: one + 2.0 ** -10,     # a tie: away from 0
             -(one + 2.0 ** -11): -(one + 2.0 ** -10),
             one + 2.0 ** -11 - 2.0 ** -23: one,     # below the tie
             one + 3 * 2.0 ** -11: one + 2 * 2.0 ** -10,
             1.5: 1.5, 0.0: 0.0, -2.0 ** -20: -2.0 ** -20}
    got = gm.tf32_round(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())
    rs = np.random.RandomState(0)
    t = torch.from_numpy((rs.randn(4096) * 10.0 ** rs.uniform(
        -8, 8, 4096)).astype(np.float32))
    r = gm.tf32_round(t)
    assert torch.equal(r, torch.from_numpy(_rna(t.numpy())))
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((r - t).abs() <= 2.0 ** -11 * t.abs()).all()


def test_tf32_split_keeps_fp32():
    rs = np.random.RandomState(1)
    t = torch.from_numpy((rs.randn(1 << 14) * 10.0 ** rs.uniform(
        -6, 6, 1 << 14)).astype(np.float32))
    hi, lo = gm.tf32_split(t)
    want_hi, want_lo = _split(t)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (t.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * t.double().abs()).all()


def test_bf16_values_split_with_zero_lo_so_two_passes_equal_three():
    """A bf16 operand takes the 2-pass route; the same values in fp32 take
    3 passes, whose third adds exact zeros."""
    gids, num_groups, _ = _layout("aligned_bm64")
    x, w, dy = _inputs(2, gids, num_groups, 48, 40)
    for b in (x, w):
        hi, lo = gm.tf32_split(b.float())
        assert torch.equal(hi, b.float()) and not lo.any()
    assert gm.tf32_operand(w)[2] == 2 and gm.tf32_operand(w.float())[2] == 3
    assert _dw_operand(x)[2] == 2 and _dw_operand(x.float())[2] == 3
    tg = torch.from_numpy(gids)
    assert torch.equal(_dx_tiled(dy, w, tg), _dx_tiled(dy, w.float(), tg))
    assert torch.equal(_dw_tiled(x, dy, tg, num_groups),
                       _dw_tiled(x.float(), dy, tg, num_groups))


def test_single_tf32_pass_is_100x_worse_than_the_split_at_depth_4096():
    """The design's reason: one TF32 pass keeps about 3 decimal digits, the
    split keeps fp32's, at the backward's depths."""
    rs = np.random.RandomState(3)
    a = torch.from_numpy((rs.randn(64, 4096) * 1e-3).astype(np.float32))
    b = _bf16(rs.randn(4096, 64) * 0.02)
    ref = a.double() @ b.double()
    split = (_split_product(a, b).double() - ref).abs().max().item()
    hi, _ = _split(a)
    single = ((hi @ b).double() - ref).abs().max().item()
    assert single >= 100 * split, (single, split)
    assert split <= TOL * ref.abs().max().item()


# ---------------------------------------------------------------------------
# dx and dw, tile by tile, against the JAX VJP and the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,h", [(48, 40), (96, 64)])
@pytest.mark.parametrize("layout", ALIGNED)
def test_dx_tiles_match_jax_vjp(layout, d, h):
    gids, num_groups, bm = _layout(layout)
    x, w, dy = _inputs(4, gids, num_groups, d, h)
    jdx, _ = _jax_vjp(x, w, dy, gids, bm)
    dx = _dx_tiled(dy, w, torch.from_numpy(gids))
    assert not torch.isnan(dx).any()               # every row was stored
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=TOL, atol=TOL)
    assert _rows_ok(dx.numpy(), jdx)
    assert not dx.numpy()[gids >= num_groups].any()
    # the rule tells the split from the single TF32 pass it replaces
    single = _dx_tiled(dy, w, torch.from_numpy(gids), passes=1)
    assert not _rows_ok(single.numpy(), jdx)


@pytest.mark.parametrize("d,h", [(48, 40), (96, 64)])
@pytest.mark.parametrize("layout", ALIGNED)
def test_dw_tiles_match_jax_vjp(layout, d, h):
    gids, num_groups, bm = _layout(layout)
    x, w, dy = _inputs(5, gids, num_groups, d, h)
    _, jdw = _jax_vjp(x, w, dy, gids, bm)
    dw = _dw_tiled(x, dy, torch.from_numpy(gids), num_groups)
    np.testing.assert_allclose(dw.numpy(), jdw, rtol=TOL, atol=TOL)
    assert _rows_ok(dw.numpy(), jdw)
    if layout == "empty_group":
        assert not dw[2].any()
    single = _dw_tiled(x, dy, torch.from_numpy(gids), num_groups, passes=1)
    assert not _rows_ok(single.numpy(), jdw)


def test_unaligned_layout_matches_plain_versions_and_numpy_rows():
    gids, num_groups, _ = _layout("unaligned_82")
    x, w, dy = _inputs(6, gids, num_groups, 32, 24)
    tg = torch.from_numpy(gids)
    dx = _dx_tiled(dy, w, tg)
    dw = _dw_tiled(x, dy, tg, num_groups)
    want_dx = np.zeros((len(gids), 32))
    want_dw = np.zeros((num_groups, 32, 24))
    xd, wd, dyd = (t.double().numpy() for t in (x, w, dy))
    for i, g in enumerate(gids):
        if g < num_groups:
            want_dx[i] = wd[g] @ dyd[i]
            want_dw[g] += np.outer(xd[i], dyd[i])
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=TOL, atol=TOL)
    assert _rows_ok(dx.numpy(), want_dx) and _rows_ok(dw.numpy(), want_dw)
    np.testing.assert_allclose(
        dx.numpy(), gm.grouped_matmul_reference(dy, w.transpose(1, 2),
                                                tg).numpy(),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        dw.numpy(), gm.grouped_matmul_dw_reference(x, dy, tg,
                                                   num_groups).numpy(),
        rtol=TOL, atol=TOL)
    assert not dx.numpy()[gids >= num_groups].any()   # trash rows
    assert not dw[1].any()                            # the empty group


@pytest.mark.parametrize("product", ["dx", "dw"])
def test_fp32_operands_take_three_passes(product):
    """An fp32 B (the tiny fp32 MoE, the tuning probe) is not exact in
    TF32: its lo part is the third pass, and the result holds fp32's
    tolerance; dropping it would not."""
    gids, num_groups, _ = _layout("unaligned_82")
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(len(gids), 64).astype(np.float32))
    w = torch.from_numpy((rs.randn(num_groups, 64, 48) * 0.02)
                         .astype(np.float32))
    dy = torch.from_numpy(rs.randn(len(gids), 48).astype(np.float32))
    tg = torch.from_numpy(gids)
    xd, wd, dyd = (t.double().numpy() for t in (x, w, dy))
    if product == "dx":
        got3, got2 = (_dx_tiled(dy, w, tg, passes) for passes in (3, 2))
        ref = np.zeros((len(gids), 64))
        for i, g in enumerate(gids):
            if g < num_groups:
                ref[i] = wd[g] @ dyd[i]
        assert gm.tf32_operand(w)[2] == 3
    else:
        got3, got2 = (_dw_tiled(x, dy, tg, num_groups, passes)
                      for passes in (3, 2))
        ref = np.zeros((num_groups, 64, 48))
        for i, g in enumerate(gids):
            if g < num_groups:
                ref[g] += np.outer(xd[i], dyd[i])
        assert _dw_operand(x)[2] == 3
    scale = np.abs(ref).max()
    err3 = np.abs(got3.double().numpy() - ref).max()
    err2 = np.abs(got2.double().numpy() - ref).max()
    assert err3 <= TOL * scale
    assert err2 >= 10 * err3


# ---------------------------------------------------------------------------
# the wrappers' layout work
# ---------------------------------------------------------------------------

def test_tf32_operand_layouts_and_passes():
    rs = np.random.RandomState(8)
    w16 = torch.from_numpy(rs.randn(3, 16, 24).astype(np.float32)).to(
        torch.bfloat16)
    # dx: w [G, d, h] as it lies is K-major for dy . w[g]^T
    hi, lo, passes = gm.tf32_operand(w16)
    assert passes == 2 and lo is None and hi.dtype == torch.float32
    assert hi.is_contiguous() and torch.equal(hi, w16.float())
    # a plain fp32 forward: the K-major copy of w^T, split
    w32 = torch.from_numpy(rs.randn(3, 16, 24).astype(np.float32))
    hi, lo, passes = gm.tf32_operand(w32.transpose(1, 2))
    assert passes == 3 and hi.shape == (3, 24, 16)
    assert hi.is_contiguous() and lo.is_contiguous()
    assert torch.equal(hi, gm.tf32_round(w32.transpose(1, 2)))
    assert ((hi + lo - w32.transpose(1, 2)).abs()
            <= 2.0 ** -22 * w32.transpose(1, 2).abs()).all()


@pytest.mark.parametrize("rows", [82, 128, 33])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dw_operand_is_padded_k_major_x_transpose(rows, dtype):
    rs = np.random.RandomState(rows)
    x = torch.from_numpy(rs.randn(rows, 20).astype(np.float32)).to(dtype)
    hi, lo, passes = _dw_operand(x)
    assert hi.shape == (20, rows) and hi.dtype == torch.float32
    assert hi.stride() == (-(-rows // 4) * 4, 1)     # 16-byte row strides
    if dtype == torch.bfloat16:
        assert passes == 2 and lo is None
        assert torch.equal(hi, x.T.float())
    else:
        assert passes == 3 and lo.stride() == hi.stride()
        assert torch.equal(hi, gm.tf32_round(x.T))
        assert torch.equal(lo, gm.tf32_round(x.T - hi))


@pytest.mark.parametrize("layout", ALIGNED + ["unaligned_82"])
def test_dw_chunk_walk_matches_jax_predicate(layout):
    gids, num_groups, _ = _layout(layout)
    ranges = _dw_chunk_ranges(torch.from_numpy(gids)).numpy()
    assert ranges.shape == (-(-len(gids) // CHUNK), 2)
    walked = np.array([sum(lo <= g <= hi for g in range(num_groups))
                       for lo, hi in ranges], np.int32)
    # the predicate over whole chunks: repeating the last row adds no id
    pad = np.full(-len(gids) % CHUNK, gids[-1], np.int32)
    want = gm.expected_visit_counts(np.concatenate([gids, pad]), num_groups,
                                    CHUNK)
    np.testing.assert_array_equal(walked, want)
    # every row of a group lies in a chunk its walk visits
    for i, g in enumerate(gids):
        if g < num_groups:
            lo, hi = ranges[i // CHUNK]
            assert lo <= g <= hi


def test_cpu_gmm_dx_is_the_plain_version_and_launches_nothing():
    gids, num_groups, _ = _layout("unaligned_82")
    _, w, dy = _inputs(9, gids, num_groups, 32, 24)
    tg = torch.from_numpy(gids)
    port_cuda.reset_launch_counts()
    dx = gm.gmm_dx(dy, w, tg)
    assert torch.equal(dx, gm.grouped_matmul_reference(
        dy, w.transpose(1, 2), tg))
    assert port_cuda.launch_counts()["gmm_fwd"] == 0
    with pytest.raises(ValueError):
        gm.gmm_dx(dy, w.transpose(1, 2), tg)
