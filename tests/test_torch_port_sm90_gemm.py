"""The arithmetic of the two kernels on the Hopper GEMM core, on the CPU.

``paddle_tpu_torch/ops/cuda/csrc/sm90.cuh`` forms 128-row x 256-column fp32
tiles of bf16 products with ``wgmma``; two epilogues use it. The kernels
run only on the card (``chip_smoke.py``); the helpers below compute what
each of them computes, tile by tile, in fp32 on bf16-representable inputs
made with numpy from a seed:

* ``gmm_fwd`` (``csrc/grouped_matmul.cu``): per 128-row tile, one full-tile
  product for each group g < G that the shared predicate admits (gid min
  <= g <= gid max over the tile's rows, rows past M counting as trash),
  only the rows with ``gids == g`` stored; rows no pass matched are zero.
  Its passes must equal ``expected_visit_counts(gids, G, 128)``, its result
  ``grouped_matmul_reference`` bit for bit (the reference's masked sum adds
  exact zeros to every row), a numpy per-row reference within 1e-5, and
  JAX ``grouped_matmul(backend="xla")`` on block-aligned layouts within
  ``tests/test_torch_port_gmm.py``'s tolerances (fp32 1e-5, bf16 1e-3).
* ``ce_stats`` (``csrc/fused_ce.cu``): per vocab split of the plan the
  wrapper computes (``_split``), 256-column tiles folded into a running
  (m, s, t, sl) with exp2 and log2(e) folded in, columns past V left out,
  then the splits merged as ``ce_stats_merge_kernel`` merges them. Held to
  ``chip_smoke.py``'s CE rule (m, lse and t within 1e-3, sl within 1e-5 *
  V) against ``ce_stats_reference`` and against the statistics of JAX
  ``fused_linear_cross_entropy_loss(variant="tokens")``: its per-token loss
  is lse for a label past the vocab, lse - t for a label inside it, and
  lse - sl / V at label smoothing 1.
* the split plan: every 256-column vocab tile in exactly one split, none
  empty, token blocks x splits within one wave of 132 SMs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy_loss
from paddle_tpu.ops.pallas.grouped_matmul import \
    grouped_matmul as jax_grouped_matmul
from paddle_tpu_torch.ops.cuda import fused_ce as fc
from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

TILE_M, TILE_N = 128, 256     # csrc/sm90.cuh kBM, kBN
LOG2E = 1.4426950408889634
NEG_INF = -1e30
CE_TOL = 1e-3                 # chip_smoke.py: m, lse, t
CE_SL_TOL = 1e-5              # chip_smoke.py: sl, times V
SMS = 132                     # the H100's SMs
IGN = -100


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float()


# ---------------------------------------------------------------------------
# gmm_fwd: one full-tile product a pass, rows selected on store
# ---------------------------------------------------------------------------

def _gmm_tiled(x, w, gids):
    """(y fp32 [M, h], passes per 128-row tile) as the bf16 kernel computes
    them; x [M, d] and w [G, d, h] fp32 holding bf16 values."""
    m, num_groups = x.shape[0], w.shape[0]
    y = torch.full((m, w.shape[2]), float("nan"))
    passes = []
    for m0 in range(0, m, TILE_M):
        g = gids[m0:m0 + TILE_M]
        pad = torch.full((TILE_M - len(g),), num_groups, dtype=g.dtype)
        gfull = torch.cat([g, pad])
        gmin, gmax = int(gfull.min()), int(gfull.max())
        n = 0
        for grp in range(num_groups):
            if not gmin <= grp <= gmax:
                continue
            prod = x[m0:m0 + TILE_M] @ w[grp]     # every row of the tile
            sel = g == grp
            y[m0:m0 + TILE_M][sel] = prod[sel]
            n += 1
        y[m0:m0 + TILE_M][(g < 0) | (g >= num_groups)] = 0.0
        passes.append(n)
    return y, np.array(passes, np.int32)


def _aligned_gids(rs, n_blocks, bm, num_groups, trash_blocks=1, skip=()):
    """The dispatcher's layout: bm-row blocks of one group each, sorted,
    then trash blocks; groups in `skip` get no block (empty)."""
    keep = [g for g in range(num_groups) if g not in skip]
    blk = np.sort(rs.choice(keep, n_blocks - trash_blocks))
    blk = np.concatenate([blk, np.full(trash_blocks, num_groups)])
    return np.repeat(blk, bm).astype(np.int32)


def _unaligned_gids(num_groups=5, trash=11):
    """``tests/test_torch_port_gmm.py``'s layout: groups of 13, 0, 21, 7
    and 30 rows (group 1 empty), then trash: 82 rows."""
    sizes = [13, 0, 21, 7, 30]
    return np.concatenate([np.full(n, g) for g, n in enumerate(sizes)]
                          + [np.full(trash, num_groups)]).astype(np.int32)


def _layout(name):
    """(gids, groups, the layout's block_rows or None when unaligned)."""
    rs = np.random.RandomState(7)
    if name == "aligned_bm128":
        return _aligned_gids(rs, 6, 128, 4), 4, 128
    if name == "aligned_bm64":           # 128-row tiles hold two groups
        return _aligned_gids(rs, 12, 64, 4, trash_blocks=2), 4, 64
    if name == "unaligned_82":
        return _unaligned_gids(), 5, None
    if name == "trash_tile":             # the last 128-row tile is all trash
        g = np.concatenate([np.repeat([0, 0, 2], 64), np.full(64, 3),
                            np.full(128, 3)]).astype(np.int32)
        return g, 3, 64
    if name == "empty_group":            # group 2 has no rows
        return _aligned_gids(rs, 8, 128, 4, skip=(2,)), 4, 128
    raise KeyError(name)


GMM_LAYOUTS = ["aligned_bm128", "aligned_bm64", "unaligned_82",
               "trash_tile", "empty_group"]


def _gmm_inputs(seed, gids, num_groups, d=32, h=48):
    rs = np.random.RandomState(seed)
    x = _bf16(rs.randn(len(gids), d) * 0.5)
    w = _bf16(rs.randn(num_groups, d, h) * 0.1)
    return x, w


def _numpy_rows(x, w, gids):
    y = np.zeros((x.shape[0], w.shape[2]), np.float64)
    for i, g in enumerate(gids):
        if 0 <= g < w.shape[0]:
            y[i] = x[i].astype(np.float64) @ w[g].astype(np.float64)
    return y


@pytest.mark.parametrize("layout", GMM_LAYOUTS)
def test_gmm_tile_passes_match_references(layout):
    gids, num_groups, _ = _layout(layout)
    x, w = _gmm_inputs(1, gids, num_groups)
    tg = torch.from_numpy(gids)
    y, passes = _gmm_tiled(x, w, tg)
    assert not torch.isnan(y).any()              # every row was stored
    ref = gm.grouped_matmul_reference(x, w, tg)
    assert torch.equal(y, ref)
    np.testing.assert_allclose(y.numpy(), _numpy_rows(x.numpy(), w.numpy(),
                                                      gids),
                               rtol=1e-5, atol=1e-5)
    trash = gids >= num_groups
    assert not y.numpy()[trash].any()
    if len(gids) % TILE_M == 0:
        np.testing.assert_array_equal(
            passes, gm.expected_visit_counts(gids, num_groups, TILE_M))
    if layout == "aligned_bm128":                # one group a tile
        assert passes.max() == 1
    if layout == "aligned_bm64":
        assert passes.max() == 2
    if layout == "trash_tile":
        assert passes[-1] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["aligned_bm128", "aligned_bm64",
                                    "trash_tile", "empty_group"])
def test_gmm_tile_passes_match_jax_xla_twin(layout, dtype):
    gids, num_groups, bm = _layout(layout)
    x, w = _gmm_inputs(2, gids, num_groups)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jy = jax_grouped_matmul(jnp.asarray(x.numpy(), jdt),
                            jnp.asarray(w.numpy(), jdt), jnp.asarray(gids),
                            block_rows=bm, backend="xla")
    y, _ = _gmm_tiled(x, w, torch.from_numpy(gids))
    tol = 1e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(y.numpy(), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# ce_stats: 256-column tiles over the split plan, then the merge
# ---------------------------------------------------------------------------

def _ce_tiled(x, w, labels, sms=SMS):
    """(m, s, t, sl) fp32 [N] as the bf16 kernel and its merge compute
    them; x [N, H], w [V, H] fp32 holding bf16 values, labels int."""
    n, v = x.shape[0], w.shape[0]
    nsplit, per = fc._split(n, v, sms)
    lab = labels.long()
    part = torch.empty((4, nsplit, n))
    for j in range(nsplit):
        m = torch.full((n,), NEG_INF)
        s, t, sl = torch.zeros(n), torch.zeros(n), torch.zeros(n)
        for v0 in range(j * per * TILE_N, min(v, (j + 1) * per * TILE_N),
                        TILE_N):
            logits = x @ w[v0:v0 + TILE_N].T           # TMA: no row past V
            col = torch.arange(v0, v0 + logits.shape[1])
            nm = torch.maximum(m, logits.amax(1))
            nml = nm * LOG2E
            s = s * torch.exp2((m - nm) * LOG2E) + torch.exp2(
                logits * LOG2E - nml[:, None]).sum(1)
            m = nm
            sl = sl + logits.sum(1)
            t = t + torch.where(col[None, :] == lab[:, None], logits,
                                0.0).sum(1)
        part[:, j] = torch.stack([m, s, t, sl])
    mx = part[0].amax(0)
    return (mx, (part[1] * torch.exp(part[0] - mx)).sum(0), part[2].sum(0),
            part[3].sum(0))


CE_CASES = {
    # V not a multiple of 256, N not a multiple of 128, ignored labels and
    # a label equal to V in each
    "n300_h64_v1000": dict(n=300, h=64, v=1000),
    "n130_h48_v777": dict(n=130, h=48, v=777),
    "n1000_h32_v5000": dict(n=1000, h=32, v=5000),
    "n256_h64_v513": dict(n=256, h=64, v=513),
}


def _ce_inputs(seed, n, h, v):
    rs = np.random.RandomState(seed)
    x = _bf16(rs.randn(n, h))
    w = _bf16(rs.randn(v, h) * 0.3)
    lab = rs.randint(0, v, n).astype(np.int32)
    lab[::7] = IGN
    lab[3] = v                               # past the vocab: t = 0
    return x, w, lab


def _ce_errs(got, want):
    (m, s, t, sl), (wm, ws, wt, wsl) = got, want
    lse, wlse = m + torch.log(s), wm + torch.log(ws)
    return {k: (a - b).abs().max().item() for k, a, b in (
        ("m", m, wm), ("lse", lse, wlse), ("t", t, wt), ("sl", sl, wsl))}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_ce_tiles_match_reference(case):
    n, h, v = (CE_CASES[case][k] for k in ("n", "h", "v"))
    x, w, lab = _ce_inputs(3, n, h, v)
    got = _ce_tiled(x, w, torch.from_numpy(lab))
    errs = _ce_errs(got, fc.ce_stats_reference(x, w, torch.from_numpy(lab)))
    assert max(errs["m"], errs["lse"], errs["t"]) <= CE_TOL, errs
    assert errs["sl"] <= CE_SL_TOL * v, errs
    assert not got[2][torch.from_numpy((lab < 0) | (lab >= v))].any()


def _jax_nll(x, w, lab, **kw):
    return np.asarray(fused_linear_cross_entropy_loss(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy().T), jnp.asarray(lab),
        ignore_index=IGN, variant="tokens", mp_axis=None, **kw))


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_ce_tiles_match_jax_statistics(case):
    n, h, v = (CE_CASES[case][k] for k in ("n", "h", "v"))
    x, w, lab = _ce_inputs(4, n, h, v)
    m, s, t, sl = _ce_tiled(x, w, torch.from_numpy(lab))
    lse = (m + torch.log(s)).numpy()
    # JAX's loss of a label past the vocab is lse; of a label inside it
    # lse - t; at label smoothing 1, lse - sl / V
    jax_lse = _jax_nll(x, w, np.full(n, v, np.int32))
    jax_t = jax_lse - _jax_nll(x, w, lab)
    jax_sl = v * (jax_lse - _jax_nll(x, w, np.full(n, v, np.int32),
                                     label_smoothing=1.0))
    assert np.abs(lse - jax_lse).max() <= CE_TOL
    valid = lab != IGN
    assert np.abs(t.numpy() - jax_t)[valid].max() <= CE_TOL
    assert np.abs(sl.numpy() - jax_sl).max() <= CE_SL_TOL * v


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, v", [(4096, 32000), (1000, 32000), (300, 1000),
                                  (20000, 32000), (1, 1), (4097, 50304)])
def test_split_covers_every_vocab_tile_once(n, v):
    nsplit, per = fc._split(n, v, SMS)
    tiles = -(-v // TILE_N)
    owner = np.concatenate([np.full(per, j) for j in range(nsplit)])[:tiles]
    assert len(owner) == tiles                   # every tile has a split
    assert np.array_equal(np.unique(owner), np.arange(nsplit))  # none empty
    blocks = -(-n // TILE_M)
    assert blocks * nsplit <= max(SMS, blocks)   # within one wave


def test_split_plan_is_pure_in_the_sm_count():
    assert fc._split(4096, 32000, 132) == (4, 32)   # the LLaMA step
    assert fc._split(4096, 32000, 132) == fc._split(4096, 32000, 132)
    assert fc._split(4096, 32000, 64) == (2, 63)
    assert fc._split(4096, 32000, 16) == (1, 125)
