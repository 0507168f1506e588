"""The block-visit, page-visit and grouped visit counters
(``csrc/flash_fwd.cu`` ``flash_visit_kernel``, ``csrc/paged_attention.cu``
``page_visit_kernel``, ``csrc/grouped_matmul.cu`` ``gmm_visit_kernel``) on
the CPU, where no kernel runs.

* The plain versions against the JAX package: the flash counter against
  ``segment_block_visit_counts(..., interpret=True)`` with bq != bk, not
  causal, rows of one segment, many short segments and pads; the page
  counter against JAX's ``_seg_blocks_can_touch`` evaluated on numpy
  arrays (JAX's ``page_visit_counts`` cannot run here: its ``x64_off``
  import fails with this jax).
* The kernels' work, emulated from ``visit_plan`` and the ``.cu`` files'
  constants: which CTA, warp, lane group and load reduce each block's
  ids, which warp, ballot step and lane test each (q block, kb < last)
  pair, which warp and lane each page; every pair, id and page exactly
  once, and the emulated counts equal the plain versions. Shared memory
  within 48 KB (so without the opt-in, and within 227 KB) up to S 131072
  at 64 x 64; the tiled tables at bq = bk = 1.
* The grouped counter's work, emulated from ``gmm_visit_plan``: which
  warp and lane group read each block_rows block (16-byte loads where the
  ids allow), which ballot and lane test each (block, group) pair, on the
  dispatcher's layouts at 8 and 64 experts and unaligned blocks of 8;
  every id and pair exactly once, the counts equal
  ``expected_visit_counts``, the grid within one wave.
* The wrappers pass the plan to the C entries as their signatures name the
  arguments (a fake library), and a refused launch raises.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _seg_blocks_can_touch
from paddle_tpu.ops.pallas.flash_attention import \
    segment_block_visit_counts as jax_segment_visits
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
from paddle_tpu_torch.ops.cuda import paged_attention as pa

_FWD_CU = open(f"{_build.CSRC_DIR}/flash_fwd.cu").read()
_PAGED_CU = open(f"{_build.CSRC_DIR}/paged_attention.cu").read()
_GMM_CU = open(f"{_build.CSRC_DIR}/grouped_matmul.cu").read()
SMS = 132
SMEM_NO_OPT_IN, SMEM_MAX = 48 * 1024, 232448


def _cu_const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _packed(rng, b, s, min_len, max_len, pad=None):
    """Rows of documents back to back (non-decreasing ids), the tail
    padded with `pad` when given."""
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        pos, j = 0, 0
        while pos < s:
            n = min(int(rng.integers(min_len, max_len + 1)), s - pos)
            seg[r, pos:pos + n] = j
            pos, j = pos + n, j + 1
        if pad is not None:
            cut = int(rng.integers(s // 2, s))
            seg[r, cut:] = pad
    return seg


def _segments(kind, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "one_segment":
        return np.zeros((b, s), np.int32)
    if kind == "short_segments":
        return _packed(rng, b, s, 1, 9)
    if kind == "documents":
        return _packed(rng, b, s, 20, 300)
    if kind == "padded":                  # the engine frame's pad segment
        return _packed(rng, b, s, 10, 120, pad=7)
    if kind == "random":                  # any int32, not sorted
        return rng.integers(-2**31, 2**31 - 1, (b, s), dtype=np.int64
                            ).astype(np.int32)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["one_segment", "short_segments",
                                  "documents", "padded", "random"])
@pytest.mark.parametrize("block_q, block_k, causal", [
    (64, 64, True), (64, 64, False), (32, 64, True), (64, 16, True),
    (128, 32, False), (16, 16, True)])
def test_flash_plain_version_equals_jax(kind, block_q, block_k, causal):
    seg = _segments(kind, 2, 256, seed=block_q + block_k)
    want = np.asarray(jax_segment_visits(seg, block_q, block_k,
                                         causal=causal, interpret=True))
    got = fa.segment_block_visit_reference(torch.from_numpy(seg), block_q,
                                           block_k, causal)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU tensor takes the plain version
    np.testing.assert_array_equal(
        fa.segment_block_visit_counts(torch.from_numpy(seg), block_q,
                                      block_k, causal).numpy(), want)


def _page_lens(rng, b, ps, pages):
    cap = ps * pages
    edge = [0, -1, -1000, 1, ps - 1, ps, ps + 1, cap - 1, cap, cap + 1,
            2**31 - 1]
    return np.concatenate([np.array(edge, np.int32),
                           rng.integers(0, cap + 3 * ps, b, dtype=np.int32)])


@pytest.mark.parametrize("ps, pages", [(1, 256), (4, 256), (16, 256),
                                       (16, 0), (16, 33), (7, 5)])
def test_page_plain_version_equals_jax_predicate(ps, pages):
    lens = _page_lens(np.random.default_rng(ps * 100 + pages), 64, ps, pages)
    first = (np.arange(pages, dtype=np.int32) * ps)[None, :]
    hit = np.asarray(_seg_blocks_can_touch(
        np.int32(0), (lens.astype(np.int64) - 1)[:, None],
        first, first + ps - 1))
    want = hit.sum(axis=1) if pages else np.zeros(len(lens), np.int64)
    got = pa.page_visit_reference(torch.from_numpy(lens), ps, pages)
    np.testing.assert_array_equal(got.numpy(), want)
    closed = np.clip(-(-lens.astype(np.int64) // ps), 0, pages)
    np.testing.assert_array_equal(got.numpy(), closed)
    np.testing.assert_array_equal(
        pa.page_visit_counts(torch.from_numpy(lens), ps, pages).numpy(),
        want)


# ---------------------------------------------------------------------------
# the kernels' work plan, emulated
# ---------------------------------------------------------------------------

def test_plan_constants_are_the_cu_files():
    assert fa.VISIT_K_TILE == _cu_const(_FWD_CU, "kVisitKTile")
    assert fa.VISIT_MAX_QCHUNK == _cu_const(_FWD_CU, "kVisitMaxQChunk")
    assert fa.VISIT_MIN_THREADS == _cu_const(_FWD_CU, "kVisitMinThreads")
    assert fa.VISIT_MAX_THREADS == _cu_const(_FWD_CU, "kVisitMaxThreads")
    assert fa.VISIT_LOADS == _cu_const(_FWD_CU, "kVisitLoads")
    assert pa.PAGE_VISIT_WARPS == _cu_const(_PAGED_CU, "kPageVisitWarps")
    assert gm.GMM_VISIT_MIN_THREADS == _cu_const(_GMM_CU,
                                                 "kGmmVisitMinThreads")
    assert gm.GMM_VISIT_MAX_THREADS == _cu_const(_GMM_CU,
                                                 "kGmmVisitMaxThreads")
    # the compile-time instantiation is the forward's tiles, the counter's
    # default blocks
    assert _cu_const(_FWD_CU, "kVisitFastBlock") == fa.FWD_BLOCK_Q \
        == fa.FWD_BLOCK_K


UNROLL = _cu_const(_FWD_CU, "kVisitUnroll")


def _lanes_a_block(bs, vec):
    """L of visit_ranges: the least power of two, up to 32, whose lanes
    read a block in UNROLL loads each."""
    per = bs // (4 if vec else 1)
    lanes = 1
    while lanes < min(-(-per // UNROLL), 32):
        lanes *= 2
    return lanes


def _emulate_ranges(row, first, n, bs, vec, warps):
    """visit_ranges<int4 | int>: (min, max) of blocks first .. first + n -
    1 as the kernel's lane groups read them; asserts every id of every
    block is read exactly once, by loads of the block's own group."""
    ids = 4 if vec else 1
    per = bs // ids
    lanes_per = _lanes_a_block(bs, vec)
    assert lanes_per <= per
    groups = 32 // lanes_per
    step = warps * groups
    i = np.arange(n)
    # the pass (w0 = warp * groups + t * step) and the group g of block i
    warp, g, t = (i % step) // groups, (i % step) % groups, i // step
    np.testing.assert_array_equal(warp * groups + t * step + g, i)
    assert (warp < warps).all()
    # a block's loads: lane sub of its group takes loads sub, sub + L, ...
    loads = [j for sub in range(lanes_per) for j in range(sub, per,
                                                          lanes_per)]
    assert sorted(loads) == list(range(per))
    # load j of block blk covers ids off .. off + ids - 1 of the row
    off = first * bs + (i[:, None] * per + np.asarray(loads)[None]) * ids
    if vec:
        assert (off % 4 == 0).all()
    covered = np.sort((off[:, :, None] + np.arange(ids)).reshape(n, -1), 1)
    np.testing.assert_array_equal(
        covered, (first + i)[:, None] * bs + np.arange(bs)[None])
    blocks = row[first * bs:(first + n) * bs].reshape(n, bs)
    return np.stack([blocks.min(1), blocks.max(1)], 1).astype(np.int64)


def _emulate_flash_visit(seg, bq, bk, causal, sms=SMS, aligned=True):
    """flash_visit_kernel by its plan; returns (counts, plan, tiles the
    CTAs took). Asserts each (q block, kb < last) pair is tested by exactly
    one lane of one ballot step of the q block's one owner warp."""
    b, s = seg.shape
    plan = fa.visit_plan(b, s, bq, bk, sms)
    nq, nk = s // bq, s // bk
    vec = aligned and s % 4 == 0
    warps = plan.threads // 32
    counts = np.full((b, nq), -1, np.int64)
    tiles = 0
    for row in range(b):
        for x in range(plan.chunks):                  # blockIdx.x % chunks
            q0 = (plan.chunks - 1 - x) * plan.qchunk
            nqc = min(plan.qchunk, nq - q0)
            kend = -(-(q0 + nqc) * bq // bk) if causal else nk
            if plan.separate_q:
                qtab = _emulate_ranges(seg[row], q0, nqc, bq,
                                       vec and bq % 4 == 0, warps)
            cnt, tested = {}, {j: [] for j in range(nqc)}
            for k0 in range(0, kend, plan.ktile):
                tiles += 1
                k1 = min(kend, k0 + plan.ktile)
                ktab = _emulate_ranges(seg[row], k0, k1 - k0, bk,
                                       vec and bk % 4 == 0, warps)
                owners = {}
                for w in range(warps):
                    for j in range(w, nqc, warps):
                        owners.setdefault(j, []).append(w)
                        qb = q0 + j
                        if plan.separate_q:
                            qmin, qmax = qtab[j]
                        else:
                            assert k0 == 0 and qb < len(ktab)
                            qmin, qmax = ktab[qb]
                        last = -(-(qb + 1) * bq // bk) if causal else nk
                        end = min(last, k1)
                        # ballot steps kb0 = k0, k0 + 32, ... < end, lane
                        # l testing kb0 + l while it is below end
                        steps = -(-max(end - k0, 0) // 32)
                        kb = (k0 + 32 * np.arange(steps)[:, None]
                              + np.arange(32)[None]).ravel()
                        kb = kb[kb < end]
                        kr = ktab[kb - k0]
                        n = int(((kr[:, 0] <= qmax)
                                 & (kr[:, 1] >= qmin)).sum())
                        tested[j].extend(kb.tolist())
                        cnt[j] = (0 if k0 == 0 else cnt[j]) + n
                assert all(len(owners[j]) == 1 for j in range(nqc))
            for j in range(nqc):
                qb = q0 + j
                last = -(-(qb + 1) * bq // bk) if causal else nk
                assert tested[j] == list(range(last)), (qb, last)
                assert counts[row, qb] == -1
                counts[row, qb] = cnt[j]
    assert (counts >= 0).all()
    return counts, plan, tiles


def _check_flash(seg, bq, bk, causal, aligned=True):
    counts, plan, tiles = _emulate_flash_visit(seg, bq, bk, causal,
                                               aligned=aligned)
    want = fa.segment_block_visit_reference(torch.from_numpy(seg), bq, bk,
                                            causal).numpy()
    np.testing.assert_array_equal(counts, want)
    return plan, tiles


@pytest.mark.parametrize("b, s, bq, bk, causal", [
    (1, 256, 64, 64, True),        # the engine frame
    (4, 2048, 64, 64, True),       # the packed frame
    (1, 4096, 64, 64, True),       # the training geometry
    (4, 2048, 64, 64, False),
    (1, 4096, 64, 32, True), (1, 4096, 32, 128, True),
    (2, 1024, 32, 64, False), (3, 768, 48, 96, True),   # blocks % 4 == 0
    (2, 480, 24, 40, True), (1, 96, 3, 6, True),        # odd blocks: ints
    (2, 512, 256, 512, True), (1, 1024, 512, 1024, False),  # > 32 loads
    (200, 128, 64, 64, True),      # more rows than SMs: a CTA a row
])
def test_emulated_kernel_counts_every_pair_once(b, s, bq, bk, causal):
    seg = _segments("documents", b, s, seed=s + bq)
    plan, _ = _check_flash(seg, bq, bk, causal)
    assert plan.chunks * plan.qchunk >= s // bq > (plan.chunks - 1) \
        * plan.qchunk
    if b == 4 and s == 2048:          # the card is not left with 4 CTAs
        assert b * plan.chunks >= SMS // 2


@pytest.mark.parametrize("b, s", [(1, 256), (4, 2048), (1, 4096),
                                  (1, 16384)])
def test_main_path_takes_the_fast_instantiation_in_one_pass(b, s):
    """At the forward's tiles the C entry launches flash_visit_kernel<true>
    (aligned ids, bq == bk == kVisitFastBlock, one K table), and up to S
    16384 each CTA reads its K blocks in one pass of one round of loads."""
    bq = bk = _cu_const(_FWD_CU, "kVisitFastBlock")
    plan = fa.visit_plan(b, s, bq, bk, SMS)
    assert not plan.separate_q and s // bk <= plan.ktile
    groups = 32 // _lanes_a_block(bk, True)
    assert plan.threads // 32 * groups >= s // bk      # blocks a pass
    assert bk // 4 <= UNROLL * _lanes_a_block(bk, True)


def test_emulated_kernel_on_unaligned_rows_takes_ints():
    seg = _segments("padded", 2, 512, seed=3)
    _check_flash(seg, 64, 64, True, aligned=False)


def test_bq_bk_one_takes_the_tiled_tables():
    seg = _segments("short_segments", 1, 4096, seed=1)
    plan, tiles = _check_flash(seg, 1, 1, True)
    assert plan.separate_q and plan.ktile == fa.VISIT_K_TILE
    assert tiles > plan.chunks        # the longer chunks take two tiles


@pytest.mark.parametrize("b, s", [(1, 32768), (1, 131072), (4, 2048),
                                  (1, 256), (64, 4096)])
@pytest.mark.parametrize("bq, bk", [(64, 64), (64, 32), (32, 128), (1, 1),
                                    (128, 128)])
def test_plan_limits(b, s, bq, bk):
    plan = fa.visit_plan(b, s, bq, bk, SMS)
    nq, nk = s // bq, s // bk
    # the C entry's smem formula, from its constants
    ktile = min(_cu_const(_FWD_CU, "kVisitKTile"), nk)
    sep = bq != bk or nk > _cu_const(_FWD_CU, "kVisitKTile")
    assert plan.smem_bytes == 8 * (ktile + (plan.qchunk if sep else 0)) \
        + 4 * plan.qchunk
    assert plan.smem_bytes <= SMEM_NO_OPT_IN <= SMEM_MAX
    assert 1 <= plan.qchunk <= fa.VISIT_MAX_QCHUNK
    assert plan.threads % 32 == 0
    assert fa.VISIT_MIN_THREADS <= plan.threads <= fa.VISIT_MAX_THREADS
    # no warp runs more than about S / (threads * 4) loads of the row, nor
    # more than ceil(nk / 32) ballots for a q block it owns
    assert -(-s // (4 * plan.threads)) <= max(
        fa.VISIT_LOADS, -(-s // (4 * fa.VISIT_MAX_THREADS)))
    assert plan.chunks * plan.qchunk >= nq
    if nq >= SMS:                     # a long row spreads over the card
        assert b * plan.chunks >= SMS // 2


def test_page_plan_counts_every_page_once():
    """page_visit_kernel: row b to block b // kPageVisitWarps, warp b %
    kPageVisitWarps; page p to lane p % 32 of ballot step p // 32; the
    int32 predicate counted by ballots equals the plain version."""
    warps = pa.PAGE_VISIT_WARPS
    rng = np.random.default_rng(0)
    for ps, pages in [(1, 256), (4, 256), (16, 256), (16, 0), (16, 33),
                      (7, 5)]:
        lens = _page_lens(rng, 245, ps, pages)     # 256 rows
        b = len(lens)
        blocks = -(-b // warps)
        got = np.full(b, -1, np.int64)
        for blk in range(blocks):
            for w in range(warps):
                row = blk * warps + w
                if row >= b:
                    continue
                n, seen = 0, []
                for p0 in range(0, pages, 32):
                    p = p0 + np.arange(32, dtype=np.int32)
                    live = p < pages
                    first = p * np.int32(ps)               # int32, as p * ps
                    last = first + np.int32(ps - 1)
                    touch = live & (first <= lens[row] - np.int64(1)) \
                        & (last >= 0)
                    n += int(touch.sum())
                    seen.extend(p[live].tolist())
                assert seen == list(range(pages))
                assert got[row] == -1
                got[row] = n
        want = pa.page_visit_reference(torch.from_numpy(lens), ps, pages)
        np.testing.assert_array_equal(got, want.numpy())


# ---------------------------------------------------------------------------
# the grouped visit counter
# ---------------------------------------------------------------------------

def _dispatch_gids(rng, tokens, groups, k, bm):
    """The dropless dispatcher's bucket gids for the top-k of random gate
    logits (``ragged_layout``, as chip_smoke's ``_dispatch_layout``)."""
    from paddle_tpu_torch.incubate.distributed.models.moe.dropless import \
        ragged_layout

    logits = torch.from_numpy(rng.standard_normal((tokens, groups)))
    topi = logits.topk(k, dim=-1).indices.reshape(-1)
    return ragged_layout(topi, groups, bm)[3].numpy().astype(np.int32)


def _unaligned_gids(rng, rows, groups, trash):
    cuts = np.sort(rng.integers(0, rows - trash + 1, groups - 1))
    cuts[1] = cuts[0]                         # group 1 is empty
    gids = np.searchsorted(cuts, np.arange(rows - trash), side="right")
    return np.concatenate([gids, np.full(trash, groups)]).astype(np.int32)


def _emulate_gmm_visit(gids, groups, bm, vec, sms=SMS):
    """gmm_visit_kernel by its plan: warp w of the grid takes blocks w *
    bpw + grp, pass by pass; a block's lane group reads load j with lane
    j % L; lane sub of the group tests g = sub + L * step in each ballot
    step (g0 < G, warp-uniform). Asserts every id is read once by its
    block's group, every (block, g < G) pair tested once, every block
    counted by one lane; returns (counts, plan, passes, ballots a warp)."""
    m = gids.size
    nb = m // bm
    plan = gm.gmm_visit_plan(m, bm, vec, sms)
    lanes, bpw = plan.lanes, plan.blocks_per_warp
    per = bm // 4 if vec else bm
    ids = 4 if vec else 1
    assert lanes * bpw == 32 and (lanes >= per or lanes == 32)
    assert lanes == 1 or lanes // 2 < per       # the least such power
    warps = plan.grid * plan.threads // 32
    counts = np.full(nb, -1, np.int64)
    reads = np.zeros(m, np.int64)
    tests = np.zeros((nb, groups), np.int64)
    passes = 0
    steps = -(-groups // lanes)
    for w in range(warps):
        for b0 in range(w * bpw, nb, warps * bpw):
            passes = max(passes, (b0 - w * bpw) // (warps * bpw) + 1)
            for grp in range(bpw):
                blk = b0 + grp
                if blk >= nb:
                    continue
                lo, hi = np.iinfo(np.int32).max, np.iinfo(np.int32).min
                for sub in range(lanes):
                    for j in range(sub, per, lanes):
                        off = blk * bm + j * ids
                        assert not vec or off % 4 == 0
                        reads[off:off + ids] += 1
                        lo = min(lo, int(gids[off:off + ids].min()))
                        hi = max(hi, int(gids[off:off + ids].max()))
                n = 0
                for g0 in range(0, groups, lanes):
                    for sub in range(lanes):
                        g = g0 + sub
                        if g < groups:
                            tests[blk, g] += 1
                            n += lo <= g <= hi      # blocks_can_touch
                assert counts[blk] == -1
                counts[blk] = n
    np.testing.assert_array_equal(reads, 1)
    np.testing.assert_array_equal(tests, 1)
    assert (counts >= 0).all()
    return counts, plan, passes, steps


@pytest.mark.parametrize("case", ["dispatch_g8", "dispatch_g64",
                                  "unaligned_bm8", "unaligned_bm8_ints",
                                  "bm32", "bm256", "bm12", "tokens_1m"])
def test_emulated_gmm_visit_counts_every_pair_once(case):
    rng = np.random.default_rng(14)
    vec = True
    if case.startswith("dispatch"):
        groups = 8 if case == "dispatch_g8" else 64
        bm = gm.pick_block_rows(4 * 2048 * 2, groups)
        gids = _dispatch_gids(rng, 4 * 2048, groups, 2, bm)
    elif case.startswith("unaligned"):
        groups, bm = 8, 8
        gids = _unaligned_gids(rng, 1000, groups, 37)
        vec = case == "unaligned_bm8"
    elif case == "tokens_1m":         # more warps than one wave holds
        groups, bm = 8, 8
        gids = np.sort(rng.integers(0, groups + 1, 1 << 20)).astype(np.int32)
    else:
        bm = int(case[2:])
        groups = 40
        gids = np.sort(rng.integers(0, groups + 1, bm * 75)).astype(np.int32)
        vec = bm % 4 == 0
    counts, plan, passes, ballots = _emulate_gmm_visit(gids, groups, bm, vec)
    np.testing.assert_array_equal(counts,
                                  gm.expected_visit_counts(gids, groups, bm))
    np.testing.assert_array_equal(
        counts, gm.grouped_matmul_visit_reference(
            torch.from_numpy(gids), groups, bm).numpy())
    assert 1 <= plan.grid <= SMS
    assert plan.threads % 32 == 0
    assert gm.GMM_VISIT_MIN_THREADS <= plan.threads \
        <= gm.GMM_VISIT_MAX_THREADS
    if case.startswith("dispatch"):
        # the dispatcher's 128-row blocks: the fast instantiation, a warp
        # a block in one 16-byte load a lane and one pass; G 64 takes two
        # ballots where the parent's lane 0 walked 64 groups
        assert bm == _cu_const(_GMM_CU, "kGmmVisitFastBlock")
        assert (plan.lanes, plan.blocks_per_warp, passes) == (32, 1, 1)
        assert ballots == -(-groups // 32)
    if case == "tokens_1m":
        assert plan.grid == SMS and passes > 1


def _check_gmm_argtypes(real_fn, name, nargs, params):
    """The argtypes `_fn(name, *nargs)` sets follow the C signature."""
    fake = _FakeLib(name)
    orig = _build.load
    _build.load = lambda n: fake
    try:
        fn = real_fn(name, *nargs)
    finally:
        _build.load = orig
    _, pointers = _entry_params(_GMM_CU, name)
    assert len(fn.argtypes) == len(params)
    for p, is_ptr, t in zip(params, pointers, fn.argtypes):
        assert t is (ctypes.c_void_p if is_ptr or p == "stream"
                     else ctypes.c_int), p


def test_gmm_visit_wrapper_passes_the_plan(monkeypatch):
    params, _ = _entry_params(_GMM_CU, "ptt_gmm_visit")
    seen = {}

    def call(*args):
        assert len(args) == len(params)
        seen.update(zip(params, args))
        return 0

    real_fn = gm._fn
    monkeypatch.setattr(gm, "_fn", lambda name, *n: (
        _check_gmm_argtypes(real_fn, name, n, params) or call))
    monkeypatch.setattr(gm, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    for offset, bm, vec in ((0, 128, 1), (1, 128, 0), (0, 8, 1),
                            (0, 6, 0)):
        gids = torch.zeros(1536 + offset, dtype=torch.int32)[offset:]
        gm.reset_launches()
        counts = gm._launch_visit(gids, 8, bm)
        plan = gm.gmm_visit_plan(1536, bm, bool(vec), SMS)
        assert counts.shape == (1536 // bm,) and counts.dtype == torch.int32
        assert (seen["gids"], seen["counts"]) == (gids.data_ptr(),
                                                  counts.data_ptr())
        assert (seen["M"], seen["G"], seen["bm"], seen["vec"]) == \
            (1536, 8, bm, vec)
        assert (seen["grid"], seen["threads"]) == (plan.grid, plan.threads)
        assert gm.launch_counts()["gmm_visit"] == 1
    monkeypatch.setattr(gm, "_fn", lambda name, *_: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="gmm_visit launch failed"):
        gm._launch_visit(torch.zeros(256, dtype=torch.int32), 8, 128)
    assert gm.launch_counts()["gmm_visit"] == 1


# ---------------------------------------------------------------------------
# the wrappers and the C entries
# ---------------------------------------------------------------------------

def _entry_params(src, name):
    sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")], \
        [("*" in p) for p in sig.split(",")]


class _Stream:
    cuda_stream = 0


class _FakeLib:
    def __init__(self, name):
        self.fn = type("Fn", (), {"argtypes": None, "restype": None})()
        setattr(self, name, self.fn)


@pytest.mark.parametrize("src, name, lib, module, getter", [
    (_FWD_CU, "ptt_flash_visit", "flash_fwd", fa, "_lib_visit"),
    (_PAGED_CU, "ptt_page_visit", "paged_attention", pa, "_lib_visit")])
def test_argtypes_follow_the_c_signature(monkeypatch, src, name, lib,
                                         module, getter):
    params, pointers = _entry_params(src, name)
    fake = _FakeLib(name)
    monkeypatch.setattr(_build, "load", lambda n: fake if n == lib else None)
    fn = getattr(module, getter)()
    assert len(fn.argtypes) == len(params)
    for p, is_ptr, t in zip(params, pointers, fn.argtypes):
        assert t is (ctypes.c_void_p if is_ptr or p == "stream"
                     else ctypes.c_int), p


@pytest.mark.parametrize("b, s, bq, bk, causal, offset", [
    (4, 2048, 64, 64, True, 0), (1, 32768, 64, 64, True, 0),
    (1, 4096, 1, 1, True, 0), (2, 4096, 64, 32, False, 0),
    (1, 256, 64, 64, True, 1)])
def test_flash_wrapper_passes_the_plan(monkeypatch, b, s, bq, bk, causal,
                                       offset):
    params, _ = _entry_params(_FWD_CU, "ptt_flash_visit")
    seen = {}

    def call(*args):
        assert len(args) == len(params)
        seen.update(zip(params, args))
        return 0

    monkeypatch.setattr(fa, "_lib_visit", lambda: call)
    monkeypatch.setattr(fa, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    seg = torch.zeros(b * s + offset, dtype=torch.int32)[offset:].view(b, s)
    fa.reset_launches()
    counts = fa._launch_visit(seg, bq, bk, causal)
    plan = fa.visit_plan(b, s, bq, bk, SMS)
    assert counts.shape == (b, s // bq) and counts.dtype == torch.int32
    assert (seen["seg"], seen["counts"]) == (seg.data_ptr(),
                                             counts.data_ptr())
    assert (seen["B"], seen["S"], seen["bq"], seen["bk"], seen["causal"]) \
        == (b, s, bq, bk, int(causal))
    assert (seen["qchunk"], seen["threads"]) == (plan.qchunk, plan.threads)
    assert fa.launch_counts()["flash_visit"] == 1


def test_page_wrapper_passes_its_arguments(monkeypatch):
    params, _ = _entry_params(_PAGED_CU, "ptt_page_visit")
    seen = {}

    def call(*args):
        assert len(args) == len(params)
        seen.update(zip(params, args))
        return 0

    monkeypatch.setattr(pa, "_lib_visit", lambda: call)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    lens = torch.arange(256, dtype=torch.int32)
    pa.reset_launches()
    counts = pa._launch_page_visit(lens, 16, 256)
    assert (seen["lens"], seen["counts"]) == (lens.data_ptr(),
                                              counts.data_ptr())
    assert (seen["B"], seen["ps"], seen["pages_per_seq"]) == (256, 16, 256)
    assert pa.launch_counts()["paged_visit"] == 1


def test_a_refused_launch_raises(monkeypatch):
    monkeypatch.setattr(fa, "_lib_visit", lambda: (lambda *a: 1))
    monkeypatch.setattr(pa, "_lib_visit", lambda: (lambda *a: 1))
    monkeypatch.setattr(fa, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    fa.reset_launches()
    pa.reset_launches()
    with pytest.raises(RuntimeError, match="flash_visit launch failed"):
        fa._launch_visit(torch.zeros(1, 256, dtype=torch.int32), 64, 64,
                         True)
    with pytest.raises(RuntimeError, match="paged_visit launch failed"):
        pa._launch_page_visit(torch.zeros(8, dtype=torch.int32), 16, 256)
    assert fa.launch_counts()["flash_visit"] == 0
    assert pa.launch_counts()["paged_visit"] == 0
