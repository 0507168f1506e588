"""The RMSNorm ring kernels (``csrc/rmsnorm.cu`` ``rmsnorm_fwd_ring_kernel``,
``rmsnorm_bwd_ring_kernel``) on the CPU, where no kernel runs.

* Their arithmetic, emulated in numpy in their order: thread t of the T
  that hold a row (a block's, or a warp's for a row of at most 32 shares)
  sums its elements (vectors t, t + T, ... of the plan, each element in
  order, by fused multiply-adds), then its warp's shuffle tree (xor 16,
  8, 4, 2, 1), then (a block a row) the warp sums in order; dw summed in
  registers row by row (a warp a row: each warp's rows, then the warps in
  order) and the partials summed by the dw kernel's fixed order. Held
  against the JAX kernel body ``_rmsnorm_fwd_kernel`` run on numpy refs
  and ``jax.vjp`` of its formula (``rmsnorm_kernel.py:47-63``), within
  1e-5 of max |ref| in fp32, at d 128, 1000, 1024, 4096 and 8192, fp32
  and ``ml_dtypes`` bf16, so the order the ring sums in keeps the fp32
  rule.
* The plan (``rmsnorm_kernel.rmsnorm_plan``): its constants equal the
  ``.cu`` file's, the ring exactly where its rule says, the two-pass
  routes otherwise, shared-memory bytes from the ``.cu`` constants.
* The wrapper passes the plan's route, threads, vectors and stages to the
  C entry points (a fake library).
"""
import re

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.rmsnorm_kernel import _rmsnorm_fwd_kernel
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import rmsnorm_kernel as rk

EPS = 1e-6
WIDTHS = (128, 1000, 1024, 4096, 8192)
_CU = open(f"{_build.CSRC_DIR}/rmsnorm.cu").read()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def _f32(a):
    return np.asarray(a, np.float32)


def _fma(a, b, c):
    """fp32 a * b + c with one rounding: the product of two fp32 values is
    exact in fp64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _holders(plan):
    """The threads that hold a row: the block's, or a warp's."""
    return plan.threads if plan.route == "ring" else 32


def _row_sum(a, b, plan, v):
    """sum over each row of a * b [rows, d] as the ring sums it: thread t
    of the row's holders sums its elements (vector t + T*j, element e, in
    that order) by fused multiply-adds, then the warp's xor shuffle tree,
    then the warp sums in order."""
    rows, d = a.shape
    nv, T = d // v, _holders(plan)
    acc = np.zeros((rows, T), np.float32)
    t = np.arange(T)
    for j in range(plan.vecs):
        c = t + T * j
        for e in range(v):
            idx = np.minimum(c * v + e, d - 1)
            acc = np.where(c < nv, _fma(a[:, idx], b[:, idx], acc), acc)
    acc = acc.reshape(rows, T // 32, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lane ^ o]
    tot = np.zeros(rows, np.float32)
    for k in range(T // 32):
        tot = tot + acc[:, k, 0]
    return tot


def _rstd(tot, d):
    return np.float32(1) / np.sqrt(tot / np.float32(d) + np.float32(EPS))


def ring_fwd(x, w, dtype, br=8):
    """The forward ring kernel's fp32 y (before its one rounding)."""
    d = x.shape[1]
    plan = rk.rmsnorm_plan("fwd", d, dtype, br)
    assert plan.route.startswith("ring")
    v = 16 // dtype.itemsize
    rstd = _rstd(_row_sum(x, x, plan, v), d)[:, None]
    return x * rstd * w


def ring_bwd(x, w, dy, dtype, br):
    """The backward ring kernel's fp32 dx and dw. A block's partial of dw
    adds dy*x*rstd row by row in order: a block a row over the block's
    rows; a warp a row over each warp's rows (rows r, r + 8, ... of the
    block for warp r), then the warps' sums in order. dw sums the partials
    as the dw kernel does: warp k of 8 takes partials k, k + 8, ..., then
    the 8 warp sums in order."""
    rows, d = x.shape
    plan = rk.rmsnorm_plan("bwd", d, dtype, br)
    assert plan.route.startswith("ring")
    v = 16 // dtype.itemsize
    dyw = dy * w
    rstd = _rstd(_row_sum(x, x, plan, v), d)[:, None]
    proj = (_row_sum(dyw, x, plan, v) / np.float32(d))[:, None]
    dx = rstd * _fma(-(x * (rstd * rstd)), proj, dyw)
    holders = 1 if plan.route == "ring" else plan.threads // 32
    nb = -(-rows // br)
    part = np.zeros((nb, d), np.float32)
    for b in range(nb):
        sums = np.zeros((holders, d), np.float32)
        for i in range(b * br, min(rows, b * br + br)):
            h = (i - b * br) % holders
            sums[h] = _fma(dy[i] * x[i], rstd[i], sums[h])
        for h in range(holders):
            part[b] = part[b] + sums[h]
    warps = np.zeros((8, d), np.float32)
    for k in range(nb):
        warps[k % 8] = warps[k % 8] + part[k]
    dw = np.zeros(d, np.float32)
    for k in range(8):
        dw = dw + warps[k]
    return dx, dw


def _data(seed, rows, d, np_dtype):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np_dtype)
    w = (1.0 + 0.1 * rs.randn(d)).astype(np_dtype)
    dy = rs.randn(rows, d).astype(np_dtype)
    return x, w, dy


def _formula(x, w):
    """The kernels' formula (rmsnorm_kernel.py:47-51) in fp32."""
    rstd = jax.lax.rsqrt(jnp.mean(x * x, -1, keepdims=True) + EPS)
    return x * rstd * w


DTYPES = [(torch.float32, np.float32), (torch.bfloat16, ml_dtypes.bfloat16)]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype,np_dtype", DTYPES, ids=["fp32", "bf16"])
def test_ring_forward_order_matches_jax_kernel_body(d, dtype, np_dtype):
    x, w, _ = _data(d, 6, d, np_dtype)
    got = ring_fwd(_f32(x), _f32(w), dtype)
    # the JAX body in fp32 on the same (bf16-valued) inputs: the order of
    # the sums is all that differs
    want = np.empty((6, d), np.float32)
    _rmsnorm_fwd_kernel(x, w.reshape(1, -1), want, eps=EPS)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if np_dtype is ml_dtypes.bfloat16:
        # rounded once to bf16, as the kernel stores y: at most one bf16
        # ulp (2^-7 of the value) from the body's own bf16 output
        out = np.empty_like(x)
        _rmsnorm_fwd_kernel(x, w.reshape(1, -1), out, eps=EPS)
        err = np.abs(_f32(got.astype(np_dtype)) - _f32(out))
        assert (err <= 2.0 ** -7 * np.abs(_f32(out))).all()
        assert (err > 0).mean() < 0.01      # and nearly always none


@pytest.mark.parametrize("d", WIDTHS + (512,))
@pytest.mark.parametrize("dtype,np_dtype", DTYPES, ids=["fp32", "bf16"])
def test_ring_backward_order_matches_jax_vjp(d, dtype, np_dtype):
    # three blocks of 16 rows, the last one ragged (5 rows); at 512 a
    # warp a row, two stages a block
    rows, br = 37, 16
    x, w, dy = (_f32(a) for a in _data(d + 1, rows, d, np_dtype))
    dx, dw = ring_bwd(x, w, dy, dtype, br)
    _, vjp = jax.vjp(_formula, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    assert np.abs(dx - want_dx).max() <= 1e-5 * np.abs(want_dx).max()
    assert np.abs(dw - want_dw).max() <= 1e-5 * np.abs(want_dw).max()


def test_ring_emulation_agrees_with_the_plain_versions():
    # the plain versions the CPU path runs and the ring's order, fp32
    x, w, dy = _data(7, 21, 4096, np.float32)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    y = rk.rmsnorm_reference(tx, tw, EPS).numpy()
    assert np.abs(ring_fwd(x, w, torch.float32) - y).max() \
        <= 1e-5 * np.abs(y).max()
    pdx, pdw = (t.numpy() for t in rk.rmsnorm_bwd_reference(tx, tw, tdy,
                                                            EPS, 8))
    dx, dw = ring_bwd(x, w, dy, torch.float32, 8)
    assert np.abs(dx - pdx).max() <= 1e-5 * np.abs(pdx).max()
    assert np.abs(dw - pdw).max() <= 1e-5 * np.abs(pdw).max()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _snake(name):                   # kRingMaxThreads -> RING_MAX_THREADS
    return re.sub(r"(?<!^)([A-Z])", r"_\1", name[1:]).upper()


def test_plan_constants_are_the_cu_files():
    names = re.findall(r"constexpr int (kRing\w+) = \d+;", _CU)
    assert {"kRingTargetThreads", "kRingMaxThreads", "kRingWarpThreads",
            "kRingFwdMaxElems", "kRingBwdMaxElems", "kRingMinStages",
            "kRingMaxStages", "kRingStageBudget", "kRingSmemLimit"} \
        <= set(names)
    for name in names:
        if name != "kRingMaxWarps":
            assert getattr(rk, _snake(name)) == _cu_const(name), name
    assert list(range(len(rk.ROUTES))) == [
        _cu_const("kRouteScalar"), _cu_const("kRouteVector"),
        _cu_const("kRouteRing"), _cu_const("kRouteRingWarp")]
    assert rk.MAX_BLOCK_ROWS == _cu_const("kMaxBlockRows")
    # 227 KB a block (232,448 bytes) less 1 KB for the static barriers
    # and warp sums
    assert _cu_const("kRingSmemLimit") == 232448 - 1024


def _ring_rule(kind, d, es):
    """The ring's route from the .cu constants, or None: whole 16-byte
    vectors; a warp a row where 32 lanes at the warp's elements a lane hold
    the row; else a block a row, the fewest vectors a thread (a power of 2
    up to the kind's elements a thread) that keeps the block within the
    target threads, at most the maximum threads; the minimum stages within
    the shared-memory limit."""
    v = 16 // es
    if d % v:
        return None
    nv = d // v
    most = _cu_const("kRingFwdMaxElems" if kind == "fwd"
                     else "kRingBwdMaxElems") // v
    tensors = 1 if kind == "fwd" else 2
    if d <= 32 * _cu_const("kRingWarpMaxElems"):
        route, threads = "ring_warp", _cu_const("kRingWarpThreads")
        per = threads // 32
    else:
        vecs = 1
        while vecs < most and -(-nv // vecs) > _cu_const(
                "kRingTargetThreads"):
            vecs *= 2
        route, threads, per = "ring", 32 * -(-nv // (32 * vecs)), 1
    fits = (threads <= _cu_const("kRingMaxThreads")
            and _cu_const("kRingMinStages") * per * d * es * tensors
            <= _cu_const("kRingSmemLimit"))
    return route if fits else None


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_takes_the_ring_exactly_where_its_rule_holds(kind, dtype):
    es, v = dtype.itemsize, 16 // dtype.itemsize
    widths = sorted({1, 7, 8, 100, 512, 520, 1000, 1001, 1024, 1032, 4096,
                     5000, 8192, 12288, 16384, 16392, 24576, 32768, 40000,
                     65536} | set(range(8, 70000, 1992)))
    for d in widths:
        for br in (1, 3, 8, 512):
            p = rk.rmsnorm_plan(kind, d, dtype, br)
            route = _ring_rule(kind, d, es)
            if route:
                per = p.threads // 32 if route == "ring_warp" else 1
                stage = per * d * es * (1 if kind == "fwd" else 2)
                holders = 32 if route == "ring_warp" else p.threads
                most = (rk.RING_WARP_MAX_ELEMS if route == "ring_warp"
                        else rk.RING_FWD_MAX_ELEMS if kind == "fwd"
                        else rk.RING_BWD_MAX_ELEMS) // v
                assert p.route == route, (d, br)
                assert p.threads % 32 == 0 and p.vecs <= most
                assert holders * p.vecs * v >= d         # every vector
                # no idle warp, no vectors a thread to spare
                assert route == "ring_warp" or (p.threads - 32) * p.vecs \
                    * v < d
                assert route == "ring" or (p.vecs == 1 or 16 * p.vecs * v
                                           < d)
                assert 1 <= p.stages <= min(-(-br // per),
                                            _cu_const("kRingMaxStages"))
                assert p.smem_bytes == p.stages * stage \
                    <= _cu_const("kRingSmemLimit")
            else:
                assert p.route == ("two_pass_scalar" if d * es % 16
                                   else "two_pass_vector"), (d, br)
                assert (p.threads, p.vecs, p.stages, p.smem_bytes) == (
                    _cu_const("kThreads"), 0, 0, 0)
            # unaligned bases never take a vector route
            assert rk.rmsnorm_plan(kind, d, dtype, br,
                                   aligned=False).route == "two_pass_scalar"


def test_plan_at_the_cases_chip_smoke_drives():
    bf, f32 = torch.bfloat16, torch.float32
    plan = rk.rmsnorm_plan
    # LLaMA's width: 2 vectors a thread of 256; 4 stages of 8 KB forward,
    # 3 of 16 KB (x and dy) backward
    assert plan("fwd", 4096, bf, 8) == ("ring", 256, 2, 4, 32768)
    assert plan("bwd", 4096, bf, 8) == ("ring", 256, 2, 3, 49152)
    # GPT-MoE's 1024 forward: a warp a row, 4 vectors a lane, 8 rows (16
    # KB) a stage, one stage for a block of 8 rows, 2 for 16
    assert plan("fwd", 1024, bf, 8) == ("ring_warp", 256, 4, 1, 16384)
    assert plan("fwd", 1024, bf, 16) == ("ring_warp", 256, 4, 2, 32768)
    # and its backward: 8 rows of x and of dy (32 KB) a stage
    assert plan("bwd", 1024, bf, 8) == ("ring_warp", 256, 4, 1, 32768)
    # 1000 bf16 is 125 vectors: whole, on the ring
    assert plan("fwd", 1000, bf, 8).route == "ring_warp"
    assert plan("bwd", 1000, f32, 8).route == "ring_warp"
    # 1032 goes a block a row: 129 vectors, a block of 160 threads in the
    # forward (32 elements a thread), 160 in the backward at fp32 (16)
    assert plan("fwd", 1032, bf, 8) == ("ring", 160, 1, 4, 8256)
    assert plan("bwd", 1032, f32, 8) == ("ring", 160, 2, 4, 33024)
    # a block of 2 rows needs 2 stages, one row 1
    assert plan("fwd", 4096, bf, 2).stages == 2
    assert plan("fwd", 4096, bf, 1).stages == 1
    # the scalar path: 1001 bf16 is not whole 16-byte vectors
    assert plan("fwd", 1001, bf, 8).route == "two_pass_scalar"
    assert plan("bwd", 1001, bf, 8).route == "two_pass_scalar"
    # LLaMA-2-70B's 8192: the backward at 512 threads of 2 vectors
    assert plan("fwd", 8192, bf, 8) == ("ring", 256, 4, 3, 49152)
    assert plan("bwd", 8192, bf, 8) == ("ring", 512, 2, 2, 65536)
    # past the ring: fp32 16384's backward (512 threads of 4 vectors
    # cover 8192), fp32 32768 in both kernels
    assert plan("fwd", 16384, f32, 8) == ("ring", 512, 8, 2, 131072)
    assert plan("bwd", 16384, f32, 8).route == "two_pass_vector"
    assert plan("fwd", 32768, f32, 8).route == "two_pass_vector"
    assert plan("bwd", 32768, f32, 8).route == "two_pass_vector"
    with pytest.raises(ValueError, match="'fwd' or 'bwd'"):
        plan("dw", 4096, bf, 8)


def test_heuristic_spreads_a_few_rows_over_the_sms(monkeypatch):
    h = rk._heuristic_block_rows
    rows = (8, 100, 500, 4096, 4097, 8192, 100000)
    # on a card: at most rows / SMs rows a block, so the decode batch's 8
    # rows take 8 blocks; a warp a row takes 32 rows a block where there
    # are rows for it; without an SM count (the CPU) the old rule
    assert [h(r, 132) for r in rows] == [1, 1, 4, 8, 8, 8, 128]
    assert [h(r, 132, True) for r in rows] == [1, 1, 4, 32, 32, 32, 128]
    assert [h(r) for r in rows] == [h(r, None, True) for r in rows] \
        == [8, 8, 8, 8, 8, 8, 128]
    assert rk._sm_count("cpu") is None
    # pick_block_rows asks the plan whether the width goes a warp a row
    monkeypatch.setattr(rk, "_sm_count", lambda device: 132)
    assert rk.pick_block_rows(8192, 1024, dtype="bfloat16") == 32
    assert rk.pick_block_rows(8192, 4096, dtype="bfloat16") == 8
    assert rk.pick_block_rows(8192, 1001, dtype="bfloat16") == 8
    assert rk.pick_block_rows(8, 1024, dtype="bfloat16") == 1


# ---------------------------------------------------------------------------
# the wrapper and the C entries
# ---------------------------------------------------------------------------

def _entry_params(name):
    sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', _CU).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("d,dtype,w_dtype,offset", [
    (4096, torch.bfloat16, torch.bfloat16, 0),     # ring
    (4096, torch.bfloat16, torch.float32, 0),      # ring, fp32 w
    (1024, torch.float32, torch.float32, 0),       # a warp a row (fwd)
    (8192, torch.bfloat16, torch.bfloat16, 0),     # ring, 512 threads bwd
    (1001, torch.bfloat16, torch.bfloat16, 0),     # two passes, scalar
    (32768, torch.float32, torch.float32, 0),      # two passes, vectors
    (1024, torch.float32, torch.float32, 1),       # an unaligned x: scalar
])
def test_wrapper_passes_the_plan_to_the_c_entry(monkeypatch, kind, d, dtype,
                                                w_dtype, offset):
    seen = {}

    def fake(name, nargs_ptr, nargs_int, has_eps):
        params = _entry_params(name)

        def call(*args):
            assert len(args) == len(params) == nargs_ptr + 3 + 1 \
                + nargs_int + 1
            seen.update(zip(params, args))
            return 0
        return call

    monkeypatch.setattr(rk, "_fn", fake)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    rows, br = 20, 8
    x = torch.zeros(rows * d + offset, dtype=dtype)[offset:].view(rows, d)
    w = torch.ones(d, dtype=w_dtype)
    out = torch.zeros(rows, d, dtype=dtype)
    tensors = ((x, w, out) if kind == "fwd" else
               (x, w, torch.zeros(rows, d, dtype=dtype), out,
                torch.zeros(-(-rows // br), d)))
    rk.reset_launches()
    got = rk._launch(kind, tensors, br, EPS)
    want = rk.rmsnorm_plan(kind, d, dtype, br, aligned=offset == 0)
    assert got == want
    assert (seen["route"], seen["threads"], seen["vecs"], seen["stages"]) \
        == (rk.ROUTES.index(want.route), want.threads, want.vecs,
            want.stages)
    assert (seen["rows"], seen["d"], seen["br"]) == (rows, d, br)
    assert seen["x"] == x.data_ptr() and seen["w"] == w.data_ptr()
    assert (seen["x_bf16"], seen["w_bf16"]) == (
        int(dtype == torch.bfloat16), int(w_dtype == torch.bfloat16))
    assert rk.launch_counts()[f"rmsnorm_{kind}"] == 1
    if offset:
        assert want.route == "two_pass_scalar"


def test_a_refused_launch_raises(monkeypatch):
    monkeypatch.setattr(rk, "_fn", lambda *a: (lambda *args: 1))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: _Stream())
    x = torch.zeros(4, 64)
    rk.reset_launches()
    with pytest.raises(RuntimeError, match="rmsnorm_fwd launch failed"):
        rk._launch("fwd", (x, torch.ones(64), torch.zeros(4, 64)), 4, EPS)
    assert rk.launch_counts()["rmsnorm_fwd"] == 0
