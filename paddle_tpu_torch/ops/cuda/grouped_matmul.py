"""Grouped (ragged) matmul over expert buckets, the dropless-MoE compute
primitive: the hand-written Hopper kernels, their plain PyTorch versions,
and the ``torch.autograd.Function`` around them
(``paddle_tpu/ops/pallas/grouped_matmul.py`` counterpart).

Replaces ``_gmm_fwd_kernel`` (``grouped_matmul.py:98``, ``pallas_call`` at
:142), ``_gmm_dw_kernel`` (:117, call :161) and the visit counter
``_visit_kernel`` (:291, call :314) with ``csrc/grouped_matmul.cu``. All
products run on the shared Hopper GEMM core (``csrc/sm90.cuh``): a
persistent grid of one block an SM walks 128-row x 256-column output
tiles, a producer warp brings K slices by TMA into an ``mbarrier`` ring and
two consumer warpgroups run ``wgmma`` and store fp32 straight from their
accumulators.

* ``gmm_fwd``: ``y[i] = x[i] @ w[gids[i]]`` in fp32. bf16 x and w: one
  bf16 product, 64-deep slices, w read MN-major as it lies. fp32 x and w:
  split TF32 (below) over the wrapper's K-major copy of ``w^T``. A tile
  reads its rows' group range once and runs one full product for each
  group the shared ``blocks_can_touch`` predicate admits, storing only
  that group's rows, so it is exact for any grouped layout, not only the
  dispatcher's block-aligned one; rows that no pass matched (``gids ==
  G``, trash) are zero.
* ``gmm_dx``: ``dx[i] = dy[i] @ w[gids[i]]^T``, the VJP's dx: the same
  split-TF32 kernel over fp32 dy, with ``w`` as it lies (``[G, d, h]`` is
  K-major for this product) in fp32.
* ``gmm_dw``: ``dw[g] = sum over the rows of g of x[i]^T dy[i]``, as
  ``dw[g]^T = dy_g^T . x_g`` in split TF32: dy comes as it lies (read
  transposed into registers, other groups' rows zeroed there), x as an
  fp32 copy ``x^T`` [d, M] that a transpose kernel makes first (split into
  hi and lo for fp32 x); a tile walks only the 32-row chunks whose gid
  range admits its group, and is stored transposed.
* ``gmm_visit``: per ``block_rows`` block, the number of groups the
  predicate admits; it must equal ``expected_visit_counts``. A block goes
  to a group of lanes that reads it in one load a lane (16-byte loads when
  the ids allow) and counts its groups a warp ballot at a time, on the
  grid ``gmm_visit_plan`` sizes.

What bounds them on the H100: operations (2 * rows * d * h flops a
product, hundreds per byte moved at the MoE widths; the bf16 forward's
fp32 y comes close at h 4096). The backward's products are fp32 as in the
JAX VJP (dy is fp32 because the forward returns fp32). They run on the
tensor cores as split TF32: a = hi + lo with hi = tf32(a) rounded to
nearest and lo = tf32(a - hi), and a . b = hi . b + lo . b, plus hi . b_lo
when b is not exact in TF32. A bf16 b is (its lo is zero), so the main
path's products take 2 passes at 495 TFLOP/s, an fp32 b 3. The kernel
splits the fp32 A side in registers. B must be K-major (TF32 ``wgmma``
has no transpose) and fp32, split into hi and lo when it is not exact in
TF32: for the forward and dx the wrapper makes it (``tf32_operand``), for
dw the transpose pass; the wrapper says the pass count from the dtypes.

On a CUDA tensor each entry point launches its kernel or raises; on a CPU
tensor it runs the plain version. The CUDA tile is not the layout's
``block_rows``: that only sets the row alignment the dispatcher pads to and
the row-count check. ``LAUNCHES`` counts kernel launches by name: the
forward entry's bf16 kernel as ``gmm_fwd``, its split-TF32 kernel (the
fp32 forward and dx) as ``gmm_fwd_tf32``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from paddle_tpu_torch.ops.cuda.flash_attention import _sm_count

__all__ = ["grouped_matmul", "GroupedMatmul", "grouped_matmul_reference",
           "grouped_matmul_dw_reference", "grouped_matmul_visit_counts",
           "grouped_matmul_visit_reference", "expected_visit_counts",
           "pick_block_rows", "gmm_fwd", "gmm_dx", "gmm_dw", "tf32_round",
           "tf32_split", "tf32_operand", "GmmVisitPlan", "gmm_visit_plan",
           "LAUNCHES", "reset_launches", "launch_counts"]

_DW_CHUNK = 32          # token rows a gmm_dw stage (csrc kChunk)

LAUNCHES = {"gmm_fwd": 0, "gmm_fwd_tf32": 0, "gmm_dw": 0, "gmm_visit": 0}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _heuristic_block_rows(n_rows: int, num_groups: int) -> int:
    for bm in (128, 32, 8):
        if n_rows >= bm * max(num_groups, 1):
            return bm
    return 8


def pick_block_rows(n_rows: int, num_groups: int, device=None) -> int:
    """Row alignment of the expert buckets, through the shared resolver
    (``grouped_matmul.py:67``): FLAGS_moe_block_rows override > tuning-cache
    entry > 128 when buckets are large enough that per-group padding stays
    small, stepping down to 32 and 8 for small problems."""
    from paddle_tpu_torch.tuning.blocks import resolve_blocks

    res = resolve_blocks(
        "grouped_matmul", {"n_rows": n_rows, "num_groups": num_groups},
        default=lambda g: (_heuristic_block_rows(n_rows, num_groups),),
        device=device)
    return res.values["block_rows"]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def grouped_matmul_reference(x, w, gids):
    """Plain version of ``gmm_fwd``: fp32 ``y[i] = x[i] @ w[gids[i]]`` for
    x [M, d], w [G, d, h], gids [M] in [0, G]; exact for any layout (each
    group's product over x with the other rows zeroed adds exact zeros to
    every other row), trash rows zero."""
    xf = x.float()
    y = xf.new_zeros((x.shape[0], w.shape[-1]))
    for g in range(w.shape[0]):
        y += torch.where((gids == g)[:, None], xf, 0.0) @ w[g].float()
    return y


def grouped_matmul_dw_reference(x, dy, gids, num_groups: int):
    """Plain version of ``gmm_dw``: fp32 ``dw[g] = x_g^T dy_g`` [G, d, h]
    over the rows with ``gids == g``; a group with no rows gets zeros."""
    xf, dyf = x.float(), dy.float()
    return torch.stack([torch.where((gids == g)[:, None], xf, 0.0).T @ dyf
                        for g in range(num_groups)])


def grouped_matmul_visit_reference(gids, num_groups: int, block_rows: int):
    """Plain version of ``gmm_visit``: per ``block_rows`` block, the count of
    groups g in [0, G) with ``gmin <= g <= gmax`` (the shared predicate),
    int32."""
    g = gids.reshape(-1, block_rows)
    gs = torch.arange(num_groups, device=gids.device)[None, :]
    hit = (gs <= g.amax(1, keepdim=True)) & (gs >= g.amin(1, keepdim=True))
    return hit.sum(1).to(torch.int32)


def expected_visit_counts(gids, num_groups: int, block_rows: int):
    """The predicate in plain numpy (``grouped_matmul.py:325``): the
    cross-check of the visit counter."""
    g = np.asarray(gids, np.int32).reshape(-1, block_rows)
    gmin = g.min(axis=1)[:, None]
    gmax = g.max(axis=1)[:, None]
    gs = np.arange(num_groups, dtype=np.int32)[None, :]
    return np.logical_and(gs <= gmax, gs >= gmin).sum(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# split TF32 operands
# ---------------------------------------------------------------------------

def tf32_round(t):
    """fp32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to the
    nearest value with the low 13 mantissa bits zero, ties away from zero
    (the magnitude's bits plus half a TF32 ulp, truncated)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """(hi, lo): ``hi = tf32(t)``, ``lo = tf32(t - hi)``, both fp32 holding
    TF32 values; ``t - hi`` is exact in fp32, so hi + lo is t to about
    2^-22 of it."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def tf32_operand(b):
    """The B operand of a split-TF32 product, K-major as ``b`` is given:
    (hi, lo or None, passes). A bf16 b is exact in TF32: hi is b in fp32,
    lo None, 2 passes; an fp32 b splits into hi and lo, 3 passes."""
    if b.dtype == torch.bfloat16:
        return b.to(torch.float32, memory_format=torch.contiguous_format), \
            None, 2
    hi, lo = tf32_split(b.float().contiguous())
    return hi, lo, 3


def _dw_ld(m):
    """x^T's row stride in gmm_dw: M rounded up to a multiple of 4 (TMA's
    16-byte strides; the columns past M are never read)."""
    return -(-m // 4) * 4


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _fn(name, nargs_ptr, nargs_int):
    from paddle_tpu_torch.ops.cuda._build import load

    fn = getattr(load("grouped_matmul"), name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * nargs_ptr + [ci] * nargs_int + [vp]
        fn.restype = ci
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_err(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _aligned(*ts):
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("grouped-matmul kernels need 16-byte aligned "
                             "tensors")


def _gids_on(gids, x):
    return gids.to(device=x.device, dtype=torch.int32).contiguous()


def _check_fwd(x, w, gids):
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x must be [M, d] and w [G, d, h], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if tuple(gids.shape) != (x.shape[0],):
        raise ValueError(f"gids shape {tuple(gids.shape)} != "
                         f"({x.shape[0]},)")


def _launch_fwd(x, w, w_lo, gids, passes, n):
    """The forward kernel: y [M, n] fp32 = x @ w[gids]; w as the C entry
    takes it for `passes` (1: bf16 [G, d, n]; 2, 3: fp32 K-major
    [G, n, d], w_lo its lo part when 3)."""
    m, d = x.shape
    x = x.contiguous()
    _aligned(x, w, *([w_lo] if w_lo is not None else []))
    gids = _gids_on(gids, x)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _fn("ptt_gmm_fwd", 5, 6)(
        x.data_ptr(), w.data_ptr(), 0 if w_lo is None else w_lo.data_ptr(),
        gids.data_ptr(), y.data_ptr(), m, d, n, w.shape[0], passes,
        x.device.index or 0, _stream(x))
    _check_err(err, "gmm_fwd")
    LAUNCHES["gmm_fwd" if passes == 1 else "gmm_fwd_tf32"] += 1
    return y


def _check_tf32_dims(name, **dims):
    bad = {k: v for k, v in dims.items() if v % 4}
    if bad:
        raise ValueError(f"{name} takes fp32 dims that are multiples of 4 "
                         f"(TMA's 16-byte row strides), got {bad}")


def gmm_fwd(x, w, gids):
    """fp32 ``y[i] = x[i] @ w[gids[i]]`` [M, h]: the kernel on CUDA tensors
    (bf16 x and w: one bf16 product; fp32 x and w: split TF32 over a K-major
    copy of ``w^T``, 3 passes), the plain version on CPU tensors."""
    _check_fwd(x, w, gids)
    if not x.is_cuda:
        return grouped_matmul_reference(x, w, gids)
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    m, d = x.shape
    g, _, h = w.shape
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gmm_fwd takes bf16 or fp32 x and w of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (d % 8 or h % 8):    # TMA row strides of 16 bytes
        raise ValueError(f"gmm_fwd takes bf16 d and h that are multiples "
                         f"of 8, got d {d}, h {h}")
    if not bf16:
        _check_tf32_dims("gmm_fwd", d=d, h=h)
    if not (m and d and h and g):    # nothing to launch: an empty or zero y
        return torch.zeros((m, h), dtype=torch.float32, device=x.device)
    if bf16:
        return _launch_fwd(x, w.contiguous(), None, gids, 1, h)
    hi, lo, passes = tf32_operand(w.transpose(1, 2))
    return _launch_fwd(x, hi, lo, gids, passes, h)


def gmm_dx(dy, w, gids):
    """The VJP's fp32 ``dx[i] = dy[i] @ w[gids[i]]^T`` [M, d] for dy [M, h]
    fp32 and w [G, d, h]: on CUDA tensors the forward kernel in split TF32
    over w as it lies in fp32 (2 passes for a bf16 w, 3 for an fp32 one),
    counted as a ``gmm_fwd_tf32`` launch; the plain version on CPU
    tensors."""
    if dy.dim() != 2 or w.dim() != 3 or w.shape[2] != dy.shape[1]:
        raise ValueError(f"dy must be [M, h] and w [G, d, h], got "
                         f"{tuple(dy.shape)} and {tuple(w.shape)}")
    if tuple(gids.shape) != (dy.shape[0],):
        raise ValueError(f"gids shape {tuple(gids.shape)} != "
                         f"({dy.shape[0]},)")
    if not dy.is_cuda:
        return grouped_matmul_reference(dy, w.transpose(1, 2), gids)
    if w.device != dy.device:
        raise ValueError("dy and w must be on one device")
    if dy.dtype != torch.float32 \
            or w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gmm_dx takes fp32 dy and bf16 or fp32 w, got "
                        f"{dy.dtype} and {w.dtype}")
    m, h = dy.shape
    g, d, _ = w.shape
    _check_tf32_dims("gmm_dx", d=d, h=h)
    if not (m and d and h and g):
        return torch.zeros((m, d), dtype=torch.float32, device=dy.device)
    hi, lo, passes = tf32_operand(w)
    return _launch_fwd(dy, hi, lo, gids, passes, d)


def gmm_dw(x, dy, gids, num_groups: int):
    """fp32 ``dw[g] = x_g^T dy_g`` [G, d, h]: the kernel on CUDA tensors (x
    bf16 or fp32, dy fp32, as the fp32 forward output's gradient is; split
    TF32 over the K-major copy ``x^T`` its first pass makes, 2 passes for
    bf16 x, 3 for fp32), the plain version on CPU tensors."""
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"x must be [M, d] and dy [M, h], got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if tuple(gids.shape) != (x.shape[0],):
        raise ValueError(f"gids shape {tuple(gids.shape)} != "
                         f"({x.shape[0]},)")
    if not x.is_cuda:
        return grouped_matmul_dw_reference(x, dy, gids, num_groups)
    if dy.device != x.device:
        raise ValueError("x and dy must be on one device")
    m, d = x.shape
    h = dy.shape[1]
    _check_tf32_dims("gmm_dw", d=d, h=h)
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or dy.dtype != torch.float32:
        raise TypeError(f"gmm_dw takes bf16 or fp32 x and fp32 dy, got "
                        f"{x.dtype} and {dy.dtype}")
    if not (m and num_groups and d and h):  # nothing to launch: zeros
        return torch.zeros((num_groups, d, h), dtype=torch.float32,
                           device=x.device)
    x, dy = x.contiguous(), dy.contiguous()
    _aligned(x, dy)
    gids = _gids_on(gids, x)
    bf16 = x.dtype == torch.bfloat16
    # x^T (and its lo part for fp32 x), made by the kernel's first pass
    xt = torch.empty((1 if bf16 else 2, d, _dw_ld(m)), dtype=torch.float32,
                     device=x.device)
    walk = torch.empty((-(-m // _DW_CHUNK) + num_groups, 2),
                       dtype=torch.int32, device=x.device)
    dw = torch.empty((num_groups, d, h), dtype=torch.float32,
                     device=x.device)
    err = _fn("ptt_gmm_dw", 7, 7)(
        x.data_ptr(), dy.data_ptr(), gids.data_ptr(), xt[0].data_ptr(),
        xt[-1].data_ptr(), walk.data_ptr(), dw.data_ptr(), m, d, h,
        num_groups, xt.shape[2], int(bf16), x.device.index or 0, _stream(x))
    _check_err(err, "gmm_dw")
    LAUNCHES["gmm_dw"] += 1
    return dw


# gmm_visit_kernel's CTA bounds (kGmmVisitMinThreads, kGmmVisitMaxThreads
# in csrc/grouped_matmul.cu)
GMM_VISIT_MIN_THREADS, GMM_VISIT_MAX_THREADS = 128, 1024


class GmmVisitPlan(NamedTuple):
    lanes: int            # lanes that read and count one block
    blocks_per_warp: int  # 32 // lanes
    grid: int             # CTAs, at most one wave of the card's SMs
    threads: int          # a CTA's threads, a multiple of 32


def gmm_visit_plan(m: int, block_rows: int, vec: bool,
                   sms: int) -> GmmVisitPlan:
    """How ``gmm_visit_kernel`` covers ``m // block_rows`` blocks: a block
    to the least power of two of lanes (at most 32) that reads it in one
    load a lane (``block_rows / 4`` 16-byte loads when ``vec``, else
    ``block_rows`` ints), so a warp takes ``32 // lanes`` blocks a pass;
    CTAs of GMM_VISIT_MIN_THREADS threads or more, grown up to
    GMM_VISIT_MAX_THREADS so the grid stays within one wave of `sms`
    SMs; warps stride over the blocks past the first pass."""
    per = block_rows // 4 if vec else block_rows
    lanes = min(32, 1 << max(0, (per - 1).bit_length()))
    bpw = 32 // lanes
    warps = -(-(m // block_rows) // bpw)
    per_cta = min(max(-(-warps // sms), GMM_VISIT_MIN_THREADS // 32),
                  GMM_VISIT_MAX_THREADS // 32)
    return GmmVisitPlan(lanes, bpw, max(1, min(sms, -(-warps // per_cta))),
                        32 * per_cta)


def _launch_visit(gids, num_groups: int, block_rows: int):
    """One launch of ``gmm_visit_kernel`` over contiguous int32 gids on
    the card, on the plan ``gmm_visit_plan`` makes."""
    m = gids.shape[0]
    counts = torch.empty((m // block_rows,), dtype=torch.int32,
                         device=gids.device)
    if m == 0:                       # nothing to launch: no blocks
        return counts
    vec = block_rows % 4 == 0 and gids.data_ptr() % 16 == 0
    plan = gmm_visit_plan(m, block_rows, vec,
                          _sm_count(gids.device.index or 0))
    err = _fn("ptt_gmm_visit", 2, 7)(
        gids.data_ptr(), counts.data_ptr(), m, num_groups, block_rows,
        int(vec), plan.grid, plan.threads, gids.device.index or 0,
        _stream(gids))
    _check_err(err, "gmm_visit")
    LAUNCHES["gmm_visit"] += 1
    return counts


def grouped_matmul_visit_counts(gids, num_groups: int, block_rows: int):
    """Per ``block_rows`` block, the number of groups the grouped-matmul
    kernels' predicate admits (int32 [M // block_rows]); ``sum() / (blocks
    * G)`` is the visited fraction. The kernel on a CUDA tensor, the plain
    version on a CPU one."""
    (m,) = gids.shape
    if block_rows <= 0 or m % block_rows:
        raise ValueError(f"rows {m} not a multiple of block_rows "
                         f"{block_rows}")
    if not gids.is_cuda:
        return grouped_matmul_visit_reference(gids, num_groups, block_rows)
    return _launch_visit(gids.to(torch.int32).contiguous(), num_groups,
                         block_rows)


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------

class GroupedMatmul(torch.autograd.Function):
    """``y = x @ w[gids]`` (fp32) with the JAX VJP: dx is ``gmm_dx``, the
    forward over ``w`` transposed in fp32 (the kernel reads w as it lies),
    dw is ``gmm_dw``; both are cast to their input's dtype, and ``gids``
    gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, gids):
        ctx.save_for_backward(x, w, gids)
        return gmm_fwd(x, w, gids)

    @staticmethod
    def backward(ctx, dy):
        x, w, gids = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm_dx(dy, w, gids).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gmm_dw(x, dy, gids, w.shape[0]).to(w.dtype)
        return dx, dw, None


def grouped_matmul(x, w, gids, *, block_rows: int | None = None):
    """y[i] = x[i] @ w[gids[i]] over ragged, group-contiguous rows.

    x: [M, d]; w: [G, d, h]; gids: [M] int in [0, G]; rows with
    ``gids == G`` are padding and give zero rows. M must be a multiple of
    ``block_rows`` (default ``pick_block_rows``). Returns fp32 [M, h];
    differentiable in x and w (dx and dw run the grouped kernels)."""
    m = x.shape[0]
    num_groups = w.shape[0]
    if tuple(gids.shape) != (m,):
        raise ValueError(f"gids shape {tuple(gids.shape)} != ({m},)")
    bm = block_rows or pick_block_rows(m, num_groups, x.device)
    if m % bm:
        if block_rows is not None:
            src = f"block_rows={block_rows} (caller-supplied)"
        else:
            from paddle_tpu_torch.tuning.blocks import last_resolution

            prov = last_resolution("grouped_matmul").provenance
            detail = {"flag": "FLAGS_moe_block_rows override",
                      "tuned": "tuning-cache entry",
                      "default": "auto-picked"}.get(prov, prov)
            src = f"block_rows={bm} ({detail})"
        raise ValueError(
            f"grouped_matmul: rows {m} not a multiple of {src}; pad the "
            f"row count to a multiple of the block, or set "
            f"FLAGS_moe_block_rows to a divisor of {m}")
    return GroupedMatmul.apply(x, w, gids)
