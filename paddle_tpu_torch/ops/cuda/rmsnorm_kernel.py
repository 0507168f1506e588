"""Fused RMSNorm, forward and backward: the hand-written Hopper kernels,
their plain PyTorch versions, and the ``torch.autograd.Function`` around
them (``paddle_tpu/ops/pallas/rmsnorm_kernel.py`` counterpart).

Replaces ``_rmsnorm_fwd_kernel`` (``rmsnorm_kernel.py:47``, the
``pallas_call`` at :105) and ``_rmsnorm_bwd_kernel`` (:54, call :124) with
``csrc/rmsnorm.cu``:

* ``rmsnorm_fwd``: ``y = x * rsqrt(mean(x^2, -1) + eps) * w`` in fp32 with
  one rounding to x's dtype at the end. This is the kernel's numerics, not
  the composite ``F.rms_norm``'s, which rounds to x's dtype before the
  multiply by w: in bf16 the two differ by a rounding.
* ``rmsnorm_bwd``: rstd recomputed from x, ``dx = rstd * (dy*w - x *
  rstd^2 * sum(dy*w*x) / d)`` in x's dtype, and ``dw = sum over rows of
  dy*x*rstd`` summed in fp32 and cast to w's dtype. The TPU kernel carries
  dw through one buffer across its sequential grid; here each block of
  ``block_rows`` rows writes an fp32 partial ``[d]`` and the ``rmsnorm_dw``
  kernel sums the ``[n_blocks, d]`` partials in a fixed order (no atomics:
  the same bits every run).

What bounds them on the H100: bytes (a reduction and an elementwise pass,
a few flops a byte); see the note in ``csrc/rmsnorm.cu``. Each kernel has
two routes, chosen by ``rmsnorm_plan`` from the width, the dtypes and the
bases' alignment: the ring (each row read from HBM once, by bulk copies
into shared-memory stages) where a row is a whole number of 16-byte
vectors and its stages fit, else two passes over a block's rows.
``block_rows`` trades the grid's width against the partials' traffic and
resolves through ``tuning.blocks.resolve_blocks`` (FLAGS_rmsnorm_block_rows
> tuning cache > the heuristic), once in the forward: the backward reuses
it.

The models keep the composite ``F.rms_norm``, as the JAX package does; this
op is reached through its public entry ``rmsnorm`` and the tuning plane.
On a CUDA tensor each entry point launches its kernel or raises; on a CPU
tensor it runs the plain version. ``LAUNCHES`` counts kernel launches by
name.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["rmsnorm", "RMSNormFunction", "rmsnorm_fwd", "rmsnorm_bwd",
           "rmsnorm_dw", "rmsnorm_reference", "rmsnorm_bwd_reference",
           "rmsnorm_dw_reference", "pick_block_rows", "validate_blocks",
           "rmsnorm_plan", "Plan", "ROUTES", "ROW_BLOCKS", "MAX_BLOCK_ROWS",
           "LAUNCHES", "reset_launches", "launch_counts"]

MAX_BLOCK_ROWS = 1024       # csrc kMaxBlockRows: the statistics' smem rows
# The row blocks the autotuner times; the heuristic picks from them too.
ROW_BLOCKS = (8, 16, 32, 64, 128, 256, 512)
# At most this many blocks: 8 blocks of 256 threads fill an SM, and the
# H100 has 132 SMs.
_TARGET_BLOCKS = 1024
# The row block on a card where the kernels go a warp a row: 4 stages of
# 8 rows (`tools/rmsnorm_ab.py --sweep` on the H100; PERF.md §6).
_WARP_ROW_BLOCK = 32

LAUNCHES = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "rmsnorm_dw": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The routes, in the order of csrc kRouteScalar, kRouteVector, kRouteRing,
# kRouteRingWarp.
ROUTES = ("two_pass_scalar", "two_pass_vector", "ring", "ring_warp")
_TWO_PASS_THREADS = 256     # csrc kThreads
# The ring's plan, the csrc kRing* constants of the same names.
RING_TARGET_THREADS = 256
RING_MAX_THREADS = 512
RING_WARP_THREADS = 256     # a warp a row: 8 rows a stage
RING_WARP_MAX_ELEMS = 32    # elements of a row a lane holds
RING_FWD_MAX_ELEMS = 32     # a block a row: elements of a row a thread
RING_BWD_MAX_ELEMS = 16     # holds at 128 registers (more spill)
RING_MIN_STAGES = 2
RING_MAX_STAGES = 4
RING_STAGE_BUDGET = 49152   # bytes of stages a block aims for
RING_SMEM_LIMIT = 231424    # 227 KB less 1 KB of static shared memory


class Plan(NamedTuple):
    """A kernel launch: its route, threads a block, 16-byte vectors a
    thread and ring stages (both 0 on the two-pass routes, which ignore
    them), and the dynamic shared-memory bytes of its stages."""
    route: str
    threads: int
    vecs: int
    stages: int
    smem_bytes: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def rmsnorm_plan(kind: str, d: int, dtype, block_rows: int,
                 aligned: bool = True) -> Plan:
    """How the `kind` ("fwd" or "bwd") kernel runs a width `d` of x in
    `dtype` over blocks of `block_rows` rows.

    The ring where a row is a whole number of 16-byte vectors, the bases
    are `aligned` to their vectors, the threads that hold a row fit a
    block, and RING_MIN_STAGES stages fit in RING_SMEM_LIMIT bytes; else
    the two passes, on 16-byte vectors where the width and alignment
    allow. A row of at most 32 * RING_WARP_MAX_ELEMS elements goes a warp
    a row ("ring_warp": RING_WARP_THREADS threads, a stage of one row a
    warp, a lane's vectors the smallest power of two that covers the row);
    a wider one a block a row ("ring": a thread's vectors the smallest
    power of two, of at most RING_{FWD,BWD}_MAX_ELEMS elements, that keeps
    the block within RING_TARGET_THREADS threads, the block the vectors
    over that in whole warps, so a narrow row does not idle half a block).
    Stages are RING_STAGE_BUDGET bytes' worth, 2 to 4, at most the stages
    a block of rows fills."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"rmsnorm_plan: kind is 'fwd' or 'bwd', got {kind!r}")
    es = dtype.itemsize
    v = 16 // es
    if d % v or not aligned:
        return Plan(ROUTES[0], _TWO_PASS_THREADS, 0, 0, 0)
    nv = d // v
    most = (RING_FWD_MAX_ELEMS if kind == "fwd" else RING_BWD_MAX_ELEMS) // v
    tensors = 1 if kind == "fwd" else 2
    if d <= 32 * RING_WARP_MAX_ELEMS:         # a warp a row
        route, threads = ROUTES[3], RING_WARP_THREADS
        vecs, per = _pow2_at_least(-(-nv // 32)), threads // 32
    else:                                     # a block a row
        vecs = 1
        while vecs < most and -(-nv // vecs) > RING_TARGET_THREADS:
            vecs *= 2
        route, threads, per = ROUTES[2], 32 * -(-nv // (32 * vecs)), 1
    stage = per * d * es * tensors
    if (threads > RING_MAX_THREADS
            or RING_MIN_STAGES * stage > RING_SMEM_LIMIT):
        return Plan(ROUTES[1], _TWO_PASS_THREADS, 0, 0, 0)
    stages = max(RING_MIN_STAGES,
                 min(RING_MAX_STAGES, RING_STAGE_BUDGET // stage))
    stages = min(stages, -(-max(int(block_rows), 1) // per))
    return Plan(route, threads, vecs, stages, stages * stage)


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _heuristic_block_rows(rows: int, sms: int | None = None,
                          warp_a_row: bool = False) -> int:
    """The smallest row block that keeps the grid within _TARGET_BLOCKS
    blocks (8 rows give one row a warp). On a card with `sms` SMs: where
    the kernels go a warp a row, _WARP_ROW_BLOCK rows instead (four stages
    of a row a warp, so the ring has copies in flight); and at most rows /
    sms rounded up, so that a few rows (a decode batch) spread over the
    SMs instead of running in series in one block."""
    br = next((b for b in ROW_BLOCKS if -(-rows // b) <= _TARGET_BLOCKS),
              ROW_BLOCKS[-1])
    if not sms:
        return br
    if warp_a_row:
        br = max(br, _WARP_ROW_BLOCK)
    return min(br, max(1, -(-rows // sms)))


def validate_blocks(values: dict, geometry: dict) -> None:
    """A row block the kernel can launch: 1 to MAX_BLOCK_ROWS rows once
    clamped to the row count."""
    br = min(int(values["block_rows"]), max(int(geometry["rows"]), 1))
    if not 1 <= br <= MAX_BLOCK_ROWS:
        raise ValueError(f"rmsnorm: block_rows {values['block_rows']} is "
                         f"outside the kernel's 1..{MAX_BLOCK_ROWS} rows")


def _sm_count(device):
    """The SM count of `device`'s card (None: the current card, where
    there is one); None on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


def pick_block_rows(rows: int, d: int, block_rows: int = 0,
                    dtype: str = "", device=None) -> int:
    """The row block, clamped to `rows`: `block_rows` when positive, else
    through the shared resolver (FLAGS_rmsnorm_block_rows > tuning-cache
    entry for (rows, d, dtype) on `device`'s card > the heuristic)."""
    geometry = {"rows": int(rows), "d": int(d)}
    if block_rows > 0:
        validate_blocks({"block_rows": block_rows}, geometry)
        return min(int(block_rows), max(int(rows), 1))
    from paddle_tpu_torch.tuning.blocks import resolve_blocks

    def default(g):
        warp = bool(dtype) and rmsnorm_plan(
            "fwd", d, getattr(torch, dtype), 1).route == "ring_warp"
        return (_heuristic_block_rows(rows, _sm_count(device), warp),)

    res = resolve_blocks("rmsnorm", geometry, dtype=dtype, default=default,
                         validate=validate_blocks, device=device)
    return min(int(res.values["block_rows"]), max(int(rows), 1))


def _check(x, w):
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be [rows, d] and w [d], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes fp32 or bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x and w must be on one device, got {x.device} "
                         f"and {w.device}")
    return x.shape


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _rstd(xf, eps):
    return torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)


def rmsnorm_reference(x, w, eps: float = 1e-6):
    """Plain version of the forward kernel: fp32 ``x * rstd * w``, rounded
    once to x's dtype."""
    xf = x.float()
    return (xf * _rstd(xf, eps) * w.float()).to(x.dtype)


def rmsnorm_dw_reference(partials, dtype):
    """Plain version of the dw kernel: the fp32 partials ``[n_blocks, d]``
    summed over blocks, cast to `dtype`."""
    return partials.sum(0).to(dtype)


def rmsnorm_bwd_reference(x, w, dy, eps: float = 1e-6, block_rows: int = 0):
    """Plain version of the backward kernels: (dx in x's dtype, dw in w's
    dtype), fp32 math as the kernel; dw is summed per ``block_rows`` block
    of rows (0: one block), the ragged last block over its real rows only,
    then over the blocks (``rmsnorm_dw_reference``)."""
    rows, d = x.shape
    xf, wf, dyf = x.float(), w.float(), dy.float()
    rstd = _rstd(xf, eps)
    dyw = dyf * wf
    proj = (dyw * xf).sum(-1, keepdim=True) / d
    dx = rstd * (dyw - xf * (rstd * rstd) * proj)
    contrib = dyf * xf * rstd
    br = min(block_rows, rows) if block_rows > 0 else max(rows, 1)
    nb = -(-rows // br)
    partials = contrib.new_zeros((nb * br, d))
    partials[:rows] = contrib
    return (dx.to(x.dtype),
            rmsnorm_dw_reference(partials.view(nb, br, d).sum(1), w.dtype))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _fn(name, nargs_ptr, nargs_int, has_eps):
    from paddle_tpu_torch.ops.cuda._build import load

    fn = getattr(load("rmsnorm"), name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * nargs_ptr + [ci] * 3
                       + ([ctypes.c_float] if has_eps else [])
                       + [ci] * nargs_int + [vp])
        fn.restype = ci
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_err(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _aligned(x, w, *others):
    """Every base aligned to its 16-byte vector (w's vector holds as many
    elements as x's)."""
    v = 16 // x.element_size()
    if any(t.data_ptr() % 16 for t in (x, *others)):
        return False
    return w.data_ptr() % (v * w.element_size()) == 0


def _launch(kind, tensors, br, eps):
    """One launch of the `kind` ("fwd" or "bwd") kernel on contiguous CUDA
    tensors in its C entry's order: x, w, y; or x, w, dy, dx, the dw
    partials. The plan's route, threads, vectors and stages go to the C
    entry; returns the plan."""
    x, w = tensors[:2]
    rows, d = x.shape
    plan = rmsnorm_plan(kind, d, x.dtype, br, _aligned(*tensors))
    err = _fn(f"ptt_rmsnorm_{kind}", len(tensors), 7, True)(
        *(t.data_ptr() for t in tensors), rows, d, br, float(eps),
        _DTYPES[x.dtype], _DTYPES[w.dtype], ROUTES.index(plan.route),
        plan.threads, plan.vecs, plan.stages, x.device.index or 0,
        _stream(x))
    _check_err(err, f"rmsnorm_{kind}")
    LAUNCHES[f"rmsnorm_{kind}"] += 1
    return plan


def _block_rows(x, block_rows):
    rows, d = x.shape
    return pick_block_rows(rows, d, block_rows, _dtype_name(x), x.device)


def rmsnorm_fwd(x, w, eps: float = 1e-6, block_rows: int = 0):
    """y [rows, d] in x's dtype: the kernel on CUDA tensors, the plain
    version on CPU tensors. `block_rows` 0 resolves (``pick_block_rows``)."""
    rows, d = _check(x, w)
    br = _block_rows(x, block_rows)
    if not x.is_cuda:
        return rmsnorm_reference(x, w, eps)
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty_like(x)
    if rows == 0 or d == 0:          # nothing to launch: an empty y
        return y
    _launch("fwd", (x, w, y), br, eps)
    return y


def rmsnorm_dw(partials, dtype):
    """dw [d] in `dtype` from the backward's fp32 partials [n_blocks, d]:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    if partials.dim() != 2 or partials.dtype != torch.float32:
        raise ValueError(f"partials must be fp32 [n_blocks, d], got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    if dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_dw writes fp32 or bf16, got {dtype}")
    if not partials.is_cuda:
        return rmsnorm_dw_reference(partials, dtype)
    nb, d = partials.shape
    partials = partials.contiguous()
    dw = torch.empty((d,), dtype=dtype, device=partials.device)
    if d == 0:                       # nothing to launch: an empty dw
        return dw
    err = _fn("ptt_rmsnorm_dw", 2, 1, False)(
        partials.data_ptr(), dw.data_ptr(), nb, d, _DTYPES[dtype],
        partials.device.index or 0, _stream(partials))
    _check_err(err, "rmsnorm_dw")
    LAUNCHES["rmsnorm_dw"] += 1
    return dw


def rmsnorm_bwd(x, w, dy, eps: float = 1e-6, block_rows: int = 0):
    """(dx in x's dtype, dw in w's dtype) for the output gradient `dy`: the
    backward kernel (dx and per-block fp32 dw partials) then the dw kernel
    on CUDA tensors, the plain version on CPU tensors."""
    rows, d = _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({tuple(x.shape)} {x.dtype} on "
                         f"{x.device}), got {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device}")
    br = _block_rows(x, block_rows)
    if not x.is_cuda:
        return rmsnorm_bwd_reference(x, w, dy, eps, br)
    x, w, dy = x.contiguous(), w.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    nb = -(-rows // br)
    partials = torch.empty((nb, d), dtype=torch.float32, device=x.device)
    if d == 0:                       # nothing to launch: empty dx and dw
        return dx, torch.empty((0,), dtype=w.dtype, device=x.device)
    if rows:
        _launch("bwd", (x, w, dy, dx, partials), br, eps)
    return dx, rmsnorm_dw(partials, w.dtype)


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------

class RMSNormFunction(torch.autograd.Function):
    """``jax.custom_vjp`` around ``_fwd``/``_bwd`` in the JAX package. The
    row block resolves once, here in the forward, and the backward reuses
    it: the resolver's trial and search state is thread-local, and
    PyTorch runs a CUDA backward on its own device thread."""

    @staticmethod
    def forward(ctx, x, w, eps, block_rows):
        br = _block_rows(x, block_rows)
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.block_rows = eps, br
        return rmsnorm_fwd(x, w, eps, br)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.to(x.dtype), ctx.eps, ctx.block_rows)
        return dx, dw, None, None


def rmsnorm(x, w, eps: float = 1e-6, block_rows: int = 0):
    """``y = x * rsqrt(mean(x^2, -1) + eps) * w`` over the trailing axis,
    differentiable in x and w. x: [rows, d] (callers flatten leading dims),
    w: [d], each fp32 or bf16. block_rows 0 resolves through
    ``tuning.blocks`` (flag > tuned > heuristic)."""
    _check(x, w)
    return RMSNormFunction.apply(x, w, float(eps), int(block_rows))
