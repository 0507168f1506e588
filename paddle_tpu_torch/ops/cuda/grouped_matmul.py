"""Grouped (ragged) matmul over expert buckets, the dropless-MoE compute
primitive: the hand-written Hopper kernels, their plain PyTorch versions,
and the ``torch.autograd.Function`` around them
(``paddle_tpu/ops/pallas/grouped_matmul.py`` counterpart).

Replaces ``_gmm_fwd_kernel`` (``grouped_matmul.py:98``, ``pallas_call`` at
:142), ``_gmm_dw_kernel`` (:117, call :161) and the visit counter
``_visit_kernel`` (:291, call :314) with ``csrc/grouped_matmul.cu``:

* ``gmm_fwd``: ``y[i] = x[i] @ w[gids[i]]`` in fp32. bf16 inputs run on the
  tensor cores (``mma.sync``), fp32 inputs on the CUDA cores. A block owns
  a 128-row (bf16) or 64-row (fp32) output tile; it reads its rows' group
  range once and runs the d loop only for the groups the shared
  ``blocks_can_touch`` predicate admits, with the rows of other groups
  loaded as zeros, so it is exact for any grouped layout, not only the
  dispatcher's block-aligned one. Rows with ``gids == G`` (trash) are zero.
* ``gmm_dw``: ``dw[g] = sum over the rows of g of x[i]^T dy[i]``, fp32 on
  the CUDA cores; a block owns a [64, 128] tile of one group's ``dw[g]``
  and walks the 16-row chunks whose group range touches g.
* ``gmm_visit``: per ``block_rows`` block, the number of groups the
  predicate admits; it must equal ``expected_visit_counts``.

What bounds them on the H100: operations (2 * rows * d * h flops a
product, hundreds per byte moved at the MoE widths). The forward's bf16
products reach the tensor cores; the backward's are fp32 as in the JAX
VJP (dy is fp32 because the forward returns fp32), so dx and dw run on the
CUDA cores at a 67 TFLOP/s peak.

dx is the forward kernel over w transposed, as ``_gmm_vjp_bwd`` computes
it: the wrapper hands the kernel a contiguous fp32 copy of ``w^T``
(``[G, h, d]``) rather than a kernel that reads bf16 w transposed. The copy
is the JAX numerics (``swapaxes(w).astype(float32)``), costs about 0.1 ms
of memory traffic at full width against a product of at least 2 ms, and
keeps the kernel to two input types.

On a CUDA tensor each entry point launches its kernel or raises; on a CPU
tensor it runs the plain version. The CUDA tile is not the layout's
``block_rows``: that only sets the row alignment the dispatcher pads to and
the row-count check. ``LAUNCHES`` counts kernel launches by name.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from paddle_tpu_torch.core.flags import flag

__all__ = ["grouped_matmul", "GroupedMatmul", "grouped_matmul_reference",
           "grouped_matmul_dw_reference", "grouped_matmul_visit_counts",
           "grouped_matmul_visit_reference", "expected_visit_counts",
           "pick_block_rows", "gmm_fwd", "gmm_dw", "LAUNCHES",
           "reset_launches", "launch_counts"]

_DW_CHUNK = 16          # token rows per gmm_dw step (csrc kBK)

LAUNCHES = {"gmm_fwd": 0, "gmm_dw": 0, "gmm_visit": 0}


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


def pick_block_rows(n_rows: int, num_groups: int) -> int:
    """Row alignment of the expert buckets: the ``moe_block_rows`` flag
    when positive, else 128 when buckets are large enough that per-group
    padding stays small, stepping down to 32 and 8 for small problems
    (``grouped_matmul.py:60``). The JAX package's tuning cache comes with
    ROADMAP A10."""
    override = int(flag("moe_block_rows"))
    if override > 0:
        return override
    return _heuristic_block_rows(n_rows, num_groups)


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


def gmm_fwd(x, w, gids):
    """fp32 ``y[i] = x[i] @ w[gids[i]]`` [M, h]: the kernel on CUDA tensors
    (bf16 x and w on the tensor cores, fp32 x and w on the CUDA cores), the
    plain version on CPU tensors."""
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
    step = 32 if bf16 else 16
    if d % step or h % 8:
        raise ValueError(f"gmm_fwd takes a depth that is a multiple of "
                         f"{step} and a width that is a multiple of 8 "
                         f"({x.dtype}), got d {d}, h {h}")
    if not (m and d and h and g):    # nothing to launch: an empty or zero y
        return torch.zeros((m, h), dtype=torch.float32, device=x.device)
    x, w = x.contiguous(), w.contiguous()
    _aligned(x, w)
    gids = _gids_on(gids, x)
    y = torch.empty((m, h), dtype=torch.float32, device=x.device)
    err = _fn("ptt_gmm_fwd", 4, 6)(
        x.data_ptr(), w.data_ptr(), gids.data_ptr(), y.data_ptr(), m, d, h, g,
        int(bf16), x.device.index or 0, _stream(x))
    _check_err(err, "gmm_fwd")
    LAUNCHES["gmm_fwd"] += 1
    return y


def gmm_dw(x, dy, gids, num_groups: int):
    """fp32 ``dw[g] = x_g^T dy_g`` [G, d, h]: the kernel on CUDA tensors (x
    bf16 or fp32, dy fp32, as the fp32 forward output's gradient is), the
    plain version on CPU tensors."""
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"x must be [M, d] and dy [M, h], got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if not x.is_cuda:
        return grouped_matmul_dw_reference(x, dy, gids, num_groups)
    if dy.device != x.device:
        raise ValueError("x and dy must be on one device")
    m, d = x.shape
    h = dy.shape[1]
    if d % 8 or h % 8:
        raise ValueError(f"gmm_dw takes d and h that are multiples of 8, "
                         f"got {d}, {h}")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or dy.dtype != torch.float32:
        raise TypeError(f"gmm_dw takes bf16 or fp32 x and fp32 dy, got "
                        f"{x.dtype} and {dy.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if not (num_groups and d and h):  # nothing to launch: an empty dw
        return torch.zeros((num_groups, d, h), dtype=torch.float32,
                           device=x.device)
    x, dy = x.contiguous(), dy.contiguous()
    _aligned(x, dy)
    gids = _gids_on(gids, x)
    ranges = torch.empty((-(-m // _DW_CHUNK), 2), dtype=torch.int32,
                         device=x.device)
    dw = torch.empty((num_groups, d, h), dtype=torch.float32,
                     device=x.device)
    err = _fn("ptt_gmm_dw", 5, 6)(
        x.data_ptr(), dy.data_ptr(), gids.data_ptr(), ranges.data_ptr(),
        dw.data_ptr(), m, d, h, num_groups, int(bf16), x.device.index or 0,
        _stream(x))
    _check_err(err, "gmm_dw")
    LAUNCHES["gmm_dw"] += 1
    return dw


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
    gids = gids.to(torch.int32).contiguous()
    counts = torch.empty((m // block_rows,), dtype=torch.int32,
                         device=gids.device)
    if m == 0:                       # nothing to launch: no blocks
        return counts
    err = _fn("ptt_gmm_visit", 2, 4)(
        gids.data_ptr(), counts.data_ptr(), m, num_groups, block_rows,
        gids.device.index or 0, _stream(gids))
    _check_err(err, "gmm_visit")
    LAUNCHES["gmm_visit"] += 1
    return counts


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------

class GroupedMatmul(torch.autograd.Function):
    """``y = x @ w[gids]`` (fp32) with the JAX VJP: dx is ``gmm_fwd`` of
    dy over ``w`` transposed in fp32, dw is ``gmm_dw``; both are cast to
    their input's dtype, and ``gids`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, gids):
        ctx.save_for_backward(x, w, gids)
        return gmm_fwd(x, w, gids)

    @staticmethod
    def backward(ctx, dy):
        x, w, gids = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # one copy: the transposed read and the fp32 cast together
            wt = w.transpose(1, 2).to(torch.float32,
                                      memory_format=torch.contiguous_format)
            dx = gmm_fwd(dy, wt, gids).to(x.dtype)
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
    bm = block_rows or pick_block_rows(m, num_groups)
    if m % bm:
        if block_rows is not None:
            src = f"block_rows={block_rows} (caller-supplied)"
        elif int(flag("moe_block_rows")) > 0:
            src = f"block_rows={bm} (FLAGS_moe_block_rows override)"
        else:
            src = f"block_rows={bm} (auto-picked)"
        raise ValueError(
            f"grouped_matmul: rows {m} not a multiple of {src}; pad the "
            f"row count to a multiple of the block, or set "
            f"FLAGS_moe_block_rows to a divisor of {m}")
    return GroupedMatmul.apply(x, w, gids)
