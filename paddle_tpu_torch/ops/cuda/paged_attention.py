"""Paged decode attention and the page-visit counter: the hand-written
Hopper kernels and their plain PyTorch versions.

Replaces ``paddle_tpu/ops/pallas/paged_attention.py`` ``_decode_kernel``
(launched by ``paged_decode_attention``, the ``pallas_call`` at :282), its
int8/fp8 branch included, and ``_visit_kernel`` (:372, launched by
``page_visit_counts``, the ``pallas_call`` at :400). The CUDA source is
``csrc/paged_attention.cu``.

Layout as in the JAX package: K/V page pools ``[Hkv, P, page_size, D]``
(page 0 is the reserved null page), page table ``[B, pages_per_seq]``
int32, ``context_lens`` ``[B]`` int32 (0 marks an inactive row, whose
output is zeros). q is ``[B, Hq, D]`` (decode) or ``[B, T, Hq, D]`` (a
frame whose query i sees keys ``< len + i``).

What bounds it on the H100: bytes. A decode step reads every live K/V row
once and does about one flop per byte, far below the ~295 flops per byte
where the tensor cores would become the limit. What the design does about
it: a block reads each needed key row once for all ``T * group`` query
rows of an 8-row tile of its kv head (GQA never repeats K/V), keys past
the last query's range are never read (the page predicate the flash
kernels share), and a row's context is cut into splits (split-K) whose
partial softmax states a second small kernel merges, so a long row next
to short ones keeps every SM busy. bf16 q runs the tensor-core kernel
(``paged_decode_kernel_mma``): one producer warp feeds a ring of 16-key
stages with bulk copies (``cp.async.bulk`` on mbarriers), four consumer
warps run ``mma.sync``; quantized pools (int8 or fp8-e4m3 codes with fp32
``[Hkv, P, page_size]`` scales) arrive as codes and are widened to bf16
in shared memory (exact), the scales applied in fp32 to the products.
It takes page sizes that are multiples of 8 (the tuner's lattice is
8-128). fp32 q, and bf16 q at any other page size, run the CUDA-core
kernel (``paged_decode_kernel``), which takes any page size and stages
fp32 tiles; ``kernel_route`` picks the kernel, and the split-K workspace
is sized for the kernel picked. Neither ever writes dequantized K/V to
device memory.

A frame of more than ``MAX_FRAME_ROWS`` query rows a kv head (T * group;
a speculative verify frame at GQA 8:1 passes it at T 9) is cut on the host
into chunks of ``MAX_FRAME_ROWS // group`` queries, one launch each: chunk
t0 takes queries t0 .. t0 + T_c - 1 with ``context_lens + t0`` (0 where
``context_lens <= 0``), so its query j sees keys < len + t0 + j, as in the
whole frame.

On a CUDA tensor ``paged_attention`` and ``page_visit_counts`` launch their
kernels or raise; on a CPU tensor they run ``paged_attention_reference`` and
``page_visit_reference``. ``LAUNCHES`` counts kernel launches by kernel
name: ``paged_decode`` (bf16/fp32 pools), ``paged_decode_int8``,
``paged_decode_fp8`` and ``paged_visit``.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["paged_attention", "paged_attention_reference",
           "page_visit_counts", "page_visit_reference", "kernel_route",
           "ROUTE_CUDA_CORE", "ROUTE_MMA", "LAUNCHES", "reset_launches",
           "launch_counts", "MAX_FRAME_ROWS", "frame_chunks"]

_NEG_INF = -1e30
MAX_FRAME_ROWS = 64     # T * group bound of a launch (shared memory)
ROUTE_CUDA_CORE = 0     # paged_decode_kernel: any q dtype, any page size
ROUTE_MMA = 1           # paged_decode_kernel_mma: bf16 q, page size % 8 == 0

LAUNCHES = {"paged_decode": 0, "paged_decode_int8": 0,
            "paged_decode_fp8": 0, "paged_visit": 0}
# code pools the kernel dequantizes: dtype -> (kv_kind, launch-counter name)
_CODES = {torch.int8: (1, "paged_decode_int8"),
          torch.float8_e4m3fn: (2, "paged_decode_fp8")}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_scales(k_pages, k_scales, v_scales):
    """True for quantized pools; the scales must be [Hkv, P, page_size],
    one of them alone is an error (JAX :218-226)."""
    if k_scales is None and v_scales is None:
        return False
    if k_scales is None or v_scales is None:
        raise ValueError("k_scales and v_scales go together: got only "
                         + ("k_scales" if v_scales is None else "v_scales"))
    want = tuple(k_pages.shape[:3])
    if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
        raise ValueError(
            f"k/v scales must be [Hkv, P, page_size]={want}, got "
            f"{tuple(k_scales.shape)} and {tuple(v_scales.shape)}")
    return True


def _check_shapes(q, k_pages, v_pages, page_table, context_lens):
    if q.dim() == 4:
        b, _, hq, d = q.shape
    elif q.dim() == 3:
        b, hq, d = q.shape
    else:
        raise ValueError(f"q must be [B, Hq, D] or [B, T, Hq, D], got "
                         f"{tuple(q.shape)}")
    if k_pages.dim() != 4:
        raise ValueError(f"pools must be [Hkv, P, page_size, D], got "
                         f"{tuple(k_pages.shape)}")
    hkv, _, ps, dk = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if dk != d:
        raise ValueError(f"head_dim mismatch: q {d} vs pages {dk}")
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(
            f"q heads must be a multiple of kv heads, got {hq} and {hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [batch={b}, pages_per_seq], "
                         f"got {tuple(page_table.shape)}")
    if tuple(context_lens.shape) != (b,):
        raise ValueError(f"context_lens must be [batch={b}], "
                         f"got {tuple(context_lens.shape)}")
    return b, hq, hkv, ps, d


def paged_attention_reference(q, k_pages, v_pages, page_table, context_lens,
                              scale: float | None = None, k_scales=None,
                              v_scales=None):
    """Plain PyTorch version: gather every page of the table, then a masked
    softmax in fp32. Same layouts and per-query causal limits as the
    kernel; quantized pools are dequantized after the fp32 cast (codes
    times their ``[Hkv, P, page_size]`` scales). Returns q's shape and
    dtype."""
    b, hq, hkv, ps, d = _check_shapes(q, k_pages, v_pages, page_table,
                                      context_lens)
    quantized = _check_scales(k_pages, k_scales, v_scales)
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    t = q.shape[1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s_max = page_table.shape[1] * ps
    pt = page_table.long()
    lens = context_lens.to(device=q.device, dtype=torch.int64)
    # [Hkv, B, pages, ps, D] -> [B, Hkv, S, D]
    k = k_pages[:, pt].transpose(0, 1).reshape(b, hkv, s_max, d).float()
    v = v_pages[:, pt].transpose(0, 1).reshape(b, hkv, s_max, d).float()
    if quantized:
        ks = k_scales.float()[:, pt].transpose(0, 1).reshape(b, hkv, s_max)
        vs = v_scales.float()[:, pt].transpose(0, 1).reshape(b, hkv, s_max)
        k = k * ks[..., None]
        v = v * vs[..., None]
    qg = q.reshape(b, t, hkv, group, d).float() * scale
    s = torch.einsum("bthgd,bhsd->bthgs", qg, k)
    pos = torch.arange(s_max, device=q.device)
    limit = lens[:, None] + torch.arange(t, device=q.device)[None]   # [B, T]
    valid = (pos[None, None, :] < limit[:, :, None])[:, :, None, None, :]
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bthgs,bhsd->bthgd", p / denom, v)
    out = out.masked_fill((lens <= 0).view(b, 1, 1, 1, 1), 0.0)
    out = out.reshape(b, t, hq, d).to(q.dtype)
    return out[:, 0] if squeeze else out


def kernel_route(q_dtype, page_size: int) -> int:
    """The decode kernel a call runs: ``ROUTE_MMA`` (the tensor-core
    kernel, whose ring stages take 8-key halves of one page) for bf16 q at
    a page size that is a multiple of 8, else ``ROUTE_CUDA_CORE``. The
    wrapper passes the same route to the split count and to the launch."""
    if q_dtype == torch.bfloat16 and page_size % 8 == 0:
        return ROUTE_MMA
    return ROUTE_CUDA_CORE


def _lib():
    from paddle_tpu_torch.ops.cuda._build import load

    lib = load("paged_attention")
    fn, splits = lib.ptt_paged_decode, lib.ptt_paged_splits
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                       ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, ci, ci,
                       vp]
        fn.restype = ci
        splits.argtypes = [ci, ci, ci, ci]
        splits.restype = ci
    return fn, splits


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def frame_chunks(t: int, group: int) -> list[tuple[int, int]]:
    """(t0, T_c) of each launch of a T-query frame: the whole frame when
    its ``t * group`` rows fit ``MAX_FRAME_ROWS``, else chunks of
    ``MAX_FRAME_ROWS // group`` queries."""
    tc = t if t * group <= MAX_FRAME_ROWS else MAX_FRAME_ROWS // group
    if tc == 0:
        raise ValueError(f"group = {group} query heads per kv head exceeds "
                         f"the kernel's {MAX_FRAME_ROWS} rows")
    return [(t0, min(tc, t - t0)) for t0 in range(0, t, tc)]


def _by_chunks(fn, q, k_pages, v_pages, page_table, context_lens, **kw):
    """`fn` over a [B, T, Hq, D] frame chunk by chunk (``frame_chunks``):
    chunk t0 with ``context_lens + t0`` (0 for inactive rows), the outputs
    concatenated along T."""
    chunks = frame_chunks(q.shape[1], q.shape[2] // k_pages.shape[0])
    if len(chunks) == 1:
        return fn(q, k_pages, v_pages, page_table, context_lens, **kw)
    lens = context_lens.to(torch.int32)
    return torch.cat([
        fn(q[:, t0:t0 + tc], k_pages, v_pages, page_table,
           torch.where(lens > 0, lens + t0, torch.zeros_like(lens)), **kw)
        for t0, tc in chunks], dim=1)


def _launch(q, k_pages, v_pages, page_table, context_lens, scale,
            k_scales=None, v_scales=None):
    b, hq, hkv, ps, d = _check_shapes(q, k_pages, v_pages, page_table,
                                      context_lens)
    if q.dim() == 4 and len(frame_chunks(q.shape[1], hq // hkv)) > 1:
        return _by_chunks(_launch, q, k_pages, v_pages, page_table,
                          context_lens, scale=scale, k_scales=k_scales,
                          v_scales=v_scales)
    quantized = _check_scales(k_pages, k_scales, v_scales)
    squeeze = q.dim() == 3
    q4 = (q[:, None] if squeeze else q).contiguous()
    t = q4.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged kernel takes bf16 or fp32 q, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"paged kernel takes head_dim 64 or 128, got {d}")
    if t * (hq // hkv) > MAX_FRAME_ROWS:   # a group past the kernel's rows
        raise ValueError(f"T * group = {t * (hq // hkv)} query rows per kv "
                         f"head exceeds the kernel's {MAX_FRAME_ROWS}")
    if quantized:
        if k_pages.dtype not in _CODES:
            raise TypeError(f"scaled pools must hold int8 or float8_e4m3fn "
                            f"codes, got {k_pages.dtype}")
        kv_kind, counter = _CODES[k_pages.dtype]
    else:
        kv_kind, counter = 0, "paged_decode"
    want = k_pages.dtype if quantized else q.dtype
    for name, a in (("k_pages", k_pages), ("v_pages", v_pages)):
        if a.device != q.device or a.dtype != want:
            raise ValueError(f"{name} must be on q's device and hold "
                             f"{want}, got {a.device} {a.dtype}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    ks = vs = None
    if quantized:
        ks = k_scales.to(device=q.device, dtype=torch.float32).contiguous()
        vs = v_scales.to(device=q.device, dtype=torch.float32).contiguous()
        if ks.data_ptr() % 16 or vs.data_ptr() % 16:
            raise ValueError("k_scales and v_scales must be 16-byte aligned")
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q4)
    fn, splits = _lib()
    route = kernel_route(q.dtype, ps)
    # split-K scratch: unnormalized (acc, max, sum) per split of the
    # kernel that will fill it
    n_splits = splits(pt.shape[1], ps, t, route)
    tg = t * (hq // hkv)
    ws_acc = torch.empty((b, hkv, n_splits, tg, d), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((b, hkv, n_splits, tg, 2), dtype=torch.float32,
                        device=q.device)
    err = fn(q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             ks.data_ptr() if quantized else None,
             vs.data_ptr() if quantized else None,
             pt.data_ptr(), lens.data_ptr(), out.data_ptr(),
             ws_acc.data_ptr(), ws_ml.data_ptr(), b, t, hq, hkv,
             k_pages.shape[1], ps, pt.shape[1], d, float(scale),
             _DTYPES[q.dtype], route, kv_kind, q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{counter} launch failed: cudaError {err}")
    LAUNCHES[counter] += 1
    return out[:, 0] if squeeze else out


def paged_attention(q, k_pages, v_pages, page_table, context_lens,
                    scale: float | None = None, k_scales=None,
                    v_scales=None):
    """Attention over the paged KV cache (what the model's decode and
    verify paths call). CUDA tensors launch the kernel ``kernel_route``
    picks: bf16 q the tensor-core kernel at page sizes that are multiples
    of 8, else (fp32 q, or any other page size) the CUDA-core one, each
    over bf16/fp32 pools of q's dtype or, when ``k_scales``/``v_scales``
    are given, int8/fp8 codes; a frame past ``MAX_FRAME_ROWS`` rows a kv
    head launches once a chunk (``frame_chunks``). CPU tensors take the
    plain version."""
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, page_table, context_lens, scale,
                       k_scales, v_scales)
    return paged_attention_reference(q, k_pages, v_pages, page_table,
                                     context_lens, scale=scale,
                                     k_scales=k_scales, v_scales=v_scales)


def page_visit_reference(context_lens, page_size: int, pages_per_seq: int):
    """Plain version of the page-visit counter: per row, the pages p <
    pages_per_seq whose positions [p*ps, p*ps + ps - 1] the predicate
    admits against [0, len - 1]; int32 [B]."""
    lens = context_lens.to(torch.int64).reshape(-1, 1)
    first = torch.arange(pages_per_seq, device=lens.device) * page_size
    hit = (first <= lens - 1) & (first + page_size - 1 >= 0)
    return hit.sum(dim=1).to(torch.int32)


def page_visit_counts(context_lens, page_size: int, pages_per_seq: int):
    """Per-row count of the cache pages the decode kernel computes on, by
    its own predicate (``ptt::blocks_can_touch`` over the page's position
    range and [0, len - 1]); int32 [B], equal to ceil(len / page_size) up
    to pages_per_seq. The kernel on a CUDA tensor, the plain version on a
    CPU one."""
    if page_size <= 0 or pages_per_seq < 0:
        raise ValueError(f"page_size must be positive and pages_per_seq "
                         f">= 0, got {page_size} and {pages_per_seq}")
    if context_lens.dim() != 1:
        raise ValueError(f"context_lens must be [B], got "
                         f"{tuple(context_lens.shape)}")
    if not context_lens.is_cuda:
        return page_visit_reference(context_lens, page_size, pages_per_seq)
    return _launch_page_visit(context_lens.to(torch.int32).contiguous(),
                              page_size, pages_per_seq)


# rows a block of ``page_visit_kernel``, a warp each (kPageVisitWarps in
# csrc/paged_attention.cu)
PAGE_VISIT_WARPS = 8


def _launch_page_visit(lens, page_size, pages_per_seq):
    """One launch of ``page_visit_kernel`` over contiguous int32 lens [B]
    on the card."""
    counts = torch.empty_like(lens)
    if lens.numel() == 0:
        return counts
    err = _lib_visit()(lens.data_ptr(), counts.data_ptr(), lens.numel(),
                       page_size, pages_per_seq, lens.device.index or 0,
                       torch.cuda.current_stream(lens.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_visit launch failed: cudaError {err}")
    LAUNCHES["paged_visit"] += 1
    return counts


def _lib_visit():
    from paddle_tpu_torch.ops.cuda._build import load

    fn = load("paged_attention").ptt_page_visit
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn
