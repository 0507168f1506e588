"""Paged decode attention: the hand-written Hopper kernel and its plain
PyTorch version.

Replaces ``paddle_tpu/ops/pallas/paged_attention.py`` ``_decode_kernel``
(launched by ``paged_decode_attention``, the ``pallas_call`` at :282). The
CUDA source is ``csrc/paged_attention.cu``.

Layout as in the JAX package: K/V page pools ``[Hkv, P, page_size, D]``
(page 0 is the reserved null page), page table ``[B, pages_per_seq]``
int32, ``context_lens`` ``[B]`` int32 (0 marks an inactive row, whose
output is zeros). q is ``[B, Hq, D]`` (decode) or ``[B, T, Hq, D]`` (a
frame whose query i sees keys ``< len + i``).

What bounds it on the H100: bytes. A decode step reads every live K/V page
once and does about one flop per byte, far below the ~295 flops per byte
where the tensor cores would become the limit. What the design does about
it: one block per (row, kv head) reads each needed page exactly once for
all ``T * group`` query rows of that kv head (GQA never repeats K/V), and
pages past the last query's key range are never read (the page predicate
the flash kernel shares), so a step moves O(sum of live tokens) bytes. A
long row next to short ones would leave SMs idle while one block walks it,
so the context is split into 512-key blocks (split-K) whose partial
softmax states a second small kernel merges.

On a CUDA tensor ``paged_attention`` launches the kernel or raises; on a
CPU tensor it runs ``paged_attention_reference``. ``LAUNCHES`` counts
kernel launches by kernel name.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["paged_attention", "paged_attention_reference", "LAUNCHES",
           "reset_launches", "launch_counts", "MAX_FRAME_ROWS"]

_NEG_INF = -1e30
MAX_FRAME_ROWS = 64     # T * group bound of the kernel's shared memory

LAUNCHES = {"paged_decode": 0}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
                              scale: float | None = None):
    """Plain PyTorch version: gather every page of the table, then a masked
    softmax in fp32. Same layouts and per-query causal limits as the
    kernel; returns q's shape and dtype."""
    b, hq, hkv, ps, d = _check_shapes(q, k_pages, v_pages, page_table,
                                      context_lens)
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


def _lib():
    from paddle_tpu_torch.ops.cuda._build import load

    lib = load("paged_attention")
    fn, splits = lib.ptt_paged_decode, lib.ptt_paged_splits
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ci, ci, ci, ctypes.c_float, ci, ci, vp]
        fn.restype = ci
        splits.argtypes = [ci, ci, ci]
        splits.restype = ci
    return fn, splits


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _launch(q, k_pages, v_pages, page_table, context_lens, scale):
    b, hq, hkv, ps, d = _check_shapes(q, k_pages, v_pages, page_table,
                                      context_lens)
    squeeze = q.dim() == 3
    q4 = (q[:, None] if squeeze else q).contiguous()
    t = q4.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged kernel takes bf16 or fp32, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"paged kernel takes head_dim 64 or 128, got {d}")
    if t * (hq // hkv) > MAX_FRAME_ROWS:
        raise ValueError(f"T * group = {t * (hq // hkv)} query rows per kv "
                         f"head exceeds the kernel's {MAX_FRAME_ROWS}")
    for name, a in (("k_pages", k_pages), ("v_pages", v_pages)):
        if a.device != q.device or a.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q4)
    fn, splits = _lib()
    # split-K scratch: unnormalized (acc, max, sum) per split
    n_splits = splits(pt.shape[1], ps, t)
    tg = t * (hq // hkv)
    ws_acc = torch.empty((b, hkv, n_splits, tg, d), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((b, hkv, n_splits, tg, 2), dtype=torch.float32,
                        device=q.device)
    err = fn(q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             pt.data_ptr(), lens.data_ptr(), out.data_ptr(),
             ws_acc.data_ptr(), ws_ml.data_ptr(), b, t, hq, hkv,
             k_pages.shape[1], ps, pt.shape[1], d, float(scale),
             _DTYPES[q.dtype], q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {err}")
    LAUNCHES["paged_decode"] += 1
    return out[:, 0] if squeeze else out


def paged_attention(q, k_pages, v_pages, page_table, context_lens,
                    scale: float | None = None):
    """Attention over the paged KV cache (what the model's decode path
    calls). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, page_table, context_lens, scale)
    return paged_attention_reference(q, k_pages, v_pages, page_table,
                                     context_lens, scale=scale)
