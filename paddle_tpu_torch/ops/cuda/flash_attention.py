"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py`` ``_fwd_kernel``
(launched by ``_flash_fwd``, the ``pallas_call`` at :288). The CUDA source
is ``csrc/flash_fwd.cu``.

What bounds it on the H100: at prefill lengths attention does about
4·S·D flops per byte it reads, so it is bound by operations. The kernel does
its math in fp32 on the CUDA cores (67 TFLOP/s), not on the tensor cores
(989 TFLOP/s bf16), so it runs far from the bound; that is the price of a
simple first kernel (``mma.sync``/``wgmma`` and TMA are later work). What
the design does about the operation count: the causal loop stops at the
diagonal tile, and a packed frame skips every K tile whose segment range
cannot touch the q tile's, so a packed frame costs O(sum of len_i^2), not
O(frame^2). The 64x128 q tile is staged once in shared memory, and each
32-key K/V tile is read once per q tile.

On a CUDA tensor ``flash_attention_fwd`` launches the kernel or raises; on
a CPU tensor it runs ``flash_attention_reference``. ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention_fwd", "flash_attention_reference", "LAUNCHES",
           "reset_launches", "launches"]

_NEG_INF = -1e30

LAUNCHES = 0


def launches() -> int:
    return LAUNCHES


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _check(q, k, v, segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(
            f"q heads must be a multiple of kv heads, got {hq} and {hkv}")
    if segment_ids is not None and tuple(segment_ids.shape) != (b, s):
        raise ValueError(f"segment_ids must be [batch, seq]=({b}, {s}), "
                         f"got {tuple(segment_ids.shape)}")
    return b, s, hq, hkv, d


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: float | None = None, segment_ids=None):
    """Plain PyTorch version of the kernel: q [B, S, Hq, D], k/v
    [B, S, Hkv, D] -> (out [B, S, Hq, D] in q's dtype, lse [B, Hq, S] fp32).
    fp32 math; masked keys get probability 0 exactly as in the kernel."""
    b, s, hq, hkv, d = _check(q, k, v, segment_ids)
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3).reshape(b, hkv, g, s, d) * scale
    kf = k.float().permute(0, 2, 1, 3)                     # [B, Hkv, S, D]
    vf = v.float().permute(0, 2, 1, 3)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qf, kf)
    valid = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid)
    valid = valid.view(1, 1, 1, s, s)
    if segment_ids is not None:
        seg = segment_ids.to(q.device)
        valid = valid & (seg[:, None, None, :, None]
                         == seg[:, None, None, None, :])
    scores = scores.masked_fill(~valid, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgst,bhtd->bhgsd", p / l, vf)
    out = out.reshape(b, hq, s, d).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, hq, s)
    return out.contiguous(), lse


def _lib():
    from paddle_tpu_torch.ops.cuda._build import load

    fn = load("flash_fwd").ptt_flash_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, ci,
                       ctypes.c_float, ci, ci, vp]
        fn.restype = ci
    return fn


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _launch(q, k, v, causal, scale, segment_ids):
    global LAUNCHES
    b, s, hq, hkv, d = _check(q, k, v, segment_ids)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes bf16 or fp32, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        sb, ss, sh, sd = t.stride()
        if sd != 1 or any(x % 8 for x in (sb, ss, sh)) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head_dim, strides "
                             f"that are multiples of 8 and a 16-byte "
                             f"aligned base, got strides {t.stride()}")
        strides += [sb, ss, sh]
    seg_ptr = None
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
        seg_ptr = segment_ids.data_ptr()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    st = (ctypes.c_longlong * 9)(*strides)
    fn = _lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr,
             out.data_ptr(), lse.data_ptr(), b, s, hq, hkv, d, st,
             int(bool(causal)), float(scale), _DTYPES[q.dtype],
             q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    LAUNCHES += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: float | None = None, segment_ids=None):
    """(out, lse) of attention over [B, S, H, D] q/k/v (GQA when k/v carry
    fewer heads; ``segment_ids`` [B, S] makes it block-diagonal per packed
    document). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if q.is_cuda:
        return _launch(q, k, v, causal, scale, segment_ids)
    return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                     segment_ids=segment_ids)

