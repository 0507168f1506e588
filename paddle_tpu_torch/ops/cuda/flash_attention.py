"""Flash attention, forward and backward: the hand-written Hopper kernels,
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py`` ``_fwd_kernel``
(launched by ``_flash_fwd``, the ``pallas_call`` at :288) with
``csrc/flash_fwd.cu``, and ``_dq_kernel`` / ``_dkv_kernel`` (launched by
``_flash_bwd``, the ``pallas_call`` at :449 and :482) with
``csrc/flash_bwd.cu``.

What bounds them on the H100: at prefill and training lengths attention
does about 4·S·D flops per byte it reads (the backward 2.5 times the
forward's work, plus the recompute of the scores), so it is bound by
operations. The kernels do their math in fp32 on the CUDA cores (67 TFLOP/s),
not on the tensor cores (989 TFLOP/s bf16), so they run far from the bound;
that is the price of simple first kernels (``mma.sync``/``wgmma`` and TMA
are later work). What the design does about the operation count: the
causal loops stop at the diagonal tile, and a packed frame skips every tile
pair whose segment ranges cannot touch (``ptt::blocks_can_touch``, the same
predicate in all three kernels), so a packed frame costs O(sum of len_i^2),
not O(frame^2). The forward stages a 64x128 q tile once and reads each
32-key K/V tile once per q tile; the backward follows the JAX split, which
needs no atomics: the dq kernel owns a q tile and walks K tiles, the dkv
kernel owns a K tile and walks the q tiles of every query head of its GQA
group.

On a CUDA tensor ``flash_attention_fwd`` / ``flash_attention_bwd`` launch
the kernels or raise; on a CPU tensor they run ``flash_attention_reference``
/ ``flash_attention_bwd_reference``. ``LAUNCHES`` counts kernel launches by
kernel name.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention_fwd", "flash_attention_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "FlashAttention", "LAUNCHES", "reset_launches", "launch_counts"]

_NEG_INF = -1e30

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _mask(s, causal, segment_ids, device):
    """[B, 1, 1, S, S] (or [1, 1, 1, S, S]) bool: key t visible to query s."""
    valid = torch.ones(s, s, dtype=torch.bool, device=device)
    if causal:
        valid = torch.tril(valid)
    valid = valid.view(1, 1, 1, s, s)
    if segment_ids is not None:
        seg = segment_ids.to(device)
        valid = valid & (seg[:, None, None, :, None]
                         == seg[:, None, None, None, :])
    return valid


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
    valid = _mask(s, causal, segment_ids, q.device)
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
    LAUNCHES["flash_fwd"] += 1
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



def _bwd_reference_ds(q, k, v, out, lse, do, causal, scale, segment_ids):
    """What both backward kernels recompute first: P from the saved lse
    and dS = P * (dP - delta) * scale ([B, Hkv, g, S, S] fp32, masked
    pairs at P = 0 exactly), with the fp32 head views [B, Hkv, g, S, D]
    of q and do, k [B, Hkv, S, D], and ``back``, which returns a
    [B, Hkv, (g,) S, D] gradient to [B, S, H, D]."""
    b, s, hq, hkv, d = _check(q, k, v, segment_ids)
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def heads(t, n):                     # [B, S, H, D] -> [B, Hkv, g, S, D]
        return t.float().permute(0, 2, 1, 3).reshape(b, hkv, n, s, d)

    qf, dof, of = heads(q, g), heads(do, g), heads(out, g)
    kf = k.float().permute(0, 2, 1, 3)                     # [B, Hkv, S, D]
    vf = v.float().permute(0, 2, 1, 3)
    lse5 = lse.float().reshape(b, hkv, g, s, 1)
    delta = (dof * of).sum(-1, keepdim=True)
    valid = _mask(s, causal, segment_ids, q.device)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qf * scale, kf)
    p = torch.exp(scores - lse5).masked_fill(~valid, 0.0)
    del scores
    dp = torch.einsum("bhgsd,bhtd->bhgst", dof, vf)
    ds = p * (dp - delta) * scale
    del dp

    def back(t, n):
        return t.reshape(b, n, s, d).permute(0, 2, 1, 3).contiguous()

    return p, ds, qf, dof, kf, back


def flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                     causal: bool = False,
                                     scale: float | None = None,
                                     segment_ids=None):
    """Plain PyTorch version of the dq kernel: dq = dS·K [B, S, Hq, D]
    fp32 (arguments as ``flash_attention_bwd_reference``)."""
    _, ds, _, _, kf, back = _bwd_reference_ds(q, k, v, out, lse, do, causal,
                                              scale, segment_ids)
    return back(torch.einsum("bhgst,bhtd->bhgsd", ds, kf), q.shape[2])


def flash_attention_bwd_dkv_reference(q, k, v, out, lse, do,
                                      causal: bool = False,
                                      scale: float | None = None,
                                      segment_ids=None):
    """Plain PyTorch version of the dkv kernel: (dk = dSᵀ·Q, dv = Pᵀ·dO),
    each [B, S, Hkv, D] fp32, summed over the GQA group."""
    p, ds, qf, dof, _, back = _bwd_reference_ds(q, k, v, out, lse, do,
                                                causal, scale, segment_ids)
    dv = torch.einsum("bhgst,bhgsd->bhtd", p, dof)
    del p
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qf)
    return back(dk, k.shape[2]), back(dv, k.shape[2])


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal: bool = False,
                                  scale: float | None = None,
                                  segment_ids=None):
    """Plain PyTorch version of the backward kernels: (dq [B, S, Hq, D],
    dk, dv [B, S, Hkv, D]), all fp32, from q, k, v, the forward's out
    [B, S, Hq, D] and lse [B, Hq, S], and the output gradient do. Like the
    two kernels (and ``_flash_bwd``) it recomputes P from the saved lse and
    forms the flash-2 products explicitly (delta = rowsum(do * out),
    dS = P * (dP - delta) * scale) in fp32, once for dq and once for
    dk/dv; it is not autograd through the forward."""
    args = (q, k, v, out, lse, do, causal, scale, segment_ids)
    return (flash_attention_bwd_dq_reference(*args),
            *flash_attention_bwd_dkv_reference(*args))


def _bwd_lib():
    from paddle_tpu_torch.ops.cuda._build import load

    fn = load("flash_bwd").ptt_flash_bwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 10 + [ci] * 6 + [ctypes.c_float, ci, ci, vp]
        fn.restype = ci
    return fn


def _launch_bwd(q, k, v, out, lse, do, causal, scale, segment_ids):
    b, s, hq, hkv, d = _check(q, k, v, segment_ids)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes bf16 or fp32, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    for name, t in (("k", k), ("v", v), ("out", out), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out/do {tuple(out.shape)}/{tuple(do.shape)} must "
                         f"match q {tuple(q.shape)}")
    if tuple(lse.shape) != (b, hq, s) or lse.device != q.device:
        raise ValueError(f"lse must be [batch, q_heads, seq]=({b}, {hq}, "
                         f"{s}) on q's device, got {tuple(lse.shape)}")
    # the kernels read [B, S, H, D] rows with a contiguous head_dim; the
    # training path hands them contiguous tensors, so these are no-ops there
    q, k, v, out, do = (t.contiguous() for t in (q, k, v, out, do))
    lse = lse.float().contiguous()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    seg_ptr = None
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
        seg_ptr = segment_ids.data_ptr()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dq = torch.empty((b, s, hq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    err = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), seg_ptr, dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), b, s, hq, hkv, d,
                     int(bool(causal)), float(scale), _DTYPES[q.dtype],
                     q.device.index or 0,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {err}")
    LAUNCHES["flash_bwd_dq"] += 1
    LAUNCHES["flash_bwd_dkv"] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale: float | None = None, segment_ids=None):
    """(dq, dk, dv) in fp32 for the forward ``out, lse =
    flash_attention_fwd(q, k, v, ...)`` and the output gradient ``do``
    (delta = rowsum(do * out) is formed here, outside the kernels, as the
    JAX package forms it outside Pallas). CUDA tensors launch the dq and
    dkv kernels; CPU tensors take the plain version."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, out, lse, do, causal, scale, segment_ids)
    return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                         causal=causal, scale=scale,
                                         segment_ids=segment_ids)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over [B, S, H, D] q/k/v
    (``jax.custom_vjp`` around ``_flash_fwd``/``_flash_bwd`` in the JAX
    package): the forward kernel saves its lse, the backward kernels
    recompute P from it. Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None, segment_ids=None):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, scale=ctx.scale,
                                         segment_ids=segment_ids)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)
