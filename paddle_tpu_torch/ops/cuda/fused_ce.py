"""Fused linear + cross-entropy: the hand-written Hopper statistics kernel,
its plain PyTorch version, and the ``torch.autograd.Function`` around them
(``paddle_tpu/ops/pallas/fused_ce.py`` counterpart, token-chunked variant).

Replaces ``_ce_stats_kernel`` (``fused_ce.py:246``, launched by
``_stats_pallas``, the ``pallas_call`` at :293) with ``csrc/fused_ce.cu``.
The loss needs three per-token scalars of the logits row x·Wᵀ (max,
log-sum-exp, target logit) plus the row sum for label smoothing; the
[tokens, vocab] logits never exist, in the forward or the backward.

What bounds it on the H100: the tile product, 2·N·V·H flops (1.07 TFLOP at
N 4096, H 4096, V 32000) against 2·(N + V)·H bytes, so operations. The
kernel computes the product in its own body, a 64-token x 128-vocab tile
at a time with fp32 accumulation: bf16 inputs on the tensor cores through
``mma.sync`` (``wgmma`` and TMA are later work), fp32 inputs on the CUDA
cores. What the design does about the card's width: N 4096 gives only 64
token blocks for 132 SMs, so the vocabulary is split across blocks too and
a second small kernel merges the partial statistics.

The backward (``FusedLinearCrossEntropy.backward``) replays ``_bwd_tokens``:
per token chunk it recomputes the [C, V] fp32 logits tile, forms the
d-logits as ``_chunk_dlogits`` does, and accumulates dx and dW in fp32.
Those products are ``torch.matmul``, as the JAX package leaves them to XLA
in a ``lax.scan`` outside any Pallas kernel.

Weights follow PyTorch's layout: W is ``[vocab, hidden]`` (the JAX package
takes ``[hidden, vocab]``). On a CUDA tensor ``ce_stats`` launches the
kernel or raises; on a CPU tensor it runs ``ce_stats_reference``.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["ce_stats", "ce_stats_reference", "resolve_chunks",
           "FusedLinearCrossEntropy", "LAUNCHES", "reset_launches",
           "launch_counts"]

_BV = 128                  # vocab columns per kernel tile (csrc/fused_ce.cu)
_BR = 64                   # tokens per kernel block
_BH = 16                   # H slice of the fp32 path
_BH_MMA = 64               # H slice of the bf16 (mma.sync) path

LAUNCHES = {"ce_stats": 0}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_chunks(n_tokens: int, vocab: int, chunk_tokens: int = 0,
                   chunk_vocab: int = 0) -> tuple[int, int]:
    """Default chunk sizes bounding the live logits tile to ~4M fp32 elements
    (16 MB). Overrides win when positive (``fused_ce.py:110``)."""
    target = 1 << 22
    ct = chunk_tokens if chunk_tokens > 0 else max(
        16, min(n_tokens, target // max(vocab, 1)))
    cv = chunk_vocab if chunk_vocab > 0 else max(
        128, min(vocab, target // max(n_tokens, 1)))
    return min(ct, max(n_tokens, 1)), min(cv, max(vocab, 1))


def _check(x, w, labels):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x must be [N, H] and w [V, H], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if labels.shape != x.shape[:1]:
        raise ValueError(f"labels must be [N]={tuple(x.shape[:1])}, got "
                         f"{tuple(labels.shape)}")
    if labels.dtype.is_floating_point:
        raise TypeError(f"cross-entropy takes integer class labels, got "
                        f"{labels.dtype}")
    return x.shape[0], w.shape[0], x.shape[1]


def ce_stats_reference(x, w, labels, chunk_tokens: int = 0):
    """Plain PyTorch version of the kernel: per-token fp32 (m, s, t, sl) of
    the logits rows x·Wᵀ, token chunk by token chunk so at most a [C, V]
    fp32 tile exists. Labels outside [0, V) match no column (t = 0)."""
    n, v, _ = _check(x, w, labels)
    ct = resolve_chunks(n, v, chunk_tokens)[0]
    wf = w.float()
    stats = []
    for i in range(0, n, ct):
        logits = x[i:i + ct].float() @ wf.T
        lab = labels[i:i + ct].long()
        hit = (lab >= 0) & (lab < v)
        m = logits.amax(-1)
        s = torch.exp(logits - m[:, None]).sum(-1)
        t = logits.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
        stats.append((m, s, torch.where(hit, t, 0.0), logits.sum(-1)))
    if not stats:
        empty = x.new_zeros(0, dtype=torch.float32)
        return empty, empty, empty, empty
    return tuple(torch.cat(c) for c in zip(*stats))


def _lib():
    from paddle_tpu_torch.ops.cuda._build import load

    fn = load("fused_ce").ptt_ce_stats
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 7 + [vp]
        fn.restype = ci
    return fn


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _split(n, v, device):
    """(nsplit, tiles_per_split): enough vocab splits that the grid holds
    about 16 blocks per SM, none of them empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-v // _BV)
    want = max(1, min(tiles, -(-16 * sms // -(-n // _BR))))
    per = -(-tiles // want)
    return -(-tiles // per), per


def _launch(x, w, labels):
    n, v, h = _check(x, w, labels)
    if x.dtype not in _DTYPES or w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"ce_stats kernel takes bf16 or fp32 x and w of one "
                        f"dtype and device, got {x.dtype}/{w.dtype} on "
                        f"{x.device}/{w.device}")
    h_step = _BH_MMA if x.dtype == torch.bfloat16 else _BH
    if h % h_step:
        raise ValueError(f"ce_stats kernel takes a {x.dtype} hidden size that "
                         f"is a multiple of {h_step}, got {h}")
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ce_stats kernel needs 16-byte aligned x and w")
    labels = labels.to(device=x.device, dtype=torch.int32).contiguous()
    stats = torch.empty((4, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return tuple(stats)
    nsplit, per = _split(n, v, x.device)
    part = torch.empty((4, nsplit, n), dtype=torch.float32, device=x.device)
    m, s, t, sl = stats
    err = _lib()(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                 part.data_ptr(), m.data_ptr(), s.data_ptr(), t.data_ptr(),
                 sl.data_ptr(), n, v, h, nsplit, per, _DTYPES[x.dtype],
                 x.device.index or 0,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_stats launch failed: cudaError {err}")
    LAUNCHES["ce_stats"] += 1
    return m, s, t, sl


def ce_stats(x, w, labels):
    """Per-token fp32 statistics (m, s, t, sl) of the logits x·Wᵀ for
    x [N, H], W [V, H], labels [N] int: running max, sum of exp(logit - m),
    the target logit (0 for a label outside [0, V), ``ignore_index``
    included) and the sum of logits. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if x.is_cuda:
        return _launch(x, w, labels)
    return ce_stats_reference(x, w, labels)


class FusedLinearCrossEntropy(torch.autograd.Function):
    """Per-token fp32 loss of ``CE(x·Wᵀ, labels)`` without the [N, V]
    logits: x [N, H], W [V, H], labels [N] int; ignored tokens give 0.
    ``label_smoothing`` mixes in the uniform target, ``z_loss`` adds
    ``z·lse²``; both reach value and gradient, as in ``_fwd_impl`` /
    ``_bwd_tokens``. ``chunk_tokens`` (0 = ``resolve_chunks``) sets the
    backward's token chunk."""

    @staticmethod
    def forward(ctx, x, w, labels, ignore_index=-100, label_smoothing=0.0,
                z_loss=0.0, chunk_tokens=0):
        m, s, t, sl = ce_stats(x, w, labels)
        lse = m + torch.log(s)
        eps = float(label_smoothing)
        if eps == 0.0:
            nll = lse - t
        else:
            nll = lse - (1.0 - eps) * t - eps * sl / w.shape[0]
        if z_loss:
            nll = nll + z_loss * lse * lse
        ctx.save_for_backward(x, w, labels, lse)
        ctx.cfg = (int(ignore_index), eps, float(z_loss), int(chunk_tokens))
        return torch.where(labels != ignore_index, nll, 0.0)

    @staticmethod
    def backward(ctx, ct):
        x, w, labels, lse = ctx.saved_tensors
        ignore_index, eps, z_loss, chunk_tokens = ctx.cfg
        n, v = x.shape[0], w.shape[0]
        ctv = torch.where(labels != ignore_index, ct.float(), 0.0)
        coef = ctv * (1.0 + 2.0 * z_loss * lse) if z_loss else ctv
        lab = labels.long()
        hit = ((lab >= 0) & (lab < v)).float()
        safe = lab.clamp(0, v - 1)
        c = resolve_chunks(n, v, chunk_tokens)[0]
        wf = w.float()
        dx = torch.empty((n, x.shape[1]), dtype=torch.float32,
                         device=x.device)
        dw = torch.zeros((v, x.shape[1]), dtype=torch.float32,
                         device=x.device)
        for i in range(0, n, c):
            xc = x[i:i + c].float()
            # d loss / d logits of one recomputed fp32 tile, in place:
            # p * coef - (1 - eps) * ct * onehot - (eps / V) * ct
            d = (xc @ wf.T).sub_(lse[i:i + c, None]).exp_()
            d.mul_(coef[i:i + c, None])
            d.scatter_add_(1, safe[i:i + c, None],
                           (-(1.0 - eps) * ctv[i:i + c]
                            * hit[i:i + c])[:, None])
            if eps:
                d.sub_((eps / v) * ctv[i:i + c, None])
            torch.matmul(d, wf, out=dx[i:i + c])
            dw.addmm_(d.T, xc)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None, None
