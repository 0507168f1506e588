"""Functional ops of the serving and training slices
(``paddle_tpu.nn.functional`` counterpart): linear, embedding, the RMSNorm
composite, layer_norm, silu, gelu, relu, scaled_dot_product_attention, and
the losses cross_entropy, parallel_cross_entropy and
fused_linear_cross_entropy.

Weights follow PyTorch's layout: a linear weight is ``[out, in]`` (the JAX
package stores ``[in, out]``; ``models.convert`` transposes on load), so
the fused head loss takes the LM-head weight as ``[vocab, hidden]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _tF

from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.ops.cuda.flash_attention import (FlashAttention,
                                                       flash_attention_fwd)
from paddle_tpu_torch.ops.cuda.fused_ce import FusedLinearCrossEntropy

__all__ = ["linear", "embedding", "rms_norm", "layer_norm", "silu", "gelu",
           "relu",
           "scaled_dot_product_attention", "cross_entropy",
           "parallel_cross_entropy", "fused_linear_cross_entropy"]


def linear(x, weight, bias=None):
    """y = x @ W^T + b with W ``[out, in]`` (paddle_tpu F.linear :233 takes
    ``[in, out]``). A plain matmul outside any kernel, as the JAX package
    left it to XLA."""
    return _tF.linear(x, weight, bias)


def embedding(x, weight, padding_idx=None):
    out = weight[x]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def rms_norm(x, weight=None, epsilon=1e-6):
    """The composite RMSNorm (paddle_tpu F.rms_norm :661): fp32 statistics,
    normalized value cast back to x's dtype, then scaled by the weight."""
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                            + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes (paddle_tpu
    F.layer_norm :634): ``(x - mean) * rsqrt(var + eps) * weight + bias``
    with the biased variance."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _tF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def silu(x):
    return _tF.silu(x)


def gelu(x, approximate=False):
    """paddle's ``F.gelu``: the erf form by default, the tanh approximation
    with ``approximate=True`` (``jax.nn.gelu``'s own default)."""
    return _tF.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return _tF.relu(x)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, segment_ids=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors (paddle_tpu
    F.scaled_dot_product_attention :1292): GQA when key/value carry fewer
    heads, and ``segment_ids`` ``[batch, seq]`` makes it block-diagonal per
    packed document (composed with the causal mask). CUDA tensors run the
    hand-written flash kernels; CPU tensors their plain versions. With
    grad enabled and any input requiring it, the call goes through the
    differentiable ``FlashAttention`` (forward kernel, then the dq/dkv
    backward kernels); otherwise straight to the forward kernel.
    ``attn_mask`` and dropout are not on the LLaMA path and not ported."""
    if attn_mask is not None:
        raise NotImplementedError("attn_mask is not ported yet")
    if dropout_p > 0.0 and training:
        raise NotImplementedError("attention dropout is not ported yet")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (query, key, value)):
        return FlashAttention.apply(query, key, value, is_causal, None,
                                    segment_ids)
    out, _ = flash_attention_fwd(query, key, value, causal=is_causal,
                                 segment_ids=segment_ids)
    return out


def _check_labels(label):
    if label.dtype.is_floating_point:
        raise TypeError(f"cross-entropy takes integer class labels, got "
                        f"{label.dtype}")


def _reduce_valid(nll, valid, reduction, shape):
    """``_fused_ce_reduce``: mean over the non-ignored tokens, sum, or the
    per-token values shaped like the labels."""
    if reduction == "mean":
        return nll.sum() / valid.sum().clamp_min(1).to(nll.dtype)
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll.reshape(shape)
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")


def _token_nll(input, label, ignore_index, label_smoothing):
    """fp32 per-token softmax CE of logits [..., V]; ignored tokens 0."""
    logp = torch.log_softmax(input.float(), dim=-1)
    v = input.shape[-1]
    picked = logp.gather(-1, label.long().clamp(0, v - 1)[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (-(1.0 - label_smoothing) * picked
               - label_smoothing * logp.mean(-1))
    else:
        nll = -picked
    valid = label != ignore_index
    return torch.where(valid, nll, 0.0), valid


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  label_smoothing=0.0):
    """Hard-label softmax cross-entropy over the last axis of the logits
    ``input`` (paddle_tpu F.cross_entropy :866): fp32 statistics, mean over
    the non-ignored tokens, the result in the logits' dtype. The unfused
    path: it takes logits that already exist (the
    ``use_fused_head_loss=False`` escape hatch, and the tests)."""
    _check_labels(label)
    nll, valid = _token_nll(input, label, ignore_index, label_smoothing)
    return _reduce_valid(nll, valid, reduction, label.shape).to(input.dtype)


def parallel_cross_entropy(input, label, ignore_index=-100,
                           label_smoothing=0.0):
    """Per-token fp32 softmax CE shaped like `label`, ignored tokens 0
    (paddle_tpu F.parallel_cross_entropy :945 on one device: the vocab is
    not sharded in this slice)."""
    _check_labels(label)
    return _token_nll(input, label, ignore_index, label_smoothing)[0]


def fused_linear_cross_entropy(x, weight, label, bias=None, ignore_index=-100,
                               reduction="mean", label_smoothing=0.0,
                               z_loss=0.0, chunk_tokens=0):
    """loss = CE(x·weightᵀ, label) without the [tokens, vocab] logits, in
    the forward or the backward (paddle_tpu F.fused_linear_cross_entropy
    :1009). x: [..., hidden]; weight: ``[vocab, hidden]`` (the LM head's
    PyTorch layout); label: integer [...]. The statistics run the
    hand-written ``ce_stats`` kernel on CUDA tensors (its plain version on
    CPU ones); ``reduction="mean"`` averages over the non-ignored tokens.
    ``chunk_tokens`` (0 = the ``fused_ce_chunk_tokens`` flag, then
    ``resolve_chunks``) sets the backward's token chunk. The JAX package's
    vocab-chunked and mp-sharded variants, fp8 and ``bias`` are not on the
    single-card LLaMA path and not ported."""
    if bias is not None:
        raise NotImplementedError("a bias on the fused head loss is not "
                                  "ported yet")
    _check_labels(label)
    chunk_tokens = chunk_tokens or flag("fused_ce_chunk_tokens")
    flat = x.reshape(-1, x.shape[-1])
    labf = label.reshape(-1)
    nll = FusedLinearCrossEntropy.apply(flat, weight, labf, ignore_index,
                                        label_smoothing, z_loss,
                                        chunk_tokens)
    return _reduce_valid(nll, labf != ignore_index, reduction, label.shape)
