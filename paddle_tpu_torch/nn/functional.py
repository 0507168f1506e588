"""Functional ops of the serving slice (``paddle_tpu.nn.functional``
counterpart): linear, embedding, the RMSNorm composite, silu and
scaled_dot_product_attention.

Weights follow PyTorch's layout: a linear weight is ``[out, in]`` (the JAX
package stores ``[in, out]``; ``models.convert`` transposes on load).
"""
from __future__ import annotations

import torch
import torch.nn.functional as _tF

from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd

__all__ = ["linear", "embedding", "rms_norm", "silu",
           "scaled_dot_product_attention"]


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


def silu(x):
    return _tF.silu(x)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, segment_ids=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors (paddle_tpu
    F.scaled_dot_product_attention :1292): GQA when key/value carry fewer
    heads, and ``segment_ids`` ``[batch, seq]`` makes it block-diagonal per
    packed document (composed with the causal mask). CUDA tensors run the
    hand-written flash kernel; CPU tensors its plain version.
    ``attn_mask`` and dropout are not on the serving path and not ported."""
    if attn_mask is not None:
        raise NotImplementedError("attn_mask is not ported yet")
    if dropout_p > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    out, _ = flash_attention_fwd(query, key, value, causal=is_causal,
                                 segment_ids=segment_ids)
    return out
