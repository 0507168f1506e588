"""Functional ops (``paddle_tpu.nn.functional`` counterpart), for two
callers.

**The torch-level seam of the port's models.** Called with ``torch.Tensor``
arguments (``models/llama.py``, ``gpt_moe.py``, the MoE layer), these
functions are the port's dispatch seam (the JAX package's ``apply_op``):
``linear``, ``embedding``, ``rms_norm``, ``sdpa``, ``mean``,
``cross_entropy`` and ``fused_linear_cross_entropy`` pass their tensor
arguments through ``amp.apply_seam`` under their JAX op names (the O1/O2
casts, the operator stats) and their outputs through ``amp.check_outputs``
(the tensor checker); so do the activations, dropouts and losses ported
for the Paddle layers. ``linear`` runs the fp8 path when an ``amp.fp8``
session asks for it, and ``fused_linear_cross_entropy`` the fp8 head route
under ``matmuls+head``. Weights follow PyTorch's layout here: a linear
weight is ``[out, in]`` (``models.convert`` transposes the JAX package's
``[in, out]`` on load), and the fused head loss takes the LM-head weight as
``[vocab, hidden]``.

**The Paddle API.** Called with any argument a ``paddle_tpu_torch.Tensor``
(the ``nn`` layers, ``models/gpt.py``), each function runs its torch-level
self through ``core.tensor.apply_op`` and returns ``Tensor``s. The ones
that do not pass the AMP seam themselves (``layer_norm``, ``gelu``,
``silu``, ``relu``) pass it there, under their JAX names. The one layout
difference is ``linear``, whose Paddle weight is ``[in, out]`` as in Paddle
and the JAX package (and ``fused_linear_cross_entropy``, whose Paddle head
weight is ``[hidden, vocab]``): that branch hands the torch-level call the
transposed view. So O1 ``auto_cast``, the operator stats and the fp8
session apply to Paddle code as they do to the models, a CUDA
``scaled_dot_product_attention`` reaches the flash kernels
(``FlashAttention``) and ``fused_linear_cross_entropy`` the fused CE ones.
"""
from __future__ import annotations

import functools
import math
import threading

import torch
import torch.nn.functional as _tF

from paddle_tpu_torch.amp import apply_seam, check_outputs
from paddle_tpu_torch.amp import fp8 as _fp8
from paddle_tpu_torch.core.dtype import to_torch_dtype
from paddle_tpu_torch.core.tensor import Tensor, apply_op
from paddle_tpu_torch.ops.cuda.flash_attention import (FlashAttention,
                                                       flash_attention_fwd)
from paddle_tpu_torch.ops.cuda.fused_ce import (Fp8LinearCrossEntropy,
                                                FusedLinearCrossEntropy)
from paddle_tpu_torch.ops.manipulation import pad  # noqa: F401 (re-export)
from paddle_tpu_torch.ops.random_state import active_generator

__all__ = [
    # activations
    "relu", "relu6", "gelu", "sigmoid", "silu", "swish", "tanh", "softmax",
    "log_softmax", "leaky_relu", "elu", "selu", "celu", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "mish", "softplus", "softshrink",
    "softsign", "tanhshrink", "thresholded_relu", "log_sigmoid", "glu",
    "prelu", "maxout",
    # linear / embedding / norms
    "linear", "embedding", "rms_norm", "layer_norm", "mean",
    # dropout
    "dropout", "dropout2d", "alpha_dropout",
    # attention
    "scaled_dot_product_attention",
    # losses
    "cross_entropy", "parallel_cross_entropy", "fused_linear_cross_entropy",
    "mse_loss", "l1_loss", "nll_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "smooth_l1_loss", "pad",
]

_NEG_BIAS = -1e30  # additive mask floor: composes without fp32 overflow


def _paddle_entry(seam=None):
    """The entry rule: with any ``Tensor`` argument, run the function on
    the unwrapped torch tensors through ``apply_op`` (passing the AMP seam
    there under `seam`, for functions that do not pass it themselves) and
    return ``Tensor``s; otherwise call it as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if any(isinstance(a, Tensor) for a in args) or any(
                    isinstance(a, Tensor) for a in kwargs.values()):
                return apply_op(fn, *args, name=seam, seam=seam is not None,
                                **kwargs)
            return fn(*args, **kwargs)

        return entry

    return deco


def _seamed(name, fn, *tensors):
    """fn(*tensors) through the AMP seam under `name` and the checker."""
    return check_outputs(name, fn(*apply_seam(name, tensors)))


# ---------------------------------------------------------------------------
# linear / embedding / norms
# ---------------------------------------------------------------------------

class _WGradSeam(threading.local):
    """The weight-gradient deferral of the ZB-H1 pipeline
    (``parallel.zero_bubble``): while a stage's forward runs under it on
    this thread, a product with a leaf weight (before any AMP cast) goes
    through the sink, whose backward gives dX at once and queues (x, dy)
    for dW on a later W tick."""

    sink = None


_WGRAD = _WGradSeam()


def _linear(x, weight, bias=None):
    if _fp8.linear_fp8_enabled(x, weight):
        x, weight, bias = apply_seam("fp8_linear", (x, weight, bias))
        return check_outputs("fp8_linear", _fp8.fp8_linear(x, weight, bias))
    master = weight
    x, weight, bias = apply_seam("linear", (x, weight, bias))
    sink = _WGRAD.sink
    # the leaf test is on the weight before the AMP cast: under AMP with
    # fp32 masters the product takes the cast copy and dW is queued
    # against the master
    if sink is not None and master.is_leaf and master.requires_grad \
            and torch.is_grad_enabled():
        return check_outputs("linear", sink.linear(x, weight, bias, master))
    return check_outputs("linear", _tF.linear(x, weight, bias))


def linear(x, weight, bias=None, name=None):
    """y = x @ W^T + b with W ``[out, in]`` on torch tensors; on Paddle
    ``Tensor``s y = x @ W + b with W ``[in, out]`` (paddle_tpu F.linear
    :233). A plain matmul outside any kernel, as the JAX package left it to
    XLA. Under an fp8 session (``amp.fp8``) the product runs through
    ``fp8_linear`` (op name ``fp8_linear``)."""
    if isinstance(x, Tensor) or isinstance(weight, Tensor):
        return apply_op(lambda v, w, b: _linear(v, w.t(), b), x, weight,
                        bias, seam=False)
    return _linear(x, weight, bias)


@_paddle_entry()
def embedding(x, weight, padding_idx=None, sparse=False):
    x, weight = apply_seam("embedding", (x, weight))
    out = _tF.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return check_outputs("embedding", out)


@_paddle_entry()
def rms_norm(x, weight=None, epsilon=1e-6):
    """The composite RMSNorm (paddle_tpu F.rms_norm :661): fp32 statistics,
    normalized value cast back to x's dtype, then scaled by the weight."""
    x, weight = apply_seam("rms_norm", (x, weight))
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                            + epsilon)).to(x.dtype)
    return check_outputs("rms_norm",
                         out * weight if weight is not None else out)


@_paddle_entry()
def mean(x):
    """The mean of every element (op name ``mean``, black-listed: fp32
    under O1 and O2)."""
    (x,) = apply_seam("mean", (x,))
    return check_outputs("mean", x.mean())


@_paddle_entry(seam="layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes (paddle_tpu
    F.layer_norm :634): ``(x - mean) * rsqrt(var + eps) * weight + bias``
    with the biased variance."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _tF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@_paddle_entry(seam="silu")
def silu(x):
    return _tF.silu(x)


@_paddle_entry(seam="gelu")
def gelu(x, approximate=False):
    """paddle's ``F.gelu``: the erf form by default, the tanh approximation
    with ``approximate=True`` (``jax.nn.gelu``'s own default)."""
    return _tF.gelu(x, approximate="tanh" if approximate else "none")


@_paddle_entry(seam="relu")
def relu(x):
    return _tF.relu(x)


def _act(name, fn):
    """An activation under its JAX op name: fn(x, *args, **kwargs)."""
    def op(x, *args, **kwargs):
        return _seamed(name, lambda v: fn(v, *args, **kwargs), x)

    op.__name__ = name
    return _paddle_entry()(op)


relu6 = _act("relu6", _tF.relu6)
sigmoid = _act("sigmoid", torch.sigmoid)
swish = _act("swish", _tF.silu)
tanh = _act("tanh", torch.tanh)
softplus = _act("softplus", lambda v: _tF.softplus(v))
softsign = _act("softsign", _tF.softsign)
log_sigmoid = _act("log_sigmoid", _tF.logsigmoid)
mish = _act("mish", _tF.mish)
leaky_relu = _act("leaky_relu", lambda v, negative_slope=0.01:
                  _tF.leaky_relu(v, negative_slope))
elu = _act("elu", lambda v, alpha=1.0: _tF.elu(v, alpha))
celu = _act("celu", lambda v, alpha=1.0: _tF.celu(v, alpha))
selu = _act("selu", lambda v, scale=1.0507009873554805,
            alpha=1.6732632423543772:
            scale * torch.where(v > 0, v, alpha * torch.expm1(v)))
hardshrink = _act("hardshrink", lambda v, threshold=0.5:
                  torch.where(v.abs() > threshold, v, 0.0))
hardsigmoid = _act("hardsigmoid", lambda v, slope=1.0 / 6, offset=0.5:
                   torch.clamp(slope * v + offset, 0.0, 1.0))
hardswish = _act("hardswish",
                 lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0) / 6.0)
hardtanh = _act("hardtanh", lambda v, min=-1.0, max=1.0:
                torch.clamp(v, min, max))
softshrink = _act("softshrink", lambda v, threshold=0.5: torch.where(
    v > threshold, v - threshold,
    torch.where(v < -threshold, v + threshold, 0.0)))
tanhshrink = _act("tanhshrink", lambda v: v - torch.tanh(v))
thresholded_relu = _act("thresholded_relu", lambda v, threshold=1.0:
                        torch.where(v > threshold, v, 0.0))


def _softmax(fn, name):
    def op(x, axis=-1, dtype=None):
        d = to_torch_dtype(dtype)
        return _seamed(name, lambda v: fn(v if d is None else v.to(d),
                                          dim=axis), x)

    op.__name__ = name
    return _paddle_entry()(op)


softmax = _softmax(torch.softmax, "softmax")
log_softmax = _softmax(torch.log_softmax, "log_softmax")


@_paddle_entry()
def glu(x, axis=-1):
    def f(v):
        a, b = torch.chunk(v, 2, dim=axis)
        return a * torch.sigmoid(b)

    return _seamed("glu", f, x)


@_paddle_entry()
def prelu(x, weight):
    def f(v, w):
        if w.numel() == 1:
            w = w.reshape(())
        else:
            shape = [1] * v.ndim
            shape[1] = w.numel()
            w = w.reshape(shape)
        return torch.where(v > 0, v, w * v)

    return _seamed("prelu", f, x, weight)


@_paddle_entry()
def maxout(x, groups, axis=1):
    def f(v):
        shape = list(v.shape)
        shape[axis] //= groups
        shape.insert(axis + 1, groups)
        return torch.amax(v.reshape(shape), dim=axis + 1)

    return _seamed("maxout", f, x)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def _keep_mask(x, p, shape):
    """Bernoulli(1 - p) of `shape` from the global generator's stream on
    x's device (a fleet RNG tracker's, inside its ``rng_state`` scope)."""
    g = active_generator(x.device)
    return torch.rand(shape, generator=g, device=x.device) < (1.0 - p)


@_paddle_entry()
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability `p` (elements sharing their
    indices outside `axis` together), scaling the kept ones by 1 / (1 - p)
    under ``upscale_in_train``; the identity when not training or p == 0,
    as in the JAX package."""
    if not training or p == 0.0:
        return x
    (x,) = apply_seam("dropout", (x,))
    shape = x.shape
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = _keep_mask(x, p, shape)
    if mode == "upscale_in_train":
        return check_outputs("dropout", torch.where(keep, x / (1.0 - p),
                                                    0.0))
    return check_outputs("dropout", torch.where(keep, x, 0.0))


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    return dropout(x, p, axis=(0, 1), training=training)


@_paddle_entry()
def alpha_dropout(x, p=0.5, training=True):
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _keep_mask(x, p, x.shape)
    a = (1.0 / math.sqrt((1 - p) * (1 + p * alpha_p ** 2))) if p < 1 else 0.0
    b = -a * alpha_p * p
    return _seamed("alpha_dropout",
                   lambda v: a * torch.where(keep, v, alpha_p) + b, x)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _sdpa_composite(q, k, v, mask, is_causal, seg):
    """The JAX package's XLA attention (paddle_tpu F.sdpa :1345-1396): fp32
    scores of grouped query heads, the hard masks (bool ``attn_mask``,
    causal, segment) as one validity test, a float mask added with a floor
    of -1e30, softmax, probabilities in q's dtype times v."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    b, hq, s, d = qh.shape
    hkv = kh.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads must be a multiple of kv heads, got {hq} "
                         f"and {hkv}")
    g = hq // hkv
    qg = qh.reshape(b, hkv, g, s, d)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qg, kh).float() / math.sqrt(d)
    t = scores.shape[-1]
    valid = None
    if mask is not None:
        m = torch.broadcast_to(mask, (b, hq, s, t)).reshape(b, hkv, g, s, t)
        if m.dtype == torch.bool:
            valid = m
        else:
            scores = scores + torch.clamp(m.float(), min=_NEG_BIAS)
    if is_causal:
        causal = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        valid = causal if valid is None else valid & causal
    if seg is not None:
        same = seg[:, None, None, :, None] == seg[:, None, None, None, :]
        valid = same if valid is None else valid & same
    if valid is not None:
        scores = torch.where(valid, scores, 2.0 * _NEG_BIAS)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, vh).reshape(b, hq, s, d)
    return out.transpose(1, 2)


def _sdpa(query, key, value, attn_mask, dropout_p, is_causal, training,
          segment_ids):
    query, key, value = apply_seam("sdpa", (query, key, value))
    if attn_mask is not None or dropout_p > 0.0:
        out = check_outputs("sdpa", _sdpa_composite(
            query, key, value, attn_mask, is_causal, segment_ids))
        return dropout(out, dropout_p, training=training)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (query, key, value)):
        return check_outputs("sdpa", FlashAttention.apply(
            query, key, value, is_causal, None, segment_ids))
    out, _ = flash_attention_fwd(query, key, value, causal=is_causal,
                                 segment_ids=segment_ids)
    return check_outputs("sdpa", out)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, segment_ids=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors (paddle_tpu
    F.scaled_dot_product_attention :1292): GQA when key/value carry fewer
    heads, and ``segment_ids`` ``[batch, seq]`` makes it block-diagonal per
    packed document (composed with the causal mask). CUDA tensors run the
    hand-written flash kernels and CPU tensors their plain versions; with
    grad enabled and any input requiring it, the call goes through the
    differentiable ``FlashAttention`` (forward kernel, then the dq/dkv
    backward kernels), otherwise straight to the forward kernel.

    On Paddle ``Tensor``s, an ``attn_mask`` (bool, or float added to the
    scores) or a ``dropout_p`` takes the composite path, where the JAX
    package computes them too (its routing condition, :1313): the masks
    compose with ``is_causal`` and ``segment_ids``, and training dropout
    applies to the attention's output. The torch-level seam of the port's
    models, which use neither, refuses both."""
    if any(isinstance(a, Tensor)
           for a in (query, key, value, attn_mask, segment_ids)):
        return apply_op(_sdpa, query, key, value, attn_mask, dropout_p,
                        is_causal, training, segment_ids, seam=False)
    if attn_mask is not None:
        raise NotImplementedError("the torch-level seam takes no attn_mask: "
                                  "pass paddle_tpu_torch Tensors")
    if dropout_p > 0.0 and training:
        raise NotImplementedError("the torch-level seam takes no attention "
                                  "dropout: pass paddle_tpu_torch Tensors")
    return _sdpa(query, key, value, None, 0.0, is_causal, training,
                 segment_ids)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

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


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


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


def _general_cross_entropy(logits, label, weight, ignore_index, reduction,
                           soft_label, axis, use_softmax, label_smoothing):
    """paddle_tpu F.cross_entropy's unfused formula (:907-942): soft
    labels, class weights, any class axis, probabilities in."""
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, 1e-15, 1.0))
    nclass = logits.shape[axis]
    if soft_label:
        soft = label
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        return _reduce(-torch.sum(soft * logp, dim=axis), reduction)
    li = label.squeeze(axis) if label.ndim == logp.ndim else label
    safe = li.long().clamp(0, nclass - 1)
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        nll = (-(1 - label_smoothing) * picked
               - label_smoothing * logp.mean(dim=axis))
    else:
        nll = -picked
    valid = li != ignore_index
    nll = torch.where(valid, nll, 0.0)
    if weight is not None:
        cw = weight[safe]
        nll = nll * cw
        if reduction == "mean":
            return nll.sum() / torch.where(valid, cw, 0.0).sum().clamp_min(
                1e-12)
    if reduction == "mean":
        return nll.sum() / valid.sum().to(nll.dtype).clamp_min(1.0)
    return _reduce(nll, reduction)


@_paddle_entry()
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, use_fused=None):
    """Softmax cross-entropy over the class axis of the logits ``input``
    (paddle_tpu F.cross_entropy :866). Hard labels over the last axis, the
    models' case: fp32 statistics, mean over the non-ignored tokens, the
    result in the logits' dtype (the unfused path: it takes logits that
    already exist; the fused head loss is ``fused_linear_cross_entropy``).
    Class weights, soft labels, another axis or probabilities in take the
    JAX package's general formula."""
    input, label = apply_seam("cross_entropy", (input, label))
    if (weight is not None or soft_label or not use_softmax
            or axis not in (-1, input.ndim - 1)):
        return check_outputs("cross_entropy", _general_cross_entropy(
            input, label, weight, ignore_index, reduction, soft_label, axis,
            use_softmax, label_smoothing))
    _check_labels(label)
    if label.ndim == input.ndim:
        label = label.squeeze(-1)
    nll, valid = _token_nll(input, label, ignore_index, label_smoothing)
    return check_outputs("cross_entropy", _reduce_valid(
        nll, valid, reduction, label.shape).to(input.dtype))


@_paddle_entry()
def parallel_cross_entropy(input, label, ignore_index=-100,
                           label_smoothing=0.0):
    """Per-token fp32 softmax CE shaped like `label`, ignored tokens 0
    (paddle_tpu F.parallel_cross_entropy :945 on one device: the vocab is
    not sharded in this slice)."""
    _check_labels(label)
    return _token_nll(input, label, ignore_index, label_smoothing)[0]


def _fused_linear_ce(x, weight, label, ignore_index, reduction,
                     label_smoothing, z_loss, chunk_tokens, mp_group=None):
    _check_labels(label)
    x, weight, label = apply_seam("fused_linear_cross_entropy",
                                  (x, weight, label))
    if label.ndim == x.ndim:
        label = label.squeeze(-1)
    flat = x.reshape(-1, x.shape[-1])
    labf = label.reshape(-1)
    if mp_group is not None and mp_group.nranks > 1:
        if _fp8.head_fp8_enabled():
            raise NotImplementedError("the fp8 head loss under tensor "
                                      "parallelism (mp > 1) is not ported "
                                      "yet (ROADMAP A8)")
        nll = FusedLinearCrossEntropy.apply(
            flat, weight, labf, ignore_index, label_smoothing, z_loss,
            chunk_tokens, mp_group)
    else:
        fn = (Fp8LinearCrossEntropy if _fp8.head_fp8_enabled()
              else FusedLinearCrossEntropy)
        nll = fn.apply(flat, weight, labf, ignore_index, label_smoothing,
                       z_loss, chunk_tokens)
    return check_outputs("fused_linear_cross_entropy", _reduce_valid(
        nll, labf != ignore_index, reduction, label.shape))


def fused_linear_cross_entropy(x, weight, label, bias=None, ignore_index=-100,
                               reduction="mean", label_smoothing=0.0,
                               z_loss=0.0, chunk_tokens=0, mp_group=None):
    """loss = CE(x·weightᵀ, label) without the [tokens, vocab] logits, in
    the forward or the backward (paddle_tpu F.fused_linear_cross_entropy
    :1009). x: [..., hidden]; label: integer [...]; weight: ``[vocab,
    hidden]`` on torch tensors (the LM head's PyTorch layout), ``[hidden,
    vocab]`` on Paddle ``Tensor``s (the JAX package's). The statistics run
    the hand-written ``ce_stats`` kernel on CUDA tensors (its plain version
    on CPU ones), the backward the ``ce_bwd`` kernels; ``reduction="mean"``
    averages over the non-ignored tokens. ``chunk_tokens`` (0 = resolved
    through the tuning resolver: the ``fused_ce_chunk_tokens`` flag, the
    tuning cache, then ``resolve_chunks``) sets the backward's token chunk.
    With an ``mp_group`` of more than one rank, ``weight`` is this rank's
    vocab shard and the loss is the vocab-parallel one (the JAX package's
    mp-sharded variant, ``FusedLinearCrossEntropy``'s docstring): every
    member gets the full per-token loss. The JAX package's vocab-chunked
    variant and ``bias`` are not ported. Under an fp8 session
    with policy ``matmuls+head`` the loss takes ``Fp8LinearCrossEntropy``
    instead (the token-chunked products through fp8, as the JAX package
    leaves its Pallas kernel for the ``tokens`` variant under fp8)."""
    if bias is not None:
        raise NotImplementedError("a bias on the fused head loss is not "
                                  "ported yet")
    args = (ignore_index, reduction, label_smoothing, z_loss, chunk_tokens,
            mp_group)
    if any(isinstance(a, Tensor) for a in (x, weight, label)):
        return apply_op(lambda v, w, lab: _fused_linear_ce(v, w.t(), lab,
                                                           *args),
                        x, weight, label, seam=False)
    return _fused_linear_ce(x, weight, label, *args)


def _loss(name):
    """A loss of the Paddle layers under its JAX op name."""
    def deco(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            return check_outputs(name, fn(*args, **kwargs))

        return _paddle_entry()(op)

    return deco


@_loss("mse_loss")
def mse_loss(input, label, reduction="mean"):
    input, label = apply_seam("mse_loss", (input, label))
    return _reduce(torch.square(input - label), reduction)


@_loss("l1_loss")
def l1_loss(input, label, reduction="mean"):
    input, label = apply_seam("l1_loss", (input, label))
    return _reduce(torch.abs(input - label), reduction)


@_loss("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    input, label, weight = apply_seam("nll_loss", (input, label, weight))
    nclass = input.shape[-1]
    safe = label.long().clamp(0, nclass - 1)
    nll = -input.gather(-1, safe[..., None])[..., 0]
    valid = label != ignore_index
    nll = torch.where(valid, nll, 0.0)
    if weight is not None:
        nll = nll * weight[safe]
    if reduction == "mean":
        denom = (valid.to(nll.dtype).sum() if weight is None
                 else torch.where(valid, weight[safe], 0.0).sum())
        return nll.sum() / denom.clamp_min(1e-12)
    return _reduce(nll, reduction)


@_loss("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    p, y, w = apply_seam("binary_cross_entropy", (input, label, weight))
    val = -(y * torch.log(torch.clamp(p, 1e-12, 1.0))
            + (1 - y) * torch.log(torch.clamp(1 - p, 1e-12, 1.0)))
    return _reduce(val if w is None else val * w, reduction)


@_loss("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    z, y, w, pw = apply_seam("bce_with_logits",
                             (logit, label, weight, pos_weight))
    log_sig, log_one_minus = _tF.logsigmoid(z), _tF.logsigmoid(-z)
    val = -((y * log_sig if pw is None else pw * y * log_sig)
            + (1 - y) * log_one_minus)
    return _reduce(val if w is None else val * w, reduction)


@_loss("kl_div")
def kl_div(input, label, reduction="mean", log_target=False):
    logp, q = apply_seam("kl_div", (input, label))
    if log_target:
        val = torch.exp(q) * (q - logp)
    else:
        val = q * (torch.log(torch.clamp(q, min=1e-12)) - logp)
    if reduction == "batchmean":
        return val.sum() / logp.shape[0]
    return _reduce(val, reduction)


@_loss("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    a, b = apply_seam("smooth_l1_loss", (input, label))
    d = torch.abs(a - b)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)
