"""Head-stage loss fusion (``paddle_tpu.parallel.fused_head`` counterpart).

When a head ends in a plain vocab projection and the loss is a
recognizable hard-label softmax CE, ``loss_fn(head(x), labels)`` runs as
the fused linear-CE (``nn.functional.fused_linear_cross_entropy``): the
``[tokens, vocab]`` logits never exist, and when the projection is a
``ColumnParallelLinear`` that keeps its vocab shard local (tensor
parallelism, ``gather_output=False``) the loss is the vocab-parallel one,
the softmax statistics reduced over its mp group. The
``use_fused_head_loss`` flag turns it off.

The protocol is the JAX package's: the head implements
``forward_features(x)`` (everything before the projection) and exposes
the projection as ``head.lm_head`` (``torch.nn.Linear`` or a
``ColumnParallelLinear``); the loss is a ``CrossEntropyLoss`` in its
fusable configuration, a ``LlamaPretrainingCriterion``, or a callable
with a ``_fused_ce_spec`` dict (``ignore_index``, ``label_smoothing``,
``reduction`` in {"mean", "sum", "mean_all"}: "mean" over the non-ignored
tokens, "mean_all" over every token). The JAX package binds traced
parameter values into the head for its compiled pipelines; the port's
eager head holds its parameters itself.
"""
from __future__ import annotations

from paddle_tpu_torch.core.flags import flag

__all__ = ["fused_ce_spec", "fused_head_spec", "fused_head_loss",
           "reduce_fused_nll"]


def fused_ce_spec(loss_fn) -> dict | None:
    """The fused-CE configuration of `loss_fn(logits, labels)`, or None
    when it is not a recognizable hard-label softmax CE."""
    spec = getattr(loss_fn, "_fused_ce_spec", None)
    if spec is not None:
        return dict(spec)
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.nn.layer.loss import CrossEntropyLoss

    if isinstance(loss_fn, CrossEntropyLoss):
        if (loss_fn.weight is None and not loss_fn.soft_label
                and loss_fn.use_softmax and loss_fn.axis == -1
                and loss_fn.use_fused is not False
                and loss_fn.reduction in ("mean", "sum")):
            return dict(ignore_index=loss_fn.ignore_index,
                        label_smoothing=loss_fn.label_smoothing,
                        reduction=loss_fn.reduction)
        return None
    if isinstance(loss_fn, LlamaPretrainingCriterion):
        return dict(ignore_index=loss_fn.ignore_index, label_smoothing=0.0,
                    reduction="mean_all" if loss_fn.parallel else "mean")
    return None


def fused_head_spec(head, loss_fn) -> dict | None:
    """The joint head + loss fusion spec, or None when the pair runs the
    unfused ``loss_fn(head(x), labels)``."""
    if not flag("use_fused_head_loss"):
        return None
    spec = fused_ce_spec(loss_fn)
    proj = getattr(head, "lm_head", None)
    if (spec is None or getattr(head, "forward_features", None) is None
            or proj is None or getattr(proj, "weight", None) is None):
        return None
    if getattr(proj, "gather_output", False) and \
            getattr(proj, "world_size", 1) > 1:
        # gathered full-vocab logits: keep the unfused path
        return None
    return spec


def reduce_fused_nll(nll, labels_flat, spec):
    """Reduce per-token fp32 fused-CE losses by the spec's reduction."""
    red = spec.get("reduction", "mean")
    if red == "mean_all":
        return nll.mean()
    if red == "sum":
        return nll.sum()
    valid = labels_flat != spec.get("ignore_index", -100)
    return nll.sum() / valid.sum().clamp_min(1).to(nll.dtype)


def fused_head_loss(head, x, labels, spec):
    """Scalar fp32 ``loss_fn(head(x), labels)`` through the fused linear-CE,
    vocab-parallel when the head's projection is an mp shard."""
    from paddle_tpu_torch.nn import functional as F

    feat = head.forward_features(x)
    proj = head.lm_head
    group = getattr(proj, "group", None)
    lab = labels.squeeze(-1) if labels.dim() == feat.dim() else labels
    nll = F.fused_linear_cross_entropy(
        feat.reshape(-1, feat.shape[-1]), proj.weight, lab.reshape(-1),
        bias=getattr(proj, "bias", None),
        ignore_index=spec.get("ignore_index", -100),
        reduction="none", label_smoothing=spec.get("label_smoothing", 0.0),
        z_loss=spec.get("z_loss", 0.0),
        mp_group=group if group is not None and group.nranks > 1 else None)
    return reduce_fused_nll(nll, lab.reshape(-1), spec)
