"""Gradient clipping (``paddle_tpu.nn.clip`` counterpart), with the
semantics the JAX package's compiled update applies
(``apply_optimizer_update``, ``parallel/train_step.py:196-216``): norms in
fp32, the factor cast to the gradient's dtype, and no host sync (the
factor stays a device scalar).

Each clip is called with ``[(param, grad), ...]`` and returns the list with
the clipped gradients; a ``None`` gradient passes through.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "global_norm"]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def _factor(norm, clip_norm):
    return torch.where(norm > clip_norm, clip_norm / norm.clamp_min(1e-12),
                       torch.ones_like(norm))


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        return [(p, g if g is None
                 else g * _factor(global_norm([g]), self.clip_norm).to(g.dtype))
                for p, g in params_grads]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        f = _factor(global_norm(grads), self.clip_norm)
        return [(p, g if g is None else g * f.to(g.dtype))
                for p, g in params_grads]
