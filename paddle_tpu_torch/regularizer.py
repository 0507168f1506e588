"""Regularizers (``paddle_tpu.regularizer`` counterpart): the coefficient
objects the optimizers read through their ``weight_decay`` argument."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    """Weight decay coefficient holder (optimizers read `_coeff`): adds
    coeff * p to the gradient (AdamW: the decoupled decay)."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay:
    """L1 regularization: optimizers add coeff * sign(p) to the gradient."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._l1 = True

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"L1Decay({self._coeff})"
