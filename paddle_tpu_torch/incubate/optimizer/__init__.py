"""Optimizer wrappers (``paddle_tpu.incubate.optimizer`` counterpart):
``LookAhead`` and ``ModelAverage``.

Both keep auxiliary per-parameter copies on the parameters' device: the
slow weights of LookAhead, the fp32 running sum of ModelAverage, updated
in place once an interval (LookAhead) or once a step (ModelAverage).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """k steps of the inner optimizer forward, then one step back:
    ``slow += alpha * (fast - slow)`` and the parameters take the slow
    value."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._params = inner_optimizer._parameter_list()
        self._slow = [p.detach().clone() for p in self._params]
        self._step_count = 0

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for i, p in enumerate(self._params):
                slow = self._slow[i] + self.alpha * (p - self._slow[i])
                self._slow[i] = slow
                p.copy_(slow.to(p.dtype))

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        out = self.inner_optimizer.state_dict()
        out["lookahead_step"] = self._step_count
        out["slow_params"] = [s.detach().float().cpu().numpy()
                              for s in self._slow]
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        state = dict(state)
        self._step_count = int(state.pop("lookahead_step", 0))
        slow = state.pop("slow_params", None)
        if slow is not None:
            self._slow = [torch.from_numpy(np.array(s, np.float32))
                          .to(device=p.device, dtype=p.dtype)
                          for s, p in zip(slow, self._params)]
        self.inner_optimizer.set_state_dict(state)


class ModelAverage:
    """A running average of the parameters for evaluation: ``step()``
    accumulates, ``apply()`` swaps the averaged weights in, ``restore()``
    swaps the training weights back. The window restarts (the sum scaled
    down) once it exceeds ``max(min_window, rate * updates)``, capped at
    ``max_average_window``."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self.rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._params = list(parameters)
        self._sum = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in self._params]
        self._num = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._num += 1
        window = max(self.min_window, int(self.rate * self._num))
        window = min(window, self.max_window)
        for i, p in enumerate(self._params):
            self._sum[i] = self._sum[i] + p.float()
        if self._num > window:
            for i in range(len(self._sum)):
                self._sum[i] = self._sum[i] * (window / self._num)
            self._num = window

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._num == 0:
            return
        self._backup = [p.detach().clone() for p in self._params]
        for p, s in zip(self._params, self._sum):
            p.copy_((s / self._num).to(p.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p, b in zip(self._params, self._backup):
            p.copy_(b)
        self._backup = None
