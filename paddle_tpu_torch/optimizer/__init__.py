"""Optimizers of the training slice (``paddle_tpu.optimizer`` counterpart):
``Optimizer``, ``Adam`` and ``AdamW``.

The update is the JAX package's ``_update`` rule, in its order of
operations (``paddle_tpu/optimizer/__init__.py:210-282``): the moments,
then the bias correction (computed in fp32, as there), then
``new = p32 - upd`` and, for AdamW, ``- lr * wd * p32`` with the OLD p32.
``torch.optim.AdamW`` decays first and is not used. With
``multi_precision`` a non-fp32 parameter keeps an fp32 master copy and fp32
moments; the parameter is the master cast down after every step. The port
updates parameters and state in place where the JAX package returns new
arrays (to XLA, which donates the old buffers).

``parameters`` is a list of tensors or of ``(name, tensor)`` pairs
(``model.named_parameters()``); ``apply_decay_param_fun`` is called with
the name, ``f"p{i}"`` for an unnamed one (the JAX package's name for a
parameter without one). State is kept per parameter index, and
``state_dict`` carries it as numpy arrays under ``param_{i}`` with the step
count, the JAX package's layout. Learning-rate schedulers (``lr.py``),
``lazy_mode`` and ``lr_ratio`` are not ported yet: ``learning_rate`` is a
float.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    """Base optimizer: gradient clip, then ``_update`` per parameter."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._params, self._names = [], []
        for i, p in enumerate(parameters):
            name, p = p if isinstance(p, tuple) else (f"p{i}", p)
            self._names.append(name)
            self._params.append(p)
        self._lr = float(learning_rate)
        self._weight_decay = float(
            getattr(weight_decay, "_coeff", weight_decay) or 0.0)
        self._grad_clip = grad_clip
        self._state: dict[int, dict] = {}
        self._step_count = 0
        self._use_master_weights = multi_precision

    def _init_state(self, p) -> dict:
        return {}

    def _update(self, i, p, g, state, lr, step):
        """Update parameter `i` (tensor `p`) in place from gradient `g`;
        `state` is updated in place."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """Clip the gradients of the parameters that have one, then update
        each (``AdamW.step`` at ``optimizer/__init__.py:249``)."""
        self._step_count += 1
        idx = {id(p): i for i, p in enumerate(self._params)}
        params_grads = [(p, p.grad) for p in self._params
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        for p, g in params_grads:
            i = idx[id(p)]
            if i not in self._state:
                self._state[i] = self._init_state(p)
            self._update(i, p, g.to(p.dtype), self._state[i], self._lr,
                         self._step_count)

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    def state_dict(self) -> dict:
        out = {"step": self._step_count}
        for i, st in sorted(self._state.items()):
            if st:
                out[f"param_{i}"] = {k: v.detach().float().cpu().numpy()
                                     for k, v in st.items()}
        return out

    @torch.no_grad()
    def set_state_dict(self, state: dict) -> None:
        """Load `state` (``state_dict`` layout); each entry is copied into
        a fresh state of the parameter's own dtypes and device."""
        self._step_count = int(state.get("step", 0))
        for i, p in enumerate(self._params):
            saved = state.get(f"param_{i}")
            if saved is None:
                continue
            st = self._init_state(p)
            if set(saved) != set(st):
                raise KeyError(f"param_{i} ({self._names[i]}): state keys "
                               f"{sorted(saved)} do not match "
                               f"{sorted(st)}")
            for k, v in saved.items():
                st[k].copy_(torch.from_numpy(np.array(v, np.float32)))
            self._state[i] = st


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._use_master_weights else p.dtype
        st = {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
              "v": torch.zeros(p.shape, dtype=dt, device=p.device)}
        if self._use_master_weights and p.dtype != torch.float32:
            st["master"] = p.detach().float().clone()
        return st

    def _adam_core(self, g32, state, lr, step):
        """upd = lr * mhat / (sqrt(vhat) + eps), the moments updated in
        place; the bias corrections in fp32 as the JAX package computes
        them."""
        m, v = state["m"], state["v"]
        m.mul_(self._b1).add_(g32 * (1 - self._b1))
        v.mul_(self._b2).add_(g32.square().mul_(1 - self._b2))
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(self._b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self._b2) ** t)
        denom = (v / bc2).sqrt_().add_(self._eps)
        return (m / bc1).mul_(lr).div_(denom)

    def _new_p32(self, i, p32, g32, state, lr, step):
        if self._weight_decay:        # Adam: L2 into the gradient
            g32 = g32 + self._weight_decay * p32
        return p32 - self._adam_core(g32, state, lr, step)

    def _update(self, i, p, g, state, lr, step):
        master = state.get("master")
        p32 = master if master is not None else p.float()
        new32 = self._new_p32(i, p32, g.float(), state, lr, step)
        if master is not None:
            master.copy_(new32)
        p.copy_(new32)


class AdamW(Adam):
    """Decoupled weight decay (paddle_tpu ``AdamW``): the decay term uses
    the parameter from before the Adam update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self._decay = [apply_decay_param_fun is None
                       or bool(apply_decay_param_fun(n))
                       for n in self._names]

    def _new_p32(self, i, p32, g32, state, lr, step):
        new32 = p32 - self._adam_core(g32, state, lr, step)
        if self._decay[i] and self._weight_decay:
            new32 -= float(np.float32(lr) * np.float32(self._weight_decay)) \
                * p32
        return new32
