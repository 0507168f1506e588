"""Optimizers of the port (``paddle_tpu.optimizer`` counterpart): the base
``Optimizer`` and the JAX package's fifteen rules, ``SGD``, ``Momentum``,
``Adam``, ``AdamW``, ``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp``,
``Lamb``, ``Lars``, ``ASGD``, ``NAdam``, ``RAdam``, ``Rprop`` and
``LBFGS``, plus the schedulers of ``lr``.

Each update is the JAX package's ``_update`` rule, in its order of
operations and with its precisions (``paddle_tpu/optimizer/__init__.py:
169-752``): SGD and Momentum compute in the parameter's dtype, the others
in fp32 (scalars such as bias corrections too) and cast the new parameter
back. Adam's moments come first, then the bias correction, then ``new =
p32 - upd`` and, for AdamW, ``- lr * wd * p32`` with the OLD p32;
``torch.optim`` decays first and orders other rules differently, so it is
not used. With ``multi_precision`` Adam and AdamW keep an fp32 master copy
and fp32 moments of a non-fp32 parameter; the parameter is the master
cast down after every step. The port updates parameters and state in
place where the JAX package returns new arrays (to XLA, which donates the
old buffers).

``parameters`` is a list of tensors, of ``(name, tensor)`` pairs
(``model.named_parameters()``) or of param-group dicts with a ``params``
list (flattened, as in the JAX package); a tensor is a torch tensor or a
Paddle-API ``Parameter``, whose ``_value`` is read at every ``step()``
and ``clear_grad()`` (never kept from construction), so a layer moved or
cast after the optimizer was built keeps training.
``apply_decay_param_fun`` is called with the name, ``f"p{i}"`` for an
unnamed one. ``learning_rate`` is a float or an ``lr.LRScheduler``:
``get_lr()`` reads the scheduler, and the caller steps it.
``weight_decay`` is a float or a ``regularizer`` object: ``L2Decay``
adds ``coeff * p`` to the gradient (AdamW: its decoupled decay),
``L1Decay`` adds ``coeff * sign(p)``. AdamW's
``lr_ratio`` and Adam's ``lazy_mode`` are accepted and have no effect, as
in the JAX package (its gradients are dense). State is kept per parameter
index, and ``state_dict`` carries it as numpy arrays under ``param_{i}``
with the step count and, with a scheduler, its state under
``LR_Scheduler``: the JAX package's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "ASGD",
           "NAdam", "RAdam", "Rprop", "LBFGS", "lr"]

_F32 = np.float32


def _lr_as(lr, p) -> float:
    """The fp32 learning rate rounded to p's dtype (``lr.astype(pv.dtype)``),
    as a Python number (exact in that dtype)."""
    return float(torch.tensor(float(lr)).to(p.dtype))


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class Optimizer:
    """Base optimizer: gradient clip, then ``_update`` per parameter."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._entries, self._names = [], []
        for i, p in enumerate(_flatten_groups(parameters)):
            name, p = p if isinstance(p, tuple) else (f"p{i}", p)
            self._names.append(name)
            self._entries.append(p)
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._wd_l1 = bool(getattr(weight_decay, "_l1", False))
        self._weight_decay = float(
            getattr(weight_decay, "_coeff", weight_decay) or 0.0)
        self._grad_clip = grad_clip
        self._state: dict[int, dict] = {}
        self._step_count = 0
        self._use_master_weights = multi_precision

    @property
    def _params(self) -> list:
        """The parameters' torch tensors, resolved at each use: a Paddle
        ``Parameter`` (``nn.Parameter`` of the Paddle API) gives its
        ``_value``, which ``Layer.to``/``astype`` may have rebound since
        construction."""
        return [getattr(p, "_value", p) for p in self._entries]

    def _init_state(self, p) -> dict:
        return {}

    def _decayed(self, g, p):
        """The regularizer on a gradient: L2 adds coeff * p, L1Decay adds
        coeff * sign(p) (``Optimizer._decayed``)."""
        if not self._weight_decay:
            return g
        if self._wd_l1:
            return g + self._weight_decay * torch.sign(p)
        return g + self._weight_decay * p

    def _rule(self, p, g, state, lr, t):
        """The functional update: (new parameter in p's dtype, new state)
        from gradient `g` (in p's dtype), fp32 `lr` and step `t`."""
        raise NotImplementedError

    def _update(self, i, p, g, state, lr, step):
        """Update parameter `i` (tensor `p`) in place from gradient `g`;
        `state` is updated in place."""
        new_p, new_state = self._rule(p.detach(), g, state, _F32(lr),
                                      _F32(step))
        p.copy_(new_p)
        state.update(new_state)

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def _parameter_list(self):
        return self._params

    @torch.no_grad()
    def step(self):
        """Clip the gradients of the parameters that have one, then update
        each at the current learning rate (``Optimizer.step``)."""
        self._step_count += 1
        idx = {id(p): i for i, p in enumerate(self._params)}
        params_grads = [(p, p.grad) for p in self._params
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        cur_lr = self.get_lr()
        for p, g in params_grads:
            i = idx[id(p)]
            if i not in self._state:
                self._state[i] = self._init_state(p)
            self._update(i, p, g.to(p.dtype), self._state[i], cur_lr,
                         self._step_count)

    def clear_grad(self, set_to_zero=False):
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self) -> dict:
        out = {"step": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
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
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
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


def _flatten_groups(parameters):
    params = list(parameters)
    if params and isinstance(params[0], dict):
        return [p for grp in params for p in grp["params"]]
    return params


class SGD(Optimizer):
    def _rule(self, p, g, state, lr, t):
        g = self._decayed(g, p)
        return p - _lr_as(lr, p) * g, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        self._momentum = momentum
        self._nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p.detach())}

    def _rule(self, p, g, state, lr, t):
        g = self._decayed(g, p)
        v = self._momentum * state["velocity"] + g
        upd = g + self._momentum * v if self._nesterov else v
        return p - _lr_as(lr, p) * upd, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False):
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
        t = _F32(step)
        bc1 = float(_F32(1) - _F32(self._b1) ** t)
        bc2 = float(_F32(1) - _F32(self._b2) ** t)
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
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision)
        self._decay = [apply_decay_param_fun is None
                       or bool(apply_decay_param_fun(n))
                       for n in self._names]

    def _new_p32(self, i, p32, g32, state, lr, step):
        new32 = p32 - self._adam_core(g32, state, lr, step)
        if self._decay[i] and self._weight_decay:
            new32 -= float(_F32(lr) * _F32(self._weight_decay)) * p32
        return new32


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"m": _zeros32(p), "u": _zeros32(p)}

    def _rule(self, p, g, state, lr, t):
        p32 = p.float()
        g32 = self._decayed(g.float(), p32)
        m = self._b1 * state["m"] + (1 - self._b1) * g32
        u = torch.maximum(self._b2 * state["u"], g32.abs())
        step_lr = float(lr / (_F32(1) - _F32(self._b1) ** t))
        new = p32 - step_lr * m / (u + self._eps)
        return new.to(p.dtype), {"m": m, "u": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0):
        self._eps = epsilon
        self._init_acc = initial_accumulator_value
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"acc": torch.full(p.shape, self._init_acc,
                                  dtype=torch.float32, device=p.device)}

    def _rule(self, p, g, state, lr, t):
        p32 = p.float()
        g32 = self._decayed(g.float(), p32)
        acc = state["acc"] + g32.square()
        new = p32 - float(lr) * g32 / (acc.sqrt() + self._eps)
        return new.to(p.dtype), {"acc": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None):
        self._eps, self._rho = epsilon, rho
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"avg_sq": _zeros32(p), "avg_upd": _zeros32(p)}

    def _rule(self, p, g, state, lr, t):
        p32 = p.float()
        g32 = self._decayed(g.float(), p32)
        avg_sq = self._rho * state["avg_sq"] + (1 - self._rho) * g32.square()
        upd = ((state["avg_upd"] + self._eps).sqrt()
               / (avg_sq + self._eps).sqrt() * g32)
        avg_upd = self._rho * state["avg_upd"] + (1 - self._rho) * upd.square()
        return ((p32 - float(lr) * upd).to(p.dtype),
                {"avg_sq": avg_sq, "avg_upd": avg_upd})


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None):
        self._rho, self._eps = rho, epsilon
        self._mom, self._centered = momentum, centered
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        st = {"ms": _zeros32(p), "mom": _zeros32(p)}
        if self._centered:
            st["mg"] = _zeros32(p)
        return st

    def _rule(self, p, g, state, lr, t):
        p32 = p.float()
        g32 = self._decayed(g.float(), p32)
        ms = self._rho * state["ms"] + (1 - self._rho) * g32.square()
        out = {"ms": ms}
        if self._centered:
            mg = self._rho * state["mg"] + (1 - self._rho) * g32
            denom = (ms - mg.square() + self._eps).sqrt()
            out["mg"] = mg
        else:
            denom = (ms + self._eps).sqrt()
        mom = self._mom * state["mom"] + float(lr) * g32 / denom
        out["mom"] = mom
        return (p32 - mom).to(p.dtype), out


def _norm(x):
    return x.square().sum().sqrt()


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None):
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        super().__init__(learning_rate, parameters, None, grad_clip)

    def _init_state(self, p):
        return {"m": _zeros32(p), "v": _zeros32(p)}

    def _rule(self, p, g, state, lr, t):
        g32, p32 = g.float(), p.float()
        m = self._b1 * state["m"] + (1 - self._b1) * g32
        v = self._b2 * state["v"] + (1 - self._b2) * g32.square()
        mhat = m / float(_F32(1) - _F32(self._b1) ** t)
        vhat = v / float(_F32(1) - _F32(self._b2) ** t)
        r = mhat / (vhat.sqrt() + self._eps) + self._lamb_wd * p32
        w_norm, r_norm = _norm(p32), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return (p32 - float(lr) * trust * r).to(p.dtype), {"m": m, "v": v}


class Lars(Momentum):
    """LARS momentum: layer-wise trust-ratio scaled learning rate."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, epsilon=1e-8,
                 grad_clip=None, multi_precision=False):
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, multi_precision)

    def _rule(self, p, g, state, lr, t):
        p32, g32 = p.float(), g.float()
        p_norm, g_norm = _norm(p32), _norm(g32)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._lars_coeff * p_norm
            / (g_norm + self._lars_wd * p_norm + self._eps), 1.0)
        upd = g32 + self._lars_wd * p32
        v = (self._momentum * state["velocity"].float()
             + float(lr) * local_lr * upd)
        return (p32 - v).to(p.dtype), {"velocity": v}


class ASGD(Optimizer):
    """Averaged SGD: SGD on the mean of the last ``batch_num`` gradients,
    plus the running average of the iterates (``averaged_value``)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, t0=0,
                 multi_precision=False):
        self._t0 = t0
        self._batch_num = max(1, int(batch_num))
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        return {"ax": p.detach().float().clone(), "d": _zeros32(p),
                "ys": torch.zeros((self._batch_num,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device)}

    def _rule(self, p, g, state, lr, t):
        p32 = p.float()
        g32 = self._decayed(g.float(), p32)
        n = self._batch_num
        pos = (int(t) - 1) % n
        d = state["d"] - state["ys"][pos] + g32
        ys = state["ys"].clone()
        ys[pos] = g32
        new_p = p32 - float(lr) * d / float(min(t, _F32(n)))
        mu = float(_F32(1) / max(_F32(1), t - _F32(self._t0)))
        ax = state["ax"] + mu * (new_p - state["ax"])
        return new_p.to(p.dtype), {"ax": ax, "d": d, "ys": ys}

    def averaged_value(self, p):
        """The Polyak-averaged iterate of `p` (a copy)."""
        for i, q in enumerate(self._params):
            if q is p and i in self._state:
                return self._state[i]["ax"].clone()
        return p


class NAdam(Optimizer):
    """Nesterov-momentum Adam."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        return {"m": _zeros32(p), "v": _zeros32(p),
                "mu_prod": torch.ones((), dtype=torch.float32,
                                      device=p.device)}

    def _rule(self, p, g, state, lr, t):
        p32 = p.float()
        g32 = self._decayed(g.float(), p32)
        b1, psi, one = _F32(self._b1), _F32(self._psi), _F32(1)
        mu_t = b1 * (one - _F32(0.5) * _F32(0.96) ** (t * psi))
        mu_t1 = b1 * (one - _F32(0.5) * _F32(0.96) ** ((t + one) * psi))
        mu_prod = state["mu_prod"] * float(mu_t)
        m = self._b1 * state["m"] + (1 - self._b1) * g32
        v = self._b2 * state["v"] + (1 - self._b2) * g32.square()
        mhat = (float(mu_t1) * m / (1 - mu_prod * float(mu_t1))
                + float(one - mu_t) * g32 / (1 - mu_prod))
        vhat = v / float(one - _F32(self._b2) ** t)
        new_p = p32 - float(lr) * mhat / (vhat.sqrt() + self._eps)
        return new_p.to(p.dtype), {"m": m, "v": v, "mu_prod": mu_prod}


class RAdam(Optimizer):
    """Rectified Adam: the variance rectification switches between the
    adaptive and the plain momentum update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        return {"m": _zeros32(p), "v": _zeros32(p)}

    def _rule(self, p, g, state, lr, t):
        p32 = p.float()
        g32 = self._decayed(g.float(), p32)
        one = _F32(1)
        m = self._b1 * state["m"] + (1 - self._b1) * g32
        v = self._b2 * state["v"] + (1 - self._b2) * g32.square()
        mhat = m / float(one - _F32(self._b1) ** t)
        rho_inf = _F32(2.0 / (1 - self._b2) - 1.0)
        b2t = _F32(self._b2) ** t
        rho_t = rho_inf - _F32(2) * t * b2t / (one - b2t)
        r_num = (rho_t - _F32(4)) * (rho_t - _F32(2)) * rho_inf
        r_den = ((rho_inf - _F32(4)) * (rho_inf - _F32(2))
                 * max(rho_t, _F32(self._eps)))
        r_t = np.sqrt(max(r_num / r_den, _F32(0)))
        if rho_t > 5.0:
            vhat = (v / float(one - b2t)).sqrt() + self._eps
            new_p = p32 - float(lr) * (float(r_t) * mhat / vhat)
        else:
            new_p = p32 - float(lr) * mhat
        return new_p.to(p.dtype), {"m": m, "v": v}


class Rprop(Optimizer):
    """Resilient backprop (iRprop-): per-weight step sizes grown on sign
    agreement, shrunk on disagreement."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False):
        self._eta_minus, self._eta_plus = etas
        self._lr_min, self._lr_max = learning_rate_range
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        return {"prev_grad": _zeros32(p),
                "step_size": torch.full(p.shape, float(self.get_lr()),
                                        dtype=torch.float32,
                                        device=p.device)}

    def _rule(self, p, g, state, lr, t):
        g32, p32 = g.float(), p.float()
        sign = torch.sign(g32 * state["prev_grad"])
        factor = torch.where(sign > 0, self._eta_plus,
                             torch.where(sign < 0, self._eta_minus, 1.0))
        step_size = (state["step_size"] * factor).clamp(self._lr_min,
                                                         self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g32)
        new_p = p32 - step_size * torch.sign(g_eff)
        return new_p.to(p.dtype), {"prev_grad": g_eff,
                                   "step_size": step_size}


class LBFGS(Optimizer):
    """L-BFGS over the flat fp32 vector of every parameter: ``step(closure)``
    re-evaluates loss and gradients up to ``max_iter`` times, keeping a
    ``history_size`` window of (s, y) pairs for the two-loop recursion;
    ``line_search_fn="strong_wolfe"`` runs the JAX package's Armijo
    backtracking."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._max_iter = max_iter
        self._max_eval = (max_eval if max_eval is not None
                          else int(max_iter * 1.25))
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._hist_size = history_size
        self._line_search = line_search_fn
        self._s_hist: list = []
        self._y_hist: list = []
        self._rho_hist: list = []
        self._prev_flat = None
        self._prev_grad = None
        self._n_eval = 0

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._params])

    def _flat_grads(self):
        params_grads = [(p, p.grad) for p in self._params]
        if self._grad_clip is not None:
            clipped = {id(p): g for p, g in self._grad_clip(
                [(p, g) for p, g in params_grads if g is not None])}
            params_grads = [(p, clipped.get(id(p), g))
                            for p, g in params_grads]
        return torch.cat([(g if g is not None else torch.zeros_like(p))
                          .detach().reshape(-1).float()
                          for p, g in params_grads])

    @torch.no_grad()
    def _assign_flat(self, flat):
        ofs = 0
        for p in self._params:
            n = p.numel()
            p.copy_(flat[ofs:ofs + n].reshape(p.shape).to(p.dtype))
            ofs += n

    def _direction(self, g):
        """Two-loop recursion: H·g from the implicit inverse-Hessian
        history."""
        q = g
        alphas = []
        for s, y, rho in zip(reversed(self._s_hist), reversed(self._y_hist),
                             reversed(self._rho_hist)):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self._y_hist:
            y_last, s_last = self._y_hist[-1], self._s_hist[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp_min(
                torch.dot(y_last, y_last), 1e-10)
            q = gamma * q
        for (s, y, rho), a in zip(zip(self._s_hist, self._y_hist,
                                      self._rho_hist), reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q

    def step(self, closure=None):
        self._step_count += 1
        if closure is None:
            return self._one_iteration(None)
        loss = None
        self._n_eval = 0
        for _ in range(self._max_iter):
            loss = self._one_iteration(closure)
            if loss is None or self._n_eval >= self._max_eval:
                break
            if float(self._flat_grads().abs().max()) <= self._tol_grad:
                break
        return loss

    def _eval_closure(self, closure):
        self._n_eval += 1
        self.clear_grad()
        with torch.enable_grad():
            loss = closure()
            if hasattr(loss, "backward") and all(
                    p.grad is None for p in self._params):
                loss.backward()
        return loss

    def _one_iteration(self, closure):
        loss = self._eval_closure(closure) if closure is not None else None
        x = self._flat_params()
        g = self._decayed(self._flat_grads(), x)
        if self._prev_flat is not None:
            s = x - self._prev_flat
            y = g - self._prev_grad
            sy = float(torch.dot(s, y))
            if sy > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                self._rho_hist.append(1.0 / sy)
                if len(self._s_hist) > self._hist_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
                    self._rho_hist.pop(0)
        d = self._direction(g)
        lr = self.get_lr()
        if not self._s_hist:        # first step: conservative scaled descent
            lr = min(1.0, 1.0 / max(float(g.abs().sum()), 1e-10)) * lr
        if self._line_search == "strong_wolfe" and closure is not None:
            lr = self._backtrack(closure, x, g, d, lr)
        self._prev_flat = x
        self._prev_grad = g
        self._assign_flat(x + lr * d)
        if float((lr * d).abs().max()) <= self._tol_change:
            return None
        return loss

    def state_dict(self):
        out = super().state_dict()
        out["lbfgs"] = {
            "s": [s.cpu().numpy() for s in self._s_hist],
            "y": [y.cpu().numpy() for y in self._y_hist],
            "rho": list(self._rho_hist),
            "prev_flat": (None if self._prev_flat is None
                          else self._prev_flat.cpu().numpy()),
            "prev_grad": (None if self._prev_grad is None
                          else self._prev_grad.cpu().numpy()),
        }
        return out

    def set_state_dict(self, state):
        super().set_state_dict(state)
        lb = state.get("lbfgs")
        if lb:
            dev = self._params[0].device

            def t(a):
                return torch.from_numpy(np.array(a, np.float32)).to(dev)

            self._s_hist = [t(s) for s in lb["s"]]
            self._y_hist = [t(y) for y in lb["y"]]
            self._rho_hist = list(lb["rho"])
            self._prev_flat = (None if lb["prev_flat"] is None
                               else t(lb["prev_flat"]))
            self._prev_grad = (None if lb["prev_grad"] is None
                               else t(lb["prev_grad"]))

    def _backtrack(self, closure, x, g, d, lr, c1=1e-4, shrink=0.5,
                   tries=10):
        """Armijo backtracking (the JAX package's stand-in for strong
        Wolfe); with weight decay the penalty is added to the observed
        losses, and the parameters are restored afterwards."""
        def f_at(flat):
            self._assign_flat(flat)
            val = float(self._eval_closure(closure))
            if self._weight_decay:
                if self._wd_l1:
                    val += self._weight_decay * float(flat.abs().sum())
                else:
                    val += 0.5 * self._weight_decay * float(
                        torch.dot(flat, flat))
            return val

        gtd = float(torch.dot(g, d))
        f0 = f_at(x)
        for _ in range(tries):
            if self._n_eval >= self._max_eval:
                break
            f1 = f_at(x + lr * d)
            if f1 <= f0 + c1 * lr * gtd:
                break
            lr *= shrink
        self._assign_flat(x)
        return lr
