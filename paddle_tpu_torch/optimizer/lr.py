"""LR schedulers of the port (``paddle_tpu.optimizer.lr`` counterpart).

Plain Python, as in the JAX package: every scheduler's value is the JAX
package's, step for step, and ``state_dict``/``set_state_dict`` carry the
same keys. An optimizer built with one reads ``scheduler()`` each step
through ``get_lr()``; the caller steps the scheduler.
"""
from __future__ import annotations

import math

__all__ = [
    "LRScheduler", "NoamDecay", "ExponentialDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "PiecewiseDecay",
    "CosineAnnealingDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
    "ReduceOnPlateau", "OneCycleLR", "CyclicLR",
]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.verbose = verbose
        self.step()

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def __call__(self) -> float:
        return self.last_lr

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    def get_last_lr(self):
        return self.last_lr


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(step ** -0.5, step * self.warmup_steps ** -1.5)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** max(self.last_epoch, 0)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * max(self.last_epoch, 0))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * max(self.last_epoch, 0))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0, cycle=False,
                 last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if self.cycle:
            div = math.ceil(step / self.decay_steps) or 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * ((1 - step / decay_steps) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.target = learning_rate if not self.lr_sched else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if step < self.warmup_steps:
            return (self.end_lr - self.start_lr) * step / self.warmup_steps + self.start_lr
        if self.lr_sched:
            self.lr_sched.step()
            return self.lr_sched()
        return self.target


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        for i, b in enumerate(self.boundaries):
            if step < b:
                return self.values[i]
        return self.values[-1]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * step / self.T_max)) / 2


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        return self.base_lr * self.gamma ** sum(step >= m for m in self.milestones)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (max(self.last_epoch, 0) // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(max(self.last_epoch, 0))


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0, epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr = float(learning_rate)
        self.base_lr = float(learning_rate)
        self.last_lr = self._lr
        self.last_epoch = 0

    def get_lr(self):
        return self._lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        m = float(metrics.item() if hasattr(metrics, "item") else metrics)
        better = (
            self.best is None
            or (self.mode == "min" and m < self.best - self.threshold)
            or (self.mode == "max" and m > self.best + self.threshold)
        )
        if better:
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            self._lr = max(self._lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_lr = self._lr


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        up = int(self.total_steps * self.phase_pct)
        if step <= up and up > 0:
            pct = step / up
            return self.initial_lr + (self.max_lr - self.initial_lr) * (1 - math.cos(math.pi * pct)) / 2
        down = self.total_steps - up
        pct = min((step - up) / max(down, 1), 1.0)
        return self.end_lr + (self.max_lr - self.end_lr) * (1 + math.cos(math.pi * pct)) / 2


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up, step_size_down=None,
                 mode="triangular", exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        cycle_len = self.up + self.down
        cycle = step // cycle_len
        pos = step % cycle_len
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** step)
        return self.base_lr + amp * pct


class MultiplicativeDecay(LRScheduler):
    """reference lr.py MultiplicativeDecay (:1821): lr multiplies by
    lr_lambda(epoch) cumulatively each epoch."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        lr = self.base_lr
        for e in range(1, max(self.last_epoch, 0) + 1):
            lr *= self.lr_lambda(e)
        return lr


class LinearLR(LRScheduler):
    """reference lr.py LinearLR (:2355): linearly anneal the multiplier from
    start_factor to end_factor over total_steps."""

    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        if total_steps <= 0:
            raise ValueError("total_steps must be positive")
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        e = max(self.last_epoch, 0)
        if e >= self.total_steps:
            return self.base_lr * self.end_factor
        frac = e / self.total_steps
        factor = self.start_factor + (self.end_factor - self.start_factor) * frac
        return self.base_lr * factor


class CosineAnnealingWarmRestarts(LRScheduler):
    """reference lr.py CosineAnnealingWarmRestarts (:2474): SGDR cosine
    cycles restarting every T_i epochs with T_{i+1} = T_i * T_mult."""

    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0,
                 last_epoch=-1, verbose=False):
        if T_0 <= 0 or T_mult < 1:
            raise ValueError("T_0 must be positive and T_mult >= 1")
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        import math as _m

        e = max(self.last_epoch, 0)
        t_i, t_cur = self.T_0, e
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + _m.cos(_m.pi * t_cur / t_i)) / 2)


__all__ += ["MultiplicativeDecay", "LinearLR", "CosineAnnealingWarmRestarts"]
