"""The port's LR schedulers against the JAX package's: every scheduler's
value over 50 steps equal (exact), and ``state_dict`` round trips: a
scheduler restored from the other package's state mid-run continues with
the same values (ReduceOnPlateau's restarts from its base lr in both
packages: its state leaves out the current lr)."""
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

CASES = {
    "noam": lambda m: m.NoamDecay(d_model=512, warmup_steps=10,
                                  learning_rate=2.0),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=20,
                                              end_lr=1e-3, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=1e-3, power=0.5, cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.1, warmup_steps=8,
                                              start_lr=0.0, end_lr=0.1),
    "warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-4, T_max=40, eta_min=3e-5),
        warmup_steps=5, start_lr=1e-6, end_lr=3e-4),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12, 30],
                                            [0.1, 0.05, 0.01, 0.001]),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=17, eta_min=0.01),
    "multistep": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 33],
                                            gamma=0.3),
    "step": lambda m: m.StepDecay(0.1, step_size=6, gamma=0.7),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 1.0 / (1 + 0.1 * e)),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-3),
    "one_cycle": lambda m: m.OneCycleLR(0.1, total_steps=40),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                   step_size_down=6),
    "cyclic_tri2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                        mode="triangular2"),
    "cyclic_exp": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                       mode="exp_range", exp_gamma=0.97),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.1,
                                                      lambda e: 0.95),
    "linear_lr": lambda m: m.LinearLR(0.1, total_steps=20,
                                      start_factor=0.25, end_factor=1.0),
    "warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-3),
}


def _metric(step):
    # a loss that plateaus, so ReduceOnPlateau both waits and reduces
    return 1.0 + math.cos(step * 0.7) * 0.01 if step > 10 else 2.0 - step


def _advance(s, step):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(_metric(step))
    else:
        s.step()


def _numbers(state):
    return {k: v for k, v in state.items()
            if isinstance(v, (int, float, bool, type(None), list, str))}


def test_every_jax_scheduler_is_ported():
    assert set(jlr.__all__) == set(tlr.__all__)
    names = {type(CASES[c](jlr)).__name__ for c in CASES}
    assert names == set(jlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_values_equal_jax_over_50_steps(case):
    js, ts = CASES[case](jlr), CASES[case](tlr)
    want, got = [js()], [ts()]
    for step in range(50):
        _advance(js, step)
        _advance(ts, step)
        want.append(js())
        got.append(ts())
        assert js.last_epoch == ts.last_epoch
    assert got == want                       # exactly, step by step
    assert len(set(got)) > 1 or case == "reduce_on_plateau"


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trips_across_packages(case):
    js, ts = CASES[case](jlr), CASES[case](tlr)
    for step in range(17):
        _advance(js, step)
        _advance(ts, step)
    assert _numbers(ts.state_dict()) == _numbers(js.state_dict())
    # restore each package's scheduler from the other's state mid-run
    jfresh, tfresh = CASES[case](jlr), CASES[case](tlr)
    tfresh.set_state_dict(_numbers(js.state_dict()))
    jfresh.set_state_dict(_numbers(ts.state_dict()))
    if isinstance(js, jlr.LinearWarmup) and js.lr_sched is not None:
        tfresh.lr_sched.set_state_dict(_numbers(js.lr_sched.state_dict()))
        jfresh.lr_sched.set_state_dict(_numbers(ts.lr_sched.state_dict()))
    # ReduceOnPlateau's state_dict leaves out its current lr (`_lr`) in
    # both packages: a restored one restarts from base_lr, in both alike
    resumes = not isinstance(js, jlr.ReduceOnPlateau)
    for step in range(17, 40):
        for s in (js, ts, jfresh, tfresh):
            _advance(s, step)
        assert ts() == js() and tfresh() == jfresh()
        assert tfresh() == ts() or not resumes
