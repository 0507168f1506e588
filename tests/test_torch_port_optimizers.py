"""The port's fifteen optimizers, ``LookAhead`` and ``ModelAverage``
against the JAX package's eager optimizers, on the CPU.

Each case runs the same steps on the same fp32 parameters and gradients
(numpy, from a seed) through ``jax_opt.step()`` and the port's
``step()``, with the regularizers (``L1Decay``, ``L2Decay``, a float),
AdamW's ``lr_ratio`` (no effect in either package), LR schedulers stepped
by the caller, a global-norm clip and LBFGS's history: parameters and
every state entry within 1e-6 relative (fp32), the lr each step equal,
and the port's ``state_dict`` round trip exact. The converter carries each
optimizer's state from a JAX tiny LLaMA into the port's (linear layouts
transposed): states equal, then one more step on both equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.incubate.optimizer import LookAhead as JLookAhead
from paddle_tpu.incubate.optimizer import ModelAverage as JModelAverage
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.regularizer import L1Decay as JL1
from paddle_tpu.regularizer import L2Decay as JL2
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.incubate.optimizer import LookAhead, ModelAverage
from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                     llama_tiny_config,
                                     optimizer_state_from_paddle_tpu)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

SHAPES = [(6, 5), (7,), (3, 4)]


def _pkg(side):
    """(optimizer module, lr module, L1, L2, clip) of one package."""
    if side == "jax":
        return jopt_mod, jlr, JL1, JL2, JClip
    return topt_mod, tlr, L1Decay, L2Decay, ClipGradByGlobalNorm


# name -> (class name, kwargs builder(lr module, L1, L2, clip), steps)
CASES = {
    "sgd_l1_stepdecay": ("SGD", lambda lr, l1, l2, c: dict(
        learning_rate=lr.StepDecay(0.1, step_size=2, gamma=0.5),
        weight_decay=l1(0.01)), 3),
    "momentum_nesterov_l2": ("Momentum", lambda lr, l1, l2, c: dict(
        learning_rate=0.05, momentum=0.8, use_nesterov=True,
        weight_decay=l2(0.02)), 3),
    "momentum_clip": ("Momentum", lambda lr, l1, l2, c: dict(
        learning_rate=0.05, grad_clip=c(0.5)), 3),
    "adam_l2_lazy": ("Adam", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2, weight_decay=0.05, lazy_mode=True), 3),
    "adamw_warmup_cosine_lr_ratio": ("AdamW", lambda lr, l1, l2, c: dict(
        learning_rate=lr.LinearWarmup(
            lr.CosineAnnealingDecay(1e-2, T_max=10), warmup_steps=2,
            start_lr=1e-3, end_lr=1e-2),
        weight_decay=0.1, lr_ratio=lambda p: 0.5,
        apply_decay_param_fun=lambda n: n != "p1"), 3),
    "adamw_regularizer_object": ("AdamW", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2, weight_decay=l2(0.1)), 3),
    "adamax_l1": ("Adamax", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2, weight_decay=l1(0.01)), 3),
    "adagrad": ("Adagrad", lambda lr, l1, l2, c: dict(
        learning_rate=0.1, initial_accumulator_value=0.1,
        weight_decay=l2(0.01)), 3),
    "adadelta": ("Adadelta", lambda lr, l1, l2, c: dict(
        learning_rate=1.0, rho=0.9, weight_decay=0.01), 3),
    "rmsprop_centered_momentum": ("RMSProp", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2, momentum=0.5, centered=True,
        weight_decay=l1(0.01)), 3),
    "rmsprop": ("RMSProp", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2), 3),
    "lamb": ("Lamb", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2, lamb_weight_decay=0.05), 3),
    "lars": ("Lars", lambda lr, l1, l2, c: dict(
        learning_rate=0.1, lars_coeff=0.01), 3),
    "asgd_window2": ("ASGD", lambda lr, l1, l2, c: dict(
        learning_rate=lr.ExponentialDecay(0.05, gamma=0.9), batch_num=2,
        t0=1, weight_decay=l2(0.01)), 4),
    "nadam": ("NAdam", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2, weight_decay=0.01), 3),
    "radam_both_branches": ("RAdam", lambda lr, l1, l2, c: dict(
        learning_rate=1e-2, beta2=0.9, weight_decay=l1(0.001)), 12),
    "rprop": ("Rprop", lambda lr, l1, l2, c: dict(
        learning_rate=0.01), 4),
    "lbfgs": ("LBFGS", lambda lr, l1, l2, c: dict(
        learning_rate=0.5, history_size=2, weight_decay=l2(0.01)), 4),
}


def _data(steps, seed=0):
    rng = np.random.RandomState(seed)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return init, grads


def _jax_params(init):
    return [paddle.to_tensor(a, stop_gradient=False) for a in init]


def _port_params(init):
    return [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]


def _set_grads(jparams, params, gs):
    for p, g in zip(jparams, gs):
        p.grad = paddle.to_tensor(g)
    for p, g in zip(params, gs):
        p.grad = torch.from_numpy(g.copy())


def _step_sched(opt):
    sched = getattr(opt, "_lr", None)
    if hasattr(sched, "step"):
        sched.step()


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-7, err_msg=msg)


def _compare_states(tsd, jsd):
    assert tsd["step"] == jsd["step"]
    pkeys = sorted(k for k in jsd if k.startswith("param_"))
    assert sorted(k for k in tsd if k.startswith("param_")) == pkeys
    for k in pkeys:
        assert set(tsd[k]) == set(jsd[k]), k
        for sk in jsd[k]:
            _close(tsd[k][sk], jsd[k][sk], f"{k}.{sk}")
    if "lbfgs" in jsd:
        for key in ("s", "y"):
            assert len(tsd["lbfgs"][key]) == len(jsd["lbfgs"][key])
            for a, b in zip(tsd["lbfgs"][key], jsd["lbfgs"][key]):
                _close(a, b, key)
        np.testing.assert_allclose(tsd["lbfgs"]["rho"], jsd["lbfgs"]["rho"],
                                   rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax_eager_step(case):
    cls_name, kw, steps = CASES[case]
    init, grads = _data(steps)
    jparams, params = _jax_params(init), _port_params(init)
    jopt = getattr(jopt_mod, cls_name)(parameters=jparams,
                                       **kw(*_pkg("jax")[1:]))
    opt = getattr(topt_mod, cls_name)(parameters=params,
                                      **kw(*_pkg("port")[1:]))
    for gs in grads:
        _set_grads(jparams, params, gs)
        assert opt.get_lr() == jopt.get_lr()
        jopt.step()
        opt.step()
        _step_sched(jopt)
        _step_sched(opt)
        for i, (p, jp) in enumerate(zip(params, jparams)):
            _close(p.detach().numpy(), np.asarray(jp._value), f"param {i}")
    _compare_states(opt.state_dict(), jopt.state_dict())
    # the port's own state_dict round trip is exact
    again = getattr(topt_mod, cls_name)(
        parameters=_port_params(init), **kw(*_pkg("port")[1:]))
    again.set_state_dict(opt.state_dict())
    sd, sd2 = opt.state_dict(), again.state_dict()
    for k in (k for k in sd if k.startswith("param_")):
        for sk in sd[k]:
            np.testing.assert_array_equal(sd2[k][sk], sd[k][sk])


@pytest.mark.parametrize("wrapper", ["lookahead", "model_average"])
def test_incubate_optimizers_match_jax(wrapper):
    init, grads = _data(5, seed=3)
    jparams, params = _jax_params(init), _port_params(init)
    if wrapper == "lookahead":
        # one interval: after a sync the JAX LookAhead's fp32 slow copy is
        # the parameter's own buffer, which the next donated step deletes
        grads = grads[:3]
        jw = JLookAhead(jopt_mod.Momentum(learning_rate=0.1,
                                          parameters=jparams), alpha=0.4, k=3)
        tw = LookAhead(topt_mod.Momentum(learning_rate=0.1,
                                         parameters=params), alpha=0.4, k=3)
        for gs in grads:
            _set_grads(jparams, params, gs)
            jw.step()
            tw.step()
            for p, jp in zip(params, jparams):
                _close(p.detach().numpy(), np.asarray(jp._value))
        jsd, tsd = jw.state_dict(), tw.state_dict()
        assert tsd["lookahead_step"] == jsd["lookahead_step"] == 3
        for a, b in zip(tsd["slow_params"], jsd["slow_params"]):
            _close(a, b)
        _compare_states(tsd, jsd)
        return
    jw = JModelAverage(0.5, parameters=jparams, min_average_window=2,
                       max_average_window=3)
    tw = ModelAverage(0.5, parameters=params, min_average_window=2,
                      max_average_window=3)
    jsgd = jopt_mod.SGD(learning_rate=0.1, parameters=jparams)
    tsgd = topt_mod.SGD(learning_rate=0.1, parameters=params)
    for gs in grads:
        _set_grads(jparams, params, gs)
        jsgd.step()
        tsgd.step()
        jw.step()
        tw.step()
        assert tw._num == jw._num
    jw.apply()
    tw.apply()
    for p, jp in zip(params, jparams):
        _close(p.detach().numpy(), np.asarray(jp._value))
    jw.restore()
    tw.restore()
    for p, jp in zip(params, jparams):
        _close(p.detach().numpy(), np.asarray(jp._value))


# ---- the converter: every optimizer's state from a JAX tiny LLaMA -----

CONVERT = sorted(set(c for c, _, _ in CASES.values())) + ["LookAhead"]


def _model_grads(jm, seed):
    rng = np.random.RandomState(seed)
    return {n: (rng.standard_normal(p._value.shape) * 0.1).astype(np.float32)
            for n, p in jm.named_parameters()}


def _port_grad(name, g):
    if name.endswith("_proj.weight") or name == "lm_head.weight":
        return g.T.copy()
    return g


@pytest.mark.parametrize("cls_name", CONVERT)
def test_optimizer_state_converter_matches_jax(cls_name):
    paddle.seed(0)
    cfg = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
               vocab_size=64, num_attention_heads=2, num_key_value_heads=2)
    jm = JaxLlama(jax_tiny_config(**cfg))
    names = [n for n, _ in jm.named_parameters()]
    inner = "Momentum" if cls_name == "LookAhead" else cls_name
    kw = {"LBFGS": dict(learning_rate=0.5, history_size=3),
          "Adagrad": dict(learning_rate=0.1),
          "RMSProp": dict(learning_rate=0.01, centered=True),
          "ASGD": dict(learning_rate=0.05, batch_num=2),
          "SGD": dict(learning_rate=lambda lr: lr.StepDecay(0.1, 1, 0.5))}
    kw = dict(kw.get(inner, dict(learning_rate=1e-2)))

    def build(side, params):
        opt_mod, lr_mod = _pkg(side)[:2]
        k = {a: (v(lr_mod) if callable(v) else v) for a, v in kw.items()}
        opt = getattr(opt_mod, inner)(parameters=params, **k)
        if cls_name == "LookAhead":
            # k=3: one sync (see test_incubate_optimizers_match_jax)
            return (JLookAhead if side == "jax" else LookAhead)(opt, k=3)
        return opt

    jopt = build("jax", jm.parameters())
    for s in range(3):
        for (n, p), g in zip(jm.named_parameters(),
                             _model_grads(jm, s).values()):
            p.grad = paddle.to_tensor(g)
        jopt.step()
        _step_sched(jopt)
    tm = from_paddle_tpu_params(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        llama_tiny_config(**cfg), device="cpu")
    opt = build("port", tm.parameters())
    optimizer_state_from_paddle_tpu(jopt.state_dict(), names, tm, opt)
    tparams = dict(tm.named_parameters())
    jsd, tsd = jopt.state_dict(), opt.state_dict()
    assert tsd["step"] == jsd["step"] == 3
    for i, n in enumerate(names):
        for k, v in jsd.get(f"param_{i}", {}).items():
            want = np.asarray(v, np.float32)
            if want.ndim >= 2 and (n.endswith("_proj.weight")
                                   or n == "lm_head.weight"):
                want = np.swapaxes(want, -1, -2)
            j = [id(p) for p in (opt.inner_optimizer if cls_name ==
                                 "LookAhead" else opt)._params].index(
                id(tparams[n]))
            np.testing.assert_array_equal(tsd[f"param_{j}"][k], want,
                                          err_msg=f"{n}.{k}")
    # one more step on both, from the carried state
    grads = _model_grads(jm, 9)
    for (n, p) in jm.named_parameters():
        p.grad = paddle.to_tensor(grads[n])
    for n, p in tm.named_parameters():
        p.grad = torch.from_numpy(_port_grad(n, grads[n]))
    assert opt.get_lr() == jopt.get_lr()
    jopt.step()
    opt.step()
    for n, p in jm.named_parameters():
        want = np.asarray(p._value)
        if n.endswith("_proj.weight") or n == "lm_head.weight":
            want = want.T
        np.testing.assert_allclose(tparams[n].detach().numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=n)
