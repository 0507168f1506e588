"""The port's AMP (``paddle_tpu_torch.amp``) against the JAX package's, on
the CPU.

* Under ``auto_cast`` O1 and O2 on a tiny LLaMA (the fused head loss and
  the logits path): the ops JAX's ``_amp_cast_hook`` acts on (a white- or
  black-listed name, or a cast that changes a dtype) and the dtypes it
  casts them to equal those at the port's seam, in order; logits within
  1e-2 of each row's max |logit| (bf16) of JAX's with its attention on
  the Pallas flash kernel in interpret mode (``force_interpret``: the
  kernel the port's replaces; JAX's XLA fallback rounds the scores to
  bf16, which the kernels do not).
* ``GradScaler`` with float16 (O1 ``dtype="float16"``): the scale
  sequence and the skip decisions over 6 steps with one forced overflow
  (the scale set to 2^40 before step 4 on both sides: fp16 gradients
  overflow) equal JAX's ``CompiledTrainStep(grad_scaler=)``, settled with
  ``drain()``; the skipped step leaves the port's parameters and moments
  bit-unchanged and advances the step count, as JAX's does.
* ``check_numerics`` raises where JAX raises, with JAX's message; the
  tensor checker (``check_nan_inf``) raises on a NaN weight in both; the
  operator stats of the seam ops equal JAX's counts for the same names;
  ``decorate`` casts the parameters and turns the master weights on.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.core import tensor as jtensor
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.ops.pallas.flash_attention import force_interpret
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel.train_step import CompiledTrainStep
import paddle_tpu_torch.amp as tamp
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                     llama_tiny_config)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep

CFG = dict(num_hidden_layers=2, num_key_value_heads=2)
LISTED = jamp.WHITE_LIST | jamp.BLACK_LIST


def _models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(**CFG))
    tm = from_paddle_tpu_params(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        llama_tiny_config(**CFG), device="cpu")
    return jm, tm


def _ids(seed=0, shape=(2, 16)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32)


def _dt(v):
    return str(v.dtype).removeprefix("torch.")


def _acted(name, before, after):
    return name in LISTED or before != after


@pytest.fixture
def spies(monkeypatch):
    seen = {"jax": [], "port": []}
    jorig, torig = jtensor._amp_hook, tamp._amp_cast_hook

    def jspy(name, vals):
        out = jorig(name, vals)
        b = [_dt(v) for v in vals if hasattr(v, "dtype")]
        a = [_dt(v) for v in out if hasattr(v, "dtype")]
        if _acted(name, b, a):
            seen["jax"].append((name, tuple(a)))
        return out

    def tspy(name, vals):
        out = torig(name, vals)
        b = [_dt(v) for v in vals if isinstance(v, torch.Tensor)]
        a = [_dt(v) for v in out if isinstance(v, torch.Tensor)]
        if _acted(name, b, a):
            seen["port"].append((name, tuple(a)))
        return out

    monkeypatch.setattr(jtensor, "_amp_hook", jspy)
    monkeypatch.setattr(tamp, "_amp_cast_hook", tspy)
    return seen


def _port_names(seq):
    # torch's integer ids are int64 where JAX's are int32
    return [(n, tuple("int32" if d == "int64" else d for d in a))
            for n, a in seq]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_seam_casts_and_logits_match_jax(level, spies):
    jm, tm = _models()
    ids = _ids()
    with jamp.auto_cast(level=level):
        jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    with tamp.auto_cast(level=level), torch.no_grad():
        tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert spies["jax"], "the JAX hook saw no op"
    assert _port_names(spies["port"]) == spies["jax"]
    names = {n for n, _ in spies["jax"]}
    assert {"linear", "sdpa", "mean"} <= names
    if level == "O2":
        assert {"embedding", "rms_norm", "rope",
                "fused_linear_cross_entropy"} <= names
    with jamp.auto_cast(level=level), force_interpret():
        jlogits = np.asarray(jm(paddle.to_tensor(ids))._value, np.float32)
    with tamp.auto_cast(level=level), torch.no_grad():
        tlogits = tm(torch.from_numpy(ids))
    assert tlogits.dtype == torch.bfloat16
    tl = tlogits.float().numpy()
    rowmax = np.abs(jlogits).max(-1, keepdims=True)
    assert (np.abs(tl - jlogits) <= 1e-2 * rowmax).all()


def _batch(seed):
    ids = _ids(seed, (2, 32))
    labels = _ids(seed + 100, (2, 32))
    return {"input_ids": ids, "labels": labels}


def test_grad_scaler_float16_matches_compiled_train_step():
    jm, tm = _models()
    jsc = jamp.GradScaler(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
                          decr_ratio=2.0 ** -25)
    tsc = tamp.GradScaler(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
                          decr_ratio=2.0 ** -25)
    jopt = JaxAdamW(learning_rate=1e-3, parameters=jm.parameters())
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    jstep = CompiledTrainStep(jm, lambda out, lab: out, optimizer=jopt,
                              grad_scaler=jsc, collect_metrics=True)
    step = TrainStep(tm, lambda out, lab: out, opt, grad_scaler=tsc,
                     collect_metrics=True)
    jscales, tscales, jskip, tskip, jl, tl = [], [], [], [], [], []
    for i in range(6):
        batch = _batch(i)
        if i == 3:                       # the forced overflow
            jsc._scale = tsc._scale = 2.0 ** 40
            before = ([p.detach().clone() for p in tm.parameters()],
                      {k: {n: v.clone() for n, v in st.items()}
                       for k, st in opt._state.items()})
        with jamp.auto_cast(level="O1", dtype="float16"):
            jl.append(float(jstep(batch)))
        jstep.drain()
        jskip.append(jstep.last_metrics()["skipped"])
        jscales.append(jsc._scale)
        with tamp.auto_cast(level="O1", dtype="float16"):
            tl.append(float(step(batch)))
        tskip.append(step.last_metrics()["skipped"])
        tscales.append(tsc._scale)
        if i == 3:
            for p, b in zip(tm.parameters(), before[0]):
                assert torch.equal(p.detach(), b)
            for k, st in opt._state.items():
                for n, v in st.items():
                    assert torch.equal(v, before[1][k][n])
            assert opt._step_count == jopt._step_count == 4
    assert tskip == jskip == [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    assert tscales == jscales == [2.0 ** 15, 2.0 ** 16, 2.0 ** 16, 2.0 ** 15,
                                  2.0 ** 15, 2.0 ** 16]
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def test_check_numerics_raises_where_jax_raises():
    good = np.ones((3, 4), np.float32)
    bad = good.copy()
    bad[0, 1], bad[2, 2] = np.nan, np.inf
    assert jdbg.check_numerics(paddle.to_tensor(good)) is True
    assert tdbg.check_numerics(torch.from_numpy(good)) is True
    with pytest.raises(FloatingPointError) as je:
        jdbg.check_numerics([paddle.to_tensor(good), paddle.to_tensor(bad)],
                            op_type="matmul")
    with pytest.raises(FloatingPointError) as te:
        tdbg.check_numerics([torch.from_numpy(good), torch.from_numpy(bad)],
                            op_type="matmul")
    assert str(te.value) == str(je.value)
    # integer tensors are never checked
    assert tdbg.check_numerics(torch.tensor([1, 2])) is True


def test_tensor_checker_raises_on_nan_weight_in_both():
    jm, tm = _models()
    w = "llama.layers.0.mlp.up_proj.weight"
    jp = dict(jm.named_parameters())[w]
    jp._set_value(jp._value.at[0, 0].set(jnp.nan))
    with torch.no_grad():
        tm.get_parameter(w)[0, 0] = float("nan")
    ids = _ids()
    try:
        jdbg.enable_tensor_checker()
        tdbg.enable_tensor_checker()
        with pytest.raises(FloatingPointError):
            jm(paddle.to_tensor(ids))
        with pytest.raises(FloatingPointError, match="linear"):
            tm(torch.from_numpy(ids))
    finally:
        jdbg.disable_tensor_checker()
        tdbg.disable_tensor_checker()
        jax_set_flags({"check_nan_inf": False})
        set_flags({"check_nan_inf": False})


def test_operator_stats_match_jax_on_the_seam_ops():
    jm, tm = _models()
    ids = _ids()
    jdbg.enable_operator_stats_collection()
    with jamp.auto_cast(level="O1"):
        jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jstats = jdbg.disable_operator_stats_collection()
    tdbg.enable_operator_stats_collection()
    with tamp.auto_cast(level="O1"), torch.no_grad():
        tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    tstats = tdbg.disable_operator_stats_collection()
    tstats["embedding"] = {"int32" if k == "int64" else k: v
                           for k, v in tstats["embedding"].items()}
    for name in ("linear", "sdpa", "rms_norm", "rope", "embedding", "mean",
                 "fused_linear_cross_entropy"):
        assert tstats[name] == jstats[name], name


def test_decorate_casts_params_and_sets_master_weights():
    _, tm = _models()
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    m, o = tamp.decorate(tm, opt, level="O2")
    assert m is tm and o is opt and opt._use_master_weights
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert tamp.white_list() == jamp.white_list()
    assert tamp.black_list() == jamp.black_list()
    assert tamp.is_bfloat16_supported()
