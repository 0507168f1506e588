"""The port's GPT-2-style model written on its Paddle API
(``paddle_tpu_torch.models.gpt``) against the JAX package's
``paddle_tpu.models.gpt`` on the CPU, on the same weights (carried by
``models.convert.state_from_paddle_tpu`` into ``set_state_dict``): equal
``state_dict`` names and shapes, logits fp32 within 1e-5, and 3 eager
AdamW steps (``loss.backward(); opt.step(); opt.clear_grad()``, optimizer
state empty on both sides) at ``tests/test_torch_port_training.py``'s
tolerances: per-step losses rtol 1e-5, final parameters atol 2e-5. One
slice is held apart: the key third of each ``qkv.bias``, whose gradient is
zero but for rounding in both packages (softmax is invariant to a shift
shared by every key), so Adam's first steps move it by +-lr on the sign of
that rounding; it is held within 6 lr after 3 steps, its gradients below
1e-6 of the largest. Also the weights' round trip JAX -> port -> JAX."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.models.gpt import GptForCausalLM as JaxGpt
from paddle_tpu.models.gpt import gpt_tiny_config as jax_tiny
from paddle_tpu_torch.models import (GptForCausalLM, gpt_tiny_config,
                                     state_from_paddle_tpu)

LR = 1e-3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev


def _pair(**kw):
    jpaddle.seed(0)
    jm = JaxGpt(jax_tiny(**kw))
    tm = GptForCausalLM(gpt_tiny_config(**kw))
    assert ({k: v.shape for k, v in jm.state_dict().items()}
            == {k: v.shape for k, v in tm.state_dict().items()})
    assert tm.set_state_dict(state_from_paddle_tpu(jm)) == ([], [])
    return jm, tm


def _ids(seed, vocab=256, shape=(2, 16)):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int64)


@pytest.mark.parametrize("kw", [{}, {"hidden_size": 256,
                                     "num_attention_heads": 4}],
                         ids=["tiny", "head_dim64"])
def test_logits_match_jax(kw):
    jm, tm = _pair(**kw)
    ids = _ids(1)
    want = np.asarray(jm(jpaddle.to_tensor(ids))._value)
    got = tm(tpaddle.to_tensor(ids)).numpy()
    assert got.shape == (2, 16, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_three_eager_adamw_steps_match_jax():
    jm, tm = _pair()
    jopt = jpaddle.optimizer.AdamW(learning_rate=LR,
                                   parameters=jm.parameters())
    topt = tpaddle.optimizer.AdamW(learning_rate=LR,
                                   parameters=tm.parameters())
    ids = _ids(2)
    h = jm.config.hidden_size
    jl, tl = [], []
    for step in range(3):
        loss = jm(jpaddle.to_tensor(ids), jpaddle.to_tensor(ids))
        loss.backward()
        jgrads = {n: np.asarray(p.grad._value)
                  for n, p in jm.named_parameters()}
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss))
        loss = tm(tpaddle.to_tensor(ids), tpaddle.to_tensor(ids))
        loss.backward()
        if step == 0:
            assert all(p.grad is not None for p in tm.parameters())
        for n, p in tm.named_parameters():
            if n.endswith("qkv.bias"):
                for g in (p.grad.numpy(), jgrads[n]):
                    assert np.abs(g[h:2 * h]).max() < 1e-6 * np.abs(g).max()
        topt.step()
        topt.clear_grad()
        assert all(p.grad is None for p in tm.parameters())
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    jparams = state_from_paddle_tpu(jm)
    for name, p in tm.named_parameters():
        got, want = p.numpy(), jparams[name]
        if name.endswith("qkv.bias"):
            np.testing.assert_allclose(got[h:2 * h], want[h:2 * h], rtol=0,
                                       atol=6 * LR, err_msg=name)
            got = np.concatenate([got[:h], got[2 * h:]])
            want = np.concatenate([want[:h], want[2 * h:]])
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                                   err_msg=name)


def test_weights_round_trip_jax_port_jax():
    jm, tm = _pair()
    back = JaxGpt(jax_tiny())
    missing, unexpected = back.set_state_dict(
        {n: p.numpy() for n, p in tm.state_dict().items()})
    assert (missing, unexpected) == ([], [])
    want, got = state_from_paddle_tpu(jm), state_from_paddle_tpu(back)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dropout_config_trains_and_eval_is_deterministic():
    tpaddle.seed(0)
    tm = GptForCausalLM(gpt_tiny_config(dropout=0.1))
    ids = tpaddle.to_tensor(_ids(3))
    opt = tpaddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=tm.parameters())
    losses = []
    for _ in range(3):
        loss = tm(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    tm.eval()
    with tpaddle.no_grad():
        a, b = tm(ids).numpy(), tm(ids).numpy()
    np.testing.assert_array_equal(a, b)
