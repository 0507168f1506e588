"""The port's activation recomputation (``fleet.recompute``) and
``strategy.recompute`` on the CPU.

* ``recompute`` of a Paddle-API block and of one tiny LLaMA decoder layer
  against the JAX package's ``fleet.recompute`` on the same weights: the
  loss and the gradients to the input and to every weight within 1e-5
  (fp32);
* within the port, recompute is bit-equal to the plain backward for a
  torch module, a Paddle-API block and a LLaMA layer, also with the
  backward (and so the recompute) on another thread and under O1 AMP;
* a block with dropout draws the first run's mask in the recompute, and
  the generator goes on as if drawn once, for the global generator and
  for a ``fleet.rng`` tracker stream (scope entered outside the
  recompute, backward on another thread); without the replay the masks
  differ. The JAX package's threefry masks cannot be matched;
* ``strategy.recompute`` with ``checkpoints`` wraps what the JAX
  package's pass wraps (``tests/test_strategy_passes.py``'s ``Net``),
  the outermost match of each, for Paddle-API layers and torch modules,
  with JAX's gradients; the LLaMA decoder layers by name, bit-equal to
  the plain model; with no patterns a ``layer_remat_capable`` model gets
  ``remat_policy`` "full" and another model nothing.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.recompute import recompute as jax_recompute
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import get_rng_state_tracker
from paddle_tpu_torch.distributed.fleet.recompute import recompute
from paddle_tpu_torch.models import from_paddle_tpu_params, llama_tiny_config
from paddle_tpu_torch.models.convert import _to_port_layout
from paddle_tpu_torch.ops import random_state

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(num_key_value_heads=2, num_hidden_layers=2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev
    get_rng_state_tracker().reset()
    fleet.reset()


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _in_thread(fn):
    """Run `fn` on another thread, as autograd runs a CUDA backward."""
    err = []

    def run():
        try:
            fn()
        except BaseException as e:      # re-raised on this thread
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    if err:
        raise err[0]


# ---- the subjects, in both packages ---------------------------------------

def _blocks():
    """The Paddle-API block of test_strategy_passes.py's recompute test
    in both packages, on the JAX one's weights."""
    jpaddle.seed(0)
    jb = jpaddle.nn.Sequential(jpaddle.nn.Linear(4, 8), jpaddle.nn.Tanh(),
                               jpaddle.nn.Linear(8, 4))
    tb = tpaddle.nn.Sequential(tpaddle.nn.Linear(4, 8), tpaddle.nn.Tanh(),
                               tpaddle.nn.Linear(8, 4))
    tb.set_state_dict({n: np.asarray(p._value)
                       for n, p in jb.state_dict().items()})
    return jb, tb, (3, 4)


def _llama_layers():
    jpaddle.seed(0)
    jm = JaxLlama(jax_tiny_config(**CFG))
    tm = from_paddle_tpu_params(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        llama_tiny_config(**CFG), device="cpu")
    return jm.llama.layers[0], tm.llama.layers[0], \
        (2, 16, jm.config.hidden_size)


SUBJECTS = {"paddle_block": _blocks, "llama_layer": _llama_layers}


def _jax_run(layer, x, proj):
    xj = jpaddle.to_tensor(x, stop_gradient=False)
    loss = (jax_recompute(layer, xj) * jpaddle.to_tensor(proj)).sum()
    loss.backward()
    return float(loss), np.asarray(xj.grad._value), {
        n: np.asarray(p.grad._value) for n, p in layer.named_parameters()}


def _port_run(layer, x, proj, rc=True, thread=False):
    """(loss, input grad, {name: weight grad}) of sum(layer(x) * proj),
    through ``recompute`` when `rc`; the gradients as numpy in the port's
    layout."""
    paddle_api = isinstance(layer, tpaddle.nn.Layer)
    params = dict(layer.named_parameters())
    for p in params.values():
        p.grad = None
    if paddle_api:
        xv = tpaddle.to_tensor(x, stop_gradient=False)
        out = recompute(layer, xv) if rc else layer(xv)
        loss = (out * tpaddle.to_tensor(proj)).sum()
    else:
        xv = torch.from_numpy(x).requires_grad_()
        out = recompute(layer, xv) if rc else layer(xv)
        loss = (out * torch.from_numpy(proj)).sum()
    if thread:
        _in_thread(loss.backward)
    else:
        loss.backward()

    def arr(t):
        return (t._value if paddle_api else t).detach().numpy().copy()

    return (float(arr(loss)), arr(xv.grad),
            {n: arr(p.grad) for n, p in params.items()})


@pytest.mark.parametrize("subject", list(SUBJECTS))
def test_recompute_matches_jax(subject):
    jl, tl, shape = SUBJECTS[subject]()
    x, proj = _f(*shape, seed=1), _f(*shape, seed=2)
    j_loss, j_gx, j_gw = _jax_run(jl, x, proj)
    t_loss, t_gx, t_gw = _port_run(tl, x, proj)
    np.testing.assert_allclose(t_loss, j_loss, **TOL)
    np.testing.assert_allclose(t_gx, j_gx, **TOL)
    assert set(t_gw) == set(j_gw)
    for n, g in t_gw.items():
        ref = j_gw[n] if subject == "paddle_block" \
            else _to_port_layout(n, j_gw[n])
        np.testing.assert_allclose(g, ref, err_msg=n, **TOL)


def _torch_block():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.GELU(),
                               torch.nn.Linear(8, 4)), (3, 4)


@pytest.mark.parametrize("thread", [False, True],
                         ids=["same_thread", "backward_thread"])
@pytest.mark.parametrize("subject", ["torch_module", *SUBJECTS])
def test_recompute_bit_equal_to_plain(subject, thread):
    if subject == "torch_module":
        layer, shape = _torch_block()
    else:
        _, layer, shape = SUBJECTS[subject]()
    x, proj = _f(*shape, seed=3), _f(*shape, seed=4)
    plain = _port_run(layer, x, proj, rc=False)
    rc = _port_run(layer, x, proj, rc=True, thread=thread)
    assert rc[0] == plain[0]
    assert np.array_equal(rc[1], plain[1])
    for n in plain[2]:
        assert np.array_equal(rc[2][n], plain[2][n]), n


def test_recompute_replays_amp_on_the_backward_thread():
    """Under O1 the layer's matmuls run in bf16; the recompute on
    autograd's thread (no AMP state there) must run them in bf16 too,
    or its saved activations and the gradients change."""
    _, layer, shape = _llama_layers()
    x, proj = _f(*shape, seed=5), _f(*shape, seed=6)

    def run(rc, thread):
        layer.zero_grad(set_to_none=True)
        xv = torch.from_numpy(x).requires_grad_()
        with auto_cast(level="O1", dtype="bfloat16"):
            out = recompute(layer, xv) if rc else layer(xv)
        loss = (out.float() * torch.from_numpy(proj)).sum()
        (_in_thread(loss.backward) if thread else loss.backward())
        return [xv.grad.clone()] + [p.grad.clone()
                                    for p in layer.parameters()]

    plain = run(False, False)
    for got in (run(True, False), run(True, True)):
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


# ---- dropout replay from the port's explicit generators --------------------

class _DropBlock(tpaddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tpaddle.nn.Linear(16, 32)
        self.drop = tpaddle.nn.Dropout(p=0.4)
        self.fc2 = tpaddle.nn.Linear(32, 16)

    def forward(self, x):
        return self.fc2(self.drop(tpaddle.tanh(self.fc1(x))))


def _fresh_stream(kind):
    """Reseed the generator `kind` draws from, and return the scope the
    forward runs in (the tracker's stream, or no scope)."""
    import contextlib

    tpaddle.seed(11)
    tracker = get_rng_state_tracker()
    tracker.reset()
    if kind == "global":
        return contextlib.nullcontext
    tracker.add("stream", 1234)
    return lambda: tracker.rng_state("stream")


def _dropout_run(kind, rc, thread=False, preserve=True):
    """Grads of a dropout block run plainly or under recompute, and the
    next 8 numbers the stream draws after the backward."""
    tpaddle.seed(5)
    block = _DropBlock()
    scope = _fresh_stream(kind)
    x = tpaddle.to_tensor(_f(8, 16, seed=7), stop_gradient=False)
    with scope():
        out = (recompute(block, x, preserve_rng_state=preserve) if rc
               else block(x))
    loss = (out * out).sum()
    (_in_thread(loss.backward) if thread else loss.backward())
    with scope():
        nxt = torch.rand(8, generator=random_state.active_generator(
            torch.device("cpu")))
    grads = [np.asarray(p.grad._value).copy() for p in block.parameters()]
    return grads + [np.asarray(x.grad._value).copy()], nxt


@pytest.mark.parametrize("thread", [False, True],
                         ids=["same_thread", "backward_thread"])
@pytest.mark.parametrize("kind", ["global", "tracker"])
def test_recompute_replays_dropout_mask(kind, thread):
    plain, nxt_plain = _dropout_run(kind, rc=False)
    got, nxt = _dropout_run(kind, rc=True, thread=thread)
    for a, b in zip(got, plain):
        assert np.array_equal(a, b)
    assert torch.equal(nxt, nxt_plain)     # as if drawn once


@pytest.mark.parametrize("kind", ["global", "tracker"])
def test_dropout_mask_differs_without_the_replay(kind):
    """The control: with preserve_rng_state=False the recompute draws a
    new mask, so the gradients leave the plain ones."""
    plain, _ = _dropout_run(kind, rc=False)
    got, _ = _dropout_run(kind, rc=True, preserve=False)
    assert not all(np.array_equal(a, b) for a, b in zip(got, plain))


# ---- strategy.recompute -----------------------------------------------------

def _jax_net():
    class Net(jpaddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.block = jpaddle.nn.Sequential(jpaddle.nn.Linear(4, 8),
                                               jpaddle.nn.Tanh())
            self.head = jpaddle.nn.Linear(8, 2)

        def forward(self, x):
            return self.head(self.block(x))

    jpaddle.seed(0)
    return Net()


class _PortNet(tpaddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.block = tpaddle.nn.Sequential(tpaddle.nn.Linear(4, 8),
                                           tpaddle.nn.Tanh())
        self.head = tpaddle.nn.Linear(8, 2)

    def forward(self, x):
        return self.head(self.block(x))


class _TorchNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.block = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                         torch.nn.Tanh())
        self.head = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.head(self.block(x))


def _strategy(pkg_fleet, checkpoints):
    s = pkg_fleet.DistributedStrategy()
    s.recompute = True
    s.recompute_configs = {"checkpoints": checkpoints}
    return s


def _wrapped(named):
    return sorted(n for n, m in named if getattr(m, "_recompute_wrapped",
                                                 False))


@pytest.mark.parametrize("kind", ["paddle_layer", "torch_module"])
def test_strategy_recompute_wraps_what_jax_wraps(kind):
    """JAX's pass wraps every sublayer whose name holds a pattern
    (block, block.0, block.1); the port wraps the outermost of them."""
    jm = _jax_net()
    jfleet._apply_strategy_passes(jm, _strategy(jfleet, ["block"]))
    j_wrapped = _wrapped(jm.named_sublayers())
    assert j_wrapped == ["block", "block.0", "block.1"]
    state = {n: np.asarray(p._value) for n, p in jm.state_dict().items()}
    if kind == "paddle_layer":
        tm = _PortNet()
        tm.set_state_dict(state)
        named = list(tm.named_sublayers())
    else:
        tm = _TorchNet()
        with torch.no_grad():      # Paddle [in, out], torch [out, in]
            for n, p in tm.named_parameters():
                p.copy_(torch.from_numpy(state[n].T.copy()))
        named = list(tm.named_modules())
    got = fleet._apply_strategy_passes(tm, _strategy(fleet, ["block"]))
    assert got is tm
    t_wrapped = _wrapped(named)
    assert t_wrapped == ["block"]
    assert all(any(n == w or n.startswith(w + ".") for w in t_wrapped)
               for n in j_wrapped)
    assert not getattr(tm.head, "_recompute_wrapped", False)

    x = _f(3, 4, seed=8)
    xj = jpaddle.to_tensor(x, stop_gradient=False)
    jm(xj).sum().backward()
    if kind == "paddle_layer":
        xt = tpaddle.to_tensor(x, stop_gradient=False)
        tm(xt).sum().backward()
        grads = {n: np.asarray(p.grad._value) for n, p in
                 tm.named_parameters()}
        gx = np.asarray(xt.grad._value)
    else:
        xt = torch.from_numpy(x).requires_grad_()
        tm(xt).sum().backward()
        grads = {n: p.grad.numpy().T if p.dim() == 2 else p.grad.numpy()
                 for n, p in tm.named_parameters()}
        gx = xt.grad.numpy()
    assert tm.block[0].weight.grad is not None
    np.testing.assert_allclose(gx, np.asarray(xj.grad._value), **TOL)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(grads[n], np.asarray(p.grad._value),
                                   err_msg=n, **TOL)


def test_strategy_recompute_wraps_llama_decoder_layers():
    """checkpoints ["llama.layers."]: the decoder layers, and nothing
    inside them or beside them; the loss and every gradient bit-equal to
    the plain model's, through fleet.distributed_model in a world of
    one."""
    tiny = llama_tiny_config(**CFG)
    batch = {"input_ids": torch.from_numpy(
                 np.arange(32).reshape(2, 16) % 256),
             "labels": torch.from_numpy(
                 (np.arange(32).reshape(2, 16) + 1) % 256)}
    from paddle_tpu_torch.models import LlamaForCausalLM

    def loss_and_grads(model):
        model.zero_grad(set_to_none=True)
        loss = model(**batch)
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in model.parameters()]

    plain = LlamaForCausalLM(tiny, device="cpu", seed=3)
    ref = loss_and_grads(plain)
    model = LlamaForCausalLM(tiny, device="cpu", seed=3)
    fleet.init(strategy=_strategy(fleet, ["llama.layers."]))
    fleet.distributed_model(model)
    assert _wrapped(model.named_modules()) == ["llama.layers.0",
                                               "llama.layers.1"]
    assert getattr(model, "remat_policy", None) is None
    got = loss_and_grads(model)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))


def test_strategy_recompute_without_patterns():
    """No checkpoints: a layer_remat_capable model gets remat_policy
    "full" (the port's route; JAX wraps nothing), any other model is left
    as JAX leaves it."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    s = _strategy(fleet, [])
    llama = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu", seed=1)
    fleet._apply_strategy_passes(llama, s)
    assert llama.remat_policy == "full"
    assert _wrapped(llama.named_modules()) == []
    net = _PortNet()
    fleet._apply_strategy_passes(net, s)
    assert _wrapped(net.named_sublayers()) == []
    jm = _jax_net()
    jfleet._apply_strategy_passes(jm, _strategy(jfleet, []))
    assert _wrapped(jm.named_sublayers()) == []


def test_recompute_is_exported_where_jax_exports_it():
    from paddle_tpu.distributed.fleet import utils as jutils
    from paddle_tpu_torch.distributed.fleet import utils

    assert "recompute" in fleet.__all__ and "recompute" in jfleet.__all__
    assert fleet.recompute is recompute and utils.recompute is recompute
    assert hasattr(jutils, "recompute")
