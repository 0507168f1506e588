"""The port's Paddle ``nn`` API (``paddle_tpu_torch.nn``) against the JAX
package's on the CPU: the ``Layer`` API (registration, structured names,
modes, hooks, containers, ``set_state_dict``, ``to``/``astype``), equal
``state_dict`` names and shapes, every ported layer and loss on the same
weights (loaded through ``set_state_dict``) and inputs, outputs and
gradients fp32 within 1e-5; the initializers by their statistics;
optimizers still training a ``Parameter`` after ``set_state_dict``,
``set_value`` and ``astype``; ``F.scaled_dot_product_attention``'s
``attn_mask`` against JAX's and its dropout by keep rate and eval-mode
identity; and the views the Paddle-level attention hands the flash kernel
at the widths the chip phases use."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.models import state_from_paddle_tpu

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev


def _f(*shape, seed=0, lo=None, hi=None):
    r = np.random.RandomState(seed)
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


# ---- the Layer API --------------------------------------------------------

class _Block(tpaddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tpaddle.nn.Linear(4, 3)
        self.norm = tpaddle.nn.LayerNorm(3)
        self.extra = self.create_parameter(
            [2], attr=tpaddle.ParamAttr(
                name="extra", trainable=False,
                initializer=tpaddle.nn.initializer.Constant(0.5)))
        self.register_buffer("steps", tpaddle.to_tensor(np.zeros(1)))
        self.register_buffer("scratch", np.ones(2, np.float32),
                             persistable=False)

    def forward(self, x):
        return self.norm(self.fc(x))


def test_layer_registration_and_state_dict():
    m = tpaddle.nn.Sequential(_Block(), tpaddle.nn.ReLU(), _Block().fc)
    names = [n for n, _ in m.named_parameters()]
    assert names == ["0.extra", "0.fc.weight", "0.fc.bias", "0.norm.weight",
                     "0.norm.bias", "2.weight", "2.bias"]
    assert list(m.state_dict()) == names + ["0.steps"]
    blk = m[0]
    assert blk.extra.stop_gradient and not blk.extra.trainable
    assert blk.extra.name == "extra" and blk.extra.persistable
    np.testing.assert_array_equal(blk.extra.numpy(), [0.5, 0.5])
    assert not blk.fc.weight.stop_gradient and blk.fc.weight.shape == [4, 3]
    blk.extra.trainable = True
    assert not blk.extra.stop_gradient
    assert [type(l).__name__ for l in m.sublayers()] == [
        "_Block", "Linear", "LayerNorm", "relu", "Linear"]
    missing, unexpected = m.set_state_dict(
        {"0.fc.bias": np.ones(3, np.float32), "nope": np.zeros(1)})
    assert "nope" in unexpected and "0.fc.weight" in missing
    np.testing.assert_array_equal(blk.fc.bias.numpy(), np.ones(3))
    with pytest.raises(ValueError, match="shape mismatch"):
        m.set_state_dict({"0.fc.bias": np.ones(4, np.float32)})
    del blk.extra
    assert "0.extra" not in dict(m.named_parameters())


def test_modes_hooks_and_containers():
    m = _Block()
    m.eval()
    assert not m.training and not m.fc.training
    m.train()
    assert m.norm.training
    seen = []
    h1 = m.register_forward_pre_hook(lambda l, args: (args[0] * 2,))
    h2 = m.register_forward_post_hook(lambda l, args, out: seen.append(
        out.shape) or out * 0 + 1)
    x = tpaddle.to_tensor(_f(2, 4))
    out = m(x)
    np.testing.assert_array_equal(out.numpy(), np.ones((2, 3)))
    h1.remove()
    h2.remove()
    assert seen == [[2, 3]] and float(m(x).sum()) != 6.0
    ll = tpaddle.nn.LayerList([tpaddle.nn.Identity()])
    ll.append(tpaddle.nn.Tanh()).insert(0, tpaddle.nn.ReLU())
    assert [type(l).__name__ for l in ll] == ["relu", "Identity", "tanh"]
    assert len(ll[1:]) == 2
    pl = tpaddle.nn.ParameterList([m.fc.weight]).append(m.fc.bias)
    assert len(pl) == 2 and pl[1] is m.fc.bias
    ld = tpaddle.nn.LayerDict({"a": m.fc})
    ld["b"] = m.norm
    assert list(ld.keys()) == ["a", "b"] and ld["b"] is m.norm
    count = []
    m.apply(lambda l: count.append(type(l).__name__))
    assert count == ["_Block", "Linear", "LayerNorm"]


def test_to_astype_and_clear_gradients():
    m = _Block()
    x = tpaddle.to_tensor(_f(2, 4))
    m(x).sum().backward()
    assert m.fc.weight.grad is not None
    m.clear_gradients()
    assert all(p.grad is None for p in m.parameters())
    m.astype("float64")
    assert m.fc.weight.dtype == tpaddle.float64 and m.fc.weight.is_leaf
    assert not m.fc.weight.stop_gradient
    assert m.steps.dtype == tpaddle.float64
    m.to(dtype="bfloat16")
    assert m.norm.bias.dtype == tpaddle.bfloat16
    m.float()
    assert m(x).dtype == tpaddle.float32


def test_state_dict_names_and_shapes_equal_jax():
    jm = jpaddle.nn.Sequential(
        jpaddle.nn.Embedding(10, 4), jpaddle.nn.Linear(4, 6),
        jpaddle.nn.LayerNorm(6), jpaddle.nn.RMSNorm(6),
        jpaddle.nn.PReLU(), jpaddle.nn.Linear(6, 2, bias_attr=False))
    tm = tpaddle.nn.Sequential(
        tpaddle.nn.Embedding(10, 4), tpaddle.nn.Linear(4, 6),
        tpaddle.nn.LayerNorm(6), tpaddle.nn.RMSNorm(6),
        tpaddle.nn.PReLU(), tpaddle.nn.Linear(6, 2, bias_attr=False))
    assert ({k: v.shape for k, v in jm.state_dict().items()}
            == {k: v.shape for k, v in tm.state_dict().items()})
    assert tm.set_state_dict(state_from_paddle_tpu(jm)) == ([], [])
    ids = np.array([[1, 3, 9]], np.int64)
    np.testing.assert_allclose(tm(tpaddle.to_tensor(ids)).numpy(),
                               np.asarray(jm(jpaddle.to_tensor(ids))._value),
                               **TOL)


# ---- every ported layer and loss against JAX ------------------------------

def _layer_cases():
    X = _f(2, 3, 8)
    return {
        "Linear": (lambda nn: nn.Linear(8, 5), [X]),
        "Linear_nobias": (lambda nn: nn.Linear(8, 5, bias_attr=False), [X]),
        "Embedding": (lambda nn: nn.Embedding(7, 4, padding_idx=2),
                      [np.array([[0, 2, 6], [2, 1, 1]], np.int64)]),
        "Dropout_p0": (lambda nn: nn.Dropout(0.0), [X]),
        "Flatten": (lambda nn: nn.Flatten(), [X]),
        "LayerNorm": (lambda nn: nn.LayerNorm(8), [X]),
        "LayerNorm_2d": (lambda nn: nn.LayerNorm([3, 8], epsilon=1e-3), [X]),
        "RMSNorm": (lambda nn: nn.RMSNorm(8), [X]),
        "Identity": (lambda nn: nn.Identity(), [X]),
        **{name: (lambda nn, n=name: getattr(nn, n)(), [X])
           for name in ("ReLU", "ReLU6", "Sigmoid", "Silu", "Swish", "Tanh",
                        "LogSigmoid", "Mish", "Hardswish", "Hardsigmoid",
                        "Tanhshrink", "Softsign", "Softplus", "SELU", "CELU",
                        "ELU", "Hardshrink", "Softshrink", "Hardtanh",
                        "ThresholdedReLU")},
        "GELU": (lambda nn: nn.GELU(), [X]),
        "GELU_tanh": (lambda nn: nn.GELU(approximate=True), [X]),
        "Softmax": (lambda nn: nn.Softmax(axis=1), [X]),
        "LogSoftmax": (lambda nn: nn.LogSoftmax(), [X]),
        "LeakyReLU": (lambda nn: nn.LeakyReLU(0.2), [X]),
        "ELU_alpha": (lambda nn: nn.ELU(0.5), [X]),
        "GLU": (lambda nn: nn.GLU(), [X]),
        "PReLU": (lambda nn: nn.PReLU(3, init=0.1), [X]),
        "Maxout": (lambda nn: nn.Maxout(2, axis=2), [X]),
    }


def _loss_cases():
    logits, lab = _f(6, 5), np.array([0, 4, 2, -100, 1, 3], np.int64)
    prob = _f(6, 5, lo=0.05, hi=0.95)
    y01 = (np.random.RandomState(3).rand(6, 5) > 0.5).astype(np.float32)
    soft = np.random.RandomState(4).dirichlet(np.ones(5), 6).astype(
        np.float32)
    w = _f(5, lo=0.5, hi=2.0)
    return {
        "CrossEntropyLoss": (lambda nn: nn.CrossEntropyLoss(), [logits, lab]),
        "CrossEntropyLoss_sum_smooth": (
            lambda nn: nn.CrossEntropyLoss(reduction="sum",
                                           label_smoothing=0.1),
            [logits, lab]),
        "CrossEntropyLoss_none": (
            lambda nn: nn.CrossEntropyLoss(reduction="none"), [logits, lab]),
        "CrossEntropyLoss_soft": (
            lambda nn: nn.CrossEntropyLoss(soft_label=True), [logits, soft]),
        "CrossEntropyLoss_weight": (
            lambda nn, P: nn.CrossEntropyLoss(weight=P.to_tensor(w)),
            [logits, lab]),
        "MSELoss": (lambda nn: nn.MSELoss(), [logits, prob]),
        "L1Loss": (lambda nn: nn.L1Loss(reduction="sum"), [logits, prob]),
        "NLLLoss": (lambda nn: nn.NLLLoss(),
                    [np.log(prob / prob.sum(1, keepdims=True)), lab]),
        "BCELoss": (lambda nn: nn.BCELoss(), [prob, y01]),
        "BCEWithLogitsLoss": (lambda nn: nn.BCEWithLogitsLoss(),
                              [logits, y01]),
        "BCEWithLogitsLoss_pos": (
            lambda nn, P: nn.BCEWithLogitsLoss(pos_weight=P.to_tensor(w)),
            [logits, y01]),
        "KLDivLoss": (lambda nn: nn.KLDivLoss(reduction="batchmean"),
                      [np.log(prob), soft]),
        "SmoothL1Loss": (lambda nn: nn.SmoothL1Loss(delta=0.5),
                         [logits, prob]),
    }


def _build(case, P):
    make = case[0]
    try:
        return make(P.nn, P)
    except TypeError:
        return make(P.nn)


def _run(P, layer, arrays):
    ts = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in arrays]
    if len(ts) > 1:                     # a loss: the label stops gradients
        ts[1].stop_gradient = True
    out = layer(*ts)
    cot = _f(*out.shape, seed=9) if out.shape else np.float32(1.0)
    (out * P.to_tensor(cot)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()
             if p.grad is not None}
    if not ts[0].stop_gradient:
        grads["input"] = ts[0].grad.numpy()
    return out.numpy(), grads


@pytest.mark.parametrize("name", sorted({**_layer_cases(), **_loss_cases()}))
def test_layer_matches_jax(name):
    case = {**_layer_cases(), **_loss_cases()}[name]
    jl, tl = _build(case, jpaddle), _build(case, tpaddle)
    assert tl.set_state_dict(state_from_paddle_tpu(jl)) == ([], [])
    jout, jg = _run(jpaddle, jl, case[1])
    tout, tg = _run(tpaddle, tl, case[1])
    np.testing.assert_allclose(tout, np.asarray(jout), **TOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], np.asarray(jg[k]), err_msg=k,
                                   **TOL)


def test_dropout_layers_keep_rate_and_eval_identity():
    x = tpaddle.to_tensor(np.ones((8, 500, 4, 4), np.float32))
    for layer, shared_axes in ((tpaddle.nn.Dropout(0.3), ()),
                               (tpaddle.nn.Dropout(0.3, axis=1), (0, 2, 3)),
                               (tpaddle.nn.Dropout2D(0.3), (2, 3))):
        tpaddle.seed(1)
        v = layer(x).numpy()
        kept = v != 0
        draws = kept.size // np.prod([kept.shape[a] for a in shared_axes],
                                     dtype=int)
        assert abs(kept.mean() - 0.7) < 5 * np.sqrt(0.21 / draws)
        np.testing.assert_allclose(v[kept], 1 / 0.7, rtol=1e-6)
        for ax in shared_axes:         # one draw along the shared axes
            assert (kept == kept.take([0], axis=ax)).all()
        layer.eval()
        np.testing.assert_array_equal(layer(x).numpy(), x.numpy())
    tpaddle.seed(1)
    a = tpaddle.nn.functional.dropout(x, 0.5).numpy()
    tpaddle.seed(1)
    np.testing.assert_array_equal(
        tpaddle.nn.functional.dropout(x, 0.5).numpy(), a)
    ad = tpaddle.nn.AlphaDropout(0.2)
    y = ad(tpaddle.to_tensor(_f(400, 200)))
    assert abs(float(y.mean())) < 0.05 and abs(float(y.std()) - 1) < 0.05
    ad.eval()
    assert float(ad(x).sum()) == x.size


# ---- initializers ---------------------------------------------------------

INITS = {
    "Constant": (lambda I: I.Constant(0.25), [64, 64], 0.25, 0.0),
    "Normal": (lambda I: I.Normal(1.0, 0.5), [128, 64], 1.0, 0.25),
    "TruncatedNormal": (lambda I: I.TruncatedNormal(0.0, 1.0), [128, 64],
                        0.0, 0.7737),
    "Uniform": (lambda I: I.Uniform(-1.0, 3.0), [128, 64], 1.0, 16 / 12),
    "XavierUniform": (lambda I: I.XavierUniform(), [128, 64], 0.0,
                      6.0 / 192 / 3),
    "XavierNormal": (lambda I: I.XavierNormal(), [128, 64], 0.0, 2.0 / 192),
    "KaimingUniform": (lambda I: I.KaimingUniform(), [128, 64], 0.0,
                       2.0 / 128),
    "KaimingNormal": (lambda I: I.KaimingNormal(), [128, 64], 0.0,
                      2.0 / 128),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_statistics(name):
    """Mean and variance of a draw, in both packages, within 5 standard
    errors of the distribution's (exact for Constant); the draw lies in
    its support; dtype and shape as asked."""
    make, shape, mean, var = INITS[name]
    for P in (jpaddle, tpaddle):
        P.seed(3)
        v = P.nn.Layer().create_parameter(
            shape, attr=P.ParamAttr(initializer=make(P.nn.initializer)))
        assert v.shape == shape and v.dtype.name == "float32"
        a = v.numpy().astype(np.float64)
        n = a.size
        assert abs(a.mean() - mean) <= 5 * np.sqrt(var / n) + 1e-7
        assert abs(a.var() - var) <= 0.05 * var + 1e-7
        if name == "TruncatedNormal":
            assert np.abs(a).max() <= 2.0
    tpaddle.seed(3)
    first = make(tpaddle.nn.initializer)(shape, "float32")
    tpaddle.seed(3)
    np.testing.assert_array_equal(
        make(tpaddle.nn.initializer)(shape, "float32").numpy(),
        first.numpy())


def test_assign_orthogonal_and_gain():
    I = tpaddle.nn.initializer
    a = I.Assign(np.arange(6, dtype=np.float32))([2, 3], "float32")
    np.testing.assert_array_equal(a.numpy(), np.arange(6).reshape(2, 3))
    q = I.Orthogonal(gain=2.0)([16, 16], "float32").numpy()
    np.testing.assert_allclose(q.T @ q, 4 * np.eye(16), atol=1e-5)
    for nl, p in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("linear", None)):
        assert I.calculate_gain(nl, p) == \
            jpaddle.nn.initializer.calculate_gain(nl, p)


# ---- optimizers keep training a Parameter ---------------------------------

def test_optimizer_trains_parameter_after_set_state_dict_set_value_astype():
    """The optimizer resolves each Parameter's value at step(): loading a
    state dict, set_value (both in place) and astype (a rebind to a new
    leaf) leave the layer training, and clear_grad clears its grads."""
    layer = tpaddle.nn.Linear(4, 3)
    opt = tpaddle.optimizer.AdamW(learning_rate=0.1,
                                  parameters=layer.parameters())
    x = tpaddle.to_tensor(_f(5, 4))

    def step():
        before = layer.weight.numpy().copy()
        layer(x).sum().backward()
        opt.step()
        assert layer.weight.grad is not None
        opt.clear_grad()
        assert layer.weight.grad is None and layer.bias.grad is None
        return before, layer.weight.numpy()

    w0 = _f(4, 3, seed=5)
    layer.set_state_dict({"weight": w0, "bias": np.zeros(3, np.float32)})
    before, after = step()
    np.testing.assert_array_equal(before, w0)
    assert np.abs(after - w0).min() > 0.05
    layer.weight.set_value(np.full((4, 3), 2.0, np.float32))
    before, after = step()
    np.testing.assert_array_equal(before, np.full((4, 3), 2.0))
    assert np.abs(after - 2.0).min() > 0.05
    layer.astype("float64")
    x = x.astype("float64")
    before, after = step()
    assert after.dtype == np.float64 and np.abs(after - before).min() > 0.05


# ---- attention: masks, dropout, the kernel's views ------------------------

def _qkv(b=2, s=12, hq=4, hkv=2, d=16):
    return (_f(b, s, hq, d, seed=1), _f(b, s, hkv, d, seed=2),
            _f(b, s, hkv, d, seed=3))


MASKS = {
    "bool": lambda b, h, s: np.random.RandomState(5).rand(b, 1, s, s) > 0.3,
    "float": lambda b, h, s: np.where(np.random.RandomState(6).rand(
        1, h, s, s) > 0.5, 0.0, -1e9).astype(np.float32) + _f(1, h, s, s),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", sorted(MASKS))
def test_sdpa_attn_mask_matches_jax(kind, causal):
    q, k, v = _qkv()
    mask = MASKS[kind](2, 4, 12)
    if kind == "bool":
        mask[..., 0] = True             # every row sees a key
    outs = {}
    for name, P in (("jax", jpaddle), ("port", tpaddle)):
        ts = [P.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        out = P.nn.functional.scaled_dot_product_attention(
            *ts, attn_mask=P.to_tensor(mask), is_causal=causal)
        (out * P.to_tensor(_f(*out.shape, seed=8))).sum().backward()
        outs[name] = [out.numpy()] + [t.grad.numpy() for t in ts]
    for w, g in zip(outs["jax"], outs["port"]):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_sdpa_matches_jax_without_mask():
    """No mask: the port's CPU route is the flash kernels' plain version,
    JAX's its XLA composite; outputs and gradients agree."""
    q, k, v = _qkv(d=64)
    outs = {}
    for name, P in (("jax", jpaddle), ("port", tpaddle)):
        ts = [P.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        out = P.nn.functional.scaled_dot_product_attention(*ts,
                                                           is_causal=True)
        (out * P.to_tensor(_f(*out.shape, seed=8))).sum().backward()
        outs[name] = [out.numpy()] + [t.grad.numpy() for t in ts]
    for w, g in zip(outs["jax"], outs["port"]):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_sdpa_dropout_keep_rate_and_eval_identity():
    F = tpaddle.nn.functional
    q, k, v = (tpaddle.to_tensor(a) for a in _qkv(b=4, s=64, d=32))
    plain = F.scaled_dot_product_attention(q, k, v, is_causal=True).numpy()
    ev = F.scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                        is_causal=True, training=False)
    np.testing.assert_allclose(ev.numpy(), plain, **TOL)
    tpaddle.seed(2)
    dr = F.scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                        is_causal=True).numpy()
    kept = dr != 0
    assert abs(kept.mean() - 0.75) < 0.02
    np.testing.assert_allclose(dr[kept], plain[kept] / 0.75, **TOL)
    tq = torch.from_numpy(q.numpy())
    with pytest.raises(NotImplementedError):   # the torch-level seam
        F.scaled_dot_product_attention(tq, tq, tq, dropout_p=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,heads", [(256, 4), (768, 12)])
def test_paddle_sdpa_hands_the_kernel_views_it_takes(monkeypatch, hidden,
                                                     heads, dtype):
    """GPT's q, k, v are [B, S, H, 64] views of the packed QKV projection
    (strides S*3h, 3h, 64, 1): the Paddle-level attention passes them to
    FlashAttention as they are, and they meet the forward kernel's view
    rule (``flash_attention.check_view``) at the chip phases' widths."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    seen = []
    real = fa.FlashAttention.apply

    def spy(q, k, v, *rest):
        seen.append((q, k, v))
        return real(q, k, v, *rest)

    monkeypatch.setattr(fa.FlashAttention, "apply", spy)
    b, s = 2, 16
    packed = tpaddle.to_tensor(_f(b, s, 3 * hidden), dtype=dtype,
                               stop_gradient=False)
    q, k, v = (t.reshape([b, s, heads, hidden // heads])
               for t in packed.chunk(3, axis=-1))
    tpaddle.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True).sum().backward()
    (tq, tk, tv), = seen
    for name, t in (("q", tq), ("k", tk), ("v", tv)):
        assert t.stride() == (s * 3 * hidden, 3 * hidden, 64, 1)
        fa.check_view(name, t)
    assert tk.data_ptr() - tq.data_ptr() == hidden * tq.element_size()
    assert packed.grad.shape == [b, s, 3 * hidden]
