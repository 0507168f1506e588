"""The port's Paddle eager API (``paddle_tpu_torch``: ``Tensor``, the tape,
``paddle.grad``, ``PyLayer``, jacobian/hessian/jvp/vjp) against the JAX
package on the CPU: the cases of ``tests/test_tensor_autograd.py``, each run
on both packages from the same seeded numpy inputs, their results compared
value for value (fp32 within 1e-5) and held to the analytic values the JAX
test states; then the semantics torch does differently (an integer tensor
that does not stop gradients, non-leaf ``grad`` and ``retain_grads``,
``stop_gradient`` set on an op's output, hooks, post-backward callbacks),
each held to what ``paddle_tpu`` does."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle

PACKAGES = {"jax": jpaddle, "port": tpaddle}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev


def _np(x):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), dtype=np.float64) \
            if x.numpy().dtype.kind in "fc" else x.numpy()
    return np.asarray(x)


def _t(paddle, arr, sg=True):
    return paddle.to_tensor(np.asarray(arr, np.float32), stop_gradient=sg)


# ---- the JAX test's cases, as functions of the package -------------------

def case_to_tensor_roundtrip(paddle):
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert x.shape == [2, 2] and x.dtype == paddle.float32
    return {"x": x}


def case_dtypes(paddle):
    x = paddle.to_tensor([1.0], dtype="bfloat16")
    return {"int": paddle.to_tensor([1, 2]).dtype.name,
            "float": paddle.to_tensor([1.0]).dtype.name,
            "bool": paddle.to_tensor([True]).dtype.name,
            "bf16": x.dtype.name, "bf16_is": x.dtype == paddle.bfloat16,
            "np_f64": paddle.to_tensor(np.array([1.0])).dtype.name,
            "np_i32": paddle.to_tensor(np.array([1], np.int32)).dtype.name,
            "np_scalar_f32": paddle.to_tensor(np.float32(2.0)).dtype.name}


def case_arith_dunders(paddle):
    a, b = _t(paddle, [1.0, 2.0]), _t(paddle, [3.0, 4.0])
    return {"add": a + b, "mul": a * b, "div": b / a, "sub1": a - 1,
            "rsub": 2 - a, "pow": a ** 2, "neg": -a, "radd": 1.5 + a,
            "rmul": 3 * a, "rdiv": 1 / a, "lt": a < b, "ge": a >= 2.0,
            "eq": a == 2.0, "mod": b % 2.5, "floordiv": b // 1.5,
            "matmul": a @ b, "int_times_float": paddle.to_tensor([3, 4])
            * 2.5, "int_div": paddle.to_tensor([3, 4]) / paddle.to_tensor(
                [2, 8])}


def case_getitem_setitem(paddle):
    x = _t(paddle, np.arange(12).reshape(3, 4))
    row, col = x[1], x[:, 1]
    x[0, 0] = 99.0
    x[2] = _t(paddle, [7.0, 7.0, 7.0, 7.0])
    return {"row": row, "col": col, "after": x, "x00": float(x[0, 0]),
            "fancy": x[[0, 2]], "mask": x[x > 5.0], "neg": x[-1, ::2]}


def case_item_and_shape(paddle):
    x = _t(paddle, 3.5)
    return {"item": x.item(), "ndim": x.ndim,
            "size": _t(paddle, [[1, 2]]).size, "len": len(_t(paddle, [1, 2]))}


def case_simple_backward(paddle):
    x = _t(paddle, [2.0, 3.0], sg=False)
    (x * x).sum().backward()
    return {"grad": x.grad}


def case_chain(paddle):
    x = _t(paddle, [1.0], sg=False)
    paddle.exp(paddle.sin(x)).backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               [np.exp(np.sin(1.0)) * np.cos(1.0)], rtol=1e-6)
    return {"grad": x.grad}


def case_branching_accumulation(paddle):
    x = _t(paddle, [1.0, 2.0], sg=False)
    a, b = x * 2, x * 3
    (a + b).sum().backward()
    return {"grad": x.grad}


def case_grad_accumulates_across_backwards(paddle):
    x = _t(paddle, [1.0], sg=False)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    g = x.grad
    x.clear_grad()
    return {"grad": g, "cleared": x.grad}


def case_stop_gradient_blocks(paddle):
    x, y = _t(paddle, [1.0], sg=False), _t(paddle, [2.0], sg=True)
    (x * y).sum().backward()
    return {"y_grad": y.grad, "x_grad": x.grad}


def case_detach(paddle):
    x = _t(paddle, [1.0], sg=False)
    d = (x * 2).detach()
    (x * 2 + d).sum().backward()
    return {"d_sg": d.stop_gradient, "grad": x.grad}


def case_no_grad_context(paddle):
    x = _t(paddle, [1.0], sg=False)
    with paddle.no_grad():
        y = x * 2

    @paddle.no_grad()
    def f(v):
        return v * 3

    z = f(x)
    return {"y_node": y._grad_node is None, "y_sg": y.stop_gradient,
            "z_sg": z.stop_gradient, "after": (x * 2).stop_gradient}


def case_retain_graph(paddle):
    x = _t(paddle, [1.0], sg=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    return {"grad": x.grad}


def case_double_backward_without_retain_raises(paddle):
    x = _t(paddle, [1.0], sg=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()
    z = x.sum()                         # a graph that saved no tensor
    z.backward()
    with pytest.raises(RuntimeError):
        z.backward()
    x.backward(paddle.to_tensor(np.ones(1, np.float32)))  # a leaf: again
    x.backward(paddle.to_tensor(np.ones(1, np.float32)))
    return {"grad": x.grad}


def case_backward_errors(paddle):
    x = _t(paddle, [1.0, 2.0], sg=False)
    with pytest.raises(RuntimeError):
        (x * 2).backward()                  # a non-scalar needs a seed
    with pytest.raises(RuntimeError):
        _t(paddle, [1.0]).sum().backward()  # stop_gradient output
    return {}


def case_non_scalar_backward_with_grad(paddle):
    x = _t(paddle, [1.0, 2.0], sg=False)
    (x * 3).backward(grad_tensor=paddle.to_tensor(
        np.array([1.0, 10.0], np.float32)))
    return {"grad": x.grad}


def case_multi_output_op(paddle):
    x = _t(paddle, np.arange(6).reshape(2, 3), sg=False)
    a, b = paddle.split(x, 2, axis=0)
    (a.sum() * 2 + b.sum() * 3).backward()
    return {"grad": x.grad}


def case_matmul_grad(paddle):
    rng = np.random.RandomState(0)
    a_np, b_np = (rng.randn(3, 4).astype(np.float32),
                  rng.randn(4, 5).astype(np.float32))
    a, b = _t(paddle, a_np, sg=False), _t(paddle, b_np, sg=False)
    paddle.matmul(a, b).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(),
                               b_np.sum(1, keepdims=True).T.repeat(3, 0),
                               rtol=1e-5)
    c = _t(paddle, rng.randn(5, 4), sg=False)
    paddle.matmul(a, c, transpose_y=True).sum().backward()
    return {"a": a.grad, "b": b.grad, "c": c.grad}


def case_register_hook(paddle):
    x = _t(paddle, [1.0], sg=False)
    seen = []
    x.register_hook(lambda g: seen.append(np.asarray(g)) or None)
    (x * 2).sum().backward()
    assert len(seen) == 1
    y = _t(paddle, [1.0, 2.0], sg=False)
    h = y.register_hook(lambda g: g * 10)
    (y * y).sum().backward()
    h.remove()
    return {"seen": seen[0], "scaled": y.grad}


def case_paddle_grad_api(paddle):
    x = _t(paddle, [2.0], sg=False)
    (g,) = paddle.grad((x ** 3).sum(), [x])
    y = _t(paddle, [1.0], sg=False)
    z = _t(paddle, [5.0], sg=False)
    with pytest.raises(RuntimeError):
        paddle.grad((y * 2).sum(), [y, z])
    g2 = paddle.grad((y * 2).sum(), [y, z], allow_unused=True)
    return {"g": g, "x_grad": x.grad, "unused": g2[1], "used": g2[0]}


def case_pylayer(paddle):
    from importlib import import_module

    PyLayer = import_module(f"{paddle.__name__}.autograd").PyLayer

    class Double(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor
            return grad * 2 + x * 0

    class Split(PyLayer):
        @staticmethod
        def forward(ctx, x, scale):
            return x * scale, x + 1

        @staticmethod
        def backward(ctx, ga, gb):
            return ga * 3 + gb

    x = _t(paddle, [3.0], sg=False)
    y = Double.apply(x)
    y.sum().backward()
    u = _t(paddle, [1.0, 2.0], sg=False)
    a, b = Split.apply(u, 3.0)
    (a.sum() + 2 * b.sum()).backward()
    return {"y": y, "grad": x.grad, "a": a, "b": b, "u_grad": u.grad}


def case_jacobian(paddle):
    from importlib import import_module

    A = import_module(f"{paddle.__name__}.autograd")
    x = _t(paddle, [1.0, 2.0], sg=False)
    J = A.jacobian(lambda v: v * v, x)
    np.testing.assert_allclose(J.numpy(), np.diag([2.0, 4.0]))
    return {"J": J}


def case_hessian(paddle):
    from importlib import import_module

    A = import_module(f"{paddle.__name__}.autograd")
    x = _t(paddle, [1.0, 2.0], sg=False)
    H = A.hessian(lambda v: (v ** 3).sum(), x)
    np.testing.assert_allclose(H.numpy(), np.diag([6.0, 12.0]))
    return {"H": H}


def case_jvp_vjp(paddle):
    from importlib import import_module

    A = import_module(f"{paddle.__name__}.autograd")
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randn(4).astype(np.float32))
    v = rng.randn(4).astype(np.float32)
    w = rng.randn(4).astype(np.float32)

    def f(t):
        return paddle.tanh(t * 2.0)

    out, jv = A.jvp(f, x, paddle.to_tensor(v))
    _, jtw = A.vjp(f, x, paddle.to_tensor(w))
    np.testing.assert_allclose(float(np.dot(jv.numpy(), w)),
                               float(np.dot(v, jtw.numpy())), rtol=1e-5)
    x2 = paddle.to_tensor(np.array([1.0, 2.0], np.float32))
    o2, tang = A.jvp(lambda t: (t.sum(), (t * t).sum()), x2,
                     paddle.to_tensor(np.array([1.0, 1.0], np.float32)))
    _, g = A.vjp(lambda t: (t.sum(), (t * t).sum()), x2,
                 [paddle.to_tensor(np.float32(1.0)),
                  paddle.to_tensor(np.float32(0.5))])
    _, g1 = A.vjp(lambda t: (t ** 3).sum(),
                  paddle.to_tensor(np.array([1.0, 2.0, 3.0], np.float32)))
    return {"out": out, "jv": jv, "jtw": jtw, "o2": o2, "tang": tang,
            "g": g, "g1": g1}


# ---- what torch does differently, held to paddle_tpu ---------------------

def case_int_tensor_stop_gradient(paddle):
    ids = paddle.to_tensor(np.array([0, 2, 1], np.int64))
    ids.stop_gradient = False
    w = _t(paddle, np.arange(6).reshape(3, 2), sg=False)
    out = paddle.gather(w, ids)
    out.sum().backward()
    return {"ids_sg": ids.stop_gradient, "w_grad": w.grad}


def case_non_leaf_grad_and_retain(paddle):
    x = _t(paddle, [1.0, 2.0], sg=False)
    h = x * 3
    k = x * 5
    k.retain_grads()
    (h * k).sum().backward()
    return {"h_grad": h.grad, "k_grad": k.grad, "x_grad": x.grad,
            "h_leaf": h.is_leaf, "x_leaf": x.is_leaf}


def case_stop_gradient_on_output(paddle):
    x = _t(paddle, [1.0, 2.0], sg=False)
    h = x * 3
    h.stop_gradient = True
    (h * x).sum().backward()
    return {"x_grad": x.grad, "h_sg": h.stop_gradient}


def case_leaf_flag_flip(paddle):
    x = _t(paddle, [1.0, 2.0])
    x.stop_gradient = False
    (x * x).sum().backward()
    g = x.grad
    x.stop_gradient = True
    return {"grad": g, "sg": x.stop_gradient, "out_sg": (x * 2).stop_gradient}


def case_set_value_keeps_identity(paddle):
    x = _t(paddle, [1.0, 2.0], sg=False)
    x.set_value(np.array([5.0, 6.0], np.float32))
    (x * x).sum().backward()
    return {"x": x, "grad": x.grad}


def case_post_backward_callback(paddle):
    from importlib import import_module

    tape = import_module(f"{paddle.__name__}.autograd.tape")
    calls = []
    h = tape.register_post_backward_callback(lambda: calls.append("ok"))
    try:
        x = _t(paddle, [1.0], sg=False)
        (x * 2).sum().backward()
        paddle.grad((x * 3).sum(), [x])
    finally:
        h.remove()
    (x * 4).sum().backward()
    return {"calls": len(calls)}


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def _compare(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _compare(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _compare(w, g, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert want.shape == got.shape, path
        if want.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, err_msg=path, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax(name):
    want = _np(CASES[name](jpaddle))
    got = _np(CASES[name](tpaddle))
    _compare(want, got, name)


def test_default_device_is_the_card_and_raises_without_cuda():
    from paddle_tpu_torch.core import device

    prev = device._place
    device._place = device.CUDAPlace(0)      # the import-time default
    try:
        assert tpaddle.get_device() == "gpu:0"
        if torch.cuda.is_available():
            assert tpaddle.to_tensor([1.0]).place.is_gpu_place()
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tpaddle.to_tensor([1.0])
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tpaddle.set_device("gpu")
    finally:
        device._place = prev
    assert tpaddle.to_tensor([1.0]).place == tpaddle.CPUPlace()


def test_apply_op_amp_and_operator_stats():
    """apply_op passes the AMP seam under the op's JAX name: matmul is
    white-listed (bf16 under O1), exp black-listed (fp32), add neither;
    the operator stats count each op with its first input's dtype."""
    from paddle_tpu_torch.amp import debugging

    a = tpaddle.to_tensor(np.ones((2, 2), np.float32))
    debugging.enable_operator_stats_collection()
    try:
        with tpaddle.amp.auto_cast(level="O1"):
            m = tpaddle.matmul(a, a)
            e = tpaddle.exp(m)
            s = m + m
    finally:
        stats = debugging.disable_operator_stats_collection()
    assert m.dtype == tpaddle.bfloat16 and e.dtype == tpaddle.float32
    assert s.dtype == tpaddle.bfloat16
    assert stats["matmul"] == {"bfloat16": 1}
    assert stats["exp"] == {"float32": 1}
    assert stats["add"] == {"bfloat16": 1}


def test_tensor_checker_in_apply_op_matches_jax():
    """FLAGS_check_nan_inf makes every op check its outputs: a log of a
    negative number raises FloatingPointError naming the op in both
    packages (the flag's value and explicit bit restored after)."""
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags

    saved = [(f, f._REGISTRY["check_nan_inf"].value,
              f._REGISTRY["check_nan_inf"].explicit)
             for f in (jflags, tflags)]
    try:
        for P, f in ((jpaddle, jflags), (tpaddle, tflags)):
            f.set_flags({"FLAGS_check_nan_inf": True})
            x = _t(P, [1.0, -1.0])
            with pytest.raises(FloatingPointError, match="log"):
                P.log(x)
            assert float(P.exp(x).sum()) > 0
    finally:
        for f, value, explicit in saved:
            f._REGISTRY["check_nan_inf"].value = value
            f._REGISTRY["check_nan_inf"].explicit = explicit


def test_paddle_grad_create_graph_gives_a_differentiable_gradient():
    """`create_graph=True` (which the JAX package refuses, pointing at
    its functional transforms): the gradient of x^3 is 3x^2 and itself
    differentiable, 6x, as ``hessian`` gives it."""
    x = _t(tpaddle, [1.0, 2.0], sg=False)
    (g,) = tpaddle.grad((x ** 3).sum(), [x], create_graph=True)
    assert not g.stop_gradient
    (gg,) = tpaddle.grad(g.sum(), [x])
    np.testing.assert_allclose(g.numpy(), [3.0, 12.0], **TOL)
    np.testing.assert_allclose(gg.numpy(), [6.0, 12.0], **TOL)
    assert x.grad is None
    with pytest.raises(NotImplementedError):
        jpaddle.grad((_t(jpaddle, [1.0], sg=False) ** 3).sum(),
                     [_t(jpaddle, [1.0], sg=False)], create_graph=True)


def test_import_builds_nothing_and_exports_the_paddle_names():
    """Importing the package starts no thread and loads no kernel; the
    top-level names the Paddle API's users reach for are there."""
    import subprocess
    import sys

    code = ("import threading, paddle_tpu_torch as p\n"
            "from paddle_tpu_torch.ops.cuda import _build\n"
            "assert threading.active_count() == 1\n"
            "assert not _build._libs, _build._libs\n"
            "for n in ('to_tensor', 'seed', 'grad', 'no_grad', 'Tensor',\n"
            "          'float32', 'bfloat16', 'set_device', 'CUDAPlace',\n"
            "          'matmul', 'concat', 'ParamAttr'):\n"
            "    assert hasattr(p, n), n\n"
            "for n in ('Layer', 'Linear', 'LayerNorm', 'Embedding',\n"
            "          'Dropout', 'LayerList', 'functional'):\n"
            "    assert hasattr(p.nn, n), n\n"
            "assert p.optimizer.AdamW and p.autograd.PyLayer\n"
            "assert issubclass(p.nn.LayerNorm, p.nn.Layer)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
