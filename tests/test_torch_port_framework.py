"""The port's ``framework`` (``save``/``load``, ``iinfo``/``finfo``, the
RNG state, ``summary``/``flops``) and ``metric`` against the JAX
package's on the CPU.

Files: what ``paddle_tpu_torch.save`` writes, ``paddle_tpu.load`` reads,
and the other way round, bit for bit (fp32, bf16, fp8, int64, nested
dicts, lists and tuples, ``stop_gradient``); with ``ml_dtypes`` hidden
from the port (as on a machine without JAX) its bf16 and fp8 still
round-trip both ways. The port's ``load`` refuses a pickle that names
any global beyond numpy's arrays, dtypes and scalars. ``summary``'s
counts and ``flops`` equal JAX's (XLA's cost analysis) on MLPs, as a
Paddle-API ``Layer`` and as a ``torch.nn.Module``; the metrics equal
JAX's over the same batches, exactly.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.framework import io_ as tio


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev


def _values(seed=0):
    r = np.random.RandomState(seed)
    f32 = r.randn(3, 5).astype(np.float32)
    return {
        "f32": f32,
        "bf16": torch.from_numpy(f32).to(torch.bfloat16),
        "e4m3": torch.from_numpy(f32).to(torch.float8_e4m3fn),
        "e5m2": torch.from_numpy(f32).to(torch.float8_e5m2),
        "i64": r.randint(-9, 9, (4, 2)).astype(np.int64),
    }


def _bits(x):
    """An array's bytes and dtype name, from either package's leaf."""
    if hasattr(x, "_value"):
        x = x._value
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        name = str(x.dtype).removeprefix("torch.")
        size = x.element_size()
        raw = x.contiguous().view(torch.uint8 if size == 1 else
                                  {2: torch.int16, 4: torch.int32,
                                   8: torch.int64}[size]).numpy().tobytes()
        return name, tuple(x.shape), raw
    x = np.asarray(x)
    return x.dtype.name, x.shape, np.ascontiguousarray(x).tobytes()


def _port_tree(v):
    T = tpaddle.Tensor
    return {"model": {"w": T(torch.from_numpy(v["f32"]).requires_grad_()),
                      "b": v["bf16"], "e4": v["e4m3"], "e5": v["e5m2"]},
            "ids": [T(torch.from_numpy(v["i64"])), (1, "two", 3.0)],
            "step": 7, "np": v["f32"] * 2}


def _jax_tree(v):
    import ml_dtypes

    T = jpaddle.Tensor
    f = v["f32"]
    return {"model": {"w": T(f, stop_gradient=False),
                      "b": T(f.astype(ml_dtypes.bfloat16)),
                      "e4": T(f.astype(ml_dtypes.float8_e4m3fn)),
                      "e5": T(f.astype(ml_dtypes.float8_e5m2))},
            "ids": [T(v["i64"]), (1, "two", 3.0)],
            "step": 7, "np": f * 2}


def _check_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _check_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _check_same(x, y)
    elif hasattr(a, "_value") or isinstance(a, (np.ndarray, torch.Tensor)):
        assert _bits(a) == _bits(b)
        if hasattr(a, "stop_gradient") and hasattr(b, "stop_gradient"):
            assert a.stop_gradient == b.stop_gradient
    else:
        assert a == b


@pytest.mark.parametrize("ml", [True, False], ids=["ml_dtypes", "no_ml"])
def test_port_file_loads_in_jax_bit_equal(tmp_path, monkeypatch, ml):
    if not ml:
        monkeypatch.setattr(tio, "_ml_dtypes", lambda: None)
    v = _values()
    path = str(tmp_path / "port.pdparams")
    tpaddle.save(_port_tree(v), path)
    got = jpaddle.load(path)
    _check_same(_jax_tree(v), got)
    assert got["model"]["w"].stop_gradient is False


@pytest.mark.parametrize("ml", [True, False], ids=["ml_dtypes", "no_ml"])
def test_jax_file_loads_in_port_bit_equal(tmp_path, monkeypatch, ml):
    if not ml:
        monkeypatch.setattr(tio, "_ml_dtypes", lambda: None)
    v = _values(1)
    path = str(tmp_path / "jax.pdparams")
    jpaddle.save(_jax_tree(v), path)
    got = tpaddle.load(path)
    _check_same(_port_tree(v), got)
    assert isinstance(got["model"]["b"], tpaddle.Tensor)
    assert got["model"]["b"]._value.dtype == torch.bfloat16
    raw = tpaddle.load(path, return_numpy=True)
    b = raw["model"]["b"]
    assert (isinstance(b, np.ndarray) and b.dtype.name == "bfloat16") if ml \
        else (isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16)
    _check_same(_port_tree(v)["model"]["b"], b)


@pytest.mark.parametrize("ml", [True, False], ids=["ml_dtypes", "no_ml"])
def test_port_round_trip_and_fortran_arrays(tmp_path, monkeypatch, ml):
    if not ml:
        monkeypatch.setattr(tio, "_ml_dtypes", lambda: None)
    v = _values(2)
    tree = _port_tree(v)
    tree["fortran"] = np.asfortranarray(np.arange(12.).reshape(3, 4))
    tree["scalar"] = np.float32(1.5)
    path = str(tmp_path / "rt.pdparams")
    tpaddle.save(tree, path)
    _check_same(tree, tpaddle.load(path))
    jpaddle.save({"f": np.asfortranarray(np.arange(6).reshape(2, 3))}, path)
    np.testing.assert_array_equal(tpaddle.load(path, return_numpy=True)["f"],
                                  np.arange(6).reshape(2, 3))


def test_load_refuses_code_in_the_pickle(tmp_path):
    class _Evil:
        def __reduce__(self):
            return (os.getpid, ())

    path = str(tmp_path / "evil.pdparams")
    with open(path, "wb") as fh:
        pickle.dump({"x": _Evil()}, fh, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match="posix.getpid"):
        tpaddle.load(path)
    # the JAX package's own loader runs it (the deliberate difference)
    assert jpaddle.load(path)["x"] == os.getpid()


def test_load_places_tensors_on_the_current_device(tmp_path):
    path = str(tmp_path / "p.pdparams")
    tpaddle.save({"w": torch.ones(2)}, path)
    got = tpaddle.load(path)["w"]
    assert got._value.device.type == "cpu" and got.stop_gradient


@pytest.mark.parametrize("name", ["int8", "int16", "int32", "int64", "uint8"])
def test_iinfo_equals_jax(name):
    a, b = tpaddle.iinfo(name), jpaddle.iinfo(name)
    assert (a.min, a.max, a.bits, a.dtype) == (b.min, b.max, b.bits, b.dtype)


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32",
                                  "float64"])
def test_finfo_equals_jax(name):
    a, b = tpaddle.finfo(name), jpaddle.finfo(name)
    for k in ("min", "max", "eps", "tiny", "smallest_normal", "resolution",
              "bits", "dtype"):
        assert getattr(a, k) == getattr(b, k), k


def test_build_queries_and_default_dtype():
    fw = tpaddle.framework
    assert fw.is_compiled_with_cuda() == torch.cuda.is_available()
    assert not fw.is_compiled_with_rocm() and not fw.is_compiled_with_xpu()
    assert not fw.is_compiled_with_custom_device("gpu")
    assert fw.in_dynamic_mode() and tpaddle.in_dynamic_mode()
    prev = fw.get_default_dtype()
    fw.set_default_dtype("float64")
    try:
        assert fw.get_default_dtype() == "float64"
    finally:
        fw.set_default_dtype(prev)
    with tpaddle.LazyGuard() as g:
        assert g is not None
    assert tpaddle.get_flags("use_fused_head_loss") == {
        "use_fused_head_loss": True}


def test_rng_state_round_trip():
    tpaddle.seed(11)
    tpaddle.randn([4])
    state = tpaddle.get_rng_state()
    a = tpaddle.randn([6]).numpy()
    b = tpaddle.randn([6]).numpy()
    tpaddle.set_rng_state(state)
    np.testing.assert_array_equal(tpaddle.randn([6]).numpy(), a)
    np.testing.assert_array_equal(tpaddle.randn([6]).numpy(), b)
    # a state taken before any draw replays from the seed
    tpaddle.seed(5)
    fresh = tpaddle.get_cuda_rng_state()
    c = tpaddle.randn([3]).numpy()
    tpaddle.randn([3])
    tpaddle.set_cuda_rng_state(fresh)
    np.testing.assert_array_equal(tpaddle.randn([3]).numpy(), c)


def test_set_printoptions_reaches_the_tensor_repr():
    old = np.get_printoptions()
    try:
        tpaddle.set_printoptions(precision=2)
        assert "0.33" in repr(tpaddle.to_tensor([1 / 3]))
        assert "0.333" not in repr(tpaddle.to_tensor([1 / 3]))
    finally:
        np.set_printoptions(**old)


def _mlp(pkg, widths):
    nn, F = pkg.nn, pkg.nn.functional

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fcs = nn.LayerList([nn.Linear(a, b) for a, b in
                                     zip(widths[:-1], widths[1:])])
            self.scale = self.create_parameter([widths[-1]])
            self.scale.stop_gradient = True

        def forward(self, x):
            for i, fc in enumerate(self.fcs):
                x = fc(x)
                if i < len(self.fcs) - 1:
                    x = F.relu(x)
            return x * self.scale

    return MLP()


def _nets(widths):
    """The same MLP (ReLU between linears) in both packages' Paddle API."""
    return _mlp(jpaddle, widths), _mlp(tpaddle, widths)


@pytest.mark.parametrize("widths,batch", [([8, 16, 1], 8),
                                          ([12, 32, 32, 4], 5)])
def test_summary_and_flops_equal_jax(widths, batch, capsys):
    jnet, tnet = _nets(widths)
    assert tpaddle.summary(tnet) == jpaddle.summary(jnet)
    out = capsys.readouterr().out
    assert "Non-trainable params: " + f"{widths[-1]:,}" in out
    assert tpaddle.flops(tnet, [batch, widths[0]]) == \
        jpaddle.flops(jnet, [batch, widths[0]])


def test_summary_and_flops_on_a_torch_module():
    jnet, _ = _nets([8, 16, 1])
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 1))
    want = jpaddle.summary(jnet)["total_params"] - 1   # jnet's scale
    assert tpaddle.summary(tnet) == {"total_params": want,
                                     "trainable_params": want}
    # XLA counts the scale's multiply: 8 more than the torch net
    assert tpaddle.flops(tnet, [8, 8]) == jpaddle.flops(jnet, [8, 8]) - 8


def _metric_batches():
    r = np.random.RandomState(3)
    out = []
    for n in (6, 9, 4):
        logits = r.randn(n, 5).astype(np.float32)
        logits[0, 1] = logits[0, 2]          # a tie
        out.append((logits, r.randint(0, 5, (n, 1)).astype(np.int64),
                    r.rand(n, 1).astype(np.float32),
                    r.randint(0, 2, (n, 1)).astype(np.int64)))
    return out


def test_metrics_equal_jax():
    jm, tm = jpaddle.metric, tpaddle.metric
    jacc, tacc = jm.Accuracy(topk=(1, 2)), tm.Accuracy(topk=(1, 2))
    jp, tp = jm.Precision(), tm.Precision()
    jr, tr = jm.Recall(), tm.Recall()
    for logits, lab, prob, binl in _metric_batches():
        jc = jacc.compute(jpaddle.to_tensor(logits), jpaddle.to_tensor(lab))
        tc = tacc.compute(tpaddle.to_tensor(logits), tpaddle.to_tensor(lab))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._value))
        assert tacc.update(tc) == jacc.update(jc)
        jp.update(jpaddle.to_tensor(prob), jpaddle.to_tensor(binl))
        tp.update(tpaddle.to_tensor(prob), tpaddle.to_tensor(binl))
        jr.update(prob, binl)
        tr.update(torch.from_numpy(prob), torch.from_numpy(binl))
        for k in (1, 2, 3):
            a = float(tm.accuracy(tpaddle.to_tensor(logits),
                                  tpaddle.to_tensor(lab), k=k).numpy())
            b = float(np.asarray(jm.accuracy(jpaddle.to_tensor(logits),
                                             jpaddle.to_tensor(lab),
                                             k=k)._value))
            assert a == b, k
    assert tacc.accumulate() == jacc.accumulate()
    assert (tp.accumulate(), tr.accumulate()) == (jp.accumulate(),
                                                  jr.accumulate())
    assert (tacc.name(), tp.name(), tr.name()) == (jacc.name(), jp.name(),
                                                   jr.name())
    for m in (tacc, tp, tr):
        m.reset()
    assert tp.accumulate() == 0.0 and tacc.accumulate() == [0.0, 0.0]
