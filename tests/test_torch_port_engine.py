"""The port's auto-parallel ``Engine`` against the JAX package's on the
CPU: ``fit``/``evaluate``/``predict`` on ``tests/test_engine_logging.py``'s
``Reg`` net from the same weights give JAX's history within 1e-5 (the
JAX Engine over its dp 8 mesh, the port's in one process: both mean the
global batch); ``save``/``load`` round-trips the parameters and the Adam
moments bit for bit and continues the step count, and each package
loads the other's file; a one-shot iterator over epochs warns and is
materialised, as there."""
import warnings

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev


def _data(n=32):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 8).astype(np.float32)
    w = rng.randn(8, 1).astype(np.float32)
    return x, (x @ w + 0.05 * rng.randn(n, 1)).astype(np.float32)


def _pkg_parts(pkg):
    nn, F, io = pkg.nn, pkg.nn.functional, pkg.io

    class ToyDs(io.Dataset):
        def __init__(self, n=32):
            self.x, self.y = _data(n)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

        def __len__(self):
            return len(self.x)

    class XOnly(io.Dataset):
        def __init__(self):
            self.x = _data(8)[0]

        def __getitem__(self, i):
            return self.x[i]

        def __len__(self):
            return len(self.x)

    class Reg(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 1)

        def forward(self, x):
            return self.fc2(F.relu(self.fc1(x)))

    return ToyDs, XOnly, Reg, lambda o, l: F.mse_loss(o, l)


def _weights(seed=0):
    jpaddle.seed(seed)
    _, _, Reg, _ = _pkg_parts(jpaddle)
    return {k: np.asarray(v._value) for k, v in Reg().state_dict().items()}


def _engine(pkg, weights):
    from importlib import import_module

    ToyDs, XOnly, Reg, loss = _pkg_parts(pkg)
    model = Reg()
    model.set_state_dict(weights)
    opt = pkg.optimizer.Adam(learning_rate=0.01,
                             parameters=model.parameters())
    Engine = import_module(pkg.__name__ + ".distributed.auto_parallel."
                           "static").Engine
    return Engine(model=model, loss=loss, optimizer=opt), model, opt, \
        ToyDs, XOnly


def test_fit_evaluate_predict_equal_jax():
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh

    w = _weights()
    hist, ev, preds = {}, {}, {}
    for pkg in (jpaddle, tpaddle):
        eng, _, _, ToyDs, XOnly = _engine(pkg, w)
        DL = pkg.io.DataLoader
        if pkg is jpaddle:
            build_mesh({"dp": 8})
        try:
            hist[pkg] = eng.fit(DL(ToyDs(), batch_size=8),
                                valid_data=DL(ToyDs(), batch_size=8),
                                epochs=3, verbose=0)
            ev[pkg] = eng.evaluate(DL(ToyDs(), batch_size=8), verbose=0)
            preds[pkg] = eng.predict(DL(XOnly(), batch_size=8))
        finally:
            set_mesh(None)
    h, jh = hist[tpaddle], hist[jpaddle]
    assert set(h) == set(jh) == {"loss", "val_loss"}
    for k in h:
        np.testing.assert_allclose(h[k], jh[k], rtol=1e-5, atol=0)
    assert h["loss"][2] < h["loss"][1] < h["loss"][0]
    np.testing.assert_allclose(ev[tpaddle]["loss"], ev[jpaddle]["loss"],
                               rtol=1e-5)
    assert len(preds[tpaddle]) == 1 and preds[tpaddle][0].shape == [8, 1]
    np.testing.assert_allclose(preds[tpaddle][0].numpy(),
                               np.asarray(preds[jpaddle][0]._value),
                               rtol=1e-5, atol=1e-6)


def test_fit_on_a_dataset_and_steps_limits():
    eng, _, _, ToyDs, _ = _engine(tpaddle, _weights())
    hist = eng.fit(ToyDs(), batch_size=8, epochs=2, steps_per_epoch=2,
                   verbose=0)
    assert len(hist["loss"]) == 2
    assert eng.evaluate(ToyDs(), batch_size=16, steps=1,
                        verbose=0)["loss"] > 0
    assert eng.main_program is not None


def test_one_shot_iterator_warns_and_is_reiterated():
    eng, *_ = _engine(tpaddle, _weights())
    x, y = _data(16)
    batches = iter([(tpaddle.to_tensor(x[i:i + 8]),
                     tpaddle.to_tensor(y[i:i + 8])) for i in (0, 8)])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        hist = eng.fit(batches, epochs=2, verbose=0)
    assert any("one-shot iterator" in str(r.message) for r in rec)
    assert all(v is not None for v in hist["loss"])


def _np(v):
    v = getattr(v, "_value", v)
    return v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)


def _state(eng, opt):
    sd = {k: _np(v) for k, v in eng._dist.state_dict().items()}
    return sd, opt.state_dict()


def _assert_same_state(a, b):
    sd1, os1 = a
    sd2, os2 = b
    for k in sd1:
        np.testing.assert_array_equal(sd2[k], sd1[k])
    keys = [k for k in os1 if k.startswith("param_")]
    assert keys
    for k in keys:
        for sk in os1[k]:
            np.testing.assert_array_equal(np.asarray(os2[k][sk]),
                                          np.asarray(os1[k][sk]))
    assert os2["step"] == os1["step"] > 0


def test_save_load_round_trips_and_continues(tmp_path):
    eng, model, opt, ToyDs, _ = _engine(tpaddle, _weights())
    eng.fit(tpaddle.io.DataLoader(ToyDs(), batch_size=8), epochs=1,
            verbose=0)
    path = str(tmp_path / "ck")
    eng.save(path)
    assert (tmp_path / "ck.pdparams").exists()
    eng2, model2, opt2, _, _ = _engine(tpaddle, _weights(seed=1))
    eng2.load(path)
    _assert_same_state(_state(eng, opt), _state(eng2, opt2))
    x, y = _data(8)
    eng2._dist.train()
    eng2._dist(tpaddle.to_tensor(x), tpaddle.to_tensor(y))
    assert opt2.state_dict()["step"] == opt.state_dict()["step"] + 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_engine_file(tmp_path, writer):
    engines = {}
    for pkg in (jpaddle, tpaddle):
        eng, _, opt, ToyDs, _ = _engine(pkg, _weights())
        engines[pkg] = (eng, opt, ToyDs)
    src, dst = ((jpaddle, tpaddle) if writer == "jax"
                else (tpaddle, jpaddle))
    eng, opt, ToyDs = engines[src]
    eng.fit(src.io.DataLoader(ToyDs(), batch_size=8), epochs=1, verbose=0)
    if src is jpaddle:
        eng._dist._sync()
    path = str(tmp_path / "ck")
    eng.save(path)
    other, opt2, _ = engines[dst]
    other.load(path)
    _assert_same_state(_state(eng, opt), _state(other, opt2))
