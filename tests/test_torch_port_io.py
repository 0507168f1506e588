"""The port's data loading (``paddle_tpu_torch.io``) against the JAX
package's on the CPU: every sampler's indices equal JAX's for the same
numpy seed, batch for batch (``DistributedBatchSampler`` for each rank,
with shuffle, over epochs, with and without ``drop_last``, and its rank
and world read from the launch contract); ``random_split``, the
datasets, ``default_collate_fn`` and ``DataLoader`` batches are equal
(tuple, dict and tensor samples, iterable datasets); ``num_workers=2``
gives the batches ``num_workers=0`` gives, over the shared-memory
hand-off and the pickle, forked and spawned, with worker errors, deaths
and ``get_worker_info`` as there. Batches are the port's ``Tensor``s on
the loader's place (the CPU here)."""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.io as tio


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev


class _Rows:
    """A map-style dataset of (x, y) rows; `fail_at` raises there."""

    def __init__(self, base, n=23, fail_at=None):
        r = np.random.RandomState(0)
        self.x = r.randn(n, 3, 4).astype(np.float64)
        self.y = np.arange(n, dtype=np.int64)
        self.fail_at = fail_at

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad row {i}")
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _ds(pkg, **kw):
    return type("Rows", (_Rows, pkg.Dataset), {})(pkg, **kw)


def _np(x):
    v = getattr(x, "_value", x)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert set(x) == set(y)
            _same_batches([x[k] for k in sorted(x)],
                          [y[k] for k in sorted(y)])
        elif isinstance(x, (tuple, list)):
            _same_batches(x, y)
        else:
            xa, ya = _np(x), _np(y)
            assert xa.dtype == ya.dtype and xa.shape == ya.shape
            np.testing.assert_array_equal(xa, ya)


def _draw(make, seed=5):
    """The indices `make(pkg)` yields in each package from one seed."""
    out = []
    for pkg in (jio, tio):
        np.random.seed(seed)
        out.append([list(b) if isinstance(b, list) else b
                    for b in make(pkg)])
    return out


@pytest.mark.parametrize("kind", ["sequence", "random", "replacement",
                                  "num_samples", "int_generator",
                                  "weighted", "weighted_no_repl", "subset",
                                  "batch_shuffle", "batch_drop_last"])
def test_samplers_equal_jax(kind):
    def make(pkg):
        ds = list(range(17))
        if kind == "sequence":
            return pkg.SequenceSampler(ds)
        if kind == "random":
            return pkg.RandomSampler(ds)
        if kind == "replacement":
            return pkg.RandomSampler(ds, replacement=True, num_samples=30)
        if kind == "num_samples":
            return pkg.RandomSampler(ds, num_samples=9)
        if kind == "int_generator":
            return pkg.RandomSampler(ds, generator=7)
        if kind == "weighted":
            return pkg.WeightedRandomSampler(np.arange(1., 9.), 20)
        if kind == "weighted_no_repl":
            return pkg.WeightedRandomSampler(np.arange(1., 9.), 6,
                                             replacement=False)
        if kind == "subset":
            return pkg.SubsetRandomSampler([3, 5, 8, 13, 21])
        if kind == "batch_shuffle":
            return pkg.BatchSampler(ds, shuffle=True, batch_size=4)
        return pkg.BatchSampler(sampler=pkg.RandomSampler(ds), batch_size=5,
                                drop_last=True)

    a, b = _draw(make)
    assert a == b and len(a) > 0
    assert len(make(tio)) == len(make(jio))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("n,world", [(23, 4), (16, 4), (7, 3)])
def test_distributed_batch_sampler_each_rank_equals_jax(shuffle, drop_last,
                                                        n, world):
    ds = list(range(n))
    for rank in range(world):
        kw = dict(batch_size=3, num_replicas=world, rank=rank,
                  shuffle=shuffle, drop_last=drop_last)
        js, ts = jio.DistributedBatchSampler(ds, **kw), \
            tio.DistributedBatchSampler(ds, **kw)
        for epoch in range(3):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(js), (rank, epoch)
        assert len(ts) == len(js)


def test_distributed_batch_sampler_reads_the_launch_contract(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    s = tio.DistributedBatchSampler(list(range(10)), batch_size=2)
    assert (s.rank, s.nranks) == (2, 4)
    want = jio.DistributedBatchSampler(list(range(10)), batch_size=2,
                                       num_replicas=4, rank=2)
    assert list(s) == list(want)


@pytest.mark.parametrize("lengths,generator", [([10, 7, 6], None),
                                               ([0.5, 0.5], 3),
                                               ([23], None)])
def test_random_split_equals_jax(lengths, generator):
    a, b = _draw(lambda pkg: [s.indices for s in pkg.random_split(
        list(range(23)), lengths, generator=generator)])
    assert a == b
    with pytest.raises(ValueError):
        tio.random_split(list(range(5)), [2, 2])


def test_datasets_equal_jax():
    for pkg_pair in [(jio, tio)]:
        j, t = pkg_pair
        jd, td = _ds(j), _ds(t)
        for make in (
                lambda p, d: p.Subset(d, [4, 0, 9]),
                lambda p, d: p.ConcatDataset([d, p.Subset(d, [1, 2])]),
                lambda p, d: p.ComposeDataset([d, d])):
            a, b = make(j, jd), make(t, td)
            assert len(a) == len(b)
            for i in list(range(len(a))) + [-1]:
                if i < 0 and not hasattr(a, "cum"):
                    continue
                _same_batches([a[i]], [b[i]])
    x = np.arange(12.).reshape(6, 2)
    tds = tio.TensorDataset([tpaddle.to_tensor(x), np.arange(6)])
    jds = jio.TensorDataset([x, np.arange(6)])
    assert len(tds) == len(jds) == 6
    _same_batches([tds[3]], [jds[3]])


def test_collate_equals_jax():
    r = np.random.RandomState(1)
    samples = [{"a": r.randn(3), "b": (np.int64(i), r.randn(2).astype(
        np.float32))} for i in range(4)]
    _same_batches([tio.default_collate_fn(samples)],
                  [jio.default_collate_fn(samples)])
    ts = [tpaddle.to_tensor(r.randn(2, 2).astype(np.float32))
          for _ in range(3)]
    got = tio.default_collate_fn(ts)
    assert isinstance(got, tpaddle.Tensor) and got.shape == [3, 2, 2]
    np.testing.assert_array_equal(got.numpy(), np.stack([t.numpy()
                                                         for t in ts]))


@pytest.mark.parametrize("kw", [dict(batch_size=4),
                                dict(batch_size=5, drop_last=True),
                                dict(batch_size=3, shuffle=True)])
def test_dataloader_batches_equal_jax(kw):
    a, b = [], []
    for pkg, out in ((jio, a), (tio, b)):
        np.random.seed(9)
        out.extend(pkg.DataLoader(_ds(pkg), **kw))
    _same_batches(b, a)
    assert all(isinstance(x, tpaddle.Tensor) for bt in b for x in bt)
    assert len(tio.DataLoader(_ds(tio), **kw)) == \
        len(jio.DataLoader(_ds(jio), **kw))


def test_iterable_dataset_loader_equals_jax():
    def make(pkg):
        class Stream(pkg.IterableDataset):
            def __iter__(self):
                return iter([np.full(2, i, np.float32) for i in range(7)])

        return pkg.DataLoader(pkg.ChainDataset([Stream(), Stream()]),
                              batch_size=4)

    _same_batches(list(make(tio)), list(make(jio)))
    with pytest.raises(TypeError):
        len(make(tio))
    # a prefetch thread over the stream gives the same batches
    it = make(tio)
    it.num_workers = 1
    _same_batches(list(it), list(make(jio)))


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "pickle"])
@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_workers_equal_the_main_process(monkeypatch, shm, method):
    monkeypatch.setattr(tio, "_start_method", lambda: method)
    x = np.random.RandomState(2).randn(40, 64).astype(np.float32)
    ds = tio.TensorDataset([x, np.arange(40)])
    serial = list(tio.DataLoader(ds, batch_size=6))
    loader = tio.DataLoader(ds, batch_size=6, num_workers=2,
                            use_shared_memory=shm, prefetch_factor=1)
    it = iter(loader)
    assert it.start_method == method
    _same_batches(list(it), serial)
    if shm:
        assert it.shm_batches == len(serial)   # 6 x 64 fp32 >= 1 KiB


def _worker_id_collate(batch):
    info = tio.get_worker_info()
    return (info.id, info.num_workers, len(batch))


def test_worker_info_and_custom_collate():
    loader = tio.DataLoader(_ds(tio), batch_size=5, num_workers=2,
                            collate_fn=_worker_id_collate)
    got = list(loader)
    assert sorted({g[0] for g in got}) == [0, 1]
    assert all(g[1] == 2 for g in got)
    assert [g[2] for g in got] == [5, 5, 5, 5, 3]
    assert tio.get_worker_info() is None


def test_worker_error_reaches_the_parent():
    loader = tio.DataLoader(_ds(tio, fail_at=11), batch_size=4,
                            num_workers=2)
    with pytest.raises(RuntimeError, match="bad row 11"):
        list(loader)
