"""Data feeding of the port (``paddle_tpu.io`` counterpart): datasets,
samplers, collate, the ``DataLoader`` with its worker processes, sequence
packing and the asynchronous device feed.

Samplers draw from numpy exactly as the JAX package's do (the global
numpy RNG unless a generator is given, ``RandomState(epoch)`` for
``DistributedBatchSampler``), so the same seed gives the same indices,
batch for batch. ``DistributedBatchSampler`` reads rank and world from
``distributed.env``: a launched rank gets its shard with no arguments.

``DataLoader(num_workers > 0)`` over a map-style dataset runs worker
PROCESSES that fetch, transform and collate to numpy, with ordered
delivery, fault propagation and an optional POSIX shared-memory hand-off
(``use_shared_memory``). A worker never touches CUDA: it hands numpy to
the parent, and only the parent makes tensors, on the loader's place
(``places``, else the current device). Workers are forked while this
process has not initialised CUDA, and started with the ``spawn`` method
once it has (a forked child of a CUDA process cannot use CUDA, and
inherits its state); spawned workers need a picklable dataset. Iterable
datasets keep a thread prefetcher, as there.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.device import current_device
from paddle_tpu_torch.core.tensor import Tensor, _from_numpy
from paddle_tpu_torch.io.device_feed import (DeviceFeeder, DispatchWindow,
                                             FeederWorkerError, LossFuture,
                                             prefetch_to_device)
from paddle_tpu_torch.io.packing import (SequencePacker, pack_examples,
                                         pad_examples, unpack_batch)

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
    "DataLoader", "default_collate_fn", "get_worker_info",
    "SequencePacker", "pack_examples", "pad_examples", "unpack_batch",
    "DeviceFeeder", "DispatchWindow", "FeederWorkerError", "LossFuture",
    "prefetch_to_device"]


def _as_rng(generator):
    """None -> the global numpy RNG, an int -> a fresh seeded Generator, a
    numpy Generator/RandomState passes through (its state advances across
    uses)."""
    if generator is None:
        return np.random
    if isinstance(generator, (int, np.integer)):
        return np.random.default_rng(int(generator))
    return generator


def _rand_ints(rng, n, size):
    # Generator spells it `integers`, RandomState/module spell it `randint`
    if hasattr(rng, "integers"):
        return rng.integers(0, n, size)
    return rng.randint(0, n, size)


def _host(x):
    """A host copy of a tensor-like: numpy, or a CPU torch tensor for the
    dtypes numpy lacks (bfloat16, the fp8 types)."""
    if isinstance(x, Tensor):
        x = x._value
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        try:
            return x.numpy()
        except TypeError:
            return x
    return x


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")


class TensorDataset(Dataset):
    """Rows of tensors or arrays; tensors are copied to the host once, so
    a worker process reads numpy."""

    def __init__(self, tensors: Sequence):
        self.tensors = [_host(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if sum(lengths) != n:
        # fraction support
        if all(0 < l < 1 for l in lengths):
            lengths = [int(l * n) for l in lengths]
            lengths[-1] = n - sum(lengths[:-1])
        else:
            raise ValueError("sum of lengths must equal dataset size")
    perm = _as_rng(generator).permutation(n)
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off: off + l].tolist()))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.generator = generator

    def __iter__(self):
        n = len(self.data_source)
        rng = _as_rng(self.generator)
        if self.replacement:
            return iter(_rand_ints(rng, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """Indices drawn with probability proportional to `weights`."""

    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        self.num_samples = int(num_samples)
        self.replacement = bool(replacement)
        if not self.replacement and self.num_samples > len(self.weights):
            raise ValueError("num_samples exceeds population without "
                             "replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    """Datasets glued end to end."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __getitem__(self, idx):
        if idx < 0:
            idx += self.cum[-1]
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]

    def __len__(self):
        return self.cum[-1]


class _WorkerInfo:
    def __init__(self, id_, num_workers, dataset=None):
        self.id = id_
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """In a DataLoader worker process its (id, num_workers, dataset);
    None in the main process."""
    return _worker_info


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded sampler: each rank sees a strided shard of the indices,
    padded by wrap-around to a multiple of the ranks; ``shuffle`` permutes
    with ``RandomState(epoch)`` (``set_epoch``). Rank and world default to
    ``distributed.env``'s."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from paddle_tpu_torch.distributed.env import (get_rank,
                                                      get_world_size)

        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else get_world_size())
        self.rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        # pad to a multiple of nranks so every rank gets equal batches
        total = int(np.ceil(n / self.nranks)) * self.nranks
        indices = np.concatenate([indices, indices[: total - n]])
        local = indices[self.rank:: self.nranks]
        batch = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        per_rank = int(np.ceil(len(self.dataset) / self.nranks))
        if self.drop_last:
            return per_rank // self.batch_size
        return (per_rank + self.batch_size - 1) // self.batch_size


def _collate_np(batch):
    """Collate to host arrays: numpy stacks (float64 narrowed to float32),
    tensors stacked on the host. Runs in the workers; the parent makes the
    tensors."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(_collate_np([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _collate_np([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (Tensor, torch.Tensor)):
        return torch.stack([getattr(s, "_value", s).detach().cpu()
                            for s in batch])
    arr = np.stack([np.asarray(s) for s in batch])
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _to_tensor_tree(x, device):
    """The parent's side: host arrays of a collated batch -> ``Tensor``s on
    `device`."""
    if isinstance(x, tuple):
        return tuple(_to_tensor_tree(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to_tensor_tree(v, device) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return Tensor(_from_numpy(x).to(device))
    if isinstance(x, torch.Tensor):
        return Tensor(x.to(device))
    return x


def default_collate_fn(batch, place=None):
    """Stack samples into batched ``Tensor``s on `place` (the current
    device by default), keeping tuple and dict structure."""
    return _to_tensor_tree(_collate_np(batch), current_device(place))


class _PrefetchIter:
    def __init__(self, it, num_prefetch):
        from paddle_tpu_torch.io.device_feed import (THREAD_PREFIX,
                                                     interruptible_put)

        self.q: queue.Queue = queue.Queue(maxsize=num_prefetch)
        self._sentinel = object()
        self._err = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if not interruptible_put(self.q, item, self._stop):
                        return
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                interruptible_put(self.q, self._sentinel, self._stop)

        self._t = threading.Thread(target=worker, daemon=True,
                                   name=f"{THREAD_PREFIX}.prefetch")
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self.q.get()
        if item is self._sentinel:
            err = self._err
            self.close()
            if err is not None:
                self._err = None
                raise err
            raise StopIteration
        return item

    def close(self):
        from paddle_tpu_torch.io.device_feed import stop_and_join

        stop_and_join(self.q, self._stop, self._t)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _start_method() -> str:
    """"fork" while this process has not initialised CUDA, else "spawn"."""
    return "spawn" if torch.cuda.is_initialized() else "fork"


class _ShmRef:
    """An array parked in a POSIX shared-memory segment: a distinct type,
    recognisable at any nesting depth."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name, shape, dtype):
        self.name = name
        self.shape = shape
        self.dtype = dtype

    def __reduce__(self):
        return (_ShmRef, (self.name, self.shape, self.dtype))


def _shm_tree_map(tree, fn):
    if isinstance(tree, tuple):
        return tuple(_shm_tree_map(v, fn) for v in tree)
    if isinstance(tree, list):
        return [_shm_tree_map(v, fn) for v in tree]
    if isinstance(tree, dict):
        return {k: _shm_tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unlink(name):
    from multiprocessing import shared_memory

    try:
        seg = shared_memory.SharedMemory(name=name)
        seg.close()
        seg.unlink()
    except Exception:
        pass


def _shm_export(tree, prefix="", counter=None):
    """Move the numpy leaves of a collated batch into POSIX shared memory
    (segments named with the loader's prefix, so the parent can sweep
    strays after a worker dies); a leaf that does not fit (a small
    ``/dev/shm``) or has a structured dtype goes through the pickle."""
    from multiprocessing import shared_memory

    names = []

    def export(v):
        if (isinstance(v, np.ndarray) and v.nbytes >= 1024
                and v.dtype.names is None and not v.dtype.hasobject):
            if counter is not None:
                counter[0] += 1
            name = (f"{prefix}{counter[0]}"
                    if (prefix and counter is not None) else None)
            try:
                seg = shared_memory.SharedMemory(name=name, create=True,
                                                 size=v.nbytes)
            except OSError:
                return v
            names.append(seg.name)
            np.ndarray(v.shape, v.dtype, buffer=seg.buf)[...] = v
            # the PARENT owns the segment: this process's resource tracker
            # must not unlink it at worker exit
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(seg._name, "shared_memory")
            except Exception:
                pass
            seg.close()
            return _ShmRef(seg.name, v.shape, v.dtype.str)
        return v

    try:
        return _shm_tree_map(tree, export)
    except Exception:
        for n in names:
            _unlink(n)
        raise


def _shm_import(tree):
    """Parent side: copy each segment into a CPU tensor once, then unlink.
    Returns (tree, refs consumed)."""
    from multiprocessing import shared_memory

    count = [0]

    def imp(v):
        if isinstance(v, _ShmRef):
            count[0] += 1
            seg = shared_memory.SharedMemory(name=v.name)
            try:
                view = np.ndarray(v.shape, np.dtype(v.dtype), buffer=seg.buf)
                return torch.from_numpy(view.copy())
            finally:
                seg.close()
                seg.unlink()
        return v

    return _shm_tree_map(tree, imp), count[0]


def _shm_release(tree):
    """Unlink a batch's segments without reading them (teardown)."""
    def rel(v):
        if isinstance(v, _ShmRef):
            _unlink(v.name)
        return v

    _shm_tree_map(tree, rel)


def _worker_loop(dataset, index_q, result_q, collate, worker_init_fn, wid,
                 use_shared_memory=False, shm_prefix="", num_workers_total=1):
    """A worker process: fetch, transform and collate to numpy."""
    global _worker_info
    torch.set_num_threads(1)
    _worker_info = _WorkerInfo(wid, num_workers_total, dataset)
    if worker_init_fn is not None:
        worker_init_fn(wid)
    seq = [0]
    while True:
        item = index_q.get()
        if item is None:
            break
        bid, idxs = item
        try:
            batch = collate([dataset[i] for i in idxs])
            if use_shared_memory:
                batch = _shm_export(batch, f"{shm_prefix}w{wid}_", seq)
            try:
                result_q.put((bid, batch, None))
            except Exception:
                if use_shared_memory:
                    _shm_release(batch)
                raise
        except Exception:
            import traceback

            result_q.put((bid, None, traceback.format_exc()))


class _MultiprocessIter:
    """Batch index lists fan out to the worker processes, batch i to
    worker i mod num_workers (each worker its own index queue, so which
    worker collates a batch does not depend on timing); collated numpy
    batches come back over a result queue and are yielded in order (early
    arrivals buffered), made into tensors in the parent."""

    def __init__(self, loader):
        import multiprocessing as mp
        import os

        ctx = mp.get_context(_start_method())
        self.start_method = ctx.get_start_method()
        self._collate_user = loader.collate_fn is not default_collate_fn
        collate = loader.collate_fn if self._collate_user else _collate_np
        self._device = current_device(loader.places)
        # shared memory only applies to the numpy default-collate layout
        self._use_shm = bool(loader.use_shared_memory
                             and not self._collate_user)
        self._shm_prefix = f"ptdl_{os.getpid()}_{id(self) & 0xffff:x}_"
        self.shm_batches = 0
        self._index_qs = [ctx.Queue() for _ in range(loader.num_workers)]
        self._result_q = ctx.Queue()
        self._timeout = loader.timeout or None
        self._workers = []
        for wid in range(loader.num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, self._index_qs[wid], self._result_q,
                      collate, loader.worker_init_fn, wid, self._use_shm,
                      self._shm_prefix, loader.num_workers),
                daemon=True)
            w.start()
            self._workers.append(w)
        self._batches = list(loader.batch_sampler)
        self._next_dispatch = 0
        self._next_yield = 0
        self._pending = {}
        self._inflight_max = loader.num_workers * loader.prefetch_factor
        self._dispatch()

    def _dispatch(self):
        while (self._next_dispatch < len(self._batches)
               and self._next_dispatch - self._next_yield
               < self._inflight_max):
            q = self._index_qs[self._next_dispatch % len(self._index_qs)]
            q.put((self._next_dispatch, self._batches[self._next_dispatch]))
            self._next_dispatch += 1

    def __iter__(self):
        return self

    def __next__(self):
        import time

        if self._next_yield >= len(self._batches):
            self._shutdown()
            raise StopIteration
        deadline = time.time() + self._timeout if self._timeout else None
        while self._next_yield not in self._pending:
            try:
                bid, batch, err = self._result_q.get(timeout=1.0)
            except queue.Empty:
                dead = [w for w in self._workers if not w.is_alive()]
                if dead:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader worker died (exitcode "
                        f"{dead[0].exitcode}) before returning a batch")
                if deadline is not None and time.time() > deadline:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader timed out after {self._timeout}s "
                        f"waiting for batch {self._next_yield}")
                continue
            if err is not None:
                self._shutdown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            self._pending[bid] = batch
        batch = self._pending.pop(self._next_yield)
        self._next_yield += 1
        self._dispatch()
        if self._collate_user:
            return batch
        if self._use_shm:
            batch, n_refs = _shm_import(batch)
            self.shm_batches += n_refs > 0
        return _to_tensor_tree(batch, self._device)

    def _shutdown(self):
        for q in self._index_qs[:len(self._workers)]:
            try:
                q.put(None)
            except Exception:
                pass
        for w in self._workers:
            w.join(timeout=5)
            if w.is_alive():
                w.terminate()
                w.join(timeout=5)
        self._workers = []
        if self._use_shm:
            # in-flight segments: the workers unregistered their trackers
            for batch in self._pending.values():
                _shm_release(batch)
            self._pending = {}
            while True:
                try:
                    _, batch, err = self._result_q.get_nowait()
                except (queue.Empty, OSError, ValueError):
                    break
                if err is None:
                    _shm_release(batch)
            # strays of a worker that died (their refs never reached the
            # queue; names carry this loader's prefix)
            import glob

            for path in glob.glob(f"/dev/shm/{self._shm_prefix}*"):
                _unlink(path.rsplit("/", 1)[1])

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass


class DataLoader:
    """Batches of a dataset (``paddle.io.DataLoader``): a ``BatchSampler``
    over a map-style dataset (or ``batch_sampler``), chunks of an iterable
    one; ``default_collate_fn`` makes ``Tensor``s on ``places`` (the
    current device when None). ``num_workers > 0`` uses worker processes
    (see the module's docstring)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.places = places[0] if isinstance(places, (list, tuple)) \
            else places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def _collate(self, samples):
        if self.collate_fn is default_collate_fn:
            return default_collate_fn(samples, self.places)
        return self.collate_fn(samples)

    def _iter_batches(self):
        if self.batch_sampler is None:
            # iterable dataset: chunk the stream
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self._collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self._collate(batch)
            return
        for idxs in self.batch_sampler:
            yield self._collate([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers > 0 and self.batch_sampler is not None:
            return _MultiprocessIter(self)
        it = self._iter_batches()
        if self.num_workers > 0:
            return _PrefetchIter(it, self.num_workers * self.prefetch_factor)
        return it

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("length of IterableDataset loader is unknown")
        return len(self.batch_sampler)
