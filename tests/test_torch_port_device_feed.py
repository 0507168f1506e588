"""The port's device feed (``io.device_feed``) on the CPU. Every test
bounds its own waits (joins and queue reads time out), so a feeder bug
fails here instead of hanging the suite.

* batches come out in order, equal to the input, as CPU tensors (numpy
  leaves converted, other leaves as they are), in tuple and dict
  structures;
* a worker fault (the ``feeder.collate`` and ``feeder.device_put`` points,
  and an iterator that raises) reaches the consumer as
  ``FeederWorkerError`` with its phase, batch index and cause;
* ``stop_and_join`` returns while a producer is blocked on a full queue,
  and ``close()`` of an abandoned feeder joins its worker;
* ``DispatchWindow`` keeps at most `window` steps in flight and
  ``TrainStep.step_async`` hands back ``LossFuture``s;
* a mesh raises (ROADMAP A8).
"""
import queue
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.io import device_feed as df
from paddle_tpu_torch.models import llama_tiny_config
from paddle_tpu_torch.models.llama import LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep

TIMEOUT = 10.0


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    yield
    faults.reset()
    leaked = [t for t in threading.enumerate()
              if t.name.startswith(df.THREAD_PREFIX)]
    for t in leaked:
        t.join(timeout=TIMEOUT)
    assert not [t for t in leaked if t.is_alive()], "leaked feeder thread"


def _take(feeder, n=None):
    """Up to n batches (all when None), each read with a deadline."""
    out = []
    deadline = time.monotonic() + TIMEOUT
    box = {}

    def pull():
        try:
            for item in feeder:
                out.append(item)
                if n is not None and len(out) >= n:
                    break
        except BaseException as e:          # re-raised below
            box["err"] = e

    t = threading.Thread(target=pull, daemon=True)
    t.start()
    t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not t.is_alive(), "the feeder did not deliver in time"
    if "err" in box:
        raise box["err"]
    return out


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 100, (2, 8)).astype(np.int32),
             "labels": rng.randint(0, 100, (2, 8)).astype(np.int32),
             "meta": i} for i in range(n)]


def test_batches_in_order_and_equal():
    src = _batches(7)
    with df.DeviceFeeder(iter(src), device="cpu", depth=2) as feeder:
        got = _take(feeder)
    assert len(got) == 7 and feeder.batches_consumed == 7
    for want, b in zip(src, got):
        assert b["meta"] == want["meta"]
        for k in ("input_ids", "labels"):
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(b[k].numpy(), want[k])
    tup = [(np.arange(3) + i, torch.ones(2) * i) for i in range(4)]
    with df.prefetch_to_device(iter(tup), device="cpu", depth=1) as feeder:
        got = _take(feeder)
    assert [int(b[0][0]) for b in got] == [0, 1, 2, 3]
    assert all(torch.equal(b[1], torch.ones(2) * i)
               for i, b in enumerate(got))


@pytest.mark.parametrize("phase", ["collate", "device_put", "iterator"])
def test_worker_fault_reaches_consumer(phase):
    src = _batches(5)

    def it():
        for i, b in enumerate(src):
            if phase == "iterator" and i == 2:
                raise ValueError("bad shard")
            yield b

    if phase != "iterator":
        faults.arm(f"feeder.{phase}", mode="nth", nth=3)
    feeder = df.DeviceFeeder(it(), device="cpu", depth=2)
    with pytest.raises(df.FeederWorkerError) as ei:
        _take(feeder)
    err = ei.value
    assert err.batch_index == 2
    assert err.phase == ("device_put" if phase == "device_put"
                         else "collate")
    cause = err.__cause__
    if phase == "iterator":
        assert isinstance(cause, ValueError) and "bad shard" in str(cause)
    else:
        assert isinstance(cause, faults.FaultInjected)
        assert cause.point == f"feeder.{phase}"
    feeder.close()
    assert not feeder._thread.is_alive()


def test_stop_and_join_returns_while_producer_blocked():
    q = queue.Queue(maxsize=1)
    stop = threading.Event()
    done = threading.Event()

    def producer():
        for i in range(100):
            if not df.interruptible_put(q, i, stop, poll=0.01):
                break
        done.set()

    t = threading.Thread(target=producer, daemon=True,
                         name=f"{df.THREAD_PREFIX}.test")
    t.start()
    time.sleep(0.05)                        # the producer is now blocked
    assert q.full() and not done.is_set()
    t0 = time.monotonic()
    df.stop_and_join(q, stop, t, timeout=TIMEOUT)
    assert not t.is_alive() and done.is_set()
    assert time.monotonic() - t0 < TIMEOUT
    # an abandoned feeder: its worker is blocked on the full queue
    feeder = df.DeviceFeeder(iter(_batches(50)), device="cpu", depth=1)
    time.sleep(0.05)
    feeder.close()
    assert not feeder._thread.is_alive()


def test_dispatch_window_bounds_in_flight_steps():
    class Ev:
        def __init__(self):
            self.waited = False

        def synchronize(self):
            self.waited = True

    w = df.DispatchWindow(2)
    evs = [Ev() for _ in range(5)]
    for i, ev in enumerate(evs):
        w.admit(ev)
        assert len(w) == min(i + 1, 2)
    assert [e.waited for e in evs] == [True, True, True, False, False]
    w.drain()
    assert len(w) == 0 and all(e.waited for e in evs)
    assert df.DispatchWindow(None).window == 2


def test_step_async_returns_loss_futures():
    model = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                             device="cpu", seed=0)
    step = TrainStep(model, lambda out, lab: out,
                     AdamW(learning_rate=1e-3, parameters=model.parameters()),
                     metrics_every=2, dispatch_window=1)
    same = [_batches(1)[0]] * 4             # one batch: the loss falls
    with df.DeviceFeeder(iter(same), device="cpu") as feeder:
        futures = [step.step_async({k: v for k, v in b.items()
                                    if k != "meta"}) for b in _take(feeder)]
    step.drain()
    assert all(isinstance(f, df.LossFuture) and f.ready() for f in futures)
    losses = [float(f) for f in futures]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert "LossFuture(" in repr(futures[0])


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="A8"):
        df.DeviceFeeder(iter([]), device="cpu", mesh=object())
