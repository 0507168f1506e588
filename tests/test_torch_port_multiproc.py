"""The port's host plane across 4 rank processes on the CPU: ``multiproc``
on the job's TCPStore and the ``socket_plane``, and ``rpc``, under the
port's launcher.

One launch of 4 ranks (``PADDLE_JOB_SESSION`` set, the store hosted by
this test on ``--master``, so rank 0 joins it as a client) runs every
collective below and above ``_SOCKET_THRESHOLD`` (1 KiB and 2 MiB
payloads), over the full world and over subgroups, and the tests hold the
results against numpy on the same seeded arrays:

* allgather, allreduce (sum, avg, max, min, prod), broadcast, p2p
  ``store_send``/``store_recv``, exchange/broadcast/scatter of objects,
  the barriers;
* the ring allreduce (2 MiB over 4 ranks, and over 3, padded) equals the
  ring's own order of sums (``SocketPlane.allreduce``: chunk c summed
  from member c around the ring, the JAX package's chunk order) bit for
  bit, which the plain row order does not;
* keys of an earlier session of the same job (planted before the launch)
  are invisible to the ranks and left as they were; every key the
  collectives made is deleted once its last member has read it (the
  socket addresses stay);
* rpc: the registry, sync and async calls, kwargs, a remote exception,
  a call to oneself, then ``shutdown``.

The socket plane's speed against the store path is the chip phase's to
print (``chip_smoke.py``), not asserted here.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu_torch.distributed.store import TCPStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SIZES = {"small": 256, "big": 1 << 19}      # float32: 1 KiB, 2 MiB
OPS = ("sum", "avg", "max", "min", "prod")
SESSION, STALE = "sess-B", "sess-A"

WORKER = """\
import os, pickle, sys
import numpy as np
from paddle_tpu_torch.distributed import multiproc, rpc

SIZES = {"small": 256, "big": 1 << 19}


def data(r, n):
    return np.random.RandomState(1000 + 7 * r + n % 97).randn(n).astype(
        np.float32)


def add(a, b):
    return a + b


def scaled(x, k=2):
    return [v * k for v in x]


def whoami():
    return int(os.environ["PADDLE_TRAINER_ID"])


def boom():
    raise ValueError("intentional")


rank, world = whoami(), multiproc.num_processes()
res = {"world": world, "active": multiproc.cross_process_active()}
for label, n in SIZES.items():
    x = data(rank, n)
    res["allgather", label] = multiproc.allgather_np(x)
    if rank in (0, 2, 3):
        res["sub_allgather", label] = multiproc.subgroup_allgather_np(
            x, [0, 2, 3])
    for op in ("sum", "avg", "max", "min", "prod"):
        res["allreduce", op, label] = multiproc.allreduce_np(x, op=op)
    if rank in (1, 2, 3):
        res["sub_allreduce", label] = multiproc.subgroup_allreduce_np(
            x, [1, 2, 3])
    res["broadcast", label] = multiproc.broadcast_np(
        x if rank == 2 else np.zeros_like(x), src=2)
    if rank in (0, 1):
        res["sub_broadcast", label] = multiproc.subgroup_broadcast_np(
            x, 1, [0, 1])
    if rank == 0:
        multiproc.store_send(x, dst=3)
    if rank == 3:
        res["p2p", label] = multiproc.store_recv(src=0)
res["exchange"] = multiproc.exchange_objects({"rank": rank})
if rank in (1, 3):
    res["exchange_sub"] = multiproc.exchange_objects(rank * 10, ranks=[3, 1])
res["broadcast_object"] = multiproc.broadcast_object({"from": rank}, src=3)
res["scatter"] = multiproc.scatter_objects(
    [f"to{r}" for r in (3, 1, 0, 2)] if rank == 1 else None, src=1,
    ranks=[3, 1, 0, 2])
multiproc.barrier()
if rank in (0, 1):
    multiproc.subgroup_barrier([0, 1])
# the first 0 -> 1 send of this session (an earlier session left one)
if rank == 0:
    multiproc.store_send(np.array([42.0]), dst=1)
if rank == 1:
    res["p2p_first"] = multiproc.store_recv(src=0)

rpc.init_rpc(f"worker{rank}")
peer = f"worker{(rank + 1) % world}"
res["rpc_info"] = rpc.get_worker_info(peer).rank
res["rpc_sync"] = rpc.rpc_sync(peer, add, args=(3, 4))
res["rpc_kwargs"] = rpc.rpc_sync(peer, scaled, args=([1, 2],),
                                 kwargs={"k": 10})
res["rpc_async"] = rpc.rpc_async(peer, add, args=(10, 20)).result(
    timeout=60)
res["rpc_remote"] = rpc.rpc_sync(peer, whoami)
res["rpc_self"] = rpc.rpc_sync(f"worker{rank}", whoami)
try:
    rpc.rpc_sync(peer, boom)
    res["rpc_error"] = None
except RuntimeError as e:
    res["rpc_error"] = str(e)
res["rpc_infos"] = sorted(i.name for i in rpc.get_all_worker_infos())
rpc.shutdown()
with open(os.path.join(sys.argv[1], f"rank{rank}.pkl"), "wb") as fh:
    pickle.dump(res, fh)
print("MULTIPROC_OK", rank, flush=True)
"""


def _data(r, n):
    return np.random.RandomState(1000 + 7 * r + n % 97).randn(n).astype(
        np.float32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stale_keys(members):
    """What an earlier session of the job left: a p2p payload and an
    object exchange's rows."""
    return {f"{STALE}/p2p/0->1/1": pickle.dumps(np.array([-1.0])),
            **{f"{STALE}/og/{members}/1/{r}": pickle.dumps({"rank": -1})
               for r in range(WORLD)}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiproc")
    (tmp / "worker.py").write_text(WORKER)
    port = _free_port()
    store = TCPStore("127.0.0.1", port, is_master=True, timeout=60)
    stale = _stale_keys("0-1-2-3")
    for k, v in stale.items():
        store.set(k, v)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env.pop("XLA_FLAGS", None)
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PADDLE_JOB_SESSION=SESSION)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(WORLD), "--log_dir", str(tmp / "log"),
         "--master", f"127.0.0.1:{port}", str(tmp / "worker.py"), str(tmp)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    logs = "".join((tmp / "log" / f"workerlog.{r}").read_text()
                   for r in range(WORLD)
                   if (tmp / "log" / f"workerlog.{r}").exists())
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
             if (tmp / f"rank{r}.pkl").exists() else None
             for r in range(WORLD)]
    yield {"proc": proc, "logs": logs, "ranks": ranks, "store": store,
           "stale": stale}
    store.close()


@pytest.fixture
def ranks(run):
    assert run["proc"].returncode == 0, (run["proc"].stderr, run["logs"])
    return run["ranks"]


def test_launch_ok(run, ranks):
    assert run["logs"].count("MULTIPROC_OK") == WORLD
    assert all(r["world"] == WORLD and r["active"] for r in ranks)


def _rows(members, n):
    return np.stack([_data(r, n) for r in members])


def _ring(rows, op):
    """The ring's reduction (``SocketPlane.allreduce``): pad to a
    multiple of n, chunk c reduced from member c, each next member
    combining its own chunk with the partial."""
    n, length = len(rows), rows.shape[1]
    pad = (-length) % n
    chunks = [np.split(np.concatenate([r, np.zeros(pad, r.dtype)]), n)
              for r in rows]
    f = {"sum": np.add, "avg": np.add, "max": np.maximum,
         "min": np.minimum, "prod": np.multiply}[op]
    out = []
    for c in range(n):
        acc = chunks[c][c].copy()
        for k in range(1, n):
            acc = f(chunks[(c + k) % n][c], acc)
        out.append(acc)
    red = np.concatenate(out)[:length]
    return red / n if op == "avg" else red


def _rowwise(rows, op):
    return {"sum": rows.sum(0), "avg": rows.mean(0), "max": rows.max(0),
            "min": rows.min(0), "prod": rows.prod(0)}[op]


@pytest.mark.parametrize("label", list(SIZES))
def test_allgather(ranks, label):
    n = SIZES[label]
    for r, res in enumerate(ranks):
        assert np.array_equal(res["allgather", label],
                              _rows(range(WORLD), n))
        if r in (0, 2, 3):
            assert np.array_equal(res["sub_allgather", label],
                                  _rows([0, 2, 3], n))
        else:
            assert ("sub_allgather", label) not in res


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("label", list(SIZES))
def test_allreduce(ranks, label, op):
    """Below the threshold: the gathered rows reduced in row order; above
    it: the ring's order, bit for bit."""
    rows = _rows(range(WORLD), SIZES[label])
    want = _ring(rows, op) if label == "big" else _rowwise(rows, op)
    for res in ranks:
        assert np.array_equal(res["allreduce", op, label], want)


def test_ring_sum_order_bit_exact(ranks):
    """The ring sums in its own order; the row order gives other bits,
    so the test can tell the two apart."""
    for members in ([0, 1, 2, 3], [1, 2, 3]):
        rows = _rows(members, SIZES["big"])
        ring = _ring(rows, "sum")
        assert not np.array_equal(ring, rows.sum(0))
        np.testing.assert_allclose(ring, rows.sum(0), rtol=1e-5, atol=1e-5)
        for r in members:
            got = (ranks[r]["allreduce", "sum", "big"] if len(members) == 4
                   else ranks[r]["sub_allreduce", "big"])
            assert np.array_equal(got, ring)
    small = _rows([1, 2, 3], SIZES["small"])
    for r in (1, 2, 3):
        assert np.array_equal(ranks[r]["sub_allreduce", "small"],
                              small.sum(0))


@pytest.mark.parametrize("label", list(SIZES))
def test_broadcast_and_p2p(ranks, label):
    n = SIZES[label]
    for r, res in enumerate(ranks):
        assert np.array_equal(res["broadcast", label], _data(2, n))
        if r in (0, 1):
            assert np.array_equal(res["sub_broadcast", label], _data(1, n))
    assert np.array_equal(ranks[3]["p2p", label], _data(0, n))


def test_object_collectives(ranks):
    for r, res in enumerate(ranks):
        assert res["exchange"] == [{"rank": q} for q in range(WORLD)]
        assert res["broadcast_object"] == {"from": 3}
        # group order [3, 1, 0, 2]: rank 3 gets the first object
        assert res["scatter"] == f"to{r}"
        if r in (1, 3):
            assert res["exchange_sub"] == [10, 30]


def test_stale_session_keys_are_invisible(run, ranks):
    assert np.array_equal(ranks[1]["p2p_first"], np.array([42.0]))
    assert ranks[0]["exchange"][0] == {"rank": 0}
    for k, v in run["stale"].items():         # untouched
        assert run["store"].get(k) == v


def test_consumed_keys_are_deleted(run, ranks):
    store = run["store"]
    groups = ["0-1-2-3", "0-2-3", "1-2-3", "0-1", "1-3"]
    left = []
    for kind in ("sg", "sar", "sb", "bar", "og", "ob", "so"):
        for tag in groups:
            for seq in range(1, 24):
                pre = f"{SESSION}/{kind}/{tag}/{seq}"
                for k in ["v", "n", "done", "acks",
                          *map(str, range(WORLD))]:
                    if store.get(f"{pre}/{k}") is not None:
                        left.append(f"{pre}/{k}")
    for src, dst in ((0, 3), (0, 1)):
        for seq in (1, 2, 3):
            if store.get(f"{SESSION}/p2p/{src}->{dst}/{seq}") is not None:
                left.append(f"p2p {src}->{dst} {seq}")
    assert left == []
    # what stays: each rank's socket address (the plane ran: 2 MiB paths)
    assert all(store.get(f"{SESSION}/sockaddr/{r}") for r in range(WORLD))


def test_rpc(ranks):
    for r, res in enumerate(ranks):
        peer = (r + 1) % WORLD
        assert res["rpc_info"] == peer
        assert res["rpc_sync"] == 7
        assert res["rpc_kwargs"] == [10, 20]
        assert res["rpc_async"] == 30
        assert res["rpc_remote"] == peer
        assert res["rpc_self"] == r
        assert "intentional" in res["rpc_error"]
        assert "failed remotely" in res["rpc_error"]
        assert f"worker{r}" in res["rpc_infos"]
