"""The port's collectives (``distributed.collective``) on 4 gloo ranks on
the CPU, against numpy and against the JAX package's in-graph
collectives.

One group of 4 processes (``distributed.spawn``: the launch contract,
loopback, a free port, a join timeout) runs every op of the module's
``__all__`` over the world and over subgroups ({0, 2}, {1, 3} and
{1, 2, 3}); each rank's inputs are made from a seed of its rank with
numpy. This process holds the results to the numpy arithmetic and to the
``lax`` collectives of a ``shard_map`` over 4 of the 8 virtual CPU
devices (``shard_map_compat``: ``psum``, ``pmax``, ``pmin``,
``all_gather``, ``psum_scatter``, ``all_to_all``, ``ppermute``), a 2 x 2
mesh standing for the subgroups. Sums are fp32 in another order: rtol
1e-6. Then ``spawn`` itself: a failing rank and a hung rank each fail the
group within its timeout, the others killed.
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

W = 4
SPAWN_TIMEOUT_S = 120


def _x(r, shape=(4, 6)):
    return np.random.RandomState(100 + r).standard_normal(shape).astype(
        np.float32)


def _collective_rank(out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C

    dist.init_parallel_env()
    r = dist.get_rank()
    g02 = C.new_group([0, 2])
    g13 = C.new_group([1, 3])
    g123 = C.new_group([1, 2, 3])
    pair = g02 if r in (0, 2) else g13
    x = torch.from_numpy(_x(r))
    out = {"rank": r, "world": dist.get_world_size(),
           "backend": C.get_backend(), "pair_rank": pair.rank,
           "env_rank": dist.ParallelEnv().rank}
    C.reset_stats()
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = x.clone()
        C.all_reduce(t, getattr(C.ReduceOp, op))
        out[f"all_reduce_{op}"] = t.numpy()
    t = x.clone()
    C.all_reduce(t, group=pair)
    out["all_reduce_pair"] = t.numpy()
    out["stats_after_all_reduce"] = C.stats()
    out["all_gather"] = np.stack([a.numpy() for a in
                                  C.all_gather([], x.clone())])
    out["all_gather_stacked"] = C.all_gather(None, x.clone()).numpy()
    out["all_gather_pair"] = np.stack([a.numpy() for a in
                                       C.all_gather([], x.clone(),
                                                    group=pair)])
    out["all_gather_object"] = C.all_gather_object([], {"r": r})
    t = x.clone()
    C.reduce(t, dst=2)
    out["reduce"] = t.numpy()
    big = torch.from_numpy(_x(r, (8, 6)))
    t = torch.empty(2, 6)
    C.reduce_scatter(t, big)
    out["reduce_scatter"] = t.numpy()
    t = torch.empty(2, 6)
    C.reduce_scatter(t, list(big.split(2)), op=C.ReduceOp.MAX)
    out["reduce_scatter_list_max"] = t.numpy()
    t = torch.empty(4, 6)
    C.reduce_scatter(t, big, group=pair)
    out["reduce_scatter_pair"] = t.numpy()
    t = x.clone()
    C.broadcast(t, src=3)
    out["broadcast"] = t.numpy()
    if r in (1, 2, 3):
        t = x.clone()
        C.broadcast(t, src=2, group=g123)
        out["broadcast_g123"] = t.numpy()
    objs = [f"from {r}", r]
    C.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    t = torch.empty(4, 6)
    C.scatter(t, [torch.full((4, 6), float(10 * r + j)) for j in range(W)]
              if r == 1 else None, src=1)
    out["scatter"] = t.numpy()
    got = []
    C.gather(x.clone(), got if r == 0 else None, dst=0)
    out["gather"] = np.stack([a.numpy() for a in got]) if got else None
    outs = C.all_to_all([], [x[j].clone() for j in range(W)])
    out["all_to_all"] = np.stack([a.numpy() for a in outs])
    t = torch.empty(4, 6)
    C.all_to_all_single(t, x.clone())
    out["all_to_all_single"] = t.numpy()
    # uneven splits: rank r sends j + 1 rows to rank j
    src = torch.arange(10.0) + 100 * r
    t = torch.empty(4 * (r + 1))
    C.all_to_all_single(t, src, in_split_sizes=[1, 2, 3, 4],
                        out_split_sizes=[r + 1] * W)
    out["all_to_all_uneven"] = t.numpy()
    # a ring: to r + 1, from r - 1, by isend/irecv and by a batch
    t = torch.empty(4, 6)
    works = [C.isend(x.clone(), (r + 1) % W), C.irecv(t, (r - 1) % W)]
    for w in works:
        w.wait()
    out["ring"] = t.numpy()
    t2 = torch.empty(4, 6)
    for w in C.batch_isend_irecv([C.P2POp(C.isend, x.clone(), (r - 1) % W),
                                  C.P2POp(C.irecv, t2, (r + 1) % W)]):
        w.wait()
    out["ring_back"] = t2.numpy()
    if r == 0:
        C.send(x.clone(), 3)
    elif r == 3:
        t = torch.empty(4, 6)
        C.recv(t, 0)
        out["send_recv"] = t.numpy()
    # partial p2p: rank 1 ships its 2nd quarter to rank 2
    if r == 1:
        C.partial_send(x.clone(), dst=2, nranks=W, rank_id=1)
    elif r == 2:
        t = torch.zeros(4, 6)
        C.partial_recv(t, src=1, nranks=W, rank_id=1)
        out["partial_recv"] = t.numpy()
    t = x.clone()
    C.partial_allgather(t, nranks=W, rank_id=r)
    out["partial_allgather"] = t.numpy()
    objs = [None]
    C.scatter_object_list(objs, [{"to": j} for j in range(W)]
                          if r == 0 else None, src=0)
    out["scatter_object_list"] = objs
    t = x.clone()
    C.stream.all_reduce(t)
    out["stream_all_reduce"] = t.numpy()
    assert C.wait(t) is t
    C.barrier()
    C.barrier(group=pair)
    C.monitored_barrier()
    out["stats"] = C.stats()
    out["is_available"] = C.is_available()
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    C.destroy_process_group()
    out_after = dist.is_initialized()
    with open(os.path.join(out_dir, f"rank{r}.after"), "w") as fh:
        fh.write(str(out_after))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collective"))
    spawn(_collective_rank, (out,), nprocs=W, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(W):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
        with open(os.path.join(out, f"rank{r}.after")) as fh:
            res[-1]["initialized_after_destroy"] = fh.read()
    return res


def _xs(shape=(4, 6)):
    return np.stack([_x(r, shape) for r in range(W)])


def _jax_shard_map(body, x, axes=("x",), shape=(W,), spec_axes=None):
    """`body` under shard_map over 4 virtual devices, each holding its
    rank's block of `x` (stacked on dim 0); the per-device outputs
    stacked on dim 0."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.mesh import shard_map_compat

    mesh = Mesh(np.array(jax.devices()[:W]).reshape(shape), axes)
    spec = P(spec_axes or axes)
    fn = shard_map_compat(lambda v: body(v[0])[None], mesh,
                          in_specs=(spec,), out_specs=spec)
    return np.asarray(fn(x))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD", "AVG"])
def test_all_reduce_matches_numpy_and_lax(ranks, op):
    import jax

    xs = _xs()
    want = {"SUM": xs.sum(0), "MAX": xs.max(0), "MIN": xs.min(0),
            "PROD": xs.prod(0), "AVG": xs.mean(0)}[op]
    lax_fn = {"SUM": lambda v: jax.lax.psum(v, "x"),
              "MAX": lambda v: jax.lax.pmax(v, "x"),
              "MIN": lambda v: jax.lax.pmin(v, "x"),
              "AVG": lambda v: jax.lax.pmean(v, "x")}.get(op)
    for r in range(W):
        _close(ranks[r][f"all_reduce_{op}"], want)
        if lax_fn is not None:
            _close(ranks[r][f"all_reduce_{op}"],
                   _jax_shard_map(lax_fn, xs)[r])


def test_all_reduce_over_subgroups_is_the_mesh_axis_psum(ranks):
    """{0, 2} and {1, 3} are the 'a' axis of a 2 x 2 mesh (rank = 2a + b)."""
    import jax

    xs = _xs()
    lax_out = _jax_shard_map(lambda v: jax.lax.psum(v, "a"), xs,
                             axes=("a", "b"), shape=(2, 2))
    for r in range(W):
        pair = (0, 2) if r in (0, 2) else (1, 3)
        _close(ranks[r]["all_reduce_pair"], xs[list(pair)].sum(0))
        _close(ranks[r]["all_reduce_pair"], lax_out[r])
        assert ranks[r]["pair_rank"] == pair.index(r)


def test_all_gather_matches_lax_all_gather(ranks):
    import jax

    xs = _xs()
    lax_out = _jax_shard_map(lambda v: jax.lax.all_gather(v, "x"), xs)
    for r in range(W):
        _close(ranks[r]["all_gather"], xs)
        _close(ranks[r]["all_gather_stacked"], xs)
        _close(ranks[r]["all_gather"], lax_out[r])
        pair = [0, 2] if r in (0, 2) else [1, 3]
        _close(ranks[r]["all_gather_pair"], xs[pair])
        assert ranks[r]["all_gather_object"] == [{"r": j} for j in range(W)]


def test_reduce_scatter_matches_psum_scatter(ranks):
    import jax

    big = _xs((8, 6))
    lax_out = _jax_shard_map(
        lambda v: jax.lax.psum_scatter(v, "x", tiled=True), big)
    for r in range(W):
        _close(ranks[r]["reduce_scatter"], big.sum(0)[2 * r:2 * r + 2])
        _close(ranks[r]["reduce_scatter"], lax_out[r])
        _close(ranks[r]["reduce_scatter_list_max"],
               big.max(0)[2 * r:2 * r + 2])
        pair = [0, 2] if r in (0, 2) else [1, 3]
        i = pair.index(r)
        _close(ranks[r]["reduce_scatter_pair"],
               big[pair].sum(0)[4 * i:4 * i + 4])


def test_all_to_all_matches_lax_all_to_all(ranks):
    import jax

    xs = _xs()
    lax_out = _jax_shard_map(
        lambda v: jax.lax.all_to_all(v, "x", 0, 0, tiled=True), xs)
    for r in range(W):
        want = xs[:, r]                      # row r of every rank's input
        _close(ranks[r]["all_to_all"], want)
        _close(ranks[r]["all_to_all_single"], want)
        _close(ranks[r]["all_to_all_single"], lax_out[r])
        got = ranks[r]["all_to_all_uneven"]
        start = sum(range(1, r + 1))
        want = np.concatenate([np.arange(start, start + r + 1) + 100 * j
                               for j in range(W)])
        np.testing.assert_array_equal(got, want)


def test_point_to_point_ring_matches_ppermute(ranks):
    import jax

    xs = _xs()
    fwd = _jax_shard_map(lambda v: jax.lax.ppermute(
        v, "x", [(i, (i + 1) % W) for i in range(W)]), xs)
    back = _jax_shard_map(lambda v: jax.lax.ppermute(
        v, "x", [(i, (i - 1) % W) for i in range(W)]), xs)
    for r in range(W):
        _close(ranks[r]["ring"], xs[(r - 1) % W])
        _close(ranks[r]["ring"], fwd[r])
        _close(ranks[r]["ring_back"], back[r])
    _close(ranks[3]["send_recv"], xs[0])


def test_rooted_ops(ranks):
    xs = _xs()
    for r in range(W):
        _close(ranks[r]["reduce"], xs.sum(0) if r == 2 else xs[r])
        _close(ranks[r]["broadcast"], xs[3])
        if r in (1, 2, 3):
            _close(ranks[r]["broadcast_g123"], xs[2])
        assert ranks[r]["broadcast_object_list"] == ["from 1", 1]
        np.testing.assert_array_equal(ranks[r]["scatter"],
                                      np.full((4, 6), 10.0 + r))
        assert ranks[r]["scatter_object_list"] == [{"to": r}]
    _close(ranks[0]["gather"], xs)
    assert all(ranks[r]["gather"] is None for r in (1, 2, 3))


def test_partial_ops(ranks):
    xs = _xs()
    want = np.zeros((4, 6), np.float32)
    want.reshape(-1)[6:12] = xs[1].reshape(-1)[6:12]
    _close(ranks[2]["partial_recv"], want)
    full = np.concatenate([xs[j].reshape(-1)[6 * j:6 * j + 6]
                           for j in range(W)]).reshape(4, 6)
    for r in range(W):
        _close(ranks[r]["partial_allgather"], full)


def test_group_env_stats_and_teardown(ranks):
    xs = _xs()
    for r in range(W):
        res = ranks[r]
        assert res["rank"] == r and res["world"] == W
        assert res["env_rank"] == r and res["backend"] == "gloo"
        _close(res["stream_all_reduce"], xs.sum(0))
        st = res["stats_after_all_reduce"]
        assert st["calls"]["all_reduce"] == 6
        assert st["bytes"]["all_reduce"] == 6 * 4 * 6 * 4
        assert res["stats"]["calls"]["barrier"] == 3
        assert res["stats"]["seconds"]["all_reduce"] > 0
        assert res["is_available"]
        assert res["initialized_after_destroy"] == "False"


def _fail_rank():
    if int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        raise SystemExit(3)
    time.sleep(60)


def _hang_rank():
    if int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        time.sleep(60)


def _contract_rank(out_dir):
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
            "PADDLE_LOCAL_RANK", "PADDLE_LOCAL_SIZE")
    with open(os.path.join(out_dir, os.environ["PADDLE_TRAINER_ID"]),
              "w") as fh:
        fh.write("|".join(os.environ[k] for k in keys))


def test_spawn_gives_each_rank_the_launch_contract(tmp_path):
    spawn(_contract_rank, (str(tmp_path),), nprocs=3, timeout=60)
    rows = [(tmp_path / str(r)).read_text().split("|") for r in range(3)]
    master = rows[0][2]
    assert master.startswith("127.0.0.1:") and int(master.split(":")[1]) > 0
    for r, row in enumerate(rows):
        assert row == [str(r), "3", master, str(r), "3"]


def test_spawn_fails_fast_on_a_failing_rank_and_kills_the_rest():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exit 3"):
        spawn(_fail_rank, nprocs=3, timeout=50)
    assert time.monotonic() - t0 < 40


def test_spawn_times_out_a_hung_rank():
    ctx = spawn(_hang_rank, nprocs=2, join=False)
    # rank 0 returns as soon as it has started (imported torch and this
    # module, which under many test workers at once takes seconds): wait for
    # it, bounded, so the window below measures only the hung rank 1
    deadline = time.monotonic() + 60
    while ctx.processes[0].is_alive() and time.monotonic() < deadline:
        ctx.processes[0].join(0.1)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] still running"):
        ctx.join(timeout=8)
    assert time.monotonic() - t0 < 40
    assert not any(p.is_alive() for p in ctx.processes)


def test_collectives_need_a_process_group():
    from paddle_tpu_torch.distributed import collective as C

    with pytest.raises(RuntimeError, match="init_parallel_env"):
        C.all_reduce(torch.ones(2))
