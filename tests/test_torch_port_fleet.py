"""Fleet on 4 gloo ranks (CPU): the topology, the mp layers, the
vocab-parallel fused CE, the reducer, the hybrid clip, ZeRO-1/2 and the
RNG tracker of the port, against the JAX package.

One group of 4 processes (``distributed.spawn``, loopback, a free port, a
join timeout) runs every rank-side case; this process builds the JAX
references:

* mp layers (dp 2 x mp 2): each layer's output and gradients, gathered
  over the mp ranks, against the JAX layer run dense on one device (its
  eager semantics), fp32 rtol 1e-5;
* the vocab-parallel fused CE over a 4-rank group against JAX's
  ``TestMpShardedParity`` setup (``tests/test_fused_cross_entropy.py:
  146-170``: shard_map over a 4-way "mp" axis, V 52, chunk 7) with
  ``ignore_index`` (-100, and 7: inside every rank's local column range,
  with valid labels that shift onto it), label smoothing 0.1 and z-loss
  1e-3: the per-token loss and dx, dW, fp32 rtol 2e-5 (JAX's own rule
  there);
* the reducer: buckets equal to JAX's ``assign_buckets``; with a
  parameter unused on rank 0 only, buckets complete out of order there
  and still post in index order, and the averaged gradients equal the
  mean of the ranks' own (zeros where unused); ``find_unused_parameters=
  False`` raises; ``no_sync`` reduces the accumulated gradient;
* ``HybridParallelClipGrad``'s norm and clipped gradients against JAX's
  global-norm clip on the full gradients;
* ZeRO-1 and ZeRO-2 over a sharding group of 4 (with a global-norm clip,
  weight decay, sizes not a multiple of 4) against JAX's unsharded AdamW
  (``apply_optimizer_update``) on the averaged gradients, rtol 1e-6;
* the topology's rank lists and each rank's group ranks against JAX's
  ``CommunicateTopology``/``HybridCommunicateGroup``;
* the RNG tracker: dropout masks per mp rank.

In this process, a world of one (no process group): ``fleet.init`` with
the strategy's amp (O2) and recompute passes, gradient merge against
one AdamW step on the mean gradient, and ``parallel.fused_head``: its
specs equal JAX's, its loss equals the unfused one.

Spawned ranks import torch, numpy and the port only.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

W = 4
SPAWN_TIMEOUT_S = 180
IGN = -100
CE_N, CE_H, CE_V = 24, 16, 52
CE_EPS, CE_Z = 0.1, 1e-3
# label: (label smoothing, z-loss, ignore_index); 7 lies in every rank's
# local column range [0, CE_V / W)
CE_CASES = {"plain": (0.0, 0.0, IGN), "smooth_z": (CE_EPS, CE_Z, IGN),
            "ign_in_shard": (0.0, 0.0, 7),
            "ign_in_shard_smooth_z": (CE_EPS, CE_Z, 7)}
ZERO_SHAPES = [(5, 3), (7,), (2, 2), (9, 2)]
ZERO_STEPS = 3


def _rs(*seed):
    return np.random.RandomState(list(seed))


def _mp_layer_data():
    r = _rs(1)
    return {
        "col_w": r.standard_normal((8, 12)).astype(np.float32),   # [in, out]
        "col_b": r.standard_normal((12,)).astype(np.float32),
        "row_w": r.standard_normal((12, 8)).astype(np.float32),
        "row_b": r.standard_normal((8,)).astype(np.float32),
        "emb_w": r.standard_normal((16, 8)).astype(np.float32),
        "x8": r.standard_normal((3, 5, 8)).astype(np.float32),
        "x12": r.standard_normal((3, 5, 12)).astype(np.float32),
        "ids": r.randint(0, 16, (3, 5)),
        "cot12": r.standard_normal((3, 5, 12)).astype(np.float32),
        "cot8": r.standard_normal((3, 5, 8)).astype(np.float32),
        "logits": r.standard_normal((6, 16)).astype(np.float32),
        "labels": np.array([3, IGN, 15, 8, 0, 11]),
        "ce_cot": r.standard_normal((6,)).astype(np.float32),
    }


def _ce_data(ign=IGN):
    r = _rs(2)
    x = r.standard_normal((CE_N, CE_H)).astype(np.float32)
    w = (r.standard_normal((CE_H, CE_V)) / np.sqrt(CE_H)).astype(np.float32)
    lab = r.randint(0, CE_V, CE_N)
    if ign >= 0:
        # valid labels at column `ign` of ranks 1-3's shards: shifted into
        # the shard, each equals ignore_index
        lab[1:W] = ign + CE_V // W * np.arange(1, W)
    lab[::5] = ign
    return x, w, lab


def _block(a, axis, i, n):
    k = a.shape[axis] // n
    return np.take(a, range(i * k, (i + 1) * k), axis=axis)


def _mp_layer_cases(hcg, out):
    from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_layers as L

    d = _mp_layer_data()
    g = hcg.get_model_parallel_group()
    i, n = g.rank, g.nranks
    t = torch.from_numpy
    res = {}
    for gather in (True, False):
        lay = L.ColumnParallelLinear(8, 12, has_bias=True,
                                     gather_output=gather)
        with torch.no_grad():
            lay.weight.copy_(t(_block(d["col_w"].T, 0, i, n)))
            lay.bias.copy_(t(_block(d["col_b"], 0, i, n)))
        x = t(d["x8"]).requires_grad_()
        y = lay(x)
        cot = t(d["cot12"] if gather else _block(d["cot12"], 2, i, n))
        (y * cot).sum().backward()
        res[f"column_{gather}"] = (y.detach().numpy(), x.grad.numpy(),
                                   lay.weight.grad.numpy(),
                                   lay.bias.grad.numpy())
    for parallel in (False, True):
        lay = L.RowParallelLinear(12, 8, has_bias=True,
                                  input_is_parallel=parallel)
        with torch.no_grad():
            lay.weight.copy_(t(_block(d["row_w"].T, 1, i, n)))
            lay.bias.copy_(t(d["row_b"]))
        x = t(_block(d["x12"], 2, i, n) if parallel else d["x12"])
        x.requires_grad_()
        y = lay(x)
        (y * t(d["cot8"])).sum().backward()
        res[f"row_{parallel}"] = (y.detach().numpy(), x.grad.numpy(),
                                  lay.weight.grad.numpy(),
                                  lay.bias.grad.numpy())
    lay = L.VocabParallelEmbedding(16, 8)
    with torch.no_grad():
        lay.weight.copy_(t(_block(d["emb_w"], 0, i, n)))
    y = lay(t(d["ids"]))
    (y * t(d["cot8"])).sum().backward()
    res["embedding"] = (y.detach().numpy(), lay.weight.grad.numpy())
    lay = L.ParallelCrossEntropy()
    logits = t(_block(d["logits"], 1, i, n)).requires_grad_()
    nll = lay(logits, t(d["labels"]))
    (nll * t(d["ce_cot"])).sum().backward()
    res["parallel_ce"] = (nll.detach().numpy(), logits.grad.numpy())
    res["marks"] = {n_: getattr(p, "mp_sharded", False) for n_, p in
                    L.ColumnParallelLinear(8, 12).named_parameters()}
    out["mp_layers"] = res


def _vocab_parallel_ce_cases(out):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.nn import functional as F

    world = C.get_group(0)
    r = world.rank
    res = {}
    for label, (eps, z, ign) in CE_CASES.items():
        x, w, lab = _ce_data(ign)
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(_block(w.T, 0, r, W).copy()).requires_grad_()
        nll = F.fused_linear_cross_entropy(
            xt, wt, torch.from_numpy(lab), ignore_index=ign,
            reduction="none", label_smoothing=eps, z_loss=z, chunk_tokens=7,
            mp_group=world)
        nll.sum().backward()
        res[label] = (nll.detach().numpy(), xt.grad.numpy(),
                      wt.grad.numpy())
    # the "mean" reduction: over the non-ignored tokens
    x, w, lab = _ce_data()
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(_block(w.T, 0, r, W).copy())
    res["mean"] = float(F.fused_linear_cross_entropy(
        xt, wt, torch.from_numpy(lab), ignore_index=IGN, mp_group=world))
    out["vocab_ce"] = res


class _Tiny(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        r = _rs(seed)
        self.a = torch.nn.Parameter(torch.from_numpy(
            r.standard_normal((3, 4)).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.from_numpy(
            r.standard_normal((4,)).astype(np.float32)))
        self.c = torch.nn.Parameter(torch.from_numpy(
            r.standard_normal((4, 2)).astype(np.float32)))
        self.d = torch.nn.Parameter(torch.from_numpy(
            r.standard_normal((2,)).astype(np.float32)))

    def forward(self, x, use_b=True):
        h = x @ self.a
        if use_b:
            h = h + self.b
        return (h @ self.c + self.d).square().sum()


def _reducer_cases(out):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.parallel import DataParallel

    r = C.get_group(0).rank
    x = torch.from_numpy(_rs(3, r).standard_normal((5, 3))
                         .astype(np.float32))
    x2 = torch.from_numpy(_rs(4, r).standard_normal((5, 3))
                          .astype(np.float32))
    res = {}
    # rank-divergent use: b unused on rank 0; one bucket a parameter
    model = _Tiny(seed=10 + r)             # the wrap broadcasts rank 0's
    dp = DataParallel(model, comm_buffer_size=1e-6,
                      last_comm_buffer_size=1e-6,
                      find_unused_parameters=True)
    res["synced_init"] = {n: p.detach().numpy().copy()
                          for n, p in model.named_parameters()}
    twin = _Tiny(seed=10)
    twin(x, use_b=r != 0).backward()
    res["local"] = {n: (None if p.grad is None else p.grad.numpy())
                    for n, p in twin.named_parameters()}
    dp(x, use_b=r != 0).backward()
    res["avg"] = {n: p.grad.numpy() for n, p in model.named_parameters()}
    res["buckets"] = [[tuple(s) for s in b.shapes]
                      for b in dp.reducer.buckets]
    res["completed"] = list(dp.reducer.completed)
    res["posted"] = list(dp.reducer.posted)
    # every rank skips b, without find_unused_parameters: a clear error
    model2 = _Tiny(seed=10)
    dp2 = DataParallel(model2, comm_buffer_size=1e-6,
                       last_comm_buffer_size=1e-6)
    try:
        dp2(x, use_b=False).backward()
        res["unused_error"] = None
    except RuntimeError as e:
        res["unused_error"] = str(e)
    model2.zero_grad(set_to_none=True)
    dp2(x).backward()                      # the next backward works
    res["after_error"] = {n: p.grad.numpy()
                          for n, p in model2.named_parameters()}
    # no_sync: the accumulated gradient is reduced by the next backward
    model3 = _Tiny(seed=10)
    dp3 = DataParallel(model3)
    with dp3.no_sync():
        dp3(x).backward()
    res["unsynced"] = model3.a.grad.numpy().copy()
    dp3(x2).backward()
    res["no_sync"] = {n: p.grad.numpy() for n, p in model3.named_parameters()}
    twin = _Tiny(seed=10)
    twin(x).backward()
    twin(x2).backward()
    res["local_sum"] = {n: p.grad.numpy() for n, p in twin.named_parameters()}
    out["reducer"] = res


def _clip_grads():
    """(mp-sharded full gradient [6, 4], replicated gradient [5])."""
    r = _rs(5)
    return (r.standard_normal((6, 4)).astype(np.float32),
            r.standard_normal((5,)).astype(np.float32))


def _clip_cases(hcg, out):
    from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
        hybrid_parallel_optimizer import HybridParallelClipGrad
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    g = hcg.get_model_parallel_group()
    full, repl = _clip_grads()
    shard = torch.nn.Parameter(torch.zeros(3, 4))
    shard.mp_sharded = True
    norm_w = torch.nn.Parameter(torch.zeros(5))
    res = {}
    for c in (0.5, 1e3):
        clip = HybridParallelClipGrad(ClipGradByGlobalNorm(c), hcg)
        got = clip([(shard, torch.from_numpy(_block(full, 0, g.rank, 2))),
                    (norm_w, torch.from_numpy(repl))])
        res[c] = (float(clip.last_norm), got[0][1].numpy(),
                  got[1][1].numpy())
    out["clip"] = res


def _zero_grads(rank, t):
    r = _rs(6, rank, t)
    return [r.standard_normal(s).astype(np.float32) for s in ZERO_SHAPES]


def _zero_init():
    r = _rs(7)
    return [r.standard_normal(s).astype(np.float32) for s in ZERO_SHAPES]


def _zero_cases(out):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    res = {}
    for stage in (1, 2):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"sharding_degree": W}
        strategy.sharding_configs = {"stage": stage}
        hcg = fleet.init(strategy=strategy)
        rank = hcg.get_sharding_parallel_rank()
        params = [torch.nn.Parameter(torch.from_numpy(a))
                  for a in _zero_init()]
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=1e-2, parameters=params, weight_decay=0.1,
            grad_clip=ClipGradByGlobalNorm(1.0)))
        norms = []
        for t in range(ZERO_STEPS):
            gs = _zero_grads(rank, t)
            sum((p * torch.from_numpy(g)).sum()
                for p, g in zip(params, gs)).backward()
            held = [p.grad is not None for p in params]
            opt.step()
            norms.append(float(opt.last_grad_norm))
            opt.clear_grad()
        base = opt._base_opt
        res[stage] = {
            "params": [p.detach().numpy().copy() for p in params],
            "state_numel": sum(st["m"].numel()
                               for st in base._state.values()),
            "full_grads_held": held, "norms": norms,
            "step": base._step_count}
    out["zero"] = res


def _topology_and_rng_cases(hcg, out):
    from paddle_tpu_torch.distributed.fleet import rng
    from paddle_tpu_torch.nn import functional as F

    out["groups"] = {
        "dp": hcg.get_data_parallel_group().ranks,
        "mp": hcg.get_model_parallel_group().ranks,
        "pp": hcg.get_pipe_parallel_group().ranks,
        "sharding": hcg.get_sharding_parallel_group().ranks,
        "dp_sharding": hcg.get_dp_sharding_parallel_group().ranks,
        "mode": hcg.get_parallel_mode(),
        "coord": (hcg.get_data_parallel_rank(),
                  hcg.get_model_parallel_rank())}
    rng.model_parallel_random_seed(1234)
    tracker = rng.get_rng_state_tracker()
    with tracker.rng_state():
        local = F.dropout(torch.ones(64), p=0.5).numpy()
    glob = F.dropout(torch.ones(64), p=0.5).numpy()
    rng.model_parallel_random_seed(1234)
    with tracker.rng_state():
        again = F.dropout(torch.ones(64), p=0.5).numpy()
    out["rng"] = (local, glob, again)


def _fleet_rank(out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    dist.init_parallel_env()
    out = {}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    hcg = fleet.init(strategy=strategy)
    _mp_layer_cases(hcg, out)
    _clip_cases(hcg, out)
    _topology_and_rng_cases(hcg, out)
    _vocab_parallel_ce_cases(out)
    _reducer_cases(out)
    _zero_cases(out)
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fleet"))
    spawn(_fleet_rank, (out,), nprocs=W, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(W):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _jax_grads(layer, x, cot, params):
    """Output and gradients (x, then `params`) of a JAX layer run dense."""
    import paddle_tpu as paddle

    xt = paddle.to_tensor(x, stop_gradient=False)
    y = layer(xt)
    (y * paddle.to_tensor(cot)).sum().backward()
    return ([np.asarray(y._value)]
            + [None if xt.grad is None else np.asarray(xt.grad._value)]
            + [np.asarray(p.grad._value) for p in params])


def _set(p, arr):
    import jax.numpy as jnp

    p._set_value(jnp.asarray(arr))


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear_matches_the_dense_jax_layer(ranks, gather):
    from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear)

    d = _mp_layer_data()
    jl = ColumnParallelLinear(8, 12, has_bias=True, gather_output=True)
    _set(jl.weight, d["col_w"])
    _set(jl.bias, d["col_b"])
    y, dx, dw, db = _jax_grads(jl, d["x8"], d["cot12"], [jl.weight, jl.bias])
    for r in range(W):
        ry, rdx, _, _ = ranks[r]["mp_layers"][f"column_{gather}"]
        i = r % 2
        _close(ry, y if gather else _block(y, 2, i, 2))
        _close(rdx, dx)
    pair = [ranks[i]["mp_layers"][f"column_{gather}"] for i in range(2)]
    _close(np.concatenate([p[2] for p in pair]).T, dw)
    _close(np.concatenate([p[3] for p in pair]), db)


@pytest.mark.parametrize("parallel", [False, True])
def test_row_parallel_linear_matches_the_dense_jax_layer(ranks, parallel):
    from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
        RowParallelLinear)

    d = _mp_layer_data()
    jl = RowParallelLinear(12, 8, has_bias=True, input_is_parallel=True)
    _set(jl.weight, d["row_w"])
    _set(jl.bias, d["row_b"])
    y, dx, dw, db = _jax_grads(jl, d["x12"], d["cot8"], [jl.weight, jl.bias])
    for r in range(W):
        ry, rdx, _, rdb = ranks[r]["mp_layers"][f"row_{parallel}"]
        _close(ry, y)
        _close(rdx, _block(dx, 2, r % 2, 2) if parallel else dx)
        _close(rdb, db)
    pair = [ranks[i]["mp_layers"][f"row_{parallel}"] for i in range(2)]
    _close(np.concatenate([p[2] for p in pair], axis=1).T, dw)


def test_vocab_parallel_embedding_matches_the_dense_jax_layer(ranks):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
        VocabParallelEmbedding)

    d = _mp_layer_data()
    jl = VocabParallelEmbedding(16, 8)
    _set(jl.weight, d["emb_w"])
    y = jl(paddle.to_tensor(d["ids"]))
    (y * paddle.to_tensor(d["cot8"])).sum().backward()
    for r in range(W):
        _close(ranks[r]["mp_layers"]["embedding"][0], np.asarray(y._value))
    dw = np.concatenate([ranks[i]["mp_layers"]["embedding"][1]
                         for i in range(2)])
    _close(dw, np.asarray(jl.weight.grad._value))


def test_parallel_cross_entropy_matches_the_dense_jax_layer(ranks):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
        ParallelCrossEntropy)

    d = _mp_layer_data()
    logits = paddle.to_tensor(d["logits"], stop_gradient=False)
    nll = ParallelCrossEntropy()(logits, paddle.to_tensor(d["labels"]))
    (nll * paddle.to_tensor(d["ce_cot"])).sum().backward()
    want = np.asarray(nll._value).reshape(-1)
    for r in range(W):
        _close(ranks[r]["mp_layers"]["parallel_ce"][0].reshape(-1), want)
    dl = np.concatenate([ranks[i]["mp_layers"]["parallel_ce"][1]
                         for i in range(2)], axis=1)
    _close(dl, np.asarray(logits.grad._value))
    assert ranks[0]["mp_layers"]["marks"] == {"weight": True, "bias": True}


def _jax_vocab_parallel_ce(eps, z, ign=IGN):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.mesh import shard_map_compat
    from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy_loss

    x, w, lab = _ce_data(ign)
    mesh = Mesh(np.array(jax.devices()[:W]), ("mp",))

    def body(x_, w_, lab_):
        return fused_linear_cross_entropy_loss(
            x_, w_, lab_, ignore_index=ign, label_smoothing=eps, z_loss=z,
            chunk_tokens=7, chunk_vocab=5, variant="tokens", mp_axis="mp")

    sharded = shard_map_compat(body, mesh, in_specs=(P(), P(None, "mp"),
                                                     P()), out_specs=P())
    labj = jnp.asarray(lab)
    nll = sharded(jnp.asarray(x), jnp.asarray(w), labj)
    gx, gw = jax.grad(lambda a, b: jnp.sum(sharded(a, b, labj)),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(nll), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("label,eps,z", [(k, eps, z) for k, (eps, z, _)
                                         in CE_CASES.items()])
def test_vocab_parallel_fused_ce_matches_jax_mp_sharded(ranks, label, eps,
                                                        z):
    ign = CE_CASES[label][2]
    nll, gx, gw = _jax_vocab_parallel_ce(eps, z, ign)
    for r in range(W):
        rn, rdx, _ = ranks[r]["vocab_ce"][label]
        np.testing.assert_allclose(rn, nll, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(rdx, gx, rtol=2e-5, atol=2e-5)
        assert (rn[::5] == 0).all()          # ignored tokens
        assert (rn[1:W] != 0).all()          # labels shifted onto `ign`
    dw = np.concatenate([ranks[r]["vocab_ce"][label][2] for r in range(W)])
    np.testing.assert_allclose(dw.T, gw, rtol=2e-5, atol=2e-5)


def test_vocab_parallel_mean_is_over_the_valid_tokens(ranks):
    nll, _, _ = _jax_vocab_parallel_ce(0.0, 0.0)
    _, _, lab = _ce_data()
    want = nll.sum() / (lab != IGN).sum()
    for r in range(W):
        np.testing.assert_allclose(ranks[r]["vocab_ce"]["mean"], want,
                                   rtol=2e-5)


def test_local_labels_never_collide_with_ignore_index():
    from paddle_tpu_torch.ops.cuda.fused_ce import local_labels

    lab = torch.tensor([-100, 15900, 16005, 31999, 3])
    # a label 100 below the shard would shift onto -100 without the guard
    np.testing.assert_array_equal(local_labels(lab, 16000, 16000, -100),
                                  [-1, -1, 5, 15999, -1])
    np.testing.assert_array_equal(
        local_labels(torch.tensor([-1, 4, 16001]), 16000, 16000, -1),
        [-1, -1, 1])
    # ignore_index inside the shard's local range: the valid label 16007
    # shifts to 7 and stays; the ignored ones leave the range
    np.testing.assert_array_equal(
        local_labels(torch.tensor([7, 16007, 7, 31999]), 16000, 16000, 7),
        [-1, 7, -1, 15999])


def test_reducer_buckets_equal_jax_assign_buckets():
    import jax.numpy as jnp

    from paddle_tpu.distributed.reducer import assign_buckets as jax_assign
    from paddle_tpu_torch.distributed.reducer import assign_buckets

    shapes = [(256, 256), (300,), (512, 512), (7,), (1024, 300), (64,),
              (256, 256)]
    dtypes = [torch.float32, torch.float32, torch.bfloat16, torch.float32,
              torch.float32, torch.bfloat16, torch.float32]
    params = [torch.nn.Parameter(torch.zeros(s, dtype=d))
              for s, d in zip(shapes, dtypes)]
    params[3].requires_grad_(False)

    class Fake:
        def __init__(self, p):
            self.stop_gradient = not p.requires_grad
            self._value = jnp.zeros(p.shape, jnp.bfloat16
                                    if p.dtype == torch.bfloat16
                                    else jnp.float32)
            self.size, self.shape = p.numel(), tuple(p.shape)

    fakes = [Fake(p) for p in params]
    for mb, last in ((1, 0.3), (0.5, 0.1)):
        want = jax_assign(fakes, mb, last)
        got = assign_buckets(params, mb, last)
        assert [b.shapes for b in got] == [b.shapes for b in want]
        assert [str(b.dtype).split(".")[-1] for b in got] == \
            [b.dtype.name for b in want]
    # a tied weight listed twice takes one slot
    tied = assign_buckets(params + [params[0]], 1, 0.3)
    slots = [id(p) for b in tied for p in b.params]
    assert len(slots) == len(set(slots)) == 6


def test_reducer_posts_in_index_order_with_rank_divergent_use(ranks):
    locals_ = [ranks[r]["reducer"]["local"] for r in range(W)]
    for r in range(W):
        res = ranks[r]["reducer"]
        # one bucket a parameter, reverse order: d, c, b, a
        assert res["buckets"] == [[(2,)], [(4, 2)], [(4,)], [(3, 4)]]
        assert res["posted"] == [0, 1, 2, 3]
        for name in ("a", "b", "c", "d"):
            want = np.mean([np.zeros_like(locals_[1][name])
                            if loc[name] is None else loc[name]
                            for loc in locals_], 0)
            _close(res["avg"][name], want)
        # the wrap broadcast rank 0's parameters
        for name, v in res["synced_init"].items():
            np.testing.assert_array_equal(
                v, ranks[0]["reducer"]["synced_init"][name])
    # b's bucket (2) completes last on rank 0, after a's (3), yet posts
    # before it
    assert ranks[0]["reducer"]["completed"] == [0, 1, 3, 2]
    assert ranks[1]["reducer"]["completed"] == [0, 1, 2, 3]
    assert locals_[0]["b"] is None


def test_reducer_raises_on_unused_parameters_and_recovers(ranks):
    for r in range(W):
        res = ranks[r]["reducer"]
        assert "find_unused_parameters=True" in res["unused_error"]
        assert "(4,)" in res["unused_error"]
        for name, g in res["after_error"].items():
            assert np.isfinite(g).all()


def test_no_sync_reduces_the_accumulated_gradient(ranks):
    sums = [ranks[r]["reducer"]["local_sum"] for r in range(W)]
    for r in range(W):
        res = ranks[r]["reducer"]
        for name, g in res["no_sync"].items():
            _close(g, np.mean([s[name] for s in sums], 0))
    # inside no_sync the gradient stayed local (ranks differ)
    assert not np.allclose(ranks[0]["reducer"]["unsynced"],
                           ranks[1]["reducer"]["unsynced"])


@pytest.mark.parametrize("clip_norm", [0.5, 1e3])
def test_hybrid_clip_matches_the_global_norm_clip(ranks, clip_norm):
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxGlobalNorm
    from paddle_tpu.optimizer import SGD as JaxSGD
    from paddle_tpu.parallel.train_step import apply_optimizer_update

    full, repl = _clip_grads()
    zeros = [paddle.to_tensor(np.zeros_like(g)) for g in (full, repl)]
    sgd = JaxSGD(learning_rate=1.0, parameters=zeros,
                 grad_clip=JaxGlobalNorm(clip_norm))
    new, _ = apply_optimizer_update(
        sgd, [p._value for p in zeros], [jnp.asarray(full),
                                         jnp.asarray(repl)],
        [{}, {}], jnp.float32(1.0), jnp.int32(1))
    norm = np.sqrt((full.astype(np.float64) ** 2).sum()
                   + (repl.astype(np.float64) ** 2).sum())
    for r in range(W):
        gn, g_shard, g_repl = ranks[r]["clip"][clip_norm]
        np.testing.assert_allclose(gn, norm, rtol=1e-6)
        _close(g_shard, -_block(np.asarray(new[0]), 0, r % 2, 2), rtol=1e-6)
        _close(g_repl, -np.asarray(new[1]), rtol=1e-6)


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_matches_unsharded_adamw(ranks, stage):
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxGlobalNorm
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu.parallel.train_step import apply_optimizer_update

    jparams = [paddle.to_tensor(a) for a in _zero_init()]
    opt = JaxAdamW(learning_rate=1e-2, parameters=jparams, weight_decay=0.1,
                   grad_clip=JaxGlobalNorm(1.0))
    vals = [p._value for p in jparams]
    states = [opt._init_state(p) for p in jparams]
    norms = []
    for t in range(ZERO_STEPS):
        gs = [np.mean([_zero_grads(r, t)[i] for r in range(W)], 0)
              for i in range(len(ZERO_SHAPES))]
        norms.append(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for g in gs)))
        vals, states = apply_optimizer_update(
            opt, vals, [jnp.asarray(g) for g in gs], states,
            jnp.float32(1e-2), jnp.int32(t + 1))
    for r in range(W):
        res = ranks[r]["zero"][stage]
        for got, want in zip(res["params"], vals):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-5)
        assert res["step"] == ZERO_STEPS
        # each rank's state covers its 1/4 slice (padded to a multiple)
        assert res["state_numel"] == sum(-(-int(np.prod(s)) // W)
                                         for s in ZERO_SHAPES)
        # ZeRO-2 drops the full gradients in backward; ZeRO-1 keeps them
        assert res["full_grads_held"] == [stage == 1] * len(ZERO_SHAPES)


def test_topology_rank_lists_equal_jax():
    from paddle_tpu.distributed.fleet.topology import (
        CommunicateTopology as JaxTopo)
    from paddle_tpu_torch.distributed.fleet.topology import (
        CommunicateTopology)

    names = ["pipe", "data", "sharding", "sep", "model"]
    for dims in ([1, 2, 1, 1, 2], [2, 2, 2, 1, 1], [1, 1, 2, 2, 2],
                 [2, 1, 3, 1, 2]):
        a, b = CommunicateTopology(names, dims), JaxTopo(names, dims)
        assert a.world_size() == b.world_size()
        for n in names:
            assert a.get_comm_list(n) == b.get_comm_list(n)
            assert a.get_dim(n) == b.get_dim(n)
            for i in range(a.get_dim(n)):
                assert a.get_axis_list(n, i) == b.get_axis_list(n, i)
        for r in range(a.world_size()):
            assert a.get_coord(r) == b.get_coord(r)
            assert a.get_rank_from_stage(r, pipe=0) == \
                b.get_rank_from_stage(r, pipe=0)


def test_hcg_groups_equal_jax_per_rank(ranks, monkeypatch):
    from paddle_tpu.distributed.fleet.topology import (
        CommunicateTopology as JaxTopo)
    from paddle_tpu.distributed.fleet.topology import (
        HybridCommunicateGroup as JaxHcg)
    from paddle_tpu.distributed.mesh import set_mesh

    names = ["pipe", "data", "sharding", "sep", "model"]
    for r in range(W):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(r))
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(W))
        try:
            j = JaxHcg(JaxTopo(names, [1, 2, 1, 1, 2]))
        finally:
            set_mesh(None)
        got = ranks[r]["groups"]
        assert got["dp"] == j.get_data_parallel_group().ranks
        assert got["mp"] == j.get_model_parallel_group().ranks
        assert got["pp"] == j.get_pipe_parallel_group().ranks
        assert got["sharding"] == j.get_sharding_parallel_group().ranks
        assert got["dp_sharding"] == \
            j.get_dp_sharding_parallel_group().ranks
        assert got["mode"] == j.get_parallel_mode()
        assert got["coord"] == (j.get_data_parallel_rank(),
                                j.get_model_parallel_rank())


def test_rng_tracker_gives_each_mp_rank_its_own_stream(ranks):
    loc = [ranks[r]["rng"][0] for r in range(W)]
    glob = [ranks[r]["rng"][1] for r in range(W)]
    # mp rank = r % 2: ranks 0 and 2 share a stream, 0 and 1 do not
    np.testing.assert_array_equal(loc[0], loc[2])
    np.testing.assert_array_equal(loc[1], loc[3])
    assert not np.array_equal(loc[0], loc[1])
    for r in range(W):
        np.testing.assert_array_equal(glob[r], glob[0])
        np.testing.assert_array_equal(ranks[r]["rng"][2], loc[r])
        assert set(np.unique(loc[r])) <= {0.0, 2.0}


def test_strategy_round_trip_matches_jax():
    from paddle_tpu.distributed.fleet.base.distributed_strategy import (
        DistributedStrategy as JaxStrategy)
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy

    a, b = DistributedStrategy(), JaxStrategy()
    for s in (a, b):
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
        s.sharding_configs = {"stage": 2}
    assert a.to_dict() == b.to_dict()
    assert DistributedStrategy().from_dict(a.to_dict()).to_dict() == \
        a.to_dict()


@pytest.fixture
def world_of_one():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import set_mesh

    fleet.reset()
    yield fleet
    fleet.reset()
    set_mesh(None)


def test_strategy_passes_and_world_of_one(world_of_one):
    """A world of one needs no process group: fleet.init builds solo
    groups; the strategy's amp (O2) casts the model, its recompute sets
    the per-layer "full" policy that TrainStep applies."""
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    fleet = world_of_one
    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs = {"use_pure_fp16": True, "dtype": "bfloat16"}
    strategy.recompute = True
    hcg = fleet.init(strategy=strategy)
    assert hcg.get_parallel_mode() == fleet.ParallelMode.DATA_PARALLEL
    assert fleet.worker_index() == 0 and fleet.worker_num() == 1
    model = fleet.distributed_model(
        LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=1))
    assert isinstance(model, DataParallel) and model.reducer is None
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, parameters=model.parameters(),
        multi_precision=True))
    step = TrainStep(model, lambda out, lab: out, opt, collect_metrics=True)
    assert step.remat_policy == "full"
    b = {"input_ids": np.arange(32).reshape(2, 16) % 256,
         "labels": (np.arange(32).reshape(2, 16) + 1) % 256}
    losses = [float(step(b)) for _ in range(2)]
    assert losses[1] < losses[0]
    assert step.last_metrics()["grad_norm"] > 0


def test_gradient_merge_applies_the_mean_of_k_steps(world_of_one):
    from paddle_tpu_torch.optimizer import AdamW

    fleet = world_of_one
    strategy = fleet.DistributedStrategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    fleet.init(strategy=strategy)
    init = _zero_init()
    merged = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    plain = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = fleet.distributed_optimizer(AdamW(learning_rate=1e-2,
                                            parameters=merged))
    ref = AdamW(learning_rate=1e-2, parameters=plain)
    g = [_zero_grads(0, t) for t in range(2)]
    for t in range(2):
        for p, gi in zip(merged, g[t]):
            p.grad = torch.from_numpy(gi)
        opt.step()
        if t == 0:        # the first micro step only accumulates
            for p, a in zip(merged, init):
                np.testing.assert_array_equal(p.detach().numpy(), a)
    for p, g0, g1 in zip(plain, *g):
        p.grad = torch.from_numpy((g0 + g1) / 2)
    ref.step()
    for a, b in zip(merged, plain):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [
    {}, {"reduction": "sum", "label_smoothing": 0.1}, {"soft_label": True},
    {"reduction": "none"}, {"use_fused": False}, {"ignore_index": 7}],
    ids=["mean", "sum_smooth", "soft", "none", "unfused", "ignore7"])
def test_fused_ce_spec_equals_jax(kw):
    from paddle_tpu.nn.layer.loss import CrossEntropyLoss as JaxCE
    from paddle_tpu.parallel.fused_head import fused_ce_spec as jax_spec
    from paddle_tpu_torch.nn.layer.loss import CrossEntropyLoss
    from paddle_tpu_torch.parallel.fused_head import fused_ce_spec

    assert fused_ce_spec(CrossEntropyLoss(**kw)) == jax_spec(JaxCE(**kw))


@pytest.mark.parametrize("parallel", [True, False])
def test_criterion_spec_equals_jax(parallel):
    from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny
    from paddle_tpu.parallel.fused_head import fused_ce_spec as jax_spec
    from paddle_tpu_torch.models import (LlamaPretrainingCriterion,
                                         llama_tiny_config)
    from paddle_tpu_torch.parallel.fused_head import fused_ce_spec

    kw = dict(use_parallel_cross_entropy=parallel)
    assert fused_ce_spec(LlamaPretrainingCriterion(llama_tiny_config(**kw))) \
        == jax_spec(JaxCrit(jax_tiny(**kw)))


class _Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        r = _rs(8)
        self.norm_w = torch.nn.Parameter(torch.from_numpy(
            r.uniform(0.5, 1.5, 16).astype(np.float32)))
        self.lm_head = torch.nn.Linear(16, 40, bias=False)
        with torch.no_grad():
            self.lm_head.weight.copy_(torch.from_numpy(
                r.standard_normal((40, 16)).astype(np.float32) * 0.3))

    def forward_features(self, x):
        return x * self.norm_w

    def forward(self, x):
        return self.lm_head(self.forward_features(x))


@pytest.mark.parametrize("kw", [{}, {"reduction": "sum",
                                     "label_smoothing": 0.1}],
                         ids=["mean", "sum_smooth"])
def test_fused_head_loss_equals_the_unfused_loss(kw):
    from paddle_tpu_torch.nn.layer.loss import CrossEntropyLoss
    from paddle_tpu_torch.parallel.fused_head import (fused_head_loss,
                                                      fused_head_spec)

    head, loss_fn = _Head(), CrossEntropyLoss(**kw)
    r = _rs(9)
    x = torch.from_numpy(r.standard_normal((3, 7, 16)).astype(np.float32))
    lab = torch.from_numpy(r.randint(0, 40, (3, 7)))
    lab[0, ::3] = -100
    spec = fused_head_spec(head, loss_fn)
    got = fused_head_loss(head, x, lab, spec)
    got.backward()
    g_fused = head.lm_head.weight.grad.clone()
    head.zero_grad()
    want = loss_fn(head(x), lab)
    want.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(g_fused.numpy(),
                               head.lm_head.weight.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
