"""The port's semi-automatic parallelism (``distributed.auto_parallel``)
on 4 gloo ranks (CPU) against the JAX package's global values.

The placements and ``ProcessMesh`` behave as JAX's. On a dp 2 x mp 2
mesh (whose dims reuse the rank mesh's groups), on the same grid named
``["x", "y"]`` and on a permuted grid ``[[3, 1], [2, 0]]`` (own groups),
every ``shard_tensor``/``reshard`` transition's local shards, assembled
by their coordinates, equal the JAX package's global value (equal
arrays; the port's value moves through gloo bit for bit), and each
rank's shard is the numpy block of its coordinates. The rule for
``Partial``: built from a global value, the rank at coordinate 0 holds
it and the others zeros ("sum"), so p->r gives the JAX value; built
from local values (``dtensor_from_local``), p->r sums them. Every
transition carries the gradient: w's gradient through ``shard_tensor``
and ``reshard``, each rank summing its part against the cotangent's
block, equals on every rank JAX's global gradient under ``jax.grad``
(the placements as ``device_put``s), bit for bit. ``shard_layer``'s
default marks the LLaMA's mp-sharded weights ``Shard(split_axis)`` on
the mp dim, and ``unshard_dtensor`` of each trained parameter is JAX's.

``shard_dataloader``'s rows equal JAX ``_ShardedLoader``'s, a tail that
does not divide included. ``to_static`` trains the tiny LLaMA at dp 2 x
mp 2 for 3 steps from the JAX model's weights (``models.convert``),
with the loss on the gathered logits (JAX ``test_to_static_trains_llama_
on_mesh``): losses within rtol 1e-5 of JAX's, the parameters gathered
over mp within atol 2e-5 (the rules of ``test_torch_port_hybrid_train``),
the eval loss and the predict logits (full vocabulary on every rank) to
the same rules. The same run fed by ``shard_dataloader`` gives the same
losses (the step cuts nothing twice). ``sharding_degree`` 4 shards the
Adam moments 1/4 a rank with JAX's losses. A Paddle-API ``Layer`` (the
Engine test's ``Reg``) trains through ``to_static`` at dp 4 as JAX's
DistModel does, and its ``Engine`` writes and reads a file a rank.
``save_group_sharded_model`` under ZeRO-3 writes the
gathered state, which ``paddle_tpu.load`` reads.

Spawned ranks import torch, numpy and the port only.
"""
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

SEED = 0
SPAWN_TIMEOUT_S = 240
GLOBAL = np.random.RandomState(11).randn(8, 12).astype(np.float32)
# the cotangent of the gradient cases: loss = sum(reshard(w) * COT)
COT = np.random.RandomState(12).randn(8, 12).astype(np.float32)
# (src placements, dst placements) over a 2-d mesh, by name
CASES = {
    "s0r_to_rr": (("S0", "R"), ("R", "R")),
    "rr_to_s1r": (("R", "R"), ("S1", "R")),
    "rr_to_rs0": (("R", "R"), ("R", "S0")),
    "pr_to_rr": (("P", "R"), ("R", "R")),
    "pr_to_s0r": (("P", "R"), ("S0", "R")),
    "rp_to_rs1": (("R", "P"), ("R", "S1")),
    "s0r_to_s1r": (("S0", "R"), ("S1", "R")),
    "s0s1_to_s1s0": (("S0", "S1"), ("S1", "S0")),
    "s0s0_to_rr": (("S0", "S0"), ("R", "R")),
    "rs0_to_s0r": (("R", "S0"), ("S0", "R")),
    "pp_to_rr": (("P", "P"), ("R", "R")),
    "s1r_to_pr": (("S1", "R"), ("P", "R")),
    "pmax_to_rr": (("Pmax", "R"), ("R", "R")),
}
MESHES = {"dp_mp": ([[0, 1], [2, 3]], ["dp", "mp"]),
          "xy": ([[0, 1], [2, 3]], ["x", "y"]),
          "xy_permuted": ([[3, 1], [2, 0]], ["x", "y"])}


def _pl(name, api):
    if name == "R":
        return api.Replicate()
    if name.startswith("Pmax"):
        return api.Partial("max")
    if name == "P":
        return api.Partial()
    return api.Shard(int(name[1:]))


def _ids_labels(n=8, seq=16, vocab=256):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (n, seq)).astype(np.int64)
    labels = rng.randint(0, vocab, (n, seq)).astype(np.int64)
    return ids, labels


def _reg_data(n=8):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 8).astype(np.float32)
    w = rng.randn(8, 1).astype(np.float32)
    return x, (x @ w + 0.05 * rng.randn(n, 1)).astype(np.float32)


def _reg(pkg):
    nn, F = pkg.nn, pkg.nn.functional

    class Reg(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 1)

        def forward(self, x):
            return self.fc2(F.relu(self.fc1(x)))

    return Reg()


def _grad_through(ap, mesh, mesh_name, src, dst, dst_mesh_name=None,
                  dst_mesh=None):
    """w.grad of loss = sum(reshard(shard_tensor(w)) * COT), each rank
    summing its part against COT's block under `dst` (a Partial part
    against the whole COT: its gradient is the whole one)."""
    from paddle_tpu_torch import Tensor

    dst_mesh = dst_mesh or mesh
    w = torch.from_numpy(GLOBAL.copy()).requires_grad_()
    t = ap.shard_tensor(Tensor(w), mesh, [_pl(p, ap) for p in src])
    r = ap.reshard(t, dst_mesh, [_pl(p, ap) for p in dst])
    assert not r.stop_gradient and r._value.grad_fn is not None
    cot = _expected_local(dst_mesh_name or mesh_name,
                          ["R" if p.startswith("P") else p for p in dst],
                          dst_mesh.coord(), COT)
    (r._value * torch.from_numpy(cot)).sum().backward()
    return w.grad.numpy()


def _reshard_cases(out):
    from paddle_tpu_torch.distributed import auto_parallel as ap

    res = {}
    for mname, (grid, names) in MESHES.items():
        mesh = ap.ProcessMesh(grid, dim_names=names)
        for label, (src, dst) in CASES.items():
            t = ap.shard_tensor(GLOBAL, mesh, [_pl(p, ap) for p in src])
            src_global = ap.unshard_dtensor(t).numpy()
            r = ap.reshard(t, mesh, [_pl(p, ap) for p in dst])
            res[(mname, label)] = {
                "coord": mesh.coord(), "src_local": t._value.numpy(),
                "src_global": src_global, "local": r._value.numpy(),
                "global": ap.unshard_dtensor(r).numpy(),
                "global_shape": r._global_shape,
                "grad": _grad_through(ap, mesh, mname, src, dst)}
        # a Partial of local values, and a reshard across meshes
        local = torch.full((2, 3), float(torch.distributed.get_rank() + 1))
        p = ap.dtensor_from_local(local, mesh, [ap.Partial(), ap.Replicate()])
        res[(mname, "local_partial")] = ap.reshard(
            p, mesh, [ap.Replicate(), ap.Replicate()])._value.numpy()
    m1 = ap.ProcessMesh(*MESHES["dp_mp"])
    m2 = ap.ProcessMesh(*MESHES["xy_permuted"])
    t = ap.shard_tensor(GLOBAL, m1, [ap.Shard(0), ap.Shard(1)])
    r = ap.reshard(t, m2, [ap.Shard(1), ap.Replicate()])
    res["cross_mesh"] = {
        "local": r._value.numpy(), "coord": m2.coord(),
        "global": ap.unshard_dtensor(r).numpy(),
        "grad": _grad_through(ap, m1, "dp_mp", ("S0", "S1"), ("S1", "R"),
                              "xy_permuted", m2)}
    # the autograd link of a local slice: each rank sums its own rows,
    # and the global gradient is all ones on every rank
    w = torch.from_numpy(GLOBAL.copy()).requires_grad_()
    from paddle_tpu_torch import Tensor

    s = ap.shard_tensor(Tensor(w), m1, [ap.Shard(0), ap.Replicate()])
    s._value.sum().backward()
    res["grad"] = w.grad.numpy()
    out["reshard"] = res


def _loader_rows(out):
    from paddle_tpu_torch import Tensor
    from paddle_tpu_torch.distributed import auto_parallel as ap

    batches = [(np.arange(n * 2).reshape(n, 2), {"ids": np.arange(n)})
               for n in (8, 7, 3)]
    sharded = ap.shard_dataloader(batches, None)
    out["loader"] = {"index": (sharded._idx, sharded._n),
                     "rows": list(sharded)}
    tb = [(Tensor(torch.arange(10).reshape(5, 2)),)]
    out["loader_tensor"] = [b[0]._value.numpy()
                            for b in ap.shard_dataloader(tb, None)]
    # no global mesh: the rank's position along the ProcessMesh's dims
    from paddle_tpu_torch.distributed.mesh import get_mesh, set_mesh

    glob = get_mesh()
    set_mesh(None)
    try:
        pm = ap.ProcessMesh([[0, 1], [2, 3]], ["x", "y"])
        by_pm = ap.shard_dataloader(batches, pm, shard_dims="x")
        out["loader_pm"] = {"index": (by_pm._idx, by_pm._n),
                            "whole": ap.shard_dataloader(batches, pm)
                            is batches}
    finally:
        set_mesh(glob)


def _llama_runs(named, out):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny_config(num_hidden_layers=2)
    ids, labels = _ids_labels()
    for label in ("global", "sharded_loader"):
        fleet.reset()
        build_mesh({"dp": 2, "mp": 2})
        model = from_paddle_tpu_params(named, cfg, device="cpu")
        dist.shard_layer(model, dist.ProcessMesh([[0, 1], [2, 3]],
                                                 ["dp", "mp"]))
        crit = LlamaPretrainingCriterion(cfg)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        if label == "global":
            loader, feed = None, [(ids, labels)] * 3
        else:
            ds = tio.TensorDataset([np.concatenate([ids] * 3),
                                    np.concatenate([labels] * 3)])
            loader = dist.shard_dataloader(tio.DataLoader(ds, batch_size=8),
                                           None)
            feed = list(loader)
        dm = dist.to_static(model, loader, lambda o, l: crit(o, l), opt)
        assert dm.mode == "train"
        losses = [float(dm(*b)) for b in feed]
        rec = {"losses": losses, "rows": int(feed[0][0].shape[0])}
        if label == "global":
            dm.eval()
            rec["eval"] = float(dm(ids, labels))
            dm.predict()
            rec["logits"] = dm(ids).numpy()
            rec["params"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
            rec["state_len"] = len(dm.state_dict())
            with torch.no_grad():
                rec["unsharded"] = {
                    n: dist.unshard_dtensor(p).numpy()
                    for n, p in model.named_parameters()}
            rec["placements"] = {n: (repr(p._placements), p._global_shape)
                                 for n, p in model.named_parameters()}
            try:
                dm.train()
                dist.to_static(model, None, None, None).train()
            except RuntimeError as e:
                rec["train_err"] = str(e)
        out["llama_" + label] = rec


def _zero_run(named, out):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.checkpoint.elastic import innermost_opt
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny_config(num_hidden_layers=2)
    fleet.reset()
    build_mesh({"sharding": 4})
    model = from_paddle_tpu_params(named, cfg, device="cpu")
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 4,
                               "sep_degree": 1}
    dm = dist.to_static(model, None, lambda o, l: crit(o, l), opt, strategy)
    ids, labels = _ids_labels()
    losses = [float(dm(ids, labels)) for _ in range(3)]
    base = innermost_opt(dm._step.optimizer)[0]
    moments = sum(v.numel() for st in base._state.values()
                  for k, v in st.items() if k in ("m", "v")) // 2
    out["zero"] = {"losses": losses, "zero_axis": dm._zero_axis,
                   "moment_numel": moments,
                   "param_numel": sum(p.numel() for p in model.parameters())}


def _reg_run(out):
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh

    fleet.reset()
    build_mesh({"dp": 4})
    model = _reg(tpaddle)
    with open(os.path.join(out["dir"], "reg.pkl"), "rb") as fh:
        model.set_state_dict(pickle.load(fh))
    opt = tpaddle.optimizer.Adam(learning_rate=0.01,
                                 parameters=model.parameters())
    dm = dist.to_static(model, None,
                        lambda o, l: tpaddle.nn.functional.mse_loss(o, l),
                        opt)
    x, y = _reg_data()
    out["reg"] = {"losses": [float(dm(tpaddle.to_tensor(x),
                                      tpaddle.to_tensor(y)))
                             for _ in range(3)],
                  "fc1": model.fc1.weight.numpy()}
    # no global mesh: the mesh of the parameters' ProcessMesh (dims that
    # name mesh axes), or none (dims named otherwise: trained replicated)
    from paddle_tpu_torch.distributed.mesh import set_mesh

    for label, names in (("pm_dp", ["dp"]), ("pm_x", ["x"])):
        set_mesh(None)
        fleet.reset()
        net = _reg(tpaddle)
        with open(os.path.join(out["dir"], "reg.pkl"), "rb") as fh:
            net.set_state_dict(pickle.load(fh))
        dist.shard_layer(net, dist.ProcessMesh([0, 1, 2, 3], names))
        o = tpaddle.optimizer.Adam(learning_rate=0.01,
                                   parameters=net.parameters())
        d = dist.to_static(net, None, lambda o_, l: tpaddle.nn.functional.
                           mse_loss(o_, l), o)
        out["reg"][label] = {
            "losses": [float(d(tpaddle.to_tensor(x), tpaddle.to_tensor(y)))
                       for _ in range(3)],
            "mesh": None if d._mesh is None else dict(d._mesh.shape)}
    # the Engine's files: one a rank, read back into a fresh net
    from paddle_tpu_torch.distributed.auto_parallel.static import Engine

    loss = lambda o, l: tpaddle.nn.functional.mse_loss(o, l)  # noqa: E731
    path = os.path.join(out["dir"], "engine")
    Engine(model, loss, opt).save(path)
    fresh = _reg(tpaddle)
    opt2 = tpaddle.optimizer.Adam(learning_rate=0.01,
                                  parameters=fresh.parameters())
    Engine(fresh, loss, opt2).load(path)
    out["reg"]["engine"] = {
        "file": os.path.exists(f"{path}_dist{dist.get_rank()}.pdparams"),
        "fc1": fresh.fc1.weight.numpy(), "step": opt2.state_dict()["step"]}


def _zero3_save(named, out):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.distributed.sharding import (
        save_group_sharded_model)
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = llama_tiny_config(num_hidden_layers=2)
    fleet.reset()
    mesh = build_mesh({"sharding": 4})
    model = from_paddle_tpu_params(named, cfg, device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda o, l: o, opt, mesh=mesh,
                     zero_axis="sharding", zero_stage=3)
    ids, labels = _ids_labels()
    step({"input_ids": ids, "labels": labels})
    path = os.path.join(out["dir"], f"gs{dist.get_rank()}")
    save_group_sharded_model(step.model, path, opt)
    out["zero3"] = {"path": path,
                    "full": {k: v.detach().clone() for k, v in
                             step.model.state_dict().items()},
                    "local_numel": sum(p.numel()
                                       for p in model.parameters())}


def _rank(out_dir):
    torch.set_num_threads(1)
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch import distributed as dist

    tpaddle.set_device("cpu")       # the Paddle API's tensors on the CPU
    dist.init_parallel_env()
    with open(os.path.join(out_dir, "named.pkl"), "rb") as fh:
        named = pickle.load(fh)
    out = {"dir": out_dir}
    from paddle_tpu_torch.distributed.mesh import build_mesh

    build_mesh({"dp": 2, "mp": 2})
    _reshard_cases(out)
    _loader_rows(out)
    _llama_runs(named, out)
    _zero_run(named, out)
    _reg_run(out)
    _zero3_save(named, out)
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX references (the test process)

def _jax_llama():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny_config

    paddle.seed(SEED)
    return LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2))


@pytest.fixture(scope="module")
def jax_run():
    """JAX ``test_to_static_trains_llama_on_mesh``'s steps, recorded."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist
    import paddle_tpu.models.llama as jl
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.models.llama import (LlamaPretrainingCriterion,
                                         llama_tiny_config)

    jl._shared_rope_tables.cache_clear()
    build_mesh({"dp": 2, "mp": 2})
    try:
        model = _jax_llama()
        named = {n: np.asarray(p._value) for n, p in model.named_parameters()}
        crit = LlamaPretrainingCriterion(
            llama_tiny_config(num_hidden_layers=2))
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
        dm = jdist.to_static(model, None, lambda o, l: crit(o, l), opt)
        ids, labels = (paddle.to_tensor(a) for a in _ids_labels())
        losses = [float(dm(ids, labels)) for _ in range(3)]
        dm.eval()
        ev = float(dm(ids, labels))
        dm.predict()
        logits = np.asarray(dm(ids)._value)
        dm._sync()
        params = {n: np.asarray(p._value) for n, p in model.named_parameters()}
    finally:
        set_mesh(None)
        jl._shared_rope_tables.cache_clear()
    return {"named": named, "losses": losses, "eval": ev, "logits": logits,
            "params": params}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_run):
    import paddle_tpu as jpaddle

    out = str(tmp_path_factory.mktemp("auto_parallel"))
    with open(os.path.join(out, "named.pkl"), "wb") as fh:
        pickle.dump(jax_run["named"], fh)
    jpaddle.seed(3)
    reg = _reg(jpaddle)
    with open(os.path.join(out, "reg.pkl"), "wb") as fh:
        pickle.dump({k: np.asarray(v._value)
                     for k, v in reg.state_dict().items()}, fh)
    spawn(_rank, (out,), nprocs=4, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


def test_placements_equal_jax():
    import paddle_tpu.distributed.auto_parallel.api as ja

    from paddle_tpu_torch.distributed.auto_parallel import api as ta

    for name in ("R", "P", "Pmax", "S0", "S1"):
        a, b = _pl(name, ta), _pl(name, ja)
        assert repr(a) == repr(b)
        assert hash(a) == hash(b)
        assert (a.is_shard(), a.is_replicated(), a.is_partial()) == \
            (b.is_shard(), b.is_replicated(), b.is_partial())
        assert a == _pl(name, ta) and a != ta.Shard(3)
    assert ta.Shard(1).is_shard(1) and not ta.Shard(1).is_shard(0)
    assert ta.Shard(2).get_dim() == 2


def test_process_mesh_equals_jax():
    import paddle_tpu.distributed.auto_parallel.api as ja

    from paddle_tpu_torch.distributed.auto_parallel import api as ta

    for grid, names in ([[[0, 1], [2, 3]], ["x", "y"]],
                        [[[0, 1, 2, 3]], None], [[4, 5, 6], ["dp"]]):
        a, b = ta.ProcessMesh(grid, names), ja.ProcessMesh(grid, names)
        assert (a.shape, a.ndim, a.dim_names, a.process_ids) == \
            (b.shape, b.ndim, b.dim_names, b.process_ids)
        assert repr(a) == repr(b) and hash(a) == hash(b)
        assert a.get_dim_size(a.dim_names[-1]) == \
            b.get_dim_size(b.dim_names[-1])
        assert a == ta.ProcessMesh(grid, ["p", "q"][:a.ndim])
        assert a.get_group() is None     # a world of one makes no group
    assert ta.ProcessMesh([[0, 1]]) != ta.ProcessMesh([[1, 0]])


def _expected_local(mesh_name, placements, coord, v=GLOBAL):
    """The numpy block of `v` at `coord` under `placements` (a Partial
    from a global value: the value at coordinate 0, zeros elsewhere)."""
    shape = [2, 2]
    for d in range(2):
        sh = [i for i, p in enumerate(placements) if p == f"S{d}"]
        idx, n = 0, 1
        for i in sh:
            idx, n = idx * shape[i] + coord[i], n * shape[i]
        k = v.shape[d] // n
        v = np.take(v, range(idx * k, (idx + 1) * k), axis=d)
    for i, p in enumerate(placements):
        if p == "P" and coord[i]:
            return np.zeros_like(v)
    return v


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("label", list(CASES))
def test_reshard_global_value_equals_jax(ranks, mesh_name, label):
    import paddle_tpu.distributed.auto_parallel.api as ja

    grid, names = MESHES[mesh_name]
    src, dst = CASES[label]
    jm = ja.ProcessMesh(grid, names)
    jt = ja.reshard(ja.shard_tensor(GLOBAL, jm, [_pl(p, ja) for p in src]),
                    jm, [_pl(p, ja) for p in dst])
    want = np.asarray(jt._value)
    for r in range(4):
        rec = ranks[r]["reshard"][(mesh_name, label)]
        np.testing.assert_array_equal(rec["src_global"], GLOBAL)
        np.testing.assert_array_equal(rec["global"], want)
        assert rec["global_shape"] == list(want.shape)
        np.testing.assert_array_equal(
            rec["src_local"], _expected_local(mesh_name, src, rec["coord"]))
        np.testing.assert_array_equal(
            rec["local"], _expected_local(mesh_name, dst, rec["coord"]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_partial_of_local_values_sums_on_reshard(ranks, mesh_name):
    grid = np.asarray(MESHES[mesh_name][0])
    for r in range(4):
        col = grid[:, np.argwhere(grid == r)[0][1]]
        np.testing.assert_array_equal(ranks[r]["reshard"][(mesh_name,
                                                           "local_partial")],
                                      np.full((2, 3), float(sum(col + 1))))


def _jax_grad(src_mesh, src, dst, dst_mesh=None):
    """JAX's gradient of sum(w placed `src`, then `dst`, * COT): the two
    placements as ``device_put``s under ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu.distributed.auto_parallel.api as ja
    from jax.sharding import NamedSharding

    def sharding(mesh_name, pls):
        jm = ja.ProcessMesh(*MESHES[mesh_name])
        return NamedSharding(jm.jax_mesh(), ja._placements_to_pspec(
            [_pl(p, ja) for p in pls], 2, jm))

    a, b = sharding(src_mesh, src), sharding(dst_mesh or src_mesh, dst)
    cot = jax.device_put(COT, b)
    return np.asarray(jax.grad(lambda w: jnp.sum(
        jax.device_put(jax.device_put(w, a), b) * cot))(
            jax.device_put(GLOBAL, a)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("label", list(CASES))
def test_reshard_gradient_equals_jax(ranks, mesh_name, label):
    """Every transition carries the gradient: w's gradient on every rank
    is JAX's global gradient, bit for bit."""
    src, dst = CASES[label]
    want = _jax_grad(mesh_name, src, dst)
    np.testing.assert_array_equal(want, COT)
    for r in range(4):
        np.testing.assert_array_equal(
            ranks[r]["reshard"][(mesh_name, label)]["grad"], want,
            err_msg=f"rank {r}")


def test_cross_mesh_reshard_and_the_slice_gradient(ranks):
    import jax
    import jax.numpy as jnp

    want_slice = np.asarray(jax.grad(lambda w: jnp.sum(w))(
        jnp.asarray(GLOBAL)))
    want_cross = _jax_grad("dp_mp", ("S0", "S1"), ("S1", "R"), "xy_permuted")
    for r in range(4):
        rec = ranks[r]["reshard"]["cross_mesh"]
        np.testing.assert_array_equal(rec["global"], GLOBAL)
        np.testing.assert_array_equal(
            rec["local"], _expected_local("xy_permuted", ("S1", "R"),
                                          rec["coord"]))
        np.testing.assert_array_equal(rec["grad"], want_cross)
        np.testing.assert_array_equal(ranks[r]["reshard"]["grad"],
                                      want_slice)


def test_shard_dataloader_rows_equal_jax(ranks):
    from paddle_tpu.distributed.auto_parallel.api import _ShardedLoader

    batches = [(np.arange(n * 2).reshape(n, 2), {"ids": np.arange(n)})
               for n in (8, 7, 3)]
    for r in range(4):
        idx, n = ranks[r]["loader"]["index"]
        assert (idx, n) == (r // 2, 2)           # mp peers share rows
        want = list(_ShardedLoader(batches, idx, n))
        got = ranks[r]["loader"]["rows"]
        assert len(got) == len(want)
        for (ga, gd), (wa, wd) in zip(got, want):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_array_equal(gd["ids"], wd["ids"])
        tail = [np.arange(10).reshape(5, 2)[rows] for rows in
                ([0, 1, 2], [3, 4, 0])][r // 2]
        np.testing.assert_array_equal(ranks[r]["loader_tensor"][0], tail)
        assert ranks[r]["loader_pm"] == {"index": (r // 2, 2),
                                         "whole": True}


def test_to_static_trains_llama_as_jax(ranks, jax_run):
    from paddle_tpu_torch.models import gather_paddle_tpu_params

    for r in range(4):
        rec = ranks[r]["llama_global"]
        np.testing.assert_allclose(rec["losses"], jax_run["losses"],
                                   rtol=1e-5, atol=0, err_msg=f"rank {r}")
        np.testing.assert_allclose(rec["eval"], jax_run["eval"], rtol=1e-5)
        got, want = rec["logits"], jax_run["logits"]
        assert got.shape == want.shape == (8, 16, 256)
        row = np.abs(want).max(-1, keepdims=True)
        assert (np.abs(got - want) <= 1e-5 * row + 1e-6).all()
        assert rec["rows"] == 8 and rec["state_len"] > 0
        assert "requires loss and optimizer" in rec["train_err"]
    assert jax_run["losses"][-1] < jax_run["losses"][0]
    full = gather_paddle_tpu_params([ranks[r]["llama_global"]["params"]
                                     for r in range(2)])
    assert set(full) == set(jax_run["params"])
    for name, want in jax_run["params"].items():
        np.testing.assert_allclose(full[name], want, rtol=0, atol=2e-5,
                                   err_msg=name)


def test_shard_layer_places_mp_shards_and_unshards_to_jax(ranks, jax_run):
    """``shard_layer``'s default marks an mp-sharded weight Shard(split
    axis) along the mesh's mp dim with its global shape, the others
    Replicate; ``unshard_dtensor`` of each trained parameter is JAX's
    global parameter (atol 2e-5) on every rank."""
    from paddle_tpu_torch.models import gather_paddle_tpu_params
    from paddle_tpu_torch.models.convert import mp_split_axis

    for r in range(4):
        rec = ranks[r]["llama_global"]
        for name, (pl, shape) in rec["placements"].items():
            ax = mp_split_axis(name)
            want_pl = ("[Replicate(), Replicate()]" if ax is None
                       else f"[Replicate(), Shard(dim={ax})]")
            assert pl == want_pl, name
            assert shape == list(rec["unsharded"][name].shape), name
        full = gather_paddle_tpu_params([rec["unsharded"]])
        assert set(full) == set(jax_run["params"])
        for name, want in jax_run["params"].items():
            np.testing.assert_allclose(full[name], want, rtol=0, atol=2e-5,
                                       err_msg=f"rank {r} {name}")
    assert any(mp_split_axis(n) is not None
               for n in ranks[0]["llama_global"]["placements"])


def test_sharded_loader_and_global_batch_give_the_same_losses(ranks):
    for r in range(4):
        a = ranks[r]["llama_global"]["losses"]
        b = ranks[r]["llama_sharded_loader"]["losses"]
        assert ranks[r]["llama_sharded_loader"]["rows"] == 4
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


def test_sharding_degree_shards_the_moments(ranks):
    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist
    import paddle_tpu.models.llama as jl
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.models.llama import (LlamaPretrainingCriterion,
                                         llama_tiny_config)

    jl._shared_rope_tables.cache_clear()
    build_mesh({"sharding": 4})
    try:
        model = _jax_llama()
        crit = LlamaPretrainingCriterion(
            llama_tiny_config(num_hidden_layers=2))
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                             "sharding_degree": 4, "sep_degree": 1}
        dm = jdist.to_static(model, None, lambda o, l: crit(o, l), opt, st)
        ids, labels = (paddle.to_tensor(a) for a in _ids_labels())
        want = [float(dm(ids, labels)) for _ in range(3)]
    finally:
        set_mesh(None)
        jl._shared_rope_tables.cache_clear()
    total = 0
    for r in range(4):
        z = ranks[r]["zero"]
        assert z["zero_axis"] == "sharding"
        np.testing.assert_allclose(z["losses"], want, rtol=1e-5, atol=0)
        assert z["moment_numel"] <= z["param_numel"] / 4 + 1024
        total += z["moment_numel"]
    assert total >= ranks[0]["zero"]["param_numel"]


def test_no_data_axis_warns_as_jax():
    import paddle_tpu.distributed.auto_parallel.api as ja

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.auto_parallel import api as ta

    class S:
        hybrid_configs = {"sharding_degree": 2}

    for api in (ja, ta):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            dm = api.DistModel(torch.nn.Linear(2, 2) if api is ta
                               else _reg(__import__("paddle_tpu")),
                               None, None, None, S())
        assert any("no 'sharding'/'dp' axis" in str(x.message) for x in w)
        assert dm.mode == "predict" and dm._zero_axis is None
    assert fleet.DistributedStrategy is not None
    with pytest.raises(RuntimeError, match="requires a loss"):
        ta.DistModel(torch.nn.Linear(2, 2)).eval()


def test_paddle_layer_trains_through_to_static_as_jax(ranks):
    import paddle_tpu as jpaddle
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh

    build_mesh({"dp": 4})
    try:
        model = _reg(jpaddle)
        with open(os.path.join(ranks[0]["dir"], "reg.pkl"), "rb") as fh:
            model.set_state_dict(pickle.load(fh))
        opt = jpaddle.optimizer.Adam(learning_rate=0.01,
                                     parameters=model.parameters())
        dm = jdist.to_static(
            model, None, lambda o, l: jpaddle.nn.functional.mse_loss(o, l),
            opt)
        x, y = _reg_data()
        want = [float(dm(jpaddle.to_tensor(x), jpaddle.to_tensor(y)))
                for _ in range(3)]
        dm._sync()
        fc1 = np.asarray(model.fc1.weight._value)
    finally:
        set_mesh(None)
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["reg"]["losses"], want,
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(ranks[r]["reg"]["fc1"], fc1, rtol=0,
                                   atol=1e-5)
        eng = ranks[r]["reg"]["engine"]
        assert eng["file"] and eng["step"] == 3
        np.testing.assert_array_equal(eng["fc1"], ranks[r]["reg"]["fc1"])
        # the parameters' ProcessMesh gives the step its mesh; dims that
        # name no mesh axis train replicated on the global batch
        assert ranks[r]["reg"]["pm_dp"]["mesh"] == {"dp": 4}
        np.testing.assert_allclose(ranks[r]["reg"]["pm_dp"]["losses"], want,
                                   rtol=1e-5, atol=0)
        assert ranks[r]["reg"]["pm_x"]["mesh"] is None
        np.testing.assert_allclose(ranks[r]["reg"]["pm_x"]["losses"], want,
                                   rtol=1e-5, atol=0)


def test_save_group_sharded_model_under_zero3_reads_in_jax(ranks):
    import paddle_tpu as jpaddle

    for r in range(4):
        z = ranks[r]["zero3"]
        got = jpaddle.load(z["path"] + ".pdmodel")
        assert set(got) == set(z["full"])
        for k, v in z["full"].items():
            np.testing.assert_array_equal(np.asarray(got[k]._value),
                                          v.numpy())
            np.testing.assert_array_equal(
                v.numpy(), ranks[0]["zero3"]["full"][k].numpy())
        numel = sum(v.numel() for v in z["full"].values())
        assert z["local_numel"] == 0 < numel     # held 1/4 between steps
        opt = jpaddle.load(z["path"] + ".pdopt")
        assert opt["step"] == 1


def test_shard_layer_hooks_on_both_model_kinds():
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch.core import device
    from paddle_tpu_torch.distributed.auto_parallel import api as ta

    prev = device.current_place()
    tpaddle.set_device("cpu")
    try:
        mesh = ta.ProcessMesh([0], ["dp"])
        seen = []

        def inp(args, m):
            seen.append(("in", m))
            return tuple(a * 2 for a in args)

        def outp(out, m):
            seen.append(("out", m))
            return out + 1

        layer = ta.shard_layer(_reg(tpaddle), mesh, input_fn=inp,
                               output_fn=outp)
        x = np.ones((2, 8), np.float32)
        want = layer.fc2(tpaddle.nn.functional.relu(
            layer.fc1(tpaddle.to_tensor(x * 2)))).numpy() + 1
        np.testing.assert_array_equal(layer(tpaddle.to_tensor(x)).numpy(),
                                      want)
        assert all(p._placements == [ta.Replicate()]
                   for p in layer.parameters())
        mod = torch.nn.Linear(8, 3)
        ta.shard_layer(mod, mesh, input_fn=inp, output_fn=outp)
        xt = torch.ones(2, 8)
        torch.testing.assert_close(mod(xt), torch.nn.functional.linear(
            xt * 2, mod.weight, mod.bias) + 1, rtol=0, atol=0)
        assert mod.weight._process_mesh == mesh
        assert [s[0] for s in seen] == ["in", "out", "in", "out"]

        def custom(name, sub, m):
            if isinstance(sub, torch.nn.Linear):
                sub.weight._placements = [ta.Shard(0)]

        ta.shard_layer(mod, mesh, shard_fn=custom)
        assert mod.weight._placements == [ta.Shard(0)]
        # world of one: shard_tensor keeps the whole value
        t = ta.shard_tensor(np.arange(4.), mesh, [ta.Shard(0)])
        np.testing.assert_array_equal(t.numpy(), np.arange(4.))
        f = ta.dtensor_from_fn(np.ones, mesh, [ta.Replicate()], (3,))
        assert f._global_shape == [3]
    finally:
        device._place = prev
