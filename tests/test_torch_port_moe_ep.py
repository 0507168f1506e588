"""MoE expert parallelism (ep > 1) of the port on 4 gloo ranks (CPU)
against the JAX package's "spmd" MoE over a mesh of the same axes.

One group of 4 processes (``distributed.spawn``, loopback, a free port, a
join timeout that turns a hang into a failure) runs every rank-side
case; this process builds the JAX references on 4 of the 8 virtual CPU
devices of ``tests/conftest.py``:

* ``global_scatter``/``global_gather``: gather after scatter is the
  identity; each equals JAX's tiled ``lax.all_to_all`` in a
  ``shard_map`` over a 4-way axis; each one's gradient is the other
  applied to the cotangent; a group of one rank, or none, is the
  identity; ``collective.stats()`` times "all_to_all";
* ``MoELayer`` at ep 4 and at dp 2 x ep 2 (8 experts, 24 tokens a rank:
  rank r holds row r of the global [4, 24, 16] batch, which is JAX's
  token shard r), with the JAX layer's weights (each rank keeps its
  block of the experts), against the JAX layer's own "spmd" run on the
  same mesh (``_dispatch_plan`` says "spmd" on both sides): dropless
  token-choice, expert-choice, dropless with a shared expert, and
  capacity with drops. A rank's loss is sum(out * cot) + l_aux; summed
  over the ranks that is JAX's sum(out * cot) + 4 * l_aux (the port's
  l_aux carries its rank's gradient and the group mean's value). Rules:
  outputs 2e-5 (JAX's own ep rule, ``test_moe_dropless.py:283``), the
  input's gradient and every parameter's (the replicated ones summed
  over the ranks, the experts' summed over dp and gathered over ep)
  1e-4, ``l_aux``, ``tokens_dropped`` and ``expert_counts`` 1e-6;
* tiny GPT-MoE (``gpt_moe_tiny_config(moe_dispatch="dropless",
  shared_expert_hidden=32)``, a global batch of 4 x 16): 3
  ``TrainStep(mesh={"dp": 2, "ep": 2}, zero_axis="dp")`` steps and 3 at
  ``{"ep": 4}`` against 3 ``CompiledTrainStep`` steps on JAX's mesh of
  the same axes and zero axis (the training tests' rule: losses rtol
  1e-5, the parameters gathered over ep atol 2e-5, ``moe_aux`` rtol
  1e-5, ``moe_dropped`` 0; ``grad_norm`` rtol 1e-5); the expert blocks
  differ across ep and match across dp;
* ``HybridParallelClipGrad`` at dp 2 x ep 2 against JAX's global-norm
  clip on the full gradients;
* the port's capacity path with a shared expert (which the JAX layer
  cannot run over a mesh) at both layouts against the port's single-rank
  layer, at a capacity no token overflows: outputs and the input's
  gradient 1e-5;
* a layer and a GPT-MoE built under the mesh from a seed hold the
  single-rank model's experts (their block) and its other weights;
* refusals: ``num_expert % ep``, rows that do not split over dp x ep, a
  foreign ``moe_group``, mp, pp or sep beside ep, ``zero_stage=3`` with
  ep, and a planted ``block_rows`` mismatch between ranks (every rank
  raises; nothing hangs);
* the new modules import neither JAX nor paddle_tpu.

The batches have no ignored labels, and the GShard gates run with
``random_routing = False`` on both sides (C-fact 2). Spawned ranks
import torch, numpy and the port only.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

W = 4
SPAWN_TIMEOUT_S = 300
D, HID, E, TOKENS = 16, 32, 8, 24
LR = 1e-3
GPT_SEED = 0
LAYOUTS = {"ep4": {"ep": 4}, "dp2_ep2": {"dp": 2, "ep": 2}}
MOE_CASES = {
    "dropless": dict(dispatch="dropless"),
    "expert_choice": dict(dispatch="dropless", router="expert"),
    "shared_expert": dict(dispatch="dropless", shared_expert_hidden=24),
    # no shared expert: the JAX layer adds the capacity path's shared
    # branch outside its shard_map, on one device, and JAX refuses to add
    # it to the output sharded over the mesh (ROADMAP C, the reference)
    "capacity": dict(dispatch="capacity", capacity_factor=0.5),
}
# the port's capacity path with a shared expert, held to its single-rank
# layer (a capacity no token overflows)
PORT_CASES = {"capacity_shared": dict(dispatch="capacity",
                                      capacity_factor=8.0,
                                      shared_expert_hidden=24)}
GPT_LAYOUTS = {"dp2_ep2_zero_dp": ({"dp": 2, "ep": 2}, "dp"),
               "ep4": ({"ep": 4}, None)}
REFUSALS = ("num_expert", "rows", "moe_group", "mp", "pp", "sep", "zero3",
            "block_rows")


def _rs(*seed):
    return np.random.RandomState(list(seed))


def _layer_kw(case):
    return dict(num_expert=E, d_hidden=HID, top_k=2,
                **{**MOE_CASES, **PORT_CASES}[case])


def _layer_data():
    r = _rs(4)
    return (r.standard_normal((W, TOKENS, D)).astype(np.float32),
            r.standard_normal((W, TOKENS, D)).astype(np.float32))


def _gpt_cfg_kw():
    return dict(moe_dispatch="dropless", shared_expert_hidden=32)


def _gpt_batch():
    ids = _rs(7).randint(1, 256, (W, 17)).astype(np.int64)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _a2a_data(rank):
    r = _rs(10, rank)
    return (r.standard_normal((8, 3)).astype(np.float32),
            r.standard_normal((8, 3)).astype(np.float32))


def _clip_grads():
    """(expert gradient, full [4, 3]: 2 experts a rank at ep 2; a
    replicated gradient [5])."""
    r = _rs(5)
    return (r.standard_normal((4, 3)).astype(np.float32),
            r.standard_normal((5,)).astype(np.float32))


def _no_random_routing(*models):
    for m in models:
        for layer in (m.sublayers() if hasattr(m, "sublayers")
                      else m.modules()):
            if hasattr(layer, "random_routing"):
                layer.random_routing = False


def _expert(name):
    from paddle_tpu_torch.models.convert import is_expert_param

    return is_expert_param(name)


# --------------------------------------------------------------------------
# rank side
# --------------------------------------------------------------------------

def _a2a_cases(out):
    from paddle_tpu_torch.distributed import (collective, global_gather,
                                              global_scatter)
    from paddle_tpu_torch.distributed.mesh import build_mesh

    g = build_mesh({"ep": W}).group("ep")
    x, ct = (torch.from_numpy(a) for a in _a2a_data(g.rank))
    collective.reset_stats()
    xs = x.clone().requires_grad_()
    y = global_scatter(xs, None, None, group=g)
    back = global_gather(y.detach(), None, None, group=g)
    (y * ct).sum().backward()
    xg = x.clone().requires_grad_()
    (global_gather(xg, None, None, group=g) * ct).sum().backward()
    st = collective.stats()
    out["a2a"] = {
        "y": y.detach().numpy(), "back": back.numpy(),
        "scatter_grad": xs.grad.numpy(), "gather_grad": xg.grad.numpy(),
        "ct_gathered": global_gather(ct, None, None, group=g).numpy(),
        "ct_scattered": global_scatter(ct, None, None, group=g).numpy(),
        "calls": st["calls"].get("all_to_all"),
        "bytes": st["bytes"].get("all_to_all"),
        "seconds": st["seconds"].get("all_to_all")}


def _load(module, named, ep_rank, ep_degree):
    from paddle_tpu_torch.models.convert import shard_expert_params

    share = shard_expert_params(named, ep_rank, ep_degree)
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.array(share[n])))


def _layer_cases(named, out):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.env import get_rank
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    rank = get_rank()
    x, ct = _layer_data()
    res = {}
    for label, axes in LAYOUTS.items():
        fleet.reset()
        mesh = build_mesh(axes)
        for case in MOE_CASES:
            tm = MoELayer(D, **_layer_kw(case))
            _load(tm, named[case], tm.ep_rank, tm.ep_degree)
            _no_random_routing(tm)
            xr = torch.from_numpy(x[rank:rank + 1]).requires_grad_()
            o = tm(xr)
            ((o * torch.from_numpy(ct[rank:rank + 1])).sum()
             + tm.l_aux).backward()
            res[(label, case)] = {
                "plan": tm._dispatch_plan(TOKENS)[:2],
                "coord": mesh.coord(), "ep_rank": tm.ep_rank,
                "out": o.detach().numpy(), "x_grad": xr.grad.numpy(),
                "grads": {n: p.grad.numpy()
                          for n, p in tm.named_parameters()},
                "marks": {n: getattr(p, "ep_sharded", False)
                          for n, p in tm.named_parameters()},
                **{a: getattr(tm, a).detach().numpy()
                   for a in ("l_aux", "tokens_dropped", "expert_counts")},
                "layout_rows": (None if tm.last_layout is None
                                else (int(tm.last_layout[0].shape[0]),
                                      int(tm.last_layout[1])))}
        # capacity with a shared expert (the JAX layer cannot run it over
        # a mesh): with no drops, each token's output is the single-rank
        # layer's
        tm = MoELayer(D, **_layer_kw("capacity_shared"))
        _load(tm, named["capacity_shared"], tm.ep_rank, tm.ep_degree)
        _no_random_routing(tm)
        xr = torch.from_numpy(x[rank:rank + 1]).requires_grad_()
        o = tm(xr)
        (o * torch.from_numpy(ct[rank:rank + 1])).sum().backward()
        res[(label, "capacity_shared")] = {
            "out": o.detach().numpy(), "x_grad": xr.grad.numpy(),
            "dropped": float(tm.tokens_dropped)}
    out["layers"] = res


def _seeded_cases(out):
    """A layer and a GPT-MoE built under an ep mesh from a seed, beside
    the same built without a mesh."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import (GptMoeForCausalLM,
                                         gpt_moe_tiny_config)

    fleet.reset()
    set_mesh(None)
    cfg = gpt_moe_tiny_config(**_gpt_cfg_kw())
    single = (MoELayer(D, num_expert=E, d_hidden=HID, seed=5),
              GptMoeForCausalLM(cfg, device="cpu", seed=2))
    build_mesh({"dp": 2, "ep": 2})
    ep = (MoELayer(D, num_expert=E, d_hidden=HID, seed=5),
          GptMoeForCausalLM(cfg, device="cpu", seed=2))
    res = {}
    for what, a, b in zip(("layer", "gpt"), single, ep):
        full = dict(a.named_parameters())
        res[what] = {"ep_rank": b.ep_rank if what == "layer"
                     else b.moe_layers()[0].ep_rank,
                     "full": {n: p.detach().numpy() for n, p in full.items()},
                     "mine": {n: p.detach().numpy()
                              for n, p in b.named_parameters()}}
    out["seeded"] = res


def _gpt_cases(named, out):
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         gpt_moe_tiny_config)
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.parallel import TrainStep

    res = {}
    for label, (axes, zero_axis) in GPT_LAYOUTS.items():
        fleet.reset()
        mesh = build_mesh(axes)
        model = from_paddle_tpu_params(named, gpt_moe_tiny_config(
            **_gpt_cfg_kw()), device="cpu")
        _no_random_routing(model)
        opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                    weight_decay=0.01)
        step = TrainStep(model, lambda o, lab: o, opt, collect_metrics=True,
                         mesh=mesh, zero_axis=zero_axis)
        collective.reset_stats()
        losses, metrics = [], []
        for _ in range(3):
            losses.append(float(step(_gpt_batch())))
            metrics.append(step.last_metrics())
        res[label] = {
            "coord": mesh.coord(), "losses": losses, "metrics": metrics,
            "a2a_calls": collective.stats()["calls"].get("all_to_all", 0),
            "state_numel": sum(st["m"].numel() for st in
                               step.optimizer._base_opt._state.values()),
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}
    out["gpt"] = res
    # one SGD step at lr 1: the update is the reduced gradient itself
    grads = {}
    for label, (axes, zero_axis) in GPT_LAYOUTS.items():
        fleet.reset()
        mesh = build_mesh(axes)
        model = from_paddle_tpu_params(named, gpt_moe_tiny_config(
            **_gpt_cfg_kw()), device="cpu")
        _no_random_routing(model)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = TrainStep(model, lambda o, lab: o,
                         SGD(learning_rate=1.0,
                             parameters=model.parameters()),
                         mesh=mesh, zero_axis=zero_axis)
        step(_gpt_batch())
        grads[label] = {n: before[n] - p.detach()
                        for n, p in model.named_parameters()}
    out["gpt_grads"] = grads


def _clip_cases(out):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
        hybrid_parallel_optimizer import HybridParallelClipGrad
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    fleet.reset()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "ep_degree": 2}
    hcg = fleet.init(strategy=strategy)
    j = hcg.get_expert_parallel_rank()
    full, repl = _clip_grads()
    expert = torch.nn.Parameter(torch.zeros(2, 3))
    expert.ep_sharded = True
    norm_w = torch.nn.Parameter(torch.zeros(5))
    res = {"ep_rank": j, "groups": {
        "ep": hcg.get_expert_parallel_group().ranks,
        "dp": hcg.get_data_parallel_group().ranks,
        "rows": hcg.get_dp_sharding_ep_parallel_group().ranks}}
    for c in (0.5, 1e3):
        clip = HybridParallelClipGrad(ClipGradByGlobalNorm(c), hcg)
        got = clip([(expert, torch.from_numpy(full[2 * j:2 * j + 2])),
                    (norm_w, torch.from_numpy(repl))])
        res[c] = (float(clip.last_norm), got[0][1].numpy(),
                  got[1][1].numpy())
    out["clip"] = res


def _refusal_cases(named, out):
    from paddle_tpu_torch.core.flags import flag, set_flags
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.env import get_rank
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         gpt_moe_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    raised = {}

    def attempt(key, fn):
        try:
            fn()
            raised[key] = None
        except (ValueError, NotImplementedError) as e:
            raised[key] = (type(e).__name__, str(e))

    fleet.reset()
    build_mesh({"ep": W})
    attempt("num_expert", lambda: MoELayer(D, num_expert=6, d_hidden=8))
    fleet.reset()
    mesh = build_mesh({"dp": 2, "ep": 2})
    world = collective.new_group(list(range(W)))
    attempt("moe_group", lambda: MoELayer(D, num_expert=E, d_hidden=8,
                                          moe_group=world))
    attempt("moe_group_ep", lambda: MoELayer(D, num_expert=E, d_hidden=8,
                                             moe_group=mesh.group("ep")))
    model = from_paddle_tpu_params(named, gpt_moe_tiny_config(
        **_gpt_cfg_kw()), device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    step = TrainStep(model, lambda o, lab: o, opt, mesh=mesh)
    batch = {k: v[:3] for k, v in _gpt_batch().items()}
    attempt("rows", lambda: step(batch))
    attempt("zero3", lambda: TrainStep(model, lambda o, lab: o, opt,
                                       mesh=mesh, zero_axis="dp",
                                       zero_stage=3))
    for axis in ("mp", "pp", "sep"):
        fleet.reset()
        other = build_mesh({axis: 2, "ep": 2})
        attempt(axis, lambda: MoELayer(D, num_expert=E, d_hidden=8))
        attempt(axis + "_step", lambda: TrainStep(
            model, lambda o, lab: o, opt, mesh=other))
    # a planted block_rows mismatch: rank 1 pads its buckets to 16 rows
    fleet.reset()
    build_mesh({"ep": W})
    old = flag("moe_block_rows")
    set_flags({"moe_block_rows": 16 if get_rank() == 1 else 8})
    try:
        tm = MoELayer(D, num_expert=E, d_hidden=8, dispatch="dropless")
        x = torch.from_numpy(_layer_data()[0][get_rank()])
        attempt("block_rows", lambda: tm(x))
    finally:
        set_flags({"moe_block_rows": old})
    out["raised"] = raised


def _ep_rank(out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env()
    with open(os.path.join(out_dir, "named.pkl"), "rb") as fh:
        named = pickle.load(fh)
    out = {}
    _a2a_cases(out)
    _layer_cases(named["layers"], out)
    _seeded_cases(out)
    _gpt_cases(named["gpt"], out)
    _clip_cases(out)
    _refusal_cases(named["gpt"], out)
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the JAX references (this process)
# --------------------------------------------------------------------------

def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _jax_layer(case):
    import paddle_tpu as paddle
    from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE

    paddle.seed(3)
    jm = JaxMoE(D, **_layer_kw(case))
    _no_random_routing(jm)
    return jm


def _jax_gpt():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt_moe import GptMoeForCausalLM as JaxGptMoe
    from paddle_tpu.models.gpt_moe import gpt_moe_tiny_config as jax_tiny

    paddle.seed(GPT_SEED)
    jm = JaxGptMoe(jax_tiny(**_gpt_cfg_kw()))
    _no_random_routing(jm)
    return jm


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe_ep"))
    named = {"layers": {c: {n: _np(p) for n, p in
                            _jax_layer(c).named_parameters()}
                        for c in list(MOE_CASES) + list(PORT_CASES)},
             "gpt": {n: _np(p) for n, p in _jax_gpt().named_parameters()}}
    with open(os.path.join(out, "named.pkl"), "wb") as fh:
        pickle.dump(named, fh)
    spawn(_ep_rank, (out,), nprocs=W, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(W):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


@pytest.fixture
def jax_mesh():
    """Build a JAX mesh for the test; reset it after."""
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh

    yield build_mesh
    set_mesh(None)


def _rows(axes):
    """{ep coordinate: the ranks holding that expert block}."""
    ep = axes["ep"]
    return {j: [r for r in range(W) if r % ep == j] for j in range(ep)}


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

def test_global_scatter_and_gather_match_the_jax_tiled_all_to_all(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.mesh import shard_map_compat

    mesh = Mesh(np.array(jax.devices()[:W]), ("ep",))
    fn = shard_map_compat(
        lambda v: jax.lax.all_to_all(v, "ep", 0, 0, tiled=True), mesh,
        (P("ep"),), P("ep"))
    xs = np.concatenate([_a2a_data(r)[0] for r in range(W)])
    cts = np.concatenate([_a2a_data(r)[1] for r in range(W)])
    want, vjp = jax.vjp(fn, jnp.asarray(xs))
    (want_grad,) = vjp(jnp.asarray(cts))
    want, want_grad = np.asarray(want), np.asarray(want_grad)
    for r in range(W):
        a = ranks[r]["a2a"]
        np.testing.assert_array_equal(a["y"], want[8 * r:8 * r + 8])
        np.testing.assert_array_equal(a["back"], _a2a_data(r)[0])
        np.testing.assert_array_equal(a["scatter_grad"],
                                      want_grad[8 * r:8 * r + 8])
        # each one's gradient is the other applied to the cotangent
        np.testing.assert_array_equal(a["scatter_grad"], a["ct_gathered"])
        np.testing.assert_array_equal(a["gather_grad"], a["ct_scattered"])


def test_all_to_all_is_counted_and_timed(ranks):
    for r in range(W):
        a = ranks[r]["a2a"]
        # the scatter, the gather of its output, the scatter's backward,
        # the second gather and its backward
        assert a["calls"] == 5
        assert a["bytes"] == 5 * 8 * 3 * 4
        assert a["seconds"] is not None and a["seconds"] > 0


def test_a_group_of_one_or_none_is_the_identity():
    from paddle_tpu_torch.distributed import global_gather, global_scatter
    from paddle_tpu_torch.distributed.collective import Group

    x = torch.arange(6.0).reshape(3, 2)
    one = Group(id=-1, ranks=(0,), pg=None)
    for fn in (global_scatter, global_gather):
        assert fn(x, None, None) is x
        assert fn(x, [3], [3], group=one) is x


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("label", sorted(LAYOUTS))
def test_moe_layer_matches_the_jax_spmd_run(ranks, jax_mesh, label, case):
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor

    axes = LAYOUTS[label]
    x, ct = _layer_data()
    jm = _jax_layer(case)
    jax_mesh(axes)
    mode, ep, _, _ = jm._dispatch_plan(W * TOKENS)
    assert mode == "spmd" and ep == axes["ep"]
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jm(jx)
    # the output lies sharded over the mesh: the cotangent goes alike
    jct = Tensor(jax.device_put(np.asarray(ct), jout._value.sharding))
    ((jout * jct).sum() + W * jm.l_aux).backward()
    jgrads = {n: _np(p.grad) for n, p in jm.named_parameters()}
    jout, jxg = _np(jout), _np(jx.grad)
    res = [ranks[r]["layers"][(label, case)] for r in range(W)]
    for r in range(W):
        assert res[r]["plan"] == ("spmd", axes["ep"])
        np.testing.assert_allclose(res[r]["out"], jout[r:r + 1], rtol=2e-5,
                                   atol=2e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(res[r]["x_grad"], jxg[r:r + 1],
                                   rtol=1e-4, atol=1e-4, err_msg=f"rank {r}")
        for attr in ("l_aux", "tokens_dropped", "expert_counts"):
            np.testing.assert_allclose(res[r][attr], _np(getattr(jm, attr)),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r} {attr}")
    blocks = _rows(axes)
    for name, want in jgrads.items():
        if _expert(name):
            got = np.concatenate([sum(res[r]["grads"][name]
                                      for r in blocks[j])
                                  for j in sorted(blocks)])
            assert all(res[r]["marks"][name] for r in range(W))
        else:
            got = sum(res[r]["grads"][name] for r in range(W))
            assert not any(res[r]["marks"][name] for r in range(W))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if case == "capacity":
        assert float(res[0]["tokens_dropped"]) > 0   # the case drops
    else:
        rows, bm = res[0]["layout_rows"]
        assert rows % bm == 0
        if case != "expert_choice":
            # the received layout: ep slices of cap rows each
            cap = -(-TOKENS * 2 // bm) * bm + E // axes["ep"] * bm
            assert rows == axes["ep"] * cap


@pytest.mark.parametrize("label", sorted(LAYOUTS))
def test_capacity_with_a_shared_expert_matches_the_single_rank_layer(
        ranks, label):
    """The port's capacity path with its shared branch at ep, against the
    port's single-rank layer on the whole batch (held to JAX's by
    ``tests/test_torch_port_moe.py``): with no token dropped, every
    token's output and input gradient are the same."""
    from paddle_tpu_torch.distributed.mesh import set_mesh
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    set_mesh(None)
    x, ct = _layer_data()
    tm = MoELayer(D, **_layer_kw("capacity_shared"))
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(torch.from_numpy(np.array(
                _np(dict(_jax_layer("capacity_shared")
                         .named_parameters())[n]))))
    _no_random_routing(tm)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    assert float(tm.tokens_dropped) == 0
    for r in range(W):
        res = ranks[r]["layers"][(label, "capacity_shared")]
        assert res["dropped"] == 0
        np.testing.assert_allclose(res["out"], out[r:r + 1].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["x_grad"], xt.grad[r:r + 1].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("what", ["layer", "gpt"])
def test_a_seeded_ep_model_holds_the_single_rank_models_weights(ranks,
                                                                  what):
    for r in range(W):
        rec = ranks[r]["seeded"][what]
        j = rec["ep_rank"]
        assert j == r % 2
        assert set(rec["mine"]) == set(rec["full"])
        for n, mine in rec["mine"].items():
            full = rec["full"][n]
            if _expert(n):
                k = full.shape[0] // 2
                full = full[j * k:(j + 1) * k]
            np.testing.assert_array_equal(mine, full, err_msg=n)


def _jax_gpt_run(axes, zero_axis, jax_mesh):
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu.parallel.train_step import CompiledTrainStep

    jm = _jax_gpt()
    mesh = jax_mesh(axes)
    opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters(),
                   weight_decay=0.01)
    step = CompiledTrainStep(jm, lambda o, lab: o, optimizer=opt,
                             mesh=mesh, zero_axis=zero_axis,
                             collect_metrics=True)
    batch = {k: v.astype(np.int32) for k, v in _gpt_batch().items()}
    losses, metrics = [], []
    for _ in range(3):
        losses.append(float(step(batch)))
        step.settle_metrics(block=True)
        metrics.append(step.last_metrics())
    step.sync_params_to_model()
    return losses, metrics, {n: _np(p) for n, p in jm.named_parameters()}


@pytest.mark.parametrize("label", sorted(GPT_LAYOUTS))
def test_gpt_moe_steps_match_compiled_train_step(ranks, jax_mesh, label):
    from paddle_tpu_torch.models import gather_expert_params
    from paddle_tpu_torch.models.convert import _is_linear

    axes, zero_axis = GPT_LAYOUTS[label]
    jl, jm, jparams = _jax_gpt_run(axes, zero_axis, jax_mesh)
    res = [ranks[r]["gpt"][label] for r in range(W)]
    for r in range(W):
        np.testing.assert_allclose(res[r]["losses"], jl, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(
            [m["moe_aux"] for m in res[r]["metrics"]],
            [m["moe_aux"] for m in jm], rtol=1e-5, atol=0)
        assert [m["moe_dropped"] for m in res[r]["metrics"]] == [0.0] * 3
        np.testing.assert_allclose(
            [m["grad_norm"] for m in res[r]["metrics"]],
            [float(m["grad_norm"]) for m in jm], rtol=1e-5)
        assert res[r]["a2a_calls"] > 0
    assert jl[-1] < jl[0]
    blocks = _rows(axes)
    full = gather_expert_params([res[blocks[j][0]]["params"]
                                 for j in sorted(blocks)])
    assert set(full) == set(jparams)
    for name, want in jparams.items():
        got = full[name].T if _is_linear(name) else full[name]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                                   err_msg=name)
    # dp replicas hold the same parameters; ep ranks other experts
    for r in range(W):
        twin = res[r % axes["ep"]]["params"]
        for name, p in res[r]["params"].items():
            assert torch.equal(p, twin[name]), (r, name)
    w1 = "blocks.0.moe.experts.w1"
    assert not torch.equal(res[0]["params"][w1], res[1]["params"][w1])


@pytest.mark.parametrize("label", sorted(GPT_LAYOUTS))
def test_gpt_moe_gradients_match_jax_per_parameter(ranks, jax_mesh, label):
    """One SGD step at lr 1 on each side: every parameter's update is its
    reduced gradient (the experts' gathered over ep), held to JAX's
    gradient of the global mean loss element by element, so a factor of
    dp or ep lost in the averaging rule shows (AdamW's updates would hide
    a scale)."""
    from paddle_tpu.optimizer import SGD as JaxSGD
    from paddle_tpu.parallel.train_step import CompiledTrainStep
    from paddle_tpu_torch.models import gather_expert_params
    from paddle_tpu_torch.models.convert import _is_linear

    axes, zero_axis = GPT_LAYOUTS[label]
    jm = _jax_gpt()
    before = {n: _np(p).copy() for n, p in jm.named_parameters()}
    step = CompiledTrainStep(
        jm, lambda o, lab: o,
        optimizer=JaxSGD(learning_rate=1.0, parameters=jm.parameters()),
        mesh=jax_mesh(axes), zero_axis=zero_axis)
    step({k: v.astype(np.int32) for k, v in _gpt_batch().items()})
    step.sync_params_to_model()
    want = {n: before[n] - _np(p) for n, p in jm.named_parameters()}
    blocks = _rows(axes)
    got = gather_expert_params([ranks[blocks[j][0]]["gpt_grads"][label]
                                for j in sorted(blocks)])
    for name, g in want.items():
        mine = got[name].T if _is_linear(name) else got[name]
        scale = float(np.abs(g).max())
        assert scale > 0, name
        np.testing.assert_allclose(mine, g, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_zero_over_dp_shards_the_state_of_each_ep_coordinate(ranks):
    """ZeRO over "dp" at dp 2 x ep 2: a rank's optimizer state is half
    of its ep coordinate's parameters (padded), against all of them at
    ep 4 without ZeRO."""
    zero = [ranks[r]["gpt"]["dp2_ep2_zero_dp"] for r in range(W)]
    plain = [ranks[r]["gpt"]["ep4"] for r in range(W)]
    for r in range(W):
        mine = sum(-(-p.numel() // 2) for p in zero[r]["params"].values())
        assert zero[r]["state_numel"] == mine
        assert plain[r]["state_numel"] == sum(
            p.numel() for p in plain[r]["params"].values())


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
        rec = ranks[r]["clip"]
        j = rec["ep_rank"]
        assert j == r % 2
        assert rec["groups"] == {"ep": (r - j, r - j + 1),
                                 "dp": (j, j + 2), "rows": (0, 1, 2, 3)}
        gn, g_expert, g_repl = rec[clip_norm]
        np.testing.assert_allclose(gn, norm, rtol=1e-6)
        np.testing.assert_allclose(g_expert,
                                   -np.asarray(new[0])[2 * j:2 * j + 2],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g_repl, -np.asarray(new[1]), rtol=1e-6,
                                   atol=1e-6)


def test_mesh_coordinates_follow_the_jax_device_order(ranks, jax_mesh):
    import jax

    for label, axes in LAYOUTS.items():
        mesh = jax_mesh(axes)
        devs = np.asarray(mesh.devices)
        for r in range(W):
            idx = np.argwhere(devs == jax.devices()[r])[0]
            want = dict(zip(mesh.axis_names, (int(i) for i in idx)))
            assert ranks[r]["layers"][(label, "dropless")]["coord"] == want


@pytest.mark.parametrize("what", REFUSALS)
def test_what_expert_parallelism_refuses(ranks, what):
    match = {"num_expert": ("ValueError", "does not split over"),
             "rows": ("ValueError", "does not split over 4 data ranks"),
             "moe_group": ("ValueError", "is not the rank mesh's ep group"),
             "mp": ("NotImplementedError", "ROADMAP A8"),
             "pp": ("NotImplementedError", "ROADMAP A8"),
             "sep": ("NotImplementedError", "ROADMAP A8"),
             "zero3": ("NotImplementedError", "ROADMAP A8"),
             "block_rows": ("ValueError", "disagree on {'block_rows'")}
    kind, text = match[what]
    for r in range(W):
        got = ranks[r]["raised"][what]
        assert got is not None and got[0] == kind and text in got[1], \
            (r, what, got)
        if what in ("mp", "pp", "sep"):
            step = ranks[r]["raised"][what + "_step"]
            assert step is not None and "ROADMAP A8" in step[1], (r, step)
    if what == "moe_group":
        # the mesh's own ep group is accepted
        assert all(ranks[r]["raised"]["moe_group_ep"] is None
                   for r in range(W))


def test_expert_params_shard_and_gather_back():
    from paddle_tpu_torch.models import (gather_expert_params,
                                         shard_expert_params)

    r = _rs(8)
    named = {"blocks.0.moe.experts.w1": r.standard_normal((4, 3, 5)),
             "blocks.0.moe.experts.b2": r.standard_normal((4, 1, 3)),
             "blocks.0.moe.gate.gate_weight": r.standard_normal((3, 4)),
             "wte.weight": r.standard_normal((7, 3))}
    shares = [shard_expert_params(named, j, 2) for j in range(2)]
    assert shares[1]["blocks.0.moe.experts.w1"].shape == (2, 3, 5)
    np.testing.assert_array_equal(shares[1]["blocks.0.moe.experts.w1"],
                                  named["blocks.0.moe.experts.w1"][2:])
    assert shares[0]["wte.weight"] is not None
    back = gather_expert_params(shares)
    for n, a in named.items():
        np.testing.assert_array_equal(back[n], a)


def test_without_an_ep_axis_the_layer_is_local():
    from paddle_tpu_torch.distributed.mesh import set_mesh
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import \
        expert_parallel_plan

    set_mesh(None)
    assert expert_parallel_plan() is None
    m = MoELayer(D, num_expert=E, d_hidden=HID)
    assert m._dispatch_plan(8) == ("local", 1, None, ())
    assert m.experts.w1.shape[0] == E
    assert not hasattr(m.experts.w1, "ep_sharded")


def test_ep_modules_import_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.distributed\n"
            "import paddle_tpu_torch.distributed.utils.moe_utils\n"
            "import paddle_tpu_torch.incubate.distributed.models.moe\n"
            "import paddle_tpu_torch.models.convert\n"
            "import paddle_tpu_torch.parallel.train_step\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'paddle_tpu.')) or k == 'paddle_tpu')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
