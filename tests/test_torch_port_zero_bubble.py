"""The port's ZB-H1 pipeline on gloo ranks (CPU) against the JAX
package's ``ZBH1PipelinedStep`` and its fleet ``train_batch``.

``ZBH1PipelinedStep.run`` on the toy model of ``tests/test_zero_bubble.py``
(an embedding, residual tanh MLP blocks of two biased linears, a linear
head, mean cross-entropy; V 64, D 32; M microbatches of 2 x 8 tokens) at
(S, M, blocks) = (2, 4, 4) and (4, 4, 4), each rank holding its stage
only, against JAX's ``run`` on the same weights: the loss rtol 1e-5, every
gradient rtol 1e-4, atol 1e-6 (largest gaps measured on the CPU: loss
0, gradients 6.7e-8 absolute at both shapes). Every linear's dW product
was deferred by the B tick and ran on that microbatch's W tick
(``WGradSink.stats``: queued == run == M x the stage's linears, no
deferred weight's ``.grad`` touched on a B tick).

``fleet.distributed_model(PipelineLayer(...)).train_batch`` with
``schedule_mode`` ZB-H1 at pp 2 against the JAX fleet ZB-H1 run
(``tests/test_zero_bubble.py:150``): 3 steps, losses rtol 1e-5,
parameters atol 2e-5 (measured 8.8e-8 relative, 1.1e-5). At pp 2 x mp 2
ZB-H1 warns and runs 1F1B on both packages; the port holds the same rule
against the JAX fleet run at pp 2 (measured 8.8e-8, 8.3e-6), since the
JAX run at mp 2 takes its unfused CE over the local vocab shard (see the
test).

Under AMP O1 with fp32 master weights, ZB-H1 still defers every linear's
dW (the sink's leaf test is on the master, not on its bf16 copy) and its
gradients equal 1F1B's under the same AMP.

The two spawns (2, then 4 ranks) run from the JAX package's starting
values while the JAX runs go on in this process.

Spawned ranks import torch, numpy and the port only.
"""
import os
import pickle
import warnings

import numpy as np
import pytest
import torch


V, D = 64, 32
CASES = {"S2_M4_B4": (2, 4, 4), "S4_M4_B4": (4, 4, 4)}


def _ids(M):
    rng = np.random.RandomState(0)
    return rng.randint(0, V, (M * 2, 8)).astype(np.int64)


# ---------------------------------------------------------------------------
# the toy model in the port (torch modules through the port's F seam)
# ---------------------------------------------------------------------------

def _toy_modules(n_blocks):
    from torch import nn

    from paddle_tpu_torch.nn import functional as F

    class Emb(nn.Module):
        def __init__(self):
            super().__init__()
            self.e = nn.Embedding(V, D)

        def forward(self, ids):
            return F.embedding(ids, self.e.weight)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(D, 2 * D)
            self.fc2 = nn.Linear(2 * D, D)

        def forward(self, x):
            h = torch.tanh(F.linear(x, self.fc1.weight, self.fc1.bias))
            return x + F.linear(h, self.fc2.weight, self.fc2.bias)

    class Head(nn.Module):
        def __init__(self):
            super().__init__()
            self.h = nn.Linear(D, V)

        def forward(self, x):
            return F.linear(x, self.h.weight, self.h.bias)

    return Emb(), [Block() for _ in range(n_blocks)], Head()


def _toy_loss(logits, labels):
    return torch.nn.functional.cross_entropy(logits.reshape(-1, V),
                                             labels.reshape(-1))


@torch.no_grad()
def _load(module, values):
    """JAX-layout values (Linear weights [in, out]) into a torch module."""
    for n, p in module.named_parameters():
        v = values[n]
        p.copy_(torch.from_numpy(np.ascontiguousarray(
            v.T if p.dim() == 2 and n.endswith("weight")
            and not n.startswith("e.") else v)))


def _zb_case(values, S, M, n_blocks):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.parallel.pipeline import stage_block_indices
    from paddle_tpu_torch.parallel.zero_bubble import ZBH1PipelinedStep

    fleet.reset()
    set_mesh(None)
    mesh = build_mesh({"pp": S})
    s = mesh.coord()["pp"]
    embed, blocks, head = _toy_modules(n_blocks)
    idx = stage_block_indices(n_blocks, S, s)
    _load(embed, values["embed"])
    _load(head, values["head"])
    mine = [blocks[i] for i in idx]
    for i, b in zip(idx, mine):
        _load(b, values["blocks"][i])
    step = ZBH1PipelinedStep(embed if s == 0 else None, mine,
                             head if s == S - 1 else None, _toy_loss,
                             mesh=mesh, num_micro=M)
    ids = _ids(M)
    loss, (g_e, g_b, g_h) = step.run(ids, ids)

    def arr(gs):
        return [g.detach().numpy().copy() for g in gs]

    stats = dict(step.last_stats)
    return {"stage": s, "idx": idx, "loss": float(loss), "g_embed": arr(g_e),
            "g_blocks": [arr(g) for g in g_b], "g_head": arr(g_h),
            "stats": stats,
            "linears": 2 * len(mine) + (1 if s == S - 1 else 0)}


def _zb_amp_case(values, S, M, n_blocks):
    """ZB-H1 and 1F1B on fp32 master weights under AMP O1 (bf16): each
    stage's gradients from both runtimes and ZB-H1's sink counts."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.parallel.pipeline import (PipelinedTrainStep,
                                                    stage_block_indices)
    from paddle_tpu_torch.parallel.zero_bubble import ZBH1PipelinedStep

    fleet.reset()
    set_mesh(None)
    mesh = build_mesh({"pp": S})
    s = mesh.coord()["pp"]
    embed, blocks, head = _toy_modules(n_blocks)
    idx = stage_block_indices(n_blocks, S, s)
    _load(embed, values["embed"])
    _load(head, values["head"])
    mine = [blocks[i] for i in idx]
    for i, b in zip(idx, mine):
        _load(b, values["blocks"][i])
    mods = ([embed] if s == 0 else []) + mine + ([head] if s == S - 1
                                                 else [])
    args = (embed if s == 0 else None, mine, head if s == S - 1 else None,
            _toy_loss)
    ids = _ids(M)
    out = {"stage": s}
    for name, cls, kw in (("zb", ZBH1PipelinedStep, {}),
                          ("1f1b", PipelinedTrainStep, {"remat": "none"})):
        step = cls(*args, mesh=mesh, num_micro=M, **kw)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            out[name + "_loss"] = float(step(ids, ids))
        out[name] = [p.grad.detach().numpy().copy() for m in mods
                     for p in m.parameters()]
        out[name + "_dtypes"] = sorted({str(p.grad.dtype) for m in mods
                                        for p in m.parameters()})
        if name == "zb":
            out["stats"] = dict(step.last_stats)
    out["linears"] = 2 * len(mine) + (1 if s == S - 1 else 0)
    return out


def _rank_main(out_dir, group):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from test_torch_port_pipeline import _fleet_case

    dist.init_parallel_env()
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    out = {}
    for label, (S, M, nb) in CASES.items():
        if S == int(group):
            out[label] = _zb_case(inputs["toy"][label], S, M, nb)
    if group == "2":
        out["fleet_zb"] = _fleet_case(inputs["named_fleet"], "ZB-H1")
        out["amp"] = _zb_amp_case(inputs["toy"]["S2_M4_B4"],
                                  *CASES["S2_M4_B4"])
    if group == "4":
        out["fleet_zb_mp2"] = _fleet_case(inputs["named_fleet_mp2"], "ZB-H1",
                                          axes={"pp": 2, "mp": 2})
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------

def _toy_values(n_blocks):
    """The JAX toy model's values, seeded as ``_jax_toy`` seeds them."""
    from test_zero_bubble import _modules

    embed, blocks, head = _modules(n_blocks)

    def vals(m):
        return {n: np.asarray(p._value).copy()
                for n, p in m.named_parameters()}

    return {"embed": vals(embed), "head": vals(head),
            "blocks": [vals(b) for b in blocks]}


def _jax_fleet_start():
    """The JAX fleet test's pipeline (pp 2, 2 blocks) before any step: the
    values every fleet run here starts from (each JAX run's own
    ``before`` is asserted equal)."""
    import paddle_tpu as paddle
    import paddle_tpu.models.llama as jl
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.fleet.meta_parallel import PipelineLayer
    from paddle_tpu.distributed.mesh import set_mesh
    from test_torch_port_pipeline import _jax_pipe_named

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 2, "sharding_degree": 1,
                               "sep_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        paddle.seed(0)
        cfg = jl.llama_tiny_config(num_hidden_layers=2,
                                   use_parallel_cross_entropy=False)
        pipe = PipelineLayer(layers=jl.LlamaForCausalLM.pipeline_layers(cfg),
                             num_stages=2)
        return _jax_pipe_named(pipe, 2)
    finally:
        set_mesh(None)


def _jax_toy(S, M, n_blocks):
    """JAX's toy model (tests/test_zero_bubble.py) seeded as there, its
    values, and its ZBH1PipelinedStep.run: (values, loss, grads)."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.parallel.zero_bubble import ZBH1PipelinedStep
    from test_zero_bubble import _modules, loss_fn

    embed, blocks, head = _modules(n_blocks)

    def vals(m):
        return {n: np.asarray(p._value).copy()
                for n, p in m.named_parameters()}

    values = {"embed": vals(embed), "head": vals(head),
              "blocks": [vals(b) for b in blocks]}
    mesh = build_mesh({"pp": S})
    try:
        step = ZBH1PipelinedStep(embed, blocks, head, loss_fn, mesh=mesh,
                                 num_micro=M)
        ids = _ids(M)
        loss, (g_e, g_st, g_h) = step.run(ids, ids)
        nb = len(blocks[0].parameters())
        g_blocks = []
        for lb in range(n_blocks):
            g_blocks.append([np.asarray(g_st[i]).reshape(
                (n_blocks,) + np.asarray(g_st[i]).shape[2:])[lb]
                for i in range(nb)])
        return values, float(loss), ([np.asarray(g) for g in g_e],
                                     g_blocks, [np.asarray(g) for g in g_h])
    finally:
        set_mesh(None)
        del paddle


_JAX = {}


def _jax_toy_cached(label):
    if label not in _JAX:
        _JAX[label] = _jax_toy(*CASES[label])
    return _JAX[label]


def _jax_fleet_mp2():
    """The JAX fleet ZB-H1 train_batch at pp 2 x mp 2: it warns and runs
    its 1F1B program; (losses, named values before and after, the
    compiled step's class name, the warnings). Its mp layers draw their
    initial values otherwise than at mp 1, so the port starts from these
    ``before`` values."""
    import paddle_tpu as paddle
    import paddle_tpu.models.llama as jl
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.fleet.meta_parallel import PipelineLayer
    from paddle_tpu.distributed.mesh import set_mesh
    from test_torch_port_pipeline import LR, _jax_pipe_named

    jl._shared_rope_tables.cache_clear()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 2, "sharding_degree": 1,
                               "sep_degree": 1}
    strategy.pipeline_configs = {"accumulate_steps": 2,
                                 "micro_batch_size": 2,
                                 "schedule_mode": "ZB-H1"}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        paddle.seed(0)
        cfg = jl.llama_tiny_config(num_hidden_layers=2,
                                   use_parallel_cross_entropy=False)
        crit = jl.LlamaPretrainingCriterion(cfg)
        pipe = PipelineLayer(layers=jl.LlamaForCausalLM.pipeline_layers(cfg),
                             num_stages=2,
                             loss_fn=lambda out, lab: crit(out, lab))
        before = _jax_pipe_named(pipe, 2)
        model = fleet.distributed_model(pipe)
        opt = fleet.distributed_optimizer(
            paddle.optimizer.AdamW(learning_rate=LR,
                                   parameters=pipe.parameters(),
                                   weight_decay=0.01))
        rng = np.random.RandomState(0)
        ids = paddle.to_tensor(rng.randint(0, 256, (4, 16)).astype(np.int64))
        labels = paddle.to_tensor(
            rng.randint(0, 256, (4, 16)).astype(np.int64))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses = [float(model.train_batch([ids, labels], opt))
                      for _ in range(3)]
        kind = type(model._compiled_step).__name__
        model._sync_from_compiled()
        return (losses, before, _jax_pipe_named(pipe, 2), kind,
                [str(w.message) for w in caught])
    finally:
        set_mesh(None)


def _once(fn):
    """fn()'s result, computed once a module run."""
    if fn.__name__ not in _JAX:
        _JAX[fn.__name__] = fn()
    return _JAX[fn.__name__]


def _jax_fleet_zb():
    from test_torch_port_pipeline import _fleet_ref

    return _fleet_ref("ZB-H1")


def _jax_1f1b_pp2():
    from test_torch_port_pipeline import _fleet_ref

    return _fleet_ref("1F1B")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two spawns (2, then 4 ranks) from the JAX package's starting
    values, while the JAX runs go on in this process."""
    from test_torch_port_pipeline import _spawn_groups

    start = _once(_jax_fleet_start)
    inputs = {"toy": {label: _toy_values(CASES[label][2])
                      for label in CASES},
              "named_fleet": start, "named_fleet_mp2": start}
    thread, res = _spawn_groups(tmp_path_factory,
                                {"2": (2, inputs), "4": (4, inputs)},
                                _rank_main)
    try:
        for label in CASES:
            _jax_toy_cached(label)
        _once(_jax_fleet_zb)
        _once(_jax_fleet_mp2)
        _once(_jax_1f1b_pp2)
    finally:
        thread.join()
    if "error" in res:
        raise res["error"]
    for label in CASES:
        toy = _jax_toy_cached(label)[0]
        sent = inputs["toy"][label]
        for part in ("embed", "head"):
            for n, v in toy[part].items():
                np.testing.assert_array_equal(sent[part][n], v)
        for a, b in zip(toy["blocks"], sent["blocks"]):
            for n, v in a.items():
                np.testing.assert_array_equal(b[n], v)
    return res


@pytest.fixture(scope="module")
def fleet_refs(ranks):
    return _once(_jax_fleet_zb)


@pytest.fixture(scope="module")
def mp2_ref(ranks):
    return _once(_jax_fleet_mp2)


@pytest.mark.parametrize("label", list(CASES))
def test_zbh1_run_matches_jax_run(ranks, label):
    S, M, n_blocks = CASES[label]
    _, jloss, (j_e, j_b, j_h) = _jax_toy_cached(label)
    res = [r[label] for r in ranks[str(S)]]
    for r in res:
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        if r["stage"] == 0:
            for g, w in zip(r["g_embed"], j_e):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        if r["stage"] == S - 1:
            np.testing.assert_allclose(r["g_head"][0], j_h[0].T, rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(r["g_head"][1], j_h[1], rtol=1e-4,
                                       atol=1e-6)
        for i, gs in zip(r["idx"], r["g_blocks"]):
            # port order: fc1.weight, fc1.bias, fc2.weight, fc2.bias (the
            # JAX block's parameters in the same order)
            for g, w in zip(gs, j_b[i]):
                np.testing.assert_allclose(g, w.T if w.ndim == 2 else w,
                                           rtol=1e-4, atol=1e-6)
    assert sorted(r["stage"] for r in res) == list(range(S))


@pytest.mark.parametrize("label", list(CASES))
def test_every_deferred_dw_runs_on_a_w_tick(ranks, label):
    S, M, _ = CASES[label]
    for r in ranks[str(S)]:
        st = r[label]["stats"]
        assert st["queued"] == st["w_ran"] == M * r[label]["linears"] > 0
        assert st["b_touched"] == 0
        assert sorted(st["w_ticks"]) == list(range(M))


def test_zb_schedule_table_is_the_one_run():
    from paddle_tpu_torch.parallel.pipeline_schedules import (
        check_schedule, zb_h1_schedule)

    for S, M, _ in CASES.values():
        sched = zb_h1_schedule(S, M)
        check_schedule(sched)
        for r in range(S):
            col = [row[r] for row in sched["ticks"] if row[r] is not None]
            assert [m for op, m, _ in col if op == "W"] == list(range(M))


def test_fleet_train_batch_zbh1_matches_jax(ranks, fleet_refs):
    from paddle_tpu_torch.models.convert import gather_pipeline_params

    jl, before, after, kind = fleet_refs
    assert kind == "ZBH1PipelinedStep"
    start = _once(_jax_fleet_start)
    assert all(np.array_equal(before[n], start[n]) for n in start)
    res = [r["fleet_zb"] for r in ranks["2"]]
    for r in res:
        assert r["is_pp"] and r["mode"] == "ZBH1"
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5, atol=0)
        st = r["zb_stats"]
        assert st["queued"] == st["w_ran"] > 0 and st["b_touched"] == 0
    full = gather_pipeline_params([r["params"] for r in res], 2)
    for n, want in after.items():
        np.testing.assert_allclose(full[n], want, rtol=0, atol=2e-5,
                                   err_msg=n)
    assert jl[-1] < jl[0]


def test_zbh1_at_mp2_warns_and_runs_1f1b(ranks, mp2_ref, fleet_refs):
    """Both packages warn and run 1F1B at pp 2 x mp 2. The port is held
    to the JAX fleet run at pp 2 (mp changes no math; the same initial
    values, asserted), not to JAX's own mp 2 run: with the JAX fleet
    test's criterion (``use_parallel_cross_entropy=False``) the JAX
    pipeline's head region takes the CE over the local vocab shard under
    mp (first loss 5.145 against 5.897 at mp 1 on the same weights and
    rows, asserted)."""
    from paddle_tpu_torch.models.convert import gather_pipeline_params

    jl_mp2, before_mp2, _, kind, jwarn = mp2_ref
    jl, before, jparams, _ = _jax_1f1b_pp2()
    assert kind == "PipelinedTrainStep"
    assert any("ZB-H1" in w for w in jwarn)
    assert all(np.array_equal(before[n], before_mp2[n]) for n in before)
    start = _once(_jax_fleet_start)
    assert all(np.array_equal(before[n], start[n]) for n in start)
    assert abs(jl_mp2[0] - jl[0]) / jl[0] > 0.1
    res = [r["fleet_zb_mp2"] for r in ranks["4"]]
    for r in res:
        assert r["mode"] == "1F1B"
        assert any("ZB-H1" in w and "1F1B" in w for w in r["warnings"])
        assert r["zb_stats"] is None
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5, atol=0)
    stages = []
    for s in range(2):
        mine = sorted((r for r in res if r["coord"]["pp"] == s),
                      key=lambda r: r["coord"]["mp"])
        stages.append([r["params"] for r in mine])
    full = gather_pipeline_params(stages, 2)
    for n, want in jparams.items():
        np.testing.assert_allclose(full[n], want, rtol=0, atol=2e-5,
                                   err_msg=n)


def test_zbh1_defers_dw_under_amp_with_fp32_masters(ranks):
    """Under AMP O1 the linears take bf16 copies of the fp32 master
    weights; the sink's leaf test is on the master, so every linear's dW
    is still deferred to a W tick and lands in the master's fp32 ``.grad``.
    ZB-H1's gradients against 1F1B's under the same AMP: the loss rtol
    1e-5, gradients rtol 1e-4, atol 1e-6 (measured on the CPU: both equal
    bit for bit). With the leaf test on the cast copy, nothing was queued
    and this test fails (checked on a copy of the code)."""
    S, M, _ = CASES["S2_M4_B4"]
    for r in (q["amp"] for q in ranks["2"]):
        st = r["stats"]
        assert st["queued"] == st["w_ran"] == M * r["linears"] > 0
        assert st["b_touched"] == 0
        assert r["zb_dtypes"] == r["1f1b_dtypes"] == ["torch.float32"]
        np.testing.assert_allclose(r["zb_loss"], r["1f1b_loss"], rtol=1e-5)
        for a, b in zip(r["zb"], r["1f1b"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
