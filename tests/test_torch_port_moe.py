"""The port's MoE layer, dispatch and GPT-MoE against the JAX package on the
CPU (fp32, inputs made with numpy from a seed).

* ``ragged_layout``: order, rank, dest, gbuf and counts EQUAL to JAX's;
* ``_route`` (naive, GShard without random routing, Switch at eps 0):
  top-k indices equal, weights and probabilities within 1e-6;
* ``MoELayer`` with weights carried from the JAX layer: dropless
  token-choice, expert-choice, dropless with a shared expert, and capacity
  (with drops); outputs within 1e-5, gradients of every parameter and of
  the input within 1e-4, ``l_aux``, ``tokens_dropped`` and
  ``expert_counts`` within 1e-6. Random routing draws from threefry keys
  torch cannot reproduce (ROADMAP C.2), so the GShard gates run with
  ``random_routing = False`` on both sides;
* tiny GPT-MoE: logits and loss within 1e-5 for both dispatch modes; and
  3 ``TrainStep`` steps against 3 ``CompiledTrainStep`` steps of AdamW on
  the dropless model after carrying weights and optimizer state from one
  JAX step: losses rtol 1e-5, parameters atol 2e-5, ``moe_aux`` rtol 1e-5;
* the port's own random routing: dropped copies ride the trash bucket
  with combine weight 0, runs with one seed repeat exactly;
* the new modules import neither JAX nor paddle_tpu.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE
from paddle_tpu.incubate.distributed.models.moe.dropless import \
    ragged_layout as jax_ragged_layout
from paddle_tpu.incubate.distributed.models.moe.moe_layer import \
    _route as jax_route
from paddle_tpu.models.gpt_moe import GptMoeForCausalLM as JaxGptMoe
from paddle_tpu.models.gpt_moe import gpt_moe_tiny_config as jax_tiny_config
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel.train_step import CompiledTrainStep
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.incubate.distributed.models.moe.dropless import \
    ragged_layout
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import _route
from paddle_tpu_torch.models import (GptMoeForCausalLM,
                                     from_paddle_tpu_params,
                                     gpt_moe_tiny_config,
                                     optimizer_state_from_paddle_tpu)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep

LR = 1e-3


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _carry(jax_layer, port_layer):
    """Copy a JAX layer's parameters into the port layer of one layout."""
    params = dict(port_layer.named_parameters())
    named = {n: _np(p) for n, p in jax_layer.named_parameters()}
    assert sorted(named) == sorted(params)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(torch.from_numpy(np.array(named[n])))


def _no_random_routing(*models):
    for m in models:
        for layer in (m.sublayers() if hasattr(m, "sublayers")
                      else m.modules()):
            if hasattr(layer, "random_routing"):
                layer.random_routing = False


@pytest.mark.parametrize("bm", [8, 32])
def test_ragged_layout_equals_jax(bm):
    rs = np.random.RandomState(0)
    E = 5
    gids = rs.randint(0, E + 1, 200).astype(np.int32)   # E = trash
    gids[:7] = 2                                         # a long run
    want = jax_ragged_layout(jnp.asarray(gids), E, bm)
    got = ragged_layout(torch.from_numpy(gids), E, bm)
    for name, a, b in zip(("order", "rank", "dest", "gbuf", "counts"), got,
                          want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert got[3].dtype == torch.int32


@pytest.mark.parametrize("routing,k", [
    ((("kind", "naive"),), 2),
    ((("kind", "gshard"), ("random_routing", False)), 2),
    ((("kind", "switch"), ("switch_eps", 0.0)), 1),
], ids=["naive", "gshard", "switch"])
def test_route_equals_jax(routing, k):
    logits = np.random.RandomState(1).randn(64, 6).astype(np.float32)
    jv, ji, jp = jax_route(jnp.asarray(logits), jax.random.key(0), k=k,
                           routing=routing)
    tv, ti, tp = _route(torch.from_numpy(logits), None, k=k, routing=routing)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


MOE_CASES = {
    "dropless": dict(dispatch="dropless"),
    "expert_choice": dict(dispatch="dropless", router="expert"),
    "shared_expert": dict(dispatch="dropless", shared_expert_hidden=24),
    "capacity": dict(dispatch="capacity", capacity_factor=0.5,
                     shared_expert_hidden=24),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_layer_matches_jax(case):
    kw = dict(num_expert=4, d_hidden=32, top_k=2, **MOE_CASES[case])
    paddle.seed(3)
    jm = JaxMoE(16, **kw)
    tm = MoELayer(16, **kw)
    _carry(jm, tm)
    _no_random_routing(jm, tm)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 24, 16).astype(np.float32)
    ct = rs.randn(2, 24, 16).astype(np.float32)

    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jm(jx)
    (jout * paddle.to_tensor(ct)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tm(tx)
    (tout * torch.from_numpy(ct)).sum().backward()

    np.testing.assert_allclose(tout.detach().numpy(), _np(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=1e-4,
                               atol=1e-4)
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jparams[name].grad),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for attr in ("l_aux", "tokens_dropped", "expert_counts"):
        np.testing.assert_allclose(
            getattr(tm, attr).detach().numpy(), _np(getattr(jm, attr)),
            rtol=1e-6, atol=1e-6, err_msg=attr)
    if case == "capacity":
        assert float(tm.tokens_dropped) > 0       # the case drops tokens
        assert tm.last_layout is None
    else:
        gids, bm = tm.last_layout
        assert gids.shape[0] % bm == 0
    stats = tm.last_stats
    assert stats["dropped_tokens"] == float(tm.tokens_dropped)
    assert len(stats["expert_tokens"]) == 4


def _gpt_pair(dispatch, seed=0):
    paddle.seed(seed)
    jm = JaxGptMoe(jax_tiny_config(moe_dispatch=dispatch))
    named = {n: _np(p) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, gpt_moe_tiny_config(
        moe_dispatch=dispatch), device="cpu")
    assert isinstance(tm, GptMoeForCausalLM)
    _no_random_routing(jm, tm)
    return jm, tm


@pytest.mark.parametrize("dispatch", ["dropless", "capacity"])
def test_gpt_moe_logits_and_loss_match_jax(dispatch):
    jm, tm = _gpt_pair(dispatch)
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 256, (2, 32)).astype(np.int64)
    labels = rs.randint(0, 256, (2, 32)).astype(np.int64)
    labels[:, ::5] = -100
    want_logits = _np(jm(paddle.to_tensor(ids)))
    want_loss = float(_np(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(labels))))
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids))
        loss = float(tm(torch.from_numpy(ids),
                        labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    # the weight names map one to one; only the projections are transposed
    jp = dict(jm.named_parameters())
    w1 = "blocks.0.moe.experts.w1"
    assert torch.equal(tm.get_parameter(w1), torch.from_numpy(np.array(_np(jp[w1]))))
    q = "blocks.0.attn.q_proj.weight"
    assert torch.equal(tm.get_parameter(q), torch.from_numpy(np.array(_np(jp[q]).T)))


def _batch(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (2, 32)).astype(np.int32)
    labels = rs.randint(0, 256, (2, 32)).astype(np.int32)
    labels[0, :3] = -100
    return {"input_ids": ids, "labels": labels}


def test_three_train_steps_match_compiled_train_step():
    paddle.seed(0)
    jm = JaxGptMoe(jax_tiny_config(moe_dispatch="dropless"))
    _no_random_routing(jm)
    names = [n for n, _ in jm.named_parameters()]
    jopt = JaxAdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=0.01)
    jstep = CompiledTrainStep(jm, lambda out, lab: out, optimizer=jopt,
                              collect_metrics=True)
    first, batch = _batch(1), _batch(2)
    float(jstep(first))
    jstep.sync_params_to_model()
    jstep.sync_states_to_optimizer()

    tm = from_paddle_tpu_params(
        {n: _np(p) for n, p in jm.named_parameters()},
        gpt_moe_tiny_config(moe_dispatch="dropless"), device="cpu")
    _no_random_routing(tm)
    opt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                weight_decay=0.01)
    optimizer_state_from_paddle_tpu(jopt.state_dict(), names, tm, opt)
    assert opt._step_count == 1
    step = TrainStep(tm, lambda out, lab: out, opt, collect_metrics=True)

    jl, jaux, jsteps = [], [], []
    for _ in range(3):
        jl.append(float(jstep(batch)))
        # JAX's last_metrics settles without blocking and may still hold
        # an earlier step: settle this one before reading it
        jstep.settle_metrics(block=True)
        jm_ = jstep.last_metrics()
        jaux.append(jm_["moe_aux"])
        jsteps.append(jm_["step"])
    tl, taux, tsteps = [], [], []
    for _ in range(3):
        tl.append(float(step(batch)))
        tm_ = step.last_metrics()
        taux.append(tm_["moe_aux"])
        tsteps.append(tm_["step"])
    # each read is of the step just taken, on both sides
    assert jsteps == [2, 3, 4] and tsteps == [2, 3, 4]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    jstep.sync_params_to_model()
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        want = _np(jparams[name])
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            want = want.T
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=2e-5, err_msg=name)
    m = step.last_metrics()
    assert m["step"] == 4 and m["moe_dropped"] == 0.0


def test_random_routing_drops_to_trash_and_repeats_with_a_seed():
    from paddle_tpu_torch.incubate.distributed.models.moe.dropless import (
        _act, _dropless_moe)

    rs = np.random.RandomState(6)
    E, n = 4, 64
    x = torch.from_numpy(rs.randn(n, 16).astype(np.float32))
    layer = MoELayer(16, num_expert=E, d_hidden=32, dispatch="dropless")
    ex = layer.experts
    logits = layer.gate(x).detach()
    routing = layer.gate.routing_config(True)
    assert dict(routing)["random_routing"]

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out = _dropless_moe(x, logits, gen, ex.w1, ex.b1, ex.w2, ex.b2,
                                E=E, k=2, act="gelu", routing=routing)
        gen = torch.Generator().manual_seed(seed)
        return out, _route(logits, gen, k=2, routing=routing)

    (out, _, dropped, counts, (gids, bm)), (topv, topi, _) = run(7)
    (out2, *_), _ = run(7)
    assert torch.equal(out, out2)                 # one seed, one run
    n_drop = int((topi < 0).sum())
    assert 0 < n_drop < n and (topi[:, 0] >= 0).all()
    assert float(dropped) == 0.0
    assert int(counts.sum()) == 2 * n - n_drop
    # the dropped copies ride the trash rows past the aligned buckets
    assert int((gids == E).sum()) >= n_drop
    # ... with combine weight 0: each token gets its kept experts only
    with torch.no_grad():
        ffn = torch.stack([_act(x @ ex.w1[e] + ex.b1[e], "gelu") @ ex.w2[e]
                           + ex.b2[e] for e in range(E)])       # [E, N, d]
        want = sum(torch.where((topi[:, j] >= 0)[:, None],
                               topv[:, j, None]
                               * ffn[topi[:, j].clamp(min=0),
                                     torch.arange(n)], 0.0)
                   for j in range(2))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    (other, *_), _ = run(8)
    assert not torch.equal(other, out)
    # the layer's own generator: reseeding repeats its stream
    layer.manual_seed(3)
    a = layer(x)
    layer.manual_seed(3)
    assert torch.equal(layer(x), a)
    assert not torch.equal(layer(x), a)           # the stream moves on


def test_group_bias_is_exact_whatever_the_matmul_precision():
    from paddle_tpu_torch.incubate.distributed.models.moe.dropless import \
        _GroupBias

    rs = np.random.RandomState(9)
    G, h = 4, 24
    gids = torch.from_numpy(np.sort(rs.randint(0, G + 1, 40))).to(torch.int32)
    b = torch.from_numpy(rs.randn(G, h).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rs.randn(40, h).astype(np.float32))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        rows = _GroupBias.apply(b, gids)
        rows.backward(dy)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    g = gids.long().numpy()
    want = np.concatenate([b.detach().numpy(), np.zeros((1, h), np.float32)])
    assert torch.equal(rows, torch.from_numpy(want[g]))   # trash rows zero
    want_db = np.stack([dy.numpy()[g == e].astype(np.float64).sum(0)
                        for e in range(G)])
    np.testing.assert_allclose(b.grad.numpy(), want_db, rtol=1e-6, atol=1e-6)


def test_moe_modules_import_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.incubate.distributed.models.moe\n"
            "import paddle_tpu_torch.models.gpt_moe\n"
            "import paddle_tpu_torch.ops.cuda.grouped_matmul\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'paddle_tpu.')) or k == 'paddle_tpu')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout

