"""Paddle's group-sharded API of the port (``distributed.sharding.
group_sharded_parallel``, ``fleet.sharding_stages``) on 4 gloo ranks (CPU)
against the JAX package's eager loop.

Each rank wraps the pipeline tests' tiny LLaMA (4 layers, hidden 64,
vocab 128; the JAX model's weights through ``models.convert``) and an
AdamW (lr 1e-3, wd 0.01) with ``group_sharded_parallel(model, opt,
level)`` on a ``{"dp": 4}`` mesh, and runs ``loss = model(ids,
labels=labels); loss.backward(); opt.step(); opt.clear_grad()`` 3 times
on its own 2 rows of the global 8 x 16 batch. The JAX package runs the
same loop through its ``group_sharded_parallel(level="p_g_os")`` over a
``{"dp": 4}`` mesh on the whole batch. Rules: the ranks' mean loss
within 1e-5 relative of JAX's at every step, the parameters (gathered at
``"p_g_os"``) within 2e-5 of JAX's at each element (the training tests'
rule), every rank equal.

As ``tests/test_group_sharded.py`` asks of the JAX package, each level
measurably shards: at ``"os"`` every rank holds 1/4 of each parameter's
optimizer state (its slice, rounded up), at ``"os_g"`` the gradients
too (each reduce-scattered as the backward completes it, none left
whole; at ``"p_g_os"`` the layers' in the backward, the outer units' at
the step), at ``"p_g_os"`` the parameters (the parameters hold no data, each
unit's shard is 1/4 of it plus the padding) and ``get_all_parameters()``
restores the full parameters. ``ShardOptimizerWrapper`` shards the
optimizer state at ``ShardingStage1/2`` and the parameters as well at
``ShardingStage3``, training the same steps; at ``ShardingStage3`` its
global forward pre-hook is armed only from a step to the next forward,
and goes with the wrapper. At ``"p_g_os"`` a model whose parameters some
steps (a held unit's second weight) or some ranks' batches (a whole
unit) leave without a gradient trains as the unwrapped model does on the
4 ranks' rows, a missing gradient counting as zeros (the sharding
optimizer's rule). ``GroupShardedStage3``'s
``state_dict`` is full and ``set_state_dict`` re-shards it;
``sync_buffers`` broadcasts the buffers from the group's first rank.

Spawned ranks import torch, numpy and the port only.
"""
import gc
import os
import pickle
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

LR = 1e-3
N = 4
SPAWN_TIMEOUT_S = 240
LEVELS = ("os", "os_g", "p_g_os")
STAGES = (1, 2, 3)


def _cfg_kw():
    return dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=32)


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (8, 16)).astype(np.int64)
    labels = rng.randint(0, 128, (8, 16)).astype(np.int64)
    return ids, labels


# ---------------------------------------------------------------------------
# the ranks (torch and the port only)
# ---------------------------------------------------------------------------

def _model(named):
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW

    model = from_paddle_tpu_params(named, llama_tiny_config(**_cfg_kw()),
                                   device="cpu")
    return model, AdamW(learning_rate=LR, parameters=model.parameters(),
                        weight_decay=0.01)


def _local():
    from paddle_tpu_torch.distributed import get_rank

    ids, labels = _batch()
    k = ids.shape[0] // N
    r = get_rank()
    return (torch.from_numpy(ids[r * k:(r + 1) * k]),
            torch.from_numpy(labels[r * k:(r + 1) * k]))


def _mean(loss):
    from paddle_tpu_torch.distributed import collective

    t = loss.detach().clone()
    collective.all_reduce(t, collective.ReduceOp.AVG)
    return float(t)


def _state_fraction(opt, full_numels):
    """Each parameter's optimizer-state elements here over its full size
    (the first state key's)."""
    inner = opt
    while hasattr(inner, "_inner_opt") or hasattr(inner, "_optim"):
        inner = getattr(inner, "_optim", None) or inner._inner_opt
    out = []
    for i, n in enumerate(full_numels):
        st = inner._state.get(i)
        out.append(None if not st else
                   next(iter(st.values())).numel() / n)
    return out


def _level_case(named, level):
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    model, opt = _model(named)
    numels = [p.numel() for p in model.parameters()]
    m, o, _ = group_sharded_parallel(model, opt, level)
    ids, labels = _local()
    out = {"losses": []}
    for i in range(3):
        loss = m(ids, labels=labels)
        loss.backward()
        if i == 0:
            out["whole_grads"] = sum(p.grad is not None
                                     for p in model.parameters())
            out["whole_grad_names"] = sorted(
                n for n, p in model.named_parameters() if p.grad is not None)
            sl = o._optim._slices
            out["slice_grads"] = [None if s.grad is None else s.grad.numel()
                                  for s in sl]
            out["param_data_after_backward"] = sum(
                p.numel() for p in model.parameters())
        o.step()
        if i == 0:
            out["whole_grads_after_step"] = sum(p.grad is not None
                                                for p in model.parameters())
            out["param_data"] = sum(p.numel() for p in model.parameters())
        o.clear_grad()
        out["losses"].append(_mean(loss))
    out["numels"] = numels
    out["state_fraction"] = _state_fraction(o, numels)
    if level == "p_g_os":
        sh = m.sharder
        out["held_names"] = sorted(n for u in sh.held_units for n in u.names)
        out["held_numel"] = sum(b.total for u in sh.held_units
                                for b in u.buckets)
        out["resident"], out["full"] = sh.resident_bytes(), sh.full_bytes()
        out["buckets"] = sum(len(u.buckets) for u in sh.units)
        out["params"] = m.state_dict()
        full = m.get_all_parameters()
        out["all_params"] = [p.detach().clone() for p in full]
        out["all_names"] = [n for n, _ in model.named_parameters()]
        # a further forward re-shards what get_all_parameters left full
        with torch.no_grad():
            out["eval_loss"] = _mean(m(ids, labels=labels))
        m.release()
        out["param_data_after_eval"] = sum(p.numel() for p in
                                           model.parameters())
        # set_state_dict re-shards a full state dict
        model2, opt2 = _model(named)
        m2, _, _ = group_sharded_parallel(model2, opt2, level)
        m2.set_state_dict(out["params"])
        out["reloaded"] = m2.state_dict()
    else:
        out["params"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
    return out


def _wrapper_case(named, stage):
    from paddle_tpu_torch.distributed.fleet.sharding_stages import (
        ShardingStage1, ShardingStage2, ShardingStage3,
        ShardOptimizerWrapper)
    from paddle_tpu_torch.optimizer import AdamW

    model, _ = _model(named)
    # named, so the stage-3 units carry the model's parameter names
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                weight_decay=0.01)
    numels = [p.numel() for p in model.parameters()]
    fn = {1: ShardingStage1, 2: ShardingStage2, 3: ShardingStage3}[stage]
    hooks = torch.nn.modules.module._global_forward_pre_hooks
    base = len(hooks)
    w = ShardOptimizerWrapper(opt, fn("dp"))
    out = {"param_data": sum(p.numel() for p in model.parameters()),
           "losses": [], "hooks": [len(hooks) - base]}
    ids, labels = _local()
    for _ in range(3):
        loss = model(ids, labels=labels)
        out["hooks"].append(len(hooks) - base)
        loss.backward()
        w.step()
        w.clear_grad()
        out["hooks"].append(len(hooks) - base)
        out["losses"].append(_mean(loss))
    out["state_fraction"] = _state_fraction(w, numels)
    out["params"] = (w.sharder.full_state() if w.sharder is not None else
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()})
    del w
    gc.collect()
    out["hooks_after_del"] = len(hooks) - base
    return out


SOMETIMES_B = (False, True, True)            # step: w_b used on every rank
SOMETIMES_C = ({0}, set(), {1, 2, 3})        # step: the ranks using extra.c


class _Scale(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = torch.nn.Parameter(c)

    def forward(self, y):
        return y * self.c


class _Sometimes(torch.nn.Module):
    """Two held units: the model's own (`w_a`, and `w_b`, which only some
    steps use) and `extra`'s (`c`, which only some ranks' batches use)."""

    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(1)
        self.w_a = torch.nn.Parameter(torch.from_numpy(
            (0.3 * rng.randn(8, 8)).astype(np.float32)))
        self.w_b = torch.nn.Parameter(torch.from_numpy(
            (1.0 + 0.1 * rng.randn(8)).astype(np.float32)))
        self.extra = _Scale(torch.from_numpy(
            (1.0 + 0.1 * rng.randn(8)).astype(np.float32)))

    def forward(self, x, use_b, use_c):
        y = torch.tanh(x @ self.w_a)
        if use_b:
            y = y * self.w_b
        if use_c:
            y = self.extra(y)
        return (y - 0.5).square().mean()


def _sometimes_case():
    """3 eager steps of ``group_sharded_parallel(level="p_g_os")`` on a
    model whose parameters some steps or some ranks leave without a
    gradient, and the unwrapped model on the 4 ranks' rows in this
    process: a parameter without a gradient takes zeros, the sharding
    optimizer's rule."""
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.optimizer import AdamW

    xs = torch.from_numpy(np.random.RandomState(2).randn(
        N, 2, 8).astype(np.float32))
    r = get_rank()
    model, ref = _Sometimes(), _Sometimes()
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01)
    ref_opt = AdamW(learning_rate=LR, parameters=ref.parameters(),
                    weight_decay=0.01)
    m, o, _ = group_sharded_parallel(model, opt, "p_g_os")
    out = {"losses": [], "ref_losses": []}
    for step in range(3):
        loss = m(xs[r], SOMETIMES_B[step], r in SOMETIMES_C[step])
        loss.backward()
        o.step()
        o.clear_grad()
        out["losses"].append(_mean(loss))
        ref_loss = sum(ref(xs[q], SOMETIMES_B[step], q in SOMETIMES_C[step])
                       for q in range(N)) / N
        ref_loss.backward()
        for p in ref.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ref_opt.step()
        ref_opt.clear_grad()
        out["ref_losses"].append(float(ref_loss))
    out["params"] = m.state_dict()
    out["ref_params"] = {n: p.detach().clone()
                         for n, p in ref.named_parameters()}
    return out


def _sync_buffers_case(named):
    """A buffer perturbed on ranks other than 0 comes back equal to rank
    0's after a wrap with ``sync_buffers=True``."""
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    out = {}
    for level in ("os_g", "p_g_os"):
        model, opt = _model(named)
        want = model.llama.rope_cos.clone()
        if get_rank() != 0:
            with torch.no_grad():
                model.llama.rope_cos.add_(1.0)
        group_sharded_parallel(model, opt, level, sync_buffers=True)
        out[level] = bool(torch.equal(model.llama.rope_cos, want))
    return out


def _rank_main(out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.mesh import build_mesh

    dist.init_parallel_env()
    with open(os.path.join(out_dir, "named.pkl"), "rb") as fh:
        named = pickle.load(fh)
    build_mesh({"dp": N})
    out = {lv: _level_case(named, lv) for lv in LEVELS}
    out["wrapper"] = {s: _wrapper_case(named, s) for s in STAGES}
    out["sync_buffers"] = _sync_buffers_case(named)
    out["sometimes"] = _sometimes_case()
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX reference (this process)
# ---------------------------------------------------------------------------

def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny

    paddle.seed(0)
    return JaxLlama(jax_tiny(**_cfg_kw()))


def _jax_loop():
    """JAX's group_sharded_parallel("p_g_os") eager loop over a dp-4 mesh:
    (losses, named params)."""
    import paddle_tpu as paddle
    import paddle_tpu.models.llama as jl
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.distributed.sharding import group_sharded_parallel

    jl._shared_rope_tables.cache_clear()
    build_mesh({"dp": N})
    try:
        jm = _jax_model()
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=jm.parameters(),
                                     weight_decay=0.01)
        m, o, _ = group_sharded_parallel(jm, opt, "p_g_os")
        ids, labels = (paddle.to_tensor(v) for v in _batch())
        losses = []
        for _ in range(3):
            loss = m(ids, labels=labels)
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(loss))
        m.get_all_parameters()
        named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    finally:
        set_mesh(None)
    return losses, named


_JAX = {}


def _jax():
    if "loop" not in _JAX:
        _JAX["loop"] = _jax_loop()
    return _JAX["loop"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("group_sharded"))
    named = {n: np.asarray(p._value)
             for n, p in _jax_model().named_parameters()}
    with open(os.path.join(out, "named.pkl"), "wb") as fh:
        pickle.dump(named, fh)
    err = []

    def run():
        try:
            spawn(_rank_main, (out,), nprocs=N, timeout=SPAWN_TIMEOUT_S)
        except BaseException as e:  # re-raised below
            err.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        _jax()
    finally:
        thread.join()
    if err:
        raise err[0]
    res = []
    for r in range(N):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _port_named(params):
    from paddle_tpu_torch.models import gather_paddle_tpu_params

    return gather_paddle_tpu_params([params])


def _hold(losses, params):
    jl, jparams = _jax()
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=0)
    assert jl[2] < jl[0]
    full = _port_named(params)
    assert set(full) == set(jparams)
    for name, want in jparams.items():
        np.testing.assert_allclose(full[name], want, rtol=0, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("level", LEVELS)
def test_levels_train_the_jax_steps(ranks, level):
    for r in ranks:
        _hold(r[level]["losses"], r[level]["params"])
        for name, p in r[level]["params"].items():
            assert torch.equal(p, ranks[0][level]["params"][name]), name


@pytest.mark.parametrize("level", LEVELS)
def test_each_rank_holds_a_quarter_of_the_optimizer_state(ranks, level):
    for r in ranks:
        res = r[level]
        for frac, n in zip(res["state_fraction"], res["numels"]):
            assert frac is not None
            if level == "p_g_os":
                # a unit's slices tile its flat buffer: a parameter's
                # slice is at most its whole, and the slices sum to 1/4
                assert frac <= 1.0
            else:
                assert frac == -(-n // N) / n
    if level == "p_g_os":
        for i, n in enumerate(ranks[0][level]["numels"]):
            assert sum(r[level]["state_fraction"][i] for r in ranks) == \
                pytest.approx(1.0)


@pytest.mark.parametrize("level", LEVELS)
def test_gradients_are_sharded_from_os_g(ranks, level):
    for r in ranks:
        res = r[level]
        if level == "os":
            assert res["whole_grads"] == len(res["numels"])
            assert all(g is None for g in res["slice_grads"])
        elif level == "p_g_os":
            # the layer loop reduce-scatters each layer's gradients in the
            # backward; the held units (embedding, final norm, head) keep
            # theirs until the step reduce-scatters them
            assert res["whole_grad_names"] == res["held_names"]
            assert len(res["held_names"]) == 3
            assert res["whole_grads_after_step"] == 0
        else:
            assert res["whole_grads"] == 0
        if level == "os_g":
            assert res["slice_grads"] == [-(-n // N) for n in res["numels"]]


def test_p_g_os_shards_the_parameters(ranks):
    for r in ranks:
        res = r["p_g_os"]
        # after the backward only the held units are whole; after the step
        # no parameter holds data
        assert res["param_data_after_backward"] == res["held_numel"] > 0
        assert res["param_data"] == 0
        pad = res["buckets"] * N * 4
        assert res["resident"] * N <= res["full"] + pad
        assert res["resident"] * N >= res["full"]
        assert res["param_data_after_eval"] == 0


def test_get_all_parameters_restores_them(ranks):
    for r in ranks:
        res = r["p_g_os"]
        params = dict(zip(res["all_names"], res["all_params"]))
        assert set(params) == set(res["params"])
        for name, p in params.items():
            assert p.numel() > 0 and torch.equal(p, res["params"][name])
        np.testing.assert_allclose(res["eval_loss"], _jax_eval_loss(),
                                   rtol=1e-5)


def _jax_eval_loss():
    """The JAX model's loss on the batch after the 3 steps."""
    import paddle_tpu as paddle

    if "eval" not in _JAX:
        jm = _jax_model()
        _, named = _jax()
        for n, p in jm.named_parameters():
            p._set_value(paddle.to_tensor(named[n])._value)
        ids, labels = (paddle.to_tensor(v) for v in _batch())
        _JAX["eval"] = float(jm(ids, labels=labels))
    return _JAX["eval"]


def test_stage3_state_dict_round_trip(ranks):
    for r in ranks:
        res = r["p_g_os"]
        assert set(res["reloaded"]) == set(res["params"])
        for name, p in res["params"].items():
            assert torch.equal(res["reloaded"][name], p), name


@pytest.mark.parametrize("stage", STAGES)
def test_shard_optimizer_wrapper(ranks, stage):
    for r in ranks:
        res = r["wrapper"][stage]
        _hold(res["losses"], res["params"])
        if stage == 3:
            assert res["param_data"] == 0
            assert sum(q["wrapper"][3]["state_fraction"][0]
                       for q in ranks) == pytest.approx(1.0)
        else:
            assert res["param_data"] > 0
            assert res["state_fraction"][0] == 0.25


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_sync_buffers_broadcasts_them(ranks, level):
    assert all(r["sync_buffers"][level] for r in ranks)


def test_save_group_sharded_model_waits_for_framework_io(tmp_path):
    """Since ``framework.io_`` is ported, the model and optimizer state
    are written in the JAX package's format (the ZeRO-3 case is
    ``test_torch_port_auto_parallel``'s)."""
    import paddle_tpu as jpaddle
    from paddle_tpu_torch.distributed.sharding import (
        save_group_sharded_model)
    from paddle_tpu_torch.optimizer import AdamW

    model = torch.nn.Linear(3, 2)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    out = str(tmp_path / "gs")
    save_group_sharded_model(model, out, opt)
    got = jpaddle.load(out + ".pdmodel")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(np.asarray(got[k]._value),
                                      v.detach().numpy())
    assert jpaddle.load(out + ".pdopt")["step"] == 1


@pytest.mark.parametrize("stage", STAGES)
def test_shard_optimizer_wrapper_hooks_one_forward_a_step(ranks, stage):
    """At ShardingStage3 the wrapper's global forward pre-hook is armed
    from construction and each step until the forward that gathers the
    parameters, and goes with the wrapper; the other stages hook
    nothing."""
    armed = 1 if stage == 3 else 0
    for r in ranks:
        res = r["wrapper"][stage]
        assert res["hooks"] == [armed] + [0, armed] * 3
        assert res["hooks_after_del"] == 0


def test_p_g_os_with_parameters_some_steps_leave_unused(ranks):
    """A held unit's parameter without a gradient on a step (w_b) and a
    unit that only some ranks use (extra): the sharded steps equal the
    unwrapped model's on the 4 ranks' rows."""
    for r in ranks:
        res = r["sometimes"]
        np.testing.assert_allclose(res["losses"], res["ref_losses"],
                                   rtol=1e-5, atol=0)
        assert set(res["params"]) == set(res["ref_params"])
        for name, want in res["ref_params"].items():
            np.testing.assert_allclose(res["params"][name], want, rtol=0,
                                       atol=2e-5, err_msg=name)
            assert torch.equal(res["params"][name],
                               ranks[0]["sometimes"]["params"][name]), name
