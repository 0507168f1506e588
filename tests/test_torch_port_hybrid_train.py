"""Hybrid-parallel LLaMA training of the port on 4 gloo ranks (CPU)
against the JAX package's ``CompiledTrainStep`` over a mesh.

The port runs a process per rank (``distributed.spawn``, gloo on
loopback, a free port); each rank holds its mp shards of the JAX model's
weights (``models.convert``) and takes 3 ``TrainStep(mesh=, zero_axis=,
zero_stage=)`` steps on the global batch. The JAX package runs the same
3 steps as one SPMD program over the 8 virtual CPU devices of
``tests/conftest.py`` (``build_mesh`` of the same axes). Layouts: dp 2 x
mp 2, mp 2 x sharding 2 with ZeRO-1 and with ZeRO-2, dp 4, and dp 4 with
ZeRO over the dp axis.

Rules: per-step losses fp32 rtol 1e-5; the parameters gathered from the
mp ranks atol 2e-5 against the JAX ones (PR 2's rule: Adam moves an
element by a small multiple of lr when its gradients differ in their
last bits; the largest gaps measured on this CPU were 2.9e-6 for the
parameters (dp 4) and 1.7e-7 relative for the losses (mp 2)); every
data-parallel and
sharding replica holds the same parameters; ``grad_norm`` (the hybrid
global norm) within 1e-5 relative of JAX's. The batch has no ignored
labels: the JAX step means over the global batch, the port's data ranks
mean their own rows and average, which agree when every rank holds as
many tokens. At dp 2 x mp 2 the logits gathered over mp and the fused and
unfused (vocab-parallel) losses equal the JAX model's forward, fp32 1e-5.
What is not ported raises naming ROADMAP A8: fp8, serving and LoRA under
mp > 1. ZeRO-3 and ZeRO inside a pipeline stage are
``tests/test_torch_port_zero3.py``'s; here fp8 under ZeRO-3 and VPP with
a zero axis raise, as in the JAX package.

Spawned ranks import torch, numpy and the port only; the JAX reference
is built in this process.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

LR = 1e-3
SEED = 0
LAYOUTS = {
    "dp2_mp2": ({"dp": 2, "mp": 2}, None, 1),
    "mp2_sharding2_zero1": ({"mp": 2, "sharding": 2}, "sharding", 1),
    "mp2_sharding2_zero2": ({"mp": 2, "sharding": 2}, "sharding", 2),
    "dp4": ({"dp": 4}, None, 1),
    "dp4_zero_dp": ({"dp": 4}, "dp", 1),
}
SPAWN_TIMEOUT_S = 240


def _batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(1, 256, (4, 33)).astype(np.int64)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _cfg_kw():
    return dict(num_key_value_heads=2)


def _fused_loss(out, labels):
    return out


def _train_rank(out_dir):
    """One rank: every layout's 3 steps; writes rank<r>.pkl."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    dist.init_parallel_env()
    with open(os.path.join(out_dir, "named.pkl"), "rb") as fh:
        named = pickle.load(fh)
    batch = _batch()
    out = {}
    for label, (axes, zero_axis, stage) in LAYOUTS.items():
        fleet.reset()
        mesh = build_mesh(axes)
        model = from_paddle_tpu_params(named, llama_tiny_config(**_cfg_kw()),
                                       device="cpu")
        opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                    weight_decay=0.01)
        step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                         mesh=mesh, zero_axis=zero_axis, zero_stage=stage)
        losses = [float(step(batch)) for _ in range(3)]
        out[label] = {
            "coord": mesh.coord(), "losses": losses,
            "metrics": step.last_metrics(),
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}
    # what raises: fp8 under mp (ROADMAP A8), fp8 under ZeRO-3 and VPP
    # with a zero axis (the JAX package's refusals)
    fleet.reset()
    mesh = build_mesh({"dp": 2, "mp": 2})
    model = from_paddle_tpu_params(named, llama_tiny_config(**_cfg_kw()),
                                   device="cpu")
    # the mp model's logits (gathered over mp) and its unfused loss
    ids, labels = (torch.from_numpy(v) for v in batch.values())
    from paddle_tpu_torch.core.flags import set_flags

    with torch.no_grad():
        out["logits"] = model(ids).numpy()
        out["loss_fused"] = float(model(ids, labels=labels))
        set_flags({"use_fused_head_loss": False})
        out["loss_unfused"] = float(model(ids, labels=labels))
        set_flags({"use_fused_head_loss": True})
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    raised = {}
    try:
        TrainStep(model, _fused_loss, opt, mesh=mesh, zero_axis="dp",
                  zero_stage=3, fp8_policy="matmuls")
    except ValueError as e:
        raised["zero3_fp8"] = str(e)
    step = TrainStep(model, _fused_loss, opt, mesh=mesh,
                     fp8_policy="matmuls")
    try:
        step(batch)
    except NotImplementedError as e:
        raised["fp8"] = str(e)
    try:
        model.decode_forward(None, None, None, None, None)
    except NotImplementedError as e:
        raised["serving"] = str(e)
    from paddle_tpu_torch import lora

    try:
        lora.attach(model, lora.LoRAConfig(rank=4))
    except NotImplementedError as e:
        raised["lora"] = str(e)
    # ZeRO inside a pipeline stage under VPP
    fleet.reset()
    mesh = build_mesh({"pp": 2, "dp": 2})
    from paddle_tpu_torch.parallel.pipeline import PipelinedTrainStep

    try:
        PipelinedTrainStep(None, [], None, _fused_loss, mesh=mesh,
                           zero_axis="dp", virtual_pp=2)
    except ValueError as e:
        raised["pp_vpp_zero_axis"] = str(e)
    out["raised"] = raised
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


def _jax_named():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny

    paddle.seed(SEED)
    jm = JaxLlama(jax_tiny(**_cfg_kw()))
    return {n: np.asarray(p._value) for n, p in jm.named_parameters()}


def _jax_run(axes, zero_axis, stage):
    """3 CompiledTrainStep steps over a JAX mesh of `axes` from the same
    weights: (losses, final named params, last grad_norm)."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu.parallel.train_step import CompiledTrainStep

    paddle.seed(SEED)
    mesh = build_mesh(axes)
    try:
        jm = JaxLlama(jax_tiny(**_cfg_kw()))
        opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters(),
                       weight_decay=0.01)
        step = CompiledTrainStep(jm, _fused_loss, optimizer=opt, mesh=mesh,
                                 zero_axis=zero_axis, zero_stage=stage,
                                 collect_metrics=True)
        batch = {k: v.astype(np.int32) for k, v in _batch().items()}
        losses = [float(step(batch)) for _ in range(3)]
        step.settle_metrics(block=True)
        gn = step.last_metrics()["grad_norm"]
        step.sync_params_to_model()
        named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    finally:
        set_mesh(None)
    return losses, named, gn


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hybrid_train"))
    with open(os.path.join(out, "named.pkl"), "wb") as fh:
        pickle.dump(_jax_named(), fh)
    spawn(_train_rank, (out,), nprocs=4, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


def _gathered(ranks, label, mp):
    """The full JAX-layout parameters from the mp ranks of data rank 0
    (mp is the mesh's innermost axis: ranks 0..mp-1)."""
    from paddle_tpu_torch.models import gather_paddle_tpu_params

    return gather_paddle_tpu_params([ranks[r][label]["params"]
                                     for r in range(mp)])


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_hybrid_steps_match_compiled_train_step_on_a_mesh(ranks, label):
    axes, zero_axis, stage = LAYOUTS[label]
    jl, jparams, jgn = _jax_run(axes, zero_axis, stage)
    for r in range(4):
        np.testing.assert_allclose(ranks[r][label]["losses"], jl, rtol=1e-5,
                                   atol=0, err_msg=f"rank {r}")
    assert jl[-1] < jl[0]
    mp = axes.get("mp", 1)
    full = _gathered(ranks, label, mp)
    assert set(full) == set(jparams)
    for name, want in jparams.items():
        np.testing.assert_allclose(full[name], want, rtol=0, atol=2e-5,
                                   err_msg=name)
    gn = ranks[0][label]["metrics"]["grad_norm"]
    np.testing.assert_allclose(gn, float(jgn), rtol=1e-5)
    assert ranks[0][label]["metrics"]["step"] == 3


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_replicas_hold_the_same_shards(ranks, label):
    """Ranks that differ off the mp axis (data and sharding replicas)
    hold bit-equal parameters; ranks along mp hold different shards of
    the split parameters and equal replicated ones."""
    axes = LAYOUTS[label][0]
    mp = axes.get("mp", 1)
    for r in range(4):
        twin = ranks[r % mp][label]["params"]
        for name, p in ranks[r][label]["params"].items():
            assert torch.equal(p, twin[name]), (r, name)
    if mp > 1:
        a, b = ranks[0][label]["params"], ranks[1][label]["params"]
        assert not torch.equal(a["llama.layers.0.self_attn.q_proj.weight"],
                               b["llama.layers.0.self_attn.q_proj.weight"])
        assert torch.equal(a["llama.norm.weight"], b["llama.norm.weight"])


def test_mesh_coordinates_follow_the_jax_device_order(ranks):
    """Rank r sits where device r sits in the JAX mesh of the same axes."""
    import jax
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh

    for label, (axes, _, _) in LAYOUTS.items():
        mesh = build_mesh(axes)
        try:
            devs = np.asarray(mesh.devices)
            for r in range(4):
                idx = np.argwhere(devs == jax.devices()[r])[0]
                want = dict(zip(mesh.axis_names, (int(i) for i in idx)))
                assert ranks[r][label]["coord"] == want, (label, r)
        finally:
            set_mesh(None)


@pytest.mark.parametrize("what", ["fp8", "serving", "lora"])
def test_what_is_not_ported_raises_naming_the_roadmap(ranks, what):
    for r in range(4):
        msg = ranks[r]["raised"].get(what)
        assert msg is not None and "ROADMAP A8" in msg, (r, what)


@pytest.mark.parametrize("what,match", [
    ("zero3_fp8", "fp8_policy cannot compose with the zero_stage=3"),
    ("pp_vpp_zero_axis", "not supported with interleaved virtual_pp")])
def test_what_zero3_refuses_as_jax_does(ranks, what, match):
    """fp8 under ZeRO-3 (JAX ``train_step.py:648-654``) and a zero axis
    under VPP (JAX ``pipeline.py:244-247``) raise ValueError."""
    for r in range(4):
        msg = ranks[r]["raised"].get(what)
        assert msg is not None and match in msg, (r, what, msg)


def test_mp1_model_is_todays_model():
    """Without tensor parallelism the LLaMA keeps its plain layers: the
    same parameter types, and a loss bit-equal to a model built before
    any mesh existed."""
    from torch import nn

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.models.llama import Projection

    cfg = llama_tiny_config(**_cfg_kw())
    m = LlamaForCausalLM(cfg, device="cpu", seed=3)
    assert type(m.lm_head) is nn.Linear
    assert type(m.llama.embed_tokens) is nn.Embedding
    assert type(m.llama.layers[0].self_attn.q_proj) is Projection
    assert m.mp_group is None and m.criterion.mp_group is None
    b = _batch()
    ids, lab = torch.from_numpy(b["input_ids"]), torch.from_numpy(b["labels"])
    loss = m(ids, labels=lab)
    loss2 = LlamaForCausalLM(cfg, device="cpu", seed=3)(ids, labels=lab)
    assert torch.equal(loss, loss2)


def test_backend_rule_never_changes_silently(monkeypatch):
    from paddle_tpu_torch.distributed import parallel

    cpu = torch.device("cpu")
    assert parallel._pick_backend(None, cpu, 4) == "gloo"
    assert parallel._pick_backend("gloo", cpu, 4) == "gloo"
    with pytest.raises(ValueError, match="needs CUDA ranks"):
        parallel._pick_backend("nccl", cpu, 4)
    # ranks sharing one card: nccl raises, the default too; gloo is asked
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("PADDLE_LOCAL_SIZE", "4")
    card = torch.device("cuda", 0)
    for backend in ("nccl", None):
        with pytest.raises(ValueError, match="backend='gloo'"):
            parallel._pick_backend(backend, card, 4)
    assert parallel._pick_backend("gloo", card, 4) == "gloo"
    monkeypatch.setenv("PADDLE_LOCAL_SIZE", "1")
    assert parallel._pick_backend(None, card, 1) == "nccl"
    with pytest.raises(ValueError, match="must be 'nccl' or 'gloo'"):
        parallel._pick_backend("mpi", cpu, 1)


def test_mp_logits_and_unfused_loss_match_the_jax_model(ranks):
    """At dp 2 x mp 2 the logits gathered over mp (``_c_concat``) equal the
    JAX model's, and the unfused vocab-parallel loss
    (``ParallelCrossEntropy`` on local logits) equals the fused one."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny

    paddle.seed(SEED)
    jm = JaxLlama(jax_tiny(**_cfg_kw()))
    b = _batch()
    want = np.asarray(jm(paddle.to_tensor(b["input_ids"]))._value)
    want_loss = float(jm(paddle.to_tensor(b["input_ids"]),
                         labels=paddle.to_tensor(b["labels"]))._value)
    for r in range(4):
        got = ranks[r]["logits"]
        assert got.shape == want.shape
        row = np.abs(want).max(-1, keepdims=True)
        assert (np.abs(got - want) <= 1e-5 * row + 1e-6).all()
        np.testing.assert_allclose(ranks[r]["loss_fused"], want_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(ranks[r]["loss_unfused"], want_loss,
                                   rtol=1e-5)

