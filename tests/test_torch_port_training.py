"""The port's training slice against the JAX package on the CPU.

* ``AdamW`` and ``Adam`` vs the JAX ``_update`` over 3 steps: a bf16
  parameter with an fp32 master, an fp32 one, and (AdamW) one excluded
  from the decay by ``apply_decay_param_fun``; fp32 rtol 1e-6;
* the gradient clips vs ``apply_optimizer_update``;
* ``LlamaPretrainingCriterion`` with ``use_parallel_cross_entropy`` True
  (mean over ALL tokens) and False (mean over the non-ignored ones), fused
  and unfused, vs the JAX model's loss on the same weights, fp32 1e-5;
* the whole slice: ``from_paddle_tpu_params`` plus the optimizer-state
  carry after one JAX ``CompiledTrainStep`` step, then 3 port
  ``TrainStep`` steps against 3 more JAX steps on the same tiny GQA LLaMA
  and the same packed dict batch (no grad clip: ``CompiledTrainStep``
  applies none); per-step losses fp32 rtol 1e-5, final parameters atol
  2e-5 (lr 1e-3: Adam divides each gradient by its own running scale, so
  gradients that differ in their last bits move a parameter by a small
  multiple of lr times that relative difference);
* the port's packer gives the JAX packer's batches.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.io.packing import pack_examples as jax_pack_examples
from paddle_tpu.io.packing import pad_examples as jax_pad_examples
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxGlobalNorm
from paddle_tpu.nn.clip import ClipGradByNorm as JaxNorm
from paddle_tpu.nn.clip import ClipGradByValue as JaxValue
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel.train_step import (CompiledTrainStep,
                                            apply_optimizer_update)
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.io import pack_examples, pad_examples, unpack_batch
from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                     llama_tiny_config,
                                     optimizer_state_from_paddle_tpu)
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel import TrainStep

LR = 1e-3


def _docs(seed, vocab, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).astype(np.int32) for n in lens]


@pytest.fixture
def fused_flag():
    yield
    set_flags({"use_fused_head_loss": True})
    jax_set_flags({"use_fused_head_loss": True})


@pytest.mark.parametrize("decoupled", [True, False], ids=["adamw", "adam"])
def test_adam_matches_jax_update_with_master_and_decay_exclusion(decoupled):
    rng = np.random.RandomState(0)
    shapes = [(6, 5), (7,), (3, 4)]
    dtypes = [torch.bfloat16, torch.float32, torch.float32]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(learning_rate=1e-2, weight_decay=0.1, multi_precision=True)
    if decoupled:
        kw["apply_decay_param_fun"] = lambda name: name != "p2"
    jax_cls, cls = (JaxAdamW, AdamW) if decoupled else (JaxAdam, Adam)

    jparams = [paddle.to_tensor(a.astype(jnp.bfloat16) if dt ==
                                torch.bfloat16 else a)
               for a, dt in zip(init, dtypes)]
    jopt = jax_cls(parameters=jparams, **kw)
    jvals = [p._value for p in jparams]
    jstates = [jopt._init_state(p) for p in jparams]
    params = [torch.nn.Parameter(torch.from_numpy(a).to(dt))
              for a, dt in zip(init, dtypes)]
    opt = cls(parameters=params, **kw)
    for t, gs in enumerate(grads, start=1):
        for i, (p, g) in enumerate(zip(jparams, gs)):
            extra = dict(decay=jopt._decay_flags[id(p)]) if decoupled else {}
            jvals[i], jstates[i] = jopt._update(
                jvals[i], jnp.asarray(g).astype(jvals[i].dtype), jstates[i],
                jnp.float32(1e-2), jnp.int32(t), **extra)
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step()
    for i, p in enumerate(params):
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(jvals[i], np.float32),
                                   rtol=1e-6, atol=1e-7)
        for k, v in jstates[i].items():
            np.testing.assert_allclose(opt._state[i][k].numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-7,
                                       err_msg=f"param {i} {k}")
    assert set(opt._state[0]) == {"m", "v", "master"}
    assert set(opt._state[1]) == {"m", "v"}
    if decoupled:     # the decay-excluded parameter took the plain step
        assert opt._decay == [True, True, False]
    # state_dict round trip into a fresh optimizer
    again = cls(parameters=[torch.nn.Parameter(p.detach().clone())
                            for p in params], **kw)
    again.set_state_dict(opt.state_dict())
    assert again._step_count == 3
    for i in range(3):
        for k, v in opt._state[i].items():
            assert torch.equal(again._state[i][k], v)


@pytest.mark.parametrize("clip", [
    ("global", 0.5), ("global", 1e3), ("norm", 0.7), ("value", 0.3),
], ids=["global", "global_unclipped", "norm", "value"])
def test_clips_match_apply_optimizer_update(clip):
    kind, c = clip
    rng = np.random.RandomState(1)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 3), (5,), (2, 2))]
    jclip, tclip = {"global": (JaxGlobalNorm, ClipGradByGlobalNorm),
                    "norm": (JaxNorm, ClipGradByNorm),
                    "value": (JaxValue, ClipGradByValue)}[kind]
    zeros = [paddle.to_tensor(np.zeros_like(g)) for g in grads]
    sgd = JaxSGD(learning_rate=1.0, parameters=zeros, grad_clip=jclip(c))
    new, _ = apply_optimizer_update(sgd, [p._value for p in zeros],
                                    [jnp.asarray(g) for g in grads],
                                    [{} for _ in grads], jnp.float32(1.0),
                                    jnp.int32(1))
    got = tclip(c)([(None, torch.from_numpy(g)) for g in grads])
    for (_, g), w in zip(got, new):
        np.testing.assert_allclose(g.numpy(), -np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def _pair(parallel, seed=0):
    paddle.seed(seed)
    kw = dict(num_key_value_heads=2, use_parallel_cross_entropy=parallel)
    jm = JaxLlama(jax_tiny_config(**kw))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(**kw), device="cpu")
    return jm, tm


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["parallel_ce", "mean_over_valid"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_criterion_reduction_matches_jax(parallel, fused, fused_flag):
    jm, tm = _pair(parallel)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 256, (2, 24)).astype(np.int64)
    labels = rng.randint(0, 256, (2, 24)).astype(np.int64)
    labels[:, ::3] = -100
    set_flags({"use_fused_head_loss": fused})
    jax_set_flags({"use_fused_head_loss": fused})
    want = float(jm(paddle.to_tensor(ids),
                    labels=paddle.to_tensor(labels))._value)
    with torch.no_grad():
        got = float(tm(torch.from_numpy(ids),
                       labels=torch.from_numpy(labels)))
        per_tok = tm.criterion.forward_fused(
            tm.llama(torch.from_numpy(ids)), tm.lm_head,
            torch.from_numpy(labels)) if parallel else None
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    valid = (labels != -100).sum()
    if parallel:
        # the mean runs over all 48 tokens, ignored ones counting as 0
        np.testing.assert_allclose(float(per_tok), got, rtol=1e-6)
    else:
        with torch.no_grad():
            tm2 = from_paddle_tpu_params(
                {n: np.asarray(p._value) for n, p in jm.named_parameters()},
                llama_tiny_config(num_key_value_heads=2), device="cpu")
            parallel_loss = float(tm2(torch.from_numpy(ids),
                                      labels=torch.from_numpy(labels)))
        np.testing.assert_allclose(parallel_loss * labels.size,
                                   got * valid, rtol=1e-5)


def _packed(seed):
    docs = _docs(seed, 256, [9, 30, 14, 5, 22, 17, 40, 11])
    return next(jax_pack_examples(docs, seq_len=64, batch_size=2))


def test_whole_slice_train_step_matches_compiled_train_step():
    paddle.seed(0)
    cfg_kw = dict(num_key_value_heads=2)
    jm = JaxLlama(jax_tiny_config(**cfg_kw))
    names = [n for n, _ in jm.named_parameters()]
    jopt = JaxAdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=0.01)
    jstep = CompiledTrainStep(jm, lambda out, lab: out, optimizer=jopt)
    first, batch = _packed(1), _packed(2)
    assert (batch["labels"] == -100).any() and batch["segment_ids"].max() > 1
    float(jstep(first))
    jstep.sync_params_to_model()
    jstep.sync_states_to_optimizer()

    # carry the weights and the optimizer state after step 1
    tm = from_paddle_tpu_params(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        llama_tiny_config(**cfg_kw), device="cpu")
    opt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                weight_decay=0.01)
    optimizer_state_from_paddle_tpu(jopt.state_dict(), names, tm, opt)
    assert opt._step_count == 1
    k_proj = names.index("llama.layers.0.self_attn.k_proj.weight")
    np.testing.assert_array_equal(
        opt._state[k_proj]["m"].numpy(),
        jopt.state_dict()[f"param_{k_proj}"]["m"].T)
    step = TrainStep(tm, lambda out, lab: out, opt, collect_metrics=True)

    jl = [float(jstep(batch)) for _ in range(3)]
    tl = [float(step(batch)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    jstep.sync_params_to_model()
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        want = np.asarray(jparams[name]._value)
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            want = want.T
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=2e-5, err_msg=name)
    m = step.last_metrics()
    assert m["step"] == 4 and opt._step_count == 4
    np.testing.assert_allclose(m["loss"], tl[-1], rtol=1e-6)
    assert m["grad_norm"] > 0


def test_train_step_tuple_batch_and_clip():
    cfg = llama_tiny_config(num_key_value_heads=2)
    from paddle_tpu_torch.models import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device="cpu", seed=4)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256, (2, 16))
    labels = rng.randint(0, 256, (2, 16))
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1e-3),
                apply_decay_param_fun=lambda n: not n.endswith("norm.weight"))
    assert opt._decay.count(False) == 2 * cfg.num_hidden_layers + 1
    step = TrainStep(model, lambda logits, lab: model.criterion(logits, lab),
                     opt, collect_metrics=True)
    before = [p.detach().clone() for p in model.parameters()]
    losses = [float(step(ids, labels)) for _ in range(2)]
    assert all(np.isfinite(losses))
    # a clipped step still moves every parameter that has a gradient
    moved = [not torch.equal(a, p) for a, p in zip(before,
                                                   model.parameters())]
    assert all(moved)
    assert step.last_metrics()["grad_norm"] > 1e-3
    with pytest.raises(ValueError, match="labels"):
        step({"input_ids": ids})


def test_train_step_follows_optimizer_state_loaded_after_it():
    """State loaded after the TrainStep is built, and a step taken outside
    it, set the step count (and so the bias correction) of later steps."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = llama_tiny_config(num_key_value_heads=2)
    rng = np.random.RandomState(6)
    ids = torch.from_numpy(rng.randint(0, 256, (2, 16)))
    labels = torch.from_numpy(rng.randint(0, 256, (2, 16)))

    def plain_step(model, opt):
        opt.clear_grad()
        model.criterion(model(ids), labels).backward()
        opt.step()

    src = LlamaForCausalLM(cfg, device="cpu", seed=6)
    src_opt = AdamW(learning_rate=LR, parameters=src.parameters())
    for _ in range(5):
        plain_step(src, src_opt)
    saved = src_opt.state_dict()

    model = LlamaForCausalLM(cfg, device="cpu", seed=7)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    step = TrainStep(model, lambda logits, lab: model.criterion(logits, lab),
                     opt, collect_metrics=True)
    opt.set_state_dict(saved)
    step(ids, labels)
    plain_step(model, opt)
    step(ids, labels)
    assert opt._step_count == 8 and step.last_metrics()["step"] == 8

    ref = LlamaForCausalLM(cfg, device="cpu", seed=7)
    ref_opt = AdamW(learning_rate=LR, parameters=ref.parameters())
    ref_opt.set_state_dict(saved)
    for _ in range(3):
        plain_step(ref, ref_opt)
    assert ref_opt._step_count == 8
    for (name, p), r in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, r), name

    alone = TrainStep(model, lambda logits, lab: model.criterion(logits, lab),
                      collect_metrics=True)
    alone(ids, labels)
    alone(ids, labels)
    assert alone.last_metrics()["step"] == 2 and opt._step_count == 8


def test_packer_matches_jax():
    docs = _docs(5, 100, [3, 17, 8, 40, 2, 9, 25, 31, 6])
    ours = list(pack_examples(docs, seq_len=32, batch_size=3))
    theirs = list(jax_pack_examples(docs, seq_len=32, batch_size=3))
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got = [d for batch in ours for d in unpack_batch(batch)]
    want = [c for d in docs for c in (d[i:i + 32] for i in range(0, len(d),
                                                                  32))]
    assert sorted(map(tuple, got)) == sorted(map(tuple, want))
    for a, b in zip(pad_examples(docs, 32, 4), jax_pad_examples(docs, 32, 4)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
