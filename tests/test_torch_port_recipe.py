"""The training recipe of the slice as a whole, against the JAX package on
the CPU: a tiny GQA LLaMA, AdamW under ``LinearWarmup(CosineAnnealingDecay)``,
``remat="save_dots"``, ``fp8_policy="matmuls+head"`` (delayed scaling for
the projections, the fused head through fp8 with current scaling), packed
batches through a ``DeviceFeeder``.

* 3 port ``TrainStep`` steps against 3 steps of JAX's ``CompiledTrainStep``
  with the same options and weights: losses within 1e-3 relative (fp8
  rounding may flip a code where the fp32 sums of the two packages differ
  in order; the observed worst is asserted below 1e-5), the lr each step
  equal, ``fp8_state_dict`` histories within 1e-5 relative (same layout,
  one plain callsite per projection), ``skipped`` 0 and ``fp8_amax_max``
  equal to JAX's;
* the fp8 converter: JAX's state after 2 steps with ``scan_layers=True``
  (a scanned group's stacked ``[L, H]`` histories) carried into a port
  step with the weights, the optimizer and the scheduler state: the next
  step's loss and histories equal JAX's next step's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.io.packing import pack_examples as jax_pack_examples
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel.train_step import CompiledTrainStep
from paddle_tpu_torch.io import DeviceFeeder
from paddle_tpu_torch.models import (fp8_state_from_paddle_tpu,
                                     from_paddle_tpu_params,
                                     llama_tiny_config,
                                     optimizer_state_from_paddle_tpu)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import TrainStep

CFG = dict(num_key_value_heads=2, num_hidden_layers=2)


def _sched(lr_mod):
    return lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(2e-3, T_max=8, eta_min=1e-4),
        warmup_steps=2, start_lr=1e-4, end_lr=2e-3)


def _packed(seed):
    rng = np.random.RandomState(seed)
    docs = [rng.randint(1, 256, n).astype(np.int32)
            for n in [9, 30, 14, 5, 22, 17, 40, 11]]
    return next(jax_pack_examples(docs, seq_len=64, batch_size=2))


def _models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(**CFG))
    tm = from_paddle_tpu_params(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        llama_tiny_config(**CFG), device="cpu")
    return jm, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_recipe_matches_compiled_train_step():
    jm, tm = _models()
    jopt = JaxAdamW(learning_rate=_sched(jlr), parameters=jm.parameters(),
                    weight_decay=0.01)
    opt = AdamW(learning_rate=_sched(tlr), parameters=tm.parameters(),
                weight_decay=0.01)
    kw = dict(remat="save_dots", fp8_policy="matmuls+head",
              collect_metrics=True)
    jstep = CompiledTrainStep(jm, lambda out, lab: out, optimizer=jopt,
                              **kw)
    step = TrainStep(tm, lambda out, lab: out, opt, **kw)
    batches = [_packed(s) for s in (1, 2, 3)]
    jl, jlr_seq, jmet = [], [], []
    for b in batches:
        jlr_seq.append(jopt.get_lr())
        jl.append(float(jstep(b)))
        jstep.settle_metrics(block=True)
        jmet.append(jstep.last_metrics())
        jopt._lr.step()
    tl, tlr_seq, tmet = [], [], []
    with DeviceFeeder(iter(batches), device="cpu", depth=2) as feeder:
        for b in feeder:
            tlr_seq.append(opt.get_lr())
            tl.append(float(step(b)))
            tmet.append(step.last_metrics())
            opt._lr.step()
    assert tlr_seq == jlr_seq and len(set(tlr_seq)) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=0)
    # observed: the losses agree to float32 rounding on the CPU
    assert _rel(tl, jl) < 1e-5, _rel(tl, jl)
    assert tl[-1] < tl[0]
    for t, j in zip(tmet, jmet):
        assert t["step"] == j["step"] and t["skipped"] == j["skipped"] == 0
        np.testing.assert_allclose(t["fp8_amax_max"], j["fp8_amax_max"],
                                   rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=1e-3)
    jsd, tsd = jstep.fp8_state_dict(), step.fp8_state_dict()
    assert [tuple(e) for e in jsd["layout"]] == tsd["layout"]
    assert len(tsd["states"]) == 7 * CFG["num_hidden_layers"]
    for i, (t, j) in enumerate(zip(tsd["states"], jsd["states"])):
        for k in ("x", "w", "g"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=0,
                                       err_msg=f"callsite {i} {k}")
            assert (t[k][:3] > 0).all()         # three steps observed


def test_fp8_state_converter_from_scanned_compiled_train_step():
    jm, _ = _models()
    names = [n for n, _ in jm.named_parameters()]
    jopt = JaxAdamW(learning_rate=_sched(jlr), parameters=jm.parameters())
    jstep = CompiledTrainStep(jm, lambda out, lab: out, optimizer=jopt,
                              fp8_policy="matmuls", scan_layers=True)
    for s in (1, 2):
        float(jstep(_packed(s)))
        jopt._lr.step()
    snap = jstep.fp8_state_dict()
    assert snap["layout"][0][0] == "scan"       # a stacked [L, H] group
    jstep.sync_params_to_model()
    jstep.sync_states_to_optimizer()
    tm = from_paddle_tpu_params(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        llama_tiny_config(**CFG), device="cpu")
    opt = AdamW(learning_rate=_sched(tlr), parameters=tm.parameters())
    optimizer_state_from_paddle_tpu(jopt.state_dict(), names, tm, opt)
    assert opt.get_lr() == jopt.get_lr() and opt._step_count == 2
    step = TrainStep(tm, lambda out, lab: out, opt, fp8_policy="matmuls")
    step.load_fp8_state(fp8_state_from_paddle_tpu(snap))
    batch = _packed(3)
    jl = float(jstep(batch))
    tl = float(step(batch))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = fp8_state_from_paddle_tpu(jstep.fp8_state_dict())
    got = step.fp8_state_dict()
    assert got["layout"] == want["layout"]
    for t, j in zip(got["states"], want["states"]):
        for k in ("x", "w", "g"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="plain"):
        step.load_fp8_state(snap)
