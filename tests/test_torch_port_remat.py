"""The port's per-layer remat policies (``parallel.scan_layers``) on the
CPU.

* Every policy (``full``, ``save_nothing``, ``save_dots``,
  ``offload_residuals``) and ``scan_layers=True`` gives the loss and
  gradients of ``none`` on a tiny packed-batch LLaMA (GQA, segment ids),
  bit for bit on the CPU (the recompute runs the same ops), also under an
  fp8 session (the recompute meets the same amax states) and under O2
  bf16;
* the same when the backward, and so the recompute, runs on another
  thread (autograd runs a CUDA backward on its device thread, where the
  thread-local AMP state and fp8 session are not installed);
* 2 ``TrainStep`` steps under each policy equal 2 steps of JAX's
  ``CompiledTrainStep(remat=policy)`` on the same weights: losses fp32
  rtol 1e-5, parameters atol 2e-5;
* the selective policy saves the projections' matmul outputs only; an
  interior policy, an unknown gather mode and fp8 delayed scaling under
  the ZeRO-3 layer loop, the anomaly detector and remat on a model that
  cannot scope it per layer raise.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.io.packing import pack_examples as jax_pack_examples
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel.train_step import CompiledTrainStep
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.amp import fp8
from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                     gpt_moe_tiny_config,
                                     llama_tiny_config)
from paddle_tpu_torch.models.gpt_moe import GptMoeForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.parallel import scan_layers as sl

POLICIES = ["full", "save_nothing", "save_dots", "offload_residuals"]
CFG = dict(num_key_value_heads=2, num_hidden_layers=3)


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


def _backward(loss, thread):
    if not thread:
        loss.backward()
        return
    err = []

    def run():
        try:
            loss.backward()
        except BaseException as e:          # re-raised on this thread
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    if err:
        raise err[0]


def _loss_and_grads(tm, batch, policy, ctx=None, thread=False):
    tm.zero_grad(set_to_none=True)
    kw = {k: torch.from_numpy(v) for k, v in batch.items()}
    with sl.layer_execution(policy):
        if ctx is not None:
            with ctx():
                loss = tm(**kw)
                _backward(loss, thread)
        else:
            loss = tm(**kw)
            _backward(loss, thread)
    return loss.detach(), [p.grad.clone() for p in tm.parameters()]


@pytest.mark.parametrize("thread", [False, True],
                         ids=["same_thread", "backward_thread"])
@pytest.mark.parametrize("mode", ["fp32", "fp8", "o2_bf16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_equals_none(policy, mode, thread):
    _, tm = _models()
    batch = _packed(1)
    if mode == "o2_bf16":
        for p in tm.parameters():
            p.data = p.data.bfloat16()

    def ctx():
        if mode == "fp8":
            return fp8.fp8_execution("matmuls", states=[], record=True)
        if mode == "o2_bf16":
            return auto_cast(level="O2")
        return fp8.fp8_execution("none")

    l0, g0 = _loss_and_grads(tm, batch, "none", ctx)
    l1, g1 = _loss_and_grads(tm, batch, policy, ctx, thread)
    assert torch.equal(l1, l0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_save_dots_keeps_the_projection_products_only():
    saved = []
    orig = sl._save_dots

    def spy(ctx, op, *args, **kwargs):
        out = orig(ctx, op, *args, **kwargs)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                and not ctx.is_recompute:
            saved.append(op)
        return out

    _, tm = _models()
    sl._save_dots = spy
    try:
        _loss_and_grads(tm, _packed(1), "save_dots")
    finally:
        sl._save_dots = orig
    # 7 projections a layer, 3 layers: every saved output an unbatched mm
    assert len(saved) == 21
    assert set(saved) <= {torch.ops.aten.mm.default,
                          torch.ops.aten.addmm.default}


@pytest.mark.parametrize("policy", ["none"] + POLICIES + ["scan_layers"])
def test_train_steps_match_compiled_train_step(policy):
    jm, tm = _models()
    scan = policy == "scan_layers"
    remat = "none" if scan else policy
    jopt = JaxAdamW(learning_rate=1e-3, parameters=jm.parameters())
    jstep = CompiledTrainStep(jm, lambda out, lab: out, optimizer=jopt,
                              remat=remat, scan_layers=scan)
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    step = TrainStep(tm, lambda out, lab: out, opt, remat=remat,
                     scan_layers=scan)
    assert step.remat_policy == remat and step.scan_layers == scan
    batches = [_packed(2), _packed(3)]
    jl = [float(jstep(b)) for b in batches]
    tl = [float(step(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    jstep.sync_params_to_model()
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        want = np.asarray(jp[name]._value)
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            want = want.T
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=2e-5, err_msg=name)


def test_unported_paths_raise():
    assert sl.normalize_remat(True) == "full"
    assert sl.normalize_remat(None) == "none"
    with pytest.raises(ValueError):
        sl.normalize_remat("save_everything")
    # the ZeRO-3 loop recomputes each layer itself ('full' grade)
    with pytest.raises(ValueError, match="sharded stack"):
        with sl.layer_execution("save_dots",
                                shard_info=sl.ScanShardInfo(None)):
            pass
    with pytest.raises(ValueError, match="zero3 gather mode"):
        sl.ScanShardInfo(None, "sometimes")
    # fp8 delayed scaling under the ZeRO-3 loop (JAX's backstop)
    from paddle_tpu_torch.amp import fp8

    with fp8.fp8_execution("matmuls", states=[], hist_len=4, record=True):
        with pytest.raises(ValueError, match="delayed scaling"):
            sl.zero3_layer_loop([], torch.zeros(1), shard_info=None)
    _, tm = _models()
    # the anomaly detector is ported now: the step takes a flag-built one
    assert TrainStep(tm, lambda o, l: o,
                     anomaly_detector=True).anomaly_detector is not None
    moe = GptMoeForCausalLM(gpt_moe_tiny_config(), device="cpu")
    with pytest.raises(ValueError, match="layer_remat_capable"):
        TrainStep(moe, lambda o, l: o, remat="full")
    assert tm.layer_remat_capable and len(tm.scan_group()) == 3
