"""ZeRO-3 of the port (parameter sharding, the gather-ahead layer loop,
ZeRO inside a pipeline stage) on 4 gloo ranks (CPU) against the JAX
package.

The port runs a process per rank (``distributed.spawn``, one spawn for
the module); the JAX package runs the same steps as one SPMD program over
the 8 virtual CPU devices of ``tests/conftest.py``, on the same weights
(``models.convert``): the pipeline tests' tiny LLaMA (4 layers, hidden
64, 4 heads, vocab 128; batch 8 x 16), 3 AdamW steps each (lr 1e-3, wd
0.01, no clip):

* ``TrainStep(mesh=, zero_axis="sharding", zero_stage=3,
  zero3_gather=mode)`` against ``CompiledTrainStep(zero_stage=3,
  scan_layers=True, zero3_gather=mode)`` at sharding 4 ("ahead" and
  "start"), dp 2 x sharding 2 and mp 2 x sharding 2;
* ``PipelinedTrainStep(zero_axis="sharding")`` (1F1B) and
  ``ZBH1PipelinedStep(zero_axis="sharding")`` at pp 2 x sharding 2 (2
  microbatches) against the JAX steps of the same names.

Rules: per-step fp32 losses rtol 1e-5 (``tests/test_zero3_sharding.py``);
the gathered parameters within 2e-5 of the JAX run at each element (the
training tests' rule; measured on the CPU: at most 1.4e-6, 1.9e-6 at mp
2, 1.5e-6 for the pipelines); every sharding replica gathers the same
parameters; each rank's shards hold at most 1/N of its units' parameters plus the
padding (under N elements a bucket) and the parameters themselves hold
no data; at "ahead" at most 2
decoder layers plus the outer units are gathered at once, at "start" the
whole stack; after a step no full buffer is left, by the core's counter
and by weak references. The batches hold no ignored labels, so the data
ranks' mean loss is the global mean. Why this model and not the hybrid
tests' vocab-256 one at 4 layers: there the JAX package's own ZeRO-3 and
unsharded runs of the same step part by up to 5.2e-5 at single elements
(9.4e-5 at mp 2), and the port's unsharded single-rank run by 4.7e-5
from JAX, where Adam amplifies last-bit gradient differences of an
element whose gradient nearly cancels; the port's ZeRO-3 run there is
within 3.8e-7 of its ZeRO-1 run, and 3.05e-5 from JAX. On this model the
JAX runs agree within 2.9e-6.

JAX's refusals are the port's: the interior remat policies, an unknown
gather mode and fp8 under ZeRO-3 raise; a typo'd axis warns and leaves
ZeRO off; a zero axis under pp that is no data axis, or under VPP,
raises. The state-dict round trips of ``tests/test_zero3_sharding.py``
(227-305): 2 sharded steps resumed replicated, 2 replicated steps resumed
sharded, both within 1e-5 of JAX's 4 sharded steps, and a sharded resume
bit-equal to the uninterrupted run.

Spawned ranks import torch, numpy and the port only; the JAX references
are built in this process, while the ranks run.
"""
import gc
import os
import pickle
import threading
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

LR = 1e-3
SEED = 0
N_LAYERS = 4
N_BLOCKS = 4
SPAWN_TIMEOUT_S = 300
Z3_LAYOUTS = {"sharding4_ahead": ({"sharding": 4}, "ahead"),
              "sharding4_start": ({"sharding": 4}, "start"),
              "dp2_sharding2": ({"dp": 2, "sharding": 2}, "ahead"),
              "mp2_sharding2": ({"sharding": 2, "mp": 2}, "ahead")}
PIPE_LAYOUTS = {"pp2_sharding2_1f1b": "1F1B", "pp2_sharding2_zbh1": "ZBH1"}
PIPE_AXES = {"pp": 2, "sharding": 2}
OUTER_UNITS = 3            # the embedding, the final norm, the head


def _cfg_kw():
    return _pipe_kw()


def _batch():
    ids, labels = _pipe_batch()
    return {"input_ids": ids, "labels": labels}


def _pipe_kw():
    return dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=N_BLOCKS, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=32)


def _pipe_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (8, 16)).astype(np.int64)
    labels = rng.randint(0, 128, (8, 16)).astype(np.int64)
    return ids, labels


def _fused_loss(out, labels):
    return out


# ---------------------------------------------------------------------------
# the ranks (torch and the port only)
# ---------------------------------------------------------------------------

def _alive(sharder):
    gc.collect()
    return sharder.alive_buffers()


def _z3_step(named, axes, mode, **kw):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    fleet.reset()
    set_mesh(None)
    mesh = build_mesh(axes)
    model = from_paddle_tpu_params(named, llama_tiny_config(**_cfg_kw()),
                                   device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                     mesh=mesh, zero_axis="sharding", zero_stage=3,
                     zero3_gather=mode, **kw)
    return mesh, model, step


def _z3_case(named, axes, mode):
    mesh, model, step = _z3_step(named, axes, mode)
    sh = step._zero3
    batch = _batch()
    losses, peaks = [], []
    for _ in range(3):
        sh.reset_peak()
        losses.append(float(step(batch)))
        peaks.append(sh.peak_units)
    return {"coord": mesh.coord(), "losses": losses,
            "grad_norm": step.last_metrics()["grad_norm"],
            "peaks": peaks, "live": sh.live_units, "alive": _alive(sh),
            "loop_units": len(sh.loop_units),
            "held_units": len(sh.held_units),
            "resident": sh.resident_bytes(), "full": sh.full_bytes(),
            "buckets": sum(len(u.buckets) for u in sh.units),
            "param_storage": sum(p.untyped_storage().nbytes()
                                 for p in model.parameters()),
            "params": step.model.state_dict()}


def _plain_step(named):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import set_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    fleet.reset()
    set_mesh(None)
    model = from_paddle_tpu_params(named, llama_tiny_config(**_cfg_kw()),
                                   device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01)
    return model, opt, TrainStep(model, _fused_loss, opt)


def _round_trips(named):
    """The state-dict round trips at sharding 4, 'ahead'."""
    batch = _batch()
    axes = {"sharding": 4}
    _, _, straight = _z3_step(named, axes, "ahead")
    out = {"straight": [float(straight(batch)) for _ in range(4)]}
    # sharded -> replicated
    _, _, st = _z3_step(named, axes, "ahead")
    first = [float(st(batch)) for _ in range(2)]
    sd, osd = st.model.state_dict(), st.optimizer.state_dict()
    model, opt, plain = _plain_step(named)
    model.load_state_dict(sd)
    opt.set_state_dict(osd)
    out["s2r"] = first + [float(plain(batch)) for _ in range(2)]
    # sharded -> sharded (the resume)
    _, _, st2 = _z3_step(named, axes, "ahead")
    st2.model.set_state_dict(sd)
    st2.optimizer.set_state_dict(osd)
    out["resume"] = first + [float(st2(batch)) for _ in range(2)]
    # replicated -> sharded
    model, opt, plain = _plain_step(named)
    first = [float(plain(batch)) for _ in range(2)]
    sd = {n: p.detach().clone() for n, p in model.named_parameters()}
    osd = opt.state_dict()
    _, _, st3 = _z3_step(named, axes, "ahead")
    st3.model.set_state_dict(sd)
    st3.optimizer.set_state_dict(osd)
    out["r2s"] = first + [float(st3(batch)) for _ in range(2)]
    return out


def _refusals(named):
    """What raises or warns under ZeRO-3 ({name: message})."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    out = {}
    for name, kw in (("remat_save_dots", {"remat": "save_dots"}),
                     ("remat_offload", {"remat": "offload_residuals"}),
                     ("gather_mode", {"zero3_gather": "sometimes"}),
                     ("fp8", {"fp8_policy": "matmuls"})):
        try:
            _z3_step(named, {"sharding": 4}, kw.pop("zero3_gather", None),
                     **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    fleet.reset()
    set_mesh(None)
    mesh = build_mesh({"sharding": 4})
    model = from_paddle_tpu_params(named, llama_tiny_config(**_cfg_kw()),
                                   device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        step = TrainStep(model, _fused_loss, opt, mesh=mesh,
                         zero_axis="shard", zero_stage=3)
    out["typo_axis"] = ([str(x.message) for x in w], step._zero3 is None,
                        min(p.numel() for p in model.parameters()) > 0)
    return out


def _pipe_modules(named, hcg):
    from paddle_tpu_torch.models import llama_tiny_config
    from paddle_tpu_torch.models.convert import (load_pipeline_params,
                                                 pipeline_stage_params)
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               LlamaEmbeddingStage,
                                               LlamaHeadStage)
    from paddle_tpu_torch.parallel.pipeline import stage_block_indices

    cfg = llama_tiny_config(**_pipe_kw())
    S, s = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
    mods = {}
    if s == 0:
        mods[0] = LlamaEmbeddingStage(cfg)
    idx = stage_block_indices(N_BLOCKS, S, s)
    for i in idx:
        mods[i + 1] = LlamaDecoderLayer(cfg)
    if s == S - 1:
        mods[N_BLOCKS + 1] = LlamaHeadStage(cfg)
    load_pipeline_params(mods, pipeline_stage_params(
        named, N_BLOCKS, list(mods), 0, 1))
    return cfg, mods, idx


def _pipe_case(named, kind):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.pipeline import (PipelinedTrainStep,
                                                    pipeline_hcg)
    from paddle_tpu_torch.parallel.zero_bubble import ZBH1PipelinedStep

    fleet.reset()
    set_mesh(None)
    mesh = build_mesh(PIPE_AXES)
    hcg, _ = pipeline_hcg(mesh)
    cfg, mods, idx = _pipe_modules(named, hcg)
    params = [p for m in mods.values() for p in m.parameters()]
    opt = AdamW(learning_rate=LR, parameters=params, weight_decay=0.01)
    cls = PipelinedTrainStep if kind == "1F1B" else ZBH1PipelinedStep
    step = cls(mods.get(0), [mods[i + 1] for i in idx],
               mods.get(N_BLOCKS + 1), LlamaPretrainingCriterion(cfg),
               optimizer=opt, mesh=mesh, num_micro=2, zero_axis="sharding")
    sh = step.sharder
    ids, labels = _pipe_batch()
    losses, peaks = [], []
    for _ in range(3):
        sh.reset_peak()
        losses.append(float(step(ids, labels)))
        peaks.append(sh.peak_units)
    share = {f"{k}.{n}": p.detach().clone() for k, m in mods.items()
             if k == 0 or k == N_BLOCKS + 1 for n, p in m.named_parameters()}
    full = sh.full_state()
    for j, i in enumerate(idx):
        pre = f"block{j}."
        share.update({f"{i + 1}.{n[len(pre):]}": v for n, v in full.items()
                      if n.startswith(pre)})
    return {"coord": mesh.coord(), "losses": losses, "peaks": peaks,
            "live": sh.live_units, "alive": _alive(sh),
            "resident": sh.resident_bytes(), "full": sh.full_bytes(),
            "buckets": sum(len(u.buckets) for u in sh.units),
            "block_storage": sum(p.untyped_storage().nbytes()
                                 for i in idx
                                 for p in mods[i + 1].parameters()),
            "params": share}


def _pipe_refusals(named):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.parallel.pipeline import (PipelinedTrainStep,
                                                    pipeline_hcg)

    out = {}
    for name, axes, kw in (
            ("pp_mp_zero_axis", {"pp": 2, "mp": 2}, {"zero_axis": "mp"}),
            ("pp_vpp_zero_axis", {"pp": 2, "sharding": 2},
             {"zero_axis": "sharding", "virtual_pp": 2}),
            ("pp_remat_save_dots", {"pp": 2, "sharding": 2},
             {"zero_axis": "sharding", "remat": "save_dots"})):
        fleet.reset()
        set_mesh(None)
        try:
            PipelinedTrainStep(None, [], None, _fused_loss,
                               mesh=build_mesh(axes), **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    fleet.reset()
    set_mesh(None)
    mesh = build_mesh(PIPE_AXES)
    hcg, _ = pipeline_hcg(mesh)
    cfg, mods, idx = _pipe_modules(named, hcg)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        step = PipelinedTrainStep(
            mods.get(0), [mods[i + 1] for i in idx], mods.get(N_BLOCKS + 1),
            LlamaPretrainingCriterion(cfg), mesh=mesh, num_micro=2,
            zero_axis="shard")
    out["pp_typo_axis"] = ([str(x.message) for x in w],
                           step.sharder is None)
    return out


def _rank_main(out_dir):
    """One rank: every case; writes rank<r>.pkl."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env()
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    named, named_pipe = inputs["named"], inputs["named_pipe"]
    out = {}
    for label, (axes, mode) in Z3_LAYOUTS.items():
        out[label] = _z3_case(named, axes, mode)
    for label, kind in PIPE_LAYOUTS.items():
        out[label] = _pipe_case(named_pipe, kind)
    out["round_trips"] = _round_trips(named)
    out["refusals"] = _refusals(named)
    out["pipe_refusals"] = _pipe_refusals(named_pipe)
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX references (this process)
# ---------------------------------------------------------------------------

def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny

    paddle.seed(SEED)
    return JaxLlama(jax_tiny(**_cfg_kw()))


def _jax_z3(axes, mode, n_steps=3):
    """CompiledTrainStep(zero_stage=3, scan_layers=True) over a JAX mesh of
    `axes`: (losses, named params after 3 steps, last grad_norm)."""
    import paddle_tpu.models.llama as jl
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu.parallel.train_step import CompiledTrainStep

    jl._shared_rope_tables.cache_clear()
    mesh = build_mesh(axes)
    try:
        jm = _jax_model()
        opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters(),
                       weight_decay=0.01)
        step = CompiledTrainStep(jm, _fused_loss, optimizer=opt, mesh=mesh,
                                 zero_axis="sharding", zero_stage=3,
                                 scan_layers=True, zero3_gather=mode,
                                 collect_metrics=True)
        assert step._zero3_scan_info is not None
        batch = {k: v.astype(np.int32) for k, v in _batch().items()}
        losses = [float(step(batch)) for _ in range(3)]
        step.settle_metrics(block=True)
        gn = step.last_metrics()["grad_norm"]
        step.sync_params_to_model()
        named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
        losses += [float(step(batch)) for _ in range(n_steps - 3)]
    finally:
        set_mesh(None)
    return losses, named, gn


def _jax_pipe_modules():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import (LlamaDecoderLayer,
                                         LlamaPretrainingCriterion,
                                         _EmbeddingStage, _HeadStage,
                                         llama_tiny_config)

    paddle.seed(0)
    cfg = llama_tiny_config(**_pipe_kw())
    embed = _EmbeddingStage(cfg)
    blocks = [LlamaDecoderLayer(cfg) for _ in range(N_BLOCKS)]
    head = _HeadStage(cfg)
    for m in [embed, head] + blocks:
        m.eval()
    return embed, blocks, head, LlamaPretrainingCriterion(cfg)


def _jax_pipe_named(embed, blocks, head):
    out = {"llama.embed_tokens.weight":
           np.asarray(embed.embed_tokens.weight._value)}
    for i, b in enumerate(blocks):
        for n, p in b.named_parameters():
            out[f"llama.layers.{i}.{n}"] = np.asarray(p._value)
    out["llama.norm.weight"] = np.asarray(head.norm.weight._value)
    out["lm_head.weight"] = np.asarray(head.lm_head.weight._value)
    return out


def _jax_pipe(kind):
    """3 JAX steps of `kind` at pp 2 x sharding 2 with
    ``zero_axis="sharding"``: (losses, params)."""
    import paddle_tpu as paddle
    import paddle_tpu.models.llama as jl
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.parallel.pipeline import PipelinedTrainStep
    from paddle_tpu.parallel.zero_bubble import ZBH1PipelinedStep

    jl._shared_rope_tables.cache_clear()
    mesh = build_mesh(PIPE_AXES)
    try:
        embed, blocks, head, crit = _jax_pipe_modules()
        params = (embed.parameters()
                  + [p for b in blocks for p in b.parameters()]
                  + head.parameters())
        opt = paddle.optimizer.AdamW(learning_rate=LR, parameters=params,
                                     weight_decay=0.01)
        if kind == "1F1B":
            step = PipelinedTrainStep(embed, blocks, head,
                                      lambda lg, lb: crit(lg, lb),
                                      optimizer=opt, mesh=mesh, num_micro=2,
                                      zero_axis="sharding")
        else:
            step = ZBH1PipelinedStep(embed, blocks, head,
                                     lambda lg, lb: crit(lg, lb), mesh=mesh,
                                     num_micro=2, optimizer=opt,
                                     zero_axis="sharding")
        assert step.zero_axis == "sharding"
        ids, labels = _pipe_batch()
        losses = [float(step(ids, labels)) for _ in range(3)]
        step.sync_params_to_model()
        return losses, _jax_pipe_named(embed, blocks, head)
    finally:
        set_mesh(None)


_JAX = {}


def _jax(key, fn, *args):
    if key not in _JAX:
        _JAX[key] = fn(*args)
    return _JAX[key]


def _jax_runs():
    """Every JAX run the checks read (each computed once a module run)."""
    for label, (axes, mode) in Z3_LAYOUTS.items():
        _jax(label, _jax_z3, axes, mode,
             4 if label == "sharding4_ahead" else 3)
    for label, kind in PIPE_LAYOUTS.items():
        _jax(label, _jax_pipe, kind)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("zero3"))
    named = {n: np.asarray(p._value)
             for n, p in _jax_model().named_parameters()}
    with open(os.path.join(out, "inputs.pkl"), "wb") as fh:
        pickle.dump({"named": named, "named_pipe": _jax_pipe_named(
            *_jax_pipe_modules()[:3])}, fh)
    err = []

    def run():
        try:
            spawn(_rank_main, (out,), nprocs=4, timeout=SPAWN_TIMEOUT_S)
        except BaseException as e:  # re-raised below
            err.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        _jax_runs()
    finally:
        thread.join()
    if err:
        raise err[0]
    res = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _mp_gathered(ranks, label):
    """The full JAX-layout parameters: the mp ranks of sharding rank 0
    (mp is the innermost axis)."""
    from paddle_tpu_torch.models import gather_paddle_tpu_params

    res = sorted((r[label] for r in ranks
                  if r[label]["coord"].get("sharding", 0) == 0
                  and r[label]["coord"].get("dp", 0) == 0),
                 key=lambda r: r["coord"].get("mp", 0))
    return gather_paddle_tpu_params([r["params"] for r in res])


@pytest.mark.parametrize("label", list(Z3_LAYOUTS))
def test_zero3_steps_match_compiled_train_step(ranks, label):
    jl, jparams, jgn = _jax(label, _jax_z3, *Z3_LAYOUTS[label])
    for r in range(4):
        np.testing.assert_allclose(ranks[r][label]["losses"], jl[:3],
                                   rtol=1e-5, atol=0, err_msg=f"rank {r}")
    assert jl[2] < jl[0]
    full = _mp_gathered(ranks, label)
    assert set(full) == set(jparams)
    for name, want in jparams.items():
        np.testing.assert_allclose(full[name], want, rtol=0, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(ranks[0][label]["grad_norm"], float(jgn),
                               rtol=1e-5)


@pytest.mark.parametrize("label", list(Z3_LAYOUTS) + list(PIPE_LAYOUTS))
def test_sharding_replicas_gather_the_same_parameters(ranks, label):
    """Ranks that differ only along the sharding (and dp) axes gather
    bit-equal parameters."""
    for r in ranks:
        twin = next(q for q in ranks if q[label]["coord"] == dict(
            r[label]["coord"], sharding=0,
            **({"dp": 0} if "dp" in r[label]["coord"] else {})))
        for name, p in r[label]["params"].items():
            assert torch.equal(p, twin[label]["params"][name]), name


@pytest.mark.parametrize("label", list(Z3_LAYOUTS) + list(PIPE_LAYOUTS))
def test_each_rank_persists_one_nth_of_its_units(ranks, label):
    n = (Z3_LAYOUTS[label][0] if label in Z3_LAYOUTS
         else PIPE_AXES)["sharding"]
    for r in ranks:
        res = r[label]
        itemsize = 4
        pad = res["buckets"] * n * itemsize
        assert res["resident"] * n <= res["full"] + pad, (res["resident"],
                                                          res["full"])
        assert res["resident"] * n >= res["full"]
        storage = res.get("param_storage", res.get("block_storage"))
        assert storage == 0
        assert res["live"] == 0 and res["alive"] == 0


@pytest.mark.parametrize("label", list(Z3_LAYOUTS))
def test_live_units_ahead_at_most_two_layers(ranks, label):
    mode = Z3_LAYOUTS[label][1]
    for r in ranks:
        res = r[label]
        assert res["held_units"] == OUTER_UNITS
        assert res["loop_units"] == N_LAYERS
        for peak in res["peaks"]:
            if mode == "ahead":
                assert peak <= 2 + OUTER_UNITS
                assert peak == 2 + OUTER_UNITS
            else:
                assert peak == N_LAYERS + OUTER_UNITS


def test_ahead_and_start_give_equal_losses(ranks):
    for r in ranks:
        assert r["sharding4_ahead"]["losses"] == \
            r["sharding4_start"]["losses"]


@pytest.mark.parametrize("label", list(PIPE_LAYOUTS))
def test_zero_inside_a_pipeline_stage_matches_jax(ranks, label):
    from paddle_tpu_torch.models.convert import gather_pipeline_params

    jl, jparams = _jax(label, _jax_pipe, PIPE_LAYOUTS[label])
    for r in ranks:
        np.testing.assert_allclose(r[label]["losses"], jl, rtol=1e-5,
                                   atol=0)
    assert jl[2] < jl[0]
    stages = [next(r[label]["params"] for r in ranks
                   if r[label]["coord"] == {"pp": s, "sharding": 0})
              for s in range(2)]
    full = gather_pipeline_params(stages, N_BLOCKS)
    assert set(full) == set(jparams)
    for name, want in jparams.items():
        np.testing.assert_allclose(full[name], want, rtol=0, atol=2e-5,
                                   err_msg=name)
    # each stage holds 2 blocks: the block loop never has more gathered
    for r in ranks:
        assert max(r[label]["peaks"]) <= 2


@pytest.mark.parametrize("what,match", [
    ("remat_save_dots", "sharded stack"),
    ("remat_offload", "sharded stack"),
    ("gather_mode", "zero3 gather mode"),
    ("fp8", "fp8_policy cannot compose with the zero_stage=3")])
def test_zero3_refusals_raise(ranks, what, match):
    for r in ranks:
        msg = r["refusals"][what]
        assert msg is not None and match in msg, (what, msg)


def test_typo_axis_warns_and_leaves_zero_off(ranks):
    for r in ranks:
        msgs, off, full = r["refusals"]["typo_axis"]
        assert any("not a mesh axis" in m for m in msgs), msgs
        assert off and full
        msgs, off = r["pipe_refusals"]["pp_typo_axis"]
        assert any("not a mesh axis" in m for m in msgs), msgs
        assert off


@pytest.mark.parametrize("what,match", [
    ("pp_mp_zero_axis", "data axis"),
    ("pp_vpp_zero_axis", "not supported with interleaved virtual_pp"),
    ("pp_remat_save_dots", "sharded stack")])
def test_zero_axis_under_pp_refusals(ranks, what, match):
    for r in ranks:
        msg = r["pipe_refusals"][what]
        assert msg is not None and match in msg, (what, msg)


def test_jax_refuses_a_non_data_zero_axis_under_pp():
    """The JAX guard the port's ``pp_mp_zero_axis`` case copies."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.models.llama import (LlamaDecoderLayer,
                                         LlamaPretrainingCriterion,
                                         _EmbeddingStage, _HeadStage,
                                         llama_tiny_config)
    from paddle_tpu.parallel.pipeline import PipelinedTrainStep

    cfg = llama_tiny_config(vocab_size=64, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2,
                            max_position_embeddings=16)
    mesh = build_mesh({"pp": 2, "mp": 2})
    try:
        paddle.seed(0)
        crit = LlamaPretrainingCriterion(cfg)
        with pytest.raises(ValueError, match="data axis"):
            PipelinedTrainStep(_EmbeddingStage(cfg),
                               [LlamaDecoderLayer(cfg) for _ in range(2)],
                               _HeadStage(cfg), lambda lg, lb: crit(lg, lb),
                               mesh=mesh, num_micro=2, zero_axis="mp")
    finally:
        set_mesh(None)


@pytest.mark.parametrize("trip", ["s2r", "r2s"])
def test_state_dict_round_trip_matches_jax(ranks, trip):
    jl = _jax("sharding4_ahead", _jax_z3, {"sharding": 4}, "ahead", 4)[0]
    assert len(jl) == 4
    for r in ranks:
        np.testing.assert_allclose(r["round_trips"][trip], jl, rtol=1e-5,
                                   atol=0)


def test_sharded_resume_is_bit_equal(ranks):
    for r in ranks:
        rt = r["round_trips"]
        assert rt["resume"] == rt["straight"], (rt["resume"],
                                                rt["straight"])

