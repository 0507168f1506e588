"""The port's parallelism auto-tuner (``distributed.auto_tuner``) against
the JAX package's on the CPU.

``candidate_configs(n)`` for n = 1..8 and ``prune_candidates`` give
JAX's candidates in JAX's order; ``AutoTuner.search`` with a
deterministic trial (some candidates raising) leaves JAX's history and
picks JAX's best. ``compiled_trial_fn`` on 4 gloo ranks times real steps
of the tiny LLaMA inside the live world: ``search`` over the first
three candidates (dp 4, dp 2 x sharding 2, sharding 4: ``TrainStep``)
leaves the same history, times and best on every rank, puts the previous
mesh back, and a second search makes no new process group (the
candidates' meshes are kept); a 1F1B pipeline (pp 2 x dp 2) and a ZB-H1
(pp 4) candidate time their schedules; a trial whose model raises on
rank 3 alone fails on every rank, naming rank 3, within a bounded wait,
and the next trial runs."""
import os
import pickle
import time

import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

SPAWN_TIMEOUT_S = 240
FAIL_WAIT_S = 30


def _fields(c):
    return (c.dp, c.mp, c.pp, c.sharding, c.micro_batches, c.schedule_mode,
            c.time_s, c.error)


@pytest.mark.parametrize("n", list(range(1, 9)))
def test_candidates_equal_jax(n):
    from paddle_tpu.distributed.auto_tuner import tuner as jt

    from paddle_tpu_torch.distributed.auto_tuner import tuner as tt

    for mm in (8, 2):
        a = [_fields(c) for c in tt.candidate_configs(n, max_micro=mm)]
        b = [_fields(c) for c in jt.candidate_configs(n, max_micro=mm)]
        assert a == b and a
        assert [c.degree for c in tt.candidate_configs(n)] == [n] * len(
            tt.candidate_configs(n))


@pytest.mark.parametrize("kw", [
    dict(n_layers=4), dict(n_heads=6), dict(global_batch=12),
    dict(param_bytes=8e9, hbm_bytes=16e9),
    dict(n_layers=2, n_heads=4, global_batch=8, param_bytes=4e9,
         hbm_bytes=8e9, opt_state_mult=2.0)])
def test_prune_equals_jax(kw):
    from paddle_tpu.distributed.auto_tuner import tuner as jt

    from paddle_tpu_torch.distributed.auto_tuner import tuner as tt

    a = [_fields(c) for c in tt.prune_candidates(tt.candidate_configs(8),
                                                 **kw)]
    b = [_fields(c) for c in jt.prune_candidates(jt.candidate_configs(8),
                                                 **kw)]
    assert a == b


def _trial(c):
    if c.mp == 4 or (c.pp == 2 and c.schedule_mode == "ZB-H1"):
        raise RuntimeError(f"no fit at mp {c.mp} pp {c.pp}")
    return 1.0 / (c.dp + 0.5 * c.sharding + 0.25 * c.mp) + 0.1 * c.pp \
        + 0.01 * c.micro_batches


@pytest.mark.parametrize("max_trials", [3, 16, 40])
def test_search_picks_jax_best_with_jax_history(max_trials):
    from paddle_tpu.distributed.auto_tuner import tuner as jt

    from paddle_tpu_torch.distributed.auto_tuner import tuner as tt

    kw = dict(prune_kwargs={"n_layers": 8}, max_trials=max_trials)
    a, b = tt.AutoTuner(8, _trial, **kw), jt.AutoTuner(8, _trial, **kw)
    assert _fields(a.search()) == _fields(b.search())
    assert [_fields(c) for c in a.history] == \
        [_fields(c) for c in b.history]
    with pytest.raises(RuntimeError, match="every candidate failed"):
        tt.AutoTuner(4, lambda c: 1 / 0, max_trials=2).search()


def _cfg(layers):
    from paddle_tpu_torch.models import llama_tiny_config

    return llama_tiny_config(num_hidden_layers=layers)


def _model_fn(fail_on_rank=None):
    """The tiny LLaMA, whole (TrainStep) or as pipeline parts, seeded the
    same on every rank; raises on `fail_on_rank` at mp 2."""
    def model_fn():
        from paddle_tpu_torch.distributed.env import get_rank
        from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import (
            mp_group)
        from paddle_tpu_torch.distributed.mesh import get_mesh
        from paddle_tpu_torch.models import LlamaForCausalLM
        from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                                   LlamaEmbeddingStage,
                                                   LlamaHeadStage,
                                                   LlamaPretrainingCriterion)

        mesh = get_mesh()
        if get_rank() == fail_on_rank and mesh.shape.get("mp", 1) == 2:
            raise MemoryError("rank 3 ran out of memory")
        pp = mesh.shape.get("pp", 1)
        cfg = _cfg(4)
        torch.manual_seed(0)
        if pp == 1:
            return (LlamaForCausalLM(cfg, device="cpu", seed=0),
                    lambda out, labels: out)
        cpu = torch.device("cpu")
        crit = LlamaPretrainingCriterion(cfg, mp_group())
        return (LlamaEmbeddingStage(cfg, cpu),
                [LlamaDecoderLayer(cfg, cpu) for _ in range(4)],
                LlamaHeadStage(cfg, cpu), lambda lg, lb: crit(lg, lb))
    return model_fn


def _batch_fn(cfg):
    import numpy as np

    ids = np.random.RandomState(5).randint(1, 256, (8, 17)).astype(np.int64)
    if cfg.pp > 1:
        return torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])
    return ({"input_ids": ids[:, :-1], "labels": ids[:, 1:]},)


def _opt_fn(params):
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(learning_rate=1e-3, parameters=params)


def _tuner_rank(out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.auto_tuner import (AutoTuner,
                                                         TunerConfig,
                                                         compiled_trial_fn)
    from paddle_tpu_torch.distributed.mesh import build_mesh, get_mesh

    dist.init_parallel_env()
    prev = build_mesh({"dp": 4})
    out = {}
    run = compiled_trial_fn(_model_fn(), _batch_fn, _opt_fn, warmup=1,
                            iters=2)
    tuner = AutoTuner(4, run, max_trials=3)
    best = tuner.search()
    out["history"] = [_fields(c) for c in tuner.history]
    out["best"] = _fields(best)
    out["prev_back"] = get_mesh() is prev
    groups = len(collective._GROUPS)
    again = AutoTuner(4, run, max_trials=3)
    again.search()
    out["new_groups"] = len(collective._GROUPS) - groups
    out["pipelines"] = {}
    for cfg in (TunerConfig(dp=2, pp=2, micro_batches=2),
                TunerConfig(pp=4, micro_batches=4, schedule_mode="ZB-H1")):
        out["pipelines"][cfg.schedule_mode] = run(cfg)
    failing = compiled_trial_fn(_model_fn(fail_on_rank=3), _batch_fn,
                                _opt_fn, warmup=1, iters=1)
    t0 = time.perf_counter()
    try:
        failing(TunerConfig(dp=2, mp=2))
        out["fail"] = None
    except RuntimeError as e:
        out["fail"] = str(e)
    out["fail_s"] = time.perf_counter() - t0
    out["after_fail"] = failing(TunerConfig(dp=4))
    out["prev_back_after_fail"] = get_mesh() is prev
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("auto_tuner"))
    spawn(_tuner_rank, (out,), nprocs=4, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


def test_compiled_trials_agree_on_every_rank(ranks):
    h = ranks[0]["history"]
    assert [c[:6] for c in h] == [(4, 1, 1, 1, 1, "1F1B"),
                                  (2, 1, 1, 2, 1, "1F1B"),
                                  (1, 1, 1, 4, 1, "1F1B")]
    assert all(c[6] > 0 and c[7] is None for c in h)
    for r in range(4):
        assert ranks[r]["history"] == h
        assert ranks[r]["best"] == ranks[0]["best"]
        assert ranks[r]["best"] == min(h, key=lambda c: c[6])
        assert ranks[r]["prev_back"]


def test_candidate_meshes_are_reused(ranks):
    for r in range(4):
        assert ranks[r]["new_groups"] == 0


def test_pipelined_trials_time_their_schedules(ranks):
    for key in ("1F1B", "ZB-H1"):
        t = ranks[0]["pipelines"][key]
        assert t > 0
        assert all(ranks[r]["pipelines"][key] == t for r in range(4))


def test_a_trial_failing_on_one_rank_fails_on_all(ranks):
    for r in range(4):
        msg = ranks[r]["fail"]
        assert msg is not None and "rank 3: MemoryError" in msg
        assert "rank 0" not in msg
        assert ranks[r]["fail_s"] < FAIL_WAIT_S
        assert ranks[r]["after_fail"] > 0
        assert ranks[r]["prev_back_after_fail"]
