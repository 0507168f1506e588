"""Elastic sharded checkpoints of the port (``paddle_tpu_torch.
distributed.checkpoint``) against the JAX package on the CPU, mirroring
``tests/test_elastic_checkpoint.py`` (its hapi class aside).

* The commit protocol: save/load/latest round trip, async saves that do
  not change the step's losses, a snapshot that survives the in-place
  updates of later steps, keep-last GC, a duplicate step refused.
* Every ``ckpt.*`` point killing a save (the latest committed snapshot
  stays loadable, and the same protocol run by the JAX package on the same
  snapshot leaves the same steps committed), a retried save after a crash,
  an async fault surfacing on ``wait``.
* The pickle-free ``paddle_tpu-dcp1`` format: legacy pickles refused, no
  pickle in the package, bf16 shards read by the other package bit for
  bit both ways.
* fp8 amax histories and GradScaler scalars riding the snapshot.
* SIGTERM and watchdog-hang save-and-stop.
* Cross-package files: a JAX ``CompiledTrainStep`` snapshot restored into
  the port's ``TrainStep`` continues within the training parity rule of
  ``tests/test_torch_port_training.py`` (losses rtol 1e-5, parameters
  atol 2e-5) of the JAX run's own continuation; a port snapshot read by
  JAX's ``read_global_state`` gives the port's arrays exactly.
* Cross-layout resume over 2 spawned gloo ranks (one spawn): dp 2, ZeRO-3 sharding 2, ZeRO-2 sharding 2, mp 2
  and pp 2 (1F1B, 2 microbatches) each save after 2 AdamW steps and
  train 2 more; a resume on the same layout is bit-equal to that
  uninterrupted run (losses and final parameters); a resume on the single
  replicated layout (this process), and a replicated save resumed at
  ZeRO-3 sharding 2 and at pp 2, are held as the JAX package holds a
  cross-layout resume: each loss bit-equal to one of the two layouts'
  uninterrupted runs, or within the two runs' own agreement (their largest
  loss difference over the 4 steps, and for the final parameters their
  largest element difference). Every multi-rank save read back by
  ``read_global_state`` equals the ranks' gathered state bit for bit.

The tiny LLaMA: 2 layers, hidden 64, vocab 256, batch 8 x 16, AdamW lr
1e-3, wd 0.01. Spawned ranks import torch, numpy and the port only.
"""
import os
import pickle
import signal
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.distributed.checkpoint import elastic
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.distributed.spawn import spawn

LR = 1e-3
SPAWN_TIMEOUT_S = 300
N_LAYERS = 2
LAYOUTS = ("dp2", "zero3", "zero2", "mp2", "pp2")


@pytest.fixture(autouse=True)
def _hygiene():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import set_mesh

    fleet.reset()
    set_mesh(None)
    yield
    faults.reset()
    set_flags({"fault_injection": "", "ckpt_fault_injection": ""})
    fleet.reset()
    set_mesh(None)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("paddle_tpu_torch.ckpt",
                                  "paddle_tpu_torch.watchdog"))
            and t.name != "paddle_tpu_torch.watchdog"]
    assert not left, f"threads outlived the test: {left}"


def _cfg():
    from paddle_tpu_torch.models import llama_tiny_config

    return llama_tiny_config(num_hidden_layers=N_LAYERS)


def _data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (8, 16)).astype(np.int64)
    labels = rng.randint(0, 256, (8, 16)).astype(np.int64)
    return ids, labels


def _batch():
    ids, labels = _data()
    return {"input_ids": torch.from_numpy(ids),
            "labels": torch.from_numpy(labels)}


def _fused_loss(out, labels):
    return out


def _jax_named():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny_config as jax_tiny

    paddle.seed(0)
    return {n: np.asarray(p._value) for n, p in
            JaxLlama(jax_tiny(num_hidden_layers=N_LAYERS)).named_parameters()}


def _single_step(named, arrays=None, meta=None, **kw):
    """A single-process TrainStep on the JAX weights (restored from a
    snapshot when `arrays` is given)."""
    from paddle_tpu_torch.models import from_paddle_tpu_params
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    model = from_paddle_tpu_params(named, _cfg(), device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01)
    if arrays is not None:
        missing, unexpected = elastic.restore(arrays, meta, model, opt)
        assert not missing and not unexpected, (missing, unexpected)
    step = TrainStep(model, _fused_loss, opt, **kw)
    if arrays is not None:
        step.load_resume_extras(arrays, meta)
    return model, opt, step


def _run(step, n):
    batch = _batch()
    return [float(step(batch)) for _ in range(n)]


@pytest.fixture(scope="module")
def named():
    return _jax_named()


# ---------------------------------------------------------------------------
# the commit protocol
# ---------------------------------------------------------------------------

class TestCommitProtocol:
    def test_save_load_latest_roundtrip(self, named, tmp_path):
        _, _, step = _single_step(named)
        _run(step, 2)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            assert mgr.latest() is None
            mgr.save(elastic.capture(step, cursor={"batches": 2}))
            assert mgr.latest() == 2
            arrays, meta = mgr.load()
        assert meta["step"] == 2 and meta["cursor"] == {"batches": 2}
        names = sorted(os.listdir(mgr.path(2)))
        assert "COMMIT" in names and "state.json" in names
        assert any(n.endswith(".metadata") for n in names)
        assert any(n.endswith(".distcp") for n in names)
        # the JAX package's names and layout: q_proj [in, out]
        q = arrays["model/llama.layers.1.self_attn.q_proj.weight"]
        assert torch.equal(q, step.model.llama.layers[1].self_attn
                           .q_proj.weight.detach().t())
        assert "opt/llama.layers.1.self_attn.q_proj.weight/m" in arrays
        assert "rng/key" not in arrays    # the port's step draws none

    def test_async_save_does_not_change_the_step(self, named, tmp_path):
        """An every-step async cadence leaves the step_async losses
        bit-identical to the run without checkpoints."""
        _, _, ref_step = _single_step(named, metrics_every=0)
        batch = _batch()
        ref = [float(ref_step.step_async(batch)) for _ in range(4)]
        _, _, step = _single_step(named, metrics_every=0)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            futures = []
            for i in range(4):
                futures.append(step.step_async(batch))
                mgr.save_async(elastic.capture(step, cursor={"it": i + 1}))
            losses = [float(f) for f in futures]
            mgr.wait()
            assert mgr.latest() == 4
        assert losses == ref
        assert set(mgr.steps()) <= {2, 3, 4} and 4 in mgr.steps()

    def test_snapshot_survives_in_place_updates(self, named, tmp_path):
        """The optimizer updates parameters in place: a step-2 capture
        written after two more steps still holds step 2's values."""
        _, _, step = _single_step(named)
        _run(step, 2)
        w = step.model.llama.norm.weight
        at2 = w.detach().clone()
        snap = elastic.capture(step)
        _run(step, 2)
        assert not torch.equal(w.detach(), at2)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            mgr.save(snap)
            arrays, meta = mgr.load()
        assert meta["step"] == 2
        assert torch.equal(arrays["model/llama.norm.weight"], at2)

    def test_keep_last_gc(self, named, tmp_path):
        import paddle_tpu.distributed.checkpoint.elastic as jel

        _, _, step = _single_step(named)
        with elastic.CheckpointManager(str(tmp_path / "port"),
                                       keep_last=2) as mgr:
            for _ in range(5):
                _run(step, 1)
                mgr.save(elastic.capture(step))
            assert mgr.steps() == [4, 5] and mgr.latest() == 5
        # the JAX package's manager over the same snapshots keeps the same
        with jel.CheckpointManager(str(tmp_path / "jax"), keep_last=2) as jm:
            for s in range(1, 6):
                jm.save(jel.Snapshot(step=s, arrays={"w": np.zeros(2)}))
            assert jm.steps() == mgr.steps()

    def test_duplicate_step_rejected(self, named, tmp_path):
        _, _, step = _single_step(named)
        _run(step, 1)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            mgr.save(elastic.capture(step))
            with pytest.raises(FileExistsError, match="already committed"):
                mgr.save(elastic.capture(step))


# ---------------------------------------------------------------------------
# fault injection at every phase of the commit
# ---------------------------------------------------------------------------

def _snap_pair(step):
    """The same snapshot for both packages (numpy arrays)."""
    import paddle_tpu.distributed.checkpoint.elastic as jel

    arrays = {"w": np.arange(12, dtype=np.float32).reshape(3, 4) + step}
    return (elastic.Snapshot(step=step, arrays=dict(arrays)),
            jel.Snapshot(step=step, arrays=dict(arrays)))


class TestFaultInjection:
    @pytest.mark.parametrize("point", elastic.FAULT_POINTS)
    def test_kill_leaves_previous_committed(self, named, tmp_path, point):
        import paddle_tpu.distributed.checkpoint.elastic as jel
        from paddle_tpu.core.flags import set_flags as jax_set_flags

        assert jel.FAULT_POINTS == elastic.FAULT_POINTS
        _, _, step = _single_step(named)
        _run(step, 1)
        with elastic.CheckpointManager(str(tmp_path / "port")) as mgr:
            mgr.save(elastic.capture(step))
            _run(step, 1)
            set_flags({"ckpt_fault_injection": point})
            try:
                with pytest.raises(elastic.CheckpointFaultInjected,
                                   match=point):
                    mgr.save(elastic.capture(step))
            finally:
                set_flags({"ckpt_fault_injection": ""})
            if point in ("before_commit", "after_commit"):
                assert mgr.latest() in (1, 2)
            else:
                assert mgr.latest() == 1
            arrays, meta = mgr.load(1)
            assert meta["step"] == 1
            _, _, step2 = _single_step(named, arrays, meta)
            assert step2.step_count == 1
        # the JAX package's protocol on the same kill commits the same
        ports = mgr.steps()
        with jel.CheckpointManager(str(tmp_path / "jax")) as jm:
            jm.save(_snap_pair(1)[1])
            jax_set_flags({"ckpt_fault_injection": point})
            try:
                with pytest.raises(jel.CheckpointFaultInjected):
                    jm.save(_snap_pair(2)[1])
            finally:
                jax_set_flags({"ckpt_fault_injection": ""})
            assert jm.steps() == ports

    @pytest.mark.parametrize("point", ["after_shard_write", "before_commit"])
    def test_retry_after_crash_succeeds(self, named, tmp_path, point):
        _, _, step = _single_step(named)
        _run(step, 2)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            faults.arm(f"ckpt.{point}")
            with pytest.raises(elastic.CheckpointFaultInjected):
                mgr.save(elastic.capture(step))
            mgr.save(elastic.capture(step))
            assert mgr.latest() == 2
            assert mgr.load()[1]["step"] == 2

    def test_async_fault_surfaces_on_wait(self, named, tmp_path):
        _, _, step = _single_step(named)
        _run(step, 1)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            set_flags({"ckpt_fault_injection": "after_shard_write"})
            try:
                h = mgr.save_async(elastic.capture(step))
                with pytest.raises(elastic.CheckpointFaultInjected):
                    mgr.wait()
                assert h.done()
            finally:
                set_flags({"ckpt_fault_injection": ""})
            assert mgr.latest() is None


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

class TestPickleFreeFormat:
    def test_legacy_pickle_checkpoint_rejected(self, tmp_path):
        from paddle_tpu_torch.distributed.checkpoint import load_state_dict

        with open(tmp_path / "0_0.distcp", "wb") as f:
            pickle.dump({("w", (0,)): np.zeros(4)}, f, protocol=4)
        with open(tmp_path / "0.metadata", "wb") as f:
            pickle.dump({"state": {}}, f, protocol=4)
        with pytest.raises(ValueError, match="legacy pickle"):
            load_state_dict({"w": torch.zeros(4)}, str(tmp_path))

    def test_no_pickle_under_checkpoint_package(self):
        import paddle_tpu_torch.distributed.checkpoint as pkg

        root = os.path.dirname(pkg.__file__)
        offenders = []
        for name in os.listdir(root):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                src = f.read()
            for needle in ("pickle.load", "pickle.dump", "import pickle",
                           "cPickle"):
                if needle in src:
                    offenders.append(f"{name}: {needle}")
        assert not offenders, offenders

    def test_bf16_roundtrip_across_packages(self, tmp_path):
        import jax.numpy as jnp

        from paddle_tpu.distributed.checkpoint import format as jax_format
        from paddle_tpu_torch.distributed.checkpoint import (
            format as ckpt_format)

        t = torch.linspace(-3, 3, 24).reshape(4, 6).to(torch.bfloat16)
        ckpt_format.write_shard_file(str(tmp_path / "p.distcp"),
                                     {("w", (0, 0)): t})
        back = ckpt_format.read_shard_file(str(tmp_path / "p.distcp"))
        assert torch.equal(back[("w", (0, 0))], t)
        jax_back = jax_format.read_shard_file(str(tmp_path / "p.distcp"))
        assert str(jax_back[("w", (0, 0))].dtype) == "bfloat16"
        np.testing.assert_array_equal(
            jax_back[("w", (0, 0))].astype(np.float32), t.float().numpy())
        arr = np.asarray(jnp.arange(8, dtype=jnp.bfloat16))
        jax_format.write_shard_file(str(tmp_path / "j.distcp"),
                                    {("w", (0,)): arr})
        got = ckpt_format.read_shard_file(str(tmp_path / "j.distcp"))
        assert got[("w", (0,))].dtype == torch.bfloat16
        assert torch.equal(got[("w", (0,))].float(),
                           torch.arange(8, dtype=torch.float32))

    def test_rank_files_split_and_read_by_both(self, tmp_path):
        """A rank's shards split over several containers (written in
        parallel) read back whole by both packages."""
        from paddle_tpu.distributed.checkpoint.load_state_dict import (
            read_global_state as jax_read)
        from paddle_tpu_torch.distributed.checkpoint import (
            format as ckpt_format)
        from paddle_tpu_torch.distributed.checkpoint import (
            read_global_state)
        from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
            collect_shards)

        arrays = {f"w{i}": torch.randn(64, 32 + i) for i in range(7)}
        arrays["b"] = torch.arange(5, dtype=torch.int64)
        meta, data = collect_shards(arrays, "")
        rec = {}
        names = ckpt_format.write_rank_files(str(tmp_path), 0, data,
                                             timings=rec,
                                             min_file_bytes=8192)
        assert len(names) == 4 and rec["files"] == 4
        assert rec["bytes"] == sum(v.numel() * v.element_size()
                                   for v in arrays.values())
        for f in names:
            for ent in ckpt_format.shard_table(str(tmp_path / f)):
                meta.storage_metadata[
                    next(i for i in meta.storage_metadata
                         if i.tensor_key == ent["key"])] = f
        ckpt_format.write_metadata(str(tmp_path / "0.metadata"), meta)
        port, jax = read_global_state(str(tmp_path)), jax_read(str(tmp_path))
        for k, v in arrays.items():
            assert torch.equal(port[k], v)
            np.testing.assert_array_equal(np.asarray(jax[k]), v.numpy())

    def test_range_boxes_cover_each_range_once(self):
        from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
            range_boxes)

        for shape in [(7,), (3, 5), (4, 3, 5), (2, 3, 2, 3)]:
            n = int(np.prod(shape))
            full = np.arange(n).reshape(shape)
            for a in range(0, n + 1, 2):
                for e in range(a, n + 1, 3):
                    seen = np.zeros(shape, int)
                    pos = a
                    boxes = range_boxes(a, e, shape)
                    assert len(boxes) <= 2 * len(shape) - 1
                    for off, bshape, fs in boxes:
                        sl = tuple(slice(o, o + s)
                                   for o, s in zip(off, bshape))
                        seen[sl] += 1
                        assert fs == pos
                        np.testing.assert_array_equal(
                            full[sl].reshape(-1),
                            np.arange(fs, fs + full[sl].size))
                        pos += full[sl].size
                    assert pos == e
                    assert (seen.reshape(-1)[a:e] == 1).all()
                    assert seen.sum() == e - a


# ---------------------------------------------------------------------------
# fp8 and the GradScaler
# ---------------------------------------------------------------------------

class TestFp8AndScalerResume:
    def test_fp8_amax_state_rides_the_snapshot(self, named, tmp_path):
        _, _, straight_step = _single_step(named, fp8_policy="matmuls")
        straight = _run(straight_step, 4)
        _, _, step = _single_step(named, fp8_policy="matmuls")
        first = _run(step, 2)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            mgr.save(elastic.capture(step))
            arrays, meta = mgr.load()
        assert meta["fp8_layout"] and meta["fp8_leaves"] > 0
        _, _, step3 = _single_step(named, arrays, meta,
                                   fp8_policy="matmuls")
        for a, b in zip(step._fp8_states, step3._fp8_states):
            for k in a:
                assert torch.equal(a[k], b[k])
        rest = _run(step3, 2)
        assert first == straight[:2] and rest == straight[2:]

    def test_grad_scaler_state_rides_the_snapshot(self, named, tmp_path):
        from paddle_tpu_torch.amp import GradScaler

        scaler = GradScaler(init_loss_scaling=1024.0)
        _, _, step = _single_step(named, grad_scaler=scaler)
        _run(step, 2)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            mgr.save(elastic.capture(step))
            arrays, meta = mgr.load()
        assert meta["scaler"]["scale"] == scaler.state_dict()["scale"]
        assert meta["scaler"]["good_steps"] == 2
        scaler2 = GradScaler(init_loss_scaling=2.0)     # wrong on purpose
        _single_step(named, arrays, meta, grad_scaler=scaler2)
        assert scaler2.state_dict() == meta["scaler"]


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

class TestPreemption:
    def test_sigterm_saves_and_requests_stop(self, named, tmp_path,
                                             monkeypatch):
        monkeypatch.setenv("PADDLE_LOG_DIR", str(tmp_path))
        _, _, step = _single_step(named)
        _run(step, 3)
        with elastic.CheckpointManager(str(tmp_path / "ck")) as mgr:
            uninstall = elastic.install_preemption_handler(
                mgr, lambda: elastic.capture(step))
            try:
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(0.01)
            finally:
                uninstall()
            assert mgr.should_stop and "signal" in mgr.preempt_reason
            assert mgr.latest() == 3
            _, meta = mgr.load()
        assert meta["preempt"]["signal"] == int(signal.SIGTERM)

    def test_hang_fires_listener_with_structured_dump_and_saves(
            self, named, tmp_path, monkeypatch):
        from paddle_tpu_torch.distributed import watchdog

        monkeypatch.setenv("PADDLE_LOG_DIR", str(tmp_path))

        class Stalled:
            def __array__(self, dtype=None):
                time.sleep(1.5)
                return np.zeros((), np.float32)

        _, _, step = _single_step(named)
        _run(step, 1)
        wd = watchdog.CommTaskManager(default_timeout_s=0.2,
                                      poll_interval_s=0.05)
        seen = []
        with elastic.CheckpointManager(str(tmp_path / "ck")) as mgr:
            uninstall = elastic.install_hang_handler(
                mgr, lambda: elastic.capture(step), watchdog_manager=wd)
            off = watchdog.add_hang_listener(
                lambda task, diag: seen.append((task.name, diag)),
                manager=wd)
            try:
                watchdog.watch_step(Stalled(), name="stalled_step",
                                    timeout_s=0.2, manager=wd)
                deadline = time.time() + 5
                while not mgr.should_stop and time.time() < deadline:
                    time.sleep(0.05)
            finally:
                off()
                uninstall()
                wd.stop()
            assert mgr.should_stop and "hang" in mgr.preempt_reason
            assert seen and seen[0][0] == "stalled_step"
            diag = seen[0][1]
            assert diag["task"]["name"] == "stalled_step"
            assert diag["task"]["elapsed_s"] >= 0.2
            assert "in_flight" in diag and "last_completed" in diag
            _, meta = mgr.load()
        assert meta["hang"]["task"]["name"] == "stalled_step"
        time.sleep(1.6)     # the stalled waiter thread ends


# ---------------------------------------------------------------------------
# cross-package files
# ---------------------------------------------------------------------------

class TestCrossPackage:
    def test_jax_snapshot_continues_in_the_port(self, named, tmp_path):
        import paddle_tpu as paddle
        import paddle_tpu.distributed.checkpoint.elastic as jel
        from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
        from paddle_tpu.models.llama import llama_tiny_config as jax_tiny
        from paddle_tpu.parallel import CompiledTrainStep

        paddle.seed(0)
        jm = JaxLlama(jax_tiny(num_hidden_layers=N_LAYERS))
        jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                      parameters=jm.parameters(),
                                      weight_decay=0.01)
        jstep = CompiledTrainStep(jm, _fused_loss, optimizer=jopt)
        ids, labels = _data()
        batch = {"input_ids": ids.astype(np.int32),
                 "labels": labels.astype(np.int32)}
        [float(jstep(batch)) for _ in range(2)]
        with jel.CheckpointManager(str(tmp_path)) as jmgr:
            jmgr.save(jel.capture(jstep))
        jrest = [float(jstep(batch)) for _ in range(2)]
        jstep.sync_params_to_model()
        jfinal = {n: np.asarray(p._value) for n, p in jm.named_parameters()}

        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            arrays, meta = mgr.load()
        _, _, step = _single_step(named, arrays, meta)
        assert step.step_count == 2
        rest = _run(step, 2)
        np.testing.assert_allclose(rest, jrest, rtol=1e-5)
        from paddle_tpu_torch.models import gather_paddle_tpu_params

        final = gather_paddle_tpu_params([dict(step.model.named_parameters())])
        for n, v in jfinal.items():
            np.testing.assert_allclose(final[n], v, atol=2e-5, err_msg=n)
        # the JAX key rides the port's next snapshot unchanged
        with elastic.CheckpointManager(str(tmp_path / "again")) as m2:
            m2.save(elastic.capture(step))
            again, _ = m2.load()
        assert torch.equal(again["rng/key"], arrays["rng/key"])

    def test_port_snapshot_read_by_jax(self, named, tmp_path):
        from paddle_tpu.distributed.checkpoint.load_state_dict import (
            read_global_state as jax_read)

        _, _, step = _single_step(named)
        _run(step, 2)
        with elastic.CheckpointManager(str(tmp_path)) as mgr:
            mgr.save(elastic.capture(step))
            arrays, _ = mgr.load()
        got = jax_read(mgr.path(2))
        assert set(got) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(),
                                          err_msg=k)
        # and they are the port's own tensors, in the JAX layout
        for n, p in step.model.named_parameters():
            v = p.detach()
            if n.endswith("_proj.weight") or n == "lm_head.weight":
                v = v.t()
            assert torch.equal(arrays[f"model/{n}"], v), n


# ---------------------------------------------------------------------------
# cross-layout resume: the ranks (torch and the port only)
# ---------------------------------------------------------------------------

def _pipe_parts(named, hcg):
    """This pp rank's stage modules {layer index: module} and block
    indices, loaded from the JAX weights."""
    from paddle_tpu_torch.models.convert import (load_pipeline_params,
                                                 pipeline_stage_params)
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               LlamaEmbeddingStage,
                                               LlamaHeadStage)
    from paddle_tpu_torch.parallel.pipeline import stage_block_indices

    cfg = _cfg()
    S, s = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
    mods = {}
    if s == 0:
        mods[0] = LlamaEmbeddingStage(cfg)
    idx = stage_block_indices(N_LAYERS, S, s)
    for i in idx:
        mods[i + 1] = LlamaDecoderLayer(cfg)
    if s == S - 1:
        mods[N_LAYERS + 1] = LlamaHeadStage(cfg)
    load_pipeline_params(mods, pipeline_stage_params(
        named, N_LAYERS, list(mods), 0, 1))
    return mods, idx


def _canonical(mods, idx):
    out = {}
    if 0 in mods:
        out["llama."] = mods[0]
    for i in idx:
        out[f"llama.layers.{i}."] = mods[i + 1]
    if N_LAYERS + 1 in mods:
        head = mods[N_LAYERS + 1]
        out["llama.norm."] = head.norm
        out["lm_head."] = head.lm_head
    return out


def _restore_stages(mods, idx, opt, arrays, meta):
    if 0 in mods:
        elastic.restore(arrays, meta, mods[0], opt,
                        mapper={"model/llama.": "model/",
                                "opt/llama.": "opt/"})
    for i in idx:
        elastic.restore(arrays, meta, mods[i + 1], opt,
                        mapper={f"model/llama.layers.{i}.": "model/",
                                f"opt/llama.layers.{i}.": "opt/"})
    if N_LAYERS + 1 in mods:
        elastic.restore(arrays, meta, mods[N_LAYERS + 1], opt,
                        mapper={"model/llama.norm.": "model/norm.",
                                "opt/llama.norm.": "opt/norm.",
                                "model/lm_head.": "model/lm_head.",
                                "opt/lm_head.": "opt/lm_head."})


_AXES = {"dp2": ({"dp": 2}, None, 1), "zero3": ({"sharding": 2},
                                                 "sharding", 3),
         "zero2": ({"sharding": 2}, "sharding", 2),
         "mp2": ({"mp": 2}, None, 1)}


def _layout_step(kind, named, arrays=None, meta=None):
    """(step, capture callable, state callable) of layout `kind` on this
    rank, restored from a snapshot when `arrays` is given; the state
    callable gives this rank's parameters as full JAX-layout arrays
    (gathered over the layout's shards)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         gather_paddle_tpu_params)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    fleet.reset()
    set_mesh(None)
    if kind == "pp2":
        from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
        from paddle_tpu_torch.parallel.pipeline import (PipelinedTrainStep,
                                                        pipeline_hcg)

        mesh = build_mesh({"pp": 2})
        hcg, _ = pipeline_hcg(mesh)
        mods, idx = _pipe_parts(named, hcg)
        params = [p for m in mods.values() for p in m.parameters()]
        opt = AdamW(learning_rate=LR, parameters=params, weight_decay=0.01)
        if arrays is not None:
            _restore_stages(mods, idx, opt, arrays, meta)
        step = PipelinedTrainStep(
            mods.get(0), [mods[i + 1] for i in idx], mods.get(N_LAYERS + 1),
            LlamaPretrainingCriterion(_cfg()), optimizer=opt, mesh=mesh,
            num_micro=2)
        ids, labels = _data()

        def run():
            return float(step(ids, labels))

        def cap():
            return elastic.capture_modules(_canonical(mods, idx),
                                           step.optimizer, step.step_count)

        def state():
            shards = {}
            for k, m in _canonical(mods, idx).items():
                for n, p in m.named_parameters():
                    shards[f"{k}{n}"] = p
            return gather_paddle_tpu_params([shards])
        return run, cap, state
    axes, zero_axis, stage = _AXES[kind]
    mesh = build_mesh(axes)
    model = from_paddle_tpu_params(named, _cfg(), device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01)
    if arrays is not None:
        missing, _ = elastic.restore(arrays, meta, model, opt)
        assert not missing, missing
    step = TrainStep(model, _fused_loss, opt, mesh=mesh,
                     zero_axis=zero_axis, zero_stage=stage)
    if arrays is not None:
        step.load_resume_extras(arrays, meta)
    batch = _batch()

    def run():
        return float(step(batch))

    def cap():
        return elastic.capture(step)

    def state():
        import torch.distributed as dist

        full = dict(step.model.state_dict()) if kind == "zero3" else \
            {n: p.detach() for n, p in model.named_parameters()}
        if kind == "mp2":
            g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
            parts = [None] * g.nranks
            dist.all_gather_object(parts, full, group=g.pg)
            return gather_paddle_tpu_params(parts)
        return gather_paddle_tpu_params([full])
    return run, cap, state


def _anomaly_dp2():
    """dp 2 with anomaly detection, rank 1's second batch NaN: both ranks
    skip that update and record the same anomaly."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.env import get_rank
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.distributed.resilience import AnomalyDetector
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import TrainStep

    fleet.reset()
    set_mesh(None)
    mesh = build_mesh({"dp": 2})
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 3))
    det = AnomalyDetector(policy="rollback", min_history=4)
    step = TrainStep(net, torch.nn.functional.cross_entropy,
                     Adam(learning_rate=0.05, parameters=net.parameters()),
                     mesh=mesh, anomaly_detector=det)
    rng = np.random.RandomState(3)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randint(0, 3, (8,)).astype(np.int64)
    params = []
    for i in range(3):
        if i == 1 and get_rank() == 1:
            faults.arm("step.grads")
        before = [p.detach().clone() for p in net.parameters()]
        step(x, y)
        params.append(all(torch.equal(a, b.detach()) for a, b in
                          zip(before, net.parameters())))
    faults.reset()
    return {"unchanged": params,
            "incidents": [a.to_json() for a in det.incidents],
            "params": [p.detach().clone() for p in net.parameters()]}


def _save(cap, root, out_key, res):
    with elastic.CheckpointManager(root) as mgr:
        mgr.save(cap())
        res[out_key] = mgr.latest()


def _rank_main(out_dir):
    """Every layout's save, uninterrupted run and same-layout resume, and
    the replicated save's resumes; writes rank<r>.pkl."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env()
    with open(os.path.join(out_dir, "named.pkl"), "rb") as fh:
        named = pickle.load(fh)
    out = {}
    for kind in LAYOUTS:
        res = {}
        run, cap, state = _layout_step(kind, named)
        res["losses"] = [run(), run()]
        _save(cap, os.path.join(out_dir, kind), "saved", res)
        res["losses"] += [run(), run()]
        res["state"] = {n: np.asarray(v) for n, v in state().items()}
        # the final state through a multi-rank save
        _save(cap, os.path.join(out_dir, f"{kind}_final"), "final", res)
        mgr = elastic.CheckpointManager(os.path.join(out_dir, kind))
        arrays, meta = mgr.load()
        mgr.close()
        run, _, state = _layout_step(kind, named, arrays, meta)
        res["resumed"] = [run(), run()]
        res["resumed_state"] = {n: np.asarray(v) for n, v in
                                state().items()}
        out[kind] = res
    out["anomaly_dp2"] = _anomaly_dp2()
    mgr = elastic.CheckpointManager(os.path.join(out_dir, "single"))
    arrays, meta = mgr.load()
    mgr.close()
    for kind in ("zero3", "pp2"):
        run, _, state = _layout_step(kind, named, arrays, meta)
        out[f"single_to_{kind}"] = {
            "losses": [run(), run()],
            "state": {n: np.asarray(v) for n, v in state().items()}}
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def layouts(tmp_path_factory, named):
    """The ranks' results, and this process's single replicated runs: the
    uninterrupted 4 steps, the save after 2, and each layout's save
    resumed here."""
    out = str(tmp_path_factory.mktemp("ckpt_layouts"))
    with open(os.path.join(out, "named.pkl"), "wb") as fh:
        pickle.dump(named, fh)
    _, _, step = _single_step(named)
    single = {"losses": _run(step, 2)}
    with elastic.CheckpointManager(os.path.join(out, "single")) as mgr:
        mgr.save(elastic.capture(step))
    single["losses"] += _run(step, 2)
    from paddle_tpu_torch.models import gather_paddle_tpu_params

    single["state"] = gather_paddle_tpu_params(
        [dict(step.model.named_parameters())])
    err = []

    def go():
        try:
            spawn(_rank_main, (out,), nprocs=2, timeout=SPAWN_TIMEOUT_S)
        except BaseException as e:  # re-raised below
            err.append(e)

    thread = threading.Thread(target=go)
    thread.start()
    thread.join()
    if err:
        raise err[0]
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    resumed = {}
    for kind in LAYOUTS:
        with elastic.CheckpointManager(os.path.join(out, kind)) as mgr:
            arrays, meta = mgr.load()
        _, _, s = _single_step(named, arrays, meta)
        resumed[kind] = {"losses": _run(s, 2), "state":
                         gather_paddle_tpu_params(
                             [dict(s.model.named_parameters())])}
    return {"dir": out, "ranks": ranks, "single": single,
            "resumed_single": resumed}


def _held(rest, src, tgt, state, src_state, tgt_state):
    """The cross-layout rule (see the module docstring): each resumed loss
    bit-equal to the source's or the target's uninterrupted run, or within
    their largest loss difference of both; the final parameters within the
    two runs' largest element difference of both."""
    agree = max(abs(a - b) for a, b in zip(src, tgt))
    for r, s, t in zip(rest, src[2:], tgt[2:]):
        assert r == s or r == t or (abs(r - s) <= agree
                                    and abs(r - t) <= agree), (
            rest, src, tgt)
    agree_p = max(float(np.abs(src_state[n] - tgt_state[n]).max())
                  for n in state)
    for n, v in state.items():
        assert float(np.abs(v - src_state[n]).max()) <= agree_p, n
        assert float(np.abs(v - tgt_state[n]).max()) <= agree_p, n


def _rank_state(layouts, kind, key="state"):
    """The layout's full parameters: rank 0's, or both stages' merged."""
    r0, r1 = layouts["ranks"]
    if kind == "pp2" or kind == "single_to_pp2":
        return {**r0[kind][key], **r1[kind][key]}
    return r0[kind][key]


def test_anomaly_skip_agrees_over_ranks(layouts):
    """A NaN batch on one data rank: every rank skips that update (the
    health flag is OR-ed over the ranks) and records the same anomaly;
    the parameters stay equal across the ranks."""
    a, b = (r["anomaly_dp2"] for r in layouts["ranks"])
    assert a["unchanged"] == b["unchanged"] == [False, True, False]
    strip = [{k: v for k, v in x.items() if k != "loss"}
             for x in a["incidents"]]
    assert strip == [{k: v for k, v in x.items() if k != "loss"}
                     for x in b["incidents"]]
    assert [x["step"] for x in a["incidents"]] == [2]
    assert a["incidents"][0]["kind"] == "nonfinite"
    for p, q in zip(a["params"], b["params"]):
        assert torch.equal(p, q)


class TestCrossLayoutResume:
    @pytest.mark.parametrize("kind", LAYOUTS)
    def test_same_layout_resume_is_bit_equal(self, layouts, kind):
        for res in layouts["ranks"]:
            assert res[kind]["resumed"] == res[kind]["losses"][2:]
        a = _rank_state(layouts, kind)
        b = _rank_state(layouts, kind, "resumed_state")
        assert set(a) == set(b)
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)

    @pytest.mark.parametrize("kind", LAYOUTS)
    def test_saves_read_back_as_the_gathered_state(self, layouts, kind):
        from paddle_tpu_torch.distributed.checkpoint import (
            read_global_state)

        full = read_global_state(os.path.join(
            layouts["dir"], f"{kind}_final",
            f"step_{4:08d}"))
        state = _rank_state(layouts, kind)
        for n, v in state.items():
            np.testing.assert_array_equal(full[f"model/{n}"].numpy(), v,
                                          err_msg=n)
        # a ZeRO shard or mp shard never writes its padding: each key's
        # boxes tile it exactly once
        from paddle_tpu_torch.distributed.checkpoint.load_state_dict import (
            read_checkpoint)

        meta, _ = read_checkpoint(os.path.join(layouts["dir"],
                                               f"{kind}_final",
                                               f"step_{4:08d}"))
        for key, metas in meta.state_dict_metadata.items():
            total = sum(int(np.prod(m.local_shape)) for m in metas)
            assert total == full[key].numel(), key
        if kind in ("zero3", "zero2", "mp2"):
            assert any(len(m) > 1 for m in
                       meta.state_dict_metadata.values())

    @pytest.mark.parametrize("kind", LAYOUTS)
    def test_resume_replicated(self, layouts, kind):
        """A layout's save resumed on one replicated rank."""
        src = layouts["ranks"][0][kind]["losses"]
        tgt = layouts["single"]["losses"]
        got = layouts["resumed_single"][kind]
        _held(got["losses"], src, tgt, got["state"],
              _rank_state(layouts, kind), layouts["single"]["state"])

    @pytest.mark.parametrize("kind", ["zero3", "pp2"])
    def test_replicated_save_resumes_sharded(self, layouts, kind):
        src = layouts["single"]["losses"]
        tgt = layouts["ranks"][0][kind]["losses"]
        got = layouts["ranks"][0][f"single_to_{kind}"]
        _held(got["losses"], src, tgt,
              _rank_state(layouts, f"single_to_{kind}"),
              layouts["single"]["state"], _rank_state(layouts, kind))

