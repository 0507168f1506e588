"""Disaggregated prefill/decode in the port on the CPU (the kernels' plain
versions), against the JAX package's engine on the same tiny fp32 GQA
LLaMA (weights carried across by ``models/convert.py``), after the JAX
package's ``test_disagg.py``:

* role validation (JAX's message, ``FLAGS_serving_role``) and the role,
  packed-fill and handoff fields in ``stats()``;
* the KV-page handoff in alias and copy mode (and copy mode over int8
  pages, codes and scales handed off together), with one and two
  workers: greedy streams equal, exactly, to the JAX engine's sequential
  prefill and to the JAX engine's own disaggregated run;
* page tables equal to the JAX engine's after the handoffs land, chain
  bytes within 1e-5 of JAX's and bit-equal to the port's own sequential
  prefill (packed segments at 32-row alignment are independent of their
  neighbours on the plain version);
* exactly-once recovery under ``serving.prefill.kill`` and
  ``serving.handoff.drop`` (and a worker killed by an error in its device
  work), streams equal to JAX's under the same chaos; a cancel while a
  job is pending defers its release; every run ends residue-free;
* the handoff events and the handoff series in the metrics registry.

JAX's ``test_zero_retrace_across_packing_mixes`` has no counterpart: the
port runs eagerly, with no traced program to count.
"""
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.distributed.resilience import faults as jax_faults
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving.disagg import build_disagg as jax_build_disagg
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.models import from_paddle_tpu_params, llama_tiny_config
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.observability.metrics import registry
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.disagg import (HandoffChannel, KVHandoff,
                                             PrefillJob, PrefillWorker,
                                             build_disagg)

ENGINE = dict(page_size=4, num_pages=64, decode_batch=4, prefill_chunk=32,
              max_seq_len=64)
LENS = (7, 5, 9, 6)
NEW = 4
TOL = 1e-5
WAIT_S = 10.0           # bound of every wait on a handoff in this file


@pytest.fixture(autouse=True)
def _port_hygiene():
    before = set(threading.enumerate())
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    events.journal().clear()
    deadline = time.time() + 3.0

    def left():
        return [t for t in threading.enumerate()
                if t.name.startswith(("paddle_tpu_torch.serving",
                                      "paddle_tpu_torch.store"))
                and t not in before and t.is_alive()]

    while left() and time.time() < deadline:
        time.sleep(0.02)
    assert not left(), [t.name for t in left()]


@pytest.fixture(scope="module")
def models():
    """2 layers, hidden 64, 4 query heads on 2 kv heads, fp32."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(num_key_value_heads=2))
    jm.eval()
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(
        num_key_value_heads=2), device="cpu")
    return jm, tm


def _port(tm, **over):
    return ServingEngine(tm, ServingConfig(**{**ENGINE, **over}),
                         device="cpu")


def _jax(jm, **over):
    return JaxServingEngine(jm, JaxServingConfig(**{**ENGINE, **over}))


@pytest.fixture(scope="module")
def jax_engines(models):
    """The JAX engines every case reuses (each costs its compiles):
    sequential prefill, packed [1, 64] frames, and packed over int8
    pages."""
    jm, _ = models
    return {"seq": _jax(jm, prefill_pack=False),
            "pack": _jax(jm, pack_frame=64),
            "int8": _jax(jm, pack_frame=64, kv_cache_dtype="int8")}


def _prompts(cfg, seed=9, lens=LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


@pytest.fixture(scope="module")
def reference(models, jax_engines):
    """The JAX engine's sequential-prefill streams of the cases' prompts."""
    _, tm = models
    prompts = _prompts(tm.config)
    return prompts, jax_engines["seq"].generate(prompts, max_new_tokens=NEW)


def _residue_free(eng):
    """Exactly-once postcondition: nothing half-admitted anywhere."""
    assert eng.scheduler._by_rid == {}
    assert eng._pending_handoff == {}
    assert eng._cancelled_pending == set()
    assert eng.allocator.used_pages == 0
    eng.allocator.check_consistency()


@contextmanager
def _disagg(build, eng, n_workers=1, mode="alias", timeout_s=None):
    channel, workers = build(eng, n_workers, mode=mode, timeout_s=timeout_s)
    try:
        yield channel, workers
    finally:
        for w in workers:
            w.close()
        eng._handoff_channel = None


def _restore_flag(module, name):
    f = module._REGISTRY[name]
    return f, f.value, f.explicit


# ---------------------------------------------------------------------------
# roles and stats
# ---------------------------------------------------------------------------
def test_role_validation(models):
    """An unknown role raises JAX's ValueError; prefill and decode build
    an engine; FLAGS_serving_role is read when the config leaves it
    empty, in both packages alike."""
    jm, tm = models
    with pytest.raises(ValueError, match="role") as port_err:
        _port(tm, role="bogus")
    with pytest.raises(ValueError, match="role") as jax_err:
        _jax(jm, role="bogus")
    assert str(port_err.value) == str(jax_err.value)
    for role in ("decode", "prefill", "MIXED"):
        assert _port(tm, role=role).stats()["role"] == role.lower()
    saved = [_restore_flag(m, "serving_role")
             for m in (port_flags, jax_flags)]
    try:
        port_flags.set_flags({"serving_role": "decode"})
        jax_flags.set_flags({"serving_role": "decode"})
        assert _port(tm).stats()["role"] == "decode"
        assert _jax(jm, prefill_pack=False).stats()["role"] == "decode"
    finally:
        for f, value, explicit in saved:
            f.value, f.explicit = value, explicit


def test_fill_gauge_and_role_in_stats(models, jax_engines):
    """The packed-fill gauge equals the JAX engine's for the same prompts,
    and stats() carries JAX's role and handoff fields."""
    _, tm = models
    prompts = _prompts(tm.config, seed=6, lens=(5, 6, 7, 9))
    pack = _port(tm, pack_frame=64)
    jpack = jax_engines["pack"]
    jpack.reset_stats()
    assert pack.generate(prompts, max_new_tokens=2) == \
        jpack.generate(prompts, max_new_tokens=2)
    st, jst = pack.stats(), jpack.stats()
    assert st["role"] == "mixed"
    assert 0.0 < st["prefill_batch_fill"] <= 1.0
    assert st["prefill_packed_frames"] >= 1
    for key in ("role", "prefill_batch_fill", "prefill_packed_frames",
                "prefill_packed_requests", "pending_handoffs", "handoffs",
                "handoff_reclaims", "handoff_pages", "handoff_ms",
                "handoff_ms_total"):
        assert key in jst, key
        if key != "handoff_ms" and key != "handoff_ms_total":
            assert st[key] == jst[key], key
    _residue_free(pack)


# ---------------------------------------------------------------------------
# the KV-page handoff
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,workers,kv", [
    ("alias", 1, "model"), ("copy", 1, "model"), ("alias", 2, "model"),
    ("copy", 2, "int8")])
def test_handoff_stream_parity(models, jax_engines, reference, mode,
                               workers, kv):
    """Greedy streams of the port's disaggregated engine equal, exactly,
    the JAX engine's sequential prefill (fp32) or its packed int8 engine,
    and the JAX engine's own disaggregated run in the same mode."""
    jm, tm = models
    prompts, ref = reference
    jeng = jax_engines["pack" if kv == "model" else "int8"]
    if kv != "model":
        ref = jeng.generate(prompts, max_new_tokens=NEW)
    eng = _port(tm, pack_frame=64, kv_cache_dtype=kv)
    with _disagg(build_disagg, eng, workers, mode=mode) as (channel, _):
        got = eng.generate(prompts, max_new_tokens=NEW)
        st = eng.stats()
        assert st["handoffs"] == len(prompts)
        assert st["handoff_reclaims"] == 0
        assert st["handoff_pages"] == sum(-(-n // 4) for n in LENS)
        assert st["pending_handoffs"] == 0
        assert channel.stats()["delivered"] == len(prompts)
    with _disagg(jax_build_disagg, jeng, workers, mode=mode):
        jgot = jeng.generate(prompts, max_new_tokens=NEW)
    assert got == ref
    assert jgot == ref
    _residue_free(eng)


def _chain_bytes(cache, chain, n_tokens):
    """Per-request K/V of the first `n_tokens` positions, gathered chain
    position by chain position (independent of page ids)."""
    out = {}
    for name, a in cache.items():
        if isinstance(a, torch.Tensor):
            a = (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
                 else a).numpy()
        a = np.asarray(a)[:, :, chain]
        out[name] = a.reshape(a.shape[0], a.shape[1], -1,
                              *a.shape[4:])[:, :, :n_tokens]
    return out


def _landed(eng, prompts, drain, build=None, mode="alias"):
    """Submit `prompts`, admit them (posting jobs when `build` wires
    workers), wait until every handoff landed WITHOUT a decode step, and
    return the page-table rows and chain bytes; then finish the run."""
    workers = []
    if build is not None:
        _, workers = build(eng, 1, mode=mode, timeout_s=WAIT_S)
    try:
        rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        with eng._step_lock:
            eng._admit()
        deadline = time.time() + WAIT_S
        while eng._pending_handoff and time.time() < deadline:
            with eng._step_lock:
                drain(eng)
            time.sleep(0.005)
        assert not eng._pending_handoff, "a handoff never landed"
        rows = [np.asarray(eng.allocator.page_table_row(r, eng.pages_per_seq))
                for r in rids]
        chains = [_chain_bytes(eng._cache, eng.allocator.chain(r),
                               int(p.size)) for r, p in zip(rids, prompts)]
        eng.run_until_idle()
        streams = [list(eng.scheduler.get(r).generated) for r in rids]
        for r in rids:
            eng.release(r)
    finally:
        for w in workers:
            w.close()
        eng._handoff_channel = None
    return rows, chains, streams


@pytest.mark.parametrize("mode", ["alias", "copy"])
def test_page_tables_and_chain_bytes_equal_jax(models, mode):
    """After the handoffs land (before any decode step): page tables
    equal a fresh JAX engine's, chain bytes within 1e-5 of JAX's and
    bit-equal to the port's own sequential prefill; the streams then equal
    JAX's."""
    jm, tm = models
    prompts = _prompts(tm.config, seed=21)
    eng = _port(tm, pack_frame=64)
    rows, chains, streams = _landed(
        eng, prompts, lambda e: e._drain_handoffs(), build_disagg, mode)
    jrows, jchains, jstreams = _landed(
        _jax(jm, pack_frame=64), prompts, lambda e: e._drain_handoffs(),
        jax_build_disagg, mode)
    srows, schains, sstreams = _landed(_port(tm, prefill_pack=False),
                                       prompts, lambda e: None)
    for r, jr in zip(rows, jrows):
        np.testing.assert_array_equal(r, jr)
    for c, jc, sc in zip(chains, jchains, schains):
        for name in c:
            np.testing.assert_allclose(c[name], jc[name], rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(c[name], sc[name])
    assert streams == jstreams == sstreams
    _residue_free(eng)


# ---------------------------------------------------------------------------
# exactly-once recovery
# ---------------------------------------------------------------------------
def test_prefill_kill_reclaims_bit_equal(models, jax_engines, reference):
    """A worker killed mid-handoff (after the device prefill, before the
    delivery): the decode side re-prefills locally; streams equal the
    fault-free reference and the JAX engine's under the same kill."""
    jm, tm = models
    prompts, ref = reference
    eng = _port(tm, pack_frame=64)
    faults.arm("serving.prefill.kill")
    with _disagg(build_disagg, eng, timeout_s=0.5) as (_, workers):
        assert eng.generate(prompts, max_new_tokens=NEW) == ref
        assert faults.fired("serving.prefill.kill") == 1
        assert not workers[0].alive
        assert workers[0].dead_cause.startswith("FaultInjected")
    assert eng.stats()["handoff_reclaims"] >= 1
    jeng = jax_engines["pack"]
    jax_faults.arm("serving.prefill.kill")
    with _disagg(jax_build_disagg, jeng, timeout_s=0.5):
        assert jeng.generate(prompts, max_new_tokens=NEW) == ref
    _residue_free(eng)
    died = events.journal().recent(component="serving",
                                   event="prefill_worker_died")
    assert died and died[-1]["jobs_failed"] >= 1


def test_handoff_drop_times_out_and_reclaims(models, jax_engines, reference):
    jm, tm = models
    prompts, ref = reference
    eng = _port(tm, pack_frame=64)
    faults.arm("serving.handoff.drop")
    with _disagg(build_disagg, eng, timeout_s=0.25) as (channel, _):
        assert eng.generate(prompts, max_new_tokens=NEW) == ref
        assert faults.fired("serving.handoff.drop") == 1
        assert channel.stats()["dropped"] == 1
    assert eng.stats()["handoff_reclaims"] == 1
    jeng = jax_engines["pack"]
    jax_faults.arm("serving.handoff.drop")
    with _disagg(jax_build_disagg, jeng, timeout_s=0.25):
        assert jeng.generate(prompts, max_new_tokens=NEW) == ref
    _residue_free(eng)
    rec = events.journal().recent(component="serving",
                                  event="handoff_reclaim")
    assert rec and rec[-1]["cause"] == "timeout"


def test_device_error_kills_worker_and_reclaims(models, reference,
                                                monkeypatch):
    """An error raised by the worker's device work (on the card, an
    asynchronous CUDA error surfacing there) is never swallowed: the
    worker dies with its cause, its jobs mark failed, and decode reclaims
    them with the fault-free streams."""
    _, tm = models
    prompts, ref = reference
    eng = _port(tm, pack_frame=64)
    real = eng.prefill_jobs

    def broken(jobs):
        if threading.current_thread().name.startswith(
                "paddle_tpu_torch.serving.prefill"):
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(jobs)

    monkeypatch.setattr(eng, "prefill_jobs", broken)
    with _disagg(build_disagg, eng, timeout_s=WAIT_S) as (_, workers):
        assert eng.generate(prompts, max_new_tokens=NEW) == ref
        assert not workers[0].alive
        assert "illegal memory access" in workers[0].dead_cause
    st = eng.stats()
    assert st["handoff_reclaims"] == len(prompts) and st["handoffs"] == 0
    _residue_free(eng)


def test_cancel_during_pending_handoff_defers_release(models):
    """cancel() of a request parked on the prefill workers must not free
    pages a worker may still write: the release defers to the handoff's
    resolution on the decode thread."""
    _, tm = models
    eng = _port(tm, pack_frame=64)
    faults.arm("serving.handoff.drop")        # keep the job pending
    with _disagg(build_disagg, eng, timeout_s=0.2):
        rid = eng.submit(_prompts(tm.config, seed=13, lens=(6,))[0],
                         max_new_tokens=8)
        eng.step()
        assert rid in eng._pending_handoff
        used = eng.allocator.used_pages
        assert eng.cancel(rid)
        eng.release(rid)                      # deferred, like cancel
        assert rid in eng._cancelled_pending
        assert eng.allocator.used_pages == used
        eng.run_until_idle()
    _residue_free(eng)


def test_handoff_events_and_metrics(models, reference):
    """Each landed handoff is one ``serving/handoff`` event; the engine's
    role and handoff series are in the registry's Prometheus text."""
    _, tm = models
    prompts, ref = reference
    eng = _port(tm, pack_frame=64, role="decode")
    events.journal().clear()
    with _disagg(build_disagg, eng, mode="copy"):
        assert eng.generate(prompts, max_new_tokens=NEW) == ref
    recs = events.journal().recent(component="serving", event="handoff")
    assert len(recs) == len(prompts)
    assert {r["mode"] for r in recs} == {"copy"}
    text = registry().prometheus_text()
    eid = eng._metrics_id
    assert f'serving_engine_role{{engine="{eid}",role="decode"}} 1' in text
    for series in ("serving_engine_handoff_ms", "serving_engine_"
                   "pending_handoffs", "serving_engine_handoff_pages_total"):
        assert f'{series}{{engine="{eid}"}}' in text, series
    pages = sum(-(-n // 4) for n in LENS)
    assert (f'serving_engine_handoff_pages_total{{engine="{eid}"}} '
            f'{pages}\n') in text
    _residue_free(eng)


def test_channel_and_worker_surface():
    """The channel's queues and counters, a cancelled job skipped at take,
    and the worker's mode check, as in JAX."""
    ch = HandoffChannel()
    jobs = [PrefillJob(rid=i, tokens=np.ones(3, np.int32),
                       page_row=np.zeros(4, np.int32), posted_t=0.0)
            for i in range(3)]
    for j in jobs:
        ch.post(j)
    jobs[1].cancelled = True
    assert [j.rid for j in ch.take_jobs(8, timeout_s=0.0)] == [0, 2]
    ch.deliver(KVHandoff(rid=0, n_pages=1, ms=0.5, worker="w"))
    assert [h.rid for h in ch.take_done(0.0)] == [0]
    assert ch.take_done(0.01) == []
    assert ch.stats() == {"posted": 3, "delivered": 1, "dropped": 0,
                          "queued": 0, "workers": 0, "workers_alive": 0}
    assert not ch.workers_alive()
    with pytest.raises(ValueError, match="alias/copy"):
        PrefillWorker(object(), ch, mode="scatter")
