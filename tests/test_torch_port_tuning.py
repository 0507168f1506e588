"""The port's tuning plane on the CPU (``paddle_tpu_torch.tuning``): the
shared block resolver (precedence and provenance), the JSON tuning cache
(round trip, rejection of any other schema, the JAX package's included),
the autotuner's search -> persist -> load -> dispatch loop on
``device="cpu"`` (the plain versions run; CPU timings rank nothing), the
grep guard that keeps every kernel wrapper on the one resolver, and the
cross-package checks: the same flags and geometry give the same
provenance and values in both packages where a parameter means the same,
each package rejects the other's cache file, and engines built with
``page_size=0`` pick the same page size and serve the same streams."""
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.flags import _REGISTRY as JAX_REGISTRY
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.ops.pallas.fused_ce import resolve_chunks as jax_chunks
from paddle_tpu.ops.pallas.grouped_matmul import \
    pick_block_rows as jax_pick_block_rows
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.tuning import blocks as jax_blocks
import paddle_tpu_torch
from paddle_tpu_torch.core.flags import _REGISTRY, flag, set_flags
from paddle_tpu_torch.models import (GptMoeForCausalLM,
                                     from_paddle_tpu_params,
                                     gpt_moe_tiny_config, llama_tiny_config)
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_ce as fc
from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
from paddle_tpu_torch.ops.cuda import rmsnorm_kernel as rk
from paddle_tpu_torch.ops.cuda.rmsnorm_kernel import rmsnorm
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.tuning import (KERNELS, TuningCache, cache_key,
                                     last_resolution, resolve_blocks,
                                     trial_blocks, tuning_counters)
from paddle_tpu_torch.tuning.autotune import (autotune_kernel,
                                              autotune_report,
                                              candidate_blocks,
                                              candidate_kernels)
from paddle_tpu_torch.tuning.blocks import _last

TUNE_FLAGS = ("autotune", "tuning_cache_dir", "moe_block_rows",
              "rmsnorm_block_rows", "fused_ce_chunk_tokens",
              "serving_page_size")
JAX_TUNE_FLAGS = ("autotune", "tuning_cache_dir", "moe_block_rows",
                  "fused_ce_chunk_tokens", "fused_ce_chunk_vocab",
                  "serving_page_size")


@pytest.fixture(autouse=True)
def _flags_hygiene():
    """set_flags marks a flag explicitly set (the override signal of
    real-default flags like serving_page_size), so the explicit bit is
    restored with the value, in both packages."""
    saved = {n: (_REGISTRY[n].value, _REGISTRY[n].explicit)
             for n in TUNE_FLAGS}
    jsaved = {n: (JAX_REGISTRY[n].value, JAX_REGISTRY[n].explicit)
              for n in JAX_TUNE_FLAGS}
    yield
    for reg, s in ((_REGISTRY, saved), (JAX_REGISTRY, jsaved)):
        for n, (v, ex) in s.items():
            reg[n].value, reg[n].explicit = v, ex
    _last.clear()


CPU_KEY = {"platform": "cpu"}
RMS_GEOM = {"rows": 512, "d": 128}


def _resolve_rmsnorm(**geom):
    return resolve_blocks("rmsnorm", {**RMS_GEOM, **geom},
                          default=lambda _: (256,), device="cpu")


def _rms_key():
    return cache_key("rmsnorm", RMS_GEOM, **CPU_KEY)


class TestResolvePrecedence:
    def test_default_tier(self):
        res = _resolve_rmsnorm()
        assert res.provenance == "default"
        assert res.values == {"block_rows": 256}
        assert last_resolution("rmsnorm") is res

    def test_flag_override_wins(self, tmp_path):
        TuningCache(str(tmp_path)).store(_rms_key(), {"block_rows": 64})
        set_flags({"rmsnorm_block_rows": 32, "autotune": "load",
                   "tuning_cache_dir": str(tmp_path)})
        res = _resolve_rmsnorm()
        assert res.provenance == "flag"
        assert res.values == {"block_rows": 32}
        assert "FLAGS_rmsnorm_block_rows" in res.source

    def test_tuned_tier_between_flag_and_default(self, tmp_path):
        TuningCache(str(tmp_path)).store(_rms_key(), {"block_rows": 64})
        set_flags({"autotune": "load", "tuning_cache_dir": str(tmp_path)})
        res = _resolve_rmsnorm()
        assert res.provenance == "tuned"
        assert res.values == {"block_rows": 64}
        assert res.source == _rms_key()   # provenance names the entry

    def test_autotune_off_ignores_cache(self, tmp_path):
        TuningCache(str(tmp_path)).store(_rms_key(), {"block_rows": 64})
        set_flags({"autotune": "off", "tuning_cache_dir": str(tmp_path)})
        assert _resolve_rmsnorm().provenance == "default"

    def test_trial_tier_beats_flags(self):
        set_flags({"rmsnorm_block_rows": 32})
        with trial_blocks("rmsnorm", {"block_rows": 8}):
            res = _resolve_rmsnorm()
            assert res.provenance == "trial"
            assert res.values == {"block_rows": 8}
        assert _resolve_rmsnorm().provenance == "flag"

    def test_trial_is_thread_local(self):
        seen = {}
        with trial_blocks("rmsnorm", {"block_rows": 8}):
            t = threading.Thread(
                target=lambda: seen.update(p=_resolve_rmsnorm().provenance))
            t.start()
            t.join()
        assert seen["p"] == "default"

    def test_flash_entries_resolve_to_the_compiled_tile(self, tmp_path):
        """The flash kernels are compiled for one tile: their entries have
        no flag and no lattice, and resolve to the given tile without
        reading or writing the cache, even under FLAGS_autotune=search."""
        set_flags({"autotune": "search", "tuning_cache_dir": str(tmp_path)})
        trials = tuning_counters()["autotune_trials"]
        for kernel in ("flash_fwd", "flash_bwd"):
            assert not KERNELS[kernel].tunable
            res = resolve_blocks(kernel, {"seq_len": 1024}, default=(64, 32),
                                 device="cpu")
            assert (res.provenance, res.values) == \
                ("default", {"block_q": 64, "block_k": 32})
            with pytest.raises(ValueError, match="compiled for one tile"):
                candidate_blocks(kernel, {"seq_len": 1024})
        assert tuning_counters()["autotune_trials"] == trials
        assert not (tmp_path / TuningCache.FILENAME).exists()

    def test_fused_ce_partial_fills_from_lower_tier(self):
        """fused_ce's chunk_tokens flag alone IS a valid override;
        chunk_vocab, which has no flag in the port, fills from below."""
        set_flags({"fused_ce_chunk_tokens": 128})
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no partial-override warning
            res = resolve_blocks("fused_ce",
                                 {"n_tokens": 4096, "vocab": 32000},
                                 default=lambda g: (1024, 32000),
                                 device="cpu")
        assert res.provenance == "flag"
        assert res.values == {"chunk_tokens": 128, "chunk_vocab": 32000}
        assert "FLAGS_fused_ce_chunk_tokens" in res.source

    def test_flag_failing_validation_raises(self):
        """An RMSNorm row-block override the kernel cannot launch fails
        validation at the call site, naming the kernel's limit; a legal
        one wins with provenance 'flag'."""
        set_flags({"rmsnorm_block_rows": 2048})
        with pytest.raises(ValueError, match="outside the kernel's 1..1024"):
            rk.pick_block_rows(4096, 64, device="cpu")
        x = torch.zeros(4096, 64)
        with pytest.raises(ValueError, match="outside the kernel's"):
            rmsnorm(x, torch.ones(64))
        set_flags({"rmsnorm_block_rows": 64})
        assert rk.pick_block_rows(4096, 64, device="cpu") == 64
        assert last_resolution("rmsnorm").provenance == "flag"

    def test_tuned_failing_validation_degrades(self, tmp_path):
        TuningCache(str(tmp_path)).store(_rms_key(), {"block_rows": 7})
        set_flags({"autotune": "load", "tuning_cache_dir": str(tmp_path)})

        def validate(values, geometry):
            if values["block_rows"] == 7:
                raise ValueError("bad tuned value")

        with pytest.warns(UserWarning, match="re-tune"):
            res = resolve_blocks("rmsnorm", RMS_GEOM,
                                 default=lambda _: (256,),
                                 validate=validate, device="cpu")
        assert res.provenance == "default"

    def test_page_size_explicit_set_detection(self):
        """serving_page_size has a REAL default (16): only an explicit set
        counts as a flag override."""
        geom = {"num_kv_heads": 4, "head_dim": 64, "max_seq_len": 256}
        res = resolve_blocks("paged_attention", geom,
                             default=lambda g: (16,), device="cpu")
        assert res.provenance == "default"
        set_flags({"serving_page_size": 16})   # the default, set explicitly
        res = resolve_blocks("paged_attention", geom,
                             default=lambda g: (16,), device="cpu")
        assert res.provenance == "flag"
        assert res.values == {"page_size": 16}

    def test_resolution_counters_by_provenance(self):
        before = tuning_counters()
        _resolve_rmsnorm()
        set_flags({"rmsnorm_block_rows": 32})
        _resolve_rmsnorm()
        after = tuning_counters()
        assert after["resolutions_default"] == \
            before["resolutions_default"] + 1
        assert after["resolutions_flag"] == before["resolutions_flag"] + 1


class TestTuningCache:
    def test_round_trip(self, tmp_path):
        key = _rms_key()
        TuningCache(str(tmp_path)).store(key, {"block_rows": 64}, ms=1.25,
                                         trials=4)
        re = TuningCache.load(str(tmp_path))
        assert re.lookup(key) == {"block_rows": 64}
        entry = re.entries[key]
        assert entry["ms"] == 1.25 and entry["trials"] == 4
        assert entry["torch"] == torch.__version__
        assert entry["cuda"] == torch.version.cuda
        blob = json.loads((tmp_path / TuningCache.FILENAME).read_text())
        assert blob["format"] == "paddle_tpu_torch-tune1"

    def test_key_anatomy(self):
        """kernel | sorted geometry | dtype | platform: every axis moves
        the key; the platform is the card's name or cpu."""
        base = cache_key("flash_fwd", {"seq_len": 1024}, "bfloat16",
                         "NVIDIA H100 80GB HBM3")
        assert base == "flash_fwd|seq_len=1024|bfloat16|NVIDIA H100 80GB HBM3"
        assert cache_key("flash_fwd", {"seq_len": 2048}, "bfloat16",
                         "NVIDIA H100 80GB HBM3") != base
        assert cache_key("flash_fwd", {"seq_len": 1024}, "float32",
                         "NVIDIA H100 80GB HBM3") != base
        assert cache_key("flash_fwd", {"seq_len": 1024}, "bfloat16",
                         "NVIDIA H200") != base
        assert cache_key("flash_bwd", {"seq_len": 1024}, "bfloat16",
                         "NVIDIA H100 80GB HBM3") != base
        assert cache_key("rmsnorm", {"rows": 1, "d": 2}) == \
            "rmsnorm|d=2,rows=1||cpu"        # no CUDA here

    def test_other_schema_rejected_with_retune_pointer(self, tmp_path):
        path = tmp_path / TuningCache.FILENAME
        path.write_text(json.dumps({"format": "paddle_tpu_torch-tune0",
                                    "entries": {"k": {"values": {"b": 1}}}}))
        with pytest.raises(ValueError) as ei:
            TuningCache.load(str(tmp_path))
        msg = str(ei.value)
        assert "paddle_tpu_torch-tune0" in msg
        assert "paddle_tpu_torch-tune1" in msg
        assert "FLAGS_autotune=search" in msg  # the re-tune pointer

    def test_corrupt_json_rejected(self, tmp_path):
        (tmp_path / TuningCache.FILENAME).write_text("{not json")
        with pytest.raises(ValueError, match="re-run the autotuner"):
            TuningCache.load(str(tmp_path))

    def test_resolver_degrades_on_stale_cache(self, tmp_path):
        """Dispatch never crashes on a bad cache file: one warning, one
        reject counter, one journal event, heuristic blocks."""
        (tmp_path / TuningCache.FILENAME).write_text(
            json.dumps({"format": "paddle_tpu_torch-tune0", "entries": {}}))
        set_flags({"autotune": "load", "tuning_cache_dir": str(tmp_path)})
        before = tuning_counters()["tuning_cache_rejects"]
        with pytest.warns(UserWarning, match="FLAGS_autotune=search"):
            res = _resolve_rmsnorm()
        assert res.provenance == "default"
        assert tuning_counters()["tuning_cache_rejects"] == before + 1
        assert events.journal().recent(component="tuning",
                                       event="cache_reject")[-1]["dir"] \
            == str(tmp_path)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert _resolve_rmsnorm().provenance == "default"  # warned ONCE


class TestAutotuneEndToEnd:
    def test_search_persist_load_dispatch(self, tmp_path):
        """FLAGS_autotune=search times the rmsnorm row-block lattice
        through the op's real entry point (the plain versions on the CPU),
        persists the winner, and a load-mode resolve consumes it with
        provenance 'tuned' and no new trial."""
        set_flags({"autotune": "search", "tuning_cache_dir": str(tmp_path)})
        trials_before = tuning_counters()["autotune_trials"]
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(64, 128).astype(np.float32))
        w = torch.from_numpy(rs.randn(128).astype(np.float32))
        y = rmsnorm(x, w)
        res = last_resolution("rmsnorm")
        assert res is not None and res.provenance == "tuned"
        assert tuning_counters()["autotune_trials"] - trials_before == \
            len(candidate_blocks("rmsnorm", {"rows": 64, "d": 128}))
        blob = json.loads((tmp_path / TuningCache.FILENAME).read_text())
        assert blob["format"] == "paddle_tpu_torch-tune1"
        key = cache_key("rmsnorm", {"rows": 64, "d": 128}, "float32", "cpu")
        assert blob["entries"][key]["values"] == dict(res.values)
        ref = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * w
        torch.testing.assert_close(y, ref, rtol=2e-6, atol=2e-6)
        _last.clear()
        set_flags({"autotune": "load"})
        trials_before = tuning_counters()["autotune_trials"]
        assert torch.equal(rmsnorm(x, w), y)
        res2 = last_resolution("rmsnorm")
        assert res2.provenance == "tuned" and res2.values == res.values
        assert tuning_counters()["autotune_trials"] == trials_before
        recs = events.journal().recent(component="tuning", n=50)
        assert any(r["event"] == "autotune" and r["key"] == key
                   for r in recs)

    def test_report_covers_every_lattice_and_persists(self, tmp_path):
        geoms = {"fused_ce": {"n_tokens": 32, "vocab": 40},
                 "rmsnorm": {"rows": 16, "d": 8},
                 "grouped_matmul": {"n_rows": 64, "num_groups": 4},
                 "paged_attention": {"num_kv_heads": 2, "head_dim": 16,
                                     "max_seq_len": 32}}
        n_skip = len(events.journal().recent(event="autotune_skip"))
        out = autotune_report(geoms, cache_dir=str(tmp_path), device="cpu",
                              trials=1)
        assert set(geoms) == set(candidate_kernels())
        assert len(out) == 4
        assert len(events.journal().recent(event="autotune_skip")) == n_skip
        cache = TuningCache.load(str(tmp_path))
        set_flags({"autotune": "load", "tuning_cache_dir": str(tmp_path)})
        for kernel, geom in geoms.items():
            key = cache_key(kernel, geom, "", "cpu")
            assert cache.lookup(key) == out[key]["values"]
            assert [t["values"] for t in out[key]["timings"]] == \
                candidate_blocks(kernel, geom)
            assert out[key]["launches"] == {}      # plain versions only
        assert gm.pick_block_rows(64, 4, "cpu") == out[cache_key(
            "grouped_matmul", geoms["grouped_matmul"], "",
            "cpu")]["values"]["block_rows"]
        assert last_resolution("grouped_matmul").provenance == "tuned"
        assert fc.pick_chunk_tokens(32, 40, device="cpu") == \
            out[cache_key("fused_ce", geoms["fused_ce"], "",
                          "cpu")]["values"]["chunk_tokens"]
        assert last_resolution("fused_ce").provenance == "tuned"

    def test_search_inside_an_autograd_forward_keeps_the_graph(self,
                                                                tmp_path):
        """A dispatch-time search can start inside the RMSNorm Function's
        forward (grad off there): the rmsnorm runner enables grad itself
        to time the backward, and the caller's backward still yields the
        plain gradients."""
        set_flags({"autotune": "search", "tuning_cache_dir": str(tmp_path)})
        rs = np.random.RandomState(1)
        x = torch.from_numpy(rs.randn(48, 32).astype(np.float32))
        w = torch.from_numpy(rs.randn(32).astype(np.float32))
        dy = torch.from_numpy(rs.randn(48, 32).astype(np.float32))
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # no search-fail warning
            rmsnorm(xr, wr).backward(dy)
        res = last_resolution("rmsnorm")
        assert res.provenance == "tuned"
        want = rk.rmsnorm_bwd_reference(x, w, dy, 1e-6,
                                        res.values["block_rows"])
        for got, ref in zip((xr.grad, wr.grad), want):
            torch.testing.assert_close(got, ref)

    def test_candidate_lattices_are_legal(self):
        # GPT-MoE's dispatcher key: 4 x 2048 tokens x top-2 over 8 experts
        cands = candidate_blocks("grouped_matmul",
                                 {"n_rows": 16384, "num_groups": 8})
        assert [c["block_rows"] for c in cands] == [8, 16, 32, 64, 128]
        assert [c["block_rows"] for c in candidate_blocks(
            "rmsnorm", {"rows": 100, "d": 8})] == [8, 16, 32, 64, 100]
        assert [c["page_size"] for c in candidate_blocks(
            "paged_attention", {"num_kv_heads": 1, "head_dim": 64,
                                "max_seq_len": 32})] == [8, 16, 32]
        for c in candidate_blocks("fused_ce",
                                  {"n_tokens": 4096, "vocab": 32000}):
            assert 0 < c["chunk_tokens"] <= 4096
            assert c["chunk_vocab"] == fc.resolve_chunks(4096, 32000)[1]

    def test_failing_candidate_is_skipped_with_a_journal_event(self):
        before = len(events.journal().recent(event="autotune_skip"))
        won = autotune_kernel("rmsnorm", {"rows": 2048, "d": 4},
                              candidates=[{"block_rows": 4096},
                                          {"block_rows": 8}],
                              device="cpu", trials=1)
        assert won["values"] == {"block_rows": 8}
        skips = events.journal().recent(event="autotune_skip")
        assert len(skips) == before + 1
        assert skips[-1]["values"] == {"block_rows": 4096}

    def test_search_counts_trials_and_journals_to_jsonl(self, tmp_path):
        """Each timed candidate bumps the trial counter once, and the
        search's journal record (with every candidate's time) reaches a
        JSONL sink."""
        sink = str(tmp_path / "events.jsonl")
        events.journal().attach(sink)
        try:
            before = tuning_counters()["autotune_trials"]
            won = autotune_kernel("paged_attention",
                                  {"num_kv_heads": 1, "head_dim": 16,
                                   "max_seq_len": 32}, device="cpu",
                                  trials=1)
        finally:
            events.journal().detach(sink)
        assert tuning_counters()["autotune_trials"] == before + 3
        with open(sink) as fh:
            recs = [json.loads(line) for line in fh]
        rec = [r for r in recs if r["event"] == "autotune"][-1]
        assert rec["component"] == "tuning"
        assert rec["values"] == won["values"]
        assert [t["values"]["page_size"] for t in rec["timings"]] == \
            [8, 16, 32]

    def test_dropless_dispatch_reads_the_tuned_key(self, tmp_path):
        """The dropless dispatcher resolves its bucket alignment at (token
        copies, experts) = (batch x seq x top-k, E): a tuned entry at that
        key sets the layout's block rows."""
        cfg = gpt_moe_tiny_config(moe_dispatch="dropless")
        model = GptMoeForCausalLM(cfg, device="cpu", seed=0).eval()
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            1, cfg.vocab_size, (2, 16)))
        geom = {"n_rows": 2 * 16 * cfg.top_k, "num_groups": cfg.num_experts}
        TuningCache(str(tmp_path)).store(
            cache_key("grouped_matmul", geom, "", "cpu"), {"block_rows": 16})
        set_flags({"autotune": "load", "tuning_cache_dir": str(tmp_path)})
        with torch.no_grad():
            model(ids)
        assert model.moe_layers()[0].last_layout[1] == 16
        res = last_resolution("grouped_matmul")
        assert res.provenance == "tuned"
        assert res.source == cache_key("grouped_matmul", geom, "", "cpu")


KERNEL_FILES = {
    "grouped_matmul.py": ("grouped_matmul",),
    "fused_ce.py": ("fused_ce",),
    "rmsnorm_kernel.py": ("rmsnorm",),
    "paged_attention.py": ("paged_attention",),
}


class TestSharedResolverGuard:
    """Every ops/cuda wrapper with a block knob resolves through
    tuning.blocks.resolve_blocks; a second copy of the pick logic fails
    here."""

    def test_all_kernels_resolve_through_the_shared_helper(self):
        d = os.path.dirname(os.path.abspath(fa.__file__))
        for fname, kernels in KERNEL_FILES.items():
            if fname == "paged_attention.py":
                # the page size resolves once, at engine construction
                import paddle_tpu_torch.serving.engine as eng

                path = eng.__file__
            else:
                path = os.path.join(d, fname)
            with open(path) as fh:
                assert "resolve_blocks" in fh.read(), (
                    f"{fname}: block pick not routed through "
                    f"tuning.blocks.resolve_blocks")
            for k in kernels:
                assert k in KERNELS
        assert {k for ks in KERNEL_FILES.values() for k in ks} == \
            set(candidate_kernels())

    def test_override_flags_are_read_only_in_blocks(self):
        """No module reads a block override flag itself (a second copy of
        the flag tier); the engine reads serving_page_size only as the
        default it hands the resolver."""
        root = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
        knobs = [f for spec in KERNELS.values() for f in spec.flags
                 if f is not None and f != "serving_page_size"]
        offenders = []
        for dirpath, _, files in os.walk(root):
            for fname in files:
                if fname.endswith(".py"):
                    path = os.path.join(dirpath, fname)
                    with open(path) as fh:
                        text = fh.read()
                    if any(f'flag("{f}")' in text for f in knobs):
                        offenders.append(os.path.relpath(path, root))
        assert offenders == [], offenders

    def test_kernel_registry_covers_the_contract(self):
        assert set(KERNELS) == set(jax_blocks.KERNELS)
        for name, spec in KERNELS.items():
            assert spec.params == jax_blocks.KERNELS[name].params
            assert len(spec.params) == len(spec.flags) == len(spec.auto)
            for f in spec.flags:
                if f is not None:
                    flag(f)  # registered


# ---------------------------------------------------------------------------
# cross-package
# ---------------------------------------------------------------------------

def _both_set(flags):
    set_flags(flags)
    jax_set_flags(flags)


def _jax_resolve(kernel, geometry, default):
    return jax_blocks.resolve_blocks(kernel, geometry, default=default)


@pytest.mark.parametrize("flags", [{}, {"moe_block_rows": 16}])
@pytest.mark.parametrize("n_rows,groups", [(17408, 8), (1000, 8), (64, 4)])
def test_grouped_matmul_resolves_as_jax(flags, n_rows, groups):
    _both_set(flags)
    assert gm.pick_block_rows(n_rows, groups, "cpu") == \
        jax_pick_block_rows(n_rows, groups)
    assert last_resolution("grouped_matmul").provenance == \
        jax_blocks.last_resolution("grouped_matmul").provenance


@pytest.mark.parametrize("flags", [{}, {"fused_ce_chunk_tokens": 96}])
@pytest.mark.parametrize("n,v", [(4096, 32000), (100, 1000)])
def test_fused_ce_chunk_tokens_resolves_as_jax(flags, n, v):
    _both_set(flags)
    ct = fc.pick_chunk_tokens(n, v, device="cpu")
    port = last_resolution("fused_ce")
    jax_res = _jax_resolve("fused_ce", {"n_tokens": n, "vocab": v},
                           lambda g: jax_chunks(n, v))
    assert port.provenance == jax_res.provenance
    assert ct == min(jax_res.values["chunk_tokens"], n)
    assert port.values == jax_res.values


@pytest.mark.parametrize("flags", [{}, {"serving_page_size": 8}])
def test_page_size_resolves_as_jax(flags):
    _both_set(flags)
    geom = {"num_kv_heads": 2, "head_dim": 16, "max_seq_len": 64}
    port = resolve_blocks("paged_attention", geom,
                          default=lambda g: (flag("serving_page_size"),),
                          device="cpu")
    jax_res = _jax_resolve("paged_attention", geom, lambda g: (16,))
    assert (port.provenance, port.values) == \
        (jax_res.provenance, jax_res.values)


def test_tuned_tier_agrees_across_packages(tmp_path):
    """Each package reads its own cache (its schema, its platform): the
    same tuned values give the same provenance and values."""
    geom = {"n_rows": 1024, "num_groups": 8}
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    TuningCache(str(port_dir)).store(
        cache_key("grouped_matmul", geom, "", "cpu"), {"block_rows": 32})
    jax_blocks.TuningCache(str(jax_dir)).store(
        jax_blocks.cache_key("grouped_matmul", geom), {"block_rows": 32})
    set_flags({"autotune": "load", "tuning_cache_dir": str(port_dir)})
    jax_set_flags({"autotune": "load", "tuning_cache_dir": str(jax_dir)})
    assert gm.pick_block_rows(1024, 8, "cpu") == 32 == \
        jax_pick_block_rows(1024, 8)
    assert last_resolution("grouped_matmul").provenance == "tuned" == \
        jax_blocks.last_resolution("grouped_matmul").provenance


def test_each_package_rejects_the_others_cache(tmp_path):
    geom = {"n_rows": 1024, "num_groups": 8}
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    TuningCache(str(port_dir)).store(
        cache_key("grouped_matmul", geom, "", "cpu"), {"block_rows": 32})
    jax_blocks.TuningCache(str(jax_dir)).store(
        jax_blocks.cache_key("grouped_matmul", geom), {"block_rows": 32})
    with pytest.raises(ValueError, match="FLAGS_autotune=search") as ei:
        jax_blocks.TuningCache.load(str(port_dir))
    assert "paddle_tpu_torch-tune1" in str(ei.value)
    with pytest.raises(ValueError, match="FLAGS_autotune=search") as ei:
        TuningCache.load(str(jax_dir))
    assert "'paddle_tpu-tune1'" in str(ei.value)
    # dispatch on the JAX file: the heuristic, one warning
    set_flags({"autotune": "load", "tuning_cache_dir": str(jax_dir)})
    with pytest.warns(UserWarning, match="re-tune"):
        assert gm.pick_block_rows(1024, 8, "cpu") == 128
    assert last_resolution("grouped_matmul").provenance == "default"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert gm.pick_block_rows(1024, 8, "cpu") == 128


ENGINE = dict(page_size=0, num_pages=64, decode_batch=4, prefill_chunk=16,
              max_seq_len=64, pack_frame=64)


def test_engines_resolve_the_same_page_size_and_serve_alike():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(num_key_value_heads=2))
    jm.eval()
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(
        num_key_value_heads=2), device="cpu")
    _both_set({"serving_page_size": 8})
    jeng = JaxServingEngine(jm, JaxServingConfig(
        prefix_sharing=False, spec_k=0, **ENGINE))
    teng = ServingEngine(tm, ServingConfig(prefix_sharing=False, **ENGINE),
                         device="cpu")
    assert teng.page_size == jeng.page_size == 8
    assert last_resolution("paged_attention").provenance == "flag"
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 256, n).astype(np.int32) for n in (5, 12, 20)]
    jr = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    tr = [teng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.step()
    teng.step()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(
            jeng.allocator.page_table_row(a, jeng.pages_per_seq),
            teng.allocator.page_table_row(b, teng.pages_per_seq))
    jeng.run_until_idle()
    teng.run_until_idle()
    assert [list(teng.scheduler.get(r).generated) for r in tr] == \
        [list(jeng.scheduler.get(r).generated) for r in jr]
