"""The port's serving engine on the CPU: greedy streams and page tables
equal to the JAX ``ServingEngine`` on the same weights (mixed prompt
lengths with ``prefill_chunk=16`` so packed frames, single-chunk and
multi-chunk prefill all run), the allocator invariants, seeded sampling,
device rules, import hygiene and an HTTP round trip."""
import json
import subprocess
import sys
import http.client

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import from_paddle_tpu_params, llama_tiny_config
from paddle_tpu_torch.models.llama import LlamaForCausalLM
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PageAllocator, Request, ServingConfig,
                                      ServingEngine, sample_tokens)
from paddle_tpu_torch.serving.sampling import request_generator

ENGINE = dict(page_size=4, num_pages=64, decode_batch=4, prefill_chunk=16,
              max_seq_len=64, pack_frame=64)
# first wave: 5 and 12 share one packed frame (32 aligned rows each), 20
# is left alone in the next frame and runs chunked, 45 is longer than the
# frame and runs three chunks; 9 and 33 arrive as slots free up
PROMPT_LENS = [5, 12, 20, 45, 9, 33]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(num_key_value_heads=2))
    jm.eval()
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = from_paddle_tpu_params(named, llama_tiny_config(
        num_key_value_heads=2), device="cpu")
    return jm, tm


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, n).astype(np.int32) for n in lens]


def test_greedy_streams_and_page_tables_equal_jax_engine(models):
    jm, tm = models
    jeng = JaxServingEngine(jm, JaxServingConfig(
        prefix_sharing=False, spec_k=0, **ENGINE))
    teng = ServingEngine(tm, ServingConfig(**ENGINE), device="cpu")
    prompts = _prompts()
    jr = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    tr = [teng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.step()
    teng.step()
    # the same admissions, the same page chains
    assert [len(jeng.scheduler.running)] == [len(teng.scheduler.running)]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(
            jeng.allocator.page_table_row(a, jeng.pages_per_seq),
            teng.allocator.page_table_row(b, teng.pages_per_seq))
    teng.allocator.check_consistency()
    assert teng.stats()["prefill_packed_frames"] == \
        jeng.stats()["prefill_packed_frames"] == 1
    jeng.run_until_idle()
    teng.run_until_idle()
    want = [list(jeng.scheduler.get(r).generated) for r in jr]
    got = [list(teng.scheduler.get(r).generated) for r in tr]
    assert got == want
    teng.allocator.check_consistency()
    assert teng.allocator.free_pages == teng.num_pages - 1


def test_eviction_and_pool_pressure_keep_streams(models):
    _, tm = models
    prompts = _prompts(1, [30, 22, 14, 27])
    roomy = ServingEngine(tm, ServingConfig(**ENGINE), device="cpu")
    want = roomy.generate(prompts, max_new_tokens=8)
    tight = ServingEngine(tm, ServingConfig(**{**ENGINE, "num_pages": 21}),
                          device="cpu")
    rids = [tight.submit(p, max_new_tokens=8) for p in prompts]
    while tight.busy:
        tight.step()
        tight.allocator.check_consistency()
    assert any(tight.scheduler.get(r).evictions for r in rids)
    assert [tight.scheduler.get(r).generated for r in rids] == want


def test_seeded_temperature_sampling_reproduces(models):
    _, tm = models
    prompts = _prompts(2, [7, 19])
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=40, top_p=0.9)
    runs = [ServingEngine(tm, ServingConfig(**ENGINE, sample_seed=5),
                          device="cpu").generate(prompts, **kw)
            for _ in range(2)]
    assert runs[0] == runs[1]
    other = ServingEngine(tm, ServingConfig(**ENGINE, sample_seed=6),
                          device="cpu").generate(prompts, **kw)
    assert other != runs[0]


def test_sample_tokens_greedy_topk_topp():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0]] * 3)
    gens = [request_generator(0, i) for i in range(3)]
    greedy = sample_tokens(logits, gens, torch.zeros(3),
                           torch.zeros(3, dtype=torch.int32), torch.ones(3))
    assert greedy.tolist() == [1, 1, 1]
    for _ in range(20):
        top1 = sample_tokens(logits, gens, torch.ones(3),
                             torch.ones(3, dtype=torch.int32), torch.ones(3))
        assert top1.tolist() == [1, 1, 1]
        tiny_p = sample_tokens(logits, gens, torch.ones(3),
                               torch.zeros(3, dtype=torch.int32),
                               torch.full((3,), 1e-6))
        assert tiny_p.tolist() == [1, 1, 1]
        top2 = sample_tokens(logits, gens, torch.ones(3),
                             torch.full((3,), 2, dtype=torch.int32),
                             torch.ones(3))
        assert set(top2.tolist()) <= {1, 3}


def test_allocator_all_or_nothing_and_scheduler_limits():
    alloc = PageAllocator(5, 4)
    assert alloc.ensure("a", 9) and alloc.chain("a") == [1, 2, 3]
    assert not alloc.ensure("b", 8) and alloc.chain("b") == []
    alloc.check_consistency()
    assert alloc.free_request("a") == 3 and alloc.free_pages == 4
    sched = ContinuousBatchingScheduler(alloc, max_batch=2, max_seq_len=16)
    with pytest.raises(ValueError, match="serving_max_seq_len"):
        sched.submit(Request(prompt=np.ones(10, np.int32),
                             max_new_tokens=8))


def test_unported_options_raise(models):
    _, tm = models
    for kw in (dict(spec_k=2), dict(prefix_sharing=True),
               dict(kv_cache_dtype="int8"), dict(host_cache_mb=4),
               dict(role="decode")):
        with pytest.raises(NotImplementedError, match="not ported"):
            ServingEngine(tm, ServingConfig(**ENGINE, **kw), device="cpu")


def test_cuda_requested_without_cuda_raises(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(llama_tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tm, ServingConfig(**ENGINE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_paddle_tpu_params({}, llama_tiny_config())


def test_port_imports_no_jax_and_no_paddle_tpu():
    code = ("import sys, importlib, pkgutil, paddle_tpu_torch\n"
            "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
            "'paddle_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'paddle_tpu.')) or k == 'paddle_tpu')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_imports_no_jax():
    import ast
    import pathlib

    src = (pathlib.Path(__file__).resolve().parents[1]
           / "chip_smoke.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "paddle_tpu"}, names


def test_http_round_trip_leaves_no_threads(models):
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(**ENGINE), device="cpu")
    prompt = _prompts(3, [11])[0]
    want = eng.generate([prompt], max_new_tokens=5)[0]
    srv = eng.serve_http(0, block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=30)
        body = json.dumps({"prompt_ids": prompt.tolist(),
                           "max_new_tokens": 5})
        conn.request("POST", "/generate", body,
                     {"Content-Type": "application/json"})
        events = [json.loads(line) for line in
                  conn.getresponse().read().decode().splitlines()]
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        assert health.status == 200 and json.loads(health.read())["ok"]
        conn.close()
    finally:
        eng.shutdown_http()
    assert events[-1]["done"] and events[-1]["state"] == "finished"
    assert [e["token"] for e in events[:-1]] == want
    assert stats["device"] == "cpu" and stats["queue_depth"] == 0
