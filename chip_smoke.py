#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--layers N]

Builds the port's hand-written Hopper kernels from ``paddle_tpu_torch/ops/
cuda/csrc`` (nvcc, sm_90a) and runs, in order:

 1. the card's name and power limit (nvidia-smi) and the kernel build time;
 2. each kernel against its plain PyTorch version (fp32 math on the same
    inputs) on the card, at the serving path's shapes, the chunked-prefill
    call's strided page-gather views included: every output row (one head
    of one query, over head_dim) must hold max |err| <= RTOL * max |ref|
    of that row + 1e-6 (bf16 RTOL 2^-7: rounding the output to bf16 alone
    costs up to 2^-8 of the value; fp32 RTOL 1e-4), and the whole output
    max |err| <= 1e-2 (bf16) or 1e-4 (fp32); then median ms, the plain
    version's and the library call's ms, and the bound (bytes over 3.35
    TB/s or flops over the peak of the input type, whichever is larger).
    The flash backward's dq, dk and dv (fp32 outputs of bf16 or fp32
    inputs) are held per row the same way against
    ``flash_attention_bwd_reference`` on the same (q, k, v, out, lse, dO);
    the CE statistics kernel's m, lse = m + log s and target logit t within
    1e-3 of ``ce_stats_reference`` (fp32 math on the same inputs; the sums
    run over H = 4096 products in another order) and the logit sum sl
    within 1e-5 * V of it (a sum over V logits);
 3. the engine on CUDA (kernels) against the engine on the CPU (plain
    versions): a 2-layer fp32 GQA model with the same weights serves the
    same prompts; the greedy streams must be equal;
 4. the LLaMA-2-7B geometry (32 layers, hidden 4096, 32 heads, bf16, random
    weights from --seed) serving 8 greedy requests of mixed prompt length
    (packed, single-chunk and multi-chunk prefill), with every kernel's
    launch count read around this run; prints prefill and decode tokens/s,
    time to first token and peak memory, then profiles (torch.profiler)
    one 3000-token prefill and a few decode steps outside that run;
 5. HTTP: serve_http, one streamed POST /generate, clean shutdown;
 6. training on CUDA (kernels) against training on the CPU (plain
    versions): a 2-layer fp32 GQA model with the same weights takes 3
    ``TrainStep`` steps of AdamW on the same packed dict batch; per-step
    losses within 1e-4 relative, last gradients within 1e-3 of each
    tensor's max |grad|, final parameters within lr (an element whose
    gradient is within rounding of zero may take another Adam step);
 7. training at the LLaMA-2-7B width (hidden 4096, 32/32 heads,
    intermediate 11008, vocab 32000, seq 4096, batch 1, bf16, random
    weights from --seed) and 3 decoder layers (the state of the full 32
    does not fit in 80 GB): AdamW(lr 1e-4, wd 0.01,
    multi_precision) with the fused head loss on one fixed batch, 2 warm-up
    and 8 timed steps; prints median step ms, tokens/s, MFU, peak memory,
    launches per step and the losses (finite, falling), checks that the
    attention projections got gradients, then profiles one more step.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``; exits non-zero (and prints no
result) without CUDA, outside the repository, or when any phase fails.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
TOL = {"bfloat16": 1e-2, "float32": 1e-4}        # whole output, abs
RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}  # per row, of max |ref|
ATOL = 1e-6
CE_TOL = 1e-3              # m, lse, t of ce_stats vs its plain version
CE_SL_TOL = 1e-5           # sl, times V
NEW_TOKENS = 32                                  # per full-width request
TRAIN_LAYERS = 3           # full-width training: the 32-layer state
TRAIN_SEQ = 4096           # (about 108 GB) does not fit in 80 GB
TRAIN_LR = 1e-4
MOE_BATCH = 4              # GPT-MoE: 4 x 2048 tokens, 2 warm-up steps
MOE_STEPS = 8              # and 8 timed ones
REPO = os.path.dirname(os.path.abspath(__file__))


def _cuda_ms(fn, reps=15, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _compare(out, ref, dtype_name):
    """max |err| over the output, and the row check: each row (the last
    axis) within RTOL of its own max |ref| (plus ATOL), so long-context
    rows, whose outputs are small, are held as tightly as short ones."""
    err = (out.float() - ref).abs()
    row_err, row_max = err.amax(-1), ref.abs().amax(-1)
    rel = (row_err / row_max.clamp_min(ATOL)).max().item()
    rows_ok = bool((row_err <= RTOL[dtype_name] * row_max + ATOL).all())
    max_abs = err.max().item()
    return dict(max_abs_err=max_abs, max_rel_err=rel, tol=TOL[dtype_name],
                rtol=RTOL[dtype_name],
                ok=rows_ok and max_abs <= TOL[dtype_name])


def _rand(gen, shape, dtype, device="cuda"):
    import torch

    # std 0.5 keeps |values| < 4, where bf16 rounding stays < 2^-8 * 2
    return (torch.randn(shape, generator=gen, device=device) * 0.5).to(dtype)


def flash_cases(gen):
    """(label, kwargs) at the serving path's shapes."""
    import torch

    bf = torch.bfloat16
    frame_lens = [17, 60, 100, 30]       # a 256-row packed frame
    seg = torch.full((1, 256), 8, dtype=torch.int32)
    off = 0
    for j, n in enumerate(frame_lens):
        seg[0, off:off + n] = j
        off += -(-n // 32) * 32
    return [
        ("causal_s256", dict(s=256, hq=32, hkv=32, dtype=bf)),
        ("causal_s2048", dict(s=2048, hq=32, hkv=32, dtype=bf)),
        ("gqa_s2048", dict(s=2048, hq=32, hkv=8, dtype=bf)),
        ("packed_s256_4seg", dict(s=256, hq=32, hkv=32, dtype=bf,
                                  seg=seg.cuda())),
        ("causal_s256_fp32", dict(s=256, hq=32, hkv=32,
                                  dtype=torch.float32)),
        ("causal_s2048_fp32", dict(s=2048, hq=32, hkv=32,
                                   dtype=torch.float32)),
        # the chunked-prefill call of the 3000-token prompt's last chunk:
        # a 4096-row ctx_pad frame, q zero outside rows 2816..3071, k/v
        # strided views of a page gather (models/llama.py forward_decode)
        ("chunk_ctx4096", dict(s=4096, hq=32, hkv=32, dtype=bf,
                               chunk=(2816, 256))),
        ("chunk_ctx4096_fp32", dict(s=4096, hq=32, hkv=32,
                                    dtype=torch.float32, chunk=(2816, 256))),
        # GPT-MoE attention: batch 4, 16 heads of 64
        ("causal_s2048_d64_b4", dict(s=2048, hq=16, hkv=16, dtype=bf, d=64,
                                     b=4)),
    ]


def _chunk_prefill_qkv(gen, s, hq, hkv, d, dtype, chunk, ps=16):
    """q/k/v laid out as LlamaAttention.forward_decode hands them to the
    flash kernel for one prefill chunk: k/v gathered from a paged pool
    through a shuffled page table and permuted (not copied) to [1, S, H,
    D]; q a zero [1, S, H, D] frame holding the chunk's rows."""
    import torch

    pages = s // ps
    ck = _rand(gen, (hkv, pages + 1, ps, d), dtype)
    cv = _rand(gen, (hkv, pages + 1, ps, d), dtype)
    pt = (torch.randperm(pages, generator=gen, device="cuda") + 1)[None]
    pos = torch.arange(s, device="cuda")
    pidx, slot = pt[:, pos // ps], (pos % ps).expand(1, s)
    k = ck[:, pidx, slot].permute(1, 2, 0, 3)
    v = cv[:, pidx, slot].permute(1, 2, 0, 3)
    q = torch.zeros((1, s, hq, d), dtype=dtype, device="cuda")
    c0, n = chunk
    q[:, c0:c0 + n] = _rand(gen, (1, n, hq, d), dtype)
    return q, k, v


def run_flash_case(gen, s, hq, hkv, dtype, seg=None, chunk=None, d=128, b=1):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    if chunk is None:
        q = _rand(gen, (b, s, hq, d), dtype)
        k = _rand(gen, (b, s, hkv, d), dtype)
        v = _rand(gen, (b, s, hkv, d), dtype)
    else:
        q, k, v = _chunk_prefill_qkv(gen, s, hq, hkv, d, dtype, chunk)
        if k.is_contiguous():
            raise AssertionError("the chunked-prefill case lost its "
                                 "strided k/v views")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(),
                                                v.float(), causal=True,
                                                segment_ids=seg)
    dname = str(dtype).replace("torch.", "")
    cmp = _compare(out, ref, dname)
    lse_err = (lse - ref_lse).abs().max().item()
    del ref, ref_lse
    ms = _cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                                 segment_ids=seg))
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids=seg), reps=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if seg is None:
        lib = lambda: tF.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=True, enable_gqa=True)
        pairs = s * (s + 1) // 2
    else:
        mask = (seg[:, None, :, None] == seg[:, None, None, :]) & torch.ones(
            s, s, dtype=torch.bool, device=q.device).tril()
        lib = lambda: tF.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
        pairs = int(mask.sum().item())
    library_ms = _cuda_ms(lib)
    item = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * item \
        + lse.numel() * 4 + (seg.numel() * 4 if seg is not None else 0)
    flops = 4 * d * hq * pairs * b
    bound_ms, bound_by = _bound(nbytes, flops, dname)
    return dict(cmp, lse_err=lse_err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=flops / ms / 1e9, ok=cmp["ok"] and lse_err <= 1e-3)


def paged_cases():
    import torch

    lens = [0, 1, 17, 4095, 100, 2048, 300, 3000]
    bf = torch.bfloat16
    return [
        ("decode_b8_h32", dict(t=1, hq=32, hkv=32, lens=lens, dtype=bf)),
        ("decode_b8_gqa8", dict(t=1, hq=32, hkv=8, lens=lens, dtype=bf)),
        ("frame3_gqa8", dict(t=3, hq=32, hkv=8, lens=lens[:-1] + [4093],
                             dtype=bf)),
        ("decode_b8_fp32", dict(t=1, hq=32, hkv=32, lens=lens,
                                dtype=torch.float32)),
    ]


def run_paged_case(gen, t, hq, hkv, lens, dtype, d=128, ps=16, pages=256):
    import torch

    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    b = len(lens)
    num_pages = b * pages + 1
    kp = _rand(gen, (hkv, num_pages, ps, d), dtype)
    vp = _rand(gen, (hkv, num_pages, ps, d), dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    pt = perm[:b * pages].view(b, pages).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, hq, d) if t == 1 else (b, t, hq, d), dtype)
    out = pa.paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), pt,
                                       ln)
    dname = str(dtype).replace("torch.", "")
    cmp = _compare(out, ref, dname)
    ms = _cuda_ms(lambda: pa.paged_attention(q, kp, vp, pt, ln))
    plain_ms = _cuda_ms(lambda: pa.paged_attention_reference(
        q, kp, vp, pt, ln), reps=5)
    item = q.element_size()
    # the keys each row needs (len + T - 1), not whole pages; a page id is
    # read once per page those keys touch
    keys = [n + t - 1 if n > 0 else 0 for n in lens]
    pages_read = sum(-(-n // ps) for n in keys)
    nbytes = (2 * q.numel() * item + 2 * sum(keys) * d * hkv * item
              + pages_read * 4 + b * 4)
    flops = 4 * d * hq * sum(n + i for n in lens if n > 0 for i in range(t))
    bound_ms, bound_by = _bound(nbytes, flops, dname)
    return dict(cmp, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, gbps=nbytes / ms / 1e6)


def _device_ms_by_kernel(fn, reps=5):
    """{kernel name: device ms per call of `fn`} from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def _kernel_ms(by_kernel, name):
    hits = [ms for key, ms in by_kernel.items() if name in key]
    if len(hits) != 1:
        raise AssertionError(f"profiler found {len(hits)} kernels named "
                             f"{name}: {sorted(by_kernel)}")
    return hits[0]


def flash_bwd_cases(gen):
    """(label, kwargs) at the training path's shapes."""
    import torch

    bf = torch.bfloat16
    seg = torch.zeros((1, 2048), dtype=torch.int32)
    for j, start in enumerate((300, 1000, 1700)):   # 4 packed documents
        seg[0, start:] = j + 1
    return [
        ("causal_s4096", dict(s=4096, hq=32, hkv=32, dtype=bf)),
        ("gqa_s2048", dict(s=2048, hq=32, hkv=8, dtype=bf)),
        ("packed_s2048_4seg", dict(s=2048, hq=32, hkv=32, dtype=bf,
                                   seg=seg.cuda())),
        ("causal_s512_fp32", dict(s=512, hq=32, hkv=32,
                                  dtype=torch.float32)),
        ("causal_s2048_d64_b4", dict(s=2048, hq=16, hkv=16, dtype=bf, d=64,
                                     b=4)),
    ]


def run_flash_bwd_case(gen, s, hq, hkv, dtype, seg=None, d=128, b=1):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    q = _rand(gen, (b, s, hq, d), dtype)
    k = _rand(gen, (b, s, hkv, d), dtype)
    v = _rand(gen, (b, s, hkv, d), dtype)
    do = _rand(gen, (b, s, hq, d), dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                   segment_ids=seg)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        causal=True, segment_ids=seg)
    dname = str(dtype).replace("torch.", "")
    cmp = {n: _compare(g, r, dname) for n, g, r in zip(("dq", "dk", "dv"),
                                                       grads, refs)}
    del grads, refs
    torch.cuda.empty_cache()
    call = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, causal=True, segment_ids=seg)
    ms = _cuda_ms(call)
    split = _device_ms_by_kernel(call)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, segment_ids=seg), reps=3,
        warmup=1)
    torch.cuda.empty_cache()
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    if seg is None:
        kw = dict(is_causal=True)
        pairs = s * (s + 1) // 2
    else:
        mask = (seg[:, None, :, None] == seg[:, None, None, :]) & torch.ones(
            s, s, dtype=torch.bool, device=q.device).tril()
        kw = dict(attn_mask=mask)
        pairs = int(mask.sum().item())
    fwd = lambda: tF.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, enable_gqa=True, **kw)
    fwd_bwd = lambda: torch.autograd.grad(fwd(), (qh, kh, vh),  # noqa: E731
                                          doh)
    library_ms = _cuda_ms(fwd_bwd) - _cuda_ms(fwd)
    item = q.element_size()
    seg_bytes = seg.numel() * 4 if seg is not None else 0
    qo_bytes = q.numel() * item             # q, out, do: one [B, S, Hq, D]
    kv_bytes = k.numel() * item
    # least work: the dq kernel needs S = QK^T, dP = dO V^T and dQ = dS K
    # (3 products); the dkv kernel S, dP, dV = P^T dO and dK = dS^T Q (4);
    # each product is 2 D flops per visible (query, key) pair and head.
    # Each kernel is set against its own plain version; no library call
    # computes dq alone or dk, dv alone, so its library_ms is None.
    rows = {}
    for name, products, nbytes, plain in (
            ("dq", 3, 3 * qo_bytes + 2 * kv_bytes + lse.numel() * 8
             + seg_bytes + q.numel() * 4, fa.flash_attention_bwd_dq_reference),
            ("dkv", 4, 3 * qo_bytes + 2 * kv_bytes + lse.numel() * 8
             + seg_bytes + 2 * k.numel() * 4,
             fa.flash_attention_bwd_dkv_reference)):
        flops = 2 * products * d * hq * pairs * b
        bound_ms, bound_by = _bound(nbytes, flops, dname)
        kms = _kernel_ms(split, f"flash_bwd_{name}_kernel")
        kplain_ms = _cuda_ms(lambda: plain(  # noqa: B023
            q, k, v, out, lse, do, causal=True, segment_ids=seg), reps=3,
            warmup=1)
        torch.cuda.empty_cache()
        errs = [cmp["dq"]] if name == "dq" else [cmp["dk"], cmp["dv"]]
        rows[name] = dict(
            ms=kms, plain_ms=kplain_ms, library_ms=None, bound_ms=bound_ms,
            bound_by=bound_by, flops=flops, tflops=flops / kms / 1e9,
            max_abs_err=max(c["max_abs_err"] for c in errs),
            max_rel_err=max(c["max_rel_err"] for c in errs))
    ok = all(c["ok"] for c in cmp.values())
    # the whole function's least work: 5 products (S, dP, dV, dQ, dK)
    bound_ms, bound_by = _bound(
        3 * qo_bytes + 2 * kv_bytes + lse.numel() * 4 + seg_bytes
        + (q.numel() + 2 * k.numel()) * 4, 10 * d * hq * pairs * b, dname)
    return dict(cmp=cmp, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                kernels=rows, tol=TOL[dname], rtol=RTOL[dname])


def ce_cases():
    import torch

    bf = torch.bfloat16
    return [
        ("n4096_h4096_v32000", dict(n=4096, h=4096, v=32000, dtype=bf)),
        ("ragged_n1000_ignored", dict(n=1000, h=4096, v=32000, dtype=bf,
                                      ignored=True)),
        ("fp32_n300_h256_v1000", dict(n=300, h=256, v=1000,
                                      dtype=torch.float32, ignored=True)),
    ]


def run_ce_case(gen, n, h, v, dtype, ignored=False):
    import torch

    from paddle_tpu_torch.ops.cuda import fused_ce as fc

    # hidden states after RMSNorm (unit scale) against a head of std 0.02,
    # as in the model
    x = torch.randn((n, h), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((v, h), generator=gen, device="cuda") * 0.02).to(dtype)
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    if ignored:
        labels[::7] = -100
        labels[3] = v                    # past the vocab: no column matches
    got = fc.ce_stats(x, w, labels)
    torch.cuda.synchronize()
    ref = fc.ce_stats_reference(x, w, labels)
    lse_g, lse_r = got[0] + torch.log(got[1]), ref[0] + torch.log(ref[1])
    errs = {name: (a - b).abs().max().item() for name, a, b in (
        ("m", got[0], ref[0]), ("lse", lse_g, lse_r), ("t", got[2], ref[2]),
        ("sl", got[3], ref[3]))}
    ok = (max(errs["m"], errs["lse"], errs["t"]) <= CE_TOL
          and errs["sl"] <= CE_SL_TOL * v)
    ms = _cuda_ms(lambda: fc.ce_stats(x, w, labels), reps=5)
    plain_ms = _cuda_ms(lambda: fc.ce_stats_reference(x, w, labels), reps=3,
                        warmup=1)
    safe = labels.clamp(0, v - 1)[:, None]

    def library():
        logits = (x @ w.T).float()
        return (logits.amax(-1), torch.logsumexp(logits, -1),
                logits.gather(1, safe)[:, 0], logits.sum(-1))

    library_ms = _cuda_ms(library, reps=5)
    flops = 2 * n * v * h
    nbytes = (n + v) * h * x.element_size() + n * 4 + 4 * n * 4
    bound_ms, bound_by = _bound(nbytes, flops,
                                str(dtype).replace("torch.", ""))
    return dict(errs=errs, max_abs_err=max(errs["m"], errs["lse"],
                                           errs["t"]),
                ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                tflops=flops / ms / 1e9)


def _dispatch_layout(gen, n_tokens, experts, k):
    """The dropless dispatcher's bucket gids for the top-k of random gate
    logits: ([M] int32, block_rows, routed rows)."""
    import torch

    from paddle_tpu_torch.incubate.distributed.models.moe.dropless import \
        ragged_layout
    from paddle_tpu_torch.ops.cuda.grouped_matmul import pick_block_rows

    logits = torch.randn((n_tokens, experts), generator=gen, device="cuda")
    topi = logits.topk(k, dim=-1).indices.reshape(-1)
    bm = pick_block_rows(n_tokens * k, experts)
    return ragged_layout(topi, experts, bm)[3], bm, n_tokens * k


def _unaligned_layout(gen, rows, groups, trash):
    """A grouped layout whose groups start anywhere (one of them empty),
    then `trash` rows of id G: 8-row blocks span several groups."""
    import torch

    cuts = torch.sort(torch.randint(0, rows - trash + 1, (groups - 1,),
                                    generator=gen, device="cuda"))[0]
    cuts[1] = cuts[0]                           # group 1 is empty
    gids = torch.searchsorted(cuts, torch.arange(rows - trash, device="cuda"),
                              right=True)
    return torch.cat([gids, torch.full((trash,), groups,
                                       device="cuda")]).to(torch.int32)


def _group_offsets(gids, groups):
    import torch

    return torch.searchsorted(gids, torch.arange(groups, dtype=torch.int32,
                                                 device=gids.device),
                              right=True).to(torch.int32)


def gmm_layouts(gen):
    """{name: (gids, block_rows, rows the data needs, groups)}: the
    full-width dispatcher layout (4 x 2048 tokens, top-2 of 8 experts) and a
    1000-row unaligned layout for block_rows 8."""
    full, bm, routed = _dispatch_layout(gen, 4 * 2048, 8, 2)
    unal = _unaligned_layout(gen, 1000, 8, 37)
    return {"dispatch": (full, bm, routed, 8),
            "unaligned_bm8": (unal, 8, int((unal < 8).sum()), 8)}


def gmm_fwd_cases(layouts):
    """(label, layout, x shape/dtype/std, w shape/dtype, transposed): the
    main path's four products at full width (h1 and y in bf16 on the tensor
    cores; the backward's dx in fp32 over w^T) and the unaligned layout.
    Activations are unit scale, weights std 0.02 and gradients std 1e-3, as
    in training."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("h1_bf16", "dispatch", 1024, 4096, bf, 1.0, False),
        ("y_bf16", "dispatch", 4096, 1024, bf, 1.0, False),
        ("dx_of_y_fp32", "dispatch", 1024, 4096, f32, 1e-3, True),
        ("dx_of_h1_fp32", "dispatch", 4096, 1024, f32, 1e-3, True),
        ("unaligned_bm8_bf16", "unaligned_bm8", 256, 512, bf, 1.0, False),
        ("unaligned_bm8_fp32", "unaligned_bm8", 256, 512, f32, 1.0, False),
    ]


def _grouped_mm_ms(x, w, gids, groups):
    """torch._grouped_mm (bf16 out) over the same groups, where the card's
    torch has it; (ms, note)."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm missing"
    offs = _group_offsets(gids, groups)
    wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
    try:
        return _cuda_ms(lambda: torch._grouped_mm(x, wt, offs=offs)), \
            "torch._grouped_mm, bf16 output"
    except Exception as e:       # reported, never on the port's path
        return None, f"torch._grouped_mm failed: {e!r}"[:200]


def _grouped_mm_dw_ms(x, dy, gids, groups):
    """torch._grouped_mm in its 2-D x 2-D mode (x^T [d, M] against dy
    [M, h], offsets along M, out [G, d, h]) with dy cast to bf16 outside
    the timing and a bf16 output; (ms, note)."""
    import torch

    if not hasattr(torch, "_grouped_mm") or x.dtype != torch.bfloat16:
        return None, "none: torch._grouped_mm missing or x not bf16"
    offs = _group_offsets(gids, groups)
    dyb = dy.to(torch.bfloat16)
    try:
        return _cuda_ms(lambda: torch._grouped_mm(x.T, dyb, offs=offs)), \
            "torch._grouped_mm, bf16 dy, bf16 output"
    except Exception as e:       # reported, never on the port's path
        return None, f"torch._grouped_mm failed: {e!r}"[:200]


def run_gmm_fwd_case(gen, layout, d, h, dtype, std, transposed):
    import torch

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    gids, _, need_rows, groups = layout
    m = gids.shape[0]
    x = (torch.randn((m, d), generator=gen, device="cuda") * std).to(dtype)
    if transposed:              # dx: the fp32 copy of w^T the VJP hands in
        w = (torch.randn((groups, h, d), generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16).transpose(1, 2).float().contiguous()
    else:
        w = (torch.randn((groups, d, h), generator=gen, device="cuda")
             * 0.02).to(dtype)
    out = gm.gmm_fwd(x, w, gids)
    torch.cuda.synchronize()
    ref = gm.grouped_matmul_reference(x, w, gids)
    cmp = _compare(out, ref, "float32")
    trash_zero = bool((out[gids == groups] == 0).all())
    del ref
    ms = _cuda_ms(lambda: gm.gmm_fwd(x, w, gids))
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_reference(x, w, gids),
                        reps=3, warmup=1)
    library_ms, library = (None, "none: no PyTorch call computes an fp32 "
                           "grouped product")
    if dtype == torch.bfloat16:
        library_ms, library = _grouped_mm_ms(x, w, gids, groups)
    dname = str(dtype).replace("torch.", "")
    flops = 2 * need_rows * d * h
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + m * h * 4 + m * 4)
    bound_ms, bound_by = _bound(nbytes, flops, dname)
    return dict(cmp, ok=cmp["ok"] and trash_zero, trash_zero=trash_zero,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library=library, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, tflops=flops / ms / 1e9, m=m, d=d, h=h)


def gmm_dw_cases():
    import torch

    bf = torch.bfloat16
    return [("dw1_bf16x", "dispatch", 1024, 4096, bf),
            ("dw2_bf16x", "dispatch", 4096, 1024, bf),
            ("unaligned_bm8_bf16x", "unaligned_bm8", 256, 512, bf),
            ("unaligned_bm8_fp32x", "unaligned_bm8", 256, 512,
             torch.float32)]


def run_gmm_dw_case(gen, layout, d, h, dtype, aligned):
    import torch

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    gids, _, need_rows, groups = layout
    m = gids.shape[0]
    x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((m, h), generator=gen, device="cuda") * 1e-3
    dw = gm.gmm_dw(x, dy, gids, groups)
    torch.cuda.synchronize()
    ref = gm.grouped_matmul_dw_reference(x, dy, gids, groups)
    cmp = _compare(dw, ref, "float32")
    present = torch.isin(torch.arange(groups, device="cuda"), gids)
    empty_zero = bool((dw[~present] == 0).all())
    del ref
    ms = _cuda_ms(lambda: gm.gmm_dw(x, dy, gids, groups))
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_dw_reference(
        x, dy, gids, groups), reps=3, warmup=1)
    library_ms, library = (_grouped_mm_dw_ms(x, dy, gids, groups) if aligned
                           else (None, "not timed: groups not block-aligned"))
    flops = 2 * need_rows * d * h
    nbytes = (x.numel() * x.element_size() + dy.numel() * 4 + m * 4
              + groups * d * h * 4)
    bound_ms, bound_by = _bound(nbytes, flops, "float32")
    return dict(cmp, ok=cmp["ok"] and empty_zero, empty_groups_zero=empty_zero,
                empty_groups=int((~present).sum()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library=library, bound_ms=bound_ms,
                bound_by=bound_by, flops=flops, tflops=flops / ms / 1e9)


def run_gmm_visit_case(layout):
    import numpy as np

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    gids, bm, _, groups = layout
    got = gm.grouped_matmul_visit_counts(gids, groups, bm)
    plain = gm.grouped_matmul_visit_reference(gids, groups, bm)
    want = gm.expected_visit_counts(gids.cpu().numpy(), groups, bm)
    exact = (bool((got == plain).all())
             and np.array_equal(got.cpu().numpy(), want))
    ms = _cuda_ms(lambda: gm.grouped_matmul_visit_counts(gids, groups, bm))
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_visit_reference(
        gids, groups, bm))
    blocks = gids.shape[0] // bm
    bound_ms, bound_by = _bound(gids.shape[0] * 4 + blocks * 4,
                                blocks * groups, "float32")
    return dict(ok=exact, max_abs_err=0 if exact else None,
                visited_tiles=int(got.sum()), total_tiles=blocks * groups,
                blocks=blocks, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_gmm(gen, report):
    import torch

    layouts = gmm_layouts(gen)
    fwd, dw, visit = {}, {}, {}
    for label, lay, d, h, dtype, std, tr in gmm_fwd_cases(layouts):
        fwd[label] = r = run_gmm_fwd_case(gen, layouts[lay], d, h, dtype,
                                          std, tr)
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "none")
        print(f"gmm_fwd {label}: err {r['max_abs_err']:.3g} row rel "
              f"{r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) trash zero "
              f"{r['trash_zero']} ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.3f} library_ms {lib} ({r['library']}) "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['tflops']:.1f} TFLOP/s", flush=True)
        torch.cuda.empty_cache()
    for label, lay, d, h, dtype in gmm_dw_cases():
        dw[label] = r = run_gmm_dw_case(gen, layouts[lay], d, h, dtype,
                                        lay == "dispatch")
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "none")
        print(f"gmm_dw {label}: err {r['max_abs_err']:.3g} row rel "
              f"{r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) empty groups "
              f"{r['empty_groups']} zero {r['empty_groups_zero']} ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.3f} library_ms {lib} "
              f"({r['library']}) bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) {r['tflops']:.1f} TFLOP/s", flush=True)
        torch.cuda.empty_cache()
    for label, lay in layouts.items():
        visit[label] = r = run_gmm_visit_case(lay)
        print(f"gmm_visit {label}: exact {r['ok']} visited "
              f"{r['visited_tiles']}/{r['total_tiles']} ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f}",
              flush=True)
    report["gmm_fwd_cases"], report["gmm_dw_cases"] = fwd, dw
    report["gmm_visit_cases"] = visit
    return ([f"gmm_fwd {k}" for k, r in fwd.items() if not r["ok"]]
            + [f"gmm_dw {k}" for k, r in dw.items() if not r["ok"]]
            + [f"gmm_visit {k}" for k, r in visit.items() if not r["ok"]])


def phase_kernels(seed, report):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flash = {}
    for label, kw in flash_cases(gen):
        flash[label] = r = run_flash_case(gen, **kw)
        print(f"flash {label}: err {r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"row rel {r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) lse_err {r['lse_err']:.3g} ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['tflops']:.2f} TFLOP/s", flush=True)
    paged = {}
    for label, kw in paged_cases():
        paged[label] = r = run_paged_case(gen, **kw)
        print(f"paged {label}: err {r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"row rel {r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) {r['gbps']:.1f} GB/s",
              flush=True)
    report["flash_cases"], report["paged_cases"] = flash, paged
    torch.cuda.empty_cache()      # the plain versions' S=4096 scores
    bwd = {}
    for label, kw in flash_bwd_cases(gen):
        bwd[label] = r = run_flash_bwd_case(gen, **kw)
        errs = " ".join(f"{n} {c['max_abs_err']:.3g}/{c['max_rel_err']:.3g}"
                        for n, c in r["cmp"].items())
        kern = " ".join(f"{n} {k['ms']:.3f} ms ({k['tflops']:.2f} TFLOP/s, "
                        f"plain {k['plain_ms']:.3f}, bound "
                        f"{k['bound_ms']:.4f})"
                        for n, k in r["kernels"].items())
        print(f"flash_bwd {label}: abs/row-rel err {errs} (tol {r['tol']}, "
              f"rtol {r['rtol']:.3g}) ms {r['ms']:.3f} [{kern}] plain_ms "
              f"{r['plain_ms']:.3f} library_ms {r['library_ms']:.3f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        torch.cuda.empty_cache()
    ce = {}
    for label, kw in ce_cases():
        ce[label] = r = run_ce_case(gen, **kw)
        print(f"ce_stats {label}: errs {json.dumps(r['errs'])} (tol "
              f"{CE_TOL}, sl {CE_SL_TOL} * V) ms {r['ms']:.3f} plain_ms "
              f"{r['plain_ms']:.3f} library_ms {r['library_ms']:.3f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['tflops']:.2f} TFLOP/s", flush=True)
        torch.cuda.empty_cache()
    report["flash_bwd_cases"], report["ce_cases"] = bwd, ce
    bad = [f"flash {k}" for k, r in flash.items() if not r["ok"]] + \
          [f"paged {k}" for k, r in paged.items() if not r["ok"]] + \
          [f"flash_bwd {k}" for k, r in bwd.items() if not r["ok"]] + \
          [f"ce_stats {k}" for k, r in ce.items() if not r["ok"]] + \
          phase_gmm(gen, report)
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")


def _engine_cfg(**kw):
    from paddle_tpu_torch.serving import ServingConfig

    return ServingConfig(**kw)


def phase_cuda_vs_cpu(seed, report):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_tiny_config(vocab_size=1024, hidden_size=512,
                            intermediate_size=1024, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            max_position_embeddings=512)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    kw = dict(page_size=16, num_pages=128, decode_batch=4, prefill_chunk=64,
              pack_frame=128, max_seq_len=256)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 70, 150, 20, 100)]
    streams = {}
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        eng = ServingEngine(model, _engine_cfg(**kw), device=dev)
        streams[dev] = eng.generate(prompts, max_new_tokens=12)
        eng.allocator.check_consistency()
    equal = streams["cpu"] == streams["cuda"]
    report["cuda_vs_cpu"] = {"equal": equal, "streams": streams}
    print(f"cuda vs cpu greedy streams equal: {equal}", flush=True)
    if not equal:
        raise AssertionError("CUDA and CPU greedy streams differ")


def phase_full_width(args, report):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_7b_config(num_hidden_layers=args.layers, dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=args.seed)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServingEngine(model, _engine_cfg(
        page_size=16, decode_batch=8, prefill_chunk=256, max_seq_len=4096,
        hbm_budget_mb=16384), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(args.seed)
    # warm-up: one short request (cuBLAS handles, allocator pools)
    eng.generate([rng.randint(1, cfg.vocab_size, 40).astype(np.int32)],
                 max_new_tokens=2)
    prompt_lens = [17, 60, 100, 200, 300, 700, 1500, 3000]
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in prompt_lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames0 = eng.stats()["prefill_packed_frames"]

    port_cuda.reset_launch_counts()          # the main path starts here
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.step()                               # all prefills + decode step 1
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = port_cuda.launch_counts()     # ... and ends here

    reqs = [eng.scheduler.get(r) for r in rids]
    streams = [list(r.generated) for r in reqs]
    ttft = [(r.token_times[0] - r.arrival_t) * 1e3 for r in reqs]
    for r in rids:
        eng.release(r)
    gen_tokens = sum(len(s) for s in streams)
    out = {
        "layers": args.layers, "params": n_params, "setup_s": setup_s,
        "kv_pages": eng.num_pages, "kv_cache_gb": eng.kv_cache_bytes / 1e9,
        "prompt_lens": prompt_lens, "new_tokens": NEW_TOKENS,
        "packed_frames": eng.stats()["prefill_packed_frames"] - frames0,
        "prefill_s": t_first - t0,
        "prefill_tokens_per_s": sum(prompt_lens) / (t_first - t0),
        "decode_s": t_end - t_first,
        "decode_tokens_per_s": (gen_tokens - len(reqs)) / (t_end - t_first),
        "ttft_ms_mean": statistics.mean(ttft), "ttft_ms_max": max(ttft),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "first_tokens": [s[:4] for s in streams],
    }
    out["profile"] = _profile_serving(eng, rng, cfg.vocab_size)
    report["full_width"] = out
    print("full width: " + json.dumps({k: v for k, v in out.items()
                                        if k != "first_tokens"}), flush=True)
    complete = all(len(s) == NEW_TOKENS for s in streams)
    in_vocab = all(0 <= t < cfg.vocab_size for s in streams for t in s)
    if not (complete and in_vocab):
        raise AssertionError(f"incomplete or out-of-vocab streams: "
                             f"{[len(s) for s in streams]}")
    if out["packed_frames"] < 1:
        raise AssertionError("no packed prefill frame ran")
    missing = [k for k in ("flash_fwd", "paged_decode") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
    return eng, prompts


def _device_profile(fn, steps, top=8):
    """torch.profiler over `fn` (one step): wall ms per step, device ms
    per step (kernels, copies), the device's busy share and the top
    device entries."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side entries only: the CPU ops that launched them carry the
    # same time again
    dev = [(e.key, e.self_device_time_total / 1e3 / steps)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms in dev)
    dev.sort(key=lambda kv: -kv[1])
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms if dev else None,
            "device_busy_share": device_ms / wall_ms if dev else None,
            "top_device_ms": [(k[:90], ms) for k, ms in dev[:top]]}


def _profile_serving(eng, rng, vocab, steps=4):
    import torch

    """Where the serving time goes, outside the main-path run: one chunked
    prefill of a 3000-token prompt alone, then decode of 8 rows with
    1000-token contexts: `steps` steps timed without the profiler, then
    `steps` more under it. The decode's busy-share estimate divides the
    profiled device ms by the unprofiled wall ms of the steps just before
    (the profiler slows the host, not the device)."""
    long_prompt = rng.randint(1, vocab, 3000).astype("int32")
    rid = eng.submit(long_prompt, max_new_tokens=1)
    prefill = _device_profile(eng._admit, 1)
    eng.run_until_idle()
    eng.release(rid)
    rids = [eng.submit(rng.randint(1, vocab, 1000).astype("int32"),
                       max_new_tokens=2 * steps + 2) for _ in range(8)]
    eng.step()                                   # prefills + first decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    decode = _device_profile(eng.step, steps)
    decode["unprofiled_wall_ms_per_step"] = wall_ms
    decode["device_busy_share_est"] = (
        decode["device_ms_per_step"] / wall_ms
        if decode["device_ms_per_step"] is not None else None)
    eng.run_until_idle()
    for r in rids:
        eng.release(r)
    return {"prefill_3000": prefill, "decode_8x1000": decode}


def phase_http(eng, prompt, report):
    import http.client

    srv = eng.serve_http(0, block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=300)
        conn.request("POST", "/generate",
                     json.dumps({"prompt_ids": prompt.tolist(),
                                 "max_new_tokens": 8}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        events = [json.loads(line)
                  for line in resp.read().decode().splitlines()]
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        health_ok = health.status == 200 and json.loads(health.read())["ok"]
        conn.close()
    finally:
        eng.shutdown_http()
    last = events[-1] if events else {}
    tokens = [e["token"] for e in events if "token" in e]
    report["http"] = {"status": resp.status, "last": last,
                      "tokens": len(tokens), "health_ok": health_ok}
    print(f"http: status {resp.status} tokens {len(tokens)} last {last}",
          flush=True)
    if not (resp.status == 200 and last.get("done") and len(tokens) == 8
            and health_ok):
        raise AssertionError(f"HTTP round trip failed: {report['http']}")


def _packed_batch(seed, vocab, seq, rows):
    """One packed dict batch (pack_examples: segment_ids, position_ids,
    labels -100 at document ends and on padding)."""
    import numpy as np

    from paddle_tpu_torch.io import pack_examples

    rng = np.random.RandomState(seed)
    docs = [rng.randint(1, vocab, n) for n in
            (37, 100, 64, 20, 150, 90, 33, 7, 200, 41)]
    return next(pack_examples(docs, seq_len=seq, batch_size=rows))


def _fused_loss(out, labels):
    return out                  # the model computed the fused head loss


def _train_cuda_vs_cpu(models, batch, lr, label, report):
    """3 TrainStep steps of AdamW on the CPU and on CUDA from the same
    weights: per-step losses within 1e-4 relative, last gradients within
    1e-3 of each tensor's max |grad|, final parameters within lr."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    losses, metrics = {}, {}
    for dev, model in models.items():
        opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                    weight_decay=0.01)
        step = TrainStep(model, _fused_loss, opt, collect_metrics=True)
        losses[dev] = [float(step(batch)) for _ in range(3)]
        metrics[dev] = step.last_metrics()
    cpu = dict(models["cpu"].named_parameters())
    worst_p, worst_g, median_p = 0.0, 0.0, []
    for name, p in models["cuda"].named_parameters():
        dp = (p.detach().cpu() - cpu[name].detach()).abs()
        worst_p = max(worst_p, dp.max().item())
        median_p.append(dp.median().item())
        g, gc = p.grad.cpu(), cpu[name].grad
        worst_g = max(worst_g, ((g - gc).abs().max()
                                / gc.abs().max().clamp_min(1e-7)).item())
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    out = {"losses": losses, "last_metrics": metrics,
           "loss_rel_err": loss_rel, "grad_rel_err": worst_g,
           "param_max_abs_err": worst_p,
           "param_median_abs_err_max": max(median_p),
           "tolerance": {"loss_rel": 1e-4, "grad_rel": 1e-3, "param": lr}}
    report[label] = out
    print(f"{label}: " + json.dumps(out), flush=True)
    if not (loss_rel <= 1e-4 and worst_g <= 1e-3 and worst_p <= lr):
        raise AssertionError("CUDA and CPU training steps differ")


def phase_train_cuda_vs_cpu(seed, report):
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config

    cfg = llama_tiny_config(vocab_size=1024, hidden_size=512,
                            intermediate_size=1024, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            max_position_embeddings=512)
    batch = _packed_batch(seed, cfg.vocab_size, 256, 2)
    models = {"cpu": LlamaForCausalLM(cfg, device="cpu", seed=seed)}
    models["cuda"] = LlamaForCausalLM(cfg, device="cuda")
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    _train_cuda_vs_cpu(models, batch, 1e-3, "train_cuda_vs_cpu", report)


def phase_train_moe_cuda_vs_cpu(seed, report):
    """Tiny fp32 GPT-MoE, dropless, deterministic GShard gates (the CPU and
    CUDA generators give different streams): 64 tokens a row make 256
    routed copies over 4 experts, so the buckets align to 32 rows and the
    CUDA tiles (64 fp32 rows) span two experts."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import GptMoeForCausalLM, gpt_moe_tiny_config

    cfg = gpt_moe_tiny_config(vocab_size=1024, hidden_size=256,
                              num_attention_heads=4, expert_hidden_size=512,
                              max_position_embeddings=256,
                              moe_dispatch="dropless")
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, 65)))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    models = {"cpu": GptMoeForCausalLM(cfg, device="cpu", seed=seed)}
    models["cuda"] = GptMoeForCausalLM(cfg, device="cuda")
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    for model in models.values():
        for moe in model.moe_layers():
            moe.gate.random_routing = False
    _train_cuda_vs_cpu(models, batch, 1e-3, "train_moe_cuda_vs_cpu", report)
    bms = [moe.last_layout[1] for moe in models["cuda"].moe_layers()]
    if bms != [32] * cfg.num_hidden_layers:
        raise AssertionError(f"expected 32-row buckets, got {bms}")


def phase_train_full_width(args, report):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = llama_7b_config(num_hidden_layers=TRAIN_LAYERS, dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=args.seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, _fused_loss, opt, collect_metrics=True)
    rng = np.random.RandomState(args.seed)
    ids = torch.from_numpy(
        rng.randint(1, cfg.vocab_size, (1, TRAIN_SEQ + 1))).cuda()
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    n_params = sum(p.numel() for p in model.parameters())
    # 6 N T for every matmul weight (the embedding gather is none), plus
    # causal attention: forward 4 D per visible (query, key) pair and head,
    # the backward 2.5 times that
    d = cfg.hidden_size // cfg.num_attention_heads
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    matmul_params = n_params - cfg.vocab_size * cfg.hidden_size
    flops = (6 * matmul_params * TRAIN_SEQ
             + cfg.num_hidden_layers * 3.5 * 4 * d
             * cfg.num_attention_heads * pairs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses = []
    for _ in range(2):                       # warm-up: cuBLAS, allocator
        losses.append(float(step(batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port_cuda.reset_launch_counts()          # the training path starts here
    times = []
    for _ in range(8):
        t1 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    launches = port_cuda.launch_counts()     # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    proj_grads = {
        f"{i}.{n}": (None if p.grad is None
                     else float(p.grad.float().abs().sum()))
        for i, layer in enumerate(model.llama.layers)
        for n, p in (("q_proj", layer.self_attn.q_proj.weight),
                     ("k_proj", layer.self_attn.k_proj.weight),
                     ("v_proj", layer.self_attn.v_proj.weight))}
    step_s = statistics.median(times)
    out = {
        "layers": cfg.num_hidden_layers, "params": n_params,
        "seq": TRAIN_SEQ, "batch": 1, "setup_s": setup_s,
        "losses": losses, "step_ms": [t * 1e3 for t in times],
        "median_step_ms": step_s * 1e3,
        "tokens_per_s": TRAIN_SEQ / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / PEAK_FLOPS[
            "bfloat16"],
        "peak_mem_gb": peak, "launches": launches,
        "launches_per_step": {k: n / 8 for k, n in launches.items()},
        "metrics": step.last_metrics(), "proj_grad_abs_sum": proj_grads,
    }
    out["profile"] = _device_profile(lambda: step(batch), 1, top=16)
    report["train_full_width"] = out
    print("train full width: " + json.dumps(
        {k: v for k, v in out.items() if k != "profile"}), flush=True)
    print("train profile: " + json.dumps(out["profile"]), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not (losses[-1] < losses[0] and max(losses[-3:]) < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(proj_grads.values()):
        raise AssertionError(f"attention projections without a gradient: "
                             f"{proj_grads}")
    layers = cfg.num_hidden_layers           # one flash call per layer
    need = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "ce_stats": 1}
    short = {k: n for k, n in out["launches_per_step"].items()
             if k in need and n < need[k]}
    if short:
        raise AssertionError(f"kernels not launched on the training path: "
                             f"{short}")


def phase_train_moe_full_width(args, report):
    """GPT-MoE at its own full width and depth (GptMoeConfig defaults: 12
    layers, hidden 1024, 16 heads, 8 experts of 4096, top-2 GShard with
    random routing, vocab 50304), dropless, bf16, batch 4 x seq 2048."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import GptMoeConfig, GptMoeForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = GptMoeConfig(moe_dispatch="dropless")
    b, s = MOE_BATCH, cfg.max_position_embeddings
    t0 = time.perf_counter()
    model = GptMoeForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                              seed=args.seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, _fused_loss, opt, collect_metrics=True)
    rng = np.random.RandomState(args.seed)
    ids = torch.from_numpy(rng.randint(1, cfg.vocab_size, (b, s + 1))).cuda()
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses = []
    for _ in range(2):                       # warm-up: cuBLAS, allocator
        losses.append(float(step(batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port_cuda.reset_launch_counts()          # the training path starts here
    times = []
    for _ in range(MOE_STEPS):
        t1 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    launches = port_cuda.launch_counts()     # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the visit counter (off the training path) over each layer's bucket
    # layout of the last step, cross-checked with the predicate in numpy;
    # its launches are counted apart from the path's
    port_cuda.reset_launch_counts()
    visits = []
    for moe in model.moe_layers():
        gids, bm = moe.last_layout
        vc = gm.grouped_matmul_visit_counts(gids, cfg.num_experts, bm)
        want = gm.expected_visit_counts(gids.cpu().numpy(), cfg.num_experts,
                                        bm)
        real = int((gids.reshape(-1, bm)[:, 0] < cfg.num_experts).sum())
        visits.append({"block_rows": bm, "blocks": int(vc.numel()),
                       "visited_tiles": int(vc.sum()), "real_blocks": real,
                       "counts_match_predicate": bool(np.array_equal(
                           vc.cpu().numpy(), want))})
    visit_check_launches = port_cuda.launch_counts()["gmm_visit"]
    stats = [moe.last_stats for moe in model.moe_layers()]
    expert_grads = {
        f"{i}.{n}": [float(p.grad[e].float().abs().sum())
                     for e in range(cfg.num_experts)]
        for i, moe in enumerate(model.moe_layers())
        for n, p in (("w1", moe.experts.w1), ("w2", moe.experts.w2))}
    step_s = statistics.median(times)
    tokens = b * s
    # flops of the last step: 6 per weight and token for the dense matmuls
    # (attention projections, gates, head), 6 per expert weight and routed
    # copy (the routed copies this step's random routing kept), causal
    # attention 3.5 x 4 D per visible (query, key) pair and head
    d, f = cfg.hidden_size, cfg.expert_hidden_size
    dense = cfg.num_hidden_layers * (4 * d * d + d * cfg.num_experts) \
        + cfg.vocab_size * d
    routed = sum(sum(st["expert_tokens"]) for st in stats)
    pairs = s * (s + 1) // 2
    flops = (6 * dense * tokens + 6 * 2 * d * f * routed
             + cfg.num_hidden_layers * 3.5 * 4 * d * pairs * b)
    out = {
        "layers": cfg.num_hidden_layers, "params": n_params, "batch": b,
        "seq": s, "setup_s": setup_s, "losses": losses,
        "step_ms": [t * 1e3 for t in times], "median_step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_FLOPS["bfloat16"], "peak_mem_gb": peak,
        "launches": launches,
        "launches_per_step": {k: n / MOE_STEPS for k, n in launches.items()},
        "routed_copies_last_step": routed, "metrics": step.last_metrics(),
        "moe_stats": stats, "visits": visits,
        "visit_check_launches": visit_check_launches,
        "expert_grad_abs_sum": expert_grads,
    }
    out["profile"] = _device_profile(lambda: step(batch), 1, top=20)
    report["train_moe_full_width"] = out
    print("train moe full width: " + json.dumps(
        {k: v for k, v in out.items()
         if k not in ("profile", "expert_grad_abs_sum", "moe_stats")}),
        flush=True)
    print("train moe layer stats: " + json.dumps(
        [{"aux": st["aux_loss"], "imbalance": st["imbalance_max_over_mean"],
          "expert_tokens": st["expert_tokens"]} for st in stats]), flush=True)
    print("train moe profile: " + json.dumps(out["profile"]), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not (losses[-1] < losses[0] and max(losses[-3:]) < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(all(v > 0 for v in g) for g in expert_grads.values()):
        raise AssertionError(f"experts without a gradient: {expert_grads}")
    if not all(v["counts_match_predicate"]
               and v["visited_tiles"] == v["real_blocks"] for v in visits):
        raise AssertionError(f"visit counts off the predicate: {visits}")
    layers = cfg.num_hidden_layers
    need = {"gmm_fwd": 4 * layers, "gmm_dw": 2 * layers,
            "flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    got = {k: out["launches_per_step"][k] for k in need}
    if got != need:
        raise AssertionError(f"launches per step {got}, want {need}")


def kernels_line(report):
    """One row per kernel; `launches` counts the main paths' runs (the
    7B serve and the timed LLaMA and GPT-MoE training steps), each read
    around its run. gmm_visit is off the training path, so it has 0."""
    from paddle_tpu_torch.ops.cuda import _build

    serve = report.get("full_width", {}).get("launches", {})
    train = report.get("train_full_width", {}).get("launches", {})
    moe = report.get("train_moe_full_width", {}).get("launches", {})
    flash = report.get("flash_cases", {}).get("causal_s2048") or {}
    paged = report.get("paged_cases", {}).get("decode_b8_h32") or {}
    bwd = report.get("flash_bwd_cases", {}).get("causal_s4096") or {}
    ce = report.get("ce_cases", {}).get("n4096_h4096_v32000") or {}
    pallas = "paddle_tpu/ops/pallas/"
    specs = [
        ("flash_fwd", "flash_fwd.cu", "flash_attention.py:119", flash),
        ("paged_decode", "paged_attention.cu", "paged_attention.py:103",
         paged),
        ("flash_bwd_dq", "flash_bwd.cu", "flash_attention.py:309",
         bwd.get("kernels", {}).get("dq", {})),
        ("flash_bwd_dkv", "flash_bwd.cu", "flash_attention.py:362",
         bwd.get("kernels", {}).get("dkv", {})),
        ("ce_stats", "fused_ce.cu", "fused_ce.py:246", ce),
        ("gmm_fwd", "grouped_matmul.cu", "grouped_matmul.py:98",
         report.get("gmm_fwd_cases", {}).get("h1_bf16") or {}),
        ("gmm_dw", "grouped_matmul.cu", "grouped_matmul.py:117",
         report.get("gmm_dw_cases", {}).get("dw1_bf16x") or {}),
        ("gmm_visit", "grouped_matmul.cu", "grouped_matmul.py:291",
         report.get("gmm_visit_cases", {}).get("dispatch") or {})]
    rows = []
    for name, src, replaces, case in specs:
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(os.path.join(_build.CSRC_DIR, src),
                                      REPO),
            "replaces": pallas + replaces,
            "launches": (serve.get(name, 0) + train.get(name, 0)
                         + moe.get(name, 0)),
            "max_abs_err": case.get("max_abs_err"), "ms": case.get("ms"),
            "plain_ms": case.get("plain_ms"),
            "bound_ms": case.get("bound_ms"),
            "bound_by": case.get("bound_by"),
            "library_ms": case.get("library_ms")})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth of the full-width serving phase")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s {json.dumps(built)}", flush=True)
    report = {"gpu": smi_line, "build_s": build_s, "built": built,
              "ptxas": {n: [ln for ln in _build.build_log(n).splitlines()
                            if "registers" in ln or "spill" in ln]
                        for n in _build.kernel_names()},
              "failed": []}
    phases = [("kernels", lambda: phase_kernels(args.seed, report)),
              ("cuda_vs_cpu", lambda: phase_cuda_vs_cpu(args.seed, report))]
    state = {}

    def full_width():
        state["eng"], state["prompts"] = phase_full_width(args, report)

    def http():
        if "eng" not in state:
            raise RuntimeError("the full-width phase built no engine")
        phase_http(state["eng"], state["prompts"][1], report)

    def free_memory():
        # the 7B serving engine's weights and KV pool, and each training
        # phase's model, make room for the next phase
        state.clear()
        gc.collect()
        torch.cuda.empty_cache()

    phases += [("full_width", full_width), ("http", http),
               ("train_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_train_cuda_vs_cpu(args.seed, report))),
               ("train_full_width",
                lambda: phase_train_full_width(args, report)),
               ("train_moe_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_train_moe_cuda_vs_cpu(args.seed, report))),
               ("train_moe_full_width",
                lambda: phase_train_moe_full_width(args, report))]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            report["failed"].append(name)
        report[f"{name}_s"] = time.perf_counter() - t0
        print(f"phase {name}: {'FAILED' if name in report['failed'] else 'ok'}"
              f" ({report[f'{name}_s']:.1f} s)", flush=True)

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    if report["failed"]:
        print(f"chip_smoke: failed phases {report['failed']}",
              file=sys.stderr)
        return 1
    print(json.dumps(kernels_line(report)), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
