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
    The flash forward runs causal and non-causal, ragged, GQA and packed
    (GQA and head_dim 64 too) cases besides the serving shapes: bf16 on
    the tensor cores (P rounded to bf16 for P . V), fp32 on the CUDA
    cores; its device ms (profiler), TFLOP/s and share of its bound are
    printed beside the library's forward (SDPA).
    The flash backward's dq, dk and dv (fp32 outputs of bf16 or fp32
    inputs) are held per row the same way against
    ``flash_attention_bwd_reference`` on the same (q, k, v, out, lse, dO),
    causal at S 4096, GQA, packed (GQA and head_dim 64 too), fp32 and a
    ragged S of 1000 (causal and not); the bf16 kernels (tensor cores)
    round P and dS to bf16 for their second products, the plain version
    keeps fp32, and the rule stays as above; each kernel's TFLOP/s and
    share of its bound are printed beside the library's backward;
    the CE statistics kernel's m, lse = m + log s and target logit t within
    1e-3 of ``ce_stats_reference`` (fp32 math on the same inputs; the sums
    run over H = 4096 products in another order) and the logit sum sl
    within 1e-5 * V of it (a sum over V logits); the grouped matmul's
    gmm_fwd per row (fp32 rule, trash rows exactly zero: h1, y, a depth
    of 96, the unaligned block_rows 8 layout in bf16 and fp32), the VJP's
    dx through ``GroupedMatmul.backward`` (bf16 w, fp32 dy: dx of h1, of
    y, unaligned), gmm_fwd at the LoRA serve's shapes (the shrink [8,
    4096] x [16, 4096, r] over unsorted slot ids with trash rows at r 8,
    16 and 64, a 256-row one-slot prefill chunk, the expands [8, r] x
    [16, r, 4096] and [256, 16] x [16, 16, 1024], fp32 [8, 64] x [4, 64,
    8]: device ms beside the bound, the launch floor and
    torch._grouped_mm over the rows sorted by slot), gmm_dw per row (dw1, dw2, dw1 with fp32 x, unaligned;
    groups with no rows exactly zero) and gmm_visit exactly. All of them
    and ce_stats run on the wgmma/TMA core (sm90.cuh): bf16 products, or
    fp32 ones as split TF32 (2 passes with a bf16 operand, 3 with two fp32
    ones); for them and the library call beside them (bf16 x . W^T with
    logsumexp, gather and sum; torch._grouped_mm, for the fp32 products
    only for scale, in bf16) the device ms (profiler, every kernel of the
    call, ce_stats with its split merge, gmm_dw with its x^T and walk
    passes, the wrappers' copies of w apart), TFLOP/s and share of the
    bound (an fp32 product's bound is the card's least time for an
    fp32-accurate product: 3 bf16 products at 989 TFLOP/s when one operand
    is exact in bf16, 3 TF32 ones at 495 when neither is; the split-TF32
    design's own ceiling, its 2 or 3 TF32 passes, and the CUDA-core bound
    it replaced, "was", are printed beside it) are printed beside the
    event-timed call ms, with each sm90
    kernel's ptxas line (a spill fails the run) and the count of 128-row
    tiles of each grouped layout that hold more than one group. The paged
    decode runs bf16 q on its tensor-core kernel (``paged_decode_kernel_mma``:
    bulk copies on an mbarrier ring, codes widened in shared memory,
    ``mma.sync``) and fp32 q on its CUDA-core kernel; each case must run
    its dtype's kernel alone (profiler names): the 7B decode at pages of
    8, 16, 32 and 128, GQA, frames of T 3 and of 64 rows (T 8, GQA 8), and
    a pool holding NaN in every slot no query sees; its int8 and fp8
    branch runs on codes and fp32 scales made by the model's
    quantize-on-write (pages of 8, 16 and 128, an fp8 pool of NaN codes
    and scales outside the live slots): with fp32 q within 1e-5 of its
    plain version, with bf16 q within 1e-3 beyond the rounding of the fp32
    result to bf16 (2^-8 of |ref|) plus the row check; each paged case
    prints its device ms (decode kernel and split-K merge apart), GB/s and
    share of the bound (bf16 q at page 4, bf16, int8 and fp8 pools, runs
    the CUDA-core kernel, which takes any page size); the page and flash
    visit counters must equal their plain versions (and ceil(len /
    page_size)) exactly, over the engine frame, packed frames of B 4 x S
    2048, B 1 x S 4096 and B 1 x S 32768, blocks (64, 32), (32, 128) and
    (1, 1), a non-causal frame, and decode batches of 8 and 256 rows at
    pages of 1, 4 and 16 (lens 0 and over capacity), each printing its
    device ms beside the launch floor (one 1-element fill's device ms),
    as the grouped matmul's visit counter does over the dispatcher's
    layout at 8 and at 64 experts and the unaligned block_rows 8 one,
    exact against both its plain versions;
    the fused-CE backward's kernels
    (``csrc/ce_bwd.cu``: the logits with the d-logits epilogue, dx and dW
    as bf16 products of d's three bf16 pieces, all on the wgmma/TMA core)
    against ``ce_bwd_reference`` at fp32 (TF32 off): dx and dW each row
    within 1e-5 of its own max |ref|, at the LLaMA step's shape (the
    default token chunk, 1024 and 4096), a ragged N with ignored tokens, label
    smoothing with z-loss and a ragged V; the error against the same
    function in fp64 is printed beside, with every kernel's device ms,
    the fp32 cuBLAS route's device ms in the same call and the 7-product
    bound;
 3. the engine on CUDA (kernels) against the engine on the CPU (plain
    versions): a 2-layer fp32 GQA model with the same weights serves the
    same prompts; the greedy streams must be equal; then the same with
    int8 and with fp8 pools, prefix sharing and a host tier: requests
    sharing a system prompt, and a prompt whose pages demote to the host
    and promote back; streams and allocator counters must be equal, and
    the promoted prompt's stream equal to its first; then the same model
    in bf16 with int8 and fp8 pools: the first decode step's logits
    within 2^-5 of each row's max |logit| (bf16 rounds in another order
    on each device), the streams' agreement reported; and the model in
    bf16 with bf16 pages of 4 keys (the CUDA-core paged kernel): page
    tables and greedy streams equal to the CPU engine's; then
    speculative engines (the fp32 GQA model at spec_k 3 over fp32, int8
    and fp8 pools; a GQA 8:1 model at spec_k 8, whose 72-row verify
    frames launch the paged kernel twice a layer): streams equal to the
    CUDA plain engine's and the CPU speculative engine's, page tables
    and each step's committed tokens equal to the CPU's; then multi-
    tenant LoRA on the fp32 GQA model (an AdapterStore of 4 slots, 3
    adapters written by the port's export_adapter, a base request and 2
    for each adapter in one batch at spec_k 0 and 3): streams and page
    tables equal to the CPU's, each stream equal to its request alone;
    prompts sharing 32 tokens served base then adapter and the reverse
    (prefix sharing on) equal to their streams alone, nothing adopted
    across adapters; a hot swap raced against the decode loop (one
    version of the weights a step); serving.lora.swap_fail giving one
    typed AdapterLoadError, the other streams unchanged; a rank-4
    adapter (pools padded to 8) equal to the CPU; two replicas behind
    the adapter-affine router with serving.replica.kill armed mid-run,
    every stream complete and equal to the CPU's;
 4. the LLaMA-2-7B geometry (32 layers, hidden 4096, 32 heads, bf16, random
    weights from --seed) serving 8 greedy requests of mixed prompt length
    (packed, single-chunk and multi-chunk prefill), with every kernel's
    launch count read around this run; prints prefill and decode tokens/s,
    time to first token and peak memory, then profiles (torch.profiler)
    one 3000-token prefill and a few decode steps outside that run (the
    paged kernels' device ms a step; the decode must run the tensor-core
    paged kernel, as the int8 and fp8 serves' decode must too);
 5. HTTP: serve_http, one streamed POST /generate, clean shutdown;
    then phase 4's prompts on its engine at spec_k 0 and at spec_k 4
    (decode tokens/s of both, accepted tokens a verify step, the verify
    step's paged kernel, the first verify step's position-0 logits held
    bit for bit to plain decode's with the frame's projections run
    position by position, the engine's own frame's error printed, the
    streams' agreement with phase 4's; every page free after);
    then, on the same model with the bf16 pools freed: a fresh bf16
    engine serves phase 4's prompts again and once more with K/V moved by
    int8's rounding size (the agreement a rounding-sized change leaves at
    random weights); an int8 and an fp8 engine at the same 16 GiB budget
    (int8: at least 1.9x the bf16 pages) serve phase 4's prompts alone in
    the timed window, the int8 one then 8 requests sharing a 1024-token
    system prompt apart; both visit counters run after the serves over
    the recorded decode lengths and packed frames; the page writes'
    (quantize-on-write) and chunk gathers' (dequant) device ms are
    measured apart; an int8 tier run at 384 pages and a 2 GiB pinned host
    store demotes a 1000-token prompt's pages and promotes them byte-exact,
    the promoted serve's stream equal to a serve that adopted the same
    pages cold in device memory; then multi-tenant LoRA on the same
    model: a fresh engine with an AdapterStore of rank 16 on q, k, v, o
    and 16 slots, 4 random adapters, phase 4's prompts served base-only
    and then 2 base and 2 for each of 3 adapters (prefill and decode
    tokens/s of both, 2 x 4 x 32 = 256 grouped-matmul launches a decode
    step, the grouped kernels' device ms against the adapter decode
    step's, swap-in ms, peak memory; each adapter request's first-step
    logits within 2^-5 of the row max of the request served alone);
    then two in-process replicas over two engines sharing the weights
    (8 GiB of pages and an AdapterStore each) behind
    Router(placement="adapter"): the 8 requests complete, each adapter's
    on one replica, an unknown adapter is one adapter_load_failed event,
    replica 1 killed mid-stream loses no request, /metrics over HTTP
    carries lora_active_adapters and router_* series;
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
    launches per step (the fused-CE backward's kernels once a step, the
    fp32 matmul route never) and the losses (finite, falling), checks
    that the attention projections got gradients, then profiles one more
    step;
    then GPT-MoE training: a tiny CUDA-vs-CPU check and the full width;
 8. the RMSNorm kernels (forward, backward, dw sum) against their plain
    versions at the main path's widths ([4096, 4096], [8, 4096],
    [8192, 1024], a ragged [4097, 1000] at every row block the autotuner
    may pick, a scalar-path [4097, 1001]; bf16 and fp32, bf16 x with fp32
    w once): y and dx by the per-row rule, dw per column within
    DW_RTOL of the column's sum of |dy * x * rstd| (plus one bf16 ulp for
    bf16 w); median ms (and the device ms of CUDA-graph replays, apart
    from the wrapper's host work), the plain version's, torch's ``F.rms_norm``
    (forward; forward+backward minus forward) and the bound;
 9. tuning, cold then warm, in two processes sharing one temporary
    FLAGS_tuning_cache_dir: the cold one (FLAGS_autotune=search) runs
    ``autotune_report`` over the four resolver entries that have a
    lattice (the flash kernels are compiled for one tile) at the main
    path's geometries (fused_ce: the bf16 head's kernels at hidden 4096),
    on device time (CUDA-graph replays), twice (the
    second into a scratch cache, to record whether the winners repeat),
    then an RMSNorm
    forward+backward at [4096, 4096] bf16 through dispatch-time search,
    one full-width GPT-MoE layer's dropless dispatch over 4 x 2048 tokens,
    two tiny LLaMA ``TrainStep`` steps and a tiny engine with
    ``page_size=0`` serving one greedy request, all on CUDA; the warm one
    (FLAGS_autotune=load) resolves the four entries and runs the rest
    again: every resolution must be tuned with 0 trials, the dispatcher
    must read the grouped-matmul entry the report tuned, and the losses,
    the stream, the MoE output and the RMSNorm outputs must be bit-equal to
    the cold run's; no search may fail or skip a candidate of the port's
    own lattice (one that cannot be captured into the CUDA graph its
    device time is read from is a skip), and every searched entry must
    persist.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``; exits non-zero (and prints no
result) without CUDA, outside the repository, or when any phase fails.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "tfloat32": 495e12,  # dense tensor-core TF32
              "float32": 67e12}    # fp32 outside the tensor cores
TOL = {"bfloat16": 1e-2, "float32": 1e-4}        # whole output, abs
RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}  # per row, of max |ref|
ATOL = 1e-6
CE_TOL = 1e-3              # m, lse, t of ce_stats vs its plain version
CE_SL_TOL = 1e-5           # sl, times V
# RMSNorm dw: an fp32 sum over up to 8192 rows taken in another order than
# the plain version's drifts by about sqrt(rows) * 2^-24 of the column's sum
# of |terms| (5.4e-6 at 8192 rows); this allows about twice that. A bf16 dw
# may then round to the neighbouring bf16 value: one ulp, up to 2^-7 of it.
DW_RTOL = 1e-5
BF16_ULP = 2.0 ** -7
RMS_EPS = 1e-6
RMS_KERNELS = ("rmsnorm_fwd", "rmsnorm_bwd", "rmsnorm_dw")
TUNE_TIMEOUT_S = 420       # each tuning process
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
                rtol=RTOL[dtype_name], rows_ok=rows_ok,
                ok=rows_ok and max_abs <= TOL[dtype_name])


def _rand(gen, shape, dtype, device="cuda"):
    import torch

    # std 0.5 keeps |values| < 4, where bf16 rounding stays < 2^-8 * 2
    return (torch.randn(shape, generator=gen, device=device) * 0.5).to(dtype)


def flash_cases(gen):
    """(label, kwargs) at the serving and training paths' shapes."""
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
        # the bf16 kernel's tiles at their edges (64 x 64 at head_dim 128,
        # 128 x 64 at 64): a ragged last q and K tile of 40 rows, every K
        # tile of every q tile, and packed GQA rows of head_dim 64
        ("causal_s1000_ragged", dict(s=1000, hq=32, hkv=32, dtype=bf)),
        ("noncausal_s1024", dict(s=1024, hq=32, hkv=32, dtype=bf,
                                 causal=False)),
        ("packed_gqa_s2048_d64_b2", dict(s=2048, hq=16, hkv=4, dtype=bf,
                                         d=64, b=2, seg=_packed_rows())),
    ]


def _packed_rows():
    """[2, 2048] segment ids on the card: 3 documents a row, their
    boundaries off every tile."""
    import torch

    seg = torch.zeros((2, 2048), dtype=torch.int32)
    for row, starts in enumerate(((517, 1311), (64, 1900))):
        for j, start in enumerate(starts):
            seg[row, start:] = j + 1
    return seg.cuda()


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


def run_flash_case(gen, s, hq, hkv, dtype, seg=None, chunk=None, d=128, b=1,
                   causal=True):
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
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      segment_ids=seg)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(),
                                                v.float(), causal=causal,
                                                segment_ids=seg)
    dname = str(dtype).replace("torch.", "")
    cmp = _compare(out, ref, dname)
    lse_err = (lse - ref_lse).abs().max().item()
    del ref, ref_lse
    call = lambda: fa.flash_attention_fwd(q, k, v,  # noqa: E731
                                          causal=causal, segment_ids=seg)
    # the kernel's device time; call_ms adds the wrapper's host work
    ms = _kernel_ms(_device_ms_by_kernel(call), "flash_fwd_kernel")
    call_ms = _cuda_ms(call)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal, segment_ids=seg), reps=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if seg is None:
        lib = lambda: tF.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=causal, enable_gqa=True)
        pairs = b * (s * (s + 1) // 2 if causal else s * s)
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
    flops = 4 * d * hq * pairs
    bound_ms, bound_by = _bound(nbytes, flops, dname)
    return dict(cmp, lse_err=lse_err, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / ms,
                tflops=flops / ms / 1e9, ok=cmp["ok"] and lse_err <= 1e-3)


PAGED_LENS = [0, 1, 17, 4095, 100, 2048, 300, 3000]
# the paged decode kernel a case must run, by q's dtype (profiler names)
PAGED_KERNEL = {"bfloat16": "paged_decode_kernel_mma",
                "float32": "paged_decode_kernel"}


def paged_cases():
    """(label, kwargs): the 7B decode (B 8, 32/32 heads, D 128, the 8 mixed
    lengths up to 4095) at page 16 and at the tuner's other page sizes
    (4096 keys a row of the table), GQA, frames (T 3 at GQA 8; T 8 at GQA 8,
    64 rows, eight 8-row tiles), a pool filled with NaN outside its live
    slots; bf16 q runs the tensor-core kernel at page sizes that are
    multiples of 8 and the CUDA-core one at page 4, as fp32 q does."""
    import torch

    lens = PAGED_LENS
    bf = torch.bfloat16
    h32 = dict(t=1, hq=32, hkv=32, lens=lens, dtype=bf)
    # own_gen: drawn from a generator of the case's own (see _paged_gen)
    return [
        ("decode_b8_h32", h32),
        ("decode_b8_h32_ps4", dict(h32, ps=4, pages=1024, own_gen=True)),
        ("decode_b8_h32_ps8", dict(h32, ps=8, pages=512, own_gen=True)),
        ("decode_b8_h32_ps32", dict(h32, ps=32, pages=128, own_gen=True)),
        ("decode_b8_h32_ps128", dict(h32, ps=128, pages=32, own_gen=True)),
        ("decode_b8_gqa8", dict(t=1, hq=32, hkv=8, lens=lens, dtype=bf)),
        ("frame3_gqa8", dict(t=3, hq=32, hkv=8, lens=lens[:-1] + [4093],
                             dtype=bf)),
        ("frame8_gqa8_rows64", dict(t=8, hq=32, hkv=4,
                                    lens=lens[:-1] + [4088], dtype=bf,
                                    own_gen=True)),
        ("nan_pool_b8_h32", dict(h32, nan_fill=True, own_gen=True)),
        ("decode_b8_fp32", dict(t=1, hq=32, hkv=32, lens=lens,
                                dtype=torch.float32)),
    ]


def _paged_gen(gen, seed, label, kw):
    """(generator, kwargs) of a paged case: the shared one, or for a case
    marked own_gen a CUDA generator seeded from `seed` and its label, so
    that such a case leaves the shared draws, and so the other cases'
    values, unchanged."""
    import zlib

    import torch

    kw = dict(kw)
    if not kw.pop("own_gen", False):
        return gen, kw
    g = torch.Generator(device="cuda")
    g.manual_seed(seed * 1000003 + zlib.crc32(label.encode()))
    return g, kw


def _live_slots(pt, lens, t, num_pages, ps):
    """[num_pages, ps] bool: the pool slots that hold a key some query of
    the call may see (positions < len + T - 1 of each row's pages)."""
    import torch

    live = torch.zeros((num_pages, ps), dtype=torch.bool, device=pt.device)
    for b, n in enumerate(lens):
        keys = min(n + t - 1, pt.shape[1] * ps) if n > 0 else 0
        pos = torch.arange(keys, device=pt.device)
        live[pt[b, pos // ps].long(), pos % ps] = True
    return live


def _host_ms(fn, reps=20):
    """Host ms per call of `fn` to enqueue its work, the device left to
    run behind it (the wrapper's own cost, which a host-bound decode step
    pays in full)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def _paged_speed(call, nbytes, flops, dname, plain):
    """The call's event-timed ms (`call_ms`), its host enqueue ms, device
    ms (decode kernel and split-K merge, apart too), the decode kernels
    that ran, the plain version's ms, the bound, and GB/s and share of the
    bound on the device ms."""
    ms = _cuda_ms(call)
    host_ms = _host_ms(call)
    dev = _paged_device_ms(call)
    bound_ms, bound_by = _bound(nbytes, flops, dname)
    return dict(dev, ms=dev["device_ms"], call_ms=ms, host_ms=host_ms,
                plain_ms=_cuda_ms(plain, reps=5), library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / dev["device_ms"],
                gbps=nbytes / dev["device_ms"] / 1e6)


def run_paged_case(gen, t, hq, hkv, lens, dtype, d=128, ps=16, pages=256,
                   nan_fill=False):
    """The kernel against its plain version on the same inputs; with
    `nan_fill`, the kernel's pools hold NaN in every slot no query may
    see (the plain version's the values drawn there before)."""
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
    ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), pt,
                                       ln)
    if nan_fill:
        dead = ~_live_slots(pt, lens, t, num_pages, ps)
        kp[:, dead] = float("nan")
        vp[:, dead] = float("nan")
    out = pa.paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    cmp = _compare(out, ref, dname)
    item = q.element_size()
    # the keys each row needs (len + T - 1), not whole pages; a page id is
    # read once per page those keys touch
    keys = [n + t - 1 if n > 0 else 0 for n in lens]
    pages_read = sum(-(-n // ps) for n in keys)
    nbytes = (2 * q.numel() * item + 2 * sum(keys) * d * hkv * item
              + pages_read * 4 + b * 4)
    flops = 4 * d * hq * sum(n + i for n in lens if n > 0 for i in range(t))
    return dict(cmp, **_paged_speed(
        lambda: pa.paged_attention(q, kp, vp, pt, ln), nbytes, flops, dname,
        lambda: pa.paged_attention_reference(q, kp, vp, pt, ln)))


QBF16_EXCESS = 1e-3      # quantized, bf16 q: error beyond bf16 rounding


def paged_quant_cases():
    """The quantized branch at row 2's shapes (B 8, H 32/32, page 16, the
    8 mixed lengths), bf16 q as the 7B engine runs it and fp32 q for the
    tight check, plus pages of 8 and 128, a T = 4 frame (GQA 8), head_dim
    64, and an fp8 pool whose dead slots hold NaN codes and scales."""
    import torch

    lens = PAGED_LENS
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    # the page-size and NaN cases draw their own values (see _paged_gen)
    # at std 0.5, as _rand does: a bf16 output of |value| 4 or more can
    # miss TOL by its own rounding (up to 2^-8 of it), whatever computed it
    new = dict(std=0.5, own_gen=True)
    for mode in ("int8", "fp8"):
        h32 = dict(mode=mode, t=1, hq=32, hkv=32, lens=lens, dtype=bf)
        cases += [
            (f"{mode}_decode_b8_h32", h32),
            (f"{mode}_decode_b8_h32_fp32", dict(h32, dtype=f32)),
            (f"{mode}_decode_b8_h32_ps4", dict(h32, ps=4, pages=1024,
                                               **new)),
            (f"{mode}_decode_b8_h32_ps8", dict(h32, ps=8, pages=512, **new)),
            (f"{mode}_decode_b8_h32_ps128", dict(h32, ps=128, pages=32,
                                                 **new)),
            (f"{mode}_frame4_gqa8", dict(mode=mode, t=4, hq=32, hkv=8,
                                         lens=lens[:-1] + [4092], dtype=bf)),
            (f"{mode}_decode_b8_d64", dict(mode=mode, t=1, hq=16, hkv=16,
                                           lens=lens, dtype=bf, d=64))]
    cases.append(("fp8_nan_pool_b8_h32",
                  dict(mode="fp8", t=1, hq=32, hkv=32, lens=lens, dtype=bf,
                       nan_fill=True, **new)))
    return cases


def _quantize_pool(x, mode):
    """The model's quantize-on-write over a [..., D] pool: codes and fp32
    per-slot-per-head scales."""
    import torch

    from paddle_tpu_torch.quantization import quantize_kv

    return quantize_kv(x, torch.int8 if mode == "int8"
                       else torch.float8_e4m3fn)


def run_paged_quant_case(gen, mode, t, hq, hkv, lens, dtype, d=128, ps=16,
                         pages=256, nan_fill=False, std=1.0):
    """The quantized kernel against its plain version on the same codes and
    scales: fp32 q within 1e-5 absolute; bf16 q within QBF16_EXCESS beyond
    the rounding of the fp32 result to bf16 (2^-8 of |ref|), and the row
    check. With `nan_fill` the kernel's dead slots hold NaN codes (e4m3
    0x7F) and NaN scales."""
    import torch

    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    b = len(lens)
    num_pages = b * pages + 1
    kc, ks = _quantize_pool(torch.randn((hkv, num_pages, ps, d),
                                        generator=gen, device="cuda") * std,
                            mode)
    vc, vs = _quantize_pool(torch.randn((hkv, num_pages, ps, d),
                                        generator=gen, device="cuda") * std,
                            mode)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    pt = perm[:b * pages].view(b, pages).to(torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, hq, d) if t == 1 else (b, t, hq, d), dtype)
    counter = f"paged_decode_{mode}"
    ref = pa.paged_attention_reference(q.float(), kc, vc, pt, ln,
                                       k_scales=ks, v_scales=vs)
    if nan_fill:
        dead = ~_live_slots(pt, lens, t, num_pages, ps)
        kc.view(torch.uint8)[:, dead] = 0x7F
        vc.view(torch.uint8)[:, dead] = 0x7F
        ks[:, dead] = float("nan")
        vs[:, dead] = float("nan")
    before = pa.launch_counts()[counter]
    out = pa.paged_attention(q, kc, vc, pt, ln, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    launched = pa.launch_counts()[counter] - before
    dname = str(dtype).replace("torch.", "")
    cmp = _compare(out, ref, dname)
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        excess = err.max().item()
        ok = excess <= 1e-5
    else:
        excess = (err - ref.abs() * 2.0 ** -8).max().item()
        ok = cmp["ok"] and excess <= QBF16_EXCESS
    item = q.element_size()
    # the keys each row needs: 1-byte codes of K and V plus their fp32
    # scales, q in and out, a page id per page touched, the lens
    keys = [n + t - 1 if n > 0 else 0 for n in lens]
    pages_read = sum(-(-n // ps) for n in keys)
    nbytes = (2 * q.numel() * item + 2 * sum(keys) * hkv * (d + 4)
              + pages_read * 4 + b * 4)
    flops = 4 * d * hq * sum(n + i for n in lens if n > 0 for i in range(t))
    return dict(cmp, ok=ok and launched == 1, excess_err=excess,
                excess_tol=1e-5 if dtype == torch.float32 else QBF16_EXCESS,
                **_paged_speed(
                    lambda: pa.paged_attention(q, kc, vc, pt, ln, k_scales=ks,
                                               v_scales=vs),
                    nbytes, flops, dname,
                    lambda: pa.paged_attention_reference(
                        q, kc, vc, pt, ln, k_scales=ks, v_scales=vs)))


def _packed_segments(b, s, docs, shift=0):
    """[b, s] int32 ids of the packer's layout: documents of the lengths
    in `docs` (cycled, row r starting at docs[r + shift]) back to back."""
    import torch

    rows = torch.zeros((b, s), dtype=torch.int32)
    for r in range(b):
        pos, j = 0, 0
        while pos < s:
            n = min(docs[(r + shift + j) % len(docs)], s - pos)
            rows[r, pos:pos + n] = j
            pos, j = pos + n, j + 1
    return rows


VISIT_DOCS = [37, 100, 700, 64, 20, 150, 500, 90, 33, 7, 200, 41]


def engine_frame_segments():
    """Segment ids of the one packed frame the 7B engine builds for phase
    4's prompts (17, 60 and 100 tokens at 32-row aligned starts of a
    256-row frame; pads carry segment 3), and a [4, 2048] frame of the
    packer's layout (documents of 7-700 tokens back to back)."""
    import torch

    frame = torch.full((1, 256), 3, dtype=torch.int32)
    off = 0
    for j, n in enumerate((17, 60, 100)):
        frame[0, off:off + n] = j
        off += -(-n // 32) * 32
    return {"engine_frame_s256": frame.cuda(),
            "packed_b4_s2048": _packed_segments(4, 2048, VISIT_DOCS).cuda()}


def visit_cases():
    """(label, kind, kwargs): the flash counter over the engine's frame and
    packed frames (the training geometry B 1 x S 4096, a long S 32768 row,
    blocks other than the forward's 64 x 64 and not causal) and the page
    counter over decode batches of 8 and 256 rows at pages of 1, 4 and 16
    (max_seq_len 4096), lens 0 and over capacity included."""
    import numpy as np

    frames = engine_frame_segments()
    s4096 = _packed_segments(1, 4096, VISIT_DOCS).cuda()
    cases = [(f"flash_{k}", "flash", dict(seg=v))
             for k, v in frames.items()]
    cases += [
        ("flash_packed_b1_s4096", "flash", dict(seg=s4096)),
        ("flash_packed_b1_s32768", "flash",
         dict(seg=_packed_segments(1, 32768, VISIT_DOCS + [4000, 9000],
                                   shift=3).cuda())),
        ("flash_bq64_bk32_s4096", "flash", dict(seg=s4096, bq=64, bk=32)),
        ("flash_bq32_bk128_s4096", "flash", dict(seg=s4096, bq=32, bk=128)),
        ("flash_bq1_bk1_s4096", "flash", dict(seg=s4096, bq=1, bk=1)),
        ("flash_packed_b4_s2048_noncausal", "flash",
         dict(seg=frames["packed_b4_s2048"], causal=False)),
        ("paged_decode_b8", "paged",
         dict(lens=[0, 1, 17, 4095, 100, 2048, 300, 3000]))]
    rng = np.random.default_rng(0)
    for ps in (1, 4, 16):
        pages = 4096 // ps
        lens = [0, 0, 4096, 5000, 2**31 - 1] + rng.integers(
            0, 4096 + 3 * ps, 251).tolist()
        cases.append((f"paged_b256_ps{ps}", "paged",
                      dict(lens=lens, ps=ps, pages_per_seq=pages)))
    return cases


def _device_ms_retry(fn, name):
    """Device ms a call of `fn` of its kernels named `name`; the profiler
    can drop a whole window's events, so up to 3 windows are taken."""
    for _ in range(3):
        by = _device_ms_by_kernel(fn)
        hits = [ms for k, ms in by.items() if name in k]
        if hits:
            return sum(hits)
    raise AssertionError(f"the profiler recorded no {name} in 3 windows")


def launch_floor_ms():
    """Device ms of one 1-element torch fill: what any launch costs."""
    import torch

    one = torch.empty(1, device="cuda")
    return _device_ms_retry(lambda: one.fill_(1.0), "")


def run_flash_visit_case(seg, bq=None, bk=None, causal=True):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    bq, bk = bq or fa.FWD_BLOCK_Q, bk or fa.FWD_BLOCK_K
    got = fa.segment_block_visit_counts(seg, bq, bk, causal)
    plain = fa.segment_block_visit_reference(seg, bq, bk, causal)
    exact = bool((got == plain).all())
    call = lambda: fa.segment_block_visit_counts(seg, bq, bk, causal)  # noqa
    call_ms = _cuda_ms(call)
    ms = _device_ms_retry(call, "flash_visit_kernel")
    plain_ms = _cuda_ms(lambda: fa.segment_block_visit_reference(
        seg, bq, bk, causal))
    b, s = seg.shape
    nq, nk = s // bq, s // bk
    # each id read once, a count written; one range test a (causal) pair
    # of blocks plus the min/max of each block's ids
    tests = b * sum((-(-(i + 1) * bq // bk) if causal else nk)
                    for i in range(nq))
    bound_ms, bound_by = _bound(seg.numel() * 4 + b * nq * 4,
                                2 * seg.numel() + 2 * tests, "float32")
    return dict(ok=exact, max_abs_err=0 if exact else None,
                visited=int(got.sum()), causal_blocks=tests, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, blocks=[bq, bk],
                causal=causal)


def run_page_visit_case(lens, ps=16, pages_per_seq=256):
    import torch

    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = pa.page_visit_counts(ln, ps, pages_per_seq)
    plain = pa.page_visit_reference(ln, ps, pages_per_seq)
    closed = [min(-(-n // ps), pages_per_seq) for n in lens]
    exact = bool((got == plain).all()) and got.tolist() == closed
    call = lambda: pa.page_visit_counts(ln, ps, pages_per_seq)  # noqa
    call_ms = _cuda_ms(call)
    ms = _device_ms_retry(call, "page_visit_kernel")
    plain_ms = _cuda_ms(lambda: pa.page_visit_reference(ln, ps,
                                                        pages_per_seq))
    bound_ms, bound_by = _bound(8 * len(lens), len(lens) * pages_per_seq,
                                "float32")
    return dict(ok=exact, max_abs_err=0 if exact else None,
                visited=int(got.sum()), pages=len(lens) * pages_per_seq,
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, page_size=ps)


def run_visit_cases():
    """{label: result} of every visit case, each with the launch floor
    measured beside it in the same process."""
    floor = launch_floor_ms()
    out = {}
    for label, kind, kw in visit_cases():
        r = (run_flash_visit_case(**kw) if kind == "flash"
             else run_page_visit_case(**kw))
        r["launch_floor_ms"] = floor
        out[label] = r
        total = r["causal_blocks"] if kind == "flash" else r["pages"]
        print(f"{kind}_visit {label}: exact {r['ok']} visited "
              f"{r['visited']}/{total} ms {r['ms']:.4f} (device; launch "
              f"floor {floor:.4f}; call {r['call_ms']:.4f}) plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.6f}",
              flush=True)
    return out


def _device_ms_by_kernel(fn, reps=5):
    """{kernel name: device ms per call of `fn`} over `reps` calls, from
    torch.profiler: a kernel's mean over the launches the profiler
    recorded, times its launches a call. The profiler drops a launch's
    event now and then, so the recorded launches are counted, and the
    launches a call are their count over `reps`, rounded; it also drops
    whole windows, now and then several in a row, so a window with no
    kernel at all (every `fn` here launches one) is taken again after a
    pause, up to 5 times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.self_device_time_total / 1e3 / e.count
              * max(1, round(e.count / reps))
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0}
        if by:
            return by
        time.sleep(0.05)
    return by


def _kernel_ms(by_kernel, name):
    hits = [ms for key, ms in by_kernel.items() if name in key]
    if len(hits) != 1:
        raise AssertionError(f"profiler found {len(hits)} kernels named "
                             f"{name}: {sorted(by_kernel)}")
    return hits[0]


def _device_ms_sum(fn, *names):
    """Device ms per call of `fn`, summed over its kernels whose names hold
    one of `names` (all its kernels when none is given)."""
    return sum(ms for key, ms in _device_ms_by_kernel(fn).items()
               if not names or any(n in key for n in names))


def _paged_device_ms(fn):
    """Device ms per call of a paged-attention wrapper: the decode kernel
    plus the split-K merge (`device_ms`), each apart, without the
    wrapper's host work that the event-timed ms includes; and the names of
    the decode kernels that ran (`kernels`)."""
    for _ in range(3):      # the profiler can drop a whole window's events
        by = _device_ms_by_kernel(fn)
        dec = {re.search(r"paged_decode_kernel\w*", k).group(0): ms
               for k, ms in by.items() if "paged_decode_kernel" in k}
        if dec:
            break
    else:
        raise AssertionError("the profiler recorded no paged decode kernel "
                             "in 3 windows")
    comb = sum(ms for k, ms in by.items() if "paged_combine_kernel" in k)
    return dict(device_ms=sum(dec.values()) + comb,
                decode_ms=sum(dec.values()), combine_ms=comb,
                kernels=sorted(dec))


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
        # the 64-row tiles' ragged edge: the last q and K tile hold 40 rows
        ("causal_s1000_ragged", dict(s=1000, hq=32, hkv=32, dtype=bf)),
        ("noncausal_s1000_ragged", dict(s=1000, hq=32, hkv=32, dtype=bf,
                                        causal=False)),
        ("packed_gqa_s2048_d64_b2", dict(s=2048, hq=16, hkv=4, dtype=bf,
                                         d=64, b=2, seg=_packed_rows())),
    ]


def run_flash_bwd_case(gen, s, hq, hkv, dtype, seg=None, d=128, b=1,
                       causal=True):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    q = _rand(gen, (b, s, hq, d), dtype)
    k = _rand(gen, (b, s, hkv, d), dtype)
    v = _rand(gen, (b, s, hkv, d), dtype)
    do = _rand(gen, (b, s, hq, d), dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      segment_ids=seg)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   segment_ids=seg)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        causal=causal, segment_ids=seg)
    dname = str(dtype).replace("torch.", "")
    cmp = {n: _compare(g, r, dname) for n, g, r in zip(("dq", "dk", "dv"),
                                                       grads, refs)}
    del grads, refs
    torch.cuda.empty_cache()
    call = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, causal=causal, segment_ids=seg)
    ms = _cuda_ms(call)
    split = _device_ms_by_kernel(call)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids=seg), reps=3,
        warmup=1)
    torch.cuda.empty_cache()
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    if seg is None:
        kw = dict(is_causal=causal)
        pairs = b * (s * (s + 1) // 2 if causal else s * s)
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
        flops = 2 * products * d * hq * pairs
        bound_ms, bound_by = _bound(nbytes, flops, dname)
        kms = _kernel_ms(split, f"flash_bwd_{name}_kernel")
        kplain_ms = _cuda_ms(lambda: plain(  # noqa: B023
            q, k, v, out, lse, do, causal=causal, segment_ids=seg), reps=3,
            warmup=1)
        torch.cuda.empty_cache()
        errs = [cmp["dq"]] if name == "dq" else [cmp["dk"], cmp["dv"]]
        rows[name] = dict(
            ms=kms, plain_ms=kplain_ms, library_ms=None, bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / kms, flops=flops,
            tflops=flops / kms / 1e9,
            max_abs_err=max(c["max_abs_err"] for c in errs),
            max_rel_err=max(c["max_rel_err"] for c in errs))
    ok = all(c["ok"] for c in cmp.values())
    # the whole function's least work: 5 products (S, dP, dV, dQ, dK)
    bound_ms, bound_by = _bound(
        3 * qo_bytes + 2 * kv_bytes + lse.numel() * 4 + seg_bytes
        + (q.numel() + 2 * k.numel()) * 4, 10 * d * hq * pairs, dname)
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
    call = lambda: fc.ce_stats(x, w, labels)  # noqa: E731
    # device ms: the statistics kernel and its split merge; call_ms adds
    # the wrapper's host work
    ms = _device_ms_sum(call, "ce_stats")
    call_ms = _cuda_ms(call, reps=5)
    plain_ms = _cuda_ms(lambda: fc.ce_stats_reference(x, w, labels), reps=3,
                        warmup=1)
    safe = labels.clamp(0, v - 1)[:, None]

    def library():
        logits = (x @ w.T).float()
        return (logits.amax(-1), torch.logsumexp(logits, -1),
                logits.gather(1, safe)[:, 0], logits.sum(-1))

    library_ms = _device_ms_sum(library)
    library_call_ms = _cuda_ms(library, reps=5)
    flops = 2 * n * v * h
    nbytes = (n + v) * h * x.element_size() + n * 4 + 4 * n * 4
    bound_ms, bound_by = _bound(nbytes, flops,
                                str(dtype).replace("torch.", ""))
    return dict(errs=errs, max_abs_err=max(errs["m"], errs["lse"],
                                           errs["t"]),
                ok=ok, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_call_ms=library_call_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, flops=flops,
                tflops=flops / ms / 1e9)


CE_BWD_RTOL = 1e-5          # dx, dW of ce_bwd: each row, of its max |ref|


def ce_bwd_cases():
    """The fused-CE backward at the LLaMA step's shape (N 4096, H 4096, V
    32000, bf16) at the resolver's default token chunk (131, which the
    kernels round up to 256) and at the autotuner's 1024 and 4096; a ragged
    N of 1000 with ignored tokens and a label = V; label smoothing 0.1 with
    z-loss 1e-4; a ragged V of 32001 (the chunk scratch's row stride padded
    to 32008)."""
    main = dict(n=4096, h=4096, v=32000)
    return [
        ("n4096_h4096_v32000", dict(main)),
        ("n4096_h4096_v32000_c1024", dict(main, chunk=1024)),
        ("n4096_h4096_v32000_c4096", dict(main, chunk=4096)),
        ("ragged_n1000_ignored", dict(n=1000, h=4096, v=32000,
                                      ignored=True)),
        ("smooth0.1_z1e-4_n1024", dict(n=1024, h=4096, v=32000, eps=0.1,
                                       z=1e-4)),
        ("ragged_v32001_n512", dict(n=512, h=4096, v=32001)),
    ]


def _row_rule(got, ref, rtol):
    """(max over rows of |got - ref| / max |ref|, every row within rtol of
    its own max |ref|; a row of zeros exactly)."""
    import torch

    err = (got.double() - ref.double()).abs().amax(-1)
    top = ref.double().abs().amax(-1)
    rel = torch.where(top > 0, err / top.clamp_min(1e-300),
                      torch.where(err > 0, torch.full_like(err, math.inf),
                                  torch.zeros_like(err)))
    return float(rel.max()), bool((err <= rtol * top).all())


def run_ce_bwd_case(gen, n, h, v, chunk=0, eps=0.0, z=0.0, ignored=False):
    """``ce_bwd`` (the kernels) against ``ce_bwd_reference`` on the same
    inputs: x, W and labels as ``run_ce_case`` makes them, lse from the
    forward's ``ce_stats``, a cotangent of 1/N scaled by 0.5-1.5 a token.
    The reference runs at the resolver's default chunk, as today's fp32
    cuBLAS route of the LLaMA step does (at a 1024-token chunk its own
    sum over V drifted by 2e-5 of a row from the fp64 result on an H100,
    past the rule); dx and dW must hold CE_BWD_RTOL per row, and their error
    against the same function in fp64 is printed beside, with the fp32
    reference's own. Device ms of every kernel the C entry launches,
    summed and apart, the reference's device ms in the same call, the
    bound: 7 bf16 products (the logits, and dx and dW as fp32-accurate
    products, 3 each by ``_fp32_product_bound``) or the bytes."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_ce as fc

    x = torch.randn((n, h), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((v, h), generator=gen, device="cuda") * 0.02).bfloat16()
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    if ignored:
        labels[::7] = -100
        labels[3] = v
    ct = (torch.rand((n,), generator=gen, device="cuda") + 0.5) / n
    m, s, _, _ = fc.ce_stats(x, w, labels)
    lse = m + torch.log(s)
    args = (x, w, labels, lse, ct, -100, eps, z)
    torch.cuda.synchronize()
    before = fc.LAUNCHES["ce_bwd"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dx, dw = fc.ce_bwd(*args, chunk)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launched = fc.LAUNCHES["ce_bwd"] - before
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the fp32 reference must not run in TF32")
    ref = fc.ce_bwd_reference(*args, 0)
    cmp = {}
    for name, got, want in (("dx", dx, ref[0]), ("dw", dw, ref[1])):
        rel, ok = _row_rule(got, want, CE_BWD_RTOL)
        cmp[name] = dict(max_rel_err=rel, ok=ok,
                         max_abs_err=(got - want).abs().max().item(),
                         finite=bool(torch.isfinite(got).all()))
    ref64 = fc.ce_bwd_reference(x.double(), w.double(), labels,
                                lse.double(), ct.double(), -100, eps, z, 0)
    for name, got, want, r64 in (("dx", dx, ref[0], ref64[0]),
                                 ("dw", dw, ref[1], ref64[1])):
        cmp[name]["kernel_vs_fp64"] = _row_rule(got, r64, CE_BWD_RTOL)[0]
        cmp[name]["reference_vs_fp64"] = _row_rule(want, r64,
                                                   CE_BWD_RTOL)[0]
    del ref, ref64
    torch.cuda.empty_cache()
    call = lambda: fc.ce_bwd(*args, chunk)  # noqa: E731
    by = _device_ms_by_kernel(call, reps=3)
    kernels = {re.search(r"ce_bwd_\w+_kernel", k).group(0): ms
               for k, ms in by.items() if "ce_bwd" in k}
    ms = sum(kernels.values())
    call_ms = _cuda_ms(call, reps=3, warmup=1)
    ref_ms = _device_ms_sum(lambda: fc.ce_bwd_reference(*args, 0))
    flops = 2 * n * v * h
    nbytes = (n + v) * h * 2 + 12 * n + (n + v) * h * 4
    fp32_prod = _fp32_product_bound(0, flops, 2)[0]
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3 + 2 * fp32_prod
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    plan = fc._bwd_plan(n, v, h, fc.resolve_chunks(n, v, chunk)[0],
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    ok = (launched == 1 and all(c["ok"] and c["finite"]
                                for c in cmp.values()))
    return dict(cmp=cmp, ok=ok, launches=launched, plan=plan,
                chunk=fc.resolve_chunks(n, v, chunk)[0],
                max_abs_err=max(c["max_abs_err"] for c in cmp.values()),
                ms=ms, kernel_ms=kernels, call_ms=call_ms, plain_ms=ref_ms,
                library_ms=None, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                bound_share=bound_ms / ms, tflops=7 * flops / ms / 1e9,
                peak_gb=peak_gb, rtol=CE_BWD_RTOL)


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
    full-width dispatcher layout (4 x 2048 tokens, top-2 of 8 experts), a
    1000-row unaligned layout for block_rows 8, and the dispatcher's layout
    at 64 experts (top-2, 4 x 2048 tokens; only the visit counter runs it:
    more groups than a ballot's 32 lanes)."""
    full, bm, routed = _dispatch_layout(gen, 4 * 2048, 8, 2)
    unal = _unaligned_layout(gen, 1000, 8, 37)
    g64, bm64, routed64 = _dispatch_layout(gen, 4 * 2048, 64, 2)
    return {"dispatch": (full, bm, routed, 8),
            "unaligned_bm8": (unal, 8, int((unal < 8).sum()), 8),
            "dispatch_g64": (g64, bm64, routed64, 64)}


def gmm_fwd_cases(layouts):
    """(label, layout, x shape/dtype/std, w shape/dtype): the main path's
    two forward products at full width (h1 and y in bf16), a bf16 depth of
    96 (TMA's zero fill past d in the last 64-deep slice) and the unaligned
    layout in bf16 and in fp32 (split TF32, 3 passes over the wrapper's
    copy of w^T). Activations are unit scale, weights std 0.02, as in
    training."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("h1_bf16", "dispatch", 1024, 4096, bf, 1.0),
        ("y_bf16", "dispatch", 4096, 1024, bf, 1.0),
        ("d96_bf16", "dispatch", 96, 512, bf, 1.0),
        ("unaligned_bm8_bf16", "unaligned_bm8", 256, 512, bf, 1.0),
        ("unaligned_bm8_fp32", "unaligned_bm8", 256, 512, f32, 1.0),
    ]


def gmm_dx_cases():
    """(label, layout, d, h): the VJP's dx of the main path's two products
    (h1 = x . w1, w1 [8, 1024, 4096]; y = a . w2, w2 [8, 4096, 1024]),
    dx [M, d] = dy [M, h] . w[g]^T through ``GroupedMatmul.backward`` with
    bf16 w and fp32 dy (std 1e-3, as gradients are), and the unaligned
    layout."""
    return [("dx_of_h1", "dispatch", 1024, 4096),
            ("dx_of_y", "dispatch", 4096, 1024),
            ("dx_unaligned_bm8", "unaligned_bm8", 256, 512)]


def _fp32_product_bound(nbytes, flops, passes):
    """(bound ms, bound_by, design ms, was ms) of an fp32-accurate product
    of `flops` whose B operand is exact in bf16 (passes 2) or fp32 (passes
    3). The bound is the card's least time for that function: its bytes,
    or its cheapest fp32-accurate tensor-core route, whichever is larger.
    With one operand exact in bf16, splitting the other into three bf16
    pieces takes 3 bf16 products at 989 TFLOP/s, less than split TF32's 2
    at 495; with neither, split TF32's 3 products at 495 are marginally
    less than bf16's 6 at 989. design ms is this kernel's own ceiling,
    `passes` TF32 products at 495 (or its bytes); was ms the fp32
    CUDA-core bound the split-TF32 kernels replaced."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops * min((3 if passes == 2 else 6) / PEAK_FLOPS["bfloat16"],
                        passes / PEAK_FLOPS["tfloat32"])
    design = max(t_bytes, passes * flops / PEAK_FLOPS["tfloat32"])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", design * 1e3,
            flops / PEAK_FLOPS["float32"] * 1e3)


def _grouped_mm_call(x, w, gids, groups):
    """torch._grouped_mm (bf16 out) over the same groups, where the card's
    torch has it: (a call or None, note)."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm missing"
    offs = _group_offsets(gids, groups)
    wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
    call = lambda: torch._grouped_mm(x, wt, offs=offs)  # noqa: E731
    try:
        call()
    except Exception as e:       # reported, never on the port's path
        return None, f"torch._grouped_mm failed: {e!r}"[:200]
    return call, "torch._grouped_mm, bf16 output"


def _grouped_mm_dw_ms(x, dy, gids, groups):
    """torch._grouped_mm in its 2-D x 2-D mode (x^T [d, M] against dy
    [M, h], offsets along M, out [G, d, h]) with dy cast to bf16 outside
    the timing and a bf16 output; (device ms, note)."""
    import torch

    if not hasattr(torch, "_grouped_mm") or x.dtype != torch.bfloat16:
        return None, "none: torch._grouped_mm missing or x not bf16"
    offs = _group_offsets(gids, groups)
    dyb = dy.to(torch.bfloat16)
    try:
        return _device_ms_sum(lambda: torch._grouped_mm(x.T, dyb,
                                                        offs=offs)), \
            "torch._grouped_mm device ms, bf16 dy, bf16 output"
    except Exception as e:       # reported, never on the port's path
        return None, f"torch._grouped_mm failed: {e!r}"[:200]


def run_gmm_fwd_case(gen, layout, d, h, dtype, std):
    import torch

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    gids, _, need_rows, groups = layout
    m = gids.shape[0]
    x = (torch.randn((m, d), generator=gen, device="cuda") * std).to(dtype)
    w = (torch.randn((groups, d, h), generator=gen, device="cuda")
         * 0.02).to(dtype)
    out = gm.gmm_fwd(x, w, gids)
    torch.cuda.synchronize()
    ref = gm.grouped_matmul_reference(x, w, gids)
    cmp = _compare(out, ref, "float32")
    trash_zero = bool((out[gids == groups] == 0).all())
    del ref
    call = lambda: gm.gmm_fwd(x, w, gids)  # noqa: E731
    # device ms of the kernel; call_ms adds the wrapper's host work (and,
    # for fp32, its split copy of w^T, whose device ms is copy_ms)
    by_kernel = _device_ms_by_kernel(call)
    bf16 = dtype == torch.bfloat16
    ms = _kernel_ms(by_kernel, "gmm_fwd_wgmma" if bf16 else "gmm_fwd_tf32")
    copy_ms = sum(v for k, v in by_kernel.items() if "gmm_fwd" not in k)
    call_ms = _cuda_ms(call)
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_reference(x, w, gids),
                        reps=3, warmup=1)
    lib, library = (None, "none: no PyTorch call computes an fp32 grouped "
                    "product")
    if bf16:
        lib, library = _grouped_mm_call(x, w, gids, groups)
    library_ms = _device_ms_sum(lib) if lib else None
    library_call_ms = _cuda_ms(lib) if lib else None
    flops = 2 * need_rows * d * h
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + m * h * 4 + m * 4)
    if bf16:
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16")
        passes, design_ms, was_bound_ms = 1, bound_ms, None
    else:
        passes = 3
        bound_ms, bound_by, design_ms, was_bound_ms = _fp32_product_bound(
            nbytes, flops, passes)
    return dict(cmp, ok=cmp["ok"] and trash_zero, trash_zero=trash_zero,
                ms=ms, copy_ms=copy_ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_call_ms=library_call_ms,
                library=library, bound_ms=bound_ms, bound_by=bound_by,
                passes=passes, design_bound_ms=design_ms,
                was_bound_ms=was_bound_ms, bound_share=bound_ms / ms,
                design_share=design_ms / ms, flops=flops,
                tflops=flops / ms / 1e9, m=m, d=d, h=h)


class _VjpCtx:
    """What autograd hands ``GroupedMatmul.backward``: the saved (x, w,
    gids), of which the backward reads x only for dx's dtype, and which
    inputs need a gradient (dx alone)."""

    def __init__(self, x, w, gids):
        self.saved_tensors = (x, w, gids)
        self.needs_input_grad = (True, False, False)


def run_gmm_dx_case(gen, layout, d, h):
    """dx = dy . w[g]^T through ``GroupedMatmul.backward`` itself (bf16 w
    as the model holds it, fp32 dy). The saved x is fp32 here, so the
    backward's cast of dx to x's dtype keeps fp32 and the fp32 rule holds
    the kernel's own output."""
    import torch

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    gids, _, need_rows, groups = layout
    m = gids.shape[0]
    dy = torch.randn((m, h), generator=gen, device="cuda") * 1e-3
    w = (torch.randn((groups, d, h), generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    ctx = _VjpCtx(torch.empty((m, d), device="cuda"), w, gids)
    call = lambda: gm.GroupedMatmul.backward(ctx, dy)[0]  # noqa: E731
    out = call()
    torch.cuda.synchronize()
    ref = gm.grouped_matmul_reference(dy, w.transpose(1, 2), gids)
    cmp = _compare(out, ref, "float32")
    trash_zero = bool((out[gids == groups] == 0).all())
    del ref, out
    # the kernel's device ms apart from the wrapper's fp32 copy of w
    by_kernel = _device_ms_by_kernel(call)
    ms = _kernel_ms(by_kernel, "gmm_fwd_tf32")
    copy_ms = sum(v for k, v in by_kernel.items() if "gmm_fwd" not in k)
    call_ms = _cuda_ms(call)
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_reference(
        dy, w.transpose(1, 2), gids), reps=3, warmup=1)
    dyb = dy.to(torch.bfloat16)
    lib, lib_note = _grouped_mm_call(dyb, w.transpose(1, 2), gids, groups)
    flops = 2 * need_rows * d * h
    nbytes = dy.numel() * 4 + w.numel() * 2 + m * 4 + m * d * 4
    bound_ms, bound_by, design_ms, was_bound_ms = _fp32_product_bound(
        nbytes, flops, 2)
    return dict(cmp, ok=cmp["ok"] and trash_zero, trash_zero=trash_zero,
                ms=ms, copy_ms=copy_ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=None, library="none: no PyTorch call computes "
                "an fp32 grouped product",
                bf16_grouped_mm_ms=_device_ms_sum(lib) if lib else None,
                bf16_grouped_mm=lib_note + " (bf16 dy, for scale)",
                bound_ms=bound_ms, bound_by=bound_by, passes=2,
                design_bound_ms=design_ms, was_bound_ms=was_bound_ms,
                bound_share=bound_ms / ms, design_share=design_ms / ms,
                flops=flops, tflops=flops / ms / 1e9, m=m, d=d, h=h)


def gmm_dw_cases():
    """(label, layout, d, h, x dtype): dw1 and dw2 of the main path with
    bf16 x (2 passes), dw1 with fp32 x (3 passes, the tiny fp32 MoE's
    route at full width) and the unaligned layout in both."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return [("dw1_bf16x", "dispatch", 1024, 4096, bf),
            ("dw2_bf16x", "dispatch", 4096, 1024, bf),
            ("dw1_fp32x", "dispatch", 1024, 4096, f32),
            ("unaligned_bm8_bf16x", "unaligned_bm8", 256, 512, bf),
            ("unaligned_bm8_fp32x", "unaligned_bm8", 256, 512, f32)]


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
    del ref, dw
    call = lambda: gm.gmm_dw(x, dy, gids, groups)  # noqa: E731
    # device ms: the three kernels the C entry launches (the x^T pass, the
    # chunk walk, the product), each printed; other_ms is any other kernel
    # of the call (none expected); call_ms is the whole wrapper, event-timed
    by_kernel = _device_ms_by_kernel(call)
    xt_ms = _kernel_ms(by_kernel, "gmm_xt")
    walk_ms = _kernel_ms(by_kernel, "gmm_dw_walk")
    product_ms = _kernel_ms(by_kernel, "gmm_dw_tf32")
    ms = xt_ms + walk_ms + product_ms
    other_ms = sum(by_kernel.values()) - ms
    call_ms = _cuda_ms(call)
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_dw_reference(
        x, dy, gids, groups), reps=3, warmup=1)
    lib_ms, lib_note = (_grouped_mm_dw_ms(x, dy, gids, groups) if aligned
                        else (None, "not timed: groups not block-aligned"))
    flops = 2 * need_rows * d * h
    nbytes = (x.numel() * x.element_size() + dy.numel() * 4 + m * 4
              + groups * d * h * 4)
    passes = 2 if dtype == torch.bfloat16 else 3
    bound_ms, bound_by, design_ms, was_bound_ms = _fp32_product_bound(
        nbytes, flops, passes)
    return dict(cmp, ok=cmp["ok"] and empty_zero, empty_groups_zero=empty_zero,
                empty_groups=int((~present).sum()), ms=ms, xt_ms=xt_ms,
                walk_ms=walk_ms, product_ms=product_ms, other_ms=other_ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=None,
                library="none: no PyTorch call computes an fp32 grouped "
                "product", bf16_grouped_mm_ms=lib_ms,
                bf16_grouped_mm=lib_note + " (for scale)",
                bound_ms=bound_ms, bound_by=bound_by, passes=passes,
                design_bound_ms=design_ms, was_bound_ms=was_bound_ms,
                bound_share=bound_ms / ms, design_share=design_ms / ms,
                flops=flops, tflops=flops / ms / 1e9)


def run_gmm_visit_case(layout):
    import numpy as np

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    gids, bm, _, groups = layout
    got = gm.grouped_matmul_visit_counts(gids, groups, bm)
    plain = gm.grouped_matmul_visit_reference(gids, groups, bm)
    want = gm.expected_visit_counts(gids.cpu().numpy(), groups, bm)
    exact = (bool((got == plain).all())
             and np.array_equal(got.cpu().numpy(), want))
    call = lambda: gm.grouped_matmul_visit_counts(gids, groups, bm)  # noqa
    call_ms = _cuda_ms(call)
    ms = _device_ms_retry(call, "gmm_visit_kernel")
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_visit_reference(
        gids, groups, bm))
    blocks = gids.shape[0] // bm
    bound_ms, bound_by = _bound(gids.shape[0] * 4 + blocks * 4,
                                blocks * groups, "float32")
    return dict(ok=exact, max_abs_err=0 if exact else None,
                visited_tiles=int(got.sum()), total_tiles=blocks * groups,
                blocks=blocks, block_rows=bm, groups=groups, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def run_gmm_visit_cases(layouts):
    """{label: result} of the grouped visit counter over `layouts`
    (``gmm_layouts``), each exact against both plain versions, with the
    launch floor measured beside it in the same process."""
    floor = launch_floor_ms()
    out = {}
    for label, lay in layouts.items():
        out[label] = r = run_gmm_visit_case(lay)
        r["launch_floor_ms"] = floor
        print(f"gmm_visit {label}: exact {r['ok']} visited "
              f"{r['visited_tiles']}/{r['total_tiles']} (block_rows "
              f"{r['block_rows']}, G {r['groups']}) ms {r['ms']:.4f} "
              f"(device; launch floor {floor:.4f}; call "
              f"{r['call_ms']:.4f}) plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.6f}", flush=True)
    return out


def _multi_group_tiles(gids, groups, rows=128):
    """How many of the bf16 gmm_fwd kernel's 128-row tiles run more than
    one group pass (the rows past M pad the last tile as trash)."""
    import numpy as np

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    g = gids.cpu().numpy()
    g = np.concatenate([g, np.full(-len(g) % rows, groups, np.int32)])
    return int((gm.expected_visit_counts(g, groups, rows) > 1).sum())


def phase_gmm(gen, report):
    import torch

    layouts = gmm_layouts(gen)
    multi = {label: _multi_group_tiles(lay[0], lay[3])
             for label, lay in layouts.items()}
    print(f"gmm layouts: 128-row tiles holding more than one group "
          f"{json.dumps(multi)}", flush=True)
    fwd, dx, dw = {}, {}, {}
    for label, lay, d, h, dtype, std in gmm_fwd_cases(layouts):
        fwd[label] = r = run_gmm_fwd_case(gen, layouts[lay], d, h, dtype,
                                          std)
        lib = (f"{r['library_ms']:.4f} (call {r['library_call_ms']:.4f})"
               if r["library_ms"] is not None else "none")
        print(f"gmm_fwd {label}: err {r['max_abs_err']:.3g} row rel "
              f"{r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) trash zero "
              f"{r['trash_zero']} ms {r['ms']:.4f} (device; call "
              f"{r['call_ms']:.4f}, copies {r['copy_ms']:.4f}) "
              f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.1%} of bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}; design "
              f"{r['design_bound_ms']:.4f}, {r['passes']} pass(es), "
              f"{r['design_share']:.1%}) plain_ms {r['plain_ms']:.3f} "
              f"library_ms {lib} ({r['library']})", flush=True)
        torch.cuda.empty_cache()
    for label, lay, d, h in gmm_dx_cases():
        dx[label] = r = run_gmm_dx_case(gen, layouts[lay], d, h)
        scale = (f"{r['bf16_grouped_mm_ms']:.4f}"
                 if r["bf16_grouped_mm_ms"] is not None else "none")
        print(f"gmm_dx {label}: err {r['max_abs_err']:.3g} row rel "
              f"{r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) trash zero "
              f"{r['trash_zero']} ms {r['ms']:.4f} (device; w.float() "
              f"{r['copy_ms']:.4f}; backward call {r['call_ms']:.4f}) "
              f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.1%} of bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}; design "
              f"{r['design_bound_ms']:.4f} in 2 TF32 passes, "
              f"{r['design_share']:.1%}; was {r['was_bound_ms']:.4f} on the "
              f"CUDA cores) plain_ms "
              f"{r['plain_ms']:.3f} library_ms none; bf16 _grouped_mm "
              f"{scale} ({r['bf16_grouped_mm']})", flush=True)
        torch.cuda.empty_cache()
    for label, lay, d, h, dtype in gmm_dw_cases():
        dw[label] = r = run_gmm_dw_case(gen, layouts[lay], d, h, dtype,
                                        lay == "dispatch")
        scale = (f"{r['bf16_grouped_mm_ms']:.4f}"
                 if r["bf16_grouped_mm_ms"] is not None else "none")
        print(f"gmm_dw {label}: err {r['max_abs_err']:.3g} row rel "
              f"{r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) empty groups "
              f"{r['empty_groups']} zero {r['empty_groups_zero']} ms "
              f"{r['ms']:.4f} (device: x^T {r['xt_ms']:.4f} + walk "
              f"{r['walk_ms']:.4f} + product {r['product_ms']:.4f}; other "
              f"{r['other_ms']:.4f}; call {r['call_ms']:.4f}) "
              f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.1%} of bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}; design "
              f"{r['design_bound_ms']:.4f} in {r['passes']} TF32 passes, "
              f"{r['design_share']:.1%}; was {r['was_bound_ms']:.4f} on "
              f"the CUDA cores) plain_ms "
              f"{r['plain_ms']:.3f} library_ms none; bf16 _grouped_mm "
              f"{scale} ({r['bf16_grouped_mm']})", flush=True)
        torch.cuda.empty_cache()
    visit = run_gmm_visit_cases(layouts)
    report["gmm_fwd_cases"], report["gmm_dw_cases"] = fwd, dw
    report["gmm_dx_cases"] = dx
    report["gmm_visit_cases"], report["gmm_multi_group_tiles"] = visit, multi
    return ([f"gmm_fwd {k}" for k, r in fwd.items() if not r["ok"]]
            + [f"gmm_dx {k}" for k, r in dx.items() if not r["ok"]]
            + [f"gmm_dw {k}" for k, r in dw.items() if not r["ok"]]
            + [f"gmm_visit {k}" for k, r in visit.items() if not r["ok"]])


def _paged_kernel_check(r, dtype, ps):
    """A paged case must have run the decode kernel its q dtype and page
    size route to, and only it (bf16 q at a page size that is a multiple
    of 8: the tensor-core kernel; else the CUDA-core one)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    want = [PAGED_KERNEL["bfloat16" if pa.kernel_route(dtype, ps)
                         == pa.ROUTE_MMA else "float32"]]
    r["kernel_ok"] = r["kernels"] == want
    r["ok"] = r["ok"] and r["kernel_ok"]


def _paged_speed_text(r):
    return (f"ms {r['ms']:.4f} (device: decode {r['decode_ms']:.4f} + "
            f"combine {r['combine_ms']:.4f}; call {r['call_ms']:.4f}, host "
            f"{r['host_ms']:.4f}) "
            f"{r['gbps']:.1f} GB/s, {r['bound_share']:.1%} of bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) plain_ms "
            f"{r['plain_ms']:.4f} kernels {r['kernels']}")


def phase_kernels(seed, report):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flash = {}
    for label, kw in flash_cases(gen):
        flash[label] = r = run_flash_case(gen, **kw)
        print(f"flash {label}: err {r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"row rel {r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) "
              f"lse_err {r['lse_err']:.3g} ms {r['ms']:.4f} (device; call "
              f"{r['call_ms']:.4f}) {r['tflops']:.2f} TFLOP/s, "
              f"{r['bound_share']:.1%} of bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms {r['library_ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f}", flush=True)
    paged = {}
    for label, kw in paged_cases():
        g, kw = _paged_gen(gen, seed, label, kw)
        paged[label] = r = run_paged_case(g, **kw)
        _paged_kernel_check(r, kw["dtype"], kw.get("ps", 16))
        print(f"paged {label}: err {r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"row rel {r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) "
              + _paged_speed_text(r), flush=True)
        torch.cuda.empty_cache()
    report["flash_cases"], report["paged_cases"] = flash, paged
    torch.cuda.empty_cache()      # the plain versions' S=4096 scores
    paged_q = {}
    for label, kw in paged_quant_cases():
        g, kw = _paged_gen(gen, seed, label, kw)
        paged_q[label] = r = run_paged_quant_case(g, **kw)
        _paged_kernel_check(r, kw["dtype"], kw.get("ps", 16))
        print(f"paged {label}: err {r['max_abs_err']:.3g} beyond rounding "
              f"{r['excess_err']:.3g} (tol {r['excess_tol']}) row rel "
              f"{r['max_rel_err']:.3g} " + _paged_speed_text(r), flush=True)
        torch.cuda.empty_cache()
    visits = run_visit_cases()
    report["paged_quant_cases"], report["visit_cases"] = paged_q, visits
    bwd = {}
    for label, kw in flash_bwd_cases(gen):
        bwd[label] = r = run_flash_bwd_case(gen, **kw)
        errs = " ".join(f"{n} {c['max_abs_err']:.3g}/{c['max_rel_err']:.3g}"
                        for n, c in r["cmp"].items())
        kern = " ".join(f"{n} {k['ms']:.3f} ms ({k['tflops']:.2f} TFLOP/s, "
                        f"{k['bound_share']:.1%} of bound "
                        f"{k['bound_ms']:.4f}, plain {k['plain_ms']:.3f})"
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
              f"{CE_TOL}, sl {CE_SL_TOL} * V) ms {r['ms']:.4f} (device, "
              f"with the merge; call {r['call_ms']:.4f}) "
              f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.1%} of bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) plain_ms "
              f"{r['plain_ms']:.3f} library_ms {r['library_ms']:.4f} (call "
              f"{r['library_call_ms']:.4f})", flush=True)
        torch.cuda.empty_cache()
    report["flash_bwd_cases"], report["ce_cases"] = bwd, ce
    ce_bwd = {}
    for label, kw in ce_bwd_cases():
        ce_bwd[label] = r = run_ce_bwd_case(gen, **kw)
        errs = " ".join(
            f"{n} {c['max_rel_err']:.3g} (fp64: kernel "
            f"{c['kernel_vs_fp64']:.3g}, reference "
            f"{c['reference_vs_fp64']:.3g})" for n, c in r["cmp"].items())
        kern = " ".join(f"{k} {v:.4f}"
                        for k, v in sorted(r["kernel_ms"].items()))
        print(f"ce_bwd {label}: chunk {r['chunk']} -> {r['plan']['cr']}, "
              f"dx splits {r['plan']['splits']}; row rel err {errs} (rtol "
              f"{r['rtol']}) launches {r['launches']} ms {r['ms']:.4f} "
              f"(device, all kernels; call {r['call_ms']:.4f}) [{kern}] "
              f"{r['tflops']:.1f} TFLOP/s (7 bf16 products), "
              f"{r['bound_share']:.1%} of bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}); fp32 cuBLAS route (ce_bwd_reference) "
              f"{r['plain_ms']:.4f} ms device; peak {r['peak_gb']:.3f} GB "
              f"above inputs", flush=True)
        torch.cuda.empty_cache()
    report["ce_bwd_cases"] = ce_bwd
    bad = [f"flash {k}" for k, r in flash.items() if not r["ok"]] + \
          [f"paged {k}" for k, r in paged.items() if not r["ok"]] + \
          [f"paged {k}" for k, r in paged_q.items() if not r["ok"]] + \
          [f"visit {k}" for k, r in visits.items() if not r["ok"]] + \
          [f"flash_bwd {k}" for k, r in bwd.items() if not r["ok"]] + \
          [f"ce_stats {k}" for k, r in ce.items() if not r["ok"]] + \
          [f"ce_bwd {k}" for k, r in ce_bwd.items() if not r["ok"]] + \
          phase_gmm(gen, report) + phase_gmm_lora(gen, report)
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
    page4 = _bf16_page4_cuda_vs_cpu(cfg, seed, prompts)
    report["cuda_vs_cpu"]["bf16_page4"] = page4
    if not page4["ok"]:
        raise AssertionError(f"the bf16 page-4 engine: CUDA and CPU differ "
                             f"or the paged kernel did not run: {page4}")


def _bf16_page4_cuda_vs_cpu(cfg, seed, prompts):
    """bf16 q at a page size that is not a multiple of 8, which runs the
    CUDA-core paged kernel: the phase's model in bf16 with bf16 pages of 4
    keys serves the phase's prompts on the CPU (plain versions), on CUDA
    (kernels), and on CUDA with the model's paged attention swapped for
    its plain version, so the paged kernel is the only difference from
    the CUDA run. Gates: page tables after the first step equal to the
    CPU's; the CUDA streams equal to the plain-paged CUDA streams; the
    first decode step's logits within BF16_LOGIT_RTOL of the CPU's; the
    kernel launched. The streams' agreement with the CPU is reported: a
    bf16 model's prefill rounds in another order on each device (flash's
    P in bf16, cuBLAS), which can part a near-tie at any page size."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models import llama as llama_mod
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.serving import ServingEngine

    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    cpu_model = LlamaForCausalLM(bcfg, device="cpu", seed=seed)
    gpu_model = LlamaForCausalLM(bcfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    kw = dict(page_size=4, num_pages=512, decode_batch=4, prefill_chunk=64,
              pack_frame=128, max_seq_len=256, prefix_sharing=False)

    def serve(model, dev):
        eng = ServingEngine(model, _engine_cfg(**kw), device=dev)
        port_cuda.reset_launch_counts()
        tables = []

        def hook(_mod, _inp, out):
            if not tables:       # the first decode step, in admission order
                tables.extend(
                    eng.allocator.page_table_row(r.rid, eng.pages_per_seq)
                    .tolist() for r in eng.scheduler.running)
        handle = eng.model.lm_head.register_forward_hook(hook)
        try:
            streams, logits = _first_decode_logits(eng, prompts, 12)
        finally:
            handle.remove()
        eng.allocator.check_consistency()
        return dict(tables=tables, streams=streams, logits=logits,
                    paged_decode=port_cuda.launch_counts()["paged_decode"])

    runs = {"cpu": serve(cpu_model, "cpu"), "cuda": serve(gpu_model, "cuda")}
    kernel = llama_mod.paged_attention
    llama_mod.paged_attention = pa.paged_attention_reference
    try:
        runs["cuda_plain_paged"] = serve(gpu_model, "cuda")
    finally:
        llama_mod.paged_attention = kernel
    c, g, p = runs["cpu"], runs["cuda"], runs["cuda_plain_paged"]
    rel = ((g["logits"] - c["logits"]).abs().amax(-1)
           / c["logits"].abs().amax(-1)).max().item()
    out = dict(tables_equal=c["tables"] == g["tables"],
               streams_equal_plain_paged=g["streams"] == p["streams"],
               first_logits_max_rel_err=rel, rtol=BF16_LOGIT_RTOL,
               paged_decode_launches=g["paged_decode"],
               plain_paged_launches=p["paged_decode"],
               stream_agreement_with_cpu=[
                   sum(a == b for a, b in zip(x, y)) / len(y)
                   for x, y in zip(g["streams"], c["streams"])],
               streams=g["streams"])
    out["ok"] = (out["tables_equal"] and out["streams_equal_plain_paged"]
                 and rel <= BF16_LOGIT_RTOL and g["paged_decode"] > 0
                 and p["paged_decode"] == 0)
    print(f"bf16 page-4 engine: page tables equal to the cpu's "
          f"{out['tables_equal']}, streams equal to plain-paged cuda "
          f"{out['streams_equal_plain_paged']}, first-step logits rel err "
          f"{rel:.4g} (<= {BF16_LOGIT_RTOL}), paged_decode launches "
          f"{g['paged_decode']} (plain run {p['paged_decode']}), stream "
          f"agreement with the cpu {out['stream_agreement_with_cpu']}",
          flush=True)
    return out


def _tier_run(eng, prompt, fillers, new_tokens):
    """Serve `prompt`, then `fillers` (which must push the prompt's cold
    pages to the host), then `prompt` again (its match promotes them):
    (first stream, second stream, allocator counters)."""
    first = eng.generate([prompt], max_new_tokens=new_tokens)[0]
    eng.generate(fillers, max_new_tokens=new_tokens)
    demoted = eng.allocator.demotions
    again = eng.generate([prompt], max_new_tokens=new_tokens)[0]
    eng.allocator.check_consistency()
    counters = {k: getattr(eng.allocator, k) for k in (
        "prefix_matches", "prefix_tokens_matched", "cow_copies", "demotions",
        "promotions", "cold_hits", "dropped_cold", "promote_failures")}
    return first, again, {"demotions_before_rerun": demoted, **counters}


def phase_kv_cuda_vs_cpu(seed, report):
    """The KV hierarchy on CUDA (kernels) against the CPU (plain versions):
    the phase-3 model with int8 and fp8 pools, prefix sharing and a host
    tier serves three requests sharing a 64-token system prompt, then a
    100-token prompt, two 200-token fillers that demote its pages to the
    host, and the 100-token prompt again (promoted). Streams and
    allocator counters must be equal, and the re-served stream equal to
    the first."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_tiny_config(vocab_size=1024, hidden_size=512,
                            intermediate_size=1024, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            max_position_embeddings=512)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.RandomState(seed + 1)
    system = rng.randint(1, cfg.vocab_size, 64).astype(np.int32)
    shared = [np.concatenate([system, rng.randint(1, cfg.vocab_size, n)
                              .astype(np.int32)]) for n in (9, 40, 0)]
    prompt = rng.randint(1, cfg.vocab_size, 100).astype(np.int32)
    fillers = [rng.randint(1, cfg.vocab_size, 200).astype(np.int32)
               for _ in range(2)]
    kw = dict(page_size=16, num_pages=24, decode_batch=4, prefill_chunk=64,
              pack_frame=128, max_seq_len=256, prefix_sharing=True,
              host_cache_mb=1)
    out, bad = {}, []
    for mode in ("int8", "fp8"):
        runs = {}
        for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            eng = ServingEngine(model, _engine_cfg(kv_cache_dtype=mode, **kw),
                                device=dev)
            streams = eng.generate(shared, max_new_tokens=8)
            first, again, counters = _tier_run(eng, prompt, fillers, 8)
            runs[dev] = {"shared": streams, "first": first, "again": again,
                         "counters": counters,
                         "prefix_hit_rate": eng.stats()["prefix_hit_rate"]}
        c, g = runs["cpu"], runs["cuda"]
        equal = all(c[k] == g[k] for k in ("shared", "first", "again",
                                           "counters"))
        round_trip = (g["again"] == g["first"]
                      and g["counters"]["demotions_before_rerun"] > 0
                      and g["counters"]["promotions"] > 0)
        shared_hit = g["counters"]["prefix_matches"] >= 2
        out[mode] = dict(runs, equal=equal, round_trip_same_stream=round_trip,
                         prefix_adopted=shared_hit)
        print(f"kv {mode} cuda vs cpu: streams and counters equal {equal}, "
              f"demote/promote round trip same stream {round_trip}, "
              f"counters {json.dumps(g['counters'])}", flush=True)
        if not (equal and round_trip and shared_hit):
            bad.append(mode)
    out["bf16"] = _kv_bf16_cuda_vs_cpu(cfg, seed, kw, shared, bad)
    report["kv_cuda_vs_cpu"] = out
    if bad:
        raise AssertionError(f"KV hierarchy CUDA vs CPU failed for {bad}")


def _serve_trace(eng, prompts, new_tokens):
    """Serve `prompts` one step at a time; returns (streams, trace, stats):
    after each step, each request's committed count and page table row,
    by submission index (what a step accepted, and the chains it grew)."""
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    trace = []
    while eng.busy:
        eng.step()
        eng.allocator.check_consistency()
        trace.append([(len(eng.scheduler.get(r).generated),
                       eng.allocator.page_table_row(r, eng.pages_per_seq)
                       .tolist()) for r in rids])
    streams = [list(eng.scheduler.get(r).generated) for r in rids]
    for r in rids:
        eng.release(r)
    return streams, trace, eng.stats()


def phase_spec_cuda_vs_cpu(seed, report):
    """Speculative decoding on CUDA (the paged kernel in its verify frame)
    against the CPU (plain versions): phase 3's fp32 GQA model at spec_k
    3 over fp32, int8 and fp8 pools, and a GQA 8:1 model (8 query heads
    of 64 on one kv head) at spec_k 8, whose 72-row frames the wrapper
    cuts into two launches; prefix sharing on, prompts behind a shared
    system prompt and two that repeat a span (so drafts are accepted).
    Gates: the CUDA speculative streams equal the CUDA plain engine's and
    the CPU speculative engine's; page tables and each step's committed
    counts (the accepted drafts) equal the CPU's; the allocator consistent
    and every page free after the run; the paged kernel launched in every
    verify step (twice a layer at GQA 8:1)."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import ServingEngine

    base = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                num_hidden_layers=2, max_position_embeddings=512)
    cfgs = {"gqa2": llama_tiny_config(num_attention_heads=4,
                                      num_key_value_heads=2, **base),
            "gqa8": llama_tiny_config(num_attention_heads=8,
                                      num_key_value_heads=1, **base)}
    cases = [("gqa2_fp32_k3", "gqa2", "model", 3),
             ("gqa2_int8_k3", "gqa2", "int8", 3),
             ("gqa2_fp8_k3", "gqa2", "fp8", 3),
             ("gqa8_fp32_k8", "gqa8", "model", 8)]
    kw = dict(page_size=16, num_pages=128, decode_batch=4, prefill_chunk=64,
              pack_frame=128, max_seq_len=256, prefix_sharing=True)
    rng = np.random.RandomState(seed + 2)
    system = rng.randint(1, 1024, 40).astype(np.int32)
    span = rng.randint(1, 1024, 7).astype(np.int32)
    prompts = ([np.concatenate([system, rng.randint(1, 1024, n)
                                .astype(np.int32)]) for n in (5, 30, 60)]
               + [np.tile(span, 6), np.tile(span[:4], 9)])
    models = {}
    out, bad = {}, []
    for label, arch, mode, k in cases:
        if arch not in models:
            cpu_model = LlamaForCausalLM(cfgs[arch], device="cpu", seed=seed)
            gpu_model = LlamaForCausalLM(cfgs[arch], device="cuda")
            gpu_model.load_state_dict(cpu_model.state_dict())
            models[arch] = (cpu_model, gpu_model)
        cpu_model, gpu_model = models[arch]
        runs = {}
        for name, dev, model, spec in (("cpu", "cpu", cpu_model, k),
                                       ("cuda", "cuda", gpu_model, k),
                                       ("cuda_plain", "cuda", gpu_model, 0)):
            eng = ServingEngine(model, _engine_cfg(
                kv_cache_dtype=mode, spec_k=spec, **kw), device=dev)
            port_cuda.reset_launch_counts()
            streams, trace, stats = _serve_trace(eng, prompts, 16)
            counts = port_cuda.launch_counts()
            runs[name] = dict(
                streams=streams, trace=trace,
                steps=stats["decode_steps"],
                accepted_tokens_per_step=stats["accepted_tokens_per_step"],
                paged_launches=sum(counts[n] for n in (
                    "paged_decode", "paged_decode_int8", "paged_decode_fp8")),
                all_free=eng.allocator.free_pages == eng.num_pages - 1)
        c, g, p = runs["cpu"], runs["cuda"], runs["cuda_plain"]
        layers = cfgs[arch].num_hidden_layers
        per_step = 2 * layers if label.startswith("gqa8") else layers
        r = dict(streams_equal_plain=g["streams"] == p["streams"],
                 streams_equal_cpu=g["streams"] == c["streams"],
                 trace_equal_cpu=g["trace"] == c["trace"],
                 accepted_tokens_per_step=g["accepted_tokens_per_step"],
                 cpu_accepted_tokens_per_step=c["accepted_tokens_per_step"],
                 verify_steps=g["steps"], plain_steps=p["steps"],
                 paged_launches=g["paged_launches"],
                 paged_launches_want=per_step * g["steps"],
                 all_free=g["all_free"] and c["all_free"])
        r["ok"] = (r["streams_equal_plain"] and r["streams_equal_cpu"]
                   and r["trace_equal_cpu"] and r["all_free"]
                   and r["paged_launches"] == r["paged_launches_want"])
        out[label] = r
        print(f"spec {label} cuda vs cpu: streams equal to cuda plain "
              f"{r['streams_equal_plain']} and to cpu "
              f"{r['streams_equal_cpu']}, page tables and accepted counts "
              f"equal to cpu {r['trace_equal_cpu']}, accepted tokens a "
              f"step {r['accepted_tokens_per_step']} ({r['verify_steps']} "
              f"verify steps against {r['plain_steps']} plain), paged "
              f"launches {r['paged_launches']} (want "
              f"{r['paged_launches_want']}), pages all free "
              f"{r['all_free']}", flush=True)
        if not r["ok"]:
            bad.append(label)
    report["spec_cuda_vs_cpu"] = out
    if bad:
        raise AssertionError(f"speculative CUDA vs CPU failed for {bad}")


# bf16 rounds activations, K/V and logits in another order on each device:
# at |logit| near 2 one bf16 step is 2^-6, and a code one quantization
# step apart adds a step or two; a lost or misapplied scale moves the
# logits by their own size (tests/test_torch_port_kv_hierarchy.py holds
# the CPU path to JAX's bf16 model within the same bound)
BF16_LOGIT_RTOL = 2.0 ** -5


def _first_decode_logits(eng, prompts, new_tokens):
    """Serve `prompts`; return (streams, the first decode step's logits
    [rows, vocab] fp32 on the CPU), read by a forward hook on the LM head
    (prefill never runs the head)."""
    seen = []

    def hook(_mod, _inp, out):
        if not seen:
            seen.append(out[:len(prompts), 0].float().cpu())

    handle = eng.model.lm_head.register_forward_hook(hook)
    try:
        streams = eng.generate(prompts, max_new_tokens=new_tokens)
    finally:
        handle.remove()
    return streams, seen[0]


def _kv_bf16_cuda_vs_cpu(cfg, seed, kw, prompts, bad):
    """The phase's model in bf16 with int8 and fp8 pools, prefix sharing
    off: the shared-prompt requests (packed and chunked prefill, bf16 q
    through the quantized paged kernel) on CUDA against the CPU plain
    versions. The first decode step's logits must agree within
    BF16_LOGIT_RTOL of each row's max |logit|; the streams' agreement is
    reported (bf16 near-ties may part them)."""
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    cpu_model = LlamaForCausalLM(bcfg, device="cpu", seed=seed)
    gpu_model = LlamaForCausalLM(bcfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    kw = dict(kw, prefix_sharing=False, host_cache_mb=0, num_pages=64)
    out = {}
    for mode in ("int8", "fp8"):
        runs = {}
        for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            eng = ServingEngine(model, _engine_cfg(kv_cache_dtype=mode, **kw),
                                device=dev)
            runs[dev] = _first_decode_logits(eng, prompts, 8)
        (cs, cl), (gs, gl) = runs["cpu"], runs["cuda"]
        row_err = (gl - cl).abs().amax(-1)
        row_rel = row_err / cl.abs().amax(-1)
        ok = bool((row_rel <= BF16_LOGIT_RTOL).all())
        agree = [sum(a == b for a, b in zip(x, y)) / len(y)
                 for x, y in zip(gs, cs)]
        out[mode] = {"first_logits_max_rel_err": row_rel.max().item(),
                     "first_logits_max_abs_err": row_err.max().item(),
                     "rtol": BF16_LOGIT_RTOL, "ok": ok,
                     "first_tokens_equal": [x[0] == y[0]
                                            for x, y in zip(gs, cs)],
                     "stream_agreement": agree}
        print(f"kv {mode} bf16 model cuda vs cpu: first-step logits max "
              f"rel err {row_rel.max().item():.4g} (<= {BF16_LOGIT_RTOL}) "
              f"{ok}, stream agreement {agree}", flush=True)
        if not ok:
            bad.append(f"{mode} bf16")
    return out


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
    _check_paged_kernels("bf16", out["profile"]["decode_8x1000"])
    return eng, prompts, streams


SPEC_K = 4                 # the 7B speculative serve's draft window


def _timed_serve(eng, prompts):
    """Phase 4's timed serve of `prompts` on `eng` as it is configured:
    (streams, launches, decode tokens/s after the first step)."""
    import torch

    from paddle_tpu_torch.ops import cuda as port_cuda

    torch.cuda.synchronize()
    port_cuda.reset_launch_counts()          # the path starts here
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.step()                               # all prefills + step 1
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    at_first = sum(len(eng.scheduler.get(r).generated) for r in rids)
    eng.run_until_idle()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = port_cuda.launch_counts()     # ... and ends here
    streams = [list(eng.scheduler.get(r).generated) for r in rids]
    for r in rids:
        eng.release(r)
    total = sum(len(x) for x in streams)
    return streams, launches, (total - at_first) / (t_end - t_first)


def _first_step_logits(eng, prompts, spec_k, per_position=False):
    """The position-0 logits [rows, vocab] (fp32, on the CPU) of the first
    decode (spec_k 0) or verify step over `prompts`, read by a hook on the
    LM head (prefill never runs it); the requests are then cancelled.
    per_position: the step's ``nn.Linear`` calls on the [decode_batch, T >
    1, H] verify frame (not the prefills' [1, T, H] chunks) run one
    position at a time, each a GEMM of decode_batch rows as decode's are,
    so everything else of the frame (RoPE, the masked page writes, the
    paged kernel's T-query frame, the norms) is held to decode bit for
    bit."""
    import torch

    seen = []
    linear = torch.nn.Linear.forward

    def by_position(self, x):
        if x.dim() == 3 and x.shape[0] == eng.decode_batch \
                and x.shape[1] > 1:
            return torch.cat([linear(self, x[:, i:i + 1])
                              for i in range(x.shape[1])], dim=1)
        return linear(self, x)

    handle = eng.model.lm_head.register_forward_hook(
        lambda _m, _i, out: seen.append(out[:len(prompts), 0].float().cpu())
        if not seen else None)
    if per_position:
        torch.nn.Linear.forward = by_position
    eng.configure_speculation(spec_k=spec_k)
    try:
        rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        eng.step()
        for r in rids:
            eng.cancel(r)
            eng.release(r)
    finally:
        torch.nn.Linear.forward = linear
        handle.remove()
        eng.configure_speculation(spec_k=0)
    return seen[0]


def phase_full_width_spec(eng, prompts, streams, report):
    """Speculative decoding at the 7B geometry, on phase 4's engine and
    prompts: a timed serve at spec_k 0, then at SPEC_K (n-gram drafts,
    one [8, SPEC_K + 1] verify frame a step through the tensor-core paged
    kernel). Prints decode tokens/s of both, accepted tokens a verify
    step, the verify steps' paged launches and (profiler) the paged kernel
    a verify step runs, and the streams' agreement with phase 4's. The
    first verify step's position-0 logits are compared with the first
    plain decode step's twice: as the engine computes them (the max
    error over each row's max |logit| printed beside BF16_LOGIT_RTOL:
    cuBLAS sums a [8 x 5]-row projection in another order than an 8-row
    one, and 32 random-weight layers grow that rounding), and with the
    frame's projections run position by position, which must equal
    plain decode's bit for bit. Gates: that equality, finite logits,
    complete streams, the tensor-core kernel alone in a verify step, one
    paged launch a layer a step, the allocator consistent with every
    page free."""
    import numpy as np
    import torch

    vocab = eng.model.config.vocab_size
    layers = eng.num_layers
    eng.configure_speculation(spec_k=0)
    eng.reset_stats()
    plain, plain_launches, plain_tps = _timed_serve(eng, prompts)
    eng.configure_speculation(spec_k=SPEC_K)
    eng.reset_stats()
    try:
        spec, launches, spec_tps = _timed_serve(eng, prompts)
        st = eng.stats()
        profile = _profile_decode_step(eng, np.random.RandomState(7), vocab,
                                       new_tokens=4 * (SPEC_K + 1))
    finally:
        eng.configure_speculation(spec_k=0)
    base = _first_step_logits(eng, prompts, 0)
    frame = _first_step_logits(eng, prompts, SPEC_K)
    by_position = _first_step_logits(eng, prompts, SPEC_K, per_position=True)
    eng.allocator.check_consistency()
    rel = ((frame - base).abs().amax(-1) / base.abs().amax(-1)).max().item()
    out = {
        "spec_k": SPEC_K, "decode_tokens_per_s": spec_tps,
        "plain_decode_tokens_per_s": plain_tps,
        "speedup": spec_tps / plain_tps,
        "accepted_tokens_per_step": st["accepted_tokens_per_step"],
        "verify_steps": st["decode_steps"],
        "draft_ms_total": st["draft_ms_total"],
        "launches": launches, "plain_launches": plain_launches,
        "paged_kernels": profile["paged_kernels"],
        "paged_ms_per_verify_step": profile["paged_ms_per_step"],
        "first_logits_max_rel_err": rel, "rtol": BF16_LOGIT_RTOL,
        "first_logits_within_rtol": rel <= BF16_LOGIT_RTOL,
        "first_argmax_equal": (frame.argmax(-1) == base.argmax(-1)).tolist(),
        "by_position_bit_equal": torch.equal(by_position, base),
        "agreement_with_phase4": _agreement(spec, streams),
        "plain_agreement_with_phase4": _agreement(plain, streams),
        "all_free": eng.allocator.free_pages == eng.num_pages - 1,
        "first_tokens": [x[:4] for x in spec]}
    report["full_width_spec"] = out
    print("full width spec: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("first_tokens",
                                                   "plain_launches")}),
        flush=True)
    bad = []
    if not (torch.isfinite(frame).all() and out["by_position_bit_equal"]):
        bad.append("first verify logits not finite, or not equal to plain "
                   "decode's with the projections run by position")
    if not all(len(x) == NEW_TOKENS and all(0 <= t < vocab for t in x)
               for x in spec):
        bad.append("incomplete or out-of-vocab streams")
    if launches["paged_decode"] != layers * st["decode_steps"]:
        bad.append(f"paged launches {launches['paged_decode']} for "
                   f"{st['decode_steps']} verify steps of {layers} layers")
    if not out["all_free"]:
        bad.append("pages left held after the serve")
    _check_paged_kernels("spec", profile)
    if bad:
        raise AssertionError(f"the speculative 7B serve: {bad}")


def _check_paged_kernels(mode, profile):
    """The 7B serves' q is bf16: their decode must run the tensor-core
    paged kernel, and no other."""
    got = profile["paged_kernels"]
    print(f"full width {mode} decode: paged kernels {got}, "
          f"{profile['paged_ms_per_step']:.4f} ms a step", flush=True)
    if got != [PAGED_KERNEL["bfloat16"]]:
        raise AssertionError(f"{mode} serve's decode ran paged kernels "
                             f"{got}, not {PAGED_KERNEL['bfloat16']}")


def _profile_decode_step(eng, rng, vocab, new_tokens=4):
    """A profile of one decode (or verify) step of 8 requests of 200-token
    prompts: which paged kernel the engine's decode runs. `new_tokens`
    must outlast the first step (a verify step commits up to K + 1)."""
    rids = [eng.submit(rng.randint(1, vocab, 200).astype("int32"),
                       max_new_tokens=new_tokens) for _ in range(8)]
    eng.step()                                   # prefills + first decode
    prof = _device_profile(eng.step, 1)
    eng.run_until_idle()
    for r in rids:
        eng.release(r)
    return prof


SYSTEM_TOKENS = 1024       # the shared system prompt of the int8 run
TIER_PAGES = 384           # the tier run's device pool and host store
TIER_HOST_MB = 2048


def _drive_recording(eng):
    """Step `eng` until idle. Records, without a host sync, each step's
    decode lengths and each packed frame's segment ids (the tensor the
    engine hands the model) for the visit counters, which run after the
    timed window, as the JAX bench reads its counters on a snapshot."""
    import torch

    lens, frames = [], []
    llama = eng.model.llama
    forward = llama.decode_forward

    def record(*args, segment_ids=None, **kw):
        if segment_ids is not None:
            frames.append(segment_ids)
        return forward(*args, segment_ids=segment_ids, **kw)

    llama.decode_forward = record
    t_first = None
    try:
        while eng.busy:
            eng.step()
            if t_first is None:
                torch.cuda.synchronize()
                t_first = time.perf_counter()
            lens.append([r.total_len for r in eng.scheduler.running])
        torch.cuda.synchronize()
    finally:
        del llama.decode_forward
    return {"t_first": t_first, "t_end": time.perf_counter(), "lens": lens,
            "frames": frames}


def _visit_counters(eng, drives):
    """The page-visit counter over every recorded decode batch (one
    launch), checked against ceil(len / page_size), and the flash visit
    counter over each recorded packed frame, checked against its plain
    version: (page-visit fraction of the decode batches, frames, exact)."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    ps, pmax, b = eng.page_size, eng.pages_per_seq, eng.decode_batch
    rows = [n for d in drives for ln in d["lens"] if ln
            for n in ln + [0] * (b - len(ln))]
    got = pa.page_visit_counts(torch.tensor(rows, dtype=torch.int32,
                                            device="cuda"), ps, pmax)
    want = [min(-(-n // ps), pmax) for n in rows]
    exact = got.tolist() == want
    frames = [seg for d in drives for seg in d["frames"]]
    for seg in frames:
        exact &= bool((fa.segment_block_visit_counts(seg)
                       == fa.segment_block_visit_reference(seg)).all())
    return {"page_visit_fraction": sum(want) / (len(rows) * pmax),
            "decode_batches_counted": len(rows) // b,
            "packed_frames_counted": len(frames),
            "visit_counts_exact": exact}


def _serve_timed(eng, prompts):
    """Submit `prompts` at once and drive them to the end: streams, the
    recorded drive, and the first step's, decode's and TTFT's times."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    drive = _drive_recording(eng)
    reqs = [eng.scheduler.get(r) for r in rids]
    streams = [list(r.generated) for r in reqs]
    ttft = [(r.token_times[0] - r.arrival_t) * 1e3 for r in reqs]
    for r in rids:
        eng.release(r)
    gen_tokens = sum(len(x) for x in streams)
    lens = [int(p.size) for p in prompts]
    timing = {
        "requests": len(prompts), "prompt_tokens": sum(lens),
        "first_step_s": drive["t_first"] - t0,
        "first_step_prefill_tokens_per_s":
            sum(lens[:eng.decode_batch]) / (drive["t_first"] - t0),
        "wall_s": drive["t_end"] - t0,
        "decode_tokens_per_s": (gen_tokens - len(reqs))
        / (drive["t_end"] - drive["t_first"]),
        "ttft_ms_mean": statistics.mean(ttft), "ttft_ms_max": max(ttft)}
    return streams, drive, timing


def _agreement(streams, ref):
    """Per stream: the share of positions equal to `ref`'s, and the
    tokens before the first difference."""
    share = [sum(a == b for a, b in zip(x, y)) / len(y)
             for x, y in zip(streams, ref)]
    lead = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                 len(y)) for x, y in zip(streams, ref)]
    return {"mean": statistics.mean(share), "per_stream": share,
            "tokens_before_first_difference": lead}


def _kv_write_read_ms(eng, ctx=3072):
    """Device time of the model's page writes for one 7B decode step (every
    layer, the decode batch's K and V: quantize-on-write when the pools
    are quantized) and of one prefill chunk's context gather at `ctx`
    rows (every layer; dequant in bf16 when quantized), each through the
    model's own functions on the engine's pools, at random pages."""
    import torch

    from paddle_tpu_torch.models.llama import gather_context, write_kv_pages

    cache, ps = eng._cache, eng.page_size
    n_layers, hkv, _, _, d = cache["k"].shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b = eng.decode_batch
    k, v = (torch.randn((b, 1, hkv, d), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    pidx = torch.randint(1, eng.num_pages, (b, 1), generator=gen,
                         device="cuda")
    slot = torch.randint(0, ps, (b, 1), generator=gen, device="cuda")
    table = torch.randint(1, eng.num_pages, (1, ctx // ps), generator=gen,
                          device="cuda")

    def write():
        for layer in range(n_layers):
            write_kv_pages(cache, layer, pidx, slot, k, v)

    def gather():
        for layer in range(n_layers):
            gather_context(cache, layer, table, ctx, torch.bfloat16)

    return {"decode_write_device_ms": sum(_device_ms_by_kernel(write)
                                          .values()),
            "decode_write_ms": _cuda_ms(write, reps=5),
            "chunk_gather_ctx": ctx,
            "chunk_gather_device_ms": sum(_device_ms_by_kernel(gather)
                                          .values()),
            "chunk_gather_ms": _cuda_ms(gather, reps=5)}


KV_NOISE = 2.0 ** -8       # int8's rounding error, of the slot's absmax


def _perturbed_bf16_serve(model, base, prompts, bf16_streams, seed):
    """What a rounding-sized change of K/V does to greedy streams at these
    random weights: a fresh bf16 engine (prefix sharing off, so the second
    serve re-prefills) serves phase 4's prompts once as they are (the
    control, against phase 4's streams) and once with every layer's K and
    V moved by uniform noise of up to KV_NOISE of each slot's absmax over
    head_dim (forward hooks on k_proj and v_proj), the size of int8's
    rounding error (against the control). Both agreements are reported,
    not held: the weights are random."""
    import torch

    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, _engine_cfg(hbm_budget_mb=16384,
                                           prefix_sharing=False, **base),
                        device="cuda")
    d = model.config.hidden_size // model.config.num_attention_heads
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def perturb(_mod, _inp, out):
        x = out.float().unflatten(-1, (-1, d))
        amax = x.abs().amax(-1, keepdim=True)
        u = torch.rand(x.shape, generator=gen, device=x.device) * 2 - 1
        return (x + u * amax * KV_NOISE).flatten(-2).to(out.dtype)

    control = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    hooks = [proj.register_forward_hook(perturb)
             for layer in model.llama.layers
             for proj in (layer.self_attn.k_proj, layer.self_attn.v_proj)]
    try:
        noisy = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    finally:
        for h in hooks:
            h.remove()
    out = {"kv_noise": KV_NOISE,
           "control_agreement_with_phase4": _agreement(control,
                                                       bf16_streams),
           "perturbed_agreement_with_control": _agreement(noisy, control),
           "pools": _kv_write_read_ms(eng)}
    del eng
    return out


def phase_full_width_kv(args, model, bf16_prompts, bf16_streams, bf16_pages,
                        report):
    """The KV hierarchy at the 7B geometry on phase 4's model. First a
    fresh bf16 engine repeats phase 4's serve, and serves it again with
    K/V perturbed by int8's rounding size (the agreement baseline). Then
    an int8 and an fp8 engine at the same 16 GiB budget each serve phase
    4's 8 prompts with nothing else in the timed window; the int8 engine
    then serves, apart, 8 requests sharing a 1024-token system prompt
    (tails of 32-256 tokens). The visit counters run over the recorded
    decode lengths and packed frames after those serves, the launch
    counts are read around serves and counters, and the page writes'
    and context gathers' device ms are measured apart. Last, a tier run
    at 384 pages and a 2 GiB host store demotes a 1000-token prompt's
    pages and promotes them byte-exact."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import ServingEngine

    vocab = model.config.vocab_size
    base = dict(page_size=16, decode_batch=8, prefill_chunk=256,
                max_seq_len=4096)
    out = {"bf16": _perturbed_bf16_serve(model, base, bf16_prompts,
                                         bf16_streams, args.seed)}
    gc.collect()
    torch.cuda.empty_cache()
    print("full width bf16 agreement baseline: " + json.dumps(out["bf16"]),
          flush=True)
    rng = np.random.RandomState(args.seed + 7)
    system = rng.randint(1, vocab, SYSTEM_TOKENS).astype(np.int32)
    tails = [32, 64, 96, 128, 160, 192, 224, 256]
    shared = [np.concatenate([system, rng.randint(1, vocab, n)
                              .astype(np.int32)]) for n in tails]
    launches = {}
    problems = []
    for mode in ("int8", "fp8"):
        eng = ServingEngine(model, _engine_cfg(kv_cache_dtype=mode,
                                               hbm_budget_mb=16384, **base),
                            device="cuda")
        eng.generate([rng.randint(1, vocab, 40).astype(np.int32)],
                     max_new_tokens=2)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        port_cuda.reset_launch_counts()      # the main path starts here
        streams, drive, timing = _serve_timed(eng, bf16_prompts)
        drives = [drive]
        res = {"kv_pages": eng.num_pages, "bf16_kv_pages": bf16_pages,
               "page_ratio": eng.num_pages / bf16_pages,
               "kv_cache_gb": eng.kv_cache_bytes / 1e9,
               "kv_scale_gb": eng.kv_scale_bytes / 1e9, **timing,
               "greedy_agreement_with_bf16": _agreement(streams,
                                                        bf16_streams)}
        complete = [len(x) == NEW_TOKENS for x in streams]
        in_vocab = [0 <= t < vocab for x in streams for t in x]
        if mode == "int8":
            matched0 = eng.allocator.prefix_tokens_matched
            wave, wdrive, wtiming = _serve_timed(eng, shared)
            drives.append(wdrive)
            res["shared_wave"] = dict(
                wtiming, prefix_hit_rate=(
                    eng.allocator.prefix_tokens_matched - matched0)
                / wtiming["prompt_tokens"])
            complete += [len(x) == NEW_TOKENS for x in wave]
            in_vocab += [0 <= t < vocab for x in wave for t in x]
        res.update(_visit_counters(eng, drives))
        launches[mode] = port_cuda.launch_counts()     # ... and ends here
        st = eng.stats()
        res.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   prefix_hit_rate=st["prefix_hit_rate"],
                   prefix_matches=st["prefix_matches"],
                   cow_copies=st["cow_copies"], launches=launches[mode])
        if mode == "int8":
            # where a decode step's time goes, outside the main-path run
            res["profile"] = _profile_serving(eng, rng, vocab)
            decode_prof = res["profile"]["decode_8x1000"]
        else:
            decode_prof = res["decode_step_profile"] = _profile_decode_step(
                eng, rng, vocab)
        try:
            _check_paged_kernels(mode, decode_prof)
        except AssertionError as e:
            problems.append(str(e))
        res["pools"] = _kv_write_read_ms(eng)
        out[mode] = res
        print(f"full width {mode}: " + json.dumps(res), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        if not (all(complete) and all(in_vocab)):
            problems.append(f"{mode}: incomplete or out-of-vocab streams")
    report["full_width_kv"] = out
    out["tier"] = _full_width_tier(model, base, rng, vocab)
    print("full width tier: " + json.dumps(out["tier"]), flush=True)
    i8 = out["int8"]
    if i8["page_ratio"] < 1.9:
        problems.append(f"int8 holds {i8['page_ratio']:.3f}x the bf16 pages")
    if launches["int8"]["paged_decode_int8"] <= 0:
        problems.append("paged_decode_int8 never launched")
    if launches["fp8"]["paged_decode_fp8"] <= 0:
        problems.append("paged_decode_fp8 never launched")
    for mode in ("int8", "fp8"):
        lc = launches[mode]
        if lc["paged_visit"] <= 0 or lc["flash_visit"] <= 0 \
                or not out[mode]["visit_counts_exact"]:
            problems.append(f"{mode}: visit counters not run or not exact")
    if i8["prefix_matches"] < len(tails) - 1:
        problems.append(f"only {i8['prefix_matches']} prefix matches")
    if not out["tier"]["byte_exact"]:
        problems.append("promoted pages differ from the demoted ones")
    if out["tier"]["cold_hits"] < out["tier"]["prompt_full_pages"]:
        problems.append("the prompt's second serve did not adopt its cold "
                        "pages")
    if out["tier"]["again"] != out["tier"]["cold_hit"]:
        problems.append("the promoted serve's stream differs from the "
                        "cold-hit serve's")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _full_width_tier(model, base, rng, vocab):
    """int8 at 384 pages (383 usable) with a 2 GiB host store: a 1000-token
    prompt (62 full pages) finishes and goes cold; served again at once, it
    adopts its cold pages where they are; two 4000-token fillers (251 pages
    each) run one after the other, and the second's admission reclaims the
    oldest cold pages, the prompt's first, into the host; the prompt again
    matches them and they are promoted. The promoted pages' codes and
    scales must equal the demoted pages' bytes, and the promoted serve's
    stream the cold-hit serve's: both prefill the same 8-token tail over
    the same page bytes. The first serve prefilled all 1000 tokens, in
    chunks of other shapes, so with random weights its stream may differ;
    it is reported, not held."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, _engine_cfg(kv_cache_dtype="int8",
                                           num_pages=TIER_PAGES,
                                           host_cache_mb=TIER_HOST_MB,
                                           **base), device="cuda")
    prompt = rng.randint(1, vocab, 1000).astype(np.int32)
    full = prompt.size // eng.page_size
    rid = eng.submit(prompt, max_new_tokens=4)
    eng.step()
    pages = eng.allocator.chain(rid)[:full]
    eng.run_until_idle()
    first = list(eng.scheduler.get(rid).generated)
    eng.release(rid)
    idx = torch.tensor(pages, device="cuda")
    snap = {n: a.index_select(2, idx).view(torch.uint8)
            if a.element_size() == 1 else a.index_select(2, idx)
            for n, a in eng._cache.items()}
    cold_hit = eng.generate([prompt], max_new_tokens=4)[0]
    cold_hits = eng.allocator.cold_hits
    fillers = [rng.randint(1, vocab, 4000).astype(np.int32)
               for _ in range(2)]
    t0 = time.perf_counter()
    eng.generate(fillers, max_new_tokens=4)
    fill_s = time.perf_counter() - t0
    st0 = eng.stats()
    rid = eng.submit(prompt, max_new_tokens=4)
    eng.step()
    st1 = eng.stats()
    new = eng.allocator.chain(rid)[:full]
    nidx = torch.tensor(new, device="cuda")
    exact = all(torch.equal(
        (a.index_select(2, nidx).view(torch.uint8) if a.element_size() == 1
         else a.index_select(2, nidx)), snap[n])
        for n, a in eng._cache.items())
    eng.run_until_idle()
    again = list(eng.scheduler.get(rid).generated)
    eng.release(rid)
    eng.allocator.check_consistency()
    demoted = st0["kv_demotions"]
    promoted = st1["kv_promotions"]
    out = {
        "num_pages": eng.num_pages, "host_pages": eng.host_pages,
        "prompt_full_pages": full, "fillers_s": fill_s,
        "demotions": demoted, "promotions": promoted,
        "dropped_cold": st1["kv_dropped_cold"],
        "demote_ms_per_page": st0["kv_demote_ms_total"] / max(demoted, 1),
        "promote_ms_per_page": st1["kv_promote_ms_total"] / max(promoted, 1),
        "page_mb": (eng.kv_cache_bytes + eng.kv_scale_bytes)
        / eng.num_pages / 2 ** 20,
        "byte_exact": exact and promoted >= full, "cold_hits": cold_hits,
        "first": first, "cold_hit": cold_hit, "again": again,
    }
    return out


def _port_kernel_ms(dev):
    """{kernel name: device ms} of the port's own kernels, the __global__
    functions of csrc/*.cu, among (profiler key, ms) pairs."""
    from paddle_tpu_torch.ops.cuda import _build

    names = set()
    for src in _build.kernel_names():
        with open(os.path.join(_build.CSRC_DIR, f"{src}.cu")) as fh:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)\s*\(", fh.read()))
    out = {}
    for key, ms in dev:
        hit = re.search(r"\(anonymous namespace\)::(\w+)", key)
        if hit and hit.group(1) in names:
            out[hit.group(1)] = out.get(hit.group(1), 0.0) + ms
    return out


def _device_profile(fn, steps, top=8):
    """torch.profiler over `fn` (one step): wall ms per step, device ms
    per step (kernels, copies), the device's busy share, the top device
    entries and the top host ops by their own CPU time."""
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
    # host side: each op's own CPU time (launch work), under the profiler
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda kv: -kv[1])
    port = _port_kernel_ms(dev)
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms if dev else None,
            "device_busy_share": device_ms / wall_ms if dev else None,
            "flash_fwd_ms_per_step": sum(ms for k, ms in dev
                                         if "flash_fwd_kernel" in k),
            # the paged decode kernel with its split-K merge
            "paged_ms_per_step": sum(ms for k, ms in port.items()
                                     if k.startswith(("paged_decode_kernel",
                                                      "paged_combine"))),
            "paged_kernels": sorted(k for k in port
                                    if k.startswith("paged_decode_kernel")),
            "port_kernel_ms_per_step": port,
            "top_device_ms": [(k[:90], ms) for k, ms in dev[:top]],
            "top_host_ms": [(k[:60], ms) for k, ms in host[:top]]}


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
    CUDA tiles (128 rows; split TF32 in 3 passes, as x and w are fp32)
    span several experts."""
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
    from paddle_tpu_torch.ops.cuda import fused_ce
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
    fp32_ce_bwd = fused_ce.ROUTE_CALLS["ce_bwd_fp32"]
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
        "fp32_ce_bwd_calls": fp32_ce_bwd,
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
            "flash_bwd_dkv": layers, "ce_stats": 1, "ce_bwd": 1}
    short = {k: n for k, n in out["launches_per_step"].items()
             if k in need and n < need[k]}
    if short:
        raise AssertionError(f"kernels not launched on the training path: "
                             f"{short}")
    if out["fp32_ce_bwd_calls"]:
        raise AssertionError(f"the fused CE backward took the fp32 matmul "
                             f"route {out['fp32_ce_bwd_calls']} times")


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
    out["gmm_ms_per_step"] = {
        k: v for k, v in out["profile"]["port_kernel_ms_per_step"].items()
        if k.startswith("gmm_")}
    report["train_moe_full_width"] = out
    print("train moe grouped-matmul device ms a step (gmm_fwd_wgmma_kernel: "
          "bf16 h1 and y; gmm_fwd_tf32_kernel: the fp32 dx; gmm_dw_*: dw "
          "with its walk and x^T passes): "
          + json.dumps(out["gmm_ms_per_step"]), flush=True)
    print("train moe full width: " + json.dumps(
        {k: v for k, v in out.items()
         if k not in ("profile", "expert_grad_abs_sum", "moe_stats",
                      "gmm_ms_per_step")}),
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
    need = {"gmm_fwd": 2 * layers, "gmm_fwd_tf32": 2 * layers,
            "gmm_dw": 2 * layers,
            "flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    got = {k: out["launches_per_step"][k] for k in need}
    if got != need:
        raise AssertionError(f"launches per step {got}, want {need}")


def rmsnorm_cases():
    """(label, rows, d, x dtype, w dtype): LLaMA-2-7B's hidden size at
    phase 7's 4096 tokens and at the decode batch, GPT-MoE's 4 x 2048
    tokens at hidden 1024, a ragged last block (4097 rows) at a width off
    the powers of two, a width that takes the scalar path, and the ring's
    edges: LLaMA-2-70B's 8192 in bf16 (512-thread blocks in the backward),
    fp32 at 16384 (the forward on the ring at 512 threads, the backward
    past it) and fp32 at 32768 (both kernels past the ring, on the
    two-pass vector route)."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for rows, d in ((4096, 4096), (8, 4096), (8192, 1024), (4097, 1000)):
        for dt, name in ((bf, "bf16"), (f32, "fp32")):
            cases.append((f"r{rows}_d{d}_{name}", rows, d, dt, dt))
    return cases + [("r4096_d4096_bf16x_fp32w", 4096, 4096, bf, f32),
                    ("r4097_d1001_bf16", 4097, 1001, bf, bf),
                    ("r2048_d8192_bf16", 2048, 8192, bf, bf),
                    ("r1024_d16384_fp32", 1024, 16384, f32, f32),
                    ("r512_d32768_fp32", 512, 32768, f32, f32)]


def _dw_check(dw, ref, scale):
    """dw against its plain version: per column within DW_RTOL of `scale`
    (the column's sum of |terms|), plus one ulp for a bf16 dw."""
    import torch

    err = (dw.float() - ref.float()).abs()
    rounding = (BF16_ULP * ref.float().abs() if dw.dtype == torch.bfloat16
                else torch.zeros_like(scale))
    return dict(max_abs_err=err.max().item(),
                max_rel_err=(err / scale.clamp_min(ATOL)).max().item(),
                rtol=DW_RTOL,
                ok=bool((err <= DW_RTOL * scale + rounding + ATOL).all()))


def _rmsnorm_check(x, w, dy, br):
    """y and dx by the per-row rule, dw by `_dw_check`, at row block br."""
    import torch

    from paddle_tpu_torch.ops.cuda import rmsnorm_kernel as rk

    dname = str(x.dtype).replace("torch.", "")
    y = rk.rmsnorm_fwd(x, w, RMS_EPS, br)
    dx, dw = rk.rmsnorm_bwd(x, w, dy, RMS_EPS, br)
    torch.cuda.synchronize()
    ref_dx, ref_dw = rk.rmsnorm_bwd_reference(x, w, dy, RMS_EPS, br)
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + RMS_EPS)
    return (_compare(y, rk.rmsnorm_reference(x, w, RMS_EPS).float(), dname),
            _compare(dx, ref_dx.float(), dname),
            _dw_check(dw, ref_dw, (dy.float() * xf * rstd).abs().sum(0)))


def _kernels_seen(fn, name=""):
    """{kernel name: device ms a call} of `fn` from the profiler; a window
    in which it recorded no kernel (whose name holds `name`) is taken
    again (it can drop a whole window's events), at most 3 times."""
    for _ in range(3):
        by = _device_ms_by_kernel(fn)
        if any(name in k for k in by):
            return by
    raise AssertionError(f"the profiler recorded no kernel named "
                         f"'{name}' in 3 windows")


def run_rmsnorm_case(gen, rows, d, dtype, w_dtype, all_blocks=False):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import rmsnorm_kernel as rk

    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
         ).to(w_dtype)
    dy = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    br = rk.pick_block_rows(rows, d, 0, str(dtype)[6:], x.device)
    fwd_c, dx_c, dw_c = _rmsnorm_check(x, w, dy, br)
    blocks = {}
    if all_blocks:        # every row block the autotuner may pick
        for b in sorted({min(rows, b) for b in rk.ROW_BLOCKS}):
            c = _rmsnorm_check(x, w, dy, b)
            blocks[b] = {"ok": c[0]["rows_ok"] and c[1]["rows_ok"]
                         and c[2]["ok"]}
            blocks[b].update({n: k["max_abs_err"]
                              for n, k in zip(("y", "dx", "dw"), c)})
    es, ws = x.element_size(), w.element_size()
    nb = -(-rows // br)
    partials = torch.randn((nb, d), generator=gen, device="cuda")
    dw_k = rk.rmsnorm_dw(partials, w.dtype)
    torch.cuda.synchronize()
    dwk_c = _dw_check(dw_k, rk.rmsnorm_dw_reference(partials, w.dtype),
                      partials.abs().sum(0))

    def lib_fwd():
        return tF.rms_norm(x, (d,), w, RMS_EPS)

    def lib_fwd_bwd():
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            wr = w.detach().requires_grad_()
            return torch.autograd.grad(tF.rms_norm(xr, (d,), wr, RMS_EPS),
                                       (xr, wr), dy)

    try:
        lib_f = _cuda_ms(lib_fwd)
        lib_fb = _cuda_ms(lib_fwd_bwd)
        # the library's kernels on the device, as the kernels' are timed
        lib_f_dev = sum(_kernels_seen(lib_fwd).values())
        lib_b_dev = sum(_kernels_seen(lib_fwd_bwd).values()) - lib_f_dev
        lib_err = None
    except Exception as e:    # torch's op may refuse a mixed-dtype weight
        lib_f = lib_fb = lib_f_dev = lib_b_dev = None
        lib_err = f"{type(e).__name__}: {e}"[:200]
    ms_f = _cuda_ms(lambda: rk.rmsnorm_fwd(x, w, RMS_EPS, br))
    ms_b = _cuda_ms(lambda: rk.rmsnorm_bwd(x, w, dy, RMS_EPS, br))
    ms_dw = _cuda_ms(lambda: rk.rmsnorm_dw(partials, w.dtype))
    plain_f = _cuda_ms(lambda: rk.rmsnorm_reference(x, w, RMS_EPS), reps=5)
    plain_b = _cuda_ms(
        lambda: rk.rmsnorm_bwd_reference(x, w, dy, RMS_EPS, br), reps=5)
    plain_dw = _cuda_ms(lambda: rk.rmsnorm_dw_reference(partials, w.dtype))
    lib_dw = _cuda_ms(lambda: torch.sum(partials, 0))
    lib_dw_dev = sum(_kernels_seen(lambda: torch.sum(partials, 0)).values())
    # device time apart from the wrappers' host work, which the event-timed
    # call_ms include (a small problem waits on the host): the kernels' own
    # time from the profiler
    by_f = _kernels_seen(lambda: rk.rmsnorm_fwd(x, w, RMS_EPS, br),
                         "rmsnorm_fwd")
    by_b = _kernels_seen(lambda: rk.rmsnorm_bwd(x, w, dy, RMS_EPS, br),
                         "rmsnorm_bwd")
    dev_f = sum(ms for k, ms in by_f.items() if "rmsnorm_fwd" in k)
    dev_b = sum(ms for k, ms in by_b.items()
                if "rmsnorm_bwd" in k or "rmsnorm_dw" in k)
    by_dw = _kernels_seen(lambda: rk.rmsnorm_dw(partials, w.dtype),
                          "rmsnorm_dw")
    dev_dw = sum(ms for k, ms in by_dw.items() if "rmsnorm_dw" in k)
    # the route each kernel took, by the names the profiler recorded, and
    # the route its plan gives (a tree older than the plan has none)
    plan = getattr(rk, "rmsnorm_plan", None)
    routes = {}
    for kind, by in (("fwd", by_f), ("bwd", by_b)):
        names = sorted(k for k in by if f"rmsnorm_{kind}" in k)
        took = "ring" if all("_ring_" in k for k in names) else "two_pass"
        want = plan(kind, d, dtype, br).route if plan else None
        routes[kind] = dict(took=took, plan=want, kernels=names,
                            ok=want is None or (took == "ring")
                            == want.startswith("ring"))
    # bytes: each input read once, each output written once; operations in
    # fp32 whatever the storage type (about 4 a value forward, 10 backward)
    n = rows * d
    fb = _bound(2 * n * es + d * ws, 4 * n, "float32")
    bb = _bound(3 * n * es + 2 * d * ws, 10 * n, "float32")
    db = _bound(nb * d * 4 + d * ws, nb * d, "float32")

    def share(bound, dev):
        return bound / dev if dev else None

    # ms and library_ms: device ms (profiler); call_ms and library_call_ms
    # event-timed, with the host's work
    out = {
        "block_rows": br, "n_blocks": nb, "blocks": blocks,
        "routes": routes, "library_error": lib_err,
        "fwd": dict(fwd_c, ok=fwd_c["rows_ok"], ms=dev_f, call_ms=ms_f,
                    plain_ms=plain_f, library_ms=lib_f_dev,
                    library_call_ms=lib_f, bound_ms=fb[0], bound_by=fb[1],
                    bound_share=share(fb[0], dev_f)),
        "bwd": dict(dx_c, dw=dw_c, max_abs_err=max(dx_c["max_abs_err"],
                                                   dw_c["max_abs_err"]),
                    ok=dx_c["rows_ok"] and dw_c["ok"], ms=dev_b, call_ms=ms_b,
                    plain_ms=plain_b, library_ms=lib_b_dev,
                    library_call_ms=(None if lib_f is None
                                     else lib_fb - lib_f),
                    bound_ms=bb[0], bound_by=bb[1],
                    bound_share=share(bb[0], dev_b)),
        "dw": dict(dwk_c, ms=dev_dw, call_ms=ms_dw, plain_ms=plain_dw,
                   library_ms=lib_dw_dev,
                   library_call_ms=lib_dw, bound_ms=db[0], bound_by=db[1],
                   bound_share=share(db[0], dev_dw))}
    out["ok"] = (out["fwd"]["ok"] and out["bwd"]["ok"] and dwk_c["ok"]
                 and all(b["ok"] for b in blocks.values())
                 and all(r["ok"] for r in routes.values()))
    return out


def _fmt(v):
    return "none" if v is None else f"{v:.4f}"


def phase_rmsnorm(seed, report):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cases = {}
    for label, rows, d, dt, wdt in rmsnorm_cases():
        cases[label] = r = run_rmsnorm_case(gen, rows, d, dt, wdt,
                                            all_blocks=rows == 4097)
        parts = []
        for k in ("fwd", "bwd", "dw"):
            c = r[k]
            parts.append(f"{k} err {c['max_abs_err']:.3g} "
                         f"device_ms {c['ms']:.4f} "
                         f"({_fmt(c['bound_share'])} of bound) "
                         f"call_ms {c['call_ms']:.4f} "
                         f"plain_ms {c['plain_ms']:.4f} "
                         f"library_device_ms {_fmt(c['library_ms'])} "
                         f"library_call_ms {_fmt(c['library_call_ms'])} "
                         f"bound_ms {c['bound_ms']:.4f} ({c['bound_by']})")
        blocks = " ".join(f"{b}:{'ok' if v['ok'] else 'BAD'}"
                          for b, v in r["blocks"].items())
        routes = " ".join(f"{k} {v['took']}" for k, v in r["routes"].items())
        print(f"rmsnorm {label}: ok {r['ok']} block_rows {r['block_rows']} "
              f"route {routes} [{'; '.join(parts)}]"
              + (f" blocks {blocks}" if blocks else ""), flush=True)
        torch.cuda.empty_cache()
    report["rmsnorm_cases"] = cases
    bad = [k for k, r in cases.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"rmsnorm kernels disagree with their plain "
                             f"versions: {bad}")


def tune_geometries():
    """The main path's geometries of the resolver entries with a lattice
    (the tuning phase's report): LLaMA-2-7B training at seq 4096 (fused
    CE, its hidden size for RMSNorm), the 7B serving geometry, and the
    key GPT-MoE's dropless dispatcher resolves: its routed token copies
    (batch x seq x top-k) over its experts."""
    from paddle_tpu_torch.models import GptMoeConfig

    moe = GptMoeConfig()
    return {
        "fused_ce": {"n_tokens": 4096, "vocab": 32000},
        "rmsnorm": {"rows": 4096, "d": 4096},
        "grouped_matmul": {
            "n_rows": MOE_BATCH * moe.max_position_embeddings * moe.top_k,
            "num_groups": moe.num_experts},
        "paged_attention": {"num_kv_heads": 32, "head_dim": 128,
                            "max_seq_len": 4096},
    }


def _digest(*tensors):
    """sha256 over the tensors' bytes: equal digests, bit-equal tensors."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def tuning_worker(mode, seed, out_path):
    """One process of the tuning phase (FLAGS_autotune and
    FLAGS_tuning_cache_dir come from the environment): the report, twice
    (cold), or the four resolutions (warm), then RMSNorm at [4096, 4096]
    bf16, one GPT-MoE layer's dispatch, two tiny LLaMA TrainStep steps and
    a tiny page_size=0 engine, all on CUDA. Writes what it saw to
    `out_path` as JSON."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from paddle_tpu_torch.core.flags import flag
    from paddle_tpu_torch.models import (GptMoeConfig, GptMoeForCausalLM,
                                         LlamaForCausalLM, llama_tiny_config)
    from paddle_tpu_torch.observability import events
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.ops.cuda import fused_ce as fc
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
    from paddle_tpu_torch.ops.cuda import rmsnorm_kernel as rk
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.tuning import blocks
    from paddle_tpu_torch.tuning.autotune import autotune_report

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"mode": mode, "autotune": flag("autotune"),
           "platform": blocks.platform_of("cuda")}
    t0 = time.perf_counter()
    g = tune_geometries()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if mode == "cold":
            won = autotune_report(g, cache_dir=flag("tuning_cache_dir"),
                                  device="cuda")
            out["report"] = won
            # the same search again, into a scratch cache: do the winners
            # repeat?
            with tempfile.TemporaryDirectory(prefix="tune_again_") as again:
                out["report_again"] = autotune_report(g, cache_dir=again,
                                                      device="cuda")
        else:
            cuda = torch.device("cuda")
            fc.pick_chunk_tokens(g["fused_ce"]["n_tokens"],
                                 g["fused_ce"]["vocab"], device=cuda)
            rk.pick_block_rows(g["rmsnorm"]["rows"], g["rmsnorm"]["d"],
                               device=cuda)
            gm.pick_block_rows(g["grouped_matmul"]["n_rows"],
                               g["grouped_matmul"]["num_groups"], cuda)
            blocks.resolve_blocks("paged_attention", g["paged_attention"],
                                  default=(flag("serving_page_size"),),
                                  device=cuda)
            out["resolved"] = {k: {"provenance": r.provenance,
                                   "values": r.values}
                               for k, r in blocks._last.items()}
        out["search_s"] = time.perf_counter() - t0
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        x = torch.randn((4096, 4096), generator=gen, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn((4096,), generator=gen, device="cuda")
             ).bfloat16()
        dy = torch.randn((4096, 4096), generator=gen,
                         device="cuda").bfloat16()
        xr, wr = x.requires_grad_(), w.requires_grad_()
        # the dispatch call's own launches, apart from those of a search
        # it starts (each search's journal record counts its launches)
        torch.cuda.synchronize()
        port_cuda.reset_launch_counts()
        n_searches = len(events.journal().recent(event="autotune"))
        y = rk.rmsnorm(xr, wr)
        dx, dw = torch.autograd.grad(y, (xr, wr), dy)
        torch.cuda.synchronize()
        got = port_cuda.launch_counts()
        searched = {}
        for r in events.journal().recent(event="autotune")[n_searches:]:
            for k, n in r["launches"].items():
                searched[k] = searched.get(k, 0) + n
        out["rmsnorm"] = {"block_rows": y.grad_fn.block_rows,
                          "provenance": blocks.last_resolution(
                              "rmsnorm").provenance,
                          "digest": _digest(y, dx, dw),
                          "dispatch_launches": {
                              n: got[n] - searched.get(n, 0)
                              for n in RMS_KERNELS},
                          "search_launches": {
                              n: searched.get(n, 0) for n in RMS_KERNELS}}
        del x, w, dy, xr, wr, y, dx, dw
        # GPT-MoE's dropless dispatcher at its own shape: one layer of the
        # full width over MOE_BATCH x 2048 tokens, eval routing; the bucket
        # alignment resolves at (batch x seq x top-k, experts)
        mcfg = GptMoeConfig(moe_dispatch="dropless", num_hidden_layers=1)
        moe_model = GptMoeForCausalLM(mcfg, device="cuda",
                                      dtype=torch.bfloat16, seed=seed).eval()
        ids = torch.from_numpy(np.random.RandomState(seed).randint(
            1, mcfg.vocab_size, (MOE_BATCH, mcfg.max_position_embeddings)))
        with torch.no_grad():
            logits = moe_model(ids.cuda())
        res = blocks.last_resolution("grouped_matmul")
        out["moe"] = {"block_rows": moe_model.moe_layers()[0].last_layout[1],
                      "provenance": res.provenance, "key": res.source,
                      "digest": _digest(logits[:, -1])}
        del moe_model, logits
        torch.cuda.empty_cache()
        cfg = llama_tiny_config(vocab_size=1024, hidden_size=512,
                                intermediate_size=1024, num_hidden_layers=2,
                                num_attention_heads=4, num_key_value_heads=2,
                                max_position_embeddings=512)
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.parallel import TrainStep

        base = LlamaForCausalLM(cfg, device="cpu", seed=seed).state_dict()
        model = LlamaForCausalLM(cfg, device="cuda")
        model.load_state_dict(base)
        step = TrainStep(model, _fused_loss,
                         AdamW(learning_rate=1e-3,
                               parameters=model.parameters(),
                               weight_decay=0.01))
        batch = _packed_batch(seed, cfg.vocab_size, 256, 2)
        out["losses"] = [float(step(batch)) for _ in range(2)]
        model = LlamaForCausalLM(cfg, device="cuda")
        model.load_state_dict(base)
        eng = ServingEngine(model, _engine_cfg(
            page_size=0, num_pages=128, decode_batch=4, prefill_chunk=64,
            pack_frame=128, max_seq_len=256), device="cuda")
        prompt = np.random.RandomState(seed).randint(
            1, cfg.vocab_size, 40).astype(np.int32)
        out["stream"] = [int(t) for t in
                         eng.generate([prompt], max_new_tokens=12)[0]]
        out["page_size"] = eng.page_size
    out["s"] = time.perf_counter() - t0
    out["counters"] = blocks.tuning_counters()
    out["last"] = {k: {"provenance": r.provenance, "values": r.values,
                       "source": r.source}
                   for k, r in blocks._last.items()}
    out["warnings"] = [str(m.message)[:300] for m in caught]
    out["skips"] = events.journal().recent(event="autotune_skip")
    out["searches"] = [{k: r[k] for k in ("kernel", "key", "values", "ms",
                                          "candidates", "timings",
                                          "launches")}
                       for r in events.journal().recent(event="autotune")]
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1, default=str)
    return 0


def phase_tuning(seed, report):
    """The tuning phase's parent: a cold (search) process, then a warm
    (load) one over the same temporary cache directory; the gates of
    ``tuning_worker``'s runs."""
    import tempfile

    from paddle_tpu_torch.tuning import TuningCache, cache_key

    runs = {}
    with tempfile.TemporaryDirectory(prefix="tune_") as tmp:
        env = dict(os.environ, FLAGS_tuning_cache_dir=tmp)
        for mode, setting in (("cold", "search"), ("warm", "load")):
            path = os.path.join(tmp, f"{mode}.json")
            env["FLAGS_autotune"] = setting
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--tuning-worker", mode, "--seed", str(seed),
                 "--out", path], env=env, cwd=REPO, capture_output=True,
                text=True, timeout=TUNE_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(
                    f"tuning {mode} process exited {proc.returncode}:\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            with open(path) as fh:
                runs[mode] = json.load(fh)
            runs[mode]["process_s"] = time.perf_counter() - t0
        cache = TuningCache.load(tmp).entries
    cold, warm = runs["cold"], runs["warm"]
    for key, won in cold["report"].items():
        again = cold["report_again"].get(key, {})
        print(f"tuned {key}: {won['values']} {won['ms']:.4f} ms over "
              f"{won['candidates']} candidates (again: "
              f"{again.get('values')}); device ms "
              + ", ".join(f"{list(t['values'].values())}: {t['ms']:.4f}"
                          for t in won["timings"]), flush=True)
    for s in cold["searches"]:
        if s["key"] not in cold["report"]:
            print(f"tuned at dispatch {s['key']}: {s['values']} "
                  f"{s['ms']:.4f} ms over {s['candidates']} candidates",
                  flush=True)
    c = warm["counters"]
    moe_key = cache_key("grouped_matmul",
                        tune_geometries()["grouped_matmul"], "",
                        warm["platform"])
    checks = {
        "report_covers_every_lattice": set(
            k.split("|")[0] for k in cold["report"]) == set(
            tune_geometries()),
        "every_search_persisted": all(s["key"] in cache
                                      for s in cold["searches"]),
        "no_search_fail": not any("autotune search failed" in w
                                  for w in cold["warnings"] +
                                  warm["warnings"]),
        "no_own_lattice_skip": not cold["skips"] and not warm["skips"],
        "cold_searched_at_dispatch": cold["rmsnorm"]["provenance"] == "tuned"
        and any("|bfloat16|" in s["key"] and s["kernel"] == "rmsnorm"
                for s in cold["searches"]),
        "warm_all_tuned": (c["resolutions_tuned"] > 0 and all(
            c[f"resolutions_{p}"] == 0 for p in ("flag", "default", "trial"))
            and all(r["provenance"] == "tuned"
                    for r in warm["resolved"].values())
            and set(warm["resolved"]) == set(tune_geometries())),
        "moe_dispatch_reads_the_tuned_key": all(
            r["moe"]["provenance"] == "tuned" and r["moe"]["key"] == moe_key
            and r["moe"]["block_rows"]
            == cold["report"][moe_key]["values"]["block_rows"]
            for r in (cold, warm)),
        "moe_bit_equal": cold["moe"]["digest"] == warm["moe"]["digest"],
        "warm_zero_trials": c["autotune_trials"] == 0,
        "losses_bit_equal": cold["losses"] == warm["losses"],
        "stream_equal": cold["stream"] == warm["stream"],
        "rmsnorm_bit_equal": cold["rmsnorm"]["digest"]
        == warm["rmsnorm"]["digest"],
        "rmsnorm_dispatched_once": all(
            r["rmsnorm"]["dispatch_launches"][n] == 1
            for r in (cold, warm) for n in RMS_KERNELS),
    }
    repeat = {k.split("|")[0]: v["values"]
              == cold["report_again"].get(k, {}).get("values")
              for k, v in cold["report"].items()}
    report["tuning"] = {
        "checks": checks, "cold": cold, "warm": warm, "cache": cache,
        "winners_repeat": repeat,
        "launches": {n: cold["rmsnorm"]["dispatch_launches"][n]
                     + warm["rmsnorm"]["dispatch_launches"][n]
                     for n in RMS_KERNELS},
        # the searches' own launches: the report's (cold, twice) and the
        # dispatch-time ones
        "search_launches": {n: sum(s["launches"].get(n, 0)
                                   for s in cold["searches"])
                            for n in RMS_KERNELS}}
    print(f"tuning: cold {cold['process_s']:.1f} s (search "
          f"{cold['search_s']:.1f} s), warm {warm['process_s']:.1f} s; "
          f"rmsnorm block_rows {cold['rmsnorm']['block_rows']} / "
          f"{warm['rmsnorm']['block_rows']}, page size "
          f"{cold['page_size']} / {warm['page_size']}, losses "
          f"{cold['losses']}, warm counters {json.dumps(c)}, MoE block "
          f"rows {cold['moe']['block_rows']} / {warm['moe']['block_rows']}, "
          f"rmsnorm dispatch launches {report['tuning']['launches']}, "
          f"search launches {report['tuning']['search_launches']}, winners "
          f"repeat {json.dumps(repeat)}; {json.dumps(checks)}", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"tuning phase failed: {bad}")


# ---------------------------------------------------------------------------
# multi-tenant LoRA: the grouped matmul at the LoRA serve's shapes, the
# adapter engine on CUDA against the CPU, the 7B adapter serve, the router
# ---------------------------------------------------------------------------
# the store's slots at 7B; id LORA_SLOTS is the trash id (a base row)
LORA_SLOTS = 16
LORA_DECODE_IDS = [3, 3, 16, 0, 7, 16, 12, 3]     # unsorted, 2 trash rows
LORA_RANK = 16             # the 7B serve's adapters: q, k, v, o
LORA_ALPHA = 32.0
LORA_STD = 0.02            # A and B ~ N(0, 0.02)
# new tokens a request in the 7B LoRA phase's gates and the router phase:
# phase 4's count cut to keep the whole run near its earlier length (the
# timed serves keep phase 4's NEW_TOKENS, a window long enough to read)
LORA_NEW_TOKENS = 8


def gmm_lora_cases():
    """(label, rows, d, h, groups, slot ids or one slot, dtype): the LoRA
    delta's two grouped products at the 7B serve's shapes, the shrink x
    [rows, 4096] @ A[slot] [4096, r] and the expand h [rows, r] @ B[slot]
    [r, d_out]: a decode batch of 8 rows over unsorted slots with trash
    rows, a 256-row prefill chunk of one slot, a 128-row packed prefill
    frame of one slot (the 7B engine's frame buckets are 64, 128 and 256
    rows), the 7B width 4096 and the GQA k/v width 1024, ranks 8, 16 and
    64; and the fp32 pools of the small model."""
    import torch

    bf, dec = torch.bfloat16, LORA_DECODE_IDS
    return [("shrink_b8_r16", 8, 4096, 16, LORA_SLOTS, dec, bf),
            ("shrink_b8_r64", 8, 4096, 64, LORA_SLOTS, dec, bf),
            ("shrink_prefill256_r16", 256, 4096, 16, LORA_SLOTS, 5, bf),
            ("shrink_packed128_r16", 128, 4096, 16, LORA_SLOTS, 9, bf),
            ("expand_b8_r16", 8, 16, 4096, LORA_SLOTS, dec, bf),
            ("expand_prefill256_r16", 256, 16, 4096, LORA_SLOTS, 5, bf),
            ("expand_packed128_r16", 128, 16, 4096, LORA_SLOTS, 9, bf),
            ("expand_prefill256_r16_gqa", 256, 16, 1024, LORA_SLOTS, 5, bf),
            ("shrink_b8_r8", 8, 4096, 8, LORA_SLOTS, dec, bf),
            ("expand_b8_r8", 8, 8, 4096, LORA_SLOTS, dec, bf),
            ("fp32_b8_r8", 8, 64, 8, 4, [0, 2, 4, 1, 1, 4, 3, 0],
             torch.float32)]


def run_gmm_lora_case(gen, rows, d, h, groups, ids, dtype, floor):
    """gmm_fwd at one LoRA shape against grouped_matmul_reference (the
    fp32 per-row rule, trash rows exactly zero); its device ms beside the
    bound (the rows of x, the A slices of the slots present and y, over
    3.35 TB/s, or the flops of the rows that hold a slot) and the launch
    floor; torch._grouped_mm over the same rows sorted by slot for scale,
    the sort's device ms apart."""
    import torch

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    gids = (torch.tensor(ids, dtype=torch.int32, device="cuda")
            if isinstance(ids, list)
            else torch.full((rows,), ids, dtype=torch.int32, device="cuda"))
    x = _rand(gen, (rows, d), dtype)
    w = (torch.randn((groups, d, h), generator=gen, device="cuda")
         * LORA_STD).to(dtype)
    out = gm.gmm_fwd(x, w, gids)
    torch.cuda.synchronize()
    ref = gm.grouped_matmul_reference(x, w, gids)
    cmp = _compare(out, ref, "float32")
    trash = gids >= groups
    trash_zero = bool((out[trash] == 0).all())
    call = lambda: gm.gmm_fwd(x, w, gids)  # noqa: E731
    bf16 = dtype == torch.bfloat16
    by_kernel = _device_ms_by_kernel(call)
    ms = _kernel_ms(by_kernel, "gmm_fwd_wgmma" if bf16 else "gmm_fwd_tf32")
    copy_ms = sum(v for k, v in by_kernel.items() if "gmm_fwd" not in k)
    call_ms = _cuda_ms(call)
    plain_ms = _cuda_ms(lambda: gm.grouped_matmul_reference(x, w, gids),
                        reps=5, warmup=1)
    real = int((~trash).sum())
    present = int(torch.unique(gids[~trash]).numel())
    es = x.element_size()
    nbytes = rows * d * es + present * d * h * es + rows * h * 4 + rows * 4
    flops = 2 * real * d * h
    if bf16:
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16")
    else:
        bound_ms, bound_by, _, _ = _fp32_product_bound(nbytes, flops, 3)
    library_ms = sort_ms = None
    library = "none: no PyTorch call computes an fp32 grouped product"
    if bf16:
        order = torch.argsort(gids, stable=True)[:real]
        xs, gs = x[order], gids[order]
        lib, library = _grouped_mm_call(xs, w, gs, groups)
        if lib is not None:
            library_ms = _device_ms_sum(lib)
            sort_ms = _device_ms_sum(lambda: (
                torch.argsort(gids, stable=True), x[order], gids[order]))
            library += ", rows sorted by slot (the sort's ms apart)"
    return dict(cmp, ok=cmp["ok"] and trash_zero, trash_zero=trash_zero,
                ms=ms, copy_ms=copy_ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, launch_floor_ms=floor,
                library_ms=library_ms, library_sort_ms=sort_ms,
                library=library, rows=rows, d=d, h=h, slots_present=present,
                flops=flops, bytes=nbytes)


def phase_gmm_lora(gen, report):
    """The LoRA shapes of gmm_fwd (`gmm_lora_cases`); returns the labels
    that disagree with the plain version."""
    import torch

    floor = launch_floor_ms()
    out = {}
    for label, rows, d, h, groups, ids, dtype in gmm_lora_cases():
        out[label] = r = run_gmm_lora_case(gen, rows, d, h, groups, ids,
                                           dtype, floor)
        lib = (f"{r['library_ms']:.4f} + sort {r['library_sort_ms']:.4f}"
               if r["library_ms"] is not None else "none")
        print(f"gmm_fwd lora {label}: err {r['max_abs_err']:.3g} row rel "
              f"{r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) trash zero "
              f"{r['trash_zero']} ms {r['ms']:.4f} (device; copies "
              f"{r['copy_ms']:.4f}; call {r['call_ms']:.4f}; launch floor "
              f"{floor:.4f}) bound {r['bound_ms']:.6f} ({r['bound_by']}, "
              f"{r['bound_share']:.2%}) slots {r['slots_present']} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {lib} ({r['library']})",
              flush=True)
        torch.cuda.empty_cache()
    report["gmm_lora_cases"] = out
    return [f"gmm_fwd lora {k}" for k, r in out.items() if not r["ok"]]


def _lora_export(model, out_dir, names, rank, seed, b_std):
    """Random adapters written by the port's export_adapter from `model`
    (attach, B ~ N(0, b_std), export, detach): {id: path}."""
    import torch

    from paddle_tpu_torch.lora import LoRAConfig, attach, detach, \
        export_adapter

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for i, aid in enumerate(names):
        h = attach(model, LoRAConfig(rank=rank, alpha=2.0 * rank,
                                     seed=seed + i))
        g = torch.Generator(device=model.device)
        g.manual_seed(seed + 100 + i)
        with torch.no_grad():
            for _, _, _, b in h.entries:
                b.normal_(0.0, b_std, generator=g)
        paths[aid] = os.path.join(out_dir, f"{aid}.pdmodel")
        export_adapter(paths[aid], h, adapter_id=aid)
        detach(h)
    return paths


def _lora_engine(model, paths, rank, slots, dev, **kw):
    from paddle_tpu_torch.lora import AdapterStore
    from paddle_tpu_torch.serving import ServingEngine

    store = AdapterStore(model, rank=rank, slots=slots)
    for aid, src in paths.items():
        store.register(aid, src)
    return ServingEngine(model, _engine_cfg(**kw), adapter_store=store,
                         device=dev)


def _lora_serve(eng, prompts, adapters, new_tokens):
    """Submit all, one step, the page tables, then to the end: (streams,
    page tables after the first step)."""
    rids = [eng.submit(p, max_new_tokens=new_tokens, adapter=a,
                       tenant=a or "") for p, a in zip(prompts, adapters)]
    eng.step()
    tables = [eng.allocator.page_table_row(r, eng.pages_per_seq).tolist()
              for r in rids]
    eng.run_until_idle()
    streams = [list(eng.scheduler.get(r).generated) for r in rids]
    for r in rids:
        eng.release(r)
    eng.allocator.check_consistency()
    return streams, tables


def _hot_swap_race(eng, blob_of, prompt, steps_min=20):
    """A thread re-registers adapter "ten-a" back and forth between two
    versions (A[0, 0] set to 1 or 2 in every target), with no pause,
    while an InProcessReplica's driver (no pause either) decodes one
    request through it. Every step's projections must read one version
    (the store stages a swap and the engine writes it at the start of its
    next step), both must have been read, and swaps must have landed
    while the stream ran. Returns (ok, steps, marks seen, swaps during
    the stream)."""
    import threading

    import numpy as np

    from paddle_tpu_torch.lora import seam
    from paddle_tpu_torch.serving import InProcessReplica

    blobs = []
    for mark in (1.0, 2.0):
        weights = {}
        for name, (a, b) in blob_of["weights"].items():
            a = np.array(a)
            a[0, 0] = mark
            weights[name] = (a, b)
        blobs.append({"adapter": blob_of["adapter"], "weights": weights})
    store = eng.adapters
    store.register("ten-a", blobs[0])
    seen, marks, swaps = [], [], []
    real, real_step = seam.serve_delta, eng.step

    def spy(v, a_pool, b_pool, binding):
        slot = int(binding.slots[0])
        if slot < binding.num_slots:
            seen.append(float(a_pool[slot, 0, 0]))
        return real(v, a_pool, b_pool, binding)

    def step():
        seen.clear()
        out = real_step()
        if seen:
            marks.append(sorted(set(seen)))
        return out

    stop = threading.Event()

    def swapper():
        i = 1
        while not stop.is_set():
            store.register("ten-a", blobs[i % 2])
            swaps.append(time.monotonic())
            i += 1

    seam.serve_delta, eng.step = spy, step
    t = threading.Thread(target=swapper)
    t0 = t1 = time.monotonic()
    try:
        with InProcessReplica(eng, replica_id=0) as rep:
            stream = rep.open_stream({
                "prompt_ids": np.asarray(prompt).tolist(),
                "max_new_tokens": max(steps_min, 24), "adapter": "ten-a"})
            t.start()
            t0 = time.monotonic()
            try:
                ev = None
                while ev is None or "done" not in ev:
                    ev = stream.next_event(60.0)
                    if ev is None:
                        break
                t1 = time.monotonic()
            finally:
                stop.set()
                t.join()
                stream.close()
    finally:
        stop.set()
        seam.serve_delta = real
        del eng.step
    landed = sum(t0 <= ts <= t1 for ts in swaps)
    one = all(len(m) == 1 for m in marks)
    both = {m[0] for m in marks if m} == {1.0, 2.0}
    return one and both and landed >= 2, len(marks), marks, landed


def phase_lora_cuda_vs_cpu(seed, report):
    """Multi-tenant LoRA on CUDA (the grouped-matmul kernel, fp32 pools:
    its split-TF32 route) against the CPU (plain versions), on phase 3's
    fp32 GQA model: an AdapterStore of 4 slots, 3 adapters registered from
    files the port's export_adapter wrote, a base request and 2 for each
    adapter in one continuous batch at spec_k 0 and 3. Gates: streams and
    page tables equal to the CPU engine's, each stream equal to the
    request served alone on CUDA; two 40-token prompts sharing 32 served
    base then adapter (and the reverse) with prefix sharing on, each
    equal to its stream alone and no adoption across them; a hot swap
    raced against a decode loop reading one version a step; the
    serving.lora.swap_fail point giving one typed AdapterLoadError with
    the other streams unchanged; a rank-4 adapter (pools padded to 8 on
    CUDA) giving the CPU's streams; two replicas behind the adapter-affine
    router with serving.replica.kill armed mid-run: every stream complete
    and equal to the CPU's."""
    import numpy as np

    from paddle_tpu_torch.distributed.resilience import faults
    from paddle_tpu_torch.lora import AdapterLoadError, load_adapter
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import InProcessReplica, Router, \
        RouterConfig

    cfg = llama_tiny_config(vocab_size=1024, hidden_size=512,
                            intermediate_size=1024, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            max_position_embeddings=512)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    cpu_model.eval()
    gpu_model.eval()
    out_dir = os.path.join(REPO, "chiprun_out", "lora_adapters")
    names = ("ten-a", "ten-b", "ten-c")
    paths = _lora_export(cpu_model, out_dir, names, 8, seed, 0.02)
    kw = dict(page_size=16, num_pages=128, decode_batch=8, prefill_chunk=64,
              pack_frame=128, max_seq_len=256, prefix_sharing=False)
    rng = np.random.RandomState(seed + 5)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 70, 20, 100, 33, 9)]
    adapters = [None, "ten-a", "ten-a", "ten-b", "ten-b", "ten-c", "ten-c"]
    new = 12
    res, bad = {}, []
    for k in (0, 3):
        runs = {}
        for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            eng = _lora_engine(model, paths, 8, 4, dev, spec_k=k, **kw)
            port_cuda.reset_launch_counts()
            runs[dev] = _lora_serve(eng, prompts, adapters, new)
            runs[dev + "_tf32"] = port_cuda.launch_counts()["gmm_fwd_tf32"]
            if dev == "cuda" and k == 0:
                cuda_eng = eng
        r = dict(streams_equal=runs["cuda"][0] == runs["cpu"][0],
                 tables_equal=runs["cuda"][1] == runs["cpu"][1],
                 gmm_launches=runs["cuda_tf32"],
                 streams=runs["cuda"][0])
        if k == 0:
            alone = [_lora_serve(cuda_eng, [p], [a], new)[0][0]
                     for p, a in zip(prompts, adapters)]
            r["alone_equal"] = alone == runs["cuda"][0]
            base_of_a = _lora_serve(cuda_eng, [prompts[1]], [None], new)[0]
            r["adapter_changes_stream"] = base_of_a[0] != runs["cuda"][0][1]
        r["ok"] = (r["streams_equal"] and r["tables_equal"]
                   and r["gmm_launches"] > 0 and r.get("alone_equal", True)
                   and r.get("adapter_changes_stream", True))
        res[f"spec_k{k}"] = r
        print(f"lora cuda vs cpu spec_k {k}: streams equal "
              f"{r['streams_equal']} page tables equal {r['tables_equal']} "
              f"alone equal {r.get('alone_equal')} adapter changes a stream "
              f"{r.get('adapter_changes_stream')} gmm_fwd_tf32 launches "
              f"{r['gmm_launches']}", flush=True)
        if not r["ok"]:
            bad.append(f"spec_k {k}")
    want = res["spec_k0"]["streams"]

    # the prefix namespace: a base and an adapter request sharing 32 tokens
    common = rng.randint(1, cfg.vocab_size, 32).astype(np.int32)
    pair = [np.concatenate([common, rng.randint(1, cfg.vocab_size, 8)
                            .astype(np.int32)]) for _ in range(2)]
    ns = {}
    shared = _lora_engine(gpu_model, paths, 8, 4, "cuda",
                          **{**kw, "prefix_sharing": True})
    for order in ((None, "ten-a"), ("ten-a", None)):
        rids = [shared.submit(pair[0], max_new_tokens=new, adapter=order[0])]
        shared.step()
        m0 = shared.allocator.prefix_tokens_matched
        rids.append(shared.submit(pair[1], max_new_tokens=new,
                                  adapter=order[1]))
        shared.run_until_idle()
        got = [list(shared.scheduler.get(r).generated) for r in rids]
        matched = shared.allocator.prefix_tokens_matched - m0
        for r in rids:
            shared.release(r)
        alone = [_lora_serve(cuda_eng, [p], [a], new)[0][0]
                 for p, a in zip(pair, order)]
        ns[f"{order[0] or 'base'}_then_{order[1] or 'base'}"] = dict(
            equal_alone=got == alone, matched_tokens=matched)
    res["namespace"] = ns
    ns_ok = all(v["equal_alone"] and v["matched_tokens"] == 0
                for v in ns.values())
    print(f"lora prefix namespace: {json.dumps(ns)}", flush=True)
    if not ns_ok:
        bad.append("namespace")

    # a hot swap racing the decode loop
    race_ok, race_steps, marks, landed = _hot_swap_race(
        cuda_eng, load_adapter(paths["ten-a"]), prompts[2])
    cuda_eng.adapters.register("ten-a", paths["ten-a"])
    versions = [m[0] if len(m) == 1 else m for m in marks]
    res["hot_swap_race"] = dict(ok=race_ok, steps=race_steps,
                                versions_by_step=versions,
                                swaps_during_stream=landed)
    print(f"lora hot swap race (through an InProcessReplica, no pauses): "
          f"one version a step, both seen and swaps landed {race_ok} over "
          f"{race_steps} steps ({landed} swaps during the stream; versions "
          f"{versions})", flush=True)
    if not race_ok:
        bad.append("hot swap race")

    # serving.lora.swap_fail: one typed error, the other streams unchanged
    extra = _lora_export(cpu_model, out_dir, ("ten-d",), 8, seed + 50, 0.02)
    cuda_eng.adapters.register("ten-d", extra["ten-d"])
    faults.reset()
    faults.arm("serving.lora.swap_fail", mode="always")
    errors = 0
    try:
        rids = [cuda_eng.submit(p, max_new_tokens=new, adapter=a)
                for p, a in zip(prompts, adapters)]
        try:
            cuda_eng.submit(prompts[0], max_new_tokens=new, adapter="ten-d")
        except AdapterLoadError:
            errors += 1
        cuda_eng.run_until_idle()
        got = [list(cuda_eng.scheduler.get(r).generated) for r in rids]
        for r in rids:
            cuda_eng.release(r)
    finally:
        faults.reset()
    res["swap_fail"] = dict(typed_errors=errors, others_equal=got == want)
    print(f"lora swap_fail: typed errors {errors}, other streams equal "
          f"{got == want}", flush=True)
    if errors != 1 or got != want:
        bad.append("swap_fail")

    # rank 4: pools padded to rank 8 on CUDA, unpadded on the CPU
    r4 = _lora_export(cpu_model, out_dir, ("ten-r4",), 4, seed + 60, 0.02)
    r4_streams = {}
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        eng = _lora_engine(model, r4, 4, 2, dev, **kw)
        r4_streams[dev] = _lora_serve(eng, prompts[:3], ["ten-r4"] * 3,
                                      new)[0]
        if dev == "cuda":
            pool_rank = eng.adapters.pool_rank
    res["rank4"] = dict(equal=r4_streams["cuda"] == r4_streams["cpu"],
                        cuda_pool_rank=pool_rank)
    print(f"lora rank 4 (cuda pool rank {pool_rank}): streams equal to the "
          f"cpu's {res['rank4']['equal']}", flush=True)
    if not res["rank4"]["equal"] or pool_rank != 8:
        bad.append("rank 4")

    # two replicas behind the router, one killed mid-run
    reps = [InProcessReplica(_lora_engine(gpu_model, paths, 8, 4, "cuda",
                                          **kw), replica_id=i)
            for i in range(2)]
    router = Router(reps, RouterConfig(
        placement="adapter", probe_interval_s=0.02, failure_threshold=2,
        breaker_cooldown_s=5.0, dispatch_attempts=4, gap_timeout_s=30.0,
        max_inflight=64, shed_queue_depth=10_000, backoff_initial_s=0.01,
        backoff_max_s=0.05))
    faults.reset()
    streamed = [0]

    def arm_mid_run():
        # armed once 10 tokens have streamed: the next driver to pass the
        # point dies with requests in flight
        streamed[0] += 1
        if streamed[0] == 10:
            faults.arm("serving.replica.kill")

    try:
        results = _route_all(router, [
            {"prompt_ids": p.tolist(), "max_new_tokens": new,
             "adapter": a, "session": f"s{i}"}
            for i, (p, a) in enumerate(zip(prompts, adapters))],
            on_token=arm_mid_run)
        fired = faults.fired("serving.replica.kill")
    finally:
        faults.reset()
        router.close()
        for rep in reps:
            rep.close()
    kill = dict(fired=fired, dead=sum(r.dead_cause is not None
                                      for r in reps),
                done=all(t.get("done") for _, t in results),
                equal_cpu=[s for s, _ in results] == want,
                failovers=sum(t.get("failovers", 0) for _, t in results))
    res["router_kill"] = kill
    print(f"lora router kill: {json.dumps(kill)}", flush=True)
    if not (kill["fired"] == 1 and kill["dead"] == 1 and kill["done"]
            and kill["equal_cpu"]):
        bad.append("router kill")
    report["lora_cuda_vs_cpu"] = res
    if bad:
        raise AssertionError(f"LoRA CUDA vs CPU failed: {bad}")


def _route_all(router, payloads, on_token=None):
    """Every payload through `router` at once, one client thread each:
    [(tokens, terminal event)] in payload order. `on_token()` runs after
    each token any stream emits."""
    import threading

    results = [None] * len(payloads)

    def client(i):
        toks, term = [], None
        for ev in router.stream(payloads[i]):
            if "token" in ev:
                toks.append(ev["token"])
                if on_token is not None:
                    on_token()
            else:
                term = ev
        results[i] = (toks, term)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a routed request hung")
    return results


def _lora_blobs(model, names, seed):
    """Random rank-LORA_RANK adapters for `model`'s q/k/v/o as store
    blobs (A and B ~ N(0, LORA_STD) in bf16, alpha LORA_ALPHA)."""
    import torch

    from paddle_tpu_torch.lora import find_targets
    from paddle_tpu_torch.lora.adapter import DEFAULT_TARGETS, target_dims

    gen = torch.Generator()
    gen.manual_seed(seed)
    blobs = {}
    for aid in names:
        weights = {}
        for path, w in find_targets(model, DEFAULT_TARGETS):
            d_in, d_out = target_dims(w)
            weights[path] = tuple(
                (torch.randn(shape, generator=gen) * LORA_STD)
                .to(torch.bfloat16)
                for shape in ((d_in, LORA_RANK), (LORA_RANK, d_out)))
        blobs[aid] = {"adapter": {"rank": LORA_RANK, "alpha": LORA_ALPHA},
                      "weights": weights}
    return blobs


def _lora_timed_serve(eng, prompts, adapters):
    """Phase 4's timed serve (NEW_TOKENS new tokens a request) with
    per-request adapters: streams, launches over the serve, decode
    launches a step, prefill and decode tokens/s."""
    import torch

    from paddle_tpu_torch.ops import cuda as port_cuda

    torch.cuda.synchronize()
    port_cuda.reset_launch_counts()          # the path starts here
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS, adapter=a,
                       tenant=a or "")
            for p, a in zip(prompts, adapters)]
    eng.step()                               # all prefills + step 1
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    at_first = port_cuda.launch_counts()
    steps0 = eng.stats()["decode_steps"]
    eng.run_until_idle()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = port_cuda.launch_counts()     # ... and ends here
    steps = eng.stats()["decode_steps"] - steps0
    streams = [list(eng.scheduler.get(r).generated) for r in rids]
    for r in rids:
        eng.release(r)
    gen_tokens = sum(len(s) for s in streams)
    return dict(
        streams=streams, launches=launches, decode_steps=steps,
        decode_launches_per_step={
            k: (launches[k] - at_first[k]) / max(steps, 1)
            for k in launches if launches[k] - at_first[k]},
        prefill_launches={k: v for k, v in at_first.items() if v},
        prefill_s=t_first - t0,
        prefill_tokens_per_s=sum(int(p.size) for p in prompts)
        / (t_first - t0),
        decode_tokens_per_s=(gen_tokens - len(prompts))
        / (t_end - t_first))


def _lora_first_logits(eng, prompts, adapters):
    """The first decode step's logits [rows, vocab] (fp32, CPU) of the
    requests, in submission order (the hook reads the decode rows'
    owners), and their streams."""
    seen = []
    rids = [eng.submit(p, max_new_tokens=4, adapter=a)
            for p, a in zip(prompts, adapters)]

    def hook(_mod, _inp, out):
        if not seen:
            owners = [r.rid for r in eng.scheduler.running]
            rows = out[:, 0].float().cpu()
            seen.append(rows[[owners.index(r) for r in rids]])

    handle = eng.model.lm_head.register_forward_hook(hook)
    try:
        eng.run_until_idle()
    finally:
        handle.remove()
    streams = [list(eng.scheduler.get(r).generated) for r in rids]
    for r in rids:
        eng.release(r)
    return seen[0], streams


def _plain_delta_product(x, w, gids):
    """fp32 ``y[i] = x[i] @ w[gids[i]]`` by one cuBLAS product for each
    slot present (trash rows zero): the grouped matmul's plain version at
    the cost of the slots a call carries, for the 7B delta check."""
    import torch

    y = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for g in torch.unique(gids).tolist():
        if g < w.shape[0]:
            rows = (gids == g).nonzero().squeeze(1)
            y[rows] = x[rows].float() @ w[g].float()
    return y


def _lora_first_logits_by_route(eng, prompts, adapters, route):
    """`_lora_first_logits` (the logits only) with every adapter delta's
    grouped product by `route`: "plain", `_plain_delta_product` from the
    store's pools; or "checked", the kernel, each call held on its own
    inputs against `_plain_delta_product` (the per-row fp32 rule, trash
    rows exactly zero), which holds the kernel at every shape the 7B path
    gives it (decode rows, prefill chunks, packed frames). Returns the
    logits and, for "checked", the calls' summary."""
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    kernel = gm.gmm_fwd
    calls = dict(n=0, failed=0, worst_row_rel_err=0.0, rtol=RTOL["float32"],
                 shapes=set())

    def checked(x, w, gids):
        out = kernel(x, w, gids)
        cmp = _compare(out, _plain_delta_product(x, w, gids), "float32")
        trash_zero = bool((out[gids >= w.shape[0]] == 0).all())
        calls["n"] += 1
        calls["failed"] += not (cmp["rows_ok"] and trash_zero)
        calls["worst_row_rel_err"] = max(calls["worst_row_rel_err"],
                                         cmp["max_rel_err"])
        calls["shapes"].add((x.shape[0], x.shape[1], w.shape[-1]))
        return out

    gm.gmm_fwd = checked if route == "checked" else _plain_delta_product
    try:
        logits = _lora_first_logits(eng, prompts, adapters)[0]
    finally:
        gm.gmm_fwd = kernel
    calls["shapes"] = sorted(calls["shapes"])
    return logits, calls


def _lora_decode_profile(eng, prompts, adapters):
    """A profile of two decode steps of `prompts` (the timed serve's mix):
    the grouped-matmul kernels' device ms a step beside the step's."""
    rids = [eng.submit(p, max_new_tokens=6, adapter=a)
            for p, a in zip(prompts, adapters)]
    eng.step()                                   # prefills + first decode
    prof = _device_profile(eng.step, 2)
    eng.run_until_idle()
    for r in rids:
        eng.release(r)
    gmm = sum(ms for k, ms in prof["port_kernel_ms_per_step"].items()
              if k.startswith("gmm_fwd"))
    return dict(gmm_ms_per_step=gmm,
                device_ms_per_step=prof["device_ms_per_step"],
                wall_ms_per_step=prof["wall_ms_per_step"],
                gmm_share_of_device=(gmm / prof["device_ms_per_step"]
                                     if prof["device_ms_per_step"] else None),
                port_kernel_ms_per_step=prof["port_kernel_ms_per_step"],
                top_device_ms=prof["top_device_ms"])


def phase_full_width_lora(args, model, prompts, report):
    """Multi-tenant LoRA at the 7B geometry on phase 4's model: a fresh
    engine (phase 4's settings) with an AdapterStore of rank 16 on q, k,
    v, o and 16 slots, 4 random adapters (A, B ~ N(0, 0.02), alpha 32)
    swapped in once each. Phase 4's 8 prompts (NEW_TOKENS new tokens
    each) served base-only, then 2 base and 2 for each of 3 adapters,
    then the two again in the other order (base, adapters, adapters,
    base: the spread of the rates): prefill and
    decode tokens/s, launches over the serve and a decode step (the
    grouped matmul 2 x 4 x 32 = 256 a step), a profile of the adapter
    decode step (the grouped-matmul kernels' device ms against the
    step's), swap-in ms, peak memory. Gates: each adapter request's first
    decode-step logits within BF16_LOGIT_RTOL of the row max of the same
    request served alone (holds the batch composition); every gmm_fwd
    call of one pass of the mix (prefills and the first decode step)
    within the per-row fp32 rule of the plain fp32 product on its own
    inputs (holds the kernel at the path's shapes). Reported: the first
    logits against the same mix with every delta by the plain product
    (32 bf16 layers grow the products' rounding, as they grow the verify
    frame's; printed beside BF16_LOGIT_RTOL) and the streams' agreement
    (LORA_NEW_TOKENS tokens alone)."""
    import torch

    from paddle_tpu_torch.lora import AdapterStore
    from paddle_tpu_torch.observability.events import journal
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.config
    names = ("ten-a", "ten-b", "ten-c", "ten-d")
    blobs = _lora_blobs(model, names, args.seed + 11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store = AdapterStore(model, rank=LORA_RANK, slots=LORA_SLOTS)
    t0 = time.perf_counter()
    for aid in names:
        store.register(aid, blobs[aid])
    register_s = time.perf_counter() - t0
    eng = ServingEngine(model, _engine_cfg(
        page_size=16, decode_batch=8, prefill_chunk=256, max_seq_len=4096,
        hbm_budget_mb=16384), adapter_store=store, device="cuda")
    warm = prompts[0]
    for aid in names:                        # one swap-in each, then warm
        eng.generate([warm], max_new_tokens=2, adapter=aid)
    eng.generate([warm], max_new_tokens=2)
    swaps = [e for e in journal().recent(64)
             if e["event"] == "adapter_swap"
             and e.get("store") == store._metrics_id]
    adapters = [None, None, "ten-a", "ten-a", "ten-b", "ten-b", "ten-c",
                "ten-c"]
    base = _lora_timed_serve(eng, prompts, [None] * len(prompts))
    lora = _lora_timed_serve(eng, prompts, adapters)
    lora2 = _lora_timed_serve(eng, prompts, adapters)
    base2 = _lora_timed_serve(eng, prompts, [None] * len(prompts))
    pairs = ((lora, base), (lora2, base2))
    rates = {
        key: dict(
            base=[b[key] for _, b in pairs], lora=[a[key] for a, _ in pairs],
            ratio=[a[key] / b[key] for a, b in pairs])
        for key in ("decode_tokens_per_s", "prefill_tokens_per_s")}
    prof = _lora_decode_profile(eng, prompts, adapters)
    prof_base = _lora_decode_profile(eng, prompts, [None] * len(prompts))
    mixed_logits, _ = _lora_first_logits(eng, prompts, adapters)
    alone_logits = torch.cat([_lora_first_logits(eng, [p], [a])[0]
                              for p, a in zip(prompts, adapters)])
    # kernel against plain delta: re-registering the same weights opens a
    # fresh prefix namespace, so each run's adapter requests prefill their
    # whole prompts through their own delta route
    by_route = {}
    for route in ("checked", "plain"):
        for aid in set(filter(None, adapters)):
            store.register(aid, blobs[aid])
        by_route[route] = _lora_first_logits_by_route(eng, prompts,
                                                      adapters, route)
    (kernel_logits, calls), (plain_logits, _) = (by_route["checked"],
                                                 by_route["plain"])

    def rel_err(got, ref):
        err = (got - ref).abs().amax(-1)
        return (err / ref.abs().amax(-1)).tolist()

    rel = rel_err(mixed_logits, alone_logits)
    rel_plain = rel_err(kernel_logits, plain_logits)
    argmax_plain = (kernel_logits.argmax(-1)
                    == plain_logits.argmax(-1)).tolist()
    alone_streams = [eng.generate([p], max_new_tokens=LORA_NEW_TOKENS,
                                  adapter=a)[0]
                     for p, a in zip(prompts, adapters)]
    gmm_step = lora["decode_launches_per_step"].get("gmm_fwd", 0)
    out = dict(
        layers=cfg.num_hidden_layers, rank=LORA_RANK, slots=LORA_SLOTS,
        adapters=list(adapters), register_s=register_s,
        swap_in_ms=[e["ms"] for e in swaps],
        swap_in_ms_mean=store.swap_ms_mean,
        base={k: v for k, v in base.items() if k != "streams"},
        lora={k: v for k, v in lora.items() if k != "streams"},
        rates_base_lora_lora_base=rates,
        launches=lora["launches"],
        gmm_launches_per_decode_step=gmm_step,
        gmm_launches_want=2 * 4 * cfg.num_hidden_layers,
        decode_profile_lora=prof, decode_profile_base=prof_base,
        first_logits_rel_err=rel,
        gmm_calls_vs_plain=calls,
        first_logits_rel_err_vs_plain_delta=rel_plain,
        first_argmax_equal_vs_plain_delta=argmax_plain,
        logit_rtol=BF16_LOGIT_RTOL,
        agreement_mixed_vs_alone=_agreement(lora["streams"], alone_streams),
        agreement_lora_vs_base=_agreement(lora["streams"], base["streams"]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["full_width_lora"] = out
    print("full width lora: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("launches",)},
        default=str), flush=True)
    problems = []
    if gmm_step != out["gmm_launches_want"]:
        problems.append(f"{gmm_step} gmm_fwd launches a decode step, want "
                        f"{out['gmm_launches_want']}")
    adapter_rows = [i for i, a in enumerate(adapters) if a]
    if not all(rel[i] <= BF16_LOGIT_RTOL for i in adapter_rows):
        problems.append(f"adapter first-step logits off: {rel}")
    if not calls["n"] or calls["failed"]:
        problems.append(f"gmm_fwd on the 7B path off its plain version: "
                        f"{calls['failed']} of {calls['n']} calls")
    if not all(len(s) == NEW_TOKENS
               for r in (base, lora, lora2, base2) for s in r["streams"]):
        problems.append("incomplete streams")
    if problems:
        raise AssertionError("; ".join(problems))
    return blobs


def phase_full_width_router(args, model, blobs, prompts, report):
    """Two InProcessReplicas over two engines sharing phase 4's 7B weights
    (each its own 8 GiB KV pool and AdapterStore of the 4 adapters) behind
    Router(placement="adapter"). Gates: phase 4's 8 requests (2 base, 2
    for each of 3 adapters) complete; each adapter's requests land on one
    replica; an unknown adapter gives one adapter_load_failed event; the
    same requests again with replica 1 killed mid-stream (its kill(), once
    one of its requests has 2 tokens) all complete with every token, none
    lost;
    GET /metrics over HTTP carries lora_active_adapters and router_*
    series. The launches are read around the first routed serve."""
    import http.client
    import threading

    import torch

    from paddle_tpu_torch.lora import AdapterStore
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import (InProcessReplica, Router,
                                          RouterConfig, ServingEngine,
                                          rendezvous_order)

    adapters = [None, None, "ten-a", "ten-a", "ten-b", "ten-b", "ten-c",
                "ten-c"]
    reps = []
    for i in range(2):
        store = AdapterStore(model, rank=LORA_RANK, slots=LORA_SLOTS)
        for aid, blob in blobs.items():
            store.register(aid, blob)
        eng = ServingEngine(model, _engine_cfg(
            page_size=16, decode_batch=8, prefill_chunk=256,
            max_seq_len=4096, hbm_budget_mb=8192), adapter_store=store,
            device="cuda")
        eng.generate([prompts[0]], max_new_tokens=2, adapter="ten-a")
        reps.append(InProcessReplica(eng, replica_id=i))
    router = Router(reps, RouterConfig(
        placement="adapter", probe_interval_s=0.05, failure_threshold=2,
        breaker_cooldown_s=30.0, dispatch_attempts=3, gap_timeout_s=120.0,
        max_inflight=64, shed_queue_depth=10_000, backoff_initial_s=0.01,
        backoff_max_s=0.05))
    payloads = [{"prompt_ids": p.tolist(),
                 "max_new_tokens": LORA_NEW_TOKENS,
                 "adapter": a, "tenant": a or "base", "session": f"s{i}"}
                for i, (p, a) in enumerate(zip(prompts, adapters))]
    homes = {i: rendezvous_order(router.placement_key(pl), [0, 1])[0]
             for i, pl in enumerate(payloads)}
    srv = None
    try:
        torch.cuda.synchronize()
        port_cuda.reset_launch_counts()      # the routed path starts here
        t0 = time.perf_counter()
        first = _route_all(router, payloads)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = port_cuda.launch_counts()  # ... and ends here
        placed = {}
        for a, (_, term) in zip(adapters, first):
            if a:
                placed.setdefault(a, set()).add(term.get("replica"))
        ghost = router.generate({"prompt_ids": prompts[0].tolist(),
                                 "adapter": "ghost"})
        # the same requests again; replica 1 dies once one of its
        # requests has streamed 2 tokens (or, holding none, at the end)
        killer_done = threading.Event()

        def killer():
            eng1 = reps[1].engine
            while not killer_done.is_set():
                if any(len(r.generated) >= 2
                       for r in list(eng1.scheduler.running)):
                    break
                time.sleep(0.002)
            reps[1].kill("killed mid-stream")

        kt = threading.Thread(target=killer)
        kt.start()
        second = _route_all(router, payloads)
        killer_done.set()
        kt.join()
        srv = router.serve_http(0)
        st = threading.Thread(target=srv.serve_forever, daemon=True)
        st.start()
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=60)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        metrics = resp.read().decode()
        conn.close()
    finally:
        if srv is not None:
            srv.shutdown()
        router.close()
        for rep in reps:
            rep.close()
    out = dict(
        wall_s=wall_s, launches=launches,
        first_done=all(t.get("done") for _, t in first),
        first_complete=all(len(s) == LORA_NEW_TOKENS for s, _ in first),
        replicas=[t.get("replica") for _, t in first],
        homes=[homes[i] for i in range(len(payloads))],
        adapter_on_one_replica=all(len(v) == 1 for v in placed.values()),
        ghost=ghost[1], killed=reps[1].dead_cause is not None,
        on_replica_1=sum(1 for i in homes if homes[i] == 1),
        second_done=all(t.get("done") for _, t in second),
        second_complete=all(len(s) == LORA_NEW_TOKENS
                            for s, _ in second),
        failovers=sum(t.get("failovers", 0) for _, t in second),
        agreement_second_vs_first=_agreement([s for s, _ in second],
                                             [s for s, _ in first]),
        metrics_status=resp.status,
        metrics_has=dict(lora_active_adapters="lora_active_adapters"
                         in metrics, router="router_completed_total"
                         in metrics and "router_replica_circuit" in metrics))
    report["full_width_router"] = out
    print("full width router: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}, default=str),
        flush=True)
    problems = []
    if not (out["first_done"] and out["first_complete"]):
        problems.append("the first routed serve lost or cut a request")
    if not out["adapter_on_one_replica"]:
        problems.append(f"an adapter's requests spread: {placed}")
    if (ghost[0] or ghost[1].get("error") != "adapter_load_failed"):
        problems.append(f"unknown adapter: {ghost}")
    if not (out["killed"] and out["second_done"] and out["second_complete"]):
        problems.append("the kill lost or cut a request")
    if out["on_replica_1"] and not out["failovers"]:
        problems.append("replica 1 held requests but none failed over")
    if not (out["metrics_status"] == 200 and all(out["metrics_has"].values())):
        problems.append(f"/metrics: {out['metrics_has']}")
    if problems:
        raise AssertionError("; ".join(problems))


def kernels_line(report):
    """One row per kernel; `launches` counts the main paths' runs (the
    7B bf16 serve, the 7B int8 and fp8 serves and their visit counters,
    and the timed LLaMA and GPT-MoE training steps), each read around its
    run. gmm_fwd is the bf16 forward kernel (its row the h1 case),
    gmm_fwd_tf32 the split-TF32 one that the VJP's dx runs (its row the dx
    of h1 through ``GroupedMatmul.backward``), and gmm_dw's ms sums the
    three kernels its C entry launches. ce_bwd (the fused-CE backward,
    which the JAX package leaves to XLA) sums its C entry's kernels over
    every token chunk, with each kernel's ms apart, and its plain_ms is
    the fp32 cuBLAS route it replaced. gmm_visit is off the training
    path, so it has 0. The RMSNorm
    kernels' path is the tuning phase (the models keep the composite):
    their launches are its RMSNorm dispatch calls' (one in the cold
    process, one in the warm), and the autotuner's timing launches stand
    apart in `search_launches`."""
    from paddle_tpu_torch.ops.cuda import _build

    kv = report.get("full_width_kv", {})
    paths = [report.get("full_width", {}).get("launches", {}),
             report.get("full_width_spec", {}).get("launches", {}),
             kv.get("int8", {}).get("launches", {}),
             kv.get("fp8", {}).get("launches", {}),
             report.get("train_full_width", {}).get("launches", {}),
             report.get("train_moe_full_width", {}).get("launches", {}),
             report.get("full_width_lora", {}).get("launches", {}),
             report.get("full_width_router", {}).get("launches", {})]
    quant = report.get("paged_quant_cases", {})
    visit = report.get("visit_cases", {})
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
        ("ce_bwd", "ce_bwd.cu", "fused_ce.py:387",
         report.get("ce_bwd_cases", {}).get("n4096_h4096_v32000") or {}),
        ("gmm_fwd", "grouped_matmul.cu", "grouped_matmul.py:98",
         report.get("gmm_fwd_cases", {}).get("h1_bf16") or {}),
        ("gmm_fwd_tf32", "grouped_matmul.cu", "grouped_matmul.py:98",
         report.get("gmm_dx_cases", {}).get("dx_of_h1") or {}),
        ("gmm_dw", "grouped_matmul.cu", "grouped_matmul.py:117",
         report.get("gmm_dw_cases", {}).get("dw1_bf16x") or {}),
        ("gmm_visit", "grouped_matmul.cu", "grouped_matmul.py:291",
         report.get("gmm_visit_cases", {}).get("dispatch") or {}),
        ("paged_decode_int8", "paged_attention.cu", "paged_attention.py:103",
         quant.get("int8_decode_b8_h32") or {}),
        ("paged_decode_fp8", "paged_attention.cu", "paged_attention.py:103",
         quant.get("fp8_decode_b8_h32") or {}),
        ("paged_visit", "paged_attention.cu", "paged_attention.py:372",
         visit.get("paged_decode_b8") or {}),
        ("flash_visit", "flash_fwd.cu", "flash_attention.py:507",
         visit.get("flash_engine_frame_s256") or {})]
    rms = report.get("rmsnorm_cases", {}).get("r4096_d4096_bf16") or {}
    specs += [("rmsnorm_fwd", "rmsnorm.cu", "rmsnorm_kernel.py:47",
               rms.get("fwd", {})),
              ("rmsnorm_bwd", "rmsnorm.cu", "rmsnorm_kernel.py:54",
               rms.get("bwd", {})),
              ("rmsnorm_dw", "rmsnorm.cu", "rmsnorm_kernel.py:54",
               rms.get("dw", {}))]
    tuning = report.get("tuning", {})
    rows = []
    for name, src, replaces, case in specs:
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(os.path.join(_build.CSRC_DIR, src),
                                      REPO),
            "replaces": pallas + replaces,
            "launches": (tuning.get("launches", {}).get(name, 0)
                         if name in RMS_KERNELS
                         else sum(p.get(name, 0) for p in paths)),
            "max_abs_err": case.get("max_abs_err"), "ms": case.get("ms"),
            **({"call_ms": case["call_ms"]} if "call_ms" in case else {}),
            **({"launch_floor_ms": case["launch_floor_ms"]}
               if "launch_floor_ms" in case else {}),
            "plain_ms": case.get("plain_ms"),
            "bound_ms": case.get("bound_ms"),
            "bound_by": case.get("bound_by"),
            "library_ms": case.get("library_ms")})
        if case.get("design_bound_ms") and case.get("passes", 1) > 1:
            # split TF32: the design's ceiling beside the function's bound,
            # and the wrapper's copy of w (dx) apart from the kernel's ms
            rows[-1].update(passes=case["passes"],
                            design_bound_ms=case["design_bound_ms"])
            if "copy_ms" in case:
                rows[-1]["copy_ms"] = case["copy_ms"]
        if name == "gmm_fwd":
            # the LoRA serve's shapes (the 7B adapter decode's products)
            rows[-1]["lora_cases"] = {
                k: {f: c.get(f) for f in (
                    "ms", "bound_ms", "bound_by", "launch_floor_ms",
                    "plain_ms", "library_ms", "library_sort_ms",
                    "max_abs_err")}
                for k, c in report.get("gmm_lora_cases", {}).items()}
        if name == "ce_bwd":
            rows[-1]["note"] = ("_bwd_tokens: XLA in the JAX package (a "
                                "lax.scan of matmuls), no pallas_call")
            rows[-1]["kernel_ms"] = case.get("kernel_ms")
        if name in RMS_KERNELS:
            rows[-1]["search_launches"] = tuning.get(
                "search_launches", {}).get(name, 0)
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth of the full-width serving phase")
    ap.add_argument("--tuning-worker", choices=("cold", "warm"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.tuning_worker:        # one process of the tuning phase
        return tuning_worker(args.tuning_worker, args.seed, args.out)
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
                            if "registers" in ln or "spill" in ln
                            or "Compiling entry" in ln or "arning" in ln]
                        for n in _build.kernel_names()},
              "failed": []}
    spills = []
    # the sm90 core's kernels, the paged tensor-core kernel, the RMSNorm
    # ring kernels and the two visit counters
    for src in ("grouped_matmul", "fused_ce", "ce_bwd", "paged_attention",
                "rmsnorm", "flash_fwd"):
        lines = report["ptxas"][src]
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and (
                    "wgmma_kernel" in ln or "tf32_kernel" in ln
                    or "paged_decode_kernel_mma" in ln
                    or "_ring_kernel" in ln or "visit_kernel" in ln):
                print("ptxas " + " | ".join(x.strip() for x in lines[i:i + 3]),
                      flush=True)
                if not any("0 bytes spill stores, 0 bytes spill loads" in x
                           for x in lines[i + 1:i + 3]):
                    spills.append(ln.strip())
    if spills:        # accumulators and staged rows stay in registers
        print(f"ptxas: kernels spill: {spills}",
              file=sys.stderr)
        report["failed"].append("build")
    # the RMSNorm phase runs early: late in a long process the profiler
    # drops whole windows of short kernels' events
    phases = [("kernels", lambda: phase_kernels(args.seed, report)),
              ("rmsnorm", lambda: phase_rmsnorm(args.seed, report)),
              ("cuda_vs_cpu", lambda: phase_cuda_vs_cpu(args.seed, report)),
              ("kv_cuda_vs_cpu",
               lambda: phase_kv_cuda_vs_cpu(args.seed, report)),
              ("spec_cuda_vs_cpu",
               lambda: phase_spec_cuda_vs_cpu(args.seed, report)),
              ("lora_cuda_vs_cpu",
               lambda: phase_lora_cuda_vs_cpu(args.seed, report))]
    state = {}

    def full_width():
        state["eng"], state["prompts"], state["streams"] = \
            phase_full_width(args, report)

    def http():
        if "eng" not in state:
            raise RuntimeError("the full-width phase built no engine")
        phase_http(state["eng"], state["prompts"][1], report)

    def full_width_spec():
        if "eng" not in state:
            raise RuntimeError("the full-width phase built no engine")
        phase_full_width_spec(state["eng"], state["prompts"],
                              state["streams"], report)

    def full_width_kv():
        if "eng" not in state:
            raise RuntimeError("the full-width phase built no engine")
        # the bf16 engine's pools make room for the quantized ones
        eng = state.pop("eng")
        model, pages = eng.model, eng.num_pages
        state["model"] = model
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        state["kv_launches"] = phase_full_width_kv(
            args, model, state["prompts"], state["streams"], pages, report)

    def full_width_lora():
        if "model" not in state:
            raise RuntimeError("the full-width phase built no model")
        gc.collect()
        torch.cuda.empty_cache()
        state["lora_blobs"] = phase_full_width_lora(
            args, state["model"], state["prompts"], report)

    def full_width_router():
        if "lora_blobs" not in state:
            raise RuntimeError("the full-width LoRA phase made no adapters")
        gc.collect()
        torch.cuda.empty_cache()
        phase_full_width_router(args, state["model"], state["lora_blobs"],
                                state["prompts"], report)

    def free_memory():
        # the 7B serving engine's weights and KV pool, and each training
        # phase's model, make room for the next phase
        for key in ("eng", "prompts", "streams", "model", "lora_blobs"):
            state.pop(key, None)
        gc.collect()
        torch.cuda.empty_cache()

    phases += [("full_width", full_width), ("http", http),
               ("full_width_spec", full_width_spec),
               ("full_width_kv", full_width_kv),
               ("full_width_lora", full_width_lora),
               ("full_width_router", full_width_router),
               ("train_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_train_cuda_vs_cpu(args.seed, report))),
               ("train_full_width",
                lambda: phase_train_full_width(args, report)),
               ("train_moe_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_train_moe_cuda_vs_cpu(args.seed, report))),
               ("train_moe_full_width",
                lambda: phase_train_moe_full_width(args, report)),
               ("tuning",
                lambda: (free_memory(), phase_tuning(args.seed, report)))]
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
