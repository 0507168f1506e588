#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--layers N] [--only PHASE,...]

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
 4. the LLaMA-2-7B geometry (SERVE_LAYERS = 8 of its 32 layers, hidden
    4096, 32 heads, bf16, random
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
    then the training recipe (``train_recipe_cuda_vs_cpu``: phase 6's
    model with AdamW under LinearWarmup -> CosineAnnealingDecay, remat
    save_dots, fp8 matmuls+head and a DeviceFeeder, 3 steps on CUDA and
    on the CPU: losses within 1e-3, lr sequences equal, a float16
    GradScaler run with the scale forced to 2^40 before step 4: scale
    sequences and skip flags equal, the skipped step moving no parameter,
    one projection's fp8 codes bit-equal between the devices;
    ``train_recipe_full_width``: phase 7's geometry, bf16 O2 with fp32
    masters, remat none, full, save_dots and offload_residuals at fp8
    none, then save_dots at fp8 matmuls and matmuls+head, 2 warm-up and
    4 timed steps each from the same weights through a DeviceFeeder:
    median step ms, tokens/s, MFU, peak memory, the forward and
    backward's own peak, device ms by kernel and launches per step;
    gates: finite falling losses, the first loss equal and the first
    gradient norm within 1e-5 across the remat policies, full's forward
    and backward peak below none's, the flash kernels every layer (the
    forward twice under remat), ce_stats/ce_bwd at fp8 none and matmuls
    but not at matmuls+head (torch._scaled_mm products instead), one fp8
    projection within the bf16 row rule of the fp32 product of its
    codes, fp8_amax_max finite and positive, the lr sequence the host
    scheduler's);
    then the Paddle eager API (``paddle_api_cuda_vs_cpu``: the tiny GPT of
    ``models.gpt`` at head_dim 64, its weights copied to a CPU twin through
    ``state_dict``: logits within 1e-4 of the largest |logit|, 3
    eager AdamW steps (``loss.backward(); opt.step(); opt.clear_grad()``)
    with losses within 1e-4 relative, parameters within lr (the key third
    of each qkv bias, whose gradient is zero but for rounding, within 6
    lr), every parameter with a gradient after step 1, flash forward and
    backward launches in the profiler's record of a CUDA step; then the
    Paddle-level ``F.scaled_dot_product_attention`` on views of a packed
    QKV projection and ``F.fused_linear_cross_entropy`` on ``Tensor``s,
    fp32 and bf16, bit-equal to the torch-level calls on the same storage,
    forward and backward; ``paddle_api_full_width``: GPT-2 small at
    ``GptConfig``'s defaults, batch 8 x 1024, random weights from --seed,
    AdamW, 2 warm-up and 8 timed eager steps in fp32 (TF32 off), then the
    same under ``amp.auto_cast(level="O1")`` (bf16): median step ms (wall,
    events, and the profiled step's device ms), tokens/s, MFU (over the
    fp32 peak, 67 TFLOP/s, for the fp32 run; over 989 bf16 for O1), peak
    memory, the device-busy share and the host gap; gates: finite falling
    losses, 12 flash forward, 12 dq and 12 dkv launches a step);
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

Since the disaggregation slice: ``disagg_cuda_vs_cpu`` (after phase 3:
phase 3's fp32 GQA model served mixed and through prefill workers in alias
and copy mode, 1 and 2 workers, the two chaos points, a cancel while a job
is pending, int8 pages in copy mode; streams equal to the CPU's and to the
CUDA mixed engine's, landed chain rows against both, flash forward
launches counted on the worker thread, and whether a packed frame's rows
for one segment are bit-equal alone and within the full frame);
``full_width_disagg`` (after the speculative serve: phase 4's engine and
prompts mixed, alias and copy; tokens/s, TTFT, handoffs and their ms, the
same independence check at 7B, copy against alias bytes for the same
frames, the worker's flash calls against their plain version, a decode
profile after the handoffs); ``full_width_router`` also serves through an
``HTTPReplica`` over a second engine's ``serve_http`` with heartbeats on
a native ``TCPStore`` (streams equal to a fresh engine's alone, the
endpoint killed mid-stream, ``dead_peers`` and the breaker naming it);
``lora_train_cuda_vs_cpu`` and ``lora_train_full_width`` (after phase 7:
a rank-8 adapter on the tiny model, CUDA against the CPU, the base
bit-unchanged; rank 16 at the 7B width, 3 layers, 2 + 4 steps, then the
exported adapter served with every grouped-matmul call held to its plain
version).

Since the fleet slice (hybrid parallelism, a process a rank on
``torch.distributed``): ``fleet_cuda_vs_cpu`` (4 gloo ranks on the card
against the same ranks on the CPU, phase 6's tiny model at dp 2 x mp 2
and mp 2 x sharding 2 with ZeRO-1 and ZeRO-2, 3 steps: losses and the
parameters gathered over mp by phase 6's rule, the CPU ranks against a
single-process step, every vocab-parallel ce_stats call against its plain
version; a world of one on nccl against the single-process step on the
card; two ranks on the card asking for nccl must raise) and
``fleet_full_width`` (phase 7's model at mp 2 x sharding 2, ZeRO-1, 4
gloo ranks time-sharing the card, 2 + 2 steps: per rank step ms, peak
memory, flash and CE launches, collective calls, bytes and host ms a step; the
first loss against the single-rank model's, every CE call against its
plain version). A rank that fails or outlives its group's timeout fails
the phase.

Since the pipeline slice (pp, a process a rank on p2p):
``pipeline_cuda_vs_cpu`` (4 gloo ranks on the card against the same
ranks on the CPU, phase 6's tiny model at 4 layers: 1F1B at pp 2 x mp 2
on a packed batch, ZB-H1 at pp 4 through fleet's ``PipelineLayer`` and
``train_batch``, VPP at pp 2 x V 2 x dp 2; losses and the parameters
gathered over pp and mp by phase 6's rule, every ce_stats call against
its plain version, ZB-H1's dW products all on W ticks) and
``pipeline_full_width`` (phase 7's model at 4 layers, pp 4, one layer a
stage, 4 microbatches of 1 x 4096 a step: 1F1B then ZB-H1 against the
single-rank model's first two losses and gradient norms; per rank step
ms, peak memory beside the schedule's peak activations, launches, p2p
calls, bytes and host ms a step; every CE call against its plain
version).

Since the ZeRO-3 slice (parameter sharding, a process a rank on gloo):
``zero3_cuda_vs_cpu`` (4 gloo ranks on the card against the same ranks
on the CPU, phase 6's tiny model at 4 layers: ``TrainStep(zero_stage=3)``
at sharding 4 'ahead' and 'start', dp 2 x sharding 2 and mp 2 x sharding
2, 1F1B and ZB-H1 with a zero axis at pp 2 x sharding 2, and
``group_sharded_parallel("p_g_os")``'s eager loop at dp 4; losses and
gathered parameters by phase 6's rule, every CE call against its plain
version, the shards 1/N of the units, no full buffer left after a step,
the gathered units' peak at 'ahead' and 'start') and
``zero3_full_width`` (phase 7's model at sharding 4, ZeRO-3, 4 gloo
ranks time-sharing the card: 'ahead' 2 + 1 steps and one for the peak
memory, 'start' one step, then ZeRO-2 at sharding 4 1 + 1 as the
memory yardstick: per rank step ms, peak memory per mode, resident
parameter bytes, launches, all-gather and reduce-scatter calls, bytes
and host ms a step; the first two losses and gradient norms against the
single-rank model's, every CE call against its plain version). ``--only
zero3_cuda_vs_cpu,zero3_full_width`` needs no earlier phase.

Since the MoE expert-parallel slice (ep > 1: each rank holds E/ep experts
and its own rows, tokens on the tiled all-to-all over gloo):
``moe_ep_cuda_vs_cpu`` (4 gloo ranks on the card against 4 on the CPU: a
tiny fp32 GPT-MoE with 8 experts and a shared expert, 3 steps at dp 2 x
ep 2 with ZeRO over dp and at ep 4, losses and the parameters gathered
over ep by phase 6's rule; an MoE layer at both layouts, dropless,
expert-choice, shared expert and capacity, outputs and gradients within
1e-4; the grouped and flash kernels launched) and ``moe_ep_full_width``
(GPT-MoE at its full width and depth, bf16, ep 4, 1 x 2048 a rank, 2 + 2
steps: the first two losses and gradient norms against the single-rank
model's, every grouped-matmul call of one step against its plain
version, the visit counts over the received layouts, per rank step ms,
peak memory, the all-to-alls' calls, bytes and host ms a step, launches
and expert counts; then gmm_fwd's and gmm_dw's event-timed ms a call on a
received layout beside the ep = 1 layout). ``--only
moe_ep_cuda_vs_cpu,moe_ep_full_width`` needs no earlier phase.

Since the sequence-parallel slice (sep > 1: each rank a contiguous
segment of the rows' sequence, attention across the segments by ring
attention on the flash kernels, K/V blocks hopping around the sep group
through gloo): the flash forward and backward cases gain split segments
(``split_seg_*``: a q stretch and an earlier k stretch of one packed row
with the keys' own segment ids, ``kv_segment_ids``, rows that see no key
among them, held to the plain versions: out 0, lse -inf, zero
gradients); ``sep_cuda_vs_cpu`` (4 gloo ranks on the card against 4 on
the CPU: phase 6's tiny fp32 model, 3 steps at sep 4, dp 2 x sep 2, sep
2 x mp 2 and a packed batch at sep 4, losses and gathered parameters by
phase 6's rule and the CPU ranks against a single-process step, every
ring block's flash call against its plain version, sep rank r launching
r + 1 of each flash kernel a layer a step) and ``sep_full_width``
(phase 7's model at sep 4, one 16,384-token row a step, 4,096 a rank, 2
+ 4 steps: the first two losses and gradient norms against the
single-rank model on the same 16,384 tokens, every CE call against its
plain version, per rank step ms, peak memory, launches, the flash
kernels' device ms in a profiled step and the ring's p2p calls, bytes
and host ms a step). ``--only sep_cuda_vs_cpu,sep_full_width`` needs no
earlier phase.

Since the checkpoint slice (elastic sharded checkpoints and self-healing
training): ``resilience_full_width`` (after ``train_full_width``) runs
phase 7's model at RESIL_LAYERS layer through ``run_resilient``: a NaN
learning rate at batch RESIL_NAN_AT rolled back to the last commit, the
third save killed before its COMMIT, a fresh step restored from the last
commit; the rollback, the final state and the restored run must repeat
the fault-free run bit for bit; it prints the snapshot's GB, the
caller-thread capture ms beside the step's ms, each save's host copy,
write, fsync and commit seconds and write GB/s, and the load seconds
(snapshots go to the git-ignored ``.ckpt_smoke/``, removed after). The
tiny 4-rank phases carry the sharded layouts (CUDA ranks, 2 steps, a
multi-rank save, 2 more; the resumed runs held to the phase's rule
against the target layout's uninterrupted run, every save read back
bit-equal to the ranks' gathered parameters): ``zero3_cuda_vs_cpu``
resumes a ZeRO-3 sharding-4 save at dp 4 and a dp 4 save at ZeRO-3, and
an mp 2 x dp 2 save at dp 4; ``pipeline_cuda_vs_cpu`` a pp 2 x dp 2 1F1B
save in ``TrainStep`` at dp 4 and the reverse. The whole script's seconds
are printed before the result lines.

Since the launcher slice (the launcher and the host plane):
``launch_full_width`` starts 4 gloo ranks on the card through ``python -m
paddle_tpu_torch.distributed.launch`` (this script with the hidden
``--launch-worker train``): ``init_parallel_env`` from the launch
contract, fleet at dp 2 x mp 2, phase 7's model at RANKS_LAYERS layers, 2
steps plain and 2 with ``strategy.recompute`` wrapping each decoder layer
in ``fleet.recompute``, from the same weights and rows (losses and
gradient norms against the plain run, flash_fwd twice a layer a step
under recompute, every flash call by its row rule and every CE call by
``_CeCalls``); a gradient shard of 86 MiB through ``multiproc``'s socket
ring against the numpy ring sum of the shards exchanged through the
store, beside gloo's all_reduce of the same bytes; rank 0's ``rpc_sync``
for rank 1's peak memory; every rank's elastic lease and rank 0's
``watch()``; the ranks' report through ``LocalFS``; then a launch of the
tiny model whose rank 3 exits 7 after a step while the others wait in
gloo: the launcher returns 7 and no rank it started is alive or on the
card. It prints the seconds from launch to every rank's first step, step
ms and peak GB a rank with and without recompute, the launches, the
ring's GB/s against gloo's, the rpc round trip and the teardown's
seconds. Since this slice the fleet, ZeRO-3 and sep full-width phases
run RANKS_LAYERS (2) layers, 3 before, for the script's time. ``--only
launch_full_width`` needs no earlier phase.

Since the semi-auto slice (``auto_parallel``, the tuner, ``io``,
``framework``): the training job of ``launch_full_width`` makes a third
run after the plain and recompute ones (``_auto_parallel_run``), and
``auto_parallel_full_width`` reads it: phase 7's model from the same
weights through ``shard_layer`` and ``dist.to_static(model, loader,
loss, opt, strategy)``, fed by a ``DataLoader`` over the same rows
through ``shard_dataloader``, AP_WARM steps held to the plain run's
losses and norms and AP_STEPS timed (every flash and CE call against its
plain version, the launches counted around the run); ``eval()`` and
``predict()`` equal on every rank; ``Engine.save`` -> ``Engine.load``
restoring parameters, moments and masters bit for bit; ``reshard``
s->r, r->s, p->r and s(0)->s(1) of a [4096, 4096] bf16 tensor against
the host's result; ``AutoTuner`` over phase 3's tiny model in the live
world (one history on every rank). ``--only
launch_full_width,auto_parallel_full_width`` runs both.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``; exits non-zero (and prints no
result) without CUDA, outside the repository, or when any phase fails.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
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
# the full-width serving phases' depth: 8 of the 7B geometry's 32 layers
# (32 until the sep slice's phases needed the script's time, then 16 until
# the launch slice's phase did)
SERVE_LAYERS = 8
TRAIN_LAYERS = 3           # full-width training: the 32-layer state
TRAIN_SEQ = 4096           # (about 108 GB) does not fit in 80 GB
# the 4-rank fleet, ZeRO-3 and sep full-width phases (TRAIN_LAYERS until
# the launch slice's phase needed the script's time)
RANKS_LAYERS = 2
TRAIN_LR = 1e-4
MOE_BATCH = 4              # GPT-MoE: 4 x 2048 tokens, 2 warm-up steps
MOE_STEPS = 8              # and 8 timed ones
PADDLE_LR = 3e-4           # the Paddle-API GPT-2 small phase's AdamW
PADDLE_BATCH = 8           # GPT-2 small: 8 x 1024 tokens a step
PADDLE_STEPS = 8           # timed steps (after 2 warm-up ones)
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
        # a ring attention block: a q stretch and an earlier k stretch of
        # one packed row, non-causal, each side with its own segment ids
        # (kv_segment_ids); 3192 query rows see no key of the stretch
        ("split_seg_s4096", dict(s=4096, hq=32, hkv=32, dtype=bf,
                                 causal=False, own_gen=True,
                                 **_split_segments(4096))),
        ("split_seg_gqa_s1000_fp32", dict(s=1000, hq=32, hkv=8,
                                          dtype=torch.float32, causal=False,
                                          own_gen=True,
                                          **_split_segments(1000))),
    ]


def _split_segments(s):
    """{seg, kv_seg} on the card: rows [s, 2s) (the queries) and [0, s)
    (the keys) of one packed row of 2s tokens holding documents [0, 0.73
    s), [0.73 s, 1.22 s) and [1.22 s, 2s): the queries of the third see no
    key, whole q tiles of them (the tile skip leaves them no K tile), and
    those of the second see the keys from 0.73 s on."""
    import torch

    row = torch.zeros(2 * s, dtype=torch.int32)
    row[int(0.73 * s):] = 1
    row[int(1.22 * s):] = 2
    return {"seg": row[s:][None].cuda(), "kv_seg": row[:s][None].cuda()}


def _seg_kwargs(seg, kv_seg):
    """The flash calls' segment keywords (``kv_segment_ids`` only where a
    case has it, so the cases run on a tree without it too)."""
    ids = {"segment_ids": seg}
    if kv_seg is not None:
        ids["kv_segment_ids"] = kv_seg
    return ids


def _lse_err(lse, ref):
    """max |lse - ref| over the rows that see a key; inf where a row sees
    no key on one side only (its lse must be -inf on both)."""
    import torch

    dead = torch.isneginf(ref)
    if not bool((torch.isneginf(lse) == dead).all()):
        return float("inf")
    return (lse - ref)[~dead].abs().max().item() if (~dead).any() else 0.0


def _masked_sdpa_mask(seg, kv_seg, causal, s, device):
    """SDPA's boolean mask of a packed case (query and key ids apart)."""
    import torch

    kv = seg if kv_seg is None else kv_seg
    mask = seg[:, None, :, None] == kv[:, None, None, :]
    if causal:
        mask = mask & torch.ones(s, s, dtype=torch.bool,
                                 device=device).tril()
    return mask


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
                   causal=True, kv_seg=None):
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
    ids = _seg_kwargs(seg, kv_seg)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, **ids)
    torch.cuda.synchronize()
    digest = _digest(out, lse)
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(),
                                                v.float(), causal=causal,
                                                **ids)
    dname = str(dtype).replace("torch.", "")
    cmp = _compare(out, ref, dname)
    lse_err = _lse_err(lse, ref_lse)
    dead_rows = int(torch.isneginf(ref_lse).sum().item())
    del ref, ref_lse
    call = lambda: fa.flash_attention_fwd(q, k, v,  # noqa: E731
                                          causal=causal, **ids)
    # the kernel's device time; call_ms adds the wrapper's host work
    ms = _kernel_ms(_device_ms_by_kernel(call), "flash_fwd_kernel")
    call_ms = _cuda_ms(call)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal, **ids), reps=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if seg is None:
        lib = lambda: tF.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=causal, enable_gqa=True)
        pairs = b * (s * (s + 1) // 2 if causal else s * s)
    else:
        mask = _masked_sdpa_mask(seg, kv_seg, causal, s, q.device)
        lib = lambda: tF.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
        pairs = int(mask.sum().item())
    library_ms = _cuda_ms(lib)
    item = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * item \
        + lse.numel() * 4 + sum(t.numel() * 4 for t in (seg, kv_seg)
                                if t is not None)
    flops = 4 * d * hq * pairs
    bound_ms, bound_by = _bound(nbytes, flops, dname)
    return dict(cmp, lse_err=lse_err, dead_rows=dead_rows, digest=digest,
                ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, tflops=flops / ms / 1e9,
                ok=cmp["ok"] and lse_err <= 1e-3)


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
        # a ring attention block's backward (the forward cases' split
        # segments): query rows that see no key carry lse -inf and get
        # zero dq, keys no query sees zero dk, dv
        ("split_seg_s4096", dict(s=4096, hq=32, hkv=32, dtype=bf,
                                 causal=False, own_gen=True,
                                 **_split_segments(4096))),
        ("split_seg_gqa_s1000_fp32", dict(s=1000, hq=32, hkv=8,
                                          dtype=torch.float32, causal=False,
                                          own_gen=True,
                                          **_split_segments(1000))),
    ]


def run_flash_bwd_case(gen, s, hq, hkv, dtype, seg=None, d=128, b=1,
                       causal=True, kv_seg=None):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    q = _rand(gen, (b, s, hq, d), dtype)
    k = _rand(gen, (b, s, hkv, d), dtype)
    v = _rand(gen, (b, s, hkv, d), dtype)
    do = _rand(gen, (b, s, hq, d), dtype)
    ids = _seg_kwargs(seg, kv_seg)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, **ids)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   **ids)
    torch.cuda.synchronize()
    digest = _digest(*grads)
    refs = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        causal=causal, **ids)
    dname = str(dtype).replace("torch.", "")
    cmp = {n: _compare(g, r, dname) for n, g, r in zip(("dq", "dk", "dv"),
                                                       grads, refs)}
    del grads, refs
    torch.cuda.empty_cache()
    call = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, causal=causal, **ids)
    ms = _cuda_ms(call)
    split = _device_ms_by_kernel(call)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, **ids), reps=3,
        warmup=1)
    torch.cuda.empty_cache()
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    if seg is None:
        kw = dict(is_causal=causal)
        pairs = b * (s * (s + 1) // 2 if causal else s * s)
    else:
        mask = _masked_sdpa_mask(seg, kv_seg, causal, s, q.device)
        kw = dict(attn_mask=mask)
        pairs = int(mask.sum().item())
    fwd = lambda: tF.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, enable_gqa=True, **kw)
    fwd_bwd = lambda: torch.autograd.grad(fwd(), (qh, kh, vh),  # noqa: E731
                                          doh)
    library_ms = _cuda_ms(fwd_bwd) - _cuda_ms(fwd)
    item = q.element_size()
    seg_bytes = sum(t.numel() * 4 for t in (seg, kv_seg) if t is not None)
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
            q, k, v, out, lse, do, causal=causal, **ids), reps=3,
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
    return dict(cmp=cmp, ok=ok, digest=digest, ms=ms, plain_ms=plain_ms,
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
        # own_gen cases (the split segments) leave the shared draws alone
        g, kw = _paged_gen(gen, seed, label, kw)
        flash[label] = r = run_flash_case(g, **kw)
        print(f"flash {label}: err {r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"row rel {r['max_rel_err']:.3g} (rtol {r['rtol']:.3g}) "
              f"lse_err {r['lse_err']:.3g} rows with no key "
              f"{r['dead_rows']} ms {r['ms']:.4f} (device; call "
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
        g, kw = _paged_gen(gen, seed, label, kw)
        bwd[label] = r = run_flash_bwd_case(g, **kw)
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


def _tiny_gqa_config():
    """Phase 3's model: 2 layers, hidden 512, 4 query heads on 2 kv heads,
    head_dim 128, vocab 1024."""
    from paddle_tpu_torch.models import llama_tiny_config

    return llama_tiny_config(vocab_size=1024, hidden_size=512,
                             intermediate_size=1024, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=512)


def phase_cuda_vs_cpu(seed, report):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _tiny_gqa_config()
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

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _tiny_gqa_config()
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
    per_position: the step's linear products on the [decode_batch, T >
    1, H] verify frame (not the prefills' [1, T, H] chunks) run one
    position at a time, each a GEMM of decode_batch rows as decode's are,
    so everything else of the frame (RoPE, the masked page writes, the
    paged kernel's T-query frame, the norms) is held to decode bit for
    bit. The products are the projections' ``nn.functional.linear`` (the
    port's AMP and fp8 seam) and the head's ``nn.Linear``."""
    import torch

    from paddle_tpu_torch.nn import functional as port_f

    seen = []
    linear, flinear = torch.nn.Linear.forward, port_f.linear

    def framed(x):
        return x.dim() == 3 and x.shape[0] == eng.decode_batch \
            and x.shape[1] > 1

    def by_position(self, x):
        if framed(x):
            return torch.cat([linear(self, x[:, i:i + 1])
                              for i in range(x.shape[1])], dim=1)
        return linear(self, x)

    def f_by_position(x, weight, bias=None):
        if framed(x):
            return torch.cat([flinear(x[:, i:i + 1], weight, bias)
                              for i in range(x.shape[1])], dim=1)
        return flinear(x, weight, bias)

    handle = eng.model.lm_head.register_forward_hook(
        lambda _m, _i, out: seen.append(out[:len(prompts), 0].float().cpu())
        if not seen else None)
    if per_position:
        torch.nn.Linear.forward = by_position
        port_f.linear = f_by_position
    eng.configure_speculation(spec_k=spec_k)
    try:
        rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        eng.step()
        for r in rids:
            eng.cancel(r)
            eng.release(r)
    finally:
        torch.nn.Linear.forward = linear
        port_f.linear = flinear
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
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = _tiny_gqa_config()
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


RECIPE_REMATS = ("none", "full", "save_dots", "offload_residuals")
RECIPE_RUNS = ([(r, "none") for r in RECIPE_REMATS]
               + [("save_dots", "matmuls"), ("save_dots", "matmuls+head")])
RECIPE_WARMUP, RECIPE_STEPS = 2, 4
# one fp8 projection against the fp32 product of its dequantized codes: the
# projection's output is bf16 in the model, so the bf16 per-row rule
FP8_ROW_RTOL = 2.0 ** -7


def _recipe_sched(lr_mod, peak, warmup, total):
    """LinearWarmup(warmup steps) -> CosineAnnealingDecay, as the recipe
    tests build it."""
    return lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(peak, T_max=total, eta_min=peak / 10),
        warmup_steps=warmup, start_lr=peak / 100, end_lr=peak)


def _fp8_codes(x, w, hist_x, hist_w):
    """(x codes, w codes) of one projection as uint8, by the delayed
    scales of the given histories."""
    import torch

    from paddle_tpu_torch.amp import fp8

    sx = fp8.delayed_scale(hist_x, fp8.E4M3_MAX)
    sw = fp8.delayed_scale(hist_w, fp8.E4M3_MAX)
    return (fp8.quantize(x, sx, fp8.E4M3_MAX, fp8.E4M3).view(torch.uint8),
            fp8.quantize(w, sw, fp8.E4M3_MAX, fp8.E4M3).view(torch.uint8))


def _fwd_bwd_peak_gb(model, batch, remat):
    """Device memory one forward and backward adds at its peak under the
    remat policy (the optimizer's update, whose temporaries no policy
    changes, left out)."""
    import torch

    from paddle_tpu_torch.parallel.scan_layers import layer_execution

    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    kw = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with layer_execution(remat):
        model(**kw).backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    model.zero_grad(set_to_none=True)
    return peak


def phase_train_recipe_cuda_vs_cpu(seed, report):
    """The recipe on phase 6's tiny fp32 LLaMA, on CUDA (the kernels, fp8
    products on torch._scaled_mm) and on the CPU (plain versions): AdamW
    under LinearWarmup -> CosineAnnealingDecay, remat save_dots, fp8
    matmuls+head, batches through a DeviceFeeder (pinned host memory and a
    side stream on CUDA), 3 steps: losses within 1e-3 relative, the lr
    sequence equal; then a float16 GradScaler run (O1 float16 with sdpa
    black-listed: the flash kernels take bf16 or fp32) over 6 steps with
    the scale forced to 2^40 before step 4: the scale sequence and the
    skip flags equal between the devices, the skipped step leaving the
    parameters bit-unchanged; the fp8 codes of layer 0's q_proj input and
    weight bit-equal between the devices."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.io import DeviceFeeder
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_mod
    from paddle_tpu_torch.parallel import TrainStep

    cfg = _tiny_gqa_config()
    batches = [_packed_batch(seed + i, cfg.vocab_size, 256, 2)
               for i in range(3)]
    base = LlamaForCausalLM(cfg, device="cpu", seed=seed).state_dict()
    out = {"recipe": {}, "scaler": {}}
    captured = {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(base)
        opt = AdamW(learning_rate=_recipe_sched(lr_mod, 1e-3, 1, 4),
                    parameters=model.parameters(), weight_decay=0.01)
        step = TrainStep(model, _fused_loss, opt, remat="save_dots",
                         fp8_policy="matmuls+head", collect_metrics=True)
        q = model.llama.layers[0].self_attn.q_proj
        hook = q.register_forward_pre_hook(
            lambda mod, args, dev=dev: (captured.setdefault(
                dev, args[0].detach().float().cpu()), None)[1])
        losses, lrs = [], []
        with DeviceFeeder(iter(batches), device=dev, depth=2) as feeder:
            for b in feeder:
                lrs.append(opt.get_lr())
                losses.append(float(step(b)))
                opt._lr.step()
        hook.remove()
        out["recipe"][dev] = {"losses": losses, "lrs": lrs,
                              "metrics": step.last_metrics()}
        if dev == "cpu":
            st0 = step.fp8_state_dict()["states"][0]
        # the float16 GradScaler run, from the same weights
        model.load_state_dict(base)
        sc = amp.GradScaler(init_loss_scaling=2.0 ** 15,
                            incr_every_n_steps=2, decr_ratio=2.0 ** -25)
        step = TrainStep(model, _fused_loss,
                         AdamW(learning_rate=1e-3,
                               parameters=model.parameters()),
                         grad_scaler=sc, collect_metrics=True)
        scales, skips, unchanged = [], [], None
        for i in range(6):
            if i == 3:
                sc._scale = 2.0 ** 40
                before = [p.detach().clone() for p in model.parameters()]
            with amp.auto_cast(level="O1", dtype="float16",
                               custom_black_list=["sdpa"]):
                step(_packed_batch(seed + 10 + i, cfg.vocab_size, 256, 2))
            scales.append(sc._scale)
            skips.append(step.last_metrics()["skipped"])
            if i == 3:
                unchanged = all(torch.equal(p.detach(), b) for p, b in
                                zip(model.parameters(), before))
        out["scaler"][dev] = {"scales": scales, "skipped": skips,
                              "skipped_step_unchanged": unchanged}
        del model, opt, step
    # the codes of one projection's x and w, on each device from the same
    # fp32 values and histories
    w = base["llama.layers.0.self_attn.q_proj.weight"]
    hx, hw = (torch.from_numpy(st0[k]) for k in ("x", "w"))
    codes = {dev: [c.cpu() for c in _fp8_codes(
        captured["cpu"].to(dev), w.to(dev), hx.to(dev), hw.to(dev))]
        for dev in ("cpu", "cuda")}
    out["fp8_codes_equal"] = {
        "x": bool(torch.equal(codes["cpu"][0], codes["cuda"][0])),
        "w": bool(torch.equal(codes["cpu"][1], codes["cuda"][1]))}
    rc, rg = out["recipe"]["cpu"], out["recipe"]["cuda"]
    out["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                              zip(rg["losses"], rc["losses"]))
    report["train_recipe_cuda_vs_cpu"] = out
    print("train recipe cuda vs cpu: " + json.dumps(out), flush=True)
    sg, scpu = out["scaler"]["cuda"], out["scaler"]["cpu"]
    if not out["loss_rel_err"] <= 1e-3:
        raise AssertionError("CUDA and CPU recipe losses differ")
    if rg["lrs"] != rc["lrs"]:
        raise AssertionError("the lr sequences differ")
    if sg["scales"] != scpu["scales"] or sg["skipped"] != scpu["skipped"] \
            or sg["skipped"][3] != 1.0 or sum(sg["skipped"]) != 1.0:
        raise AssertionError("GradScaler sequences differ or no skip")
    if not (sg["skipped_step_unchanged"] and scpu["skipped_step_unchanged"]):
        raise AssertionError("the skipped step moved the parameters")
    if not all(out["fp8_codes_equal"].values()):
        raise AssertionError("fp8 codes differ between the devices")


def _fp8_projection_check(model):
    """One fp8 projection on the card (layer 0's q_proj on a bf16 x at the
    recipe's width) against an fp32 product of the same dequantized codes
    (TF32 off), per row; returns (max row error, within FP8_ROW_RTOL: the
    bf16 rule, the projection's output being bf16 in the model)."""
    import torch

    from paddle_tpu_torch.amp import fp8

    w = model.llama.layers[0].self_attn.q_proj.weight.detach()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    x = torch.randn((TRAIN_SEQ, w.shape[1]), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    sx, sw = fp8.current_scale(x, fp8.E4M3_MAX), \
        fp8.current_scale(w, fp8.E4M3_MAX)
    qx = fp8.quantize(x, sx, fp8.E4M3_MAX, fp8.E4M3)
    qw = fp8.quantize(w, sw, fp8.E4M3_MAX, fp8.E4M3)
    got = fp8.mm_codes(qx, sx, qw, sw)
    ref = (qx.float() / sx) @ (qw.float() / sw).T
    return _row_rule(got, ref, FP8_ROW_RTOL)


def phase_train_recipe_full_width(args, report):
    """The recipe at phase 7's geometry (7B width, 3 layers, seq 4096),
    bf16 O2 with fp32 masters (``amp.decorate``), AdamW under
    LinearWarmup(2) -> CosineAnnealingDecay, batches through a
    DeviceFeeder from pinned memory: remat none, full, save_dots and
    offload_residuals at fp8 none, then save_dots at fp8 matmuls and
    matmuls+head, each run from the same weights, 2 warm-up and 4 timed
    steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import fp8
    from paddle_tpu_torch.io import DeviceFeeder
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_mod
    from paddle_tpu_torch.parallel import TrainStep

    cfg = llama_7b_config(num_hidden_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=args.seed)
    amp.decorate(model, level="O2")                # fp32 -> bf16 in place
    base = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(args.seed)
    ids = rng.randint(1, cfg.vocab_size, (1, TRAIN_SEQ + 1))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    d = cfg.hidden_size // cfg.num_attention_heads
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    matmul_params = n_params - cfg.vocab_size * cfg.hidden_size
    flops = (6 * matmul_params * TRAIN_SEQ
             + cfg.num_hidden_layers * 3.5 * 4 * d
             * cfg.num_attention_heads * pairs)
    n_steps = RECIPE_WARMUP + RECIPE_STEPS
    torch.cuda.synchronize()
    out = {"layers": cfg.num_hidden_layers, "params": n_params,
           "seq": TRAIN_SEQ, "setup_s": time.perf_counter() - t0,
           "flops_per_step": flops, "runs": {}}
    launches_all = {}
    for remat, policy in RECIPE_RUNS:
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(base[k])
        opt = AdamW(learning_rate=_recipe_sched(lr_mod, TRAIN_LR, 2,
                                                n_steps),
                    parameters=model.parameters(), weight_decay=0.01)
        amp.decorate(model, opt, level="O2")       # fp32 master weights
        host = _recipe_sched(lr_mod, TRAIN_LR, 2, n_steps)
        step = TrainStep(model, _fused_loss, opt, remat=remat,
                         fp8_policy=policy, collect_metrics=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, lrs, host_lrs, times, metrics = [], [], [], [], []
        with DeviceFeeder(iter([batch] * n_steps), device="cuda",
                          depth=2) as feeder:
            for i, b in enumerate(feeder):
                if i == RECIPE_WARMUP:
                    torch.cuda.synchronize()
                    port_cuda.reset_launch_counts()   # the path starts here
                    fp8.reset_launches()
                lrs.append(opt.get_lr())
                host_lrs.append(host())
                t1 = time.perf_counter()
                loss = step(b)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                losses.append(float(loss))
                metrics.append(step.last_metrics())
                opt._lr.step()
                host.step()
        launches = port_cuda.launch_counts()          # ... and ends here
        scaled_mm = fp8.LAUNCHES["scaled_mm"]
        for k, n in launches.items():
            launches_all[k] = launches_all.get(k, 0) + n
        step_s = statistics.median(times[RECIPE_WARMUP:])
        run = {"remat": remat, "fp8_policy": policy, "losses": losses,
               "lrs": lrs, "host_lrs": host_lrs,
               "step_ms": [t * 1e3 for t in times],
               "median_step_ms": step_s * 1e3,
               "tokens_per_s": TRAIN_SEQ / step_s,
               "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches_per_step": {k: n / RECIPE_STEPS
                                     for k, n in launches.items() if n},
               "scaled_mm_per_step": scaled_mm / RECIPE_STEPS,
               "first_grad_norm": metrics[0]["grad_norm"],
               "fp8_amax_max": metrics[-1].get("fp8_amax_max"),
               "skipped": [m["skipped"] for m in metrics]}
        prof = _device_profile(lambda: step(batch), 1, top=12)
        run["device_ms_by_kernel"] = prof["port_kernel_ms_per_step"]
        run["profile"] = {k: prof[k] for k in
                          ("wall_ms_per_step", "device_ms_per_step",
                           "device_busy_share", "top_device_ms")}
        if policy == "matmuls":
            run["fp8_projection_row_err"], run["fp8_projection_ok"] = \
                _fp8_projection_check(model)
        if policy == "none":
            run["fwd_bwd_peak_gb"] = _fwd_bwd_peak_gb(model, batch, remat)
        label = f"{remat}/{policy}"
        out["runs"][label] = run
        print(f"train recipe {label}: " + json.dumps(
            {k: v for k, v in run.items() if k not in ("profile",)}),
            flush=True)
        del step, opt
    out["launches"] = launches_all
    report["train_recipe_full_width"] = out
    runs = out["runs"]
    ref = runs["none/none"]
    layers = cfg.num_hidden_layers
    bad = []
    for label, run in runs.items():
        ls = run["losses"]
        if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            bad.append(f"{label}: losses {ls}")
        if run["lrs"] != run["host_lrs"]:
            bad.append(f"{label}: lr {run['lrs']} vs {run['host_lrs']}")
        lp = run["launches_per_step"]
        fwd = 2 * layers if run["remat"] != "none" else layers
        for k, n in (("flash_fwd", fwd), ("flash_bwd_dq", layers),
                     ("flash_bwd_dkv", layers)):
            if lp.get(k, 0) < n:
                bad.append(f"{label}: {k} {lp.get(k, 0)} a step < {n}")
        if run["fp8_policy"] == "matmuls+head":
            if lp.get("ce_stats") or lp.get("ce_bwd") \
                    or not run["scaled_mm_per_step"]:
                bad.append(f"{label}: the head did not take _scaled_mm")
        elif lp.get("ce_stats", 0) < 1 or lp.get("ce_bwd", 0) < 1:
            bad.append(f"{label}: ce_stats/ce_bwd not launched")
        if run["fp8_policy"] != "none":
            amax = run["fp8_amax_max"]
            if not (amax is not None and math.isfinite(amax) and amax > 0):
                bad.append(f"{label}: fp8_amax_max {amax}")
            if not run["scaled_mm_per_step"]:
                bad.append(f"{label}: no _scaled_mm product")
        if run["fp8_policy"] == "none":
            if run["losses"][0] != ref["losses"][0]:
                bad.append(f"{label}: first loss {run['losses'][0]} vs "
                           f"{ref['losses'][0]}")
            rel = abs(run["first_grad_norm"] - ref["first_grad_norm"]) \
                / ref["first_grad_norm"]
            if rel > 1e-5:
                bad.append(f"{label}: first grad norm rel err {rel}")
    if not runs["full/none"]["fwd_bwd_peak_gb"] < ref["fwd_bwd_peak_gb"]:
        bad.append("the forward and backward's peak memory under full is "
                   "not below none's")
    if not runs["save_dots/matmuls"].get("fp8_projection_ok"):
        bad.append("the fp8 projection is off the fp32 product of its codes")
    if bad:
        raise AssertionError("; ".join(bad))


def _kernel_launches(fn):
    """{kernel name: launches} of one call of `fn`, from the profiler. Late
    in a long process the profiler loses the first kernels of a window
    (the full-width GPT-2 profile misses about 2 of its 12 forwards), so
    the window opens with 512 one-element fills before `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(512):
            pad.fill_(1.0)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _paddle_gpt_steps(model, opt, ids, steps):
    """`steps` eager steps of the Paddle API: loss.backward(); opt.step();
    opt.clear_grad(). Returns the losses and, after the first backward,
    the names of the parameters without a gradient."""
    losses, no_grad = [], None
    for _ in range(steps):
        loss = model(ids, ids)
        loss.backward()
        if no_grad is None:
            no_grad = [n for n, p in model.named_parameters()
                       if p.grad is None]
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, no_grad


def _paddle_bitwise_cases(seed):
    """Paddle-level F.scaled_dot_product_attention (on views of a packed
    QKV projection, as GPT calls it) and F.fused_linear_cross_entropy on
    Tensors against the torch-level calls on the same storage, fp32 and
    bf16: outputs and gradients must be bit-equal."""
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    b, s, h, d, vocab, hidden = 2, 1024, 12, 64, 50304, 768
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        packed = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda",
                             dtype=dtype)
        dout = torch.randn(b, s, h, d, generator=gen, device="cuda",
                           dtype=dtype)

        def attn(t, chunk, reshape):
            q, k, v = (reshape(x) for x in chunk(t))
            return q, k, v

        tp = packed.detach().requires_grad_()
        q, k, v = attn(tp, lambda t: t.chunk(3, dim=-1),
                       lambda x: x.reshape(b, s, h, d))
        strides = [list(x.stride()) for x in (q, k, v)]
        ref = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        ref.backward(dout)
        pp = paddle.Tensor(packed.detach(), stop_gradient=False)
        q, k, v = attn(pp, lambda t: t.chunk(3, axis=-1),
                       lambda x: x.reshape([b, s, h, d]))
        got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        got.backward(paddle.Tensor(dout))
        sdpa_ok = (torch.equal(got._value, ref)
                   and torch.equal(pp.grad._value, tp.grad))

        x = torch.randn(b * s, hidden, generator=gen, device="cuda",
                        dtype=dtype)
        w = (torch.randn(vocab, hidden, generator=gen, device="cuda",
                         dtype=torch.float32) * 0.02).to(dtype)
        lab = torch.randint(0, vocab, (b * s,), generator=gen, device="cuda")
        tx, tw = x.detach().requires_grad_(), w.detach().requires_grad_()
        ref_ce = F.fused_linear_cross_entropy(tx, tw, lab)
        ref_ce.backward()
        px = paddle.Tensor(x.detach(), stop_gradient=False)
        pw = paddle.Tensor(w.detach().t(), stop_gradient=False)  # [H, V]
        got_ce = F.fused_linear_cross_entropy(px, pw, paddle.Tensor(lab))
        got_ce.backward()
        ce_ok = (torch.equal(got_ce._value, ref_ce)
                 and torch.equal(px.grad._value, tx.grad)
                 and torch.equal(pw.grad._value.t(), tw.grad))
        out[name] = {"sdpa_bit_equal": sdpa_ok, "qkv_view_strides": strides,
                     "fused_ce_bit_equal": ce_ok,
                     "fused_ce_loss": ref_ce.item()}
    return out


def phase_paddle_api_cuda_vs_cpu(seed, report):
    """The Paddle eager API's tiny GPT (head_dim 64) on the card against
    its CPU twin (same weights, copied through state_dict): logits, then 3
    eager AdamW steps; the flash kernels must run on the card; then the
    Paddle-level attention and fused CE against the torch-level calls, bit
    for bit."""
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import GptForCausalLM, gpt_tiny_config
    from paddle_tpu_torch.ops import cuda as port_cuda

    cfg = gpt_tiny_config(hidden_size=256, num_attention_heads=4,
                          intermediate_size=1024,
                          max_position_embeddings=256)
    lr = 1e-3
    rng = np.random.RandomState(seed)
    ids_np = rng.randint(0, cfg.vocab_size, (2, 128)).astype(np.int64)
    models, ids, logits, losses, no_grad = {}, {}, {}, {}, {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        paddle.seed(seed)
        models[dev] = GptForCausalLM(cfg)
        ids[dev] = paddle.to_tensor(ids_np)
    paddle.set_device("gpu")
    models["gpu"].set_state_dict(models["cpu"].state_dict())
    for dev, model in models.items():
        with paddle.no_grad():
            logits[dev] = model(ids[dev]).numpy()
        opt = paddle.optimizer.AdamW(learning_rate=lr,
                                     parameters=model.parameters(),
                                     weight_decay=0.01)
        port_cuda.reset_launch_counts()       # the CUDA run's path starts
        losses[dev], no_grad[dev] = _paddle_gpt_steps(model, opt, ids[dev],
                                                      3)
    counted = port_cuda.launch_counts()       # ... and ends here

    def fwd_bwd():            # moves no weight: no optimizer step
        model = models["gpu"]
        model(ids["gpu"], ids["gpu"]).backward()
        model.clear_gradients()

    for windows in range(1, 4):   # the profiler can lose a window's events
        launches = _kernel_launches(fwd_bwd)
        flash = {k: n for k, n in launches.items() if "flash_" in k}
        fwd = sum(n for k, n in flash.items() if "flash_fwd" in k)
        bwd = sum(n for k, n in flash.items() if "flash_bwd" in k)
        if fwd and bwd:
            break
    cpu_p = {n: p.numpy() for n, p in models["cpu"].named_parameters()}
    # the key third of each qkv bias has a zero gradient (softmax is
    # invariant to a shift shared by all keys): its computed gradient is
    # rounding noise whose sign Adam turns into +-lr, so it is held apart
    h = cfg.hidden_size
    worst_p, key_bias = 0.0, 0.0
    for n, p in models["gpu"].named_parameters():
        diff = np.abs(p.numpy() - cpu_p[n])
        if n.endswith("qkv.bias"):
            key_bias = max(key_bias, float(diff[h:2 * h].max()))
            diff = np.concatenate([diff[:h], diff[2 * h:]])
        worst_p = max(worst_p, float(diff.max()))
    logit_err = float(np.abs(logits["gpu"] - logits["cpu"]).max()
                      / np.abs(logits["cpu"]).max())
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["gpu"], losses["cpu"]))
    out = {"config": dataclasses.asdict(cfg), "lr": lr,
           "losses": losses, "loss_rel_err": loss_rel,
           "logit_rel_err": logit_err, "param_max_abs_err": worst_p,
           "key_bias_max_abs_err": key_bias,
           "params_without_grad_after_step1": no_grad,
           "step_launches": {k: n for k, n in counted.items() if n},
           "profiled_fwd_bwd_flash_launches": flash,
           "profiler_windows": windows,
           "tolerance": {"loss_rel": 1e-4, "logit_rel": 1e-4,
                         "param": lr, "key_bias": 6 * lr}}
    out["bitwise"] = _paddle_bitwise_cases(seed)
    report["paddle_api_cuda_vs_cpu"] = out
    print("paddle_api_cuda_vs_cpu: " + json.dumps(out), flush=True)
    bad = []
    if not (loss_rel <= 1e-4 and logit_err <= 1e-4 and worst_p <= lr
            and key_bias <= 6 * lr):
        bad.append("CUDA and CPU differ")
    if no_grad["gpu"] or no_grad["cpu"]:
        bad.append("parameters without a gradient after step 1")
    if not (fwd > 0 and bwd > 0 and all(
            counted[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"))):
        bad.append(f"flash kernels not launched: {flash}, {counted}")
    for name, case in out["bitwise"].items():
        if not (case["sdpa_bit_equal"] and case["fused_ce_bit_equal"]):
            bad.append(f"{name}: Paddle-level and torch-level calls differ")
    if bad:
        raise AssertionError("; ".join(bad))


def _paddle_full_width_run(args, label, amp_level):
    """GPT-2 small from --seed: 2 warm-up and PADDLE_STEPS timed eager
    AdamW steps on one fixed batch, then one profiled step."""
    import contextlib

    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import GptConfig, GptForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda

    cfg = GptConfig()
    paddle.set_device("gpu")
    paddle.seed(args.seed)
    t0 = time.perf_counter()
    model = GptForCausalLM(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=PADDLE_LR,
                                 parameters=model.parameters(),
                                 weight_decay=0.01)
    rng = np.random.RandomState(args.seed)
    seq = cfg.max_position_embeddings
    ids = paddle.to_tensor(rng.randint(0, cfg.vocab_size,
                                       (PADDLE_BATCH, seq)).astype(np.int64))
    def ctx():
        return (paddle.amp.auto_cast(level=amp_level) if amp_level
                else contextlib.nullcontext())

    n_params = sum(p.size for p in model.parameters())
    tokens = PADDLE_BATCH * seq
    # 6 N T for the matmul weights (the two embedding gathers are none);
    # causal attention: 4 D a visible (query, key) pair and head forward,
    # 2.5 times that backward; the loss sees seq - 1 positions a row
    d = cfg.hidden_size // cfg.num_attention_heads
    pairs = seq * (seq + 1) // 2
    matmul_params = n_params - (cfg.vocab_size
                                + cfg.max_position_embeddings) * \
        cfg.hidden_size
    flops = (6 * matmul_params * tokens
             + cfg.num_hidden_layers * 3.5 * 4 * d * cfg.num_attention_heads
             * pairs * PADDLE_BATCH)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def one_step():
        with ctx():
            loss = model(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses = [float(one_step()) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port_cuda.reset_launch_counts()          # the Paddle API path starts
    times, dev_ms = [], []
    for _ in range(PADDLE_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1 = time.perf_counter()
        e0.record()
        loss = one_step()
        e1.record()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        dev_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    launches = port_cuda.launch_counts()     # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(times)
    peak_name = "bfloat16" if amp_level else "float32"
    out = {"label": label, "amp": amp_level or "fp32 (TF32 off)",
           "params": n_params, "batch": PADDLE_BATCH, "seq": seq,
           "setup_s": setup_s, "losses": losses,
           "step_ms": [t * 1e3 for t in times],
           "median_step_ms": step_s * 1e3,
           "median_event_ms": statistics.median(dev_ms),
           "tokens_per_s": tokens / step_s, "flops_per_step": flops,
           "mfu": flops / step_s / PEAK_FLOPS[peak_name],
           "mfu_peak": f"{peak_name} {PEAK_FLOPS[peak_name] / 1e12:g} "
                       f"TFLOP/s",
           "peak_mem_gb": peak, "launches": launches,
           "launches_per_step": {k: n / PADDLE_STEPS
                                 for k, n in launches.items() if n}}
    prof = _device_profile(one_step, 1, top=12)
    out["profile"] = prof
    if prof["device_ms_per_step"]:
        out["host_gap_ms"] = (prof["wall_ms_per_step"]
                              - prof["device_ms_per_step"])
    print(f"{label}: " + json.dumps(
        {k: v for k, v in out.items() if k != "profile"}), flush=True)
    print(f"{label} profile: " + json.dumps(prof), flush=True)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_paddle_api_full_width(args, report):
    """GPT-2 small (GptConfig defaults, about 163M parameters with the
    untied head) on the Paddle eager API, batch 8 x 1024, fp32 (TF32 off)
    then bf16 under auto_cast O1: each step 12 flash forward, 12 dq and
    12 dkv launches, losses finite and falling."""
    runs = {"fp32": _paddle_full_width_run(args, "paddle_gpt2_fp32", None),
            "bf16_o1": _paddle_full_width_run(args, "paddle_gpt2_bf16_o1",
                                              "O1")}
    launches = {}
    for r in runs.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    report["paddle_api_full_width"] = {"runs": runs, "launches": launches}
    bad = []
    layers = 12
    for name, r in runs.items():
        losses = r["losses"]
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"{name}: non-finite loss {losses}")
        elif not (losses[-1] < losses[0]
                  and max(losses[-3:]) < losses[0]):
            bad.append(f"{name}: the loss did not fall {losses}")
        per = r["launches_per_step"]
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if per.get(k) != layers:
                bad.append(f"{name}: {k} {per.get(k)} a step, not {layers}")
    if bad:
        raise AssertionError("; ".join(bad))


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
                                         LlamaForCausalLM)
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
        cfg = _tiny_gqa_config()
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
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import InProcessReplica, Router, \
        RouterConfig

    cfg = _tiny_gqa_config()
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
    series. The launches are read around the first routed serve.
    Before that, the same two engines serve behind an HTTPReplica
    (`_http_replica_router`)."""
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
    engines = []
    for i in range(2):
        store = AdapterStore(model, rank=LORA_RANK, slots=LORA_SLOTS)
        for aid, blob in blobs.items():
            store.register(aid, blob)
        eng = ServingEngine(model, _engine_cfg(
            page_size=16, decode_batch=8, prefill_chunk=256,
            max_seq_len=4096, hbm_budget_mb=8192), adapter_store=store,
            device="cuda")
        eng.generate([prompts[0]], max_new_tokens=2, adapter="ten-a")
        engines.append(eng)
    http_part = _http_replica_router(engines, prompts)
    reps = [InProcessReplica(eng, replica_id=i)
            for i, eng in enumerate(engines)]
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
                         in metrics and "router_replica_circuit" in metrics),
        http=http_part)
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
    problems += http_part["problems"]
    if problems:
        raise AssertionError("; ".join(problems))


HB_INTERVAL_S = 0.1        # heartbeats of the HTTP replica fleet
DEAD_TIMEOUT_S = 1.0       # the router's verdict on a stale heartbeat


def _http_replica_router(engines, prompts):
    """Replica 0 is an InProcessReplica over engines[0]; replica 1 is an
    HTTPReplica over engines[1]'s serve_http endpoint (the stand-in for a
    serving process, which beats its own RankHeartbeat); both beat into a
    TCPStore the Router reads (store=, heartbeat liveness). Phase 4's 8
    prompts, base, LORA_NEW_TOKENS new tokens: first routed one at a time
    (each prompt new to the engine that serves it), each stream equal to a
    fresh engine of the same settings serving the request alone; then all
    at once with the HTTP endpoint killed mid-stream (its driver dies, so
    open streams end with an error event, its heartbeat stops without the
    clean-exit tombstone, its listener closes): every request complete
    with exactly LORA_NEW_TOKENS tokens (none lost, none doubled),
    dead_peers names replica 1, and the breaker opens by that name on the
    stale heartbeat (the probe threshold is 99, so the probes cannot trip
    it). Returns the record, its launches and the problems found."""
    import threading

    import torch

    from paddle_tpu_torch.distributed.store import (RankHeartbeat, TCPStore,
                                                    dead_peers)
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import InProcessReplica, Router, \
        RouterConfig, ServingEngine
    from paddle_tpu_torch.serving.replica import HTTPReplica

    ref = ServingEngine(engines[0].model, _engine_cfg(
        page_size=16, decode_batch=8, prefill_chunk=256, max_seq_len=4096,
        hbm_budget_mb=4096), device="cuda")
    alone = [ref.generate([p], max_new_tokens=LORA_NEW_TOKENS)[0]
             for p in prompts]
    del ref
    store = TCPStore(is_master=True, timeout=60.0)
    rep0 = InProcessReplica(engines[0], replica_id=0, store=store,
                            heartbeat_interval_s=HB_INTERVAL_S)
    srv = engines[1].serve_http(0, block=False)
    beat1 = RankHeartbeat(store, "serving-fleet", 1,
                          interval_s=HB_INTERVAL_S)
    rep1 = HTTPReplica("127.0.0.1", srv.server_address[1], replica_id=1,
                       timeout_s=60.0, stream_timeout_s=300.0)
    router = Router([rep0, rep1], RouterConfig(
        placement="session", probe_interval_s=0.05, failure_threshold=99,
        breaker_cooldown_s=300.0, dispatch_attempts=3, gap_timeout_s=120.0,
        max_inflight=64, shed_queue_depth=10_000, backoff_initial_s=0.01,
        backoff_max_s=0.05), store=store, dead_timeout_s=DEAD_TIMEOUT_S)
    payloads = [{"prompt_ids": p.tolist(), "max_new_tokens": LORA_NEW_TOKENS,
                 "session": f"h{i}"} for i, p in enumerate(prompts)]
    killed = threading.Event()
    try:
        torch.cuda.synchronize()
        port_cuda.reset_launch_counts()      # the routed path starts here
        one_by_one = [router.generate(pl) for pl in payloads]
        torch.cuda.synchronize()
        launches = port_cuda.launch_counts()  # ... and ends here
        served_by = [t.get("replica") for _, t in one_by_one]

        def killer():
            eng1 = engines[1]
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if any(len(r.generated) >= 2
                       for r in list(eng1.scheduler.running)):
                    break
                time.sleep(0.002)

            def died(*_a, **_k):
                raise RuntimeError("serving process killed")

            eng1.step = died                 # the driver's next step dies
            beat1.stop(mark_clean=False)     # ... and so does its beat
            killed.set()

        kt = threading.Thread(target=killer)
        kt.start()
        t_kill = time.monotonic()
        burst = _route_all(router, payloads)
        kt.join(timeout=180)
        engines[1].shutdown_http()           # the listener goes too
        opened, cause = False, None
        while time.monotonic() - t_kill < 60.0:
            rec = router.stats()["replicas"]["1"]
            if rec["circuit"] == "open":
                opened, cause = True, rec["last_cause"]
                break
            time.sleep(0.05)
        dead = dead_peers(store, "serving-fleet", 2,
                          timeout_s=DEAD_TIMEOUT_S)
    finally:
        router.close()
        rep0.close()
        engines[1].__dict__.pop("step", None)
        engines[1].shutdown_http()
        if not beat1._stop.is_set():
            beat1.stop()
        native = store.native
        store.close()
    # the killed endpoint's open requests were cancelled and released by
    # their streams' teardown
    left = len(engines[1].scheduler._by_rid)
    out = dict(
        native_store=native, launches=launches, served_by=served_by,
        one_by_one_equal_alone=[s == a for (s, _), a in zip(one_by_one,
                                                            alone)],
        killed=killed.is_set(),
        burst_done=[bool(t and t.get("done")) for _, t in burst],
        burst_tokens=[len(s) for s, _ in burst],
        failovers=sum((t or {}).get("failovers", 0) for _, t in burst),
        burst_served_by=[(t or {}).get("replica") for _, t in burst],
        agreement_burst_vs_alone=_agreement([s for s, _ in burst], alone),
        breaker_opened=opened, breaker_cause=cause, dead_peers=dead,
        killed_engine_requests_left=left)
    problems = []
    if not native:
        problems.append("the store is not the native one")
    if not all(out["one_by_one_equal_alone"]):
        problems.append(f"routed streams differ from the engine's own: "
                        f"{out['one_by_one_equal_alone']}")
    if 1 not in served_by:
        problems.append(f"the HTTP replica served nothing: {served_by}")
    if not (out["killed"] and all(out["burst_done"])
            and all(n == LORA_NEW_TOKENS for n in out["burst_tokens"])):
        problems.append(f"the HTTP kill lost or cut a request: "
                        f"{out['burst_done']} {out['burst_tokens']}")
    if not out["failovers"]:
        problems.append("no request failed over from the killed endpoint")
    if not (opened and cause and "heartbeat stale" in cause):
        problems.append(f"the breaker did not open on the heartbeat: "
                        f"{opened} {cause}")
    if [d["rank"] for d in dead] != [1]:
        problems.append(f"dead_peers: {dead}")
    out["problems"] = problems
    print("full width router over HTTP: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}, default=str),
        flush=True)
    return out


# ---------------------------------------------------------------------------
# disaggregated prefill/decode (the KV-page handoff)
# ---------------------------------------------------------------------------
WORKER_THREAD = "paddle_tpu_torch.serving.prefill"
DISAGG_TIMEOUT_S = 30.0    # handoff patience of the fault-free runs
CHAOS_TIMEOUT_S = 0.5      # ... of the drop and cancel runs


def _chain_rows(cache, chain, n):
    """{pool: CPU tensor [L, Hkv, n(, D)]}: a chain's first n slots of
    every pool (fp8 codes as their bytes)."""
    from paddle_tpu_torch.quantization import raw_bytes

    out = {}
    for name, a in cache.items():
        t = raw_bytes(a)[:, :, list(chain)]
        out[name] = t.reshape(t.shape[0], t.shape[1], -1,
                              *t.shape[4:])[:, :, :n].cpu()
    return out


def _first_diff(a, b):
    """None when two chain-row dicts are bit-equal, else the first
    differing byte: its pool, byte offset, element index and both
    elements' values."""
    import numpy as np
    import torch

    for name in a:
        x, y = a[name].contiguous(), b[name].contiguous()
        xb = x.view(-1).view(torch.uint8)
        yb = y.view(-1).view(torch.uint8)
        ne = (xb != yb).nonzero()
        if ne.numel():
            byte = int(ne[0])
            elem = byte // x.element_size()
            idx = tuple(int(i) for i in np.unravel_index(elem, x.shape))
            return {"pool": name, "byte": byte, "element": idx,
                    "dtype": str(x.dtype).replace("torch.", ""),
                    "values": [float(x[idx].float()), float(y[idx].float())],
                    "bytes_differing": int(ne.numel())}
    return None


def _instrument(eng):
    """Install, once, two probes on an engine: each request's chain rows at
    its activation (what its prefill left, before a decode step rewrites
    its last slot; local, packed, handed off or reclaimed alike), and the
    launch counts of the packed frames a prefill worker's thread ran (the
    worker holds the step lock through a frame, so the counters' change
    over the call is the worker's alone). Returns the probes' dict."""
    import threading

    from paddle_tpu_torch.ops import cuda as port_cuda

    probe = getattr(eng, "_smoke_probe", None)
    if probe is not None:
        return probe
    probe = {"landed": {}, "worker_launches": {}, "worker_frames": [],
             "record_upto": None}
    activate = eng.scheduler.activate
    packed = eng.packed_prefill_cache

    def record(req):
        n = int(req.context.size)
        if probe["record_upto"] is None or n <= probe["record_upto"]:
            probe["landed"][req.rid] = _chain_rows(
                eng._cache, eng.allocator.chain(req.rid), n)
        return activate(req)

    def counted(cache, items, req=None):
        if not threading.current_thread().name.startswith(WORKER_THREAD):
            return packed(cache, items, req=req)
        before = port_cuda.launch_counts()
        out = packed(cache, items, req=req)
        for k, n in port_cuda.launch_counts().items():
            d = n - before.get(k, 0)
            if d:
                probe["worker_launches"][k] = \
                    probe["worker_launches"].get(k, 0) + d
        probe["worker_frames"].append([int(t.size) for t, _ in items])
        return out

    eng.scheduler.activate = record
    eng.packed_prefill_cache = counted
    eng._smoke_probe = probe
    return probe


def _residue(eng):
    """The exactly-once postcondition: nothing half-admitted anywhere."""
    eng.allocator.check_consistency()
    return {"requests": len(eng.scheduler._by_rid),
            "pending": len(eng._pending_handoff),
            "cancelled_pending": len(eng._cancelled_pending),
            "used_pages": eng.allocator.used_pages}


def _disagg_serve(eng, prompts, new_tokens, mode=None, workers=1,
                  chaos=None, timeout_s=DISAGG_TIMEOUT_S, record_upto=None):
    """Serve `prompts` on `eng`: mixed (mode None) or as the decode side of
    `workers` prefill workers (build_disagg) with `chaos` armed once. All
    are submitted, stepped until each has its first token, then run to the
    end. Returns the streams, each prompt's landed chain rows, the
    launches (whole run, and the workers' share), the handoff counters and
    each handoff's ms, TTFTs and tokens/s, worker deaths and the residue.
    Only prompts of up to `record_upto` tokens (None: all) have their
    landed rows read back."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.resilience import faults
    from paddle_tpu_torch.observability.events import journal
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving.disagg import build_disagg

    probe = _instrument(eng)
    probe["landed"].clear()
    probe["worker_launches"].clear()
    probe["worker_frames"].clear()
    probe["record_upto"] = record_upto
    cuda = eng.device.type == "cuda"
    eng.reset_stats()
    ws, channel = [], None
    if mode is not None:
        channel, ws = build_disagg(eng, workers, mode=mode,
                                   timeout_s=timeout_s)
    faults.reset()
    if chaos:
        faults.arm(chaos)
    journal().clear()
    try:
        if cuda:
            torch.cuda.synchronize()
        port_cuda.reset_launch_counts()          # the path starts here
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        reqs = [eng.scheduler.get(r) for r in rids]
        while eng.busy and not all(r.generated for r in reqs):
            eng.step()
        if cuda:
            torch.cuda.synchronize()
        t_first = time.perf_counter()
        at_first = sum(len(r.generated) for r in reqs)
        eng.run_until_idle()
        if cuda:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = port_cuda.launch_counts()     # ... and ends here
        streams = [list(r.generated) for r in reqs]
        ttft = [(r.token_times[0] - r.arrival_t) * 1e3 for r in reqs]
        for r in rids:
            eng.release(r)
        fired = faults.fired(chaos) if chaos else 0
    finally:
        faults.reset()
        for w in ws:
            w.close()
        eng._handoff_channel = None
    st = eng.stats()
    handoff_ms = [e["ms"] for e in journal().recent(component="serving",
                                                     event="handoff")]
    gen = sum(len(s) for s in streams)
    return {
        "mode": mode or "mixed", "workers": workers if mode else 0,
        "chaos": chaos, "fired": fired, "streams": streams,
        "landed": [probe["landed"].get(r) for r in rids],
        "launches": launches,
        "worker_launches": dict(probe["worker_launches"]),
        "worker_frames": list(probe["worker_frames"]),
        "handoffs": st["handoffs"], "reclaims": st["handoff_reclaims"],
        "handoff_pages": st["handoff_pages"],
        "handoff_ms_p50": (float(np.percentile(handoff_ms, 50))
                           if handoff_ms else None),
        "handoff_ms_max": max(handoff_ms) if handoff_ms else None,
        "channel": channel.stats() if channel is not None else None,
        "worker_deaths": [w.dead_cause for w in ws if w.dead_cause],
        "prefill_s": t_first - t0,
        "prefill_tokens_per_s": (sum(int(np.asarray(p).size)
                                     for p in prompts) / (t_first - t0)),
        "decode_tokens_per_s": ((gen - at_first) / (t_end - t_first)
                                if t_end > t_first else None),
        "ttft_ms_mean": statistics.mean(ttft), "ttft_ms_max": max(ttft),
        "residue": _residue(eng)}


def _landed_vs(runs, ref, rule=None):
    """Per prompt, against `ref`'s landed rows: None (bit-equal) or the
    first differing byte; with `rule` ("float32") also each pool's worst
    difference and whether every pool holds the rule: float pools (K/V,
    int8 scales) each row by the fp32 row rule, int8 codes within one
    step."""
    import torch

    out = []
    for got, want in zip(runs, ref):
        diff = _first_diff(got, want)
        rec = {"first_diff": diff}
        if rule is not None and diff is not None:
            ok, worst = True, {}
            for name, g in got.items():
                w = want[name]
                if g.dtype == torch.float32:
                    cmp = _compare(g, w, rule)
                    worst[name] = cmp["max_rel_err"]
                    ok &= cmp["rows_ok"]
                else:
                    d = (g.int() - w.int()).abs()
                    worst[name] = int(d.max())
                    ok &= worst[name] <= 1
            rec["worst"] = worst
            rec["rule_ok"] = bool(ok)
        out.append(rec)
    return out


def _frame_independence(eng, prompts):
    """Is a packed frame's output for one segment independent of the
    segments beside it? Each prompt that fits the pack frame is prefilled
    into scratch pools (zeros, fresh page ids) alone in a frame and within
    the full frames `_plan_frames` makes of all of them (as a worker that
    took them together would), and the chain rows are compared bit for
    bit. Returns, per prompt, its frame's segment lengths and the first
    differing byte (None: bit-equal)."""
    import numpy as np
    import torch

    ps = eng.page_size
    fit = [np.asarray(p, np.int32) for p in prompts
           if int(np.asarray(p).size) <= eng.pack_frame]
    need = 1 + sum(-(-int(p.size) // ps) for p in fit)

    def scratch():
        return {name: torch.zeros(a.shape[:2] + (need,) + a.shape[3:],
                                  dtype=a.dtype, device=a.device)
                for name, a in eng._cache.items()}

    rows, nxt = [], 1
    for p in fit:
        n = -(-int(p.size) // ps)
        row = np.zeros(eng.pages_per_seq, np.int32)
        row[:n] = np.arange(nxt, nxt + n)
        rows.append(row)
        nxt += n
    items = list(zip(fit, rows))
    together, alone = scratch(), scratch()
    frames = eng._plan_frames(items, lambda it: it[0].size)
    with eng._step_lock:
        for frame in frames:
            together = eng.packed_prefill_cache(together, frame)
        for item in items:
            alone = eng.packed_prefill_cache(alone, [item])
    out = []
    for (p, row) in items:
        frame = next(f for f in frames if any(r is row for _, r in f))
        chain = row[:-(-int(p.size) // ps)]
        out.append({"len": int(p.size),
                    "frame": [int(t.size) for t, _ in frame],
                    "first_diff": _first_diff(
                        _chain_rows(together, chain, int(p.size)),
                        _chain_rows(alone, chain, int(p.size)))})
    return out, items


def _copy_vs_alias_same_frames(eng, items):
    """Copy-mode chain bytes against alias-mode ones for the same frames:
    the alias path's packed frames written into scratch pools, against a
    copy worker's `_prefill_copy` of the same jobs (its side pool, then
    the pages copied to host tensors). Returns the first differing byte
    per job (None: bit-equal)."""
    import torch

    from paddle_tpu_torch.quantization import raw_bytes
    from paddle_tpu_torch.serving.disagg import (HandoffChannel, PrefillJob,
                                                 PrefillWorker)

    ps = eng.page_size
    need = 1 + sum(-(-int(t.size) // ps) for t, _ in items)
    alias = {name: torch.zeros(a.shape[:2] + (need,) + a.shape[3:],
                               dtype=a.dtype, device=a.device)
             for name, a in eng._cache.items()}
    with eng._step_lock:
        for frame in eng._plan_frames(items, lambda it: it[0].size):
            alias = eng.packed_prefill_cache(alias, frame)
    jobs = [PrefillJob(rid=-1 - i, tokens=t, page_row=r, posted_t=0.0)
            for i, (t, r) in enumerate(items)]
    worker = PrefillWorker(eng, HandoffChannel(), mode="copy")
    try:
        payloads, ms = worker._prefill_copy(jobs)
    finally:
        worker.close()
        del worker
    out = []
    for (t, row), pages in zip(items, payloads):
        n = int(t.size)
        got = {name: torch.stack([pg[name] for pg in pages], 2)
               for name in pages[0]}
        got = {name: raw_bytes(g.reshape(g.shape[0], g.shape[1], -1,
                                         *g.shape[4:])[:, :, :n])
               for name, g in got.items()}
        out.append(_first_diff(got, _chain_rows(alias, row[:len(pages)], n)))
    return out, ms


def phase_disagg_cuda_vs_cpu(seed, report):
    """Disaggregated prefill/decode on CUDA (kernels) against the CPU
    (plain versions), on phase 3's fp32 GQA model (page 16, decode batch
    4, chunk and pack frame 128): 8 prompts of 5-150 tokens (the 150 one
    past the frame, prefilled on the decode side), 16 new tokens, served
    mixed, then through 1 and 2 prefill workers in alias and copy mode,
    with serving.prefill.kill and serving.handoff.drop armed, a cancel
    while a job is pending, and over int8 pages in copy mode (codes and
    scales handed off). Gates: every stream equal to the CPU engine's
    mixed and disaggregated runs and to the CUDA mixed engine's; each
    chain's landed rows within the fp32 rule of the CPU disaggregated
    run's (over int8 pages the worst code step and scale difference
    against the CPU are reported, not gated: a code flipped by a
    rounding-sized difference moves the next layers' scales by up to a
    quantization step; against the CUDA mixed engine, codes within a step
    and scales by the fp32 rule); the chaos runs reclaim; the cancel
    defers its release; every run residue-free; flash forward launched
    on the worker thread in every CUDA disaggregated run. Measured and
    printed, gating the bytes: whether a packed frame's output for one
    segment is independent of its neighbours (scratch pools, alone
    against in the full frame) and equal to the chunked path's (the
    mixed engine's solo prompts, and every reclaim); where both hold,
    every landed chain is bit-equal to the CUDA mixed engine's, else the
    first differing byte is reported and the rows held to the fp32
    rule (the chaos runs' reclaims prefill on the chunked path, so their
    rows are held to that rule in any case)."""
    import numpy as np

    from paddle_tpu_torch.distributed.resilience import faults
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.disagg import build_disagg

    cfg = _tiny_gqa_config()
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    kw = dict(page_size=16, num_pages=128, decode_batch=4, prefill_chunk=128,
              pack_frame=128, max_seq_len=256)
    rng = np.random.RandomState(seed + 3)
    lens = (5, 40, 70, 150, 20, 100, 33, 64)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    new = 16
    engines = {}

    def engine(dev, kv="model"):
        key = (dev, kv)
        if key not in engines:
            engines[key] = ServingEngine(
                cpu_model if dev == "cpu" else gpu_model,
                _engine_cfg(kv_cache_dtype=kv, **kw), device=dev)
        return engines[key]

    runs = {
        "cpu_mixed": _disagg_serve(engine("cpu"), prompts, new),
        "cpu_alias": _disagg_serve(engine("cpu"), prompts, new, "alias"),
        "cuda_mixed": _disagg_serve(engine("cuda"), prompts, new)}
    for mode in ("alias", "copy"):
        for n in (1, 2):
            runs[f"cuda_{mode}_{n}"] = _disagg_serve(
                engine("cuda"), prompts, new, mode, workers=n)
    runs["cuda_kill"] = _disagg_serve(engine("cuda"), prompts, new, "alias",
                                      chaos="serving.prefill.kill")
    runs["cuda_drop"] = _disagg_serve(engine("cuda"), prompts, new, "alias",
                                      chaos="serving.handoff.drop",
                                      timeout_s=CHAOS_TIMEOUT_S)
    runs["cpu_int8_mixed"] = _disagg_serve(engine("cpu", "int8"), prompts,
                                           new)
    runs["cpu_int8_copy"] = _disagg_serve(engine("cpu", "int8"), prompts,
                                          new, "copy")
    runs["cuda_int8_mixed"] = _disagg_serve(engine("cuda", "int8"), prompts,
                                            new)
    runs["cuda_int8_copy"] = _disagg_serve(engine("cuda", "int8"), prompts,
                                           new, "copy")

    # a cancel while the job is pending: the drop keeps it pending, the
    # release defers until the reclaim resolves it
    eng = engine("cuda")
    channel, ws = build_disagg(eng, 1, timeout_s=CHAOS_TIMEOUT_S)
    faults.reset()
    faults.arm("serving.handoff.drop", mode="always")
    try:
        rid = eng.submit(prompts[1], max_new_tokens=new)
        eng.step()
        was_pending = rid in eng._pending_handoff
        used = eng.allocator.used_pages
        eng.cancel(rid)
        eng.release(rid)
        deferred = (rid in eng._cancelled_pending
                    and eng.allocator.used_pages == used)
        eng.run_until_idle()
    finally:
        faults.reset()
        for w in ws:
            w.close()
        eng._handoff_channel = None
    cancel = {"was_pending": was_pending, "release_deferred": deferred,
              "residue": _residue(eng)}

    indep, _ = _frame_independence(engine("cuda"), prompts)
    fp32_mixed = runs["cuda_mixed"]["landed"]
    chunked_vs_packed = _landed_vs(runs["cuda_alias_1"]["landed"],
                                   fp32_mixed)
    exact = (all(r["first_diff"] is None for r in indep)
             and all(r["first_diff"] is None for r in chunked_vs_packed))
    ref = runs["cpu_mixed"]["streams"]
    problems, checks = [], {}
    for name, run in runs.items():
        int8 = "int8" in name
        want = runs["cpu_int8_mixed"]["streams"] if int8 else ref
        c = {"streams_equal": run["streams"] == want,
             "residue_free": not any(run["residue"].values())}
        if name.startswith("cuda") and run["mode"] != "mixed":
            mixed = runs["cuda_int8_mixed" if int8 else "cuda_mixed"]
            cpu_dis = runs["cpu_int8_copy" if int8 else "cpu_alias"]
            c["equal_cuda_mixed"] = run["streams"] == mixed["streams"]
            c["worker_flash_fwd"] = run["worker_launches"].get("flash_fwd",
                                                               0)
            c["vs_cpu"] = _landed_vs(run["landed"], cpu_dis["landed"],
                                     "float32")
            c["vs_cuda_mixed"] = _landed_vs(run["landed"], mixed["landed"],
                                            "float32")
            if not int8 and not all(r.get("rule_ok", True)
                                    for r in c["vs_cpu"]):
                # int8 rows against the CPU are reported, not gated: one
                # code a rounding-sized difference flips moves the next
                # layers' scales by up to a quantization step
                problems.append(f"{name}: landed rows off the CPU's")
            if exact and not int8 and run["chaos"] is None and not all(
                    r["first_diff"] is None for r in c["vs_cuda_mixed"]):
                problems.append(f"{name}: landed rows not bit-equal to "
                                f"the CUDA mixed engine's")
            if not all(r.get("rule_ok", True) for r in c["vs_cuda_mixed"]):
                problems.append(f"{name}: landed rows off the CUDA mixed "
                                f"engine's")
            if not c["equal_cuda_mixed"]:
                problems.append(f"{name}: streams differ from the CUDA "
                                f"mixed engine's")
            if c["worker_flash_fwd"] <= 0 and run["chaos"] is None:
                problems.append(f"{name}: no flash forward launch on the "
                                f"worker thread")
            if run["chaos"] is None and (run["handoffs"] == 0
                                         or run["reclaims"]):
                problems.append(f"{name}: {run['handoffs']} handoffs, "
                                f"{run['reclaims']} reclaims")
        if run["chaos"] is not None and not (run["fired"] == 1
                                             and run["reclaims"] >= 1):
            problems.append(f"{name}: chaos fired {run['fired']}, "
                            f"{run['reclaims']} reclaims")
        if not c["streams_equal"]:
            problems.append(f"{name}: streams differ from the CPU's")
        if not c["residue_free"]:
            problems.append(f"{name}: residue {run['residue']}")
        checks[name] = c
    if not (cancel["was_pending"] and cancel["release_deferred"]
            and not any(cancel["residue"].values())):
        problems.append(f"cancel during a pending handoff: {cancel}")
    launches = {}
    for name, run in runs.items():
        if name.startswith("cuda"):
            for k, n in run["launches"].items():
                launches[k] = launches.get(k, 0) + n
    out = {"prompt_lens": list(lens), "new_tokens": new,
           "independence": indep,
           "chunked_vs_packed_first_diff": [r["first_diff"]
                                            for r in chunked_vs_packed],
           "exact_bytes_gate": exact, "checks": checks, "cancel": cancel,
           "launches": launches,
           "runs": {k: {f: v for f, v in r.items()
                        if f not in ("landed", "streams")}
                    for k, r in runs.items()}}
    report["disagg_cuda_vs_cpu"] = out
    print("disagg cuda vs cpu: " + json.dumps(
        {"independence": indep, "chunked_vs_packed":
         out["chunked_vs_packed_first_diff"], "exact_bytes_gate": exact,
         "cancel": cancel,
         "runs": {k: dict(streams_equal=c["streams_equal"],
                          worker_flash_fwd=c.get("worker_flash_fwd"),
                          handoffs=runs[k]["handoffs"],
                          reclaims=runs[k]["reclaims"],
                          frames=runs[k]["worker_frames"])
                  for k, c in checks.items()}}, default=str), flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


def _checked_worker_flash(check):
    """Hold every flash forward call made on a prefill worker's thread to
    its plain version on the same inputs (the bf16 row rule): wraps the
    functional seam's forward, returns the restore function."""
    import threading

    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    kernel = F.flash_attention_fwd

    def checked(q, k, v, causal=False, scale=None, segment_ids=None):
        out = kernel(q, k, v, causal=causal, scale=scale,
                     segment_ids=segment_ids)
        if threading.current_thread().name.startswith(WORKER_THREAD):
            ref, _ = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), causal=causal,
                scale=scale, segment_ids=segment_ids)
            cmp = _compare(out[0], ref,
                           "float32" if q.dtype == torch.float32
                           else "bfloat16")
            check["n"] += 1
            check["failed"] += not cmp["rows_ok"]
            check["worst_row_rel_err"] = max(check["worst_row_rel_err"],
                                             cmp["max_rel_err"])
        return out

    F.flash_attention_fwd = checked

    def restore():
        F.flash_attention_fwd = kernel

    return restore


def phase_full_width_disagg(eng, prompts, report):
    """Phase 4's engine (LLaMA-2-7B geometry, bf16, page 16, decode batch
    8, chunk and pack frame 256, 16 GiB of pages) serves phase 4's 8
    prompts (NEW_TOKENS new tokens) mixed, then as the decode side of one
    alias worker and of one copy worker (the four prompts of up to 256
    tokens go to the worker, the four longer ones prefill on the decode
    side). Per run: prefill and decode tokens/s, TTFT, handoffs, reclaims,
    pages handed off, handoff ms (p50, max; the worker synchronizes the
    device before it reads the clock, so they include the device work),
    launches (whole run, and flash forward on the worker thread). Then one
    alias run with every worker flash call held to its plain version (the
    bf16 row rule), a profile of two decode steps after the handoffs
    (device ms against wall ms, the paged kernel by name), the packed-frame
    independence check on scratch pools (each prompt alone against within
    the full frame; the first differing byte) and copy-mode chain bytes
    against alias-mode ones for the same frames. Gates: every run
    completes every request with no reclaim and no residue; copy equals
    alias bit for bit for the same frames; flash forward and paged decode
    launched in every run, flash forward on the worker thread; if the
    frames are independent and the worker's rows equal the mixed engine's
    bit for bit, every stream equals the mixed run's, else each worker
    flash call holds the row rule and every request's first token equals
    the mixed run's (ROADMAP C-fact 4)."""
    import numpy as np

    from paddle_tpu_torch.serving.disagg import build_disagg

    upto = eng.pack_frame                    # the worker's prompts
    runs = {"mixed": _disagg_serve(eng, prompts, NEW_TOKENS,
                                   record_upto=upto),
            "alias": _disagg_serve(eng, prompts, NEW_TOKENS, "alias",
                                   record_upto=upto),
            "copy": _disagg_serve(eng, prompts, NEW_TOKENS, "copy",
                                  record_upto=0)}
    check = dict(n=0, failed=0, worst_row_rel_err=0.0,
                 rtol=RTOL["bfloat16"])
    restore = _checked_worker_flash(check)
    try:
        runs["alias_checked"] = _disagg_serve(eng, prompts, NEW_TOKENS,
                                              "alias", record_upto=0)
    finally:
        restore()
    # two decode steps after the handoffs landed, profiled
    channel, ws = build_disagg(eng, 1, timeout_s=DISAGG_TIMEOUT_S)
    try:
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        while eng._pending_handoff or eng.scheduler.waiting:
            eng.step()
        profile = _device_profile(eng.step, 2)
        eng.run_until_idle()
        for r in rids:
            eng.release(r)
    finally:
        for w in ws:
            w.close()
        eng._handoff_channel = None
    indep, items = _frame_independence(eng, prompts)
    copy_vs_alias, copy_ms = _copy_vs_alias_same_frames(eng, items)
    mixed = runs["mixed"]
    worker_rows = _landed_vs(
        [x for x in runs["alias"]["landed"] if x is not None],
        [x for x in mixed["landed"] if x is not None])
    exact = (all(r["first_diff"] is None for r in indep)
             and all(r["first_diff"] is None for r in worker_rows))
    out = {"prompt_lens": [int(np.asarray(p).size) for p in prompts],
           "new_tokens": NEW_TOKENS, "independence": indep,
           "worker_rows_vs_mixed": [r["first_diff"] for r in worker_rows],
           "copy_vs_alias_same_frames": copy_vs_alias,
           "copy_prefill_ms_per_job": copy_ms,
           "streams_gate": "exact" if exact else "row_rule_first_token",
           "worker_flash_check": check,
           "decode_profile_after_handoff": profile,
           "runs": {k: {f: v for f, v in r.items()
                        if f not in ("landed", "streams")}
                    for k, r in runs.items()}}
    problems = []
    for name, run in runs.items():
        complete = all(len(s) == NEW_TOKENS for s in run["streams"])
        run_out = out["runs"][name]
        run_out["complete"] = complete
        run_out["agreement_vs_mixed"] = _agreement(run["streams"],
                                                   mixed["streams"])
        run_out["first_tokens_equal"] = [s[0] == m[0] for s, m in zip(
            run["streams"], mixed["streams"])]
        if not complete or any(run["residue"].values()):
            problems.append(f"{name}: incomplete or residue "
                            f"{run['residue']}")
        for k in ("flash_fwd", "paged_decode"):
            if run["launches"].get(k, 0) <= 0:
                problems.append(f"{name}: {k} never launched")
        if name == "mixed":
            continue
        if run["handoffs"] != 4 or run["reclaims"]:
            problems.append(f"{name}: {run['handoffs']} handoffs, "
                            f"{run['reclaims']} reclaims")
        if run["worker_launches"].get("flash_fwd", 0) <= 0:
            problems.append(f"{name}: no flash forward on the worker")
        if exact and run["streams"] != mixed["streams"]:
            problems.append(f"{name}: streams differ from the mixed run's "
                            f"with bit-equal prefill bytes")
        if not exact and not all(run_out["first_tokens_equal"]):
            problems.append(f"{name}: first tokens differ from the mixed "
                            f"run's")
    if not exact and (check["n"] == 0 or check["failed"]):
        problems.append(f"worker flash calls off their plain version: "
                        f"{check}")
    if any(d is not None for d in copy_vs_alias):
        problems.append(f"copy-mode bytes differ from alias-mode bytes for "
                        f"the same frames: {copy_vs_alias}")
    _check_paged_kernels("bf16", profile)
    launches = {}
    for run in runs.values():
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    report["full_width_disagg"] = out
    print("full width disagg: " + json.dumps(
        {k: v for k, v in out.items()
         if k not in ("decode_profile_after_handoff",)}, default=str),
        flush=True)
    print("full width disagg decode after handoff: " + json.dumps(
        {k: profile[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                 "device_busy_share", "paged_ms_per_step",
                                 "paged_kernels")}), flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# LoRA training on the card
# ---------------------------------------------------------------------------
LORA_TRAIN_STEPS = 4       # timed, after 2 warm-up steps


def _lora_train(model, rank, lr, multi_precision=False):
    """Attach a rank-`rank` adapter on q, k, v, o (the base frozen) and
    build a TrainStep of AdamW over model.parameters(): (handle, step)."""
    from paddle_tpu_torch.lora import LoRAConfig, attach
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    handle = attach(model, LoRAConfig(rank=rank, alpha=2.0 * rank, seed=7))
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=multi_precision)
    step = TrainStep(model, _fused_loss, opt)
    return handle, step


def phase_lora_train_cuda_vs_cpu(seed, report):
    """LoRA training on CUDA (kernels) against the CPU (plain versions):
    phase 6's model and packed batch with a rank-8 adapter on q, k, v, o
    (A from the same numpy seed on both devices, B zero), 3 TrainStep
    steps of AdamW(1e-3) over model.parameters(). Gates, phase 6's fp32
    rule on the factors: per-step losses within 1e-4 relative, the
    factors' last gradients within 1e-3 of each tensor's max |grad|, the
    factors within lr; every base parameter bit-unchanged on both devices
    (no gradient); every A and B moved off its initial value."""
    import torch

    from paddle_tpu_torch.lora import detach
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda

    cfg = _tiny_gqa_config()
    batch = _packed_batch(seed, cfg.vocab_size, 256, 2)
    models = {"cpu": LlamaForCausalLM(cfg, device="cpu", seed=seed)}
    models["cuda"] = LlamaForCausalLM(cfg, device="cuda")
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    lr = 1e-3
    base, handles, losses, init = {}, {}, {}, {}
    for dev, model in models.items():
        base[dev] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
        handle, step = _lora_train(model, 8, lr)
        handles[dev] = handle
        init[dev] = [(a.detach().clone(), b.detach().clone())
                     for _, _, a, b in handle.entries]
        if dev == "cuda":
            torch.cuda.synchronize()
            port_cuda.reset_launch_counts()
        losses[dev] = [float(step(batch)) for _ in range(3)]
        if dev == "cuda":
            launches = port_cuda.launch_counts()
    worst_p = worst_g = 0.0
    for (_, _, ta, tb), (_, _, ca, cb) in zip(handles["cuda"].entries,
                                              handles["cpu"].entries):
        for t, c in ((ta, ca), (tb, cb)):
            worst_p = max(worst_p, (t.detach().cpu() - c.detach())
                          .abs().max().item())
            g, gc = t.grad.cpu(), c.grad
            worst_g = max(worst_g, ((g - gc).abs().max()
                                    / gc.abs().max().clamp_min(1e-7)).item())
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    base_unchanged, moved = {}, {}
    for dev, model in models.items():
        base_unchanged[dev] = all(
            torch.equal(p.detach(), base[dev][n])
            for n, p in model.named_parameters()
            if not n.startswith("_lora_host"))
        base_unchanged[dev] &= all(
            p.grad is None for n, p in model.named_parameters()
            if not n.startswith("_lora_host"))
        moved[dev] = all(
            not torch.equal(a.detach(), a0) and not torch.equal(b.detach(), b0)
            for (_, _, a, b), (a0, b0) in zip(handles[dev].entries,
                                              init[dev]))
    for handle in handles.values():
        detach(handle)
    out = {"losses": losses, "loss_rel_err": loss_rel,
           "factor_grad_rel_err": worst_g, "factor_max_abs_err": worst_p,
           "base_bit_unchanged": base_unchanged, "factors_moved": moved,
           "trainable": sum(a.numel() + b.numel() for _, _, a, b
                            in handles["cuda"].entries),
           "launches": launches,
           "tolerance": {"loss_rel": 1e-4, "grad_rel": 1e-3, "param": lr}}
    report["lora_train_cuda_vs_cpu"] = out
    print("lora train cuda vs cpu: " + json.dumps(out), flush=True)
    if not (loss_rel <= 1e-4 and worst_g <= 1e-3 and worst_p <= lr):
        raise AssertionError("CUDA and CPU LoRA training steps differ")
    if not (all(base_unchanged.values()) and all(moved.values())):
        raise AssertionError(f"base changed or factors not trained: "
                             f"{base_unchanged} {moved}")
    if launches.get("flash_fwd", 0) < 3 * cfg.num_hidden_layers:
        raise AssertionError(f"flash forward not on the LoRA training "
                             f"path: {launches}")


def phase_lora_train_full_width(args, report):
    """LoRA training at phase 7's geometry (7B width, 3 layers, bf16, seq
    4096, the fused head loss), the base frozen, rank 16 on q, k, v, o,
    AdamW(1e-4, multi_precision), 2 warm-up and LORA_TRAIN_STEPS timed
    steps: step ms, tokens/s, peak memory, trainable parameters and
    launches a step (flash forward, dq, dkv, ce_stats, the CE backward).
    Then the trained adapter is exported (the port's export_adapter),
    the base detached, and one request served through a LoRA engine on the
    same base: every gmm_fwd call of its prefill and first decode step
    held to the per-row fp32 rule of a plain fp32 product on its own
    inputs (full_width_lora's check). Gates: finite losses; the kernels
    every step (3 of each flash kernel, 1 ce_stats, 1 ce_bwd); the base's
    first projection and head bit-unchanged; the gmm_fwd calls; the
    served stream complete."""
    import numpy as np
    import torch

    from paddle_tpu_torch.lora import AdapterStore, detach, export_adapter
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_7b_config(num_hidden_layers=TRAIN_LAYERS, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cuda", seed=args.seed)
    rng = np.random.RandomState(args.seed)
    ids = torch.from_numpy(
        rng.randint(1, cfg.vocab_size, (1, TRAIN_SEQ + 1))).cuda()
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    q0 = model.llama.layers[0].self_attn.q_proj.weight.detach().clone()
    head0 = model.lm_head.weight.detach().clone()
    handle, step = _lora_train(model, LORA_RANK, TRAIN_LR,
                               multi_precision=True)
    trainable = sum(p.numel() for p in model.parameters()
                    if p.requires_grad)
    losses = [float(step(batch)) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port_cuda.reset_launch_counts()          # the LoRA training path
    times = []
    for _ in range(LORA_TRAIN_STEPS):
        t1 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    launches = port_cuda.launch_counts()     # ... ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(times)
    path = os.path.join(REPO, "chiprun_out", "lora_adapters",
                        "trained.pdmodel")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    export_adapter(path, handle, adapter_id="trained")
    detach(handle)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    base_unchanged = (torch.equal(model.llama.layers[0].self_attn.q_proj
                                  .weight.detach(), q0)
                      and torch.equal(model.lm_head.weight.detach(), head0))
    model.eval()
    store = AdapterStore(model, rank=LORA_RANK, slots=4)
    store.register("trained", path)
    eng = ServingEngine(model, _engine_cfg(
        page_size=16, decode_batch=8, prefill_chunk=256, max_seq_len=4096,
        hbm_budget_mb=2048), adapter_store=store, device="cuda")
    prompt = rng.randint(1, cfg.vocab_size, 200).astype(np.int32)
    _, calls = _lora_first_logits_by_route(eng, [prompt], ["trained"],
                                           "checked")
    stream = eng.generate([prompt], max_new_tokens=8, adapter="trained")[0]
    base_stream = eng.generate([prompt], max_new_tokens=8)[0]
    out = {"layers": cfg.num_hidden_layers, "seq": TRAIN_SEQ,
           "rank": LORA_RANK, "trainable_params": trainable,
           "losses": losses, "step_ms": [t * 1e3 for t in times],
           "median_step_ms": step_s * 1e3,
           "tokens_per_s": TRAIN_SEQ / step_s, "peak_mem_gb": peak,
           "launches": launches,
           "launches_per_step": {k: n / LORA_TRAIN_STEPS
                                 for k, n in launches.items()},
           "base_bit_unchanged": base_unchanged,
           "serve_gmm_calls_vs_plain": calls, "stream": stream,
           "base_stream": base_stream,
           "agreement_vs_base": _agreement([stream], [base_stream])}
    report["lora_train_full_width"] = out
    print("lora train full width: " + json.dumps(out, default=str),
          flush=True)
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"non-finite loss: {losses}")
    layers = cfg.num_hidden_layers
    need = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "ce_stats": 1, "ce_bwd": 1}
    short = {k: n for k, n in out["launches_per_step"].items()
             if k in need and n < need[k]}
    short.update({k: 0 for k in need if k not in launches})
    if short:
        problems.append(f"kernels not launched a step: {short}")
    if not base_unchanged:
        problems.append("the frozen base changed")
    if not calls["n"] or calls["failed"]:
        problems.append(f"gmm_fwd off its plain version: {calls['failed']} "
                        f"of {calls['n']} calls")
    if len(stream) != 8:
        problems.append(f"the adapter stream is incomplete: {stream}")
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# fleet: hybrid parallelism, a process a rank (ROADMAP A8, first part)
# ---------------------------------------------------------------------------

FLEET_LR = 1e-3              # the tiny CUDA-vs-CPU layouts (phase 6's lr)
FLEET_SMALL_TIMEOUT_S = 300  # each spawned group (ranks reach the card,
FLEET_FULL_TIMEOUT_S = 480   # gloo carries CUDA tensors through the host)
FLEET_LAYOUTS = {
    "dp2_mp2": ({"dp": 2, "mp": 2}, None, 1),
    "mp2_sharding2_zero1": ({"mp": 2, "sharding": 2}, "sharding", 1),
    "mp2_sharding2_zero2": ({"mp": 2, "sharding": 2}, "sharding", 2)}
# the full-width run: 2 + 2 steps (2 + 4 until the sep slice's phases
# needed the script's time)
FLEET_WARMUP, FLEET_STEPS = 2, 2
# the full-width run against the single-rank model: its first two losses
# and its gradient norms of steps 0 and 1, relative. Sound runs read at
# most 3.0e-5 (losses) and 3.7e-5 (norms); a planted fault (mp rank 1
# dropping layer 0's o_proj all-reduce; sharding rank 1 dropping its
# update) reads 1.7e-4 and 2.5e-4 at the least (tools/fleet_gate_probe.py)
FLEET_LOSS_RTOL = 7e-5
FLEET_GNORM_RTOL = 1e-4
CE_BWD_FP64_FLOOR = 8.0            # see _CeCalls


class _CeCalls:
    """Holds every ``ce_stats``/``ce_bwd`` kernel call of this process to
    its plain version on the same inputs: ce_stats' m, lse and t within
    CE_TOL and sl within CE_SL_TOL * V (the kernels phase's rule); the
    backward's dx and dW (bf16 inputs: the kernels) each row within
    CE_BWD_RTOL of its max |ref| (TF32 off). Every backward call is also
    run in fp64 on the same inputs (the witness), and both versions'
    distances from it are recorded in the row rule's measure; a call
    that misses the rule against the plain version passes if the kernel
    is within it of the fp64 result, or, where the fp32 plain version
    itself is past it (a batch the model has memorised: p within
    rounding of 1, d-logits all rounding), within CE_BWD_FP64_FLOOR
    times the plain version's distance (the worst ratio read there was
    3.6, ``tools/fleet_gate_probe.py``). While ``defer`` is set the
    inputs and outputs are kept and checked by ``check_deferred()``, so
    timed steps carry no reference work. The references launch no
    kernel, so they add no launch."""

    def __init__(self):
        from paddle_tpu_torch.ops.cuda import fused_ce as fc

        self.fc = fc
        self.real = (fc.ce_stats, fc.ce_bwd)
        self.defer = False
        self.host = False       # deferred copies kept in host memory
        self.pending = []
        self.out = {name: {"calls": 0, "worst": 0.0, "ok": True, "errs": []}
                    for name in ("ce_stats", "ce_bwd")}
        self.out["ce_bwd"]["fp64"] = []
        fc.ce_stats, fc.ce_bwd = self._stats, self._bwd

    def restore(self):
        self.fc.ce_stats, self.fc.ce_bwd = self.real

    def _queue(self, job):
        if not self.defer:
            self._check(job)
        elif self.host:
            dev = job[3][0].device
            self.pending.append(_moved(job, "cpu") + (dev,))
        else:
            self.pending.append(job)

    def _stats(self, x, w, labels):
        got = self.real[0](x, w, labels)
        if x.is_cuda:
            self._queue(("ce_stats", (x.detach().clone(), w.detach().clone(),
                                      labels.clone()), {}, got))
        return got

    def _bwd(self, x, w, labels, lse, ct, ignore_index=-100,
             label_smoothing=0.0, z_loss=0.0, chunk_tokens=0, v_total=0):
        import torch

        args = (x, w, labels, lse, ct, ignore_index, label_smoothing, z_loss,
                chunk_tokens)
        got = self.real[1](*args, v_total=v_total)
        if x.is_cuda and x.dtype == torch.bfloat16:
            # the caller sums dx over mp in place after this returns
            kept = (got[0].clone(), got[1]) if self.defer else got
            self._queue(("ce_bwd", tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a
                for a in args), {"v_total": v_total}, kept))
        return got

    def _check(self, job):
        import torch

        name, args, kw, got = job
        fc, rec = self.fc, self.out[name]
        if name == "ce_stats":
            x, w, labels = args
            ref = fc.ce_stats_reference(x, w, labels)
            lse_g = got[0] + torch.log(got[1])
            lse_r = ref[0] + torch.log(ref[1])
            err = max((got[0] - ref[0]).abs().max().item(),
                      (lse_g - lse_r).abs().max().item(),
                      (got[2] - ref[2]).abs().max().item())
            err_sl = (got[3] - ref[3]).abs().max().item()
            ok = err <= CE_TOL and err_sl <= CE_SL_TOL * w.shape[0]
        else:
            ref = fc.ce_bwd_reference(*args, v_total=kw["v_total"])
            x, w, labels, lse, ct = args[:5]
            ref64 = fc.ce_bwd_reference(x.double(), w.double(), labels,
                                        lse.double(), ct.double(), *args[5:],
                                        v_total=kw["v_total"])
            err, ok, wit = 0.0, True, {}
            for part, g, r, r64 in (("dx", got[0], ref[0], ref64[0]),
                                    ("dw", got[1], ref[1], ref64[1])):
                e, ok_row = _row_rule(g, r, CE_BWD_RTOL)
                e_k = _row_rule(g, r64, CE_BWD_RTOL)[0]
                e_p = _row_rule(r, r64, CE_BWD_RTOL)[0]
                wit[part] = {"vs_plain": e, "kernel_vs_fp64": e_k,
                             "plain_vs_fp64": e_p}
                err = max(err, e)
                ok = ok and (ok_row or e_k <= CE_BWD_RTOL or (
                    e_p > CE_BWD_RTOL and e_k <= CE_BWD_FP64_FLOOR * e_p))
            rec["fp64"].append(wit)
            del ref64
        rec["calls"] += 1
        rec["errs"].append(err)
        rec["worst"] = max(rec["worst"], err)
        rec["ok"] = rec["ok"] and ok

    def check_deferred(self):
        pending, self.pending = self.pending, []
        for job in pending:
            self._check(_moved(job[:4], job[4]) if len(job) == 5 else job)


def _moved(job, dev):
    """A `_CeCalls` job with its tensors (inputs and outputs) on `dev`."""
    import torch

    def mv(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, tuple):
            return tuple(mv(x) for x in v)
        return v

    name, args, kw, got = job
    return (name, mv(args), kw, mv(got))


def _rank_threads():
    """A full-width rank's intra-op threads: its share of the host's cores
    (four ranks share the machine, and gloo stages their collectives
    through host memory on the same cores)."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))


def _fleet_named(cfg, seed):
    """A seeded port LLaMA's parameters in the JAX package's layout (what
    ``models.convert`` shards)."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.convert import _to_port_layout

    m = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    return {n: _to_port_layout(n, p.detach().numpy().copy())
            for n, p in m.named_parameters()}


def _rank_out(out_dir, name, obj):
    import pickle

    with open(os.path.join(out_dir, name), "wb") as fh:
        pickle.dump(obj, fh)


def _rank_in(out_dir, name):
    import pickle

    with open(os.path.join(out_dir, name), "rb") as fh:
        return pickle.load(fh)


def _fleet_small_rank(out_dir):
    """One gloo rank of ``fleet_cuda_vs_cpu``: each layout on cuda:0 then
    on the CPU, 3 steps from the same shards."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import from_paddle_tpu_params
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    env = dist.init_parallel_env(backend="gloo")
    named, batch = _rank_in(out_dir, "inputs.pkl")
    cfg = _tiny_gqa_config()
    ce = _CeCalls()
    out = {"rank": env.rank,
           "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend(), "layouts": {}}
    launches = {}
    for label, (axes, zero_axis, stage) in FLEET_LAYOUTS.items():
        out["layouts"][label] = {}
        for dev in ("cuda", "cpu"):
            fleet.reset()
            mesh = build_mesh(axes)
            model = from_paddle_tpu_params(named, cfg, device=dev)
            opt = AdamW(learning_rate=FLEET_LR,
                        parameters=model.parameters(), weight_decay=0.01)
            step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                             mesh=mesh, zero_axis=zero_axis,
                             zero_stage=stage)
            if dev == "cuda":
                torch.cuda.synchronize()
                port_cuda.reset_launch_counts()
            losses = [float(step(batch)) for _ in range(3)]
            if dev == "cuda":
                torch.cuda.synchronize()
                for k, n in port_cuda.launch_counts().items():
                    launches[k] = launches.get(k, 0) + n
            out["layouts"][label][dev] = {
                "coord": mesh.coord(), "losses": losses,
                "grad_norm": step.last_metrics()["grad_norm"],
                "params": {n: p.detach().cpu()
                           for n, p in model.named_parameters()}}
            del step, opt, model
    ce.restore()
    out["launches"] = launches
    out["ce_calls"] = ce.out
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def _fleet_nccl_rank(out_dir):
    """A world of one on nccl: c10d collectives on the card, then 3
    TrainStep(mesh=) steps."""
    import torch
    import torch.distributed as tdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import from_paddle_tpu_params
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    dist.init_parallel_env(backend="nccl")
    t = torch.arange(4.0, device="cuda")
    tdist.all_reduce(t)
    tdist.broadcast(t, 0)
    tdist.barrier()
    named, batch = _rank_in(out_dir, "inputs.pkl")
    model = from_paddle_tpu_params(named, _tiny_gqa_config(), device="cuda")
    opt = AdamW(learning_rate=FLEET_LR, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, _fused_loss, opt, mesh=build_mesh({"dp": 1}))
    losses = [float(step(batch)) for _ in range(3)]
    _rank_out(out_dir, "nccl.pkl", {
        "backend": collective.get_backend(), "all_reduce": t.tolist(),
        "losses": losses, "params": {n: p.detach().cpu()
                                     for n, p in model.named_parameters()}})
    dist.destroy_process_group()


def _fleet_nccl_shared_rank(out_dir):
    """One of two ranks on one card asking for nccl, then for the default:
    each call must raise before joining any group."""
    from paddle_tpu_torch import distributed as dist

    msgs = []
    for backend in ("nccl", None):
        try:
            dist.init_parallel_env(backend=backend)
            msgs.append("joined")
        except ValueError as e:
            msgs.append(str(e))
    _rank_out(out_dir, "shared" + os.environ["PADDLE_TRAINER_ID"], msgs)


def phase_fleet_cuda_vs_cpu(seed, report):
    """4 gloo ranks on cuda:0 against the same 4 ranks on the CPU: phase
    6's tiny fp32 LLaMA (mp 2 splits its 4 heads, 2 kv heads, 1024
    intermediate and 1024 vocab), 3 AdamW steps at dp 2 x mp 2 and mp 2 x
    sharding 2 (ZeRO-1, ZeRO-2) on one packed 4 x 256 batch: per-step
    losses within 1e-4 relative and the parameters gathered over mp within
    lr (phase 6's rule); the CPU ranks' losses within 1e-5 relative and
    parameters within lr of a single-process CPU TrainStep; every
    vocab-parallel ce_stats call
    held to its plain version. Then a world of one on nccl against the
    single-process TrainStep on the card (the fp32 rule: losses 1e-6
    relative, parameters 1e-6), and two ranks on the card asking for nccl
    (and for the default backend): both must raise."""
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         gather_paddle_tpu_params)
    from paddle_tpu_torch.models.convert import _to_port_layout
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = _tiny_gqa_config()
    named = _fleet_named(cfg, seed)
    batch = _packed_batch(seed, cfg.vocab_size, 256, 4)
    tmp = tempfile.mkdtemp(prefix="fleet_small_")
    _rank_out(tmp, "inputs.pkl", (named, batch))
    single = {}
    for dev in ("cpu", "cuda"):
        model = from_paddle_tpu_params(named, cfg, device=dev)
        opt = AdamW(learning_rate=FLEET_LR, parameters=model.parameters(),
                    weight_decay=0.01)
        step = TrainStep(model, _fused_loss, opt)
        single[dev] = ([float(step(batch)) for _ in range(3)],
                       {n: p.detach().cpu()
                        for n, p in model.named_parameters()})
    t0 = time.perf_counter()
    spawn(_fleet_small_rank, (tmp,), nprocs=4, timeout=FLEET_SMALL_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    bad = []
    out = {"gloo_s": gloo_s, "layouts": {}, "launches": {},
           "ce_calls": [r["ce_calls"] for r in ranks],
           "devices": [r["device"] for r in ranks],
           "tolerance": {"loss_rel": 1e-4, "param": FLEET_LR,
                         "cpu_vs_single_loss_rel": 1e-5,
                         "cpu_vs_single_param": FLEET_LR}}
    for r in ranks:
        for k, n in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        if r["backend"] != "gloo" or r["device"] != "cuda:0":
            bad.append(f"rank {r['rank']}: {r['backend']} on {r['device']}")
        for name, rec in r["ce_calls"].items():
            if not rec["ok"]:
                bad.append(f"rank {r['rank']} {name} off its plain version "
                           f"({rec['worst']:.3g})")
        if r["ce_calls"]["ce_stats"]["calls"] == 0:
            bad.append(f"rank {r['rank']}: no ce_stats call checked")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ce_stats"):
        if not out["launches"].get(k):
            bad.append(f"{k} not launched by the ranks")
    for label, (axes, _, _) in FLEET_LAYOUTS.items():
        mp = axes.get("mp", 1)
        full = {dev: gather_paddle_tpu_params(
            [ranks[i]["layouts"][label][dev]["params"] for i in range(mp)])
            for dev in ("cuda", "cpu")}
        losses = {dev: ranks[0]["layouts"][label][dev]["losses"]
                  for dev in ("cuda", "cpu")}
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses["cuda"], losses["cpu"]))
        p_err = max(float(abs(full["cuda"][n] - full["cpu"][n]).max())
                    for n in full["cpu"])
        s_err = max(float((torch.from_numpy(_to_port_layout(
            n, full["cpu"][n]).copy()) - single["cpu"][1][n]).abs().max())
            for n in full["cpu"])
        s_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(losses["cpu"], single["cpu"][0]))
        out["layouts"][label] = {
            "losses": losses, "loss_rel_err": loss_rel,
            "param_max_abs_err": p_err, "cpu_vs_single_param_err": s_err,
            "cpu_vs_single_loss_rel": s_loss,
            "grad_norm": {d: ranks[0]["layouts"][label][d]["grad_norm"]
                          for d in ("cuda", "cpu")}}
        if not (loss_rel <= 1e-4 and p_err <= FLEET_LR
                and s_err <= FLEET_LR and s_loss <= 1e-5):
            bad.append(f"{label}: loss {loss_rel:.3g}, params {p_err:.3g}, "
                       f"CPU vs single {s_err:.3g} / {s_loss:.3g}")
    # a world of one on nccl against the single-process step on the card
    spawn(_fleet_nccl_rank, (tmp,), nprocs=1, timeout=FLEET_SMALL_TIMEOUT_S)
    nccl = _rank_in(tmp, "nccl.pkl")
    n_loss = max(abs(a - b) / abs(b)
                 for a, b in zip(nccl["losses"], single["cuda"][0]))
    n_err = max(float((p - single["cuda"][1][n]).abs().max())
                for n, p in nccl["params"].items())
    out["nccl_world_one"] = {
        "backend": nccl["backend"], "all_reduce": nccl["all_reduce"],
        "losses": nccl["losses"], "single": single["cuda"][0],
        "loss_rel_err": n_loss, "param_max_abs_err": n_err,
        "bit_equal": n_err == 0.0 and nccl["losses"] == single["cuda"][0]}
    if not (nccl["backend"] == "nccl" and n_loss <= 1e-6 and n_err <= 1e-6
            and nccl["all_reduce"] == [0.0, 1.0, 2.0, 3.0]):
        bad.append(f"nccl world of one: {nccl['backend']}, loss "
                   f"{n_loss:.3g}, params {n_err:.3g}")
    # two ranks on one card: nccl (and the default) must raise
    spawn(_fleet_nccl_shared_rank, (tmp,), nprocs=2,
          timeout=FLEET_SMALL_TIMEOUT_S)
    shared = [_rank_in(tmp, f"shared{r}") for r in range(2)]
    out["nccl_shared_card"] = shared
    if not all(len(m) == 2 and all("backend='gloo'" in x for x in m)
               for m in shared):
        bad.append(f"nccl on a shared card did not raise: {shared}")
    report["fleet_cuda_vs_cpu"] = out
    print("fleet_cuda_vs_cpu: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f"fleet_cuda_vs_cpu: {bad}")


def _fleet_full_rank(out_dir, seed):
    """One gloo rank of ``fleet_full_width``: the 7B width at mp 2 x
    sharding 2 (ZeRO-1) from phase 7's weights, sharded; 2 warm-up steps
    with every CE call checked at once, 4 timed steps whose CE calls are
    checked after the timing."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.models import llama_7b_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    _rank_threads()
    env = dist.init_parallel_env(backend="gloo")
    cfg = llama_7b_config(num_hidden_layers=RANKS_LAYERS, dtype="bfloat16")
    t0 = time.perf_counter()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2, "sharding_degree": 2}
    strategy.sharding_configs = {"stage": 1}
    model, hcg = _mp_llama(cfg, strategy, seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                     mesh=hcg.mesh, zero_axis="sharding", zero_stage=1)
    batches = _rank_in(out_dir, "batches.pkl")
    ce = _CeCalls()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, warm_grad_norms = [], []
    for b in batches[:FLEET_WARMUP]:
        losses.append(float(step(b)))
        warm_grad_norms.append(step.last_metrics()["grad_norm"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.defer = True
    collective.reset_stats()
    port_cuda.reset_launch_counts()          # the training path starts here
    times = []
    for b in batches[FLEET_WARMUP:]:
        t1 = time.perf_counter()
        loss = step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    launches = port_cuda.launch_counts()     # ... and ends here
    comm = collective.stats()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ce.defer = False
    ce.check_deferred()
    ce.restore()
    _rank_out(out_dir, f"rank{env.rank}.pkl", {
        "rank": env.rank, "coord": hcg.mesh.coord(),
        "device": str(dist.parallel.current_device()),
        "backend": collective.get_backend(), "setup_s": setup_s,
        "losses": losses, "step_ms": [t * 1e3 for t in times],
        "median_step_ms": statistics.median(times) * 1e3,
        "peak_mem_gb": peak, "launches": launches,
        "launches_per_step": {k: n / FLEET_STEPS
                              for k, n in launches.items() if n},
        "collective_calls_per_step": {k: n / FLEET_STEPS for k, n in
                                      comm["calls"].items()},
        "collective_bytes_per_step": {k: n / FLEET_STEPS for k, n in
                                      comm["bytes"].items()},
        "collective_host_ms_per_step": {k: v * 1e3 / FLEET_STEPS for k, v in
                                        comm["seconds"].items()},
        "warm_grad_norms": warm_grad_norms,
        "grad_norm": step.last_metrics()["grad_norm"],
        "ce_calls": ce.out})
    dist.destroy_process_group()


def _fleet_full_batches(cfg, seed, rows=2, steps=FLEET_WARMUP + FLEET_STEPS):
    """fleet_full_width's batches: step t's `rows` rows (a data rank
    each), step 0's first row phase 7's batch; every 97th label ignored
    and every 101st set 100 below mp rank 1's vocab shard (where a plain
    shift would land on ignore_index)."""
    import numpy as np

    batches = []
    for t in range(steps):
        ids = np.concatenate([np.random.RandomState(seed + rows * t + k)
                              .randint(1, cfg.vocab_size, (1, TRAIN_SEQ + 1))
                              for k in range(rows)])
        labels = ids[:, 1:].copy()
        labels[:, ::97] = -100
        labels[:, 5::101] = cfg.vocab_size // 2 - 100
        batches.append({"input_ids": ids[:, :-1], "labels": labels})
    return batches


def phase_fleet_full_width(args, report):
    """Phase 7's model (the 7B width, RANKS_LAYERS layers, bf16 with fp32
    masters, seq 4096, AdamW, the fused head loss) at mp 2 x sharding 2 (ZeRO-1):
    4 gloo ranks on the one card, 1 x 4096 tokens a rank, a fresh batch a
    step (``_fleet_full_batches``), 2 + 2 steps. Per rank: step ms, peak
    memory, the flash and CE launches and the collectives' calls, bytes
    and host ms a step. These times are 4 ranks time-sharing one card
    through gloo, no multi-GPU figure. Gates, against the single-rank
    model on the same weights and rows (phase 7's model, seeded alike),
    on every rank: the first loss and the second (after one AdamW step)
    within FLEET_LOSS_RTOL, the global gradient norms of steps 0 and 1
    within FLEET_GNORM_RTOL; every CE call of
    every rank within its plain version's rule (``_CeCalls``), the
    kernels launched every step, finite losses."""
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = llama_7b_config(num_hidden_layers=RANKS_LAYERS, dtype="bfloat16")
    batches = _fleet_full_batches(cfg, args.seed)
    # the single-rank model on the same weights and rows: 2 steps
    ref = LlamaForCausalLM(cfg, device="cuda", seed=args.seed)
    ref_step = TrainStep(ref, _fused_loss, AdamW(
        learning_rate=TRAIN_LR, parameters=ref.parameters(),
        weight_decay=0.01, multi_precision=True), collect_metrics=True)
    ref_losses, ref_gnorms = [], []
    for b in batches[:2]:
        ref_losses.append(float(ref_step(b)))
        ref_gnorms.append(ref_step.last_metrics()["grad_norm"])
    ref_loss = ref_losses[0]
    del ref, ref_step
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="fleet_full_")
    _rank_out(tmp, "batches.pkl", batches)
    t0 = time.perf_counter()
    spawn(_fleet_full_rank, (tmp, args.seed), nprocs=4,
          timeout=FLEET_FULL_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    launches = {}
    for r in ranks:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    first = ranks[0]["losses"][0]

    def worst(read, want):
        return max(abs(read(r) - want) / abs(want) for r in ranks)

    out = {"layers": cfg.num_hidden_layers, "seq": TRAIN_SEQ,
           "layout": "mp 2 x sharding 2, ZeRO-1, 4 gloo ranks on one card",
           "wall_s": wall_s, "ref_first_loss": ref_loss,
           "ref_losses": ref_losses, "ref_grad_norms": ref_gnorms,
           "first_loss_rel_err": worst(lambda r: r["losses"][0], ref_loss),
           "second_loss_rel_err": worst(lambda r: r["losses"][1],
                                        ref_losses[1]),
           "grad_norm_rel_errs": [
               worst(lambda r: r["warm_grad_norms"][i], ref_gnorms[i])
               for i in range(2)],
           "launches": launches,
           "ranks": [{k: v for k, v in r.items() if k != "launches"}
                     for r in ranks]}
    report["fleet_full_width"] = out
    for r in out["ranks"]:
        print(f"fleet full width rank {r['rank']} {r['coord']} "
              f"({report.get('gpu')}; 4 ranks time-sharing one card "
              f"through gloo): " + json.dumps(r), flush=True)
    print("fleet full width: " + json.dumps(
        {k: v for k, v in out.items() if k != "ranks"}), flush=True)
    bad = []
    if not out["first_loss_rel_err"] <= FLEET_LOSS_RTOL:
        bad.append(f"first loss {first} vs the single rank's {ref_loss}")
    if not out["second_loss_rel_err"] <= FLEET_LOSS_RTOL:
        bad.append(f"second loss {ranks[0]['losses'][1]} vs the single "
                   f"rank's {ref_losses[1]}")
    if not max(out["grad_norm_rel_errs"]) <= FLEET_GNORM_RTOL:
        bad.append(f"grad norms {ranks[0]['warm_grad_norms']} vs the "
                   f"single rank's {ref_gnorms}")
    layers = cfg.num_hidden_layers
    need = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "ce_stats": 1, "ce_bwd": 1}
    for r in ranks:
        if not all(math.isfinite(x) for x in r["losses"]):
            bad.append(f"rank {r['rank']}: non-finite loss {r['losses']}")
        short = {k: n for k, n in need.items()
                 if r["launches_per_step"].get(k, 0) < n}
        if short:
            bad.append(f"rank {r['rank']}: kernels short a step {short}")
        for name, rec in r["ce_calls"].items():
            if not rec["ok"] or rec["calls"] != FLEET_WARMUP + FLEET_STEPS:
                bad.append(f"rank {r['rank']} {name}: {rec}")
    if bad:
        raise AssertionError(f"fleet_full_width: {bad}")


# ---------------------------------------------------------------------------
# the pipeline (pp): PipelinedTrainStep (1F1B, VPP), ZBH1PipelinedStep and
# fleet's PipelineParallel, a process a rank on gloo
# ---------------------------------------------------------------------------

PIPE_LR = 1e-3               # the tiny CUDA-vs-CPU cases (phase 6's lr)
PIPE_SMALL_TIMEOUT_S = 300
PIPE_FULL_TIMEOUT_S = 480
PIPE_LAYERS = 4              # the full-width run: one layer a stage at pp 4
PIPE_MICRO = 4               # microbatches of 1 x TRAIN_SEQ a step
# 1F1B: 2 warm-up steps (their losses and norms gated), 4 timed and one
# for the peak memory; ZB-H1 the same with 2 timed
# 1F1B 2 + 2 timed steps (2 + 4 until the sep slice's phases needed the
# script's time), ZB-H1 2 timed
PIPE_WARMUP, PIPE_STEPS, PIPE_ZB_STEPS = 2, 2, 2
# the full-width run against the single-rank model (the fleet phase's
# rules): its first two losses and its gradient norms of steps 0 and 1
PIPE_LOSS_RTOL = 7e-5
PIPE_GNORM_RTOL = 1e-4
PIPE_SMALL = {
    "1f1b_pp2_mp2_packed": {"pp": 2, "mp": 2},
    "zbh1_pp4_fleet": {"pp": 4},
    "vpp_pp2_v2_dp2": {"pp": 2, "dp": 2}}


def _pipe_stage(cfg, hcg, n_layers, V, dev, named=None, seed=None):
    """This rank's stage of the LLaMA pipeline on `dev`: {list index:
    module}, weights from `named` (the JAX-layout state, cut by
    ``models.convert``) or drawn per layer from `seed`
    (``seeded_init_``)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers.\
        pp_layers import seeded_init_
    from paddle_tpu_torch.models.convert import (load_pipeline_params,
                                                 pipeline_stage_params)
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               LlamaEmbeddingStage,
                                               LlamaHeadStage)
    from paddle_tpu_torch.parallel.pipeline import stage_block_indices

    S, s = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
    dt = cfg.torch_dtype
    mods = {}
    if s == 0:
        mods[0] = LlamaEmbeddingStage(cfg, device=dev, dtype=dt)
    idx = stage_block_indices(n_layers, S, s, V)
    for i in idx:
        mods[i + 1] = LlamaDecoderLayer(cfg, device=dev, dtype=dt)
    if s == S - 1:
        mods[n_layers + 1] = LlamaHeadStage(cfg, device=dev, dtype=dt)
    if named is not None:
        mp = hcg.get_model_parallel_group()
        load_pipeline_params(mods, pipeline_stage_params(
            named, n_layers, list(mods), mp.rank, mp.nranks))
    else:
        for i, m in mods.items():
            seeded_init_(m.parameters(), seed, i)
    return mods, idx


def _pipe_share(mods):
    return {f"{i}.{n}": p.detach().cpu().clone()
            for i, m in mods.items() for n, p in m.named_parameters()}


def _pipe_small_case(label, axes, named, batch, dev):
    """3 steps of one pipeline_cuda_vs_cpu case on this rank."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer)
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.convert import (load_pipeline_params,
                                                 pipeline_stage_params)
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.pipeline import (PipelinedTrainStep,
                                                    pipeline_hcg)

    cfg = dataclasses.replace(_tiny_gqa_config(),
                              num_hidden_layers=PIPE_LAYERS)
    fleet.reset()
    set_mesh(None)
    if label.startswith("zbh1"):
        # ZB-H1 through fleet: PipelineLayer + distributed_model
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"pp_degree": axes["pp"]}
        strategy.pipeline_configs = {"accumulate_steps": 4,
                                     "schedule_mode": "ZB-H1"}
        hcg = fleet.init(strategy=strategy)
        pipe = PipelineLayer(LlamaForCausalLM.pipeline_layers(cfg),
                             loss_fn=LlamaPretrainingCriterion(cfg),
                             device=dev)
        idx = [i for _, items in pipe.parts() for i, _ in items]
        load_pipeline_params(pipe, pipeline_stage_params(
            named, PIPE_LAYERS, idx))
        model = fleet.distributed_model(pipe)
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=PIPE_LR, parameters=pipe.parameters(),
            weight_decay=0.01))
        data = [batch["input_ids"], batch["labels"]]
        losses = [float(model.train_batch(data, opt)) for _ in range(3)]
        share = {n: p.detach().cpu().clone()
                 for n, p in pipe.named_parameters()}
        return {"coord": hcg.mesh.coord(), "losses": losses,
                "params": share, "mode": model.schedule_mode,
                "zb_stats": model.last_zb_stats}
    mesh = build_mesh(axes)
    hcg, _ = pipeline_hcg(mesh)
    V = 2 if label.startswith("vpp") else 1
    mods, idx = _pipe_stage(cfg, hcg, PIPE_LAYERS, V, dev, named=named)
    mp = hcg.get_model_parallel_group()
    opt = AdamW(learning_rate=PIPE_LR,
                parameters=[p for m in mods.values() for p in m.parameters()],
                weight_decay=0.01)
    step = PipelinedTrainStep(
        mods.get(0), [mods[i + 1] for i in idx], mods.get(PIPE_LAYERS + 1),
        LlamaPretrainingCriterion(cfg, mp), optimizer=opt, mesh=mesh,
        num_micro=2, remat="none", virtual_pp=V)
    kw = ({"segment_ids": batch["segment_ids"],
           "position_ids": batch["position_ids"]} if V == 1 else {})
    losses = [float(step(batch["input_ids"], batch["labels"], **kw))
              for _ in range(3)]
    return {"coord": mesh.coord(), "losses": losses,
            "params": _pipe_share(mods)}


def _pipe_small_rank(out_dir):
    """One gloo rank of ``pipeline_cuda_vs_cpu``: each case on cuda:0 then
    on the CPU, 3 steps from the same weights."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops import cuda as port_cuda

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    env = dist.init_parallel_env(backend="gloo")
    named, batch = _rank_in(out_dir, "inputs.pkl")
    ce = _CeCalls()
    out = {"rank": env.rank, "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend(), "cases": {}}
    launches = {}
    for label, axes in PIPE_SMALL.items():
        out["cases"][label] = {}
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                torch.cuda.synchronize()
                port_cuda.reset_launch_counts()
            res = _pipe_small_case(label, axes, named, batch, dev)
            if dev == "cuda":
                torch.cuda.synchronize()
                got = {k: n for k, n in port_cuda.launch_counts().items()
                       if n}
                res["launches"] = got
                for k, n in got.items():
                    launches[k] = launches.get(k, 0) + n
            out["cases"][label][dev] = res
    # elastic checkpoints: a pipeline save resumed into TrainStep and back
    cfg = dataclasses.replace(_tiny_gqa_config(),
                              num_hidden_layers=PIPE_LAYERS)
    out["resume"] = _ckpt_resume_cases(
        cfg, named, batch, os.path.join(out_dir, "ckpt"),
        ("pp2_dp2", "dp4"), (("pp2_dp2", "dp4"), ("dp4", "pp2_dp2")))
    for k, n in out["resume"]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    ce.restore()
    out["launches"] = launches
    out["ce_calls"] = ce.out
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def phase_pipeline_cuda_vs_cpu(seed, report):
    """4 gloo ranks on cuda:0 against the same 4 ranks on the CPU, phase
    6's tiny fp32 LLaMA at 4 layers (PIPE_LAYERS): 1F1B
    (``PipelinedTrainStep``) at pp 2 x mp 2 on a packed 4 x 256 batch,
    ZB-H1 at pp 4 with 4 microbatches through fleet (``PipelineLayer``,
    ``distributed_model``, ``train_batch``), VPP at pp 2 x V 2 x dp 2; 3
    AdamW steps each. Phase 6's rule: per-step losses within 1e-4
    relative, the parameters gathered over pp and mp within lr; every
    ce_stats call held to its plain version; the flash and CE kernels
    launched by the CUDA ranks; ZB-H1's dW products all on W ticks."""
    import tempfile

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models.convert import gather_pipeline_params

    cfg = dataclasses.replace(_tiny_gqa_config(),
                              num_hidden_layers=PIPE_LAYERS)
    named = _fleet_named(cfg, seed)
    batch = _packed_batch(seed, cfg.vocab_size, 256, 4)
    tmp = tempfile.mkdtemp(prefix="pipe_small_")
    _rank_out(tmp, "inputs.pkl", (named, batch))
    t0 = time.perf_counter()
    spawn(_pipe_small_rank, (tmp,), nprocs=4, timeout=PIPE_SMALL_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    bad = []
    out = {"gloo_s": gloo_s, "cases": {}, "launches": {},
           "ce_calls": [r["ce_calls"] for r in ranks],
           "tolerance": {"loss_rel": 1e-4, "param": PIPE_LR}}
    for r in ranks:
        for k, n in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        if r["backend"] != "gloo" or r["device"] != "cuda:0":
            bad.append(f"rank {r['rank']}: {r['backend']} on {r['device']}")
        for name, rec in r["ce_calls"].items():
            if not rec["ok"]:
                bad.append(f"rank {r['rank']} {name} off its plain version "
                           f"({rec['worst']:.3g})")
    if not any(r["ce_calls"]["ce_stats"]["calls"] for r in ranks):
        bad.append("no ce_stats call checked")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ce_stats"):
        if not out["launches"].get(k):
            bad.append(f"{k} not launched by the ranks")
    for label in PIPE_SMALL:
        res = {dev: [r["cases"][label][dev] for r in ranks]
               for dev in ("cuda", "cpu")}
        full = {}
        for dev, rs in res.items():
            S = max(x["coord"]["pp"] for x in rs) + 1
            stages = [[x["params"] for x in sorted(
                (x for x in rs if x["coord"]["pp"] == st
                 and x["coord"].get("dp", 0) == 0),
                key=lambda x: x["coord"].get("mp", 0))] for st in range(S)]
            full[dev] = gather_pipeline_params(stages, PIPE_LAYERS)
        loss_rel = max(abs(a - b) / abs(b) for c, p in zip(res["cuda"],
                                                           res["cpu"])
                       for a, b in zip(c["losses"], p["losses"]))
        p_err = max(float(abs(full["cuda"][n] - full["cpu"][n]).max())
                    for n in full["cpu"])
        agree = all(x["losses"] == res["cuda"][0]["losses"]
                    for x in res["cuda"])
        out["cases"][label] = {
            "losses": {d: res[d][0]["losses"] for d in res},
            "loss_rel_err": loss_rel, "param_max_abs_err": p_err,
            "ranks_agree": agree,
            "launches": [x["launches"] for x in res["cuda"]]}
        if label.startswith("zbh1"):
            st = [x["zb_stats"] for x in res["cuda"]]
            out["cases"][label]["zb_stats"] = [
                {k: v for k, v in s_.items() if k != "w_ticks"} for s_ in st]
            if not all(x["mode"] == "ZBH1" for x in res["cuda"]) or not all(
                    s_["queued"] == s_["w_ran"] and s_["b_touched"] == 0
                    for s_ in st):
                bad.append(f"{label}: ZB-H1 did not run its W ticks: {st}")
        if not (loss_rel <= 1e-4 and p_err <= PIPE_LR and agree):
            bad.append(f"{label}: loss {loss_rel:.3g}, params {p_err:.3g}, "
                       f"ranks agree {agree}")
    out["resume"] = _ckpt_resume_check(ranks, os.path.join(tmp, "ckpt"),
                                       PIPE_LR, bad)
    report["pipeline_cuda_vs_cpu"] = out
    print("pipeline_cuda_vs_cpu: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f"pipeline_cuda_vs_cpu: {bad}")


def _pipe_full_batches(cfg, seed, steps):
    """pipeline_full_width's batches: step t's PIPE_MICRO rows of
    TRAIN_SEQ tokens (a fresh batch a step; every 97th label ignored)."""
    import numpy as np

    batches = []
    for t in range(steps):
        ids = np.concatenate([np.random.RandomState(seed + 7 * t + m).randint(
            1, cfg.vocab_size, (1, TRAIN_SEQ + 1))
            for m in range(PIPE_MICRO)])
        labels = ids[:, 1:].copy()
        labels[:, ::97] = -100
        batches.append({"input_ids": ids[:, :-1], "labels": labels})
    return batches


def _pipe_full_run(kind, cfg, hcg, mesh, seed, batches, ce, warm, timed):
    """One schedule on this rank at the full width: `warm` steps whose CE
    calls are checked at once, `timed` steps whose CE calls are checked
    after the timing (their inputs kept on the card), then one step for
    the peak memory whose CE calls' inputs are kept in host memory (the
    checks' copies stay out of the peak). Every step's loss and hybrid
    gradient norm are read after it."""
    import torch

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.pipeline import PipelinedTrainStep
    from paddle_tpu_torch.parallel.pipeline_schedules import (
        bubble_fraction, one_f_one_b_schedule, peak_activations,
        zb_h1_schedule)
    from paddle_tpu_torch.parallel.zero_bubble import ZBH1PipelinedStep

    t0 = time.perf_counter()
    mods, idx = _pipe_stage(cfg, hcg, PIPE_LAYERS, 1, "cuda", seed=seed)
    opt = AdamW(learning_rate=TRAIN_LR,
                parameters=[p for m in mods.values() for p in m.parameters()],
                weight_decay=0.01, multi_precision=True)
    args = (mods.get(0), [mods[i + 1] for i in idx],
            mods.get(PIPE_LAYERS + 1), LlamaPretrainingCriterion(cfg))
    if kind == "1f1b":
        step = PipelinedTrainStep(*args, optimizer=opt, mesh=mesh,
                                  num_micro=PIPE_MICRO, remat="none")
        sched = one_f_one_b_schedule(hcg.get_pipe_parallel_world_size(),
                                     PIPE_MICRO)
    else:
        step = ZBH1PipelinedStep(*args, optimizer=opt, mesh=mesh,
                                 num_micro=PIPE_MICRO)
        sched = zb_h1_schedule(hcg.get_pipe_parallel_world_size(),
                               PIPE_MICRO)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    s = hcg.get_stage_id()
    losses, norms, per_step, times = [], [], [], []
    for i, b in enumerate(batches[:warm + timed + 1]):
        if i < warm:
            port_cuda.reset_launch_counts()
        elif i == warm:
            ce.defer = True
            collective.reset_stats()
            port_cuda.reset_launch_counts()  # the training path starts here
        else:
            if i == warm + timed:
                launches = port_cuda.launch_counts()  # ... and ends here
                comm = collective.stats()
                # the timed steps' checks, then a step whose checks keep
                # their copies in host memory: its peak is the pipeline's
                ce.defer = False
                ce.check_deferred()
                ce.defer = ce.host = True
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        loss = step(b["input_ids"], b["labels"])
        torch.cuda.synchronize()
        if warm <= i < warm + timed:
            times.append(time.perf_counter() - t1)
        losses.append(float(loss))
        norms.append(float(step.optimizer.last_grad_norm))
        if i < warm:
            per_step.append(port_cuda.launch_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    ce.defer = ce.host = False
    ce.check_deferred()
    n = len(times)
    out = {"setup_s": setup_s, "losses": losses, "grad_norms": norms,
           "warm_launches": per_step,
           "step_ms": [t * 1e3 for t in times],
           "median_step_ms": statistics.median(times) * 1e3,
           "peak_mem_gb": peak, "launches": launches,
           "launches_per_step": {k: v / n for k, v in launches.items()
                                 if v},
           "p2p_calls_per_step": {k: comm["calls"].get(k, 0) / n
                                  for k in ("send", "recv")},
           "p2p_bytes_per_step": {k: comm["bytes"].get(k, 0) / n
                                  for k in ("send", "recv")},
           "p2p_host_ms_per_step": comm["seconds"].get("p2p", 0.0) * 1e3
           / n,
           "collective_host_ms_per_step": {
               k: v * 1e3 / n for k, v in comm["seconds"].items()},
           "peak_activations": peak_activations(sched, s),
           "bubble_fraction": bubble_fraction(sched, s),
           "stage_layers": [i for i in mods if 0 < i <= PIPE_LAYERS]}
    if kind == "zbh1":
        out["zb_stats"] = {k: v for k, v in step.last_stats.items()
                           if k != "w_ticks"}
    del step, opt, mods
    torch.cuda.empty_cache()
    return out


def _pipe_full_rank(out_dir, seed):
    """One gloo rank of ``pipeline_full_width``: its stage at the 7B width
    (one decoder layer; the embedding on stage 0, the head on stage 3),
    1F1B, then ZB-H1 from the same initial weights (``_pipe_full_run``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import llama_7b_config
    from paddle_tpu_torch.parallel.pipeline import pipeline_hcg

    _rank_threads()
    env = dist.init_parallel_env(backend="gloo")
    cfg = llama_7b_config(num_hidden_layers=PIPE_LAYERS, dtype="bfloat16")
    fleet.reset()
    mesh = build_mesh({"pp": 4})
    hcg, _ = pipeline_hcg(mesh)
    batches = _rank_in(out_dir, "batches.pkl")
    ce = _CeCalls()
    out = {"rank": env.rank, "coord": mesh.coord(),
           "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend()}
    out["1f1b"] = _pipe_full_run("1f1b", cfg, hcg, mesh, seed, batches, ce,
                                 PIPE_WARMUP, PIPE_STEPS)
    ce_1f1b = {k: dict(v, errs=None, fp64=None) for k, v in ce.out.items()}
    out["zbh1"] = _pipe_full_run("zbh1", cfg, hcg, mesh, seed, batches, ce,
                                 PIPE_WARMUP, PIPE_ZB_STEPS)
    ce.restore()
    out["ce_calls_after_1f1b"] = ce_1f1b
    out["ce_calls"] = ce.out
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def _pipe_reference(cfg, seed, batches):
    """The single-rank model on the same weights (drawn per layer as the
    stages draw them) and rows: its first two steps' losses (the mean of
    the microbatch losses) and gradient norms, the microbatches' gradients
    accumulated as the pipeline accumulates them."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers.\
        pp_layers import seeded_init_
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import global_norm
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(cfg, device="cuda")
    seeded_init_([model.llama.embed_tokens.weight], seed, 0)
    for i, layer in enumerate(model.llama.layers):
        seeded_init_(layer.parameters(), seed, i + 1)
    seeded_init_([model.llama.norm.weight, model.lm_head.weight], seed,
                 PIPE_LAYERS + 1)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    losses, norms = [], []
    for b in batches[:2]:
        opt.clear_grad()
        total = 0.0
        for m in range(PIPE_MICRO):
            ids = torch.from_numpy(b["input_ids"][m:m + 1]).cuda()
            lab = torch.from_numpy(b["labels"][m:m + 1]).cuda()
            loss = model(ids, labels=lab).float()
            (loss / PIPE_MICRO).backward()
            total += float(loss.detach())
        losses.append(total / PIPE_MICRO)
        norms.append(float(global_norm([p.grad for p in model.parameters()
                                        if p.grad is not None])))
        opt.step()
    del model, opt
    return losses, norms


def phase_pipeline_full_width(args, report):
    """The 7B width at PIPE_LAYERS layers, bf16 with fp32 masters, seq
    4096, AdamW, the fused head loss, at pp 4 (one decoder layer a stage):
    4 gloo ranks on the one card, PIPE_MICRO microbatches of 1 x 4096 a
    step, a fresh batch a step. 1F1B (``PipelinedTrainStep``): PIPE_WARMUP
    steps, PIPE_STEPS timed, one for the peak memory; then ZB-H1
    (``ZBH1PipelinedStep``) the same with PIPE_ZB_STEPS timed, from the
    same initial weights. Per rank: step ms, peak memory (its CE checks'
    copies in host memory) beside the schedule's peak activations, the
    flash and CE
    launches and the p2p calls, bytes and host ms a step. These are 4
    ranks time-sharing one card through gloo: no multi-GPU figure. Gates,
    on every rank, against the single-rank model on the same weights and
    rows: each schedule's first two losses within PIPE_LOSS_RTOL and its
    gradient norms of steps 0 and 1 within PIPE_GNORM_RTOL; every CE call
    within its plain version's rule; the flash kernels launched for every
    layer and microbatch of every step and the CE kernels for every
    microbatch on the last stage; finite losses; ZB-H1's dW products all
    on W ticks."""
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models import llama_7b_config

    cfg = llama_7b_config(num_hidden_layers=PIPE_LAYERS, dtype="bfloat16")
    batches = _pipe_full_batches(cfg, args.seed,
                                 PIPE_WARMUP + PIPE_STEPS + 1)
    ref_losses, ref_norms = _pipe_reference(cfg, args.seed, batches)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pipe_full_")
    _rank_out(tmp, "batches.pkl", batches)
    t0 = time.perf_counter()
    spawn(_pipe_full_rank, (tmp, args.seed), nprocs=4,
          timeout=PIPE_FULL_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    launches = {}
    for r in ranks:
        for k, n in r["1f1b"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    bad = []
    out = {"layers": cfg.num_hidden_layers, "seq": TRAIN_SEQ,
           "micro": PIPE_MICRO,
           "layout": "pp 4, one decoder layer a stage, 4 gloo ranks on one "
                     "card", "wall_s": wall_s, "ref_losses": ref_losses,
           "ref_grad_norms": ref_norms, "launches": launches, "gaps": {}}
    for kind in ("1f1b", "zbh1"):
        def worst(read, want):
            return max(abs(read(r[kind]) - want) / abs(want) for r in ranks)

        gaps = {"loss": [worst(lambda x, i=i: x["losses"][i], ref_losses[i])
                         for i in range(2)],
                "grad_norm": [worst(lambda x, i=i: x["grad_norms"][i],
                                    ref_norms[i]) for i in range(2)]}
        out["gaps"][kind] = gaps
        if not max(gaps["loss"]) <= PIPE_LOSS_RTOL:
            bad.append(f"{kind}: losses {ranks[0][kind]['losses'][:2]} vs "
                       f"the single rank's {ref_losses}")
        if not max(gaps["grad_norm"]) <= PIPE_GNORM_RTOL:
            bad.append(f"{kind}: grad norms {ranks[0][kind]['grad_norms']} "
                       f"vs the single rank's {ref_norms}")
    out["ranks"] = [{k: v for k, v in r.items()} for r in ranks]
    report["pipeline_full_width"] = out
    for r in ranks:
        for kind in ("1f1b", "zbh1"):
            print(f"pipeline full width rank {r['rank']} {kind} "
                  f"({report.get('gpu')}; 4 ranks time-sharing one card "
                  f"through gloo): " + json.dumps(
                      {k: v for k, v in r[kind].items()
                       if k != "warm_launches"}), flush=True)
    print("pipeline full width: " + json.dumps(
        {k: v for k, v in out.items() if k != "ranks"}), flush=True)
    for r in ranks:
        last = r["coord"]["pp"] == 3
        layers = len(r["1f1b"]["stage_layers"])
        need = {"flash_fwd": layers * PIPE_MICRO,
                "flash_bwd_dq": layers * PIPE_MICRO,
                "flash_bwd_dkv": layers * PIPE_MICRO}
        if last:
            need.update(ce_stats=PIPE_MICRO, ce_bwd=PIPE_MICRO)
        for kind in ("1f1b", "zbh1"):
            run = r[kind]
            if not all(math.isfinite(x) for x in run["losses"]):
                bad.append(f"rank {r['rank']} {kind}: non-finite loss "
                           f"{run['losses']}")
            per_step = list(run["warm_launches"]) + [
                run["launches_per_step"]]
            for i, got in enumerate(per_step):
                short = {k: v for k, v in need.items() if got.get(k, 0) < v}
                if short:
                    bad.append(f"rank {r['rank']} {kind} step {i}: kernels "
                               f"short {short}")
        st = r["zbh1"]["zb_stats"]
        if not (st["queued"] == st["w_ran"] > 0 and st["b_touched"] == 0):
            bad.append(f"rank {r['rank']}: ZB-H1 deferral {st}")
        want_calls = (2 * PIPE_WARMUP + PIPE_STEPS + PIPE_ZB_STEPS
                      + 2) * PIPE_MICRO if last else 0
        for name, rec in r["ce_calls"].items():
            if not rec["ok"] or rec["calls"] != want_calls:
                bad.append(f"rank {r['rank']} {name}: ok {rec['ok']}, "
                           f"{rec['calls']} calls of {want_calls}")
    if bad:
        raise AssertionError(f"pipeline_full_width: {bad}")


# ---------------------------------------------------------------------------
# ZeRO-3: parameter sharding (group-sharded stage 3, the gather-ahead layer
# loop, ZeRO inside a pipeline stage), a process a rank on gloo
# ---------------------------------------------------------------------------

ZERO3_LAYERS = 4             # the tiny model: the loop's 2-layer bound bites
ZERO3_OUTER = 3              # units outside the loop: embedding, norm, head
ZERO3_SMALL_TIMEOUT_S = 300
ZERO3_FULL_TIMEOUT_S = 600
ZERO3_SMALL = {              # label: (route, mesh axes, gather mode)
    "sharding4_ahead": ("train_step", {"sharding": 4}, "ahead"),
    "sharding4_start": ("train_step", {"sharding": 4}, "start"),
    "dp2_sharding2": ("train_step", {"dp": 2, "sharding": 2}, "ahead"),
    "mp2_sharding2": ("train_step", {"sharding": 2, "mp": 2}, "ahead"),
    "1f1b_pp2_sharding2": ("1f1b", {"pp": 2, "sharding": 2}, "ahead"),
    "zbh1_pp2_sharding2": ("zbh1", {"pp": 2, "sharding": 2}, None),
    "group_sharded_p_g_os": ("group_sharded", {"dp": 4}, "ahead")}
# the full-width run: 2 warm-up steps, the first at 'start' and the second
# at 'ahead' (both held to the single rank's losses and norms); 'ahead' 1
# timed (3 until the sep slice's phases needed the script's time), 1 for
# the peak memory; 'start' one step, timed and giving the
# peak (kept short: the script's time limit); ZeRO-2 (the yardstick) its
# first step timed, its second (its optimizer state made) for the peak
ZERO3_WARM_MODES = ("start", "ahead")
ZERO3_WARMUP, ZERO3_AHEAD, ZERO3_START, ZERO3_Z2 = 2, 1, 1, 1


def _zero3_small_case(label, named, batch, dev):
    """3 steps of one zero3_cuda_vs_cpu case on this rank: (losses, full
    parameters, the sharder's readings)."""
    import torch

    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import from_paddle_tpu_params
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep
    from paddle_tpu_torch.parallel.pipeline import (PipelinedTrainStep,
                                                    pipeline_hcg)
    from paddle_tpu_torch.parallel.zero_bubble import ZBH1PipelinedStep

    route, axes, mode = ZERO3_SMALL[label]
    cfg = dataclasses.replace(_tiny_gqa_config(),
                              num_hidden_layers=ZERO3_LAYERS)
    fleet.reset()
    set_mesh(None)
    mesh = build_mesh(axes)
    if route in ("train_step", "group_sharded"):
        model = from_paddle_tpu_params(named, cfg, device=dev)
        opt = AdamW(learning_rate=FLEET_LR, parameters=model.parameters(),
                    weight_decay=0.01)
    if route == "train_step":
        step = TrainStep(model, _fused_loss, opt, mesh=mesh,
                         zero_axis="sharding", zero_stage=3,
                         zero3_gather=mode)
        sh = step._zero3

        def run():
            return float(step(batch))

        def full():
            return step.model.state_dict()
    elif route == "group_sharded":
        m, o, _ = group_sharded_parallel(model, opt, "p_g_os")
        sh = m.sharder
        r = mesh.coord()["dp"]
        mine = {k: torch.from_numpy(v[r:r + 1]).to(dev)
                for k, v in batch.items()}

        def run():
            loss = m(**mine)
            loss.backward()
            o.step()
            o.clear_grad()
            mean = loss.detach().float().clone()
            collective.all_reduce(mean, collective.ReduceOp.AVG)
            return float(mean)

        def full():
            return m.state_dict()
    else:
        hcg, _ = pipeline_hcg(mesh)
        mods, idx = _pipe_stage(cfg, hcg, ZERO3_LAYERS, 1, dev, named=named)
        opt = AdamW(learning_rate=FLEET_LR,
                    parameters=[p for q in mods.values()
                                for p in q.parameters()],
                    weight_decay=0.01)
        cls = PipelinedTrainStep if route == "1f1b" else ZBH1PipelinedStep
        step = cls(mods.get(0), [mods[i + 1] for i in idx],
                   mods.get(ZERO3_LAYERS + 1), LlamaPretrainingCriterion(cfg),
                   optimizer=opt, mesh=mesh, num_micro=2,
                   zero_axis="sharding")
        sh = step.sharder
        kw = {"segment_ids": batch["segment_ids"],
              "position_ids": batch["position_ids"]}

        def run():
            return float(step(batch["input_ids"], batch["labels"], **kw))

        def full():
            share = {f"{i}.{n}": p.detach() for i, q in mods.items()
                     if i in (0, ZERO3_LAYERS + 1)
                     for n, p in q.named_parameters()}
            blocks = sh.full_state()
            for j, i in enumerate(idx):
                pre = f"block{j}."
                share.update({f"{i + 1}.{n[len(pre):]}": v
                              for n, v in blocks.items()
                              if n.startswith(pre)})
            return share
    losses, peaks = [], []
    for _ in range(3):
        sh.reset_peak()
        losses.append(run())
        peaks.append(sh.peak_units)
    gc.collect()
    return {"coord": mesh.coord(), "losses": losses,
            "params": {n: v.detach().cpu().clone() for n, v in full().items()},
            "peaks": peaks, "live": sh.live_units,
            "alive": sh.alive_buffers(), "resident": sh.resident_bytes(),
            "full": sh.full_bytes(),
            "buckets": sum(len(u.buckets) for u in sh.units),
            "units": len(sh.units), "loop_units": len(sh.loop_units)}


def _zero3_small_rank(out_dir):
    """One gloo rank of ``zero3_cuda_vs_cpu``: each case on cuda:0 then on
    the CPU, 3 steps from the same weights."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops import cuda as port_cuda

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    env = dist.init_parallel_env(backend="gloo")
    named, batch = _rank_in(out_dir, "inputs.pkl")
    ce = _CeCalls()
    out = {"rank": env.rank, "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend(), "cases": {}}
    launches = {}
    for label in ZERO3_SMALL:
        out["cases"][label] = {}
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                torch.cuda.synchronize()
                port_cuda.reset_launch_counts()
            res = _zero3_small_case(label, named, batch, dev)
            if dev == "cuda":
                torch.cuda.synchronize()
                got = {k: n for k, n in port_cuda.launch_counts().items()
                       if n}
                res["launches"] = got
                for k, n in got.items():
                    launches[k] = launches.get(k, 0) + n
            out["cases"][label][dev] = res
    # elastic checkpoints: a ZeRO-3 save resumed replicated and back, an
    # mp 2 save resumed at mp 1
    cfg = dataclasses.replace(_tiny_gqa_config(),
                              num_hidden_layers=ZERO3_LAYERS)
    out["resume"] = _ckpt_resume_cases(
        cfg, named, batch, os.path.join(out_dir, "ckpt"),
        ("zero3_sharding4", "dp4", "mp2_dp2"),
        (("zero3_sharding4", "dp4"), ("dp4", "zero3_sharding4"),
         ("mp2_dp2", "dp4")))
    for k, n in out["resume"]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    ce.restore()
    out["launches"] = launches
    out["ce_calls"] = ce.out
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def _zero3_holds(res, route, mode, n):
    """The ZeRO-3 readings of one rank's case: (ok, why)."""
    pad = res["buckets"] * n * 4
    why = []
    if not res["full"] <= res["resident"] * n <= res["full"] + pad:
        why.append(f"resident {res['resident']} of {res['full']} bytes")
    if res["live"] or res["alive"]:
        why.append(f"{res['live']} units, {res['alive']} buffers left")
    loop = res["loop_units"]
    if route in ("train_step", "group_sharded"):
        want = 2 + ZERO3_OUTER if mode == "ahead" else loop + ZERO3_OUTER
        if max(res["peaks"]) != want:
            why.append(f"peak units {res['peaks']}, not {want}")
    elif max(res["peaks"]) > res["units"]:
        why.append(f"peak units {res['peaks']} past the stage's "
                   f"{res['units']} blocks")
    return not why, why


def phase_zero3_cuda_vs_cpu(seed, report):
    """4 gloo ranks on cuda:0 against the same 4 ranks on the CPU, phase
    6's tiny fp32 LLaMA at 4 layers (ZERO3_LAYERS), ZeRO-3, 3 AdamW steps
    on one packed 4 x 256 batch each: ``TrainStep(zero_stage=3)`` at
    sharding 4 ('ahead' and 'start'), dp 2 x sharding 2 and mp 2 x
    sharding 2; 1F1B and ZB-H1 with ``zero_axis="sharding"`` at pp 2 x
    sharding 2; ``group_sharded_parallel(level="p_g_os")``'s eager loop at
    dp 4 (a row a rank). Phase 6's rule: per-step losses within 1e-4
    relative, the gathered parameters within lr; every ce_stats call held
    to its plain version (the fp32 model's CE backward takes its fp32
    route, so ce_bwd does not launch here); the flash and ce_stats
    kernels launched by the CUDA ranks; on every rank and device the
    shards 1/N of the units plus the padding, no full buffer left after a
    step, and the gathered units' peak 2 layers plus the outer units at
    'ahead', the whole stack at 'start' (at most a stage's blocks under
    pp)."""
    import tempfile

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models import gather_paddle_tpu_params
    from paddle_tpu_torch.models.convert import gather_pipeline_params

    cfg = dataclasses.replace(_tiny_gqa_config(),
                              num_hidden_layers=ZERO3_LAYERS)
    named = _fleet_named(cfg, seed)
    batch = _packed_batch(seed, cfg.vocab_size, 256, 4)
    tmp = tempfile.mkdtemp(prefix="zero3_small_")
    _rank_out(tmp, "inputs.pkl", (named, batch))
    t0 = time.perf_counter()
    spawn(_zero3_small_rank, (tmp,), nprocs=4, timeout=ZERO3_SMALL_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    bad = []
    out = {"gloo_s": gloo_s, "cases": {}, "launches": {},
           "ce_calls": [r["ce_calls"] for r in ranks],
           "tolerance": {"loss_rel": 1e-4, "param": FLEET_LR}}
    for r in ranks:
        for k, n in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        if r["backend"] != "gloo" or r["device"] != "cuda:0":
            bad.append(f"rank {r['rank']}: {r['backend']} on {r['device']}")
        for name, rec in r["ce_calls"].items():
            if not rec["ok"]:
                bad.append(f"rank {r['rank']} {name} off its plain version "
                           f"({rec['worst']:.3g})")
        if r["ce_calls"]["ce_stats"]["calls"] == 0:
            bad.append(f"rank {r['rank']}: no ce_stats call checked")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ce_stats"):
        if not out["launches"].get(k):
            bad.append(f"{k} not launched by the ranks")
    for label, (route, axes, mode) in ZERO3_SMALL.items():
        res = {dev: [r["cases"][label][dev] for r in ranks]
               for dev in ("cuda", "cpu")}
        full = {}
        for dev, rs in res.items():
            if route in ("1f1b", "zbh1"):
                full[dev] = gather_pipeline_params(
                    [next(x["params"] for x in rs
                          if x["coord"] == {"pp": st, "sharding": 0})
                     for st in range(2)], ZERO3_LAYERS)
            else:
                # the mp ranks of the first data replica
                mine = sorted((x for x in rs
                               if x["coord"].get("sharding", 0) == 0
                               and x["coord"].get("dp", 0) == 0),
                              key=lambda x: x["coord"].get("mp", 0))
                full[dev] = gather_paddle_tpu_params(
                    [x["params"] for x in mine])
        loss_rel = max(abs(a - b) / abs(b) for c, p in zip(res["cuda"],
                                                           res["cpu"])
                       for a, b in zip(c["losses"], p["losses"]))
        p_err = max(float(abs(full["cuda"][n] - full["cpu"][n]).max())
                    for n in full["cpu"])
        agree = all(x["losses"] == res["cuda"][0]["losses"]
                    for x in res["cuda"])
        n = axes.get("sharding", axes.get("dp", 1))
        holds = [_zero3_holds(x, route, mode, n)
                 for dev in res for x in res[dev]]
        out["cases"][label] = {
            "losses": {d: res[d][0]["losses"] for d in res},
            "loss_rel_err": loss_rel, "param_max_abs_err": p_err,
            "ranks_agree": agree,
            "peak_units": res["cuda"][0]["peaks"],
            "resident_bytes": res["cuda"][0]["resident"],
            "unit_bytes": res["cuda"][0]["full"],
            "launches": [x["launches"] for x in res["cuda"]]}
        if not (loss_rel <= 1e-4 and p_err <= FLEET_LR and agree):
            bad.append(f"{label}: loss {loss_rel:.3g}, params {p_err:.3g}, "
                       f"ranks agree {agree}")
        bad += [f"{label}: {why}" for ok, why in holds if not ok]
    out["resume"] = _ckpt_resume_check(ranks, os.path.join(tmp, "ckpt"),
                                       FLEET_LR, bad)
    report["zero3_cuda_vs_cpu"] = out
    print("zero3_cuda_vs_cpu: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f"zero3_cuda_vs_cpu: {bad}")


def _zero3_mode(step, sharder, batches, ce, timed, peak_apart=True):
    """`timed` timed steps of `step` (their CE calls checked after the
    timing), then, with `peak_apart`, one for the peak memory (its CE
    checks' copies in host memory); without it the timed steps keep their
    copies in host memory themselves and give the peak (their time then
    includes the copies): step ms, peak memory, the gathered units' peak,
    launches and the collectives' calls, bytes and host ms a timed
    step."""
    import torch

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops import cuda as port_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.defer = True
    ce.host = not peak_apart
    collective.reset_stats()
    if sharder is not None:
        sharder.reset_peak()
    port_cuda.reset_launch_counts()          # the training path starts here
    losses, times = [], []
    for i, b in enumerate(batches[:timed + int(peak_apart)]):
        if i == timed:
            launches = port_cuda.launch_counts()     # ... and ends here
            comm = collective.stats()
            units = sharder.peak_units if sharder is not None else None
            ce.defer = False
            ce.check_deferred()
            ce.defer = ce.host = True
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        loss = step(b)
        torch.cuda.synchronize()
        if i < timed:
            times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    if not peak_apart:
        launches = port_cuda.launch_counts()     # ... and ends here
        comm = collective.stats()
        units = sharder.peak_units if sharder is not None else None
    peak = torch.cuda.max_memory_allocated() / 1e9
    ce.defer = ce.host = False
    ce.check_deferred()
    gc.collect()
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "median_step_ms": statistics.median(times) * 1e3,
            "peak_mem_gb": peak, "peak_units": units,
            "live_units": sharder.live_units if sharder else None,
            "alive_buffers": sharder.alive_buffers() if sharder else None,
            "launches": launches,
            "launches_per_step": {k: v / timed for k, v in launches.items()
                                  if v},
            "collective_calls_per_step": {k: v / timed for k, v in
                                          comm["calls"].items()},
            "collective_bytes_per_step": {k: v / timed for k, v in
                                          comm["bytes"].items()},
            "collective_host_ms_per_step": {k: v * 1e3 / timed for k, v in
                                            comm["seconds"].items()}}


def _zero3_full_rank(out_dir, seed):
    """One gloo rank of ``zero3_full_width``: phase 7's model at sharding
    4, ZeRO-3, the warm-up steps at ZERO3_WARM_MODES, then 'ahead' and
    'start' on the same step (its gather schedule set through
    ``GroupShardedStage3.zero3_gather``), then ZeRO-2 at sharding 4 from
    the same initial weights."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    _rank_threads()
    env = dist.init_parallel_env(backend="gloo")
    cfg = llama_7b_config(num_hidden_layers=RANKS_LAYERS, dtype="bfloat16")
    batches = _rank_in(out_dir, "batches.pkl")
    ce = _CeCalls()
    fleet.reset()
    mesh = build_mesh({"sharding": 4})
    out = {"rank": env.rank, "coord": mesh.coord(),
           "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend()}
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                     mesh=mesh, zero_axis="sharding", zero_stage=3,
                     zero3_gather="ahead")
    sh = step._zero3
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out.update(setup_s=time.perf_counter() - t0,
               resident_param_bytes=sh.resident_bytes(),
               unit_param_bytes=sh.full_bytes(),
               buckets=sum(len(u.buckets) for u in sh.units),
               param_storage_bytes=sum(p.untyped_storage().nbytes()
                                       for p in model.parameters()),
               allocated_gb_after_setup=torch.cuda.memory_allocated() / 1e9)
    losses, norms, warm, warm_units = [], [], [], []
    for mode, b in zip(ZERO3_WARM_MODES, batches[:ZERO3_WARMUP]):
        step.model.zero3_gather = mode
        port_cuda.reset_launch_counts()
        sh.reset_peak()
        losses.append(float(step(b)))
        norms.append(step.last_metrics()["grad_norm"])
        torch.cuda.synchronize()
        warm.append(port_cuda.launch_counts())
        warm_units.append(sh.peak_units)
    out.update(warm_modes=list(ZERO3_WARM_MODES), warm_losses=losses,
               warm_grad_norms=norms, warm_launches=warm,
               warm_peak_units=warm_units,
               allocated_gb_after_warmup=torch.cuda.memory_allocated() / 1e9)
    k = ZERO3_WARMUP
    step.model.zero3_gather = "ahead"
    out["ahead"] = _zero3_mode(step, sh, batches[k:], ce, ZERO3_AHEAD)
    k += ZERO3_AHEAD + 1
    step.model.zero3_gather = "start"
    out["start"] = _zero3_mode(step, sh, batches[k:], ce, ZERO3_START,
                               peak_apart=False)
    del step, opt, model, sh
    gc.collect()
    torch.cuda.empty_cache()
    # the memory yardstick: ZeRO-2 over the same 4 ranks
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, _fused_loss, opt, mesh=mesh,
                     zero_axis="sharding", zero_stage=2)
    out["zero2"] = _zero3_mode(step, None, batches, ce, ZERO3_Z2)
    ce.restore()
    out["ce_calls"] = ce.out
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def _zero3_reference(cfg, seed, batches, rows):
    """The single-rank model on the same weights (phase 7's) and rows: its
    first two steps' losses (the mean of the rows' losses) and gradient
    norms, the rows' gradients accumulated a row at a time."""
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import global_norm
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    losses, norms = [], []
    for b in batches[:2]:
        opt.clear_grad()
        total = 0.0
        for m in range(rows):
            ids = torch.from_numpy(b["input_ids"][m:m + 1]).cuda()
            lab = torch.from_numpy(b["labels"][m:m + 1]).cuda()
            loss = model(ids, labels=lab).float()
            (loss / rows).backward()
            total += float(loss.detach())
        losses.append(total / rows)
        norms.append(float(global_norm([p.grad for p in model.parameters()
                                        if p.grad is not None])))
        opt.step()
    del model, opt
    return losses, norms


def phase_zero3_full_width(args, report):
    """Phase 7's model (the 7B width, RANKS_LAYERS layers, bf16 with fp32
    masters, seq 4096, AdamW, the fused head loss) at sharding 4 with ZeRO-3: 4 gloo
    ranks on the one card, 1 x 4096 tokens a rank, a fresh batch a step
    (``_fleet_full_batches`` at 4 rows). ZERO3_WARMUP steps, the first at
    'start' and the second at 'ahead'; 'ahead' ZERO3_AHEAD timed, one for
    the peak memory; then 'start' on the same step, ZERO3_START step,
    timed and giving its peak at once; then
    ZeRO-2 at sharding 4 from the same initial weights, the memory
    yardstick, ZERO3_Z2 timed step and one for the peak. Per rank:
    step ms, peak memory per mode (its CE checks' copies in host memory),
    the gathered units' peak, the resident parameter bytes, the flash and
    CE launches, and the all-gathers' and reduce-scatters' calls, bytes and
    host ms a step. These are 4 ranks time-sharing one card through gloo:
    no multi-GPU figure. Gates, on every rank: the first two losses (one
    a mode) within FLEET_LOSS_RTOL and the gradient norms of steps 0 and
    1 within FLEET_GNORM_RTOL of the single-rank model's on the same
    weights and rows; the shards at most 1/4 of the parameters plus the
    padding, the parameters holding no data; the gathered units' peak, in
    every step read, 2 layers plus the outer units at 'ahead' and every
    layer plus the outer units at 'start'; every step launching flash forward
    twice a layer (the forward and the recompute), dq and dkv once a
    layer, ce_stats and ce_bwd once; every CE call within its plain
    version's rule; finite losses."""
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models import llama_7b_config

    cfg = llama_7b_config(num_hidden_layers=RANKS_LAYERS, dtype="bfloat16")
    steps = ZERO3_WARMUP + ZERO3_AHEAD + 1 + ZERO3_START
    batches = _fleet_full_batches(cfg, args.seed, rows=4, steps=steps)
    ref_losses, ref_norms = _zero3_reference(cfg, args.seed, batches, 4)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="zero3_full_")
    _rank_out(tmp, "batches.pkl", batches)
    t0 = time.perf_counter()
    spawn(_zero3_full_rank, (tmp, args.seed), nprocs=4,
          timeout=ZERO3_FULL_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    launches = {}
    for r in ranks:
        for mode in ("ahead", "start"):
            for k_, n in r[mode]["launches"].items():
                launches[k_] = launches.get(k_, 0) + n

    def worst(read, want):
        return max(abs(read(r) - want) / abs(want) for r in ranks)

    layers = cfg.num_hidden_layers
    out = {"layers": layers, "seq": TRAIN_SEQ,
           "layout": "sharding 4, ZeRO-3, 4 gloo ranks on one card",
           "wall_s": wall_s, "ref_losses": ref_losses,
           "ref_grad_norms": ref_norms,
           "loss_rel_errs": [worst(lambda r, i=i: r["warm_losses"][i],
                                   ref_losses[i]) for i in range(2)],
           "grad_norm_rel_errs": [
               worst(lambda r, i=i: r["warm_grad_norms"][i], ref_norms[i])
               for i in range(2)],
           "launches": launches,
           "ranks": [{k_: v for k_, v in r.items()} for r in ranks]}
    report["zero3_full_width"] = out
    for r in ranks:
        print(f"zero3 full width rank {r['rank']} ({report.get('gpu')}; 4 "
              f"ranks time-sharing one card through gloo): " + json.dumps(
                  {k_: v for k_, v in r.items()
                   if k_ not in ("warm_launches", "ce_calls")}), flush=True)
    print("zero3 full width: " + json.dumps(
        {k_: v for k_, v in out.items() if k_ != "ranks"}), flush=True)
    bad = []
    if not max(out["loss_rel_errs"]) <= FLEET_LOSS_RTOL:
        bad.append(f"losses {ranks[0]['warm_losses']} vs the single "
                   f"rank's {ref_losses}")
    if not max(out["grad_norm_rel_errs"]) <= FLEET_GNORM_RTOL:
        bad.append(f"grad norms {ranks[0]['warm_grad_norms']} vs the "
                   f"single rank's {ref_norms}")
    need3 = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
             "flash_bwd_dkv": layers, "ce_stats": 1, "ce_bwd": 1}
    need2 = dict(need3, flash_fwd=layers)
    calls = ZERO3_WARMUP + ZERO3_AHEAD + 1 + ZERO3_START + ZERO3_Z2 + 1
    for r in ranks:
        pad = r["buckets"] * 4 * 2
        if not (r["unit_param_bytes"] <= 4 * r["resident_param_bytes"]
                <= r["unit_param_bytes"] + pad
                and r["param_storage_bytes"] == 0):
            bad.append(f"rank {r['rank']}: {r['resident_param_bytes']} "
                       f"resident bytes of {r['unit_param_bytes']}, "
                       f"{r['param_storage_bytes']} in the parameters")
        want_units = {"ahead": 2 + ZERO3_OUTER,
                      "start": layers + ZERO3_OUTER}
        units = ([(m, n) for m, n in zip(r["warm_modes"],
                                         r["warm_peak_units"])]
                 + [(m, r[m]["peak_units"]) for m in ("ahead", "start")])
        for mode, n in units:
            if n != want_units[mode]:
                bad.append(f"rank {r['rank']}: '{mode}' gathered {n} "
                           f"units at once, not {want_units[mode]}")
        for mode in ("ahead", "start"):
            if r[mode]["live_units"] or r[mode]["alive_buffers"]:
                bad.append(f"rank {r['rank']} {mode}: full buffers left")
        losses = r["warm_losses"] + [x for mode in ("ahead", "start",
                                                    "zero2")
                                     for x in r[mode]["losses"]]
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"rank {r['rank']}: non-finite loss {losses}")
        for i, got in enumerate(list(r["warm_launches"])
                                + [r["ahead"]["launches_per_step"],
                                   r["start"]["launches_per_step"]]):
            short = {k_: v for k_, v in need3.items() if got.get(k_, 0) < v}
            if short:
                bad.append(f"rank {r['rank']} step {i}: kernels short "
                           f"{short}")
        short = {k_: v for k_, v in need2.items()
                 if r["zero2"]["launches_per_step"].get(k_, 0) < v}
        if short:
            bad.append(f"rank {r['rank']} ZeRO-2: kernels short {short}")
        for name, rec in r["ce_calls"].items():
            if not rec["ok"] or rec["calls"] != calls:
                bad.append(f"rank {r['rank']} {name}: ok {rec['ok']}, "
                           f"{rec['calls']} calls of {calls}")
    if bad:
        raise AssertionError(f"zero3_full_width: {bad}")


# ---------------------------------------------------------------------------
# MoE expert parallelism (ep): GPT-MoE's experts split over the ranks, the
# tokens on the tiled all-to-all, a process a rank on gloo
# ---------------------------------------------------------------------------

MOE_EP_LR = 1e-3             # the tiny CUDA-vs-CPU cases (phase 6's lr)
MOE_EP_SMALL_TIMEOUT_S = 300
MOE_EP_FULL_TIMEOUT_S = 480
MOE_EP_SMALL = {             # label: (mesh axes, zero axis)
    "dp2_ep2_zero_dp": ({"dp": 2, "ep": 2}, "dp"),
    "ep4": ({"ep": 4}, None)}
MOE_EP_LAYER_CASES = {
    "dropless": dict(dispatch="dropless"),
    "expert_choice": dict(dispatch="dropless", router="expert"),
    "shared_expert": dict(dispatch="dropless", shared_expert_hidden=96),
    "capacity": dict(dispatch="capacity", capacity_factor=0.5,
                     shared_expert_hidden=96)}
MOE_EP_LAYER_D, MOE_EP_LAYER_H, MOE_EP_LAYER_TOKENS = 64, 128, 48
MOE_EP_WARMUP, MOE_EP_STEPS = 2, 2   # the full-width run: 2 + 2 steps
# the full-width run against the single-rank model (its experts' outputs
# rounded as the ep combine sends them): its first two losses and its
# gradient norms of steps 0 and 1, relative. Sound runs read 7.0e-6 and
# 3.2e-5 (losses), 2.7e-6 and 2.6e-3 (norms: AdamW's first update moves
# each weight by lr times the sign of its gradient, so a rounding-sized
# gradient flips some signs); planted faults (tools/moe_ep_gate_probe.py)
# read 1.5e-4 and 4.8e-4 (losses; a rank losing one owner's outputs in one
# layer) and from 1.8e-2 (step 0) and 1.49 (step 1, with the experts'
# gradients or the load-balance loss's 4 times too large) on the norms
MOE_EP_LOSS_RTOL = 1e-4
MOE_EP_GNORM_RTOL = (1e-4, 1e-2)


class _GmmCalls:
    """While ``on``, holds every ``gmm_fwd``, ``gmm_dx`` (the split-TF32
    dx, counted as ``gmm_fwd_tf32``) and ``gmm_dw`` call of this process
    to its plain version on the same inputs: every output row within the
    fp32 rule, RTOL["float32"] of the row's max |ref| (a row of zeros
    exactly). The references launch no kernel, so they add no launch."""

    NAMES = ("gmm_fwd", "gmm_dx", "gmm_dw")

    def __init__(self):
        from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

        self.gm = gm
        self.real = (gm.gmm_fwd, gm.gmm_dx, gm.gmm_dw)
        self.on = False
        self.out = {n: {"calls": 0, "worst": 0.0, "ok": True}
                    for n in self.NAMES}
        gm.gmm_fwd, gm.gmm_dx, gm.gmm_dw = self._fwd, self._dx, self._dw

    def restore(self):
        self.gm.gmm_fwd, self.gm.gmm_dx, self.gm.gmm_dw = self.real

    def _fwd(self, x, w, gids):
        got = self.real[0](x, w, gids)
        if self.on and x.is_cuda:
            self._check("gmm_fwd", got,
                        self.gm.grouped_matmul_reference(x, w, gids))
        return got

    def _dx(self, dy, w, gids):
        got = self.real[1](dy, w, gids)
        if self.on and dy.is_cuda:
            self._check("gmm_dx", got, self.gm.grouped_matmul_reference(
                dy, w.transpose(1, 2), gids))
        return got

    def _dw(self, x, dy, gids, num_groups):
        got = self.real[2](x, dy, gids, num_groups)
        if self.on and x.is_cuda:
            self._check("gmm_dw", got, self.gm.grouped_matmul_dw_reference(
                x, dy, gids, num_groups))
        return got

    def _check(self, name, got, ref):
        err, ok = _row_rule(got, ref, RTOL["float32"])
        rec = self.out[name]
        rec["calls"] += 1
        rec["worst"] = max(rec["worst"], err)
        rec["ok"] = rec["ok"] and ok


def _moe_ep_tiny_config():
    """Phase 9's tiny CUDA-vs-CPU GPT-MoE (hidden 256, 4 heads of 64,
    expert hidden 512, vocab 1024, fp32, dropless) with 8 experts (2 a
    rank at ep 4, 4 at ep 2) and a shared expert of 128."""
    from paddle_tpu_torch.models import gpt_moe_tiny_config

    return gpt_moe_tiny_config(vocab_size=1024, hidden_size=256,
                               num_attention_heads=4, num_experts=8,
                               expert_hidden_size=512,
                               max_position_embeddings=256,
                               moe_dispatch="dropless",
                               shared_expert_hidden=128)


def _moe_ep_no_random_routing(model):
    for moe in model.moe_layers():
        moe.gate.random_routing = False


def _moe_ep_small_rank(out_dir):
    """One gloo rank of ``moe_ep_cuda_vs_cpu``: each layout's 3 GPT-MoE
    steps and each MoE layer case on cuda:0 then on the CPU, from the same
    weights (this rank keeps its block of the experts)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import from_paddle_tpu_params
    from paddle_tpu_torch.models.convert import shard_expert_params
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    env = dist.init_parallel_env(backend="gloo")
    named, layer_named, batch, x, ct = _rank_in(out_dir, "inputs.pkl")
    cfg = _moe_ep_tiny_config()
    out = {"rank": env.rank,
           "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend(), "gpt": {}, "layers": {}}
    launches = {}

    def counted(dev, fn):
        if dev == "cuda":
            torch.cuda.synchronize()
            port_cuda.reset_launch_counts()
        res = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
            for k, n in port_cuda.launch_counts().items():
                launches[k] = launches.get(k, 0) + n
        return res

    for label, (axes, zero_axis) in MOE_EP_SMALL.items():
        out["gpt"][label], out["layers"][label] = {}, {}
        for dev in ("cuda", "cpu"):
            fleet.reset()
            mesh = build_mesh(axes)
            model = from_paddle_tpu_params(named, cfg, device=dev)
            _moe_ep_no_random_routing(model)
            opt = AdamW(learning_rate=MOE_EP_LR,
                        parameters=model.parameters(), weight_decay=0.01)
            step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                             mesh=mesh, zero_axis=zero_axis)
            losses = counted(dev, lambda: [float(step(batch))
                                           for _ in range(3)])
            m = step.last_metrics()
            out["gpt"][label][dev] = {
                "coord": mesh.coord(), "losses": losses,
                "grad_norm": m["grad_norm"], "moe_aux": m["moe_aux"],
                "moe_dropped": m["moe_dropped"],
                "params": {n: p.detach().cpu()
                           for n, p in model.named_parameters()}}
            del step, opt, model
            for case, kw in MOE_EP_LAYER_CASES.items():
                tm = MoELayer(MOE_EP_LAYER_D, num_expert=cfg.num_experts,
                              d_hidden=MOE_EP_LAYER_H, device=dev, **kw)
                share = shard_expert_params(layer_named[case], tm.ep_rank,
                                            tm.ep_degree)
                with torch.no_grad():
                    for n, p in tm.named_parameters():
                        p.copy_(torch.from_numpy(share[n]))
                tm.gate.random_routing = False
                r = env.rank
                xr = torch.from_numpy(x[r:r + 1]).to(dev).requires_grad_()

                def run():
                    o = tm(xr)
                    ((o * torch.from_numpy(ct[r:r + 1]).to(dev)).sum()
                     + tm.l_aux).backward()
                    return o

                o = counted(dev, run)
                out["layers"][label].setdefault(case, {})[dev] = {
                    "out": o.detach().cpu(), "x_grad": xr.grad.cpu(),
                    "grads": {n: p.grad.cpu()
                              for n, p in tm.named_parameters()},
                    "l_aux": float(tm.l_aux.detach()),
                    "counts": tm.expert_counts.cpu()}
    out["launches"] = launches
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def _moe_ep_err(a, b):
    """max |a - b| over max |b| (0 for two zero tensors)."""
    top = float(b.abs().max())
    err = float((a.double() - b.double()).abs().max())
    return err / top if top else err


def phase_moe_ep_cuda_vs_cpu(seed, report):
    """4 gloo ranks on cuda:0 against the same 4 ranks on the CPU: the
    tiny fp32 GPT-MoE of ``_moe_ep_tiny_config`` (8 experts, dropless, a
    shared expert), 3 AdamW steps at dp 2 x ep 2 with ZeRO over dp and at
    ep 4 on one 4 x 64 batch (a row a rank, no ignored labels,
    deterministic GShard gates): per-step losses within 1e-4 relative and
    the parameters gathered over ep within lr (phase 6's rule); then an
    MoE layer (d 64, 8 experts of 128, 48 tokens a rank) at both layouts,
    dropless token-choice, expert-choice, with a shared expert, and
    capacity with drops: the output, the input's gradient and every
    parameter's gradient within 1e-4 of the CPU's max |value|, l_aux and
    the expert counts equal within 1e-5. The ranks must launch the
    grouped kernels (gmm_fwd_tf32: the fp32 forward and dx; gmm_dw) and
    the flash kernels."""
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.mesh import set_mesh
    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import (GptMoeForCausalLM,
                                         gather_expert_params)
    from paddle_tpu_torch.models.convert import _to_port_layout

    cfg = _moe_ep_tiny_config()
    set_mesh(None)
    full = GptMoeForCausalLM(cfg, device="cpu", seed=seed)
    named = {n: _to_port_layout(n, p.detach().numpy().copy())
             for n, p in full.named_parameters()}
    layer_named = {
        case: {n: p.detach().numpy().copy() for n, p in MoELayer(
            MOE_EP_LAYER_D, num_expert=cfg.num_experts,
            d_hidden=MOE_EP_LAYER_H, seed=seed, **kw).named_parameters()}
        for case, kw in MOE_EP_LAYER_CASES.items()}
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (4, 65))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    x = rng.standard_normal((4, MOE_EP_LAYER_TOKENS, MOE_EP_LAYER_D)) \
        .astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="moe_ep_small_")
    _rank_out(tmp, "inputs.pkl", (named, layer_named, batch, x, ct))
    t0 = time.perf_counter()
    spawn(_moe_ep_small_rank, (tmp,), nprocs=4,
          timeout=MOE_EP_SMALL_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    bad = []
    out = {"gloo_s": gloo_s, "gpt": {}, "layers": {}, "launches": {},
           "devices": [r["device"] for r in ranks],
           "tolerance": {"loss_rel": 1e-4, "param": MOE_EP_LR,
                         "layer_rel": 1e-4, "stats": 1e-5}}
    for r in ranks:
        for k, n in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        if r["backend"] != "gloo" or r["device"] != "cuda:0":
            bad.append(f"rank {r['rank']}: {r['backend']} on {r['device']}")
    for k in ("gmm_fwd_tf32", "gmm_dw", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkv"):
        if not out["launches"].get(k):
            bad.append(f"{k} not launched by the ranks")
    for label, (axes, _) in MOE_EP_SMALL.items():
        ep = axes["ep"]
        # ranks 0..ep-1 hold the ep blocks of the first dp replica
        params = {dev: gather_expert_params(
            [ranks[j]["gpt"][label][dev]["params"] for j in range(ep)])
            for dev in ("cuda", "cpu")}
        losses = {dev: [ranks[r]["gpt"][label][dev]["losses"]
                        for r in range(4)] for dev in ("cuda", "cpu")}
        loss_rel = max(abs(a - b) / abs(b) for r in range(4)
                       for a, b in zip(losses["cuda"][r], losses["cpu"][r]))
        p_err = max(float(np.abs(params["cuda"][n] - params["cpu"][n]).max())
                    for n in params["cpu"])
        rec = {"losses": {d: losses[d][0] for d in losses},
               "loss_rel_err": loss_rel, "param_max_abs_err": p_err,
               **{k: {d: ranks[0]["gpt"][label][d][k]
                      for d in ("cuda", "cpu")}
                  for k in ("grad_norm", "moe_aux", "moe_dropped")}}
        out["gpt"][label] = rec
        if not (loss_rel <= 1e-4 and p_err <= MOE_EP_LR
                and all(v == 0 for v in rec["moe_dropped"].values())):
            bad.append(f"gpt {label}: loss {loss_rel:.3g}, params "
                       f"{p_err:.3g}, dropped {rec['moe_dropped']}")
        blocks = {j: [r for r in range(4) if r % ep == j] for j in range(ep)}
        for case in MOE_EP_LAYER_CASES:
            res = [ranks[r]["layers"][label][case] for r in range(4)]
            errs = {}
            for part in ("out", "x_grad"):
                errs[part] = max(_moe_ep_err(res[r]["cuda"][part],
                                             res[r]["cpu"][part])
                                 for r in range(4))
            for name in res[0]["cpu"]["grads"]:
                def grad(dev, n=name):
                    if n.startswith("experts."):
                        return torch.cat([sum(res[r][dev]["grads"][n]
                                              for r in blocks[j])
                                          for j in range(ep)])
                    return sum(res[r][dev]["grads"][n] for r in range(4))
                errs[name] = _moe_ep_err(grad("cuda"), grad("cpu"))
            stats = max(max(abs(res[r]["cuda"]["l_aux"]
                                - res[r]["cpu"]["l_aux"]),
                            float((res[r]["cuda"]["counts"]
                                   - res[r]["cpu"]["counts"]).abs().max()))
                        for r in range(4))
            out["layers"][f"{label}_{case}"] = {"rel_errs": errs,
                                               "stats_err": stats}
            if max(errs.values()) > 1e-4 or stats > 1e-5:
                bad.append(f"layer {label} {case}: {errs}, stats {stats}")
    report["moe_ep_cuda_vs_cpu"] = out
    print("moe_ep_cuda_vs_cpu: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f"moe_ep_cuda_vs_cpu: {bad}")


def _moe_ep_batches(cfg, seed, rows=4, steps=MOE_EP_WARMUP + MOE_EP_STEPS):
    """moe_ep_full_width's batches (input ids, labels): step t's `rows`
    rows of max_position_embeddings tokens (a row a rank), fresh every
    step, no ignored labels."""
    import numpy as np

    s = cfg.max_position_embeddings
    batches = []
    for t in range(steps):
        ids = np.random.RandomState(seed + t).randint(1, cfg.vocab_size,
                                                      (rows, s + 1))
        batches.append((ids[:, :-1], ids[:, 1:]))
    return batches


def _moe_ep_loss(model):
    """GPT-MoE's training loss (cross entropy plus the weighted sum of the
    layers' load-balance losses) taken in fp32 from the bf16 logits: the
    model's own loss is bf16, whose 2^-8 steps would hide what the gates
    look for."""
    import torch

    def loss_fn(logits, labels):
        ce = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1))
        aux = sum(m.l_aux.float() for m in model.moe_layers())
        return ce + model.config.moe_aux_loss_weight * aux

    return loss_fn


@contextlib.contextmanager
def _combine_in_model_dtype(on=True):
    """While on, the ep = 1 dropless body rounds its experts' outputs to
    the tokens' dtype before the combine, as the ep body's combine
    all-to-all carries them (the JAX package's too): the backward then
    rounds their gradient alike."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        dropless as dl

    real = dl._expert_ffn_grouped

    def rounded(x, *args):
        return real(x, *args).to(x.dtype).float()

    if on:
        dl._expert_ffn_grouped = rounded
    try:
        yield
    finally:
        dl._expert_ffn_grouped = real


def _moe_ep_reference(cfg, seed, batches, rows, rounded):
    """The single-rank GPT-MoE on the same weights (seeded alike) and rows,
    deterministic gates: its first two steps' losses and gradient norms,
    a row at a time (each row's loss with its own load-balance loss, as
    the rank holding it computes it; the rows' bf16 gradients summed in
    fp32, rounded once and divided by their count, as the ranks' sum is
    reduced once). `rounded`: the experts' outputs rounded to bf16 before
    the combine, as the ep combine sends them (``_combine_in_model_dtype``);
    else the plain model, which keeps them in fp32."""
    import torch

    from paddle_tpu_torch.models import GptMoeForCausalLM
    from paddle_tpu_torch.nn.clip import global_norm
    from paddle_tpu_torch.optimizer import AdamW

    model = GptMoeForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                              seed=seed)
    _moe_ep_no_random_routing(model)
    loss_fn = _moe_ep_loss(model)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    params = list(model.parameters())
    losses, norms = [], []
    with _combine_in_model_dtype(rounded):
        for b in batches[:2]:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            total = 0.0
            for m in range(rows):
                opt.clear_grad()
                ids = torch.from_numpy(b[0][m:m + 1]).cuda()
                lab = torch.from_numpy(b[1][m:m + 1]).cuda()
                loss = loss_fn(model(ids), lab)
                loss.backward()
                total += float(loss.detach())
                for a, p in zip(acc, params):
                    if p.grad is not None:
                        a += p.grad.float()
            for a, p in zip(acc, params):
                p.grad = a.to(p.dtype).div_(rows)
            del acc
            losses.append(total / rows)
            norms.append(float(global_norm([p.grad for p in params])))
            opt.step()
    del model, opt, params
    return losses, norms


def _moe_ep_full_rank(out_dir, seed):
    """One gloo rank of ``moe_ep_full_width``: GPT-MoE at its full width
    and depth, bf16, ep 4 (2 of the 8 experts a layer a rank); the second
    warm-up step with every grouped-matmul call held to its plain version,
    MOE_EP_STEPS timed steps, then the visit counter over each layer's
    received layout."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import GptMoeConfig, GptMoeForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    _rank_threads()
    env = dist.init_parallel_env(backend="gloo")
    cfg = GptMoeConfig(moe_dispatch="dropless")
    t0 = time.perf_counter()
    mesh = build_mesh({"ep": 4})
    model = GptMoeForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                              seed=seed)
    _moe_ep_no_random_routing(model)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, _moe_ep_loss(model), opt, collect_metrics=True,
                     mesh=mesh)
    batches = _rank_in(out_dir, "batches.pkl")
    gmm = _GmmCalls()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, warm_grad_norms = [], []
    for i, b in enumerate(batches[:MOE_EP_WARMUP]):
        gmm.on = i == MOE_EP_WARMUP - 1
        losses.append(float(step(*b)))
        warm_grad_norms.append(step.last_metrics()["grad_norm"])
    gmm.on = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collective.reset_stats()
    port_cuda.reset_launch_counts()          # the training path starts here
    times = []
    for b in batches[MOE_EP_WARMUP:]:
        t1 = time.perf_counter()
        loss = step(*b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    launches = port_cuda.launch_counts()     # ... and ends here
    comm = collective.stats()
    peak = torch.cuda.max_memory_allocated() / 1e9
    stats = [moe.last_stats for moe in model.moe_layers()]
    # the visit counter (off the path) over each layer's received layout,
    # against the predicate in numpy; its launches are counted apart
    port_cuda.reset_launch_counts()
    visits = []
    for moe in model.moe_layers():
        gids, bm = moe.last_layout
        el = moe.experts.num_local
        vc = gm.grouped_matmul_visit_counts(gids, el, bm)
        want = gm.expected_visit_counts(gids.cpu().numpy(), el, bm)
        visits.append({"rows": int(gids.shape[0]), "block_rows": bm,
                       "blocks": int(vc.numel()),
                       "visited_tiles": int(vc.sum()),
                       "multi_group_tiles_128": _multi_group_tiles(gids, el),
                       "counts_match_predicate": bool(np.array_equal(
                           vc.cpu().numpy(), want))})
    visit_launches = port_cuda.launch_counts()["gmm_visit"]
    gids0, bm0 = model.moe_layers()[0].last_layout
    gmm.restore()
    n = len(times)
    _rank_out(out_dir, f"rank{env.rank}.pkl", {
        "rank": env.rank, "coord": mesh.coord(),
        "device": str(dist.parallel.current_device()),
        "backend": collective.get_backend(), "setup_s": setup_s,
        "losses": losses, "step_ms": [t * 1e3 for t in times],
        "median_step_ms": statistics.median(times) * 1e3,
        "peak_mem_gb": peak,
        "params": sum(p.numel() for p in model.parameters()),
        "launches_per_step": {k: v / n for k, v in launches.items() if v},
        "all_to_all_per_step": {
            "calls": comm["calls"].get("all_to_all", 0) / n,
            "bytes": comm["bytes"].get("all_to_all", 0) / n,
            "host_ms": comm["seconds"].get("all_to_all", 0.0) * 1e3 / n},
        "collective_host_ms_per_step": {k: v * 1e3 / n for k, v in
                                        comm["seconds"].items()},
        "warm_grad_norms": warm_grad_norms,
        "grad_norm": step.last_metrics()["grad_norm"],
        "expert_counts": [st["expert_tokens"] for st in stats],
        "aux": [st["aux_loss"] for st in stats],
        "visits": visits, "visit_launches": visit_launches,
        "gmm_calls": gmm.out,
        "layout": (gids0.cpu().numpy(), bm0)})
    dist.destroy_process_group()


def _moe_ep_gmm_case(gen, gids, bm, groups, contiguous):
    """gmm_fwd (h1: x [M, 1024] bf16 . w1 [G, 1024, 4096]) and gmm_dw (its
    dw1, fp32 dy) over one layout: each held to its plain version by the
    fp32 row rule, the ms a call (CUDA events over back-to-back calls,
    gmm_dw's three kernels together: late in a long process the profiler
    drops short kernels' events), the bound over the rows the layout
    routes, the 128-row tiles that run more than one group pass, and
    torch._grouped_mm's ms where the groups are contiguous (the received
    layout's are not: each source's slice starts its ids again)."""
    import torch

    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    d, h = 1024, 4096
    m = gids.shape[0]
    real = int((gids < groups).sum())
    x = torch.randn((m, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((groups, d, h), generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    dy = torch.randn((m, h), generator=gen, device="cuda") * 1e-3
    fwd_err, fwd_ok = _row_rule(gm.gmm_fwd(x, w, gids),
                                gm.grouped_matmul_reference(x, w, gids),
                                RTOL["float32"])
    dw_err, dw_ok = _row_rule(gm.gmm_dw(x, dy, gids, groups),
                              gm.grouped_matmul_dw_reference(x, dy, gids,
                                                             groups),
                              RTOL["float32"])
    fwd_ms = _cuda_ms(lambda: gm.gmm_fwd(x, w, gids))
    dw_ms = _cuda_ms(lambda: gm.gmm_dw(x, dy, gids, groups))
    flops = 2 * real * d * h
    fwd_bound, fwd_by = _bound(x.numel() * 2 + w.numel() * 2 + m * h * 4
                               + m * 4, flops, "bfloat16")
    dw_bound, dw_by, _, _ = _fp32_product_bound(
        x.numel() * 2 + dy.numel() * 4 + m * 4 + groups * d * h * 4,
        flops, 2)
    lib_ms, lib_note = None, ("none: the groups are not contiguous "
                              "(torch._grouped_mm needs sorted rows)")
    if contiguous:
        lib, lib_note = _grouped_mm_call(x, w, gids, groups)
        lib_ms = _cuda_ms(lib) if lib else None
    return {"rows": m, "routed_rows": real, "block_rows": bm,
            "groups": groups, "multi_group_tiles_128":
            _multi_group_tiles(gids, groups),
            "gmm_fwd": {"ms": fwd_ms, "bound_ms": fwd_bound,
                        "bound_by": fwd_by, "bound_share": fwd_bound / fwd_ms,
                        "tflops": flops / fwd_ms / 1e9, "max_rel_err":
                        fwd_err, "ok": fwd_ok, "library_ms": lib_ms,
                        "library": lib_note},
            "gmm_dw": {"ms": dw_ms, "bound_ms": dw_bound, "bound_by": dw_by,
                       "bound_share": dw_bound / dw_ms,
                       "tflops": flops / dw_ms / 1e9, "max_rel_err": dw_err,
                       "ok": dw_ok}}


def phase_moe_ep_full_width(args, report):
    """GPT-MoE at ``GptMoeConfig``'s full width and depth (12 layers,
    hidden 1024, 16 heads, 8 experts of 4096, top-2 GShard, vocab 50304,
    dropless, bf16 with fp32 masters, AdamW) at ep 4: 4 gloo ranks on the
    one card, each with 2 experts a layer and 1 x 2048 tokens of a
    global 4 x 2048 batch, a fresh batch a step, MOE_EP_WARMUP +
    MOE_EP_STEPS steps; the gates are deterministic (no random routing),
    so the ranks route as the single-rank model does, and the loss is
    taken in fp32 (``_moe_ep_loss``). Per rank: step ms,
    peak memory, the all-to-alls' calls, bytes and host ms a step (gloo
    stages them through host memory: 4 ranks time-sharing one card, no
    multi-GPU figure), the launches of flash forward, dq, dkv, gmm_fwd,
    the split-TF32 dx and gmm_dw a step, and each layer's expert counts.
    Then, alone on the card, gmm_fwd's and gmm_dw's ms a call (CUDA
    events) on rank 0's received layout of layer 0 beside the ep = 1
    dispatcher's layout of the same 4 x 2048 tokens. Gates, on every
    rank: the first two losses within MOE_EP_LOSS_RTOL and the gradient
    norms of steps 0 and 1 within MOE_EP_GNORM_RTOL's two limits of the
    single-rank model's on the same weights and rows, its experts'
    outputs rounded to bf16 before the combine as the ep combine sends
    them (``_moe_ep_reference``, run and freed before the ranks start;
    the plain model's readings are printed beside, not gated); every
    gmm_fwd, dx and gmm_dw call of the second warm-up step within the
    fp32 rule of its plain version; 24 gmm_fwd, 24 gmm_fwd_tf32, 24
    gmm_dw and 12 of each flash kernel a step; the visit counts over
    each received layout equal to the predicate's; finite losses."""
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models import GptMoeConfig

    cfg = GptMoeConfig(moe_dispatch="dropless")
    batches = _moe_ep_batches(cfg, args.seed)
    plain = _moe_ep_reference(cfg, args.seed, batches, 4, rounded=False)
    gc.collect()
    torch.cuda.empty_cache()
    ref_losses, ref_gnorms = _moe_ep_reference(cfg, args.seed, batches, 4,
                                               rounded=True)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="moe_ep_full_")
    _rank_out(tmp, "batches.pkl", batches)
    t0 = time.perf_counter()
    spawn(_moe_ep_full_rank, (tmp, args.seed), nprocs=4,
          timeout=MOE_EP_FULL_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    launches = {}
    for r in ranks:
        for k, v in r["launches_per_step"].items():
            launches[k] = launches.get(k, 0) + v * MOE_EP_STEPS

    def worst(read, want):
        return max(abs(read(r) - want) / abs(want) for r in ranks)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    el = cfg.num_experts // 4
    gids0, bm0 = ranks[0].pop("layout")
    for r in ranks[1:]:
        r.pop("layout")
    one, bm1, _ = _dispatch_layout(gen, 4 * cfg.max_position_embeddings,
                                   cfg.num_experts, cfg.top_k)
    gmm_ms = {"received": _moe_ep_gmm_case(
        gen, torch.from_numpy(gids0).cuda(), bm0, el, False),
        "ep1": _moe_ep_gmm_case(gen, one, bm1, cfg.num_experts, True)}
    out = {"layers": cfg.num_hidden_layers,
           "seq": cfg.max_position_embeddings,
           "layout": "ep 4, 4 gloo ranks on one card, 1 x 2048 a rank",
           "wall_s": wall_s, "ref_losses": ref_losses,
           "ref_grad_norms": ref_gnorms,
           "first_loss_rel_err": worst(lambda r: r["losses"][0],
                                       ref_losses[0]),
           "second_loss_rel_err": worst(lambda r: r["losses"][1],
                                        ref_losses[1]),
           "grad_norm_rel_errs": [
               worst(lambda r: r["warm_grad_norms"][i], ref_gnorms[i])
               for i in range(2)],
           # the plain single-rank model (expert outputs kept in fp32 to
           # the combine): the rounding the ep combine adds, not gated
           "plain_ref": {
               "losses": plain[0], "grad_norms": plain[1],
               "loss_rel_errs": [worst(lambda r: r["losses"][i],
                                       plain[0][i]) for i in range(2)],
               "grad_norm_rel_errs": [
                   worst(lambda r: r["warm_grad_norms"][i], plain[1][i])
                   for i in range(2)]},
           "launches": launches, "gmm_per_call": gmm_ms,
           "ranks": ranks}
    report["moe_ep_full_width"] = out
    for r in ranks:
        print(f"moe ep full width rank {r['rank']} {r['coord']} "
              f"({report.get('gpu')}; 4 ranks time-sharing one card "
              f"through gloo): " + json.dumps(
                  {k: v for k, v in r.items() if k != "visits"}), flush=True)
    print("moe ep full width: " + json.dumps(
        {k: v for k, v in out.items() if k != "ranks"}), flush=True)
    bad = []
    if not out["first_loss_rel_err"] <= MOE_EP_LOSS_RTOL:
        bad.append(f"first loss {ranks[0]['losses'][0]} vs the single "
                   f"rank's {ref_losses[0]}")
    if not out["second_loss_rel_err"] <= MOE_EP_LOSS_RTOL:
        bad.append(f"second loss {ranks[0]['losses'][1]} vs the single "
                   f"rank's {ref_losses[1]}")
    if not all(e <= lim for e, lim in zip(out["grad_norm_rel_errs"],
                                          MOE_EP_GNORM_RTOL)):
        bad.append(f"grad norms {ranks[0]['warm_grad_norms']} vs the "
                   f"single rank's {ref_gnorms}")
    layers = cfg.num_hidden_layers
    need = {"gmm_fwd": 2 * layers, "gmm_fwd_tf32": 2 * layers,
            "gmm_dw": 2 * layers, "flash_fwd": layers,
            "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    for r in ranks:
        if not all(math.isfinite(x) for x in r["losses"]):
            bad.append(f"rank {r['rank']}: non-finite loss {r['losses']}")
        got = {k: r["launches_per_step"].get(k, 0) for k in need}
        if got != need:
            bad.append(f"rank {r['rank']}: launches a step {got}, want "
                       f"{need}")
        for name, rec in r["gmm_calls"].items():
            if not rec["ok"] or rec["calls"] != 2 * layers:
                bad.append(f"rank {r['rank']} {name}: {rec}")
        if not all(v["counts_match_predicate"] for v in r["visits"]):
            bad.append(f"rank {r['rank']}: visit counts off the predicate")
        # a layer a step: the dispatch, its ids and the combine forward,
        # the combine's and the dispatch's backward
        if r["all_to_all_per_step"]["calls"] != 5 * layers:
            bad.append(f"rank {r['rank']}: all-to-alls a step "
                       f"{r['all_to_all_per_step']}")
    for case in gmm_ms.values():
        if not (case["gmm_fwd"]["ok"] and case["gmm_dw"]["ok"]):
            bad.append(f"gmm per-call case off its plain version: {case}")
    if bad:
        raise AssertionError(f"moe_ep_full_width: {bad}")


# ---------------------------------------------------------------------------
# sequence (sep) parallelism: each rank a contiguous segment of the rows'
# sequence, attention across the segments by ring attention (K/V blocks
# hopping around the sep group through gloo), a process a rank
# ---------------------------------------------------------------------------

SEP_LR = 1e-3                # the tiny CUDA-vs-CPU cases (phase 6's lr)
SEP_SMALL_TIMEOUT_S = 300
SEP_FULL_TIMEOUT_S = 600
SEP_SMALL = {                # label: (mesh axes, batch)
    "sep4": ({"sep": 4}, "plain"),
    "dp2_sep2": ({"dp": 2, "sep": 2}, "plain"),
    "sep2_mp2": ({"sep": 2, "mp": 2}, "plain"),
    "sep4_packed": ({"sep": 4}, "packed")}
SEP_SEQ = 16384              # the full-width row: 4096 tokens a rank
SEP_WARMUP, SEP_STEPS = 2, 2  # the full-width run: 2 + 2 steps
# the full-width run against the single-rank model on the same 16,384
# tokens: its first two losses and its gradient norms of steps 0 and 1,
# relative. Sound runs read 5.5e-6 and 4.6e-6 (losses), 2.7e-5 and 1.1e-5
# (norms); planted faults (tools/sep_gate_probe.py) read, on the losses,
# 2.9e-4 and 4.8e-4 (sep rank 1's RoPE offset forgotten) and 4.2e-5 and
# 3.6e-4 (rank 2 dropping rank 0's block), and on the norms from 1.3e-3
# (those two) to 0.75 (the gradients averaged over sep, not summed, which
# moves no loss: AdamW is blind to the scale)
SEP_LOSS_RTOL = 3e-5
SEP_GNORM_RTOL = 2e-4


class _RingCalls:
    """Holds every flash call that ring attention makes in this process
    (``parallel.ring_attention``'s block calls; or, given `mod`, the
    calls through that module's ``flash_attention_fwd`` and
    ``flash_attention_bwd``, e.g. ``ops.cuda.flash_attention``'s own
    autograd function) to its plain version on the same inputs, by the
    kernels phase's rules: each row of the output (and of dq, dk, dv)
    within RTOL of its max |ref| and the whole within TOL, the forward's
    lse within 1e-3 on the rows that see a key and -inf on both sides on
    the rows that see none. With ``rows_only`` the whole-output TOL is
    recorded (``worst_abs``) but not gated: it is an absolute bound for
    the kernels phase's unit-scale inputs, and a model's activations
    (causal rows of few keys, whose output is a value row) reach past it
    in bf16 rounding alone while every row holds the row rule. Counts the
    calls by kind, causal apart. While ``defer`` is set the calls' inputs
    and outputs are kept (in host memory with ``host``) and checked by
    ``check_deferred()``, as ``_CeCalls`` does. The plain versions launch
    no kernel."""

    def __init__(self, mod=None, rows_only=False):
        if mod is None:
            from paddle_tpu_torch.parallel import ring_attention as mod

        self.ra = mod
        self.rows_only = rows_only
        self.real = (mod.flash_attention_fwd, mod.flash_attention_bwd)
        self.out = {name: {"calls": 0, "causal": 0, "dead_rows": 0,
                           "worst": 0.0, "worst_abs": 0.0, "worst_lse": 0.0,
                           "ok": True}
                    for name in ("fwd", "bwd")}
        self.defer = False
        self.host = False
        self.pending = []
        mod.flash_attention_fwd, mod.flash_attention_bwd = \
            self._fwd, self._bwd

    def restore(self):
        self.ra.flash_attention_fwd, self.ra.flash_attention_bwd = self.real

    def _note(self, name, causal, errs, ok, dead=0, cmps=(), lse_err=0.0):
        rec = self.out[name]
        rec["calls"] += 1
        rec["causal"] += int(bool(causal))
        rec["dead_rows"] += dead
        rec["worst"] = max([rec["worst"]] + errs)
        rec["worst_abs"] = max([rec["worst_abs"]]
                               + [c["max_abs_err"] for c in cmps])
        rec["worst_lse"] = max(rec["worst_lse"], lse_err)
        rec["ok"] = rec["ok"] and ok

    def _held(self, cmp):
        return cmp["rows_ok"] if self.rows_only else cmp["ok"]

    def _queue(self, job):
        if not self.defer:
            self._check(job)
            return
        name, args, kw, got = job
        dev = args[0].device
        keep = "cpu" if self.host else dev

        def kept(ts):
            return tuple(t.detach().to(keep, copy=True) for t in ts)

        self.pending.append((name, kept(args), kw, kept(got), dev))

    def _fwd(self, q, k, v, causal=False, scale=None, segment_ids=None,
             kv_segment_ids=None):
        kw = dict(causal=causal, scale=scale, segment_ids=segment_ids,
                  kv_segment_ids=kv_segment_ids)
        got = self.real[0](q, k, v, **kw)
        if q.is_cuda:
            self._queue(("fwd", (q, k, v), kw, got))
        return got

    def _bwd(self, q, k, v, out, lse, do, causal=False, scale=None,
             segment_ids=None, kv_segment_ids=None):
        kw = dict(causal=causal, scale=scale, segment_ids=segment_ids,
                  kv_segment_ids=kv_segment_ids)
        got = self.real[1](q, k, v, out, lse, do, **kw)
        if q.is_cuda:
            self._queue(("bwd", (q, k, v, out, lse, do), kw, got))
        return got

    def _check(self, job):
        import torch

        from paddle_tpu_torch.ops.cuda import flash_attention as fa

        name, args, kw, got = job
        q = args[0]
        if name == "fwd":
            q, k, v = args
            ref = fa.flash_attention_reference(q.float(), k.float(),
                                               v.float(), **kw)
            cmp = _compare(got[0], ref[0], str(q.dtype)[6:])
            lse_err = _lse_err(got[1], ref[1])
            self._note("fwd", kw["causal"], [cmp["max_rel_err"], lse_err],
                       self._held(cmp) and lse_err <= 1e-3,
                       int(torch.isneginf(ref[1]).sum()), [cmp], lse_err)
            return
        q, k, v, out, lse, do = args
        refs = fa.flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), out.float(), lse, do.float(),
            **kw)
        cmps = [_compare(g, r, str(q.dtype)[6:]) for g, r in zip(got, refs)]
        self._note("bwd", kw["causal"], [c["max_rel_err"] for c in cmps],
                   all(self._held(c) for c in cmps), cmps=cmps)

    def check_deferred(self):
        pending, self.pending = self.pending, []
        for job in pending:
            self._check(_moved(job[:4], job[4]))


def _sep_plain_batch(seed, vocab, seq, rows):
    """`rows` x `seq` tokens with no ignored label (the data ranks of a dp
    layout then count as many tokens each)."""
    import numpy as np

    ids = np.random.RandomState(seed + 11).randint(1, vocab, (rows, seq + 1))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}


def _sep_small_rank(out_dir):
    """One gloo rank of ``sep_cuda_vs_cpu``: each layout on cuda:0 then on
    the CPU, 3 steps from the same weights; the ring's flash calls held to
    their plain versions; each CUDA layout's launches."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import from_paddle_tpu_params
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    env = dist.init_parallel_env(backend="gloo")
    named, batches = _rank_in(out_dir, "inputs.pkl")
    cfg = _tiny_gqa_config()
    ce, ring = _CeCalls(), _RingCalls()
    out = {"rank": env.rank,
           "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend(), "layouts": {}}
    for label, (axes, kind) in SEP_SMALL.items():
        out["layouts"][label] = {}
        for dev in ("cuda", "cpu"):
            fleet.reset()
            mesh = build_mesh(axes)
            model = from_paddle_tpu_params(named, cfg, device=dev)
            opt = AdamW(learning_rate=SEP_LR, parameters=model.parameters(),
                        weight_decay=0.01)
            step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                             mesh=mesh)
            if dev == "cuda":
                torch.cuda.synchronize()
                port_cuda.reset_launch_counts()
            losses = [float(step(batches[kind])) for _ in range(3)]
            rec = {"coord": mesh.coord(), "losses": losses,
                   "grad_norm": step.last_metrics()["grad_norm"],
                   "params": {n: p.detach().cpu()
                              for n, p in model.named_parameters()}}
            if dev == "cuda":
                torch.cuda.synchronize()
                rec["launches"] = {k: n for k, n in
                                   port_cuda.launch_counts().items() if n}
            out["layouts"][label][dev] = rec
            del step, opt, model
    ce.restore()
    ring.restore()
    out["ce_calls"], out["ring_calls"] = ce.out, ring.out
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def phase_sep_cuda_vs_cpu(seed, report):
    """4 gloo ranks on cuda:0 against the same 4 ranks on the CPU: phase
    6's tiny fp32 LLaMA (head_dim 128, 4 query heads on 2 kv heads, mp 2
    splitting them), 3 AdamW steps at sep 4, dp 2 x sep 2 and sep 2 x mp
    2 on a 4 x 256 batch with no ignored label, and at sep 4 on a packed
    4 x 256 batch (its documents cross the segments, its ignored labels
    spread unevenly): per-step losses within 1e-4 relative and the
    parameters gathered over mp within lr (phase 6's rule); the CPU ranks'
    losses within 1e-5 relative and parameters within lr of a
    single-process CPU TrainStep on the same batch; every flash call of
    the ring on the card (each block's forward, each block's backward)
    held to its plain version; each CUDA layout's launches: sep rank r
    runs r + 1 flash forward calls a layer (its own block causal, the r
    earlier ones whole, the later ones skipped), as many dq and dkv
    calls, a step; ce_stats launched."""
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         gather_paddle_tpu_params)
    from paddle_tpu_torch.models.convert import _to_port_layout
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = _tiny_gqa_config()
    named = _fleet_named(cfg, seed)
    batches = {"plain": _sep_plain_batch(seed, cfg.vocab_size, 256, 4),
               "packed": _packed_batch(seed, cfg.vocab_size, 256, 4)}
    tmp = tempfile.mkdtemp(prefix="sep_small_")
    _rank_out(tmp, "inputs.pkl", (named, batches))
    single = {}
    for kind, batch in batches.items():
        model = from_paddle_tpu_params(named, cfg, device="cpu")
        opt = AdamW(learning_rate=SEP_LR, parameters=model.parameters(),
                    weight_decay=0.01)
        step = TrainStep(model, _fused_loss, opt)
        single[kind] = ([float(step(batch)) for _ in range(3)],
                        {n: p.detach() for n, p in model.named_parameters()})
    t0 = time.perf_counter()
    spawn(_sep_small_rank, (tmp,), nprocs=4, timeout=SEP_SMALL_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    layers = cfg.num_hidden_layers
    bad = []
    out = {"gloo_s": gloo_s, "layouts": {}, "launches": {},
           "ring_calls": [r["ring_calls"] for r in ranks],
           "ce_calls": [r["ce_calls"] for r in ranks],
           "tolerance": {"loss_rel": 1e-4, "param": SEP_LR,
                         "cpu_vs_single_loss_rel": 1e-5,
                         "cpu_vs_single_param": SEP_LR}}
    for r in ranks:
        if r["backend"] != "gloo" or r["device"] != "cuda:0":
            bad.append(f"rank {r['rank']}: {r['backend']} on {r['device']}")
        # the fp32 model's CE backward takes the fp32 route: no ce_bwd call
        for name, rec in [("ring " + k_, v) for k_, v in
                          r["ring_calls"].items()] + [
                ("ce_stats", r["ce_calls"]["ce_stats"])]:
            if not rec["ok"] or rec["calls"] == 0:
                bad.append(f"rank {r['rank']} {name}: ok {rec['ok']}, "
                           f"{rec['calls']} calls, worst {rec['worst']:.3g}")
    # the packed batch's documents cross the segments: some block of some
    # rank holds query rows that see none of its keys
    if not sum(r["ring_calls"]["fwd"]["dead_rows"] for r in ranks):
        bad.append("no ring block met a row that sees no key")
    for label, (axes, kind) in SEP_SMALL.items():
        mp = axes.get("mp", 1)
        full = {dev: gather_paddle_tpu_params(
            [ranks[i]["layouts"][label][dev]["params"] for i in range(mp)])
            for dev in ("cuda", "cpu")}
        losses = {dev: ranks[0]["layouts"][label][dev]["losses"]
                  for dev in ("cuda", "cpu")}
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses["cuda"], losses["cpu"]))
        p_err = max(float(abs(full["cuda"][n] - full["cpu"][n]).max())
                    for n in full["cpu"])
        s_err = max(float((torch.from_numpy(_to_port_layout(
            n, full["cpu"][n]).copy()) - single[kind][1][n]).abs().max())
            for n in full["cpu"])
        s_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(losses["cpu"], single[kind][0]))
        per_rank = []
        for r in ranks:
            rec = r["layouts"][label]["cuda"]
            for k, n in rec["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + n
            want = (rec["coord"]["sep"] + 1) * layers * 3
            got = {k: rec["launches"].get(k, 0)
                   for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            per_rank.append(got)
            if any(n != want for n in got.values()) or \
                    not rec["launches"].get("ce_stats"):
                bad.append(f"{label} rank {r['rank']}: launches "
                           f"{rec['launches']}, want {want} of each flash "
                           f"kernel")
        out["layouts"][label] = {
            "losses": losses, "loss_rel_err": loss_rel,
            "param_max_abs_err": p_err, "cpu_vs_single_param_err": s_err,
            "cpu_vs_single_loss_rel": s_loss, "flash_launches": per_rank,
            "grad_norm": {d: ranks[0]["layouts"][label][d]["grad_norm"]
                          for d in ("cuda", "cpu")}}
        if not (loss_rel <= 1e-4 and p_err <= SEP_LR
                and s_err <= SEP_LR and s_loss <= 1e-5):
            bad.append(f"{label}: loss {loss_rel:.3g}, params {p_err:.3g}, "
                       f"CPU vs single {s_err:.3g} / {s_loss:.3g}")
    report["sep_cuda_vs_cpu"] = out
    print("sep_cuda_vs_cpu: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f"sep_cuda_vs_cpu: {bad}")


def _sep_full_config():
    from paddle_tpu_torch.models import llama_7b_config

    return llama_7b_config(num_hidden_layers=RANKS_LAYERS, dtype="bfloat16",
                           rope_max_position=SEP_SEQ)


def _sep_full_batches(cfg, seed, steps):
    """sep_full_width's batches: one row of SEP_SEQ tokens a step, fresh
    each step; every 97th label ignored."""
    import numpy as np

    batches = []
    for t in range(steps):
        ids = np.random.RandomState(seed + 7919 * (t + 1)).randint(
            1, cfg.vocab_size, (1, SEP_SEQ + 1))
        labels = ids[:, 1:].copy()
        labels[:, ::97] = -100
        batches.append({"input_ids": ids[:, :-1], "labels": labels})
    return batches


def _flash_device_ms(step, batch):
    """One profiled step: {kernel: device ms} of the flash kernels, and the
    step's device ms over all its kernels (None where the profiler
    recorded nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    by = {e.key: e.self_device_time_total / 1e3
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total}
    if not by:
        return {"flash_fwd": None, "flash_bwd_dq": None,
                "flash_bwd_dkv": None, "step_device_ms": None}
    out = {k: sum(ms for key, ms in by.items() if name in key)
           for k, name in (("flash_fwd", "flash_fwd_kernel"),
                           ("flash_bwd_dq", "flash_bwd_dq_kernel"),
                           ("flash_bwd_dkv", "flash_bwd_dkv_kernel"))}
    out["step_device_ms"] = sum(by.values())
    return out


def _sep_timed(step, batches):
    """The timed steps of ``sep_full_width``: step ms, peak memory,
    launches and the collectives' calls, bytes and host ms a step."""
    import torch

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops import cuda as port_cuda

    n = len(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collective.reset_stats()
    port_cuda.reset_launch_counts()          # the training path starts here
    losses, times = [], []
    for b in batches:
        t1 = time.perf_counter()
        loss = step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    launches = port_cuda.launch_counts()     # ... and ends here
    comm = collective.stats()
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "median_step_ms": statistics.median(times) * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "launches_per_step": {k: v / n for k, v in launches.items()
                                  if v},
            "collective_calls_per_step": {k: v / n for k, v in
                                          comm["calls"].items()},
            "collective_bytes_per_step": {k: v / n for k, v in
                                          comm["bytes"].items()},
            "collective_host_ms_per_step": {k: v * 1e3 / n for k, v in
                                            comm["seconds"].items()}}


def _sep_full_rank(out_dir, seed):
    """One gloo rank of ``sep_full_width``: phase 7's model at sep 4, this
    rank's 4096-token segment of each 16,384-token row. Every CE call's
    inputs and outputs are kept in host memory and checked after the
    model and optimizer are freed: four ranks each holding the whole
    model leave no room for the checks' fp64 witnesses beside them."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    _rank_threads()
    env = dist.init_parallel_env(backend="gloo")
    cfg = _sep_full_config()
    batches = _rank_in(out_dir, "batches.pkl")
    ce = _CeCalls()
    ce.defer = ce.host = True
    fleet.reset()
    mesh = build_mesh({"sep": 4})
    out = {"rank": env.rank, "coord": mesh.coord(),
           "device": str(dist.parallel.current_device()),
           "backend": collective.get_backend()}
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, _fused_loss, opt, collect_metrics=True,
                     mesh=mesh)
    out["setup_s"] = time.perf_counter() - t0
    losses, norms, warm = [], [], []
    for i, b in enumerate(batches[:SEP_WARMUP]):
        port_cuda.reset_launch_counts()
        if i == SEP_WARMUP - 1:          # the last warm-up step, profiled
            out["profiled"] = _flash_device_ms(step, b)
        else:
            step(b)
        losses.append(float(step.last_metrics()["loss"]))
        norms.append(step.last_metrics()["grad_norm"])
        torch.cuda.synchronize()
        warm.append(port_cuda.launch_counts())
    out.update(warm_losses=losses, warm_grad_norms=norms,
               warm_launches=warm)
    out["timed"] = _sep_timed(step, batches[SEP_WARMUP:])
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    ce.defer = ce.host = False
    ce.check_deferred()
    ce.restore()
    out["ce_calls"] = ce.out
    _rank_out(out_dir, f"rank{env.rank}.pkl", out)
    dist.destroy_process_group()


def _sep_reference(cfg, seed, batches):
    """The single-rank model on the same weights and 16,384-token rows: its
    first two steps' losses and gradient norms."""
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import global_norm
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    losses, norms = [], []
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:2]:
        opt.clear_grad()
        ids = torch.from_numpy(b["input_ids"]).cuda()
        lab = torch.from_numpy(b["labels"]).cuda()
        loss = model(ids, labels=lab).float()
        loss.backward()
        losses.append(float(loss.detach()))
        norms.append(float(global_norm([p.grad for p in model.parameters()
                                        if p.grad is not None])))
        opt.step()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, opt
    return losses, norms, peak


def phase_sep_full_width(args, report):
    """Phase 7's model (the 7B width, RANKS_LAYERS layers, bf16 with fp32
    masters, AdamW, the fused head loss; RoPE tables to 16,384 positions) at sep 4:
    4 gloo ranks on the one card, one row of 16,384 tokens a step, 4,096 a
    rank, a fresh row a step. SEP_WARMUP steps, the last of them
    profiled, then SEP_STEPS timed (their time includes copying each CE
    call's inputs and outputs to host memory, about 0.6 GB a step, for
    the checks after the run). Per rank: step ms, peak memory, the flash
    and CE launches a step and the flash kernels' device ms in the
    profiled step, and the ring's p2p calls,
    bytes and host ms a step (``collective.stats()``: "send", "recv",
    "p2p"). These are 4 ranks time-sharing one card through gloo: no
    multi-GPU figure. Gates, on every rank: the first two losses within
    SEP_LOSS_RTOL and the gradient norms of steps 0 and 1 within
    SEP_GNORM_RTOL of the single-rank model's on the same weights and
    16,384 tokens (run before the ranks, so the card never holds both);
    sep rank r launching r + 1 flash forward, dq and dkv calls a layer
    a step, ce_stats and ce_bwd once; every CE call within its plain
    version's rule; finite losses."""
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.spawn import spawn

    cfg = _sep_full_config()
    batches = _sep_full_batches(cfg, args.seed, SEP_WARMUP + SEP_STEPS)
    ref_losses, ref_norms, ref_peak = _sep_reference(cfg, args.seed,
                                                     batches)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="sep_full_")
    _rank_out(tmp, "batches.pkl", batches)
    t0 = time.perf_counter()
    spawn(_sep_full_rank, (tmp, args.seed), nprocs=4,
          timeout=SEP_FULL_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    ranks = [_rank_in(tmp, f"rank{r}.pkl") for r in range(4)]
    launches = {}
    for r in ranks:
        for k_, n in r["timed"]["launches"].items():
            launches[k_] = launches.get(k_, 0) + n

    def worst(read, want):
        return max(abs(read(r) - want) / abs(want) for r in ranks)

    layers = cfg.num_hidden_layers
    out = {"layers": layers, "seq": SEP_SEQ,
           "layout": "sep 4, 4 gloo ranks on one card",
           "wall_s": wall_s, "ref_losses": ref_losses,
           "ref_grad_norms": ref_norms, "ref_peak_mem_gb": ref_peak,
           "loss_rel_errs": [worst(lambda r, i=i: r["warm_losses"][i],
                                   ref_losses[i]) for i in range(2)],
           "grad_norm_rel_errs": [
               worst(lambda r, i=i: r["warm_grad_norms"][i], ref_norms[i])
               for i in range(2)],
           "limits": {"loss": SEP_LOSS_RTOL, "grad_norm": SEP_GNORM_RTOL},
           "launches": launches, "ranks": ranks}
    report["sep_full_width"] = out
    for r in ranks:
        t = r["timed"]
        print(f"sep full width rank {r['rank']} ({report.get('gpu')}; 4 "
              f"ranks time-sharing one card through gloo): " + json.dumps({
                  "coord": r["coord"], "warm_losses": r["warm_losses"],
                  "warm_grad_norms": r["warm_grad_norms"],
                  "median_step_ms": t["median_step_ms"],
                  "step_ms": t["step_ms"], "peak_mem_gb": t["peak_mem_gb"],
                  "launches_per_step": t["launches_per_step"],
                  "flash_device_ms_profiled_step": r["profiled"],
                  "p2p_calls_per_step": t["collective_calls_per_step"],
                  "p2p_bytes_per_step": t["collective_bytes_per_step"],
                  "host_ms_per_step": t["collective_host_ms_per_step"],
                  "ce_calls": {k_: (v["calls"], v["ok"], v["worst"])
                               for k_, v in r["ce_calls"].items()}}),
              flush=True)
    print("sep full width: " + json.dumps(
        {k_: v for k_, v in out.items() if k_ != "ranks"}), flush=True)
    bad = []
    if not max(out["loss_rel_errs"]) <= SEP_LOSS_RTOL:
        bad.append(f"losses {ranks[0]['warm_losses']} vs the single "
                   f"rank's {ref_losses}")
    for i, err in enumerate(out["grad_norm_rel_errs"]):
        if not err <= SEP_GNORM_RTOL:
            bad.append(f"step {i} grad norm {ranks[0]['warm_grad_norms'][i]}"
                       f" vs the single rank's {ref_norms[i]}")
    calls = SEP_WARMUP + SEP_STEPS
    for r in ranks:
        need = {"flash_fwd": (r["coord"]["sep"] + 1) * layers,
                "ce_stats": 1, "ce_bwd": 1}
        need["flash_bwd_dq"] = need["flash_bwd_dkv"] = need["flash_fwd"]
        for i, got in enumerate(list(r["warm_launches"])
                                + [r["timed"]["launches_per_step"]]):
            off = {k_: got.get(k_, 0) for k_, v in need.items()
                   if got.get(k_, 0) != v}
            if off:
                bad.append(f"rank {r['rank']} step {i}: launches {off}, "
                           f"want {need}")
        losses = r["warm_losses"] + r["timed"]["losses"]
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"rank {r['rank']}: non-finite loss {losses}")
        for name, rec in r["ce_calls"].items():
            if not rec["ok"] or rec["calls"] != calls:
                bad.append(f"rank {r['rank']} {name}: ok {rec['ok']}, "
                           f"{rec['calls']} calls of {calls}")
    if bad:
        raise AssertionError(f"sep_full_width: {bad}")


# ---------------------------------------------------------------------------
# the launcher and the host plane: 4 ranks started by the port's launcher
# ---------------------------------------------------------------------------

LAUNCH_STEPS = 2             # a run's steps: plain, then recompute
LAUNCH_TIMEOUT_S = 240
LAUNCH_RANK_LIMIT_S = 210    # a rank's own limit, inside the launcher's
LAUNCH_TEARDOWN_S = 60       # the failing launch must end within
LAUNCH_FAIL_CODE = 7
LAUNCH_RPC_CALLS = 20        # rpc round trips timed
LAUNCH_RING_MIN = 64 << 20   # the socket ring's payload, bytes at the least
LAUNCH_CHECKPOINTS = ["llama.layers."]      # the decoder layers


def _launch_strategy(recompute):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    if recompute:
        s.recompute = True
        s.recompute_configs = {"checkpoints": list(LAUNCH_CHECKPOINTS)}
    return s


def _mp_llama(cfg, strategy, seed):
    """(model, hcg): phase 7's seeded model on the card, built whole
    first, then ``fleet.init(strategy)`` and this rank's mp shard of it
    (a model built under an mp group is built sharded)."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.convert import mp_split_axis

    with torch.no_grad():
        full = LlamaForCausalLM(cfg, device="cuda", seed=seed)
        state = {n: p.detach() for n, p in full.named_parameters()}
        hcg = fleet.init(strategy=strategy)
        model = LlamaForCausalLM(cfg, device="cuda")
        mp = hcg.get_model_parallel_group()
        for n, p in model.named_parameters():
            src, ax = state[n], mp_split_axis(n)
            if ax is not None:
                k = src.shape[ax] // mp.nranks
                src = src.narrow(ax, mp.rank * k, k)
            p.copy_(src)
        del full, state
    torch.cuda.empty_cache()
    return model, hcg


def _ring_sum(rows):
    """The socket ring's sum (``SocketPlane.allreduce``): the rows padded
    to a multiple of n, chunk c summed from member c around the ring."""
    import numpy as np

    n, shape = len(rows), rows[0].shape
    flat = [r.reshape(-1) for r in rows]
    pad = (-flat[0].size) % n
    chunks = [np.split(np.concatenate([f, np.zeros(pad, f.dtype)]), n)
              for f in flat]
    out = []
    for c in range(n):
        acc = chunks[c][c].copy()
        for k in range(1, n):
            acc = chunks[(c + k) % n][c] + acc
        out.append(acc)
    return np.concatenate(out)[:flat[0].size].reshape(shape)


def _launch_run(model, label, batches, hcg):
    """LAUNCH_STEPS of `model` from its current weights: 'plain', or
    'recompute' with the strategy's pass (``fleet.distributed_model``)
    wrapping the decoder layers in ``fleet.recompute``."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    target = model
    if label == "recompute":
        # TrainStep(mesh=) builds its own strategy: the recompute
        # strategy's pass goes first
        fleet.init(strategy=_launch_strategy(True))
        target = fleet.distributed_model(model)
    wrapped = sorted(n for n, m in model.named_modules()
                     if getattr(m, "_recompute_wrapped", False))
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(target, _fused_loss, opt, collect_metrics=True,
                     mesh=hcg.mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port_cuda.reset_launch_counts()          # the training path starts here
    out = {"wrapped": wrapped, "losses": [], "grad_norms": [], "step_ms": [],
           "first_step_at": time.time()}
    for b in batches:
        t1 = time.perf_counter()
        loss = step(b)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t1) * 1e3)
        out["losses"].append(float(loss))
        out["grad_norms"].append(step.last_metrics()["grad_norm"])
    launches = port_cuda.launch_counts()     # ... and ends here
    out.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches,
               launches_per_step={k: n / len(batches)
                                  for k, n in launches.items() if n})
    return out


def _launch_ring(model, hcg, rank):
    """One full-width gradient shard (layer 0's down_proj, fp32, made
    distinct a rank) through the socket ring over the dp group, against
    the numpy ring sum of the shards exchanged through the store, and
    gloo's all_reduce of the same bytes."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import collective, multiproc

    dp = hcg.get_data_parallel_group()
    members = list(dp.ranks)
    g = model.llama.layers[0].mlp.down_proj.weight.grad
    shard = g.float().cpu().numpy() * np.float32(rank + 1) + \
        np.float32(0.125 * rank)
    multiproc.subgroup_barrier(members)
    t1 = time.perf_counter()
    ring = multiproc.subgroup_allreduce_np(shard, members)
    ring_s = time.perf_counter() - t1
    rows = multiproc.exchange_objects(shard, ranks=members)
    t = torch.from_numpy(shard.copy())
    collective.barrier(group=dp)
    t1 = time.perf_counter()
    collective.all_reduce(t, group=dp)
    gloo_s = time.perf_counter() - t1
    return {"members": members, "bytes": int(shard.nbytes),
            "equal": bool(np.array_equal(ring, _ring_sum(rows))),
            "gloo_equal": bool(np.array_equal(t.numpy(), ring)),
            "ring_s": ring_s, "gloo_s": gloo_s,
            "ring_gb_s": shard.nbytes / ring_s / 1e9,
            "gloo_gb_s": shard.nbytes / gloo_s / 1e9}


def _launch_rpc_and_lease(rank, world):
    """rank 0's rpc to rank 1 for its peak memory (read by rank 1 itself
    while the ranks wait), the round trip's ms; every rank's elastic
    lease in the job's store and rank 0's watch()."""
    import torch

    from paddle_tpu_torch.distributed import multiproc, rpc
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    out = {}
    rpc.init_rpc(f"worker{rank}")
    multiproc.barrier()
    out["own_peak_bytes"] = torch.cuda.max_memory_allocated()
    multiproc.barrier()
    if rank == 0:
        out["rank1_peak_by_rpc"] = rpc.rpc_sync(
            "worker1", torch.cuda.max_memory_allocated)
        t1 = time.perf_counter()
        for _ in range(LAUNCH_RPC_CALLS):
            rpc.rpc_sync("worker1", os.getpid)
        out["rpc_ms"] = (time.perf_counter() - t1) * 1e3 / LAUNCH_RPC_CALLS
    rpc.shutdown()
    mgr = ElasticManager(rank=rank, world_size=world, lease_ttl=30.0)
    mgr.register()
    multiproc.barrier()
    if rank == 0:
        out.update(watch=mgr.watch(), alive=mgr.alive_ranks(),
                   record=mgr.read_record())
    multiproc.barrier()
    mgr.exit()
    return out


def _launch_gates(r, peaks):
    """This rank's gates (see ``phase_launch_full_width``)."""
    bad = []
    plain, rc = r["runs"]["plain"], r["runs"]["recompute"]
    layers = RANKS_LAYERS
    if plain["wrapped"] or rc["wrapped"] != [f"llama.layers.{i}"
                                             for i in range(layers)]:
        bad.append(f"wrapped {plain['wrapped']} / {rc['wrapped']}")
    for run in (plain, rc):
        if not all(math.isfinite(x) for x in run["losses"]):
            bad.append(f"non-finite loss {run['losses']}")
    for key, rtol in (("losses", FLEET_LOSS_RTOL),
                      ("grad_norms", FLEET_GNORM_RTOL)):
        for a, b in zip(rc[key], plain[key]):
            if not abs(a - b) <= rtol * abs(b):
                bad.append(f"{key}: recompute {rc[key]} vs plain "
                           f"{plain[key]}")
                break
    for run, fwd in ((plain, layers), (rc, 2 * layers)):
        got = run["launches_per_step"]
        if any(got.get(k, 0) != n for k, n in (
                ("flash_fwd", fwd), ("flash_bwd_dq", layers),
                ("flash_bwd_dkv", layers))) or \
                got.get("ce_stats", 0) < 1 or got.get("ce_bwd", 0) < 1:
            bad.append(f"launches a step {got}")
    for name, rec in r["ce_calls"].items():
        if not rec["ok"] or rec["calls"] != 2 * LAUNCH_STEPS:
            bad.append(f"{name}: ok {rec['ok']}, {rec['calls']} calls")
    calls = {"fwd": 3 * layers * LAUNCH_STEPS, "bwd": 2 * layers * LAUNCH_STEPS}
    for name, rec in r["flash_calls"].items():
        if not rec["ok"] or rec["calls"] != calls[name]:
            bad.append(f"flash {name}: ok {rec['ok']}, {rec['calls']} calls")
    ring = r["ring"]
    if not (ring["equal"] and ring["bytes"] >= LAUNCH_RING_MIN):
        bad.append(f"socket ring {ring}")
    if r["rank"] == 0:
        hp = r["host_plane"]
        if hp["rank1_peak_by_rpc"] != peaks[1]:
            bad.append(f"rpc peak {hp['rank1_peak_by_rpc']} vs rank 1's "
                       f"{peaks[1]}")
        if hp["watch"] != "hold" or hp["alive"] != list(range(4)):
            bad.append(f"elastic watch {hp['watch']} alive {hp['alive']}")
    return bad


def _warm_recompute():
    """``fleet.recompute``'s first call imports torch's compiler stack
    (``torch.utils.checkpoint``; about 2 s a process on an idle host,
    9-11 s with four ranks importing at once): made once before the
    steps, so no step carries it. Returns its seconds."""
    import torch

    from paddle_tpu_torch.distributed.fleet import recompute

    t1 = time.perf_counter()
    x = torch.ones(1, requires_grad=True)
    recompute(lambda v: v * 2, x).sum().backward()
    return time.perf_counter() - t1


# ---------------------------------------------------------------------------
# semi-automatic parallelism: dist.to_static inside the launch's training job
# ---------------------------------------------------------------------------

AP_WARM, AP_STEPS = 2, 2         # to_static's steps: held to the plain run,
#                                  then timed
AP_TUNER_TRIALS = 3              # the tuner's first candidates: dp 4, dp 2
#                                  x sharding 2, sharding 4
AP_RESHARD = (4096, 4096)        # the reshards' bf16 tensor
AP_LOGITS_RTOL = 1e-4            # the fused eval loss of a row against the
#                                  fp32 CE over predict()'s bf16 logits


class _ApRows:
    """``_fleet_full_batches``' rows as a map-style dataset, a dict row
    each (the fused head loss takes the labels through the model)."""

    def __init__(self, batches):
        import numpy as np

        self.ids = np.concatenate([b["input_ids"] for b in batches])
        self.labels = np.concatenate([b["labels"] for b in batches])

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "labels": self.labels[i]}

    def __len__(self):
        return len(self.ids)


def _ap_state(model, opt):
    """Device clones of the parameters and the optimizer's state, and its
    step count."""
    return ([p.detach().clone() for p in model.parameters()],
            {i: {k: v.detach().clone() for k, v in st.items()}
             for i, st in opt._state.items()}, opt._step_count)


def _ap_save_load(model, opt, path):
    """``Engine.save``, the parameters and optimizer state zeroed, then
    ``Engine.load``: whether every parameter and moment (and the fp32
    masters and the step count) came back bit for bit."""
    import torch

    from paddle_tpu_torch.distributed.auto_parallel.static import Engine
    from paddle_tpu_torch.distributed.auto_parallel.static.engine import (
        _file)

    before = _ap_state(model, opt)
    eng = Engine(model, _fused_loss, opt)
    t1 = time.perf_counter()
    eng.save(path)
    save_s = time.perf_counter() - t1
    size = os.path.getsize(_file(path))
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
        for st in opt._state.values():
            for v in st.values():
                v.zero_()
    opt._step_count = 0
    t1 = time.perf_counter()
    eng.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    os.remove(_file(path))
    after = _ap_state(model, opt)
    equal = (before[2] == after[2] and set(before[1]) == set(after[1])
             and all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
             and all(set(before[1][i]) == set(after[1][i])
                     and all(torch.equal(v, after[1][i][k])
                             for k, v in before[1][i].items())
                     for i in before[1]))
    return {"equal": equal, "save_s": save_s, "load_s": load_s,
            "file_gb": size / 1e9, "step": after[2]}


def _ap_reshard(rank, seed):
    """reshard s->r over mp, r->s over dp, p->r over mp (each rank's own
    partial values) and s(0)->s(1) over mp of a bf16 AP_RESHARD tensor on
    the card, each against the host's result (numpy's fp32 sum rounded
    once to bf16 for p->r); the device ms of each."""
    import torch

    from paddle_tpu_torch import distributed as dist

    pm = dist.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])
    dp, mp = pm.coord()
    R, S, P = dist.Replicate, dist.Shard, dist.Partial

    def drawn(s):
        g = torch.Generator(device="cuda").manual_seed(s)
        return torch.randn(AP_RESHARD, generator=g, device="cuda").to(
            torch.bfloat16)

    x = drawn(seed + 7)
    host = x.cpu()
    half = AP_RESHARD[1] // 2
    line = [r for r in pm.process_ids if r // 2 == rank // 2]
    parts = [drawn(seed + 100 + r).float().cpu().numpy() for r in line]
    cases = {
        "s_to_r_mp": (x, [R(), S(0)], [R(), R()], host),
        "r_to_s_dp": (x, [R(), R()], [S(1), R()],
                      host[:, dp * half:(dp + 1) * half]),
        "p_to_r_mp": (drawn(seed + 100 + rank), [R(), P()], [R(), R()],
                      torch.from_numpy(sum(parts)).to(torch.bfloat16)),
        "s0_to_s1_mp": (x, [R(), S(0)], [R(), S(1)],
                        host[:, mp * half:(mp + 1) * half])}
    out = {}
    for name, (v, src, dst, want) in cases.items():
        t = (dist.dtensor_from_local(v, pm, src) if name == "p_to_r_mp"
             else dist.shard_tensor(v, pm, src))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = dist.reshard(t, pm, dst)
        torch.cuda.synchronize()
        out[name] = {"ms": (time.perf_counter() - t1) * 1e3,
                     "equal": bool(torch.equal(r._value.cpu(), want)),
                     "shape": list(r._value.shape)}
    return out


def _ap_tuner(seed):
    """``AutoTuner(4, compiled_trial_fn(...), max_trials=AP_TUNER_TRIALS)``
    over phase 6's tiny model (phase 3's config, its packed 4 x 256
    batch) in the live world: the history, the best and the seconds."""
    from paddle_tpu_torch.distributed.auto_tuner import (AutoTuner,
                                                         compiled_trial_fn)
    from paddle_tpu_torch.distributed.mesh import get_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = _tiny_gqa_config()
    batch = _packed_batch(seed, cfg.vocab_size, 256, 4)
    prev = get_mesh()
    tuner = AutoTuner(4, compiled_trial_fn(
        lambda: (LlamaForCausalLM(cfg, device="cuda", seed=seed),
                 _fused_loss),
        lambda c: (batch,),
        lambda params: AdamW(learning_rate=FLEET_LR, parameters=params),
        warmup=1, iters=2), max_trials=AP_TUNER_TRIALS)
    t1 = time.perf_counter()
    best = tuner.search()

    def fields(c):
        return [c.dp, c.mp, c.pp, c.sharding, c.micro_batches,
                c.schedule_mode, c.time_s, c.error]

    return {"history": [fields(c) for c in tuner.history],
            "best": fields(best), "seconds": time.perf_counter() - t1,
            "mesh_back": get_mesh() is prev}


def _ap_logits_loss(logits, labels, fused):
    """The criterion's loss computed in fp32 from predict()'s logits of
    a row (``use_parallel_cross_entropy``: the per-token CE summed over
    the valid tokens, over ALL tokens), beside the fused head loss of the
    same row and the mean over the valid tokens only (torch's default
    reduction, which the criterion does not use)."""
    import torch

    lab = labels.to(logits.device).reshape(-1)
    nll = torch.nn.functional.cross_entropy(
        logits.float().reshape(lab.numel(), -1), lab, ignore_index=-100,
        reduction="sum")
    valid = int((lab != -100).sum())
    return {"fused": fused, "from_logits": float(nll) / lab.numel(),
            "valid_token_mean": float(nll) / valid, "valid": valid,
            "tokens": lab.numel()}


def _auto_parallel_run(cfg, init, seed, out_dir, rank):
    """One rank of ``auto_parallel_full_width``: phase 7's model at dp 2 x
    mp 2 from the launch's initial weights, ``shard_layer``, trained
    through ``dist.to_static(model, loader, loss, opt, strategy)`` on a
    ``DataLoader`` over ``_fleet_full_batches``' rows cut by
    ``shard_dataloader`` (AP_WARM steps held to the plain run, AP_STEPS
    timed; every flash and CE call against its plain version), then
    eval and predict on a held-out batch, Engine save/load, the
    reshards and the tuner."""
    import hashlib

    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, get_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    fleet.reset()
    mesh = get_mesh()
    if mesh is None or dict(mesh.shape) != {"dp": 2, "mp": 2}:
        build_mesh({"dp": 2, "mp": 2})      # else the launch's groups
    with torch.no_grad():
        model = LlamaForCausalLM(cfg, device="cuda")
        for p, v in zip(model.parameters(), init):
            p.copy_(v)
    pm = dist.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])
    dist.shard_layer(model, pm)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    batches = _fleet_full_batches(cfg, seed, steps=AP_WARM + AP_STEPS)
    loader = dist.shard_dataloader(
        pio.DataLoader(_ApRows(batches), batch_size=2), pm)
    dm = dist.to_static(model, loader, _fused_loss, opt, strategy)
    dm.collect_metrics = True
    ce, flash = _CeCalls(), _RingCalls(fa, rows_only=True)
    for c in (ce, flash):
        c.defer = c.host = True   # the steps carry no reference work
    rec = {"losses": [], "grad_norms": [], "step_ms": [], "rows": [],
           "vocab": cfg.vocab_size}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port_cuda.reset_launch_counts()          # the to_static path starts here
    for b in loader:
        t1 = time.perf_counter()
        loss = dm(b)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t1) * 1e3)
        rec["losses"].append(float(loss))
        rec["grad_norms"].append(dm.last_metrics()["grad_norm"])
        rec["rows"].append(int(b["input_ids"].shape[0]))
    launches = port_cuda.launch_counts()     # ... and ends here
    n = len(rec["losses"])
    rec.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches,
               launches_per_step={k: v / n for k, v in launches.items()
                                  if v})
    _launch_note(f"to_static steps {rec['step_ms']} ms")
    ce.check_deferred()
    flash.check_deferred()
    ce.restore()
    flash.restore()
    rec.update(ce_calls={k: {f: v[f] for f in ("calls", "worst", "ok")}
                         for k, v in ce.out.items()},
               flash_calls=flash.out)
    # a held-out batch (the run trained on the others: at lr 1e-4 the 7B
    # width memorises a batch within a few steps)
    g = {k: torch.from_numpy(v) for k, v in _fleet_full_batches(
        cfg, seed, steps=AP_WARM + AP_STEPS + 1)[-1].items()}
    dm.eval()
    rec["eval_loss"] = float(dm(g))
    row = {k: v[:1] for k, v in g.items()}
    fused_row = float(dm(row))
    dm.predict()
    logits = dm({"input_ids": row["input_ids"]})._value
    rec["predict"] = {"shape": list(logits.shape),
                      "finite": bool(torch.isfinite(logits).all()),
                      "sha256": hashlib.sha256(
                          logits.float().cpu().numpy().tobytes()).hexdigest()}
    rec["eval_vs_logits"] = _ap_logits_loss(logits, row["labels"], fused_row)
    del logits
    rec["save_load"] = _ap_save_load(model, opt,
                                     os.path.join(out_dir, "engine"))
    _launch_note(f"eval, predict, save/load done: {rec['save_load']}")
    del dm, model, opt, loader
    gc.collect()
    torch.cuda.empty_cache()
    rec["reshard"] = _ap_reshard(rank, seed)
    rec["tuner"] = _ap_tuner(seed)
    _launch_note(f"reshards and tuner done: {rec['tuner']['history']}")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _launch_train_rank(out_dir, seed):
    """One rank of ``launch_full_width``'s training launch."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, multiproc
    from paddle_tpu_torch.distributed.fleet.utils import LocalFS
    from paddle_tpu_torch.models import llama_7b_config
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    _rank_threads()
    # the launcher's contract; ranks sharing one card ask for gloo
    env = dist.init_parallel_env(backend="gloo")
    rank = env.rank
    _launch_note("init_parallel_env done")
    warm_s = _warm_recompute()
    _launch_note(f"recompute warmed in {warm_s:.1f} s")
    cfg = llama_7b_config(num_hidden_layers=RANKS_LAYERS, dtype="bfloat16")
    model, hcg = _mp_llama(cfg, _launch_strategy(False), seed)
    init = [p.detach().clone() for p in model.parameters()]
    batches = _fleet_full_batches(cfg, seed, steps=LAUNCH_STEPS)
    _launch_note("model and batches built")
    ce, flash = _CeCalls(), _RingCalls(fa, rows_only=True)
    for c in (ce, flash):
        c.defer = c.host = True   # the steps carry no reference work
    out = {"rank": rank, "coord": hcg.mesh.coord(),
           "backend": collective.get_backend(),
           "local_size": os.environ.get("PADDLE_LOCAL_SIZE"),
           "session": os.environ.get("PADDLE_JOB_SESSION"),
           "recompute_first_call_s": warm_s, "runs": {}}
    for label in ("plain", "recompute"):
        with torch.no_grad():
            for p, v in zip(model.parameters(), init):
                p.copy_(v)
        out["runs"][label] = _launch_run(model, label, batches, hcg)
        _launch_note(f"{label} steps {out['runs'][label]['step_ms']} ms")
        ce.check_deferred()
        flash.check_deferred()
        _launch_note(f"{label} calls checked")
    ce.restore()
    flash.restore()
    out.update(ce_calls=ce.out, flash_calls=flash.out,
               ring=_launch_ring(model, hcg, rank))
    _launch_note("socket ring done")
    del model            # the plain and recompute runs' model
    gc.collect()
    torch.cuda.empty_cache()
    try:
        out["auto_parallel"] = _auto_parallel_run(cfg, init, seed, out_dir,
                                                  rank)
    except Exception:
        out["auto_parallel"] = {"error": traceback.format_exc()[-3000:]}
    del init
    _launch_note("auto_parallel done")
    out["host_plane"] = _launch_rpc_and_lease(rank, env.world_size)
    _launch_note("rpc and leases done")
    peaks = multiproc.exchange_objects(out["host_plane"]["own_peak_bytes"])
    out["bad"] = _launch_gates(out, peaks)
    ranks = multiproc.exchange_objects(out)
    if rank == 0:             # the ranks' report, written through LocalFS
        fs = LocalFS()
        fs.mkdirs(out_dir)
        stage = os.path.join(out_dir, "report.json.part")
        with open(stage, "w") as fh:
            json.dump(ranks, fh, default=str)
        fs.mv(stage, os.path.join(out_dir, "report.json"), overwrite=True)
    multiproc.barrier()
    dist.destroy_process_group()
    if out["bad"]:
        print(f"LAUNCH_RANK_BAD {rank} {out['bad']}", flush=True)
        return 1
    print(f"LAUNCH_RANK_OK {rank}", flush=True)
    return 0


def _launch_teardown_rank(out_dir, seed):
    """One rank of the teardown launch: phase 3's tiny model at dp 4, one
    step; then rank 3 exits LAUNCH_FAIL_CODE while the others wait in the
    second step's gloo all-reduce for it."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    with open(os.path.join(out_dir, f"pid.{rank}"), "w") as fh:
        fh.write(str(os.getpid()))
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo")
    cfg = _tiny_gqa_config()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    step = TrainStep(model, _fused_loss, AdamW(
        learning_rate=FLEET_LR, parameters=model.parameters()),
        mesh=build_mesh({"dp": 4}))
    batch = _packed_batch(seed, cfg.vocab_size, 256, 4)
    step(batch)
    torch.cuda.synchronize()
    if rank == 3:
        with open(os.path.join(out_dir, "exit.3"), "w") as fh:
            fh.write(repr(time.time()))
        os._exit(LAUNCH_FAIL_CODE)
    step(batch)
    torch.cuda.synchronize()
    print(f"rank {rank}: the second step ended without rank 3", flush=True)
    return 0


_LAUNCH_T0 = time.perf_counter()   # a launched rank's notes count from here


def _launch_note(msg):
    """A timestamped progress line in this rank's workerlog, so a launch
    that runs past its time shows how far each rank got."""
    print(f"[rank {os.environ.get('PADDLE_TRAINER_ID')} "
          f"+{time.perf_counter() - _LAUNCH_T0:.1f} s] {msg}",
          file=sys.stderr, flush=True)


def launch_worker(mode, seed, out_dir) -> int:
    """A rank started by ``phase_launch_full_width``'s launcher. A rank
    that its launcher ends with SIGTERM writes every thread's stack to
    its workerlog first."""
    import faulthandler
    import signal

    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    # a rank still running near the launcher's limit writes its stacks and
    # exits non-zero, so the launcher returns and the phase says where
    faulthandler.dump_traceback_later(LAUNCH_RANK_LIMIT_S, exit=True)
    _launch_note(f"{mode} rank started, pid {os.getpid()}")
    if mode == "train":
        return _launch_train_rank(out_dir, seed)
    return _launch_teardown_rank(out_dir, seed)


def _run_launcher(mode, seed, out_dir, timeout):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4
    ... chip_smoke.py --launch-worker <mode>``; (returncode, output,
    seconds, start time). A launcher past `timeout` gets SIGTERM (it
    ends its ranks) and then SIGKILL."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "4", "--log_dir",
           os.path.join(out_dir, "log"), "--job_id", f"chip_launch_{mode}",
           os.path.join(REPO, "chip_smoke.py"), "--launch-worker", mode,
           "--seed", str(seed), "--out", out_dir]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        text = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            text = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0]
        text += f"\nchip_smoke: the launcher ran past {timeout} s"
    return proc.returncode, text, time.time() - t0, t0


def _teardown_launch(seed):
    """The teardown launch (``_launch_teardown_rank``) and, as soon as its
    launcher has returned, which of its ranks are alive or on the card
    (nvidia-smi's compute apps): (record, the launcher's output)."""
    import tempfile

    down = tempfile.mkdtemp(prefix="launch_down_")
    rc, text, down_s, t0 = _run_launcher("teardown", seed, down,
                                         LAUNCH_TEARDOWN_S + 60)
    pids = [int(open(os.path.join(down, f"pid.{r}")).read())
            for r in range(4) if os.path.exists(os.path.join(down,
                                                             f"pid.{r}"))]
    on_card = _compute_app_pids()
    exit_at = os.path.join(down, "exit.3")
    return {"launcher_rc": rc, "seconds": down_s,
            "after_rank3_exit_s": (t0 + down_s - float(open(exit_at).read())
                                   if os.path.exists(exit_at) else None),
            "pids": pids, "alive": [p for p in pids if _pid_alive(p)],
            "on_card": [p for p in pids if p in on_card],
            "compute_apps": on_card}, text


def _compute_app_pids():
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return sorted(int(x) for x in res.stdout.split() if x.strip().isdigit())


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def phase_launch_full_width(args, report):
    """The port's launcher starts 4 gloo ranks on the card (``python -m
    paddle_tpu_torch.distributed.launch --nproc_per_node 4 ...
    chip_smoke.py --launch-worker train``): ``init_parallel_env`` from the
    launch contract, fleet at dp 2 x mp 2, phase 7's model at
    RANKS_LAYERS layers (bf16, fp32 masters, AdamW, the fused head
    loss, seq 4096, ``_fleet_full_batches``), LAUNCH_STEPS steps plain
    and LAUNCH_STEPS with ``strategy.recompute`` wrapping each decoder
    layer in ``fleet.recompute``, from the same weights and rows. Each
    rank's gates (``_launch_gates``): the recompute's losses and
    gradient norms within FLEET_LOSS_RTOL / FLEET_GNORM_RTOL of the plain
    run's (bit equality is recorded), flash_fwd launched 2 x layers a
    step under recompute and 1 x layers without, every flash and CE call
    within its plain version's rule (``_RingCalls``, ``_CeCalls``); a
    gradient shard of at least 64 MiB through the socket ring over the
    dp group equal to the numpy ring sum of the shards exchanged by
    ``exchange_objects``; rank 0's ``rpc_sync`` for rank 1's peak memory
    equal to rank 1's own; every rank's elastic lease and rank 0's
    ``watch()`` HOLD; rank 0 writes the report through ``LocalFS``. The
    launcher returns 0 and each ``workerlog.<rank>`` holds its ok line.
    Beside it, the teardown launch: rank 3 exits LAUNCH_FAIL_CODE after one
    step of the tiny model while the others wait in gloo; the launcher
    returns that code within LAUNCH_TEARDOWN_S, and no rank it started
    is alive or on the card (nvidia-smi's compute apps). Prints the
    seconds from launch to every rank's first step, step ms and peak GB
    a rank with and without recompute, the launches, the ring's GB/s
    against gloo's all_reduce of the same bytes, the rpc round trip and
    the teardown's seconds: 4 ranks time-sharing one card through host
    memory, no multi-GPU figure."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="launch_full_")
    # the teardown launch runs beside the training launch: its tiny ranks
    # need little of the card or the host, and the script's time is short
    with ThreadPoolExecutor(1) as pool:
        teardown = pool.submit(_teardown_launch, args.seed)
        rc, text, wall_s, t0 = _run_launcher("train", args.seed, tmp,
                                             LAUNCH_TIMEOUT_S)
        td, down_text = teardown.result()
    logs = {r: open(os.path.join(tmp, "log", f"workerlog.{r}")).read()
            if os.path.exists(os.path.join(tmp, "log", f"workerlog.{r}"))
            else "" for r in range(4)}
    bad = []
    if rc != 0:
        bad.append(f"the launcher returned {rc}: {text[-2000:]}")
    for r, log in logs.items():
        if f"LAUNCH_RANK_OK {r}" not in log:
            notes = [ln for ln in log.splitlines() if ln.startswith("[rank")]
            bad.append(f"workerlog.{r} holds no ok line; its last notes "
                       f"{notes[-3:]}; its end: {log[-1500:]}")
    path = os.path.join(tmp, "report.json")
    if not os.path.exists(path):
        raise AssertionError(f"launch_full_width: no report; {bad}")
    with open(path) as fh:
        ranks = json.load(fh)
    # the same job's to_static run: auto_parallel_full_width reads it
    report["_auto_parallel_ranks"] = [
        {"rank": r["rank"], "coord": r["coord"],
         "plain": r["runs"]["plain"], "run": r.get("auto_parallel")}
        for r in ranks]
    launches = {}
    for r in ranks:
        bad += [f"rank {r['rank']}: {b}" for b in r["bad"]]
        for run in r["runs"].values():
            for k, n in run["launches"].items():
                launches[k] = launches.get(k, 0) + n
    first = [r["runs"]["plain"]["first_step_at"] - t0 for r in ranks]
    r0 = ranks[0]
    out = {"layers": RANKS_LAYERS, "seq": TRAIN_SEQ, "steps": LAUNCH_STEPS,
           "layout": "dp 2 x mp 2, 4 gloo ranks on one card, started by "
                     "paddle_tpu_torch.distributed.launch",
           "launcher_rc": rc, "wall_s": wall_s,
           "launch_to_first_step_s": max(first),
           "bit_equal": all(r["runs"]["recompute"][k] == r["runs"]["plain"][k]
                            for r in ranks for k in ("losses", "grad_norms")),
           "launches": launches,
           "ring": {k: r0["ring"][k] for k in ("bytes", "ring_gb_s",
                                               "gloo_gb_s", "equal",
                                               "gloo_equal")},
           "rpc_ms": r0["host_plane"].get("rpc_ms"),
           "ranks": [{"rank": r["rank"], "coord": r["coord"],
                      "backend": r["backend"], "local_size": r["local_size"],
                      "recompute_first_call_s": r["recompute_first_call_s"],
                      **{label: {k: run[k] for k in (
                          "losses", "grad_norms", "step_ms", "peak_mem_gb",
                          "launches_per_step")}
                         for label, run in r["runs"].items()},
                      "ce_calls": {k: {f: v[f] for f in ("calls", "worst",
                                                         "ok")}
                                   for k, v in r["ce_calls"].items()},
                      "flash_calls": r["flash_calls"],
                      "ring_gb_s": r["ring"]["ring_gb_s"],
                      "gloo_gb_s": r["ring"]["gloo_gb_s"]}
                     for r in ranks]}
    report["launch_full_width"] = out
    for r in out["ranks"]:
        print(f"launch full width rank {r['rank']} {r['coord']} "
              f"({report.get('gpu')}; 4 ranks time-sharing one card "
              f"through gloo): " + json.dumps(r), flush=True)
    print(f"launch full width ({report.get('gpu')}): " + json.dumps(
        {k: v for k, v in out.items() if k != "ranks"}), flush=True)

    out["teardown"] = td
    print(f"launch teardown ({report.get('gpu')}): " + json.dumps(td),
          flush=True)
    if td["launcher_rc"] != LAUNCH_FAIL_CODE:
        bad.append(f"teardown: the launcher returned {td['launcher_rc']}, "
                   f"not {LAUNCH_FAIL_CODE}: {down_text[-2000:]}")
    if td["seconds"] > LAUNCH_TEARDOWN_S:
        bad.append(f"teardown took {td['seconds']:.1f} s")
    if len(td["pids"]) != 4 or td["alive"] or td["on_card"]:
        bad.append(f"teardown left ranks: {td}")
    if bad:
        raise AssertionError(f"launch_full_width: {bad}")


# ---------------------------------------------------------------------------
# elastic checkpoints across layouts (riding the tiny 4-rank ZeRO-3 and
# pipeline phases) and self-healing training at full width
# ---------------------------------------------------------------------------

CKPT_STEPS = 2               # steps before a save, and after it
# the full-width run: phase 7's LLaMA at one layer (a snapshot of the bf16
# parameters, fp32 masters and moments is about 6.5 GB a layer's worth of
# disk a save), 6 batches, a snapshot every 3 (step 0, 3 and 6: the last
# one killed before its COMMIT), the NaN learning rate at batch 4
RESIL_LAYERS = 1
RESIL_BATCHES = 6
RESIL_EVERY = 3
RESIL_NAN_AT = 4


def _pipe_canonical(mods, idx, n_layers):
    """A pipeline rank's stage modules under the single LLaMA's canonical
    prefixes (``elastic.capture_modules``)."""
    out = {}
    if 0 in mods:
        out["llama."] = mods[0]
    for i in idx:
        out[f"llama.layers.{i}."] = mods[i + 1]
    if n_layers + 1 in mods:
        out["llama.norm."] = mods[n_layers + 1].norm
        out["lm_head."] = mods[n_layers + 1].lm_head
    return out


def _pipe_restore(mods, idx, n_layers, opt, arrays, meta):
    """A single-LLaMA snapshot into a pipeline rank's stage modules and
    its optimizer, by name."""
    from paddle_tpu_torch.distributed.checkpoint import elastic

    if 0 in mods:
        elastic.restore(arrays, meta, mods[0], opt,
                        mapper={"model/llama.": "model/",
                                "opt/llama.": "opt/"})
    for i in idx:
        elastic.restore(arrays, meta, mods[i + 1], opt,
                        mapper={f"model/llama.layers.{i}.": "model/",
                                f"opt/llama.layers.{i}.": "opt/"})
    if n_layers + 1 in mods:
        elastic.restore(arrays, meta, mods[n_layers + 1], opt,
                        mapper={"model/llama.norm.": "model/norm.",
                                "opt/llama.norm.": "opt/norm.",
                                "model/lm_head.": "model/lm_head.",
                                "opt/lm_head.": "opt/lm_head."})


CKPT_LAYOUTS = {                  # kind: (route, mesh axes, ZeRO)
    "dp4": ("train_step", {"dp": 4}, None),
    "zero3_sharding4": ("train_step", {"sharding": 4}, "sharding"),
    "mp2_dp2": ("train_step", {"dp": 2, "mp": 2}, None),
    "pp2_dp2": ("1f1b", {"pp": 2, "dp": 2}, None)}


def _ckpt_layout(kind, cfg, named, batch, dev, arrays=None, meta=None):
    """(run, capture, gathered) of one resume-case layout on this rank:
    built from `named`, or restored from a snapshot (`arrays`, `meta`)
    before the step is built. `gathered()` gives the full JAX-layout
    parameters on every rank (the layout's own gathers: ZeRO-3's
    ``state_dict``, the mp and pp ranks' shares over their groups), as
    numpy."""
    import torch
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.checkpoint import elastic
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu_torch.models import (from_paddle_tpu_params,
                                         gather_paddle_tpu_params)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    route, axes, zero = CKPT_LAYOUTS[kind]
    n_layers = cfg.num_hidden_layers
    fleet.reset()
    set_mesh(None)
    mesh = build_mesh(axes)

    def over(group, share):
        parts = [None] * group.nranks
        tdist.all_gather_object(parts, share, group=group.pg)
        return parts

    if route == "1f1b":
        from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
        from paddle_tpu_torch.parallel.pipeline import (PipelinedTrainStep,
                                                        pipeline_hcg)

        hcg, _ = pipeline_hcg(mesh)
        mods, idx = _pipe_stage(cfg, hcg, n_layers, 1, dev, named=named)
        opt = AdamW(learning_rate=FLEET_LR,
                    parameters=[p for m in mods.values()
                                for p in m.parameters()],
                    weight_decay=0.01)
        if arrays is not None:
            _pipe_restore(mods, idx, n_layers, opt, arrays, meta)
        step = PipelinedTrainStep(
            mods.get(0), [mods[i + 1] for i in idx], mods.get(n_layers + 1),
            LlamaPretrainingCriterion(cfg), optimizer=opt, mesh=mesh,
            num_micro=2, remat="none")
        kw = {"segment_ids": batch["segment_ids"],
              "position_ids": batch["position_ids"]}

        def run():
            return float(step(batch["input_ids"], batch["labels"], **kw))

        def capture():
            return elastic.capture_modules(_pipe_canonical(mods, idx,
                                                           n_layers),
                                           step.optimizer, step.step_count)

        def gathered():
            share = {f"{k}{n}": p.detach().cpu().clone() for k, m in
                     _pipe_canonical(mods, idx, n_layers).items()
                     for n, p in m.named_parameters()}
            merged = {}
            for part in over(hcg.get_pipe_parallel_group(), share):
                merged.update(part)
            return gather_paddle_tpu_params([merged])
        return run, capture, gathered
    model = from_paddle_tpu_params(named, cfg, device=dev)
    opt = AdamW(learning_rate=FLEET_LR, parameters=model.parameters(),
                weight_decay=0.01)
    if arrays is not None:
        missing, _ = elastic.restore(arrays, meta, model, opt)
        if missing:
            raise AssertionError(f"{kind}: the snapshot lacks {missing}")
    step = TrainStep(model, _fused_loss, opt, mesh=mesh, zero_axis=zero,
                     zero_stage=3 if zero else 1)
    if arrays is not None:
        step.load_resume_extras(arrays, meta)

    def run():
        return float(step(batch))

    def capture():
        return elastic.capture(step)

    def gathered():
        if zero:
            share = {n: v.detach().cpu()
                     for n, v in step.model.state_dict().items()}
        else:
            share = {n: p.detach().cpu().clone()
                     for n, p in model.named_parameters()}
        if axes.get("mp", 1) > 1:
            from paddle_tpu_torch.distributed.fleet import (
                get_hybrid_communicate_group)

            parts = over(get_hybrid_communicate_group()
                         .get_model_parallel_group(), share)
        else:
            parts = [share]
        return gather_paddle_tpu_params(parts)
    return run, capture, gathered


def _ckpt_resume_cases(cfg, named, batch, root, saves, resumes,
                       dev="cuda"):
    """This rank's resume cases on `dev` (cuda:0): each layout of `saves`
    trains CKPT_STEPS steps, saves into root/<kind> (every rank, the
    elastic commit protocol), trains CKPT_STEPS more; each (src, dst) of
    `resumes` restores src's snapshot into dst's layout and trains
    CKPT_STEPS steps. The port kernels' launches are counted over it."""
    import torch

    from paddle_tpu_torch.distributed.checkpoint import elastic
    from paddle_tpu_torch.ops import cuda as port_cuda

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    port_cuda.reset_launch_counts()
    out = {"layouts": {}, "resumes": {}}
    for kind in saves:
        run, capture, gathered = _ckpt_layout(kind, cfg, named, batch, dev)
        rec = {"losses": [run() for _ in range(CKPT_STEPS)]}
        with elastic.CheckpointManager(os.path.join(root, kind)) as mgr:
            mgr.save(capture())
            rec["step"] = mgr.latest()
        rec["saved"] = gathered()
        rec["losses"] += [run() for _ in range(CKPT_STEPS)]
        rec["final"] = gathered()
        out["layouts"][kind] = rec
    for src, dst in resumes:
        mgr = elastic.CheckpointManager(os.path.join(root, src))
        arrays, meta = mgr.load()
        mgr.close()
        run, _, gathered = _ckpt_layout(dst, cfg, named, batch, dev,
                                        arrays, meta)
        out["resumes"][f"{src}->{dst}"] = {
            "losses": [run() for _ in range(CKPT_STEPS)],
            "final": gathered()}
    sync()
    out["launches"] = {k: n for k, n in port_cuda.launch_counts().items()
                       if n}
    out["seconds"] = time.perf_counter() - t0
    return out


def _ckpt_resume_check(ranks, root, lr, bad):
    """The resume cases against the phase's rule (per-step losses within
    1e-4 relative of the target layout's uninterrupted run, the final
    parameters within lr), every rank's losses alike, and each save read
    back (``read_global_state``) bit-equal to the ranks' gathered
    parameters at the save."""
    import numpy as np

    from paddle_tpu_torch.distributed.checkpoint import read_global_state

    res = [r["resume"] for r in ranks]
    out = {"layouts": {}, "resumes": {},
           "seconds": max(r["seconds"] for r in res), "launches": {}}
    for r in res:
        for k, n in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    for kind, rec in res[0]["layouts"].items():
        full = read_global_state(os.path.join(
            root, kind, f"step_{rec['step']:08d}"))
        exact = all(np.array_equal(full[f"model/{n}"].numpy(), v)
                    for n, v in rec["saved"].items())
        keys = sorted(k for k in full if k.startswith("model/"))
        out["layouts"][kind] = {"losses": rec["losses"],
                                "saved_equals_gathered": exact,
                                "model_keys": len(keys)}
        if not exact or len(keys) != len(rec["saved"]):
            bad.append(f"resume {kind}: the save does not read back as the "
                       f"gathered parameters")
        if any(r["layouts"][kind]["losses"] != rec["losses"] for r in res):
            bad.append(f"resume {kind}: ranks' losses differ")
    for pair, rec in res[0]["resumes"].items():
        src, dst = pair.split("->")
        want = res[0]["layouts"][dst]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(rec["losses"], want["losses"][CKPT_STEPS:]))
        p_err = max(float(np.abs(rec["final"][n] - want["final"][n]).max())
                    for n in want["final"])
        out["resumes"][pair] = {
            "losses": rec["losses"], "loss_rel_err": rel,
            "param_max_abs_err": p_err,
            "bit_equal_target": rec["losses"] ==
            want["losses"][CKPT_STEPS:],
            "bit_equal_source": rec["losses"] ==
            res[0]["layouts"][src]["losses"][CKPT_STEPS:]}
        if not (rel <= 1e-4 and p_err <= lr):
            bad.append(f"resume {pair}: loss {rel:.3g}, params {p_err:.3g}")
        if any(r["resumes"][pair]["losses"] != rec["losses"] for r in res):
            bad.append(f"resume {pair}: ranks' losses differ")
    return out


def _resil_batch(seed, vocab, seq, i):
    """Batch `i` of the full-width resilient run, a function of its index
    only (a replay must see the same data)."""
    import numpy as np

    rng = np.random.RandomState(seed * 7919 + i)
    ids = rng.randint(1, vocab, (1, seq + 1))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _same_state(a, b):
    """Parameters and optimizer states of two TrainSteps bit-equal?"""
    import torch

    from paddle_tpu_torch.distributed.checkpoint.elastic import (
        innermost_opt)

    pa, pb = dict(a.model.named_parameters()), dict(
        b.model.named_parameters())
    if any(not torch.equal(pa[n], pb[n]) for n in pa):
        return False
    sa, sb = innermost_opt(a.optimizer)[0], innermost_opt(b.optimizer)[0]
    return sa._state.keys() == sb._state.keys() and all(
        torch.equal(v, sb._state[i][k]) for i, st in sa._state.items()
        for k, v in st.items())


def _resilience_run(cfg, dev, seed, seq, root):
    """The fault-free reference (timed steps), then ``run_resilient`` with
    a NaN learning rate at RESIL_NAN_AT and the third save killed before
    its COMMIT, then a fresh step restored from the last commit: the
    numbers and checks of ``phase_resilience_full_width``."""
    import shutil

    import torch

    from paddle_tpu_torch.core.flags import flag, set_flags
    from paddle_tpu_torch.distributed.checkpoint import elastic
    from paddle_tpu_torch.distributed.resilience import faults, run_resilient
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as port_cuda
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    built = {}

    def build(det=False, arrays=None, meta=None):
        model = LlamaForCausalLM(cfg, device=dev, seed=seed)
        opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                    weight_decay=0.01, multi_precision=True)
        if arrays is not None:
            elastic.restore(arrays, meta, model, opt)
        step = TrainStep(model, _fused_loss, opt, anomaly_detector=det,
                         metrics_every=0)
        if arrays is not None:
            step.load_resume_extras(arrays, meta)
        built["step"] = step
        return step

    n = RESIL_BATCHES
    batches = [_resil_batch(seed, cfg.vocab_size, seq, i) for i in range(n)]
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"layers": cfg.num_hidden_layers, "seq": seq, "batches": n,
           "every": RESIL_EVERY, "nan_at": RESIL_NAN_AT,
           "disk_free_gb": shutil.disk_usage(root).free / 1e9}
    ref = build()
    built.pop("step")
    losses, step_ms = [], []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        losses.append(float(ref(b)))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["ref_losses"], out["step_ms"] = losses, step_ms
    keep = flag("ckpt_keep_last")
    set_flags({"ckpt_keep_last": 1})
    faults.reset()
    faults.arm("step.grads", mode="nth", nth=RESIL_NAN_AT + 1)
    faults.arm("ckpt.before_commit", mode="nth", nth=3)
    port_cuda.reset_launch_counts()       # the resilient run starts here
    t0 = time.perf_counter()
    try:
        rep = run_resilient(
            build, lambda start: iter(batches[start:]), n, root,
            ckpt_every=RESIL_EVERY, feed_depth=2, device=dev)
    finally:
        faults.reset()
        set_flags({"ckpt_keep_last": keep})
    sync()
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in port_cuda.launch_counts().items()
                       if v}                 # ... and ends here
    chaos = built.pop("step")
    out["status"], out["losses"] = rep["status"], rep["losses"]
    out["incidents"] = [{k: v for k, v in e.items() if k != "ts"}
                        for e in rep["incidents"]]
    out["timings"] = rep["ckpt_timings"]
    out["rollback_bit_equal"] = (
        [rep["losses"].get(i) for i in range(n)] == losses)
    out["final_state_bit_equal"] = _same_state(chaos, ref)
    del chaos
    mgr = elastic.CheckpointManager(root)
    out["committed"] = mgr.steps()
    out["uncommitted_left"] = sorted(
        d for d in os.listdir(root) if d.startswith("step_")
        and not os.path.exists(os.path.join(root, d, "COMMIT")))
    t0 = time.perf_counter()
    arrays, meta = mgr.load()
    out["load_s"] = time.perf_counter() - t0
    mgr.close()
    fresh = build(False, arrays, meta)
    built.pop("step")
    del arrays
    start = int(meta["cursor"]["batches"])
    out["restored_at"] = start
    out["restored_losses"] = [float(fresh(b)) for b in batches[start:]]
    sync()
    out["restored_bit_equal"] = (out["restored_losses"] == losses[start:]
                                 and _same_state(fresh, ref))
    del fresh, ref
    shutil.rmtree(root, ignore_errors=True)
    return out


def phase_resilience_full_width(args, report):
    """Phase 7's LLaMA (7B width, bf16, AdamW with fp32 masters) at
    RESIL_LAYERS layer(s), seq TRAIN_SEQ, through ``run_resilient`` over
    RESIL_BATCHES batches with a snapshot every RESIL_EVERY (keep-last 1):
    ``step.grads`` poisons batch RESIL_NAN_AT's learning rate, the next
    step's non-finite loss rolls back to step RESIL_EVERY's snapshot, and
    the third save is killed before its COMMIT. The rollback's losses and
    final parameters and optimizer states must equal the fault-free run's
    bit for bit, the killed commit must leave the previous snapshot
    loadable, and a fresh TrainStep restored from it must continue
    bit-equal; the flash and CE kernels must launch. Prints the snapshot's
    GB, the caller-thread capture ms against the step's ms, each save's
    host copy, write, fsync and commit seconds and write GB/s, and the load
    seconds, beside the card's name and power limit."""
    import statistics as stats

    from paddle_tpu_torch.models import llama_7b_config

    cfg = llama_7b_config(num_hidden_layers=RESIL_LAYERS, dtype="bfloat16")
    out = _resilience_run(cfg, "cuda", args.seed, TRAIN_SEQ,
                          os.path.join(REPO, ".ckpt_smoke"))
    out["gpu"] = report.get("gpu")
    saves = [t for t in out["timings"] if "bytes" in t]
    out["snapshot_gb"] = max(t["bytes"] for t in saves) / 1e9 if saves \
        else None
    out["median_step_ms"] = stats.median(out["step_ms"][1:])
    out["capture_ms"] = [t["capture_ms"] for t in out["timings"]]
    out["write_gb_per_s"] = [t["bytes"] / 1e9 / t["write_s"]
                             for t in saves]
    report["resilience_full_width"] = out
    print("resilience_full_width: " + json.dumps(out), flush=True)
    bad = []
    events = [e["event"] for e in out["incidents"]]
    if out["status"] != "ok" or events != ["anomaly", "rollback",
                                           "ckpt_save_failed"]:
        bad.append(f"status {out['status']}, incidents {events}")
    if not out["rollback_bit_equal"] or not out["final_state_bit_equal"]:
        bad.append("the rollback does not repeat the fault-free run")
    if out["committed"] != [RESIL_EVERY] or not out["uncommitted_left"]:
        bad.append(f"killed commit: committed {out['committed']}, "
                   f"uncommitted {out['uncommitted_left']}")
    if not out["restored_bit_equal"]:
        bad.append("the restored step does not continue bit-equal")
    layers = cfg.num_hidden_layers
    need = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "ce_stats": 1, "ce_bwd": 1}
    short = {k: out["launches"].get(k, 0) for k in need
             if out["launches"].get(k, 0) < need[k]}
    if short:
        bad.append(f"kernels not launched: {short}")
    if bad:
        raise AssertionError(f"resilience_full_width: {bad}")


def phase_auto_parallel_full_width(report):
    """Reads the to_static run that ``launch_full_width``'s training job
    made after its plain and recompute runs (``_auto_parallel_run``; this
    phase needs that one in the same run): phase 7's model at dp 2 x mp 2
    (bf16, fp32 masters, AdamW, the fused head loss, seq 4096,
    RANKS_LAYERS layers) from the plain run's weights, ``shard_layer``,
    ``dist.to_static(model, loader, loss, opt, strategy)`` fed by a
    ``DataLoader`` over ``_fleet_full_batches``' rows through
    ``shard_dataloader``, AP_WARM + AP_STEPS steps. Gates, on every rank:
    the first AP_WARM losses and gradient norms within FLEET_LOSS_RTOL /
    FLEET_GNORM_RTOL of the plain run's on the same weights and rows (bit
    equality recorded); a row a step from the sharded loader; flash_fwd,
    flash_bwd_dq and flash_bwd_dkv launched RANKS_LAYERS times a step and
    the CE kernels at least once; every flash call by its row rule and
    every CE call by ``_CeCalls``; ``eval()`` the same finite loss on
    every rank and ``predict()`` the same full-vocabulary logits of one
    row on every rank (their sha256), on a held-out batch; the fused
    eval loss of that row within AP_LOGITS_RTOL of the criterion's loss
    computed in fp32 from predict()'s logits (``_ap_logits_loss``);
    ``Engine.save`` -> ``Engine.load`` restoring parameters, moments,
    masters and the step count bit for bit; ``reshard`` s->r, r->s, p->r
    and s(0)->s(1) of a [4096, 4096] bf16 tensor equal to the host's
    result; the tuner's history and best
    the same on every rank with no failed trial. Prints step ms, peak GB
    and launches a rank, the reshards' ms, each trial's seconds, the
    save/load seconds and the phase's seconds: 4 ranks time-sharing one
    card through gloo, no multi-GPU figure."""
    ranks = report.pop("_auto_parallel_ranks", None)
    if ranks is None:
        raise AssertionError("auto_parallel_full_width: needs "
                             "launch_full_width's training job in this run")
    bad = [f"rank {r['rank']}: {r['run']['error']}" for r in ranks
           if r["run"] is None or "error" in r["run"]]
    if bad:
        raise AssertionError(f"auto_parallel_full_width: {bad}")
    layers = RANKS_LAYERS
    steps = AP_WARM + AP_STEPS
    launches = {}
    for r in ranks:
        run, plain, who = r["run"], r["plain"], f"rank {r['rank']}"
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for key, rtol in (("losses", FLEET_LOSS_RTOL),
                          ("grad_norms", FLEET_GNORM_RTOL)):
            for a, b in zip(run[key][:AP_WARM], plain[key]):
                if not abs(a - b) <= rtol * abs(b):
                    bad.append(f"{who} {key}: to_static {run[key]} vs the "
                               f"plain run's {plain[key]}")
                    break
        if not all(math.isfinite(x) for x in run["losses"]):
            bad.append(f"{who}: non-finite loss {run['losses']}")
        if run["rows"] != [1] * steps:
            bad.append(f"{who}: rows a step {run['rows']}")
        got = run["launches_per_step"]
        if any(got.get(k, 0) != layers for k in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) or \
                got.get("ce_stats", 0) < 1 or got.get("ce_bwd", 0) < 1:
            bad.append(f"{who}: launches a step {got}")
        for name, rec in run["ce_calls"].items():
            if not rec["ok"] or rec["calls"] != steps:
                bad.append(f"{who} {name}: ok {rec['ok']}, "
                           f"{rec['calls']} calls")
        for name, rec in run["flash_calls"].items():
            if not rec["ok"] or rec["calls"] != layers * steps:
                bad.append(f"{who} flash {name}: ok {rec['ok']}, "
                           f"{rec['calls']} calls")
        if not run["save_load"]["equal"]:
            bad.append(f"{who}: Engine.load did not restore the state "
                       f"{run['save_load']}")
        for name, rec in run["reshard"].items():
            if not rec["equal"]:
                bad.append(f"{who}: reshard {name} {rec}")
        tuner = run["tuner"]
        if any(c[7] is not None for c in tuner["history"]) or \
                len(tuner["history"]) != AP_TUNER_TRIALS or \
                not tuner["mesh_back"]:
            bad.append(f"{who}: tuner {tuner}")
    first = ranks[0]["run"]
    evals = [r["run"]["eval_loss"] for r in ranks]
    if len(set(evals)) != 1 or not math.isfinite(evals[0]):
        bad.append(f"eval losses {evals}")
    for r in ranks:
        e = r["run"]["eval_vs_logits"]
        if not abs(e["fused"] - e["from_logits"]) <= \
                AP_LOGITS_RTOL * abs(e["from_logits"]):
            bad.append(f"rank {r['rank']}: the fused eval loss against the "
                       f"CE over predict()'s logits {e}")
    preds = [r["run"]["predict"] for r in ranks]
    if any(p != preds[0] for p in preds) or not preds[0]["finite"] or \
            preds[0]["shape"] != [1, TRAIN_SEQ, first["vocab"]]:
        bad.append(f"predict {preds}")
    if any(r["run"]["tuner"]["history"] != first["tuner"]["history"]
           or r["run"]["tuner"]["best"] != first["tuner"]["best"]
           for r in ranks):
        bad.append("the tuner's history or best differs across ranks")
    out = {"layers": layers, "seq": TRAIN_SEQ, "steps": steps,
           "layout": "dp 2 x mp 2, 4 gloo ranks on one card, "
                     "dist.to_static fed by shard_dataloader",
           "seconds": max(r["run"]["seconds"] for r in ranks),
           "bit_equal": all(r["run"][k][:AP_WARM] == r["plain"][k]
                            for r in ranks
                            for k in ("losses", "grad_norms")),
           "launches": launches, "eval_loss": evals[0],
           "predict": preds[0],
           "eval_vs_logits": first["eval_vs_logits"],
           "reshard_ms": {k: max(r["run"]["reshard"][k]["ms"]
                                 for r in ranks)
                          for k in first["reshard"]},
           "tuner": {"history": first["tuner"]["history"],
                     "best": first["tuner"]["best"],
                     "seconds": first["tuner"]["seconds"]},
           "save_load": {k: max(r["run"]["save_load"][k] for r in ranks)
                         for k in ("save_s", "load_s", "file_gb")},
           "ranks": [{"rank": r["rank"], "coord": r["coord"],
                      **{k: r["run"][k] for k in (
                          "losses", "grad_norms", "step_ms", "peak_mem_gb",
                          "launches_per_step", "ce_calls", "flash_calls",
                          "seconds")},
                      "plain_losses": r["plain"]["losses"],
                      "plain_grad_norms": r["plain"]["grad_norms"]}
                     for r in ranks]}
    report["auto_parallel_full_width"] = out
    for r in out["ranks"]:
        print(f"auto_parallel full width rank {r['rank']} {r['coord']} "
              f"({report.get('gpu')}; 4 ranks time-sharing one card "
              f"through gloo): " + json.dumps(r), flush=True)
    print(f"auto_parallel full width ({report.get('gpu')}): " + json.dumps(
        {k: v for k, v in out.items() if k != "ranks"}), flush=True)
    for c in out["tuner"]["history"]:
        print(f"auto_tuner trial dp {c[0]} mp {c[1]} pp {c[2]} sharding "
              f"{c[3]} micro {c[4]} {c[5]}: {c[6]} s a step "
              f"({report.get('gpu')})", flush=True)
    if bad:
        raise AssertionError(f"auto_parallel_full_width: {bad}")


def kernels_line(report):
    """One row per kernel; `launches` counts the main paths' runs (the
    7B bf16 serve, the 7B int8 and fp8 serves and their visit counters,
    and the timed LLaMA and GPT-MoE training steps; since the
    disaggregation slice also the disaggregated serves (tiny and 7B: the
    decode thread's and the prefill workers' launches together), the
    routed serve over the HTTP replica and the LoRA training steps), each
    read around its run; since the fleet slice also the fleet phases'
    ranks (the tiny layouts' CUDA steps and the full-width run's timed
    steps, summed over the 4 ranks), and since the pipeline slice the
    pipeline phases' ranks alike (the tiny cases' CUDA steps, the
    full-width 1F1B run's timed steps), and since the ZeRO-3 slice the
    ZeRO-3 phases' ranks (the tiny cases' CUDA steps, the full-width
    run's timed 'ahead' and 'start' steps), since the MoE ep slice the
    ep phases' ranks (the tiny cases' CUDA steps and layer calls, the
    full-width run's timed steps), and since the sep slice the sep
    phases' ranks alike (the ring's block calls: sep rank r launches each
    flash kernel r + 1 times a layer a step); since the checkpoint slice
    also the resilient full-width run and the tiny ZeRO-3 and pipeline
    phases' resume cases. gmm_fwd is the bf16 forward kernel
    (its row the h1 case),
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
             report.get("train_recipe_full_width", {}).get("launches", {}),
             report.get("full_width_lora", {}).get("launches", {}),
             report.get("full_width_router", {}).get("launches", {}),
             report.get("paddle_api_full_width", {}).get("launches", {}),
             report.get("disagg_cuda_vs_cpu", {}).get("launches", {}),
             report.get("full_width_disagg", {}).get("launches", {}),
             report.get("full_width_router", {}).get("http", {})
             .get("launches", {}),
             report.get("lora_train_cuda_vs_cpu", {}).get("launches", {}),
             report.get("lora_train_full_width", {}).get("launches", {}),
             report.get("fleet_cuda_vs_cpu", {}).get("launches", {}),
             report.get("fleet_full_width", {}).get("launches", {}),
             report.get("launch_full_width", {}).get("launches", {}),
             report.get("auto_parallel_full_width", {}).get("launches", {}),
             report.get("pipeline_cuda_vs_cpu", {}).get("launches", {}),
             report.get("pipeline_full_width", {}).get("launches", {}),
             report.get("zero3_cuda_vs_cpu", {}).get("launches", {}),
             report.get("zero3_full_width", {}).get("launches", {}),
             report.get("moe_ep_cuda_vs_cpu", {}).get("launches", {}),
             report.get("moe_ep_full_width", {}).get("launches", {}),
             report.get("sep_cuda_vs_cpu", {}).get("launches", {}),
             report.get("sep_full_width", {}).get("launches", {}),
             report.get("resilience_full_width", {}).get("launches", {})]
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
    ap.add_argument("--layers", type=int, default=SERVE_LAYERS,
                    help="decoder depth of the full-width serving phase")
    ap.add_argument("--tuning-worker", choices=("cold", "warm"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--launch-worker", choices=("train", "teardown"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--only", default="",
                    help="comma-separated phase names: run only these, and "
                    "print no result (a quicker check while iterating)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.tuning_worker:        # one process of the tuning phase
        return tuning_worker(args.tuning_worker, args.seed, args.out)
    if args.launch_worker:        # a rank the launch phase's launcher started
        return launch_worker(args.launch_worker, args.seed, args.out)
    t_script = time.perf_counter()
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
    report = {"gpu": smi_line, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s, "built": built,
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
               lambda: phase_lora_cuda_vs_cpu(args.seed, report)),
              ("disagg_cuda_vs_cpu",
               lambda: phase_disagg_cuda_vs_cpu(args.seed, report))]
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

    def full_width_disagg():
        if "eng" not in state:
            raise RuntimeError("the full-width phase built no engine")
        phase_full_width_disagg(state["eng"], state["prompts"], report)

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
               ("full_width_disagg", full_width_disagg),
               ("full_width_kv", full_width_kv),
               ("full_width_lora", full_width_lora),
               ("full_width_router", full_width_router),
               ("train_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_train_cuda_vs_cpu(args.seed, report))),
               ("train_full_width",
                lambda: phase_train_full_width(args, report)),
               ("resilience_full_width",
                lambda: (free_memory(),
                         phase_resilience_full_width(args, report))),
               ("lora_train_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_lora_train_cuda_vs_cpu(args.seed, report))),
               ("lora_train_full_width",
                lambda: (free_memory(),
                         phase_lora_train_full_width(args, report))),
               ("train_moe_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_train_moe_cuda_vs_cpu(args.seed, report))),
               ("train_moe_full_width",
                lambda: phase_train_moe_full_width(args, report)),
               ("train_recipe_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_train_recipe_cuda_vs_cpu(args.seed, report))),
               ("train_recipe_full_width",
                lambda: (free_memory(),
                         phase_train_recipe_full_width(args, report))),
               ("paddle_api_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_paddle_api_cuda_vs_cpu(args.seed, report))),
               ("paddle_api_full_width",
                lambda: (free_memory(),
                         phase_paddle_api_full_width(args, report))),
               ("fleet_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_fleet_cuda_vs_cpu(args.seed, report))),
               ("fleet_full_width",
                lambda: (free_memory(),
                         phase_fleet_full_width(args, report))),
               ("launch_full_width",
                lambda: (free_memory(),
                         phase_launch_full_width(args, report))),
               ("auto_parallel_full_width",
                lambda: phase_auto_parallel_full_width(report)),
               ("pipeline_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_pipeline_cuda_vs_cpu(args.seed, report))),
               ("pipeline_full_width",
                lambda: (free_memory(),
                         phase_pipeline_full_width(args, report))),
               ("zero3_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_zero3_cuda_vs_cpu(args.seed, report))),
               ("zero3_full_width",
                lambda: (free_memory(),
                         phase_zero3_full_width(args, report))),
               ("moe_ep_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_moe_ep_cuda_vs_cpu(args.seed, report))),
               ("moe_ep_full_width",
                lambda: (free_memory(),
                         phase_moe_ep_full_width(args, report))),
               ("sep_cuda_vs_cpu",
                lambda: (free_memory(),
                         phase_sep_cuda_vs_cpu(args.seed, report))),
               ("sep_full_width",
                lambda: (free_memory(),
                         phase_sep_full_width(args, report))),
               ("tuning",
                lambda: (free_memory(), phase_tuning(args.seed, report)))]
    only = [n for n in args.only.split(",") if n]
    if only:
        phases = [(n, fn) for n, fn in phases if n in only]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            report["failed"].append(name)
        report[f"{name}_s"] = time.perf_counter() - t0
        line = (f"phase {name}: "
                f"{'FAILED' if name in report['failed'] else 'ok'} "
                f"({report[f'{name}_s']:.1f} s, "
                f"{time.perf_counter() - t_script:.1f} s into the script)")
        print(line, flush=True)
        print(line, file=sys.stderr, flush=True)

    report["script_s"] = time.perf_counter() - t_script
    print(f"chip_smoke: whole script {report['script_s']:.1f} s",
          flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    if report["failed"]:
        print(f"chip_smoke: failed phases {report['failed']}",
              file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: phases {[n for n, _ in phases]} ok (--only: no "
              f"result)", flush=True)
        return 0
    print(json.dumps(kernels_line(report)), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
