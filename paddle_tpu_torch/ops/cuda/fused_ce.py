"""Fused linear + cross-entropy: the hand-written Hopper statistics kernel,
its plain PyTorch version, and the ``torch.autograd.Function`` around them
(``paddle_tpu/ops/pallas/fused_ce.py`` counterpart, token-chunked variant).

Replaces ``_ce_stats_kernel`` (``fused_ce.py:246``, launched by
``_stats_pallas``, the ``pallas_call`` at :293) with ``csrc/fused_ce.cu``.
The loss needs three per-token scalars of the logits row x·Wᵀ (max,
log-sum-exp, target logit) plus the row sum for label smoothing; the
[tokens, vocab] logits never exist, in the forward or the backward.

What bounds it on the H100: the tile product, 2·N·V·H flops (1.07 TFLOP at
N 4096, H 4096, V 32000) against 2·(N + V)·H bytes, so operations. The
kernel computes the product in its own body with fp32 accumulation. bf16
inputs run on the shared Hopper GEMM core (``csrc/sm90.cuh``): a
persistent grid of one block an SM, TMA copies of 64-deep slices of x and
W into a 4-stage ``mbarrier`` ring, two consumer warpgroups on ``wgmma``
m64n256k16, so a tile is 128 tokens x 256 vocab columns, folded into the
running statistics in the accumulators. fp32 inputs run on the CUDA cores
(64 x 128 tiles). N 4096 gives only 32 token blocks for 132 SMs, so the
vocabulary is split across blocks too (``_split``: token blocks x splits
fill one wave, the blocks of a split run together and share its W range)
and a second small kernel merges the partial statistics.

The backward (``ce_bwd``, under ``FusedLinearCrossEntropy.backward``)
computes what ``_bwd_tokens`` computes (``fused_ce.py:387``, which the JAX
package leaves to XLA in a ``lax.scan``: no ``pallas_call``): per token
chunk the [C, V] fp32 logits, the d-logits as ``_chunk_dlogits`` forms
them, dx = d·W and dW += dᵀ·x in fp32. bf16 x and W on CUDA run it as
hand-written kernels on the same core (``csrc/ce_bwd.cu``): the logits'
tile product with an epilogue that forms d and splits it into three bf16
pieces (hi + mid + lo, exact for the d a step makes) in a [3, C, V] chunk
scratch, then dx and dW as bf16 products of the pieces against W and x
(dW's A is the pieces transposed, bf16 ``wgmma``'s MN-major A): 7 bf16
products of 2·N·V·H flops, the least fp32-accurate tensor-core route.
Each 256-deep run of products is summed on the tensor cores and added
to the 128 x 128 output tile in fp32 on the CUDA cores (the tensor
cores' own accumulation loses bits with the depth), in a fixed order.
The token chunk is the resolved ``chunk_tokens`` rounded up to the
128-token tile. fp32 x and W on CUDA
keep the fp32 ``torch.matmul`` route of ``ce_bwd_reference`` (counted
apart in ``ROUTE_CALLS``); CPU tensors run ``ce_bwd_reference``.

Weights follow PyTorch's layout: W is ``[vocab, hidden]`` (the JAX package
takes ``[hidden, vocab]``). On a CUDA tensor ``ce_stats`` launches the
kernel or raises; on a CPU tensor it runs ``ce_stats_reference``.
``LAUNCHES`` counts kernel launches: ``ce_stats`` one a forward,
``ce_bwd`` one a bf16 backward (the C entry's launches for every chunk).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["ce_stats", "ce_stats_reference", "ce_bwd", "ce_bwd_reference",
           "resolve_chunks", "pick_chunk_tokens", "FusedLinearCrossEntropy",
           "local_labels",
           "LAUNCHES", "ROUTE_CALLS", "reset_launches", "launch_counts"]

_BV = 256                  # vocab columns per bf16 tile and split unit
_BR = 128                  # tokens per bf16 tile (csrc/sm90.cuh kBM)
_BH = 16                   # H slice of the fp32 path
_BH_TMA = 8                # bf16 H step: TMA row strides are 16-byte
                           # multiples; a ragged 64-deep slice reads zeros

_BWD_PIECES = 3            # bf16 pieces of the fp32 d-logits
_BWD_BN = 128              # output tile columns of the backward kernels
_BWD_BK = 64               # V step of the dx product (a TMA stage's depth)

LAUNCHES = {"ce_stats": 0, "ce_bwd": 0}
# backward calls that took the fp32 torch.matmul route on CUDA (no kernel)
ROUTE_CALLS = {"ce_bwd_fp32": 0}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_CALLS):
        for name in counts:
            counts[name] = 0


def resolve_chunks(n_tokens: int, vocab: int, chunk_tokens: int = 0,
                   chunk_vocab: int = 0) -> tuple[int, int]:
    """Default chunk sizes bounding the live logits tile to ~4M fp32 elements
    (16 MB). Overrides win when positive (``fused_ce.py:110``)."""
    target = 1 << 22
    ct = chunk_tokens if chunk_tokens > 0 else max(
        16, min(n_tokens, target // max(vocab, 1)))
    cv = chunk_vocab if chunk_vocab > 0 else max(
        128, min(vocab, target // max(n_tokens, 1)))
    return min(ct, max(n_tokens, 1)), min(cv, max(vocab, 1))


def pick_chunk_tokens(n_tokens: int, vocab: int, chunk_tokens: int = 0,
                      device=None) -> int:
    """The backward's token chunk: `chunk_tokens` when positive, else
    through the shared resolver with geometry ``{n_tokens, vocab}``
    (FLAGS_fused_ce_chunk_tokens > tuning-cache entry > ``resolve_chunks``;
    ``fused_ce.py:549-562``), clamped to the token count."""
    if chunk_tokens > 0:
        return resolve_chunks(n_tokens, vocab, chunk_tokens)[0]
    from paddle_tpu_torch.tuning.blocks import resolve_blocks

    res = resolve_blocks(
        "fused_ce", {"n_tokens": int(n_tokens), "vocab": int(vocab)},
        default=lambda g: resolve_chunks(n_tokens, vocab), device=device)
    return min(int(res.values["chunk_tokens"]), max(int(n_tokens), 1))


def _check(x, w, labels):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x must be [N, H] and w [V, H], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if labels.shape != x.shape[:1]:
        raise ValueError(f"labels must be [N]={tuple(x.shape[:1])}, got "
                         f"{tuple(labels.shape)}")
    if labels.dtype.is_floating_point:
        raise TypeError(f"cross-entropy takes integer class labels, got "
                        f"{labels.dtype}")
    return x.shape[0], w.shape[0], x.shape[1]


def ce_stats_reference(x, w, labels, chunk_tokens: int = 0):
    """Plain PyTorch version of the kernel: per-token fp32 (m, s, t, sl) of
    the logits rows x·Wᵀ, token chunk by token chunk so at most a [C, V]
    fp32 tile exists. Labels outside [0, V) match no column (t = 0)."""
    n, v, _ = _check(x, w, labels)
    ct = resolve_chunks(n, v, chunk_tokens)[0]
    wf = w.float()
    stats = []
    for i in range(0, n, ct):
        logits = x[i:i + ct].float() @ wf.T
        lab = labels[i:i + ct].long()
        hit = (lab >= 0) & (lab < v)
        m = logits.amax(-1)
        s = torch.exp(logits - m[:, None]).sum(-1)
        t = logits.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
        stats.append((m, s, torch.where(hit, t, 0.0), logits.sum(-1)))
    if not stats:
        empty = x.new_zeros(0, dtype=torch.float32)
        return empty, empty, empty, empty
    return tuple(torch.cat(c) for c in zip(*stats))


def _lib():
    from paddle_tpu_torch.ops.cuda._build import load

    fn = load("fused_ce").ptt_ce_stats
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 7 + [vp]
        fn.restype = ci
    return fn


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _split(n: int, v: int, sms: int) -> tuple[int, int]:
    """(nsplit, tiles_per_split) of the vocabulary for N tokens, V columns
    and `sms` SMs: as many splits of 256-column tiles as keep token blocks
    x splits within one wave of the persistent grid (one split when the
    token blocks alone fill it), none of them empty. Units run split-major,
    so the blocks running together share a split's W range."""
    tiles = -(-v // _BV)
    want = max(1, min(tiles, sms // -(-n // _BR)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def _launch(x, w, labels):
    n, v, h = _check(x, w, labels)
    if x.dtype not in _DTYPES or w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"ce_stats kernel takes bf16 or fp32 x and w of one "
                        f"dtype and device, got {x.dtype}/{w.dtype} on "
                        f"{x.device}/{w.device}")
    h_step = _BH_TMA if x.dtype == torch.bfloat16 else _BH
    if h % h_step:
        raise ValueError(f"ce_stats kernel takes a {x.dtype} hidden size that "
                         f"is a multiple of {h_step}, got {h}")
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ce_stats kernel needs 16-byte aligned x and w")
    labels = labels.to(device=x.device, dtype=torch.int32).contiguous()
    stats = torch.empty((4, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return tuple(stats)
    nsplit, per = _split(
        n, v, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((4, nsplit, n), dtype=torch.float32, device=x.device)
    m, s, t, sl = stats
    err = _lib()(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                 part.data_ptr(), m.data_ptr(), s.data_ptr(), t.data_ptr(),
                 sl.data_ptr(), n, v, h, nsplit, per, _DTYPES[x.dtype],
                 x.device.index or 0,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_stats launch failed: cudaError {err}")
    LAUNCHES["ce_stats"] += 1
    return m, s, t, sl


def ce_stats(x, w, labels):
    """Per-token fp32 statistics (m, s, t, sl) of the logits x·Wᵀ for
    x [N, H], W [V, H], labels [N] int: running max, sum of exp(logit - m),
    the target logit (0 for a label outside [0, V), ``ignore_index``
    included) and the sum of logits. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if x.is_cuda:
        return _launch(x, w, labels)
    return ce_stats_reference(x, w, labels)


def ce_bwd_reference(x, w, labels, lse, ct, ignore_index: int = -100,
                     label_smoothing: float = 0.0, z_loss: float = 0.0,
                     chunk_tokens: int = 0, v_total: int = 0):
    """Plain PyTorch version of the backward (``_bwd_tokens``): (dx [N, H],
    dW [V, H]) of the per-token loss for its cotangent ``ct`` [N] and the
    forward's ``lse`` [N], token chunk by token chunk (``chunk_tokens``, 0
    = ``resolve_chunks``): each chunk's logits recomputed in fp32, the
    d-logits ``p·coef - (1 - eps)·ct·onehot - (eps/V)·ct`` formed in
    place, dx = d·W and dW += dᵀ·x as fp32 ``torch.matmul``. Computes in
    fp32, or in fp64 for fp64 inputs; the caller casts. ``v_total`` (0 =
    V) is the vocabulary the smoothing spreads over: the whole one when W
    is a tensor-parallel shard."""
    n, v, _ = _check(x, w, labels)
    c = resolve_chunks(n, v, chunk_tokens)[0]
    ft = torch.promote_types(x.dtype, torch.float32)
    eps = float(label_smoothing)
    lse = lse.to(ft)
    ctv = torch.where(labels != ignore_index, ct.to(ft), 0.0)
    coef = ctv * (1.0 + 2.0 * z_loss * lse) if z_loss else ctv
    lab = labels.long()
    hit = ((lab >= 0) & (lab < v)).to(ft)
    safe = lab.clamp(0, v - 1)
    wf = w.to(ft)
    dx = torch.empty((n, x.shape[1]), dtype=ft, device=x.device)
    dw = torch.zeros((v, x.shape[1]), dtype=ft, device=x.device)
    for i in range(0, n, c):
        xc = x[i:i + c].to(ft)
        # d loss / d logits of one recomputed fp32 tile, in place:
        # p * coef - (1 - eps) * ct * onehot - (eps / V) * ct
        d = (xc @ wf.T).sub_(lse[i:i + c, None]).exp_()
        d.mul_(coef[i:i + c, None])
        d.scatter_add_(1, safe[i:i + c, None],
                       (-(1.0 - eps) * ctv[i:i + c] * hit[i:i + c])[:, None])
        if eps:
            d.sub_((eps / (v_total or v)) * ctv[i:i + c, None])
        torch.matmul(d, wf, out=dx[i:i + c])
        dw.addmm_(d.T, xc)
    return dx, dw


def _lib_bwd():
    from paddle_tpu_torch.ops.cuda._build import load

    fn = load("ce_bwd").ptt_ce_bwd_vt
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 9 + [ci] * 8 + [cf, cf, ci, ci, vp]
        fn.restype = ci
    return fn


def _bwd_plan(n: int, v: int, h: int, chunk: int, sms: int) -> dict:
    """The backward kernels' plan for N tokens, V columns, hidden H, the
    resolved token chunk and `sms` SMs: the chunk rounded up to the
    128-token tile (`cr`), the scratch's row stride (V rounded up to 8:
    TMA row strides are 16-byte multiples), and dx's split of its V loop
    into `splits` ranges of `per` 64-column steps, so token tiles x H
    tiles x splits fill one wave of the persistent grid (one split when
    the tiles alone fill it), none of them empty."""
    cr = -(-max(1, min(chunk, n)) // _BR) * _BR
    tiles = cr // _BR * -(-h // _BWD_BN)
    ksteps = -(-v // _BWD_BK)
    want = max(1, min(ksteps, sms // tiles))
    per = -(-ksteps // want)
    return dict(cr=cr, vp=-(-v // 8) * 8, splits=-(-ksteps // per), per=per)


def _launch_bwd(x, w, labels, lse, ct, ignore_index, eps, z_loss, chunk,
                v_total=0):
    n, v, h = _check(x, w, labels)
    if x.dtype != torch.bfloat16 or w.dtype != x.dtype \
            or w.device != x.device:
        raise TypeError(f"ce_bwd kernel takes bf16 x and w on one device, "
                        f"got {x.dtype}/{w.dtype} on {x.device}/{w.device}")
    if h % _BH_TMA:
        raise ValueError(f"ce_bwd kernel takes a hidden size that is a "
                         f"multiple of {_BH_TMA}, got {h}")
    if tuple(lse.shape) != (n,) or tuple(ct.shape) != (n,):
        raise ValueError(f"lse and ct must be [N]={n}, got "
                         f"{tuple(lse.shape)} and {tuple(ct.shape)}")
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ce_bwd kernel needs 16-byte aligned x and w")
    dev = x.device
    dx = torch.empty((n, h), dtype=torch.float32, device=dev)
    dw = torch.empty((v, h), dtype=torch.float32, device=dev)
    if n == 0:
        return dx, dw.zero_()
    labels = labels.to(device=dev, dtype=torch.int32).contiguous()
    lse = lse.to(device=dev, dtype=torch.float32).contiguous()
    ct = ct.to(device=dev, dtype=torch.float32).contiguous()
    plan = _bwd_plan(n, v, h, chunk,
                     torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
    dl = torch.empty((_BWD_PIECES, plan["cr"], plan["vp"]),
                     dtype=torch.bfloat16, device=dev)
    part = (torch.empty((plan["splits"], plan["cr"], h),
                        dtype=torch.float32, device=dev)
            if plan["splits"] > 1 else None)
    err = _lib_bwd()(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                     lse.data_ptr(), ct.data_ptr(), dl.data_ptr(),
                     part.data_ptr() if part is not None else None,
                     dx.data_ptr(), dw.data_ptr(), n, v, h, plan["cr"],
                     plan["vp"], plan["splits"], plan["per"],
                     int(ignore_index), float(eps), float(z_loss),
                     int(v_total or v), dev.index or 0,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_bwd launch failed: cudaError {err}")
    LAUNCHES["ce_bwd"] += 1
    return dx, dw


def ce_bwd(x, w, labels, lse, ct, ignore_index: int = -100,
           label_smoothing: float = 0.0, z_loss: float = 0.0,
           chunk_tokens: int = 0, v_total: int = 0):
    """(dx [N, H], dW [V, H]), fp32, of the per-token fused CE loss for its
    cotangent ``ct`` [N] and the forward's ``lse`` [N], in token chunks of
    ``chunk_tokens`` (0 = ``resolve_chunks``). bf16 x and w on CUDA launch
    the ``csrc/ce_bwd.cu`` kernels (at the chunk rounded up to 128
    tokens) or raise; fp32 x and w on CUDA take the fp32 ``torch.matmul``
    route of ``ce_bwd_reference`` (counted in ``ROUTE_CALLS``, no kernel);
    CPU tensors take ``ce_bwd_reference``. ``v_total`` (0 = V): the
    vocabulary the smoothing spreads over (see ``ce_bwd_reference``)."""
    n, v, _ = _check(x, w, labels)
    chunk = resolve_chunks(n, v, chunk_tokens)[0]
    args = (x, w, labels, lse, ct, ignore_index, label_smoothing, z_loss,
            chunk, v_total)
    if x.is_cuda and x.dtype == torch.bfloat16:
        return _launch_bwd(*args)
    if x.is_cuda:
        if x.dtype != torch.float32 or w.dtype != torch.float32:
            raise TypeError(f"the fused CE backward takes bf16 x and w (the "
                            f"kernels) or fp32 (torch.matmul) on CUDA, got "
                            f"{x.dtype}/{w.dtype}")
        ROUTE_CALLS["ce_bwd_fp32"] += 1
    return ce_bwd_reference(*args)


def local_labels(labels, offset: int, v_local: int, ignore_index: int):
    """Labels shifted into a vocab shard ``[offset, offset + v_local)``
    (``_local_labels``, ``fused_ce.py:311``): in-shard labels to ``[0,
    v_local)``, every other label, ignored ones included, to -1, which
    matches no column in ``ce_stats`` or ``ce_bwd``. No local label equals
    ``v_local``: the backward passes it as the kernels' ignore value (their
    ignore test reads these labels) after zeroing ignored tokens'
    cotangents from the global labels."""
    loc = labels.long() - offset
    keep = (loc >= 0) & (loc < v_local) & (labels != ignore_index)
    return torch.where(keep, loc, -1)


class FusedLinearCrossEntropy(torch.autograd.Function):
    """Per-token fp32 loss of ``CE(x·Wᵀ, labels)`` without the [N, V]
    logits: x [N, H], W [V, H], labels [N] int; ignored tokens give 0.
    ``label_smoothing`` mixes in the uniform target, ``z_loss`` adds
    ``z·lse²``; both reach value and gradient, as in ``_fwd_impl`` /
    ``_bwd_tokens``. ``chunk_tokens`` (0 = ``pick_chunk_tokens``) sets the
    backward's token chunk; it resolves here in the forward, on the
    caller's thread, and the backward reuses it.

    With an ``mp_group`` of more than one rank, W is this rank's vocab
    shard (rows ``[r V_loc, (r+1) V_loc)`` of the head; x and labels are
    the same on every member): the labels shift into the shard
    (``local_labels``), the kernel computes the shard's statistics, lse
    is combined over the group (max, then the sum of exp) and t and sl
    summed, smoothing divides by the whole vocabulary. The backward takes
    the global lse, zeroes the cotangent of ignored tokens from the
    global labels, runs the kernels on the shard with an ignore value no
    local label takes, and sums dx over the group (after the kernels' own
    dx merge); dW stays local."""

    @staticmethod
    def forward(ctx, x, w, labels, ignore_index=-100, label_smoothing=0.0,
                z_loss=0.0, chunk_tokens=0, mp_group=None):
        n, v, _ = _check(x, w, labels)
        chunk = pick_chunk_tokens(n, v, chunk_tokens, x.device)
        world = 1 if mp_group is None else mp_group.nranks
        lab_k = labels if world == 1 else local_labels(
            labels, mp_group.rank * v, v, int(ignore_index))
        m, s, t, sl = ce_stats(x, w, lab_k)
        lse = m + torch.log(s)
        if world > 1:
            from paddle_tpu_torch.distributed import collective

            g = lse.clone()
            collective.all_reduce(g, collective.ReduceOp.MAX, mp_group)
            parts = torch.stack([torch.exp(lse - g), t, sl])
            collective.all_reduce(parts, group=mp_group)
            lse = g + torch.log(parts[0])
            t, sl = parts[1], parts[2]
        eps = float(label_smoothing)
        if eps == 0.0:
            nll = lse - t
        else:
            nll = lse - (1.0 - eps) * t - eps * sl / (v * world)
        if z_loss:
            nll = nll + z_loss * lse * lse
        ctx.save_for_backward(x, w, labels, lab_k, lse)
        ctx.cfg = (int(ignore_index), eps, float(z_loss), chunk)
        ctx.group = mp_group if world > 1 else None
        return torch.where(labels != ignore_index, nll, 0.0)

    @staticmethod
    def backward(ctx, ct):
        x, w, labels, lab_k, lse = ctx.saved_tensors
        ignore_index, eps, z_loss, c = ctx.cfg
        group = ctx.group
        if group is None:
            dx, dw = ce_bwd(x, w, labels, lse, ct, ignore_index, eps, z_loss,
                            c)
        else:
            ct = torch.where(labels != ignore_index, ct.float(), 0.0)
            v = w.shape[0]
            dx, dw = ce_bwd(x, w, lab_k, lse, ct, v, eps, z_loss, c,
                            v_total=v * group.nranks)
            from paddle_tpu_torch.distributed import collective

            collective.all_reduce(dx, group=group)
        return (dx.to(x.dtype), dw.to(w.dtype), None, None, None, None, None,
                None)


def _fp8_chunk_stats(logits, lab, v):
    """(m, s, t, sl) of one fp32 logits tile (``_chunk_stats``); a label
    outside [0, V) matches no column."""
    lab = lab.long()
    hit = (lab >= 0) & (lab < v)
    m = logits.amax(-1)
    s = torch.exp(logits - m[:, None]).sum(-1)
    t = logits.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    return m, s, torch.where(hit, t, 0.0), logits.sum(-1)


class Fp8LinearCrossEntropy(torch.autograd.Function):
    """The fused head loss under ``fp8_policy='matmuls+head'``: the
    token-chunked variant with its products through fp8 and current
    scaling (``fused_ce.py:562-582``: JAX leaves its Pallas kernel for the
    ``tokens`` scan, ``_project`` :150 and the backward's ``_fp8_mm``
    :411-416), so ``ce_stats``/``ce_bwd`` do not run. Per token chunk of
    the resolved ``chunk_tokens`` (the chunk sets each chunk's x amax, so
    it is JAX's): logits = q(x_c)·q(W)ᵀ in e4m3, the softmax statistics in
    fp32; the backward recomputes the tile, forms d as ``_chunk_dlogits``
    does, then dx_c = q(d)·q(W) and dW += q(d)ᵀ·q(x_c) with d in e5m2 and
    dW summed in fp32. W's codes are made once a call (its amax and so its
    codes are the same for every chunk). The products run
    ``amp.fp8.mm_codes``: ``torch._scaled_mm`` on CUDA, the widened codes'
    fp32 product on the CPU."""

    @staticmethod
    def forward(ctx, x, w, labels, ignore_index=-100, label_smoothing=0.0,
                z_loss=0.0, chunk_tokens=0):
        from paddle_tpu_torch.amp import fp8

        n, v, _ = _check(x, w, labels)
        c = pick_chunk_tokens(n, v, chunk_tokens, x.device)
        sw = fp8.current_scale(w, fp8.E4M3_MAX)
        qw = fp8.quantize(w, sw, fp8.E4M3_MAX, fp8.E4M3)
        stats = []
        for i in range(0, n, c):
            xi = x[i:i + c]
            sx = fp8.current_scale(xi, fp8.E4M3_MAX)
            qx = fp8.quantize(xi, sx, fp8.E4M3_MAX, fp8.E4M3)
            logits = fp8.mm_codes(qx, sx, qw, sw)
            stats.append(_fp8_chunk_stats(logits, labels[i:i + c], v))
        m, s, t, sl = (torch.cat(a) for a in zip(*stats))
        lse = m + torch.log(s)
        eps = float(label_smoothing)
        nll = lse - t if eps == 0.0 else lse - (1.0 - eps) * t - eps * sl / v
        if z_loss:
            nll = nll + z_loss * lse * lse
        ctx.save_for_backward(x, w, labels, lse)
        ctx.cfg = (int(ignore_index), eps, float(z_loss), c)
        return torch.where(labels != ignore_index, nll, 0.0)

    @staticmethod
    def backward(ctx, ct):
        from paddle_tpu_torch.amp import fp8

        x, w, labels, lse = ctx.saved_tensors
        ignore_index, eps, z_loss, c = ctx.cfg
        n, v, h = _check(x, w, labels)
        ctv = torch.where(labels != ignore_index, ct.float(), 0.0)
        coef = ctv * (1.0 + 2.0 * z_loss * lse) if z_loss else ctv
        sw = fp8.current_scale(w, fp8.E4M3_MAX)
        qw = fp8.quantize(w, sw, fp8.E4M3_MAX, fp8.E4M3)
        qw_t = qw.t().contiguous()              # the rows of (Wᵀ)ᵀ for dx
        dx = torch.empty((n, h), dtype=torch.float32, device=x.device)
        dw = torch.zeros((v, h), dtype=torch.float32, device=x.device)
        lab = labels.long()
        for i in range(0, n, c):
            xi = x[i:i + c]
            sx = fp8.current_scale(xi, fp8.E4M3_MAX)
            qx = fp8.quantize(xi, sx, fp8.E4M3_MAX, fp8.E4M3)
            logits = fp8.mm_codes(qx, sx, qw, sw)
            # _chunk_dlogits: p * coef - (1 - eps) * ct * onehot
            # - (eps / V) * ct
            d = torch.exp(logits - lse[i:i + c, None]) * coef[i:i + c, None]
            col = torch.arange(v, device=x.device)
            d = d - torch.where(col == lab[i:i + c, None],
                                (1.0 - eps) * ctv[i:i + c, None], 0.0)
            if eps:
                d = d - (eps / v) * ctv[i:i + c, None]
            sd = fp8.current_scale(d, fp8.E5M2_MAX)
            qd = fp8.quantize(d, sd, fp8.E5M2_MAX, fp8.E5M2)
            dx[i:i + c] = fp8.mm_codes(qd, sd, qw_t, sw)
            dw += fp8.mm_codes(qd.t().contiguous(), sd,
                               qx.t().contiguous(), sx)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None, None
