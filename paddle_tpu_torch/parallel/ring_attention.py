"""Ring attention: exact attention over a sequence sharded across the
ranks of a sep group (``paddle_tpu.parallel.ring_attention``
counterpart).

Each rank holds a contiguous segment of every row's sequence, its
``[B, S_local, H, D]`` shards of q, k and v: rank r of the group holds
positions ``[r S_local, (r + 1) S_local)``. K/V blocks travel around the
ring (rank r sends to r + 1 and receives from r - 1, one
``collective.isend``/``irecv`` pair a hop, gloo staging CUDA tensors
through the host where ranks share a card) while each rank merges its
query shard's block results. Where the JAX package keeps the streaming
softmax statistics (m, l, acc) in ``jnp`` inside ``shard_map`` and lets
autograd transpose the ``ppermute``s into the reverse ring, the port
writes both directions out as one ``torch.autograd.Function``:

* forward: step t holds the block of source rank ``(r - t) mod n``. The
  rank's own block runs the causal flash forward, an earlier rank's block
  the non-causal one, and under ``causal`` a later rank's block is
  skipped (it lies wholly in the query shard's future), as JAX skips it.
  Each call gives (out_j, lse_j); they are merged into the running
  (out, lse) by log-sum-exp in fp32 (JAX's merge, which it too computes
  outside any kernel). A query row that sees no key of a block (a packed
  row's segment ends before it) has lse_j = -inf and adds nothing.
* backward: with the final out and lse each block's probabilities are
  ``exp(S_j - lse)``, so the flash backward kernels give the exact block
  gradients when handed the global out and lse. K/V go around the ring
  again; dq accumulates here, each block's dk/dv in fp32 buffers that
  travel with the block and are back at their owner after n hops. The
  same future blocks are skipped.

Both directions hop with ``collective.isend``/``irecv`` in one order on
every rank (gloo matches messages by order), even ranks sending first
and odd ones receiving first, as the pipeline's hops do. The hops count
as "send"/"recv" in ``collective.stats()`` and their host time as "p2p".

The flash kernels take fewer K/V heads than query heads (GQA), so the
ring moves only the K/V heads; JAX's ring needs equal heads. A packed
row's segment ids are gathered over the group once a call, and each
block's flash call takes its source's ids as the keys' ids
(``kv_segment_ids``). A group of one rank is plain flash attention.

On CUDA tensors every block runs the flash kernels (or raises); on CPU
tensors both directions run the flash kernels' plain versions.
``_block_attn`` is JAX's block attention in torch (q-chunked, fp32
statistics), the plain statement of one block's (acc, m, l) that the
tests hold against JAX's. ``SEP_AXIS`` names the mesh axis; ``current_sep_group()``
(``parallel.segments``) is the group a training step publishes.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.ops.cuda.flash_attention import (FlashAttention,
                                                       flash_attention_bwd,
                                                       flash_attention_fwd)

__all__ = ["ring_attention", "RingAttention", "SEP_AXIS"]

SEP_AXIS = "sep"
_NEG_INF = -1e30


def _block_attn(q, k, v, qpos, kpos, scale, causal, q_chunk=512,
                q_seg=None, k_seg=None):
    """One q shard against one K/V block with its statistics, JAX's
    ``_block_attn`` in torch: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]
    (GQA when Hkv < Hq), global positions qpos [Sq] and kpos [Sk], and
    optionally the rows' segment ids q_seg [B, Sq] and k_seg [B, Sk].
    Returns (acc [B, Sq, Hq, D] fp32 unnormalised, m, l [B, Sq, Hq, 1]).
    q is taken in chunks of `q_chunk` rows, the last one padded, so the
    scores of one chunk are O(q_chunk * Sk). A masked pair gets p = 0; a
    row with no visible key has l = 0."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kh, vh = k.float(), v.float()
    k_ids = q_seg if k_seg is None else k_seg
    chunk = min(q_chunk, sq)
    nc = -(-sq // chunk)
    pad = nc * chunk - sq
    qf = q.float()
    if pad:
        qf = torch.cat([qf, qf.new_zeros(b, pad, hq, d)], 1)
        qpos = torch.cat([qpos, qpos[-1:].expand(pad)])
        if q_seg is not None:
            q_seg = torch.cat([q_seg, q_seg[:, -1:].expand(b, pad)], 1)
    accs, ms, ls = [], [], []
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        qc = qf[:, rows].reshape(b, chunk, hkv, g, d)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kh) * scale
        valid = torch.ones(chunk, kh.shape[1], dtype=torch.bool,
                           device=q.device)
        if causal:
            valid = qpos[rows, None] >= kpos[None, :]
        valid = valid[None, None, None]
        if q_seg is not None:
            valid = valid & (q_seg[:, rows][:, None, None, :, None]
                             == k_ids[:, None, None, None, :])
        s = torch.where(valid, s, _NEG_INF)
        m = s.amax(-1)                                     # [B, Hkv, g, C]
        p = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
        accs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vh)
                    .reshape(b, chunk, hq, d))
        ms.append(m.reshape(b, hq, chunk).transpose(1, 2)[..., None])
        ls.append(p.sum(-1).reshape(b, hq, chunk).transpose(1, 2)[..., None])
    return tuple(torch.cat(t, 1)[:, :sq] for t in (accs, ms, ls))


def _merge(out, lse, out_j, lse_j):
    """Fold (out_j, lse_j) into the running fp32 (out [B, S, H, D], lse
    [B, H, S]) by log-sum-exp, in place; rows at -inf on both sides stay
    at out 0, lse -inf."""
    new = torch.logaddexp(lse, lse_j)
    base = torch.where(torch.isinf(new), 0.0, new)
    a = torch.exp(lse - base).transpose(1, 2)[..., None]
    c = torch.exp(lse_j - base).transpose(1, 2)[..., None]
    out.mul_(a).add_(out_j.float() * c)
    lse.copy_(new)


def _hop(group, tensors):
    """Send `tensors` to the next rank of the ring and receive the
    previous rank's, in one order on every rank."""
    n, r = group.nranks, group.rank
    nxt, prev = group.ranks[(r + 1) % n], group.ranks[(r - 1) % n]
    bufs = [torch.empty_like(t) for t in tensors]

    def sends():
        return [collective.isend(t, nxt, group) for t in tensors]

    def recvs():
        return [collective.irecv(b, prev, group) for b in bufs]

    with collective._timed("p2p"):
        works = sends() + recvs() if r % 2 == 0 else recvs() + sends()
        for work in works:
            work.wait()
    return bufs


def _skipped(causal, src, r):
    return causal and src > r


class RingAttention(torch.autograd.Function):
    """``RingAttention.apply(q, k, v, group, causal, scale, segment_ids)``:
    ring attention over `group` (see the module docstring) on this rank's
    [B, S_local, H, D] shards; ``segment_ids`` [B, S_local] (or None) are
    this rank's packed-row ids. Gradients come back in the inputs'
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal=True, scale=None,
                segment_ids=None):
        n, r = group.nranks, group.rank
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        segs = None
        if segment_ids is not None:
            seg = segment_ids.to(device=q.device, dtype=torch.int32)
            segs = collective.all_gather([], seg.contiguous(), group=group)
        b, s, hq, d = q.shape
        out = torch.zeros((b, s, hq, d), dtype=torch.float32,
                          device=q.device)
        lse = torch.full((b, hq, s), float("-inf"), dtype=torch.float32,
                         device=q.device)
        kv = torch.stack([k, v])
        for t in range(n):
            src = (r - t) % n
            if not _skipped(causal, src, r):
                # the block in its own frame, the diagonal one causal
                out_j, lse_j = flash_attention_fwd(
                    q, kv[0], kv[1], causal=causal and src == r, scale=scale,
                    segment_ids=segs[r] if segs else None,
                    kv_segment_ids=segs[src] if segs else None)
                _merge(out, lse, out_j, lse_j)
            if t < n - 1:
                kv, = _hop(group, [kv])
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.segs = group, causal, scale, \
            segs
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, segs = ctx.group, ctx.causal, ctx.segs
        n, r = group.nranks, group.rank
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for t in range(n):
            src = (r - t) % n
            if not _skipped(causal, src, r):
                dq_j, dk_j, dv_j = flash_attention_bwd(
                    q, kv[0], kv[1], out, lse, do,
                    causal=causal and src == r, scale=ctx.scale,
                    segment_ids=segs[r] if segs else None,
                    kv_segment_ids=segs[src] if segs else None)
                dq += dq_j
                dkv[0] += dk_j
                dkv[1] += dv_j
            # the block's gradient travels with it; after the n-th hop it
            # is back at its owner
            if t < n - 1:
                kv, dkv = _hop(group, [kv, dkv])
            else:
                dkv, = _hop(group, [dkv])
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def _resolve_group(group):
    """`group`, else the published sep group, else the hcg's or the rank
    mesh's sep group; raises when none is bound (a silent ring of one
    would skip every exchange)."""
    if group is not None:
        return group
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import get_mesh
    from paddle_tpu_torch.parallel.segments import current_sep_group

    g = current_sep_group()
    if g is not None:
        return g
    if fleet._hcg[0] is not None:
        return fleet._hcg[0].get_sep_parallel_group()
    mesh = get_mesh()
    if mesh is None or SEP_AXIS not in mesh.shape:
        raise ValueError(f"ring_attention: axis {SEP_AXIS!r} is not bound "
                         f"(pass group=, or build a rank mesh carrying it)")
    return mesh.group(SEP_AXIS)


def ring_attention(q, k, v, group=None, causal: bool = True,
                   scale: float | None = None):
    """Exact attention over a sequence sharded across `group` (the sep
    group when None): q [B, S_local, Hq, D], k/v [B, S_local, Hkv, D], this
    rank's contiguous segment. Returns this rank's [B, S_local, Hq, D]
    output, differentiable. A group of one rank is plain flash
    attention."""
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [B, S_local, H, D] "
                         f"shards of one length")
    group = _resolve_group(group)
    if group.nranks == 1:
        return FlashAttention.apply(q, k, v, causal, scale, None)
    return RingAttention.apply(q, k, v, group, causal, scale, None)
