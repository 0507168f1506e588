"""Dropless (capacity-free) MoE dispatch
(``paddle_tpu.incubate.distributed.models.moe.dropless`` counterpart).

* sort-based ragged dispatch: token copies are stably argsorted by expert
  id into contiguous buckets whose starts are aligned to the grouped
  matmul's ``block_rows``; every shape is static ([N*k] permutations, a
  [M, d] bucket buffer with M = round_up(N*k, bm) + E*bm), and at ep = 1
  nothing reads a device value back to the host, so the step can later
  be captured in a CUDA graph;
* the experts' two products run through the hand-written grouped-matmul
  kernels (``ops/cuda/grouped_matmul.py``) over exactly the routed rows;
* the combine with the gate weights runs in fp32;
* expert parallelism (ep > 1): each rank holds E/ep experts, the
  contiguous block of its ep coordinate. The aligned buckets are laid out
  per owner ([ep, cap, d], cap = round_up(N*k, bm) + E/ep * bm, each
  owner's slice block-aligned on its own) and ride the tiled all-to-all
  over the ep group (``distributed.utils.global_scatter``) with their
  expert ids; the owner runs the grouped products over the [ep * cap]
  rows it received, whose ids rise within each source's slice, and the
  results ride the inverse all-to-all back (``global_gather``). The
  payload is the static worst case, as in the JAX package. The dense
  shared expert runs between the two exchanges, as there. The ep group's
  ranks must agree on ``block_rows`` (it sizes the slices): each body
  checks that they do, with one small collective, and raises on a
  mismatch.

Token-choice routing (the gates of ``_route``) and expert-choice routing
(each expert picks its top-C tokens). The statistics follow the JAX
package's token-axes rule over the rank's token group (the ranks that
hold other rows: dp, sharding and ep): counts and dropped tokens are
summed over it, ``l_aux`` averaged; its value is the group mean and its
gradient this rank's own, so averaging the gate's gradient over the
group gives the gradient of the mean. Each body returns ``(out [N, d],
l_aux, dropped, counts [E], layout)``: the JAX contract plus ``layout =
(gids [M] int32, block_rows)``, the bucket layout the grouped matmul ran
over (at ep > 1 the received one, ids local to this rank's experts),
which the visit counter reads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _tF

from paddle_tpu_torch.distributed.utils.moe_utils import (global_gather,
                                                          global_scatter)
from paddle_tpu_torch.ops.cuda.grouped_matmul import (grouped_matmul,
                                                      pick_block_rows)

__all__ = ["_dropless_moe", "_expert_choice_moe", "ragged_layout"]


def _round_up(v, m):
    return ((v + m - 1) // m) * m


def ragged_layout(gids_all, E, bm):
    """Sort-based static-shape ragged bucket layout (``dropless.py:57``).

    gids_all: [Nk] int expert id per token copy, E = trash (unrouted).
    Returns (order, rank, dest, gbuf, counts): the stable argsort by expert
    id; the rank of sorted copy j in its bucket; its destination row in the
    bucket buffer (bucket starts aligned to bm, trash after the buckets);
    the per-buffer-row expert id [M] int32 (each expert's whole aligned
    region carries its id, E past the buckets), M = round_up(Nk, bm) +
    E*bm; and the tokens routed per expert [E] int32."""
    (nk,) = gids_all.shape
    dev = gids_all.device
    gids_all = gids_all.long()
    # scatter_add, not bincount: bincount on CUDA reads the max back
    counts_full = torch.zeros(E + 1, dtype=torch.long, device=dev)
    counts_full.scatter_add_(0, gids_all, torch.ones_like(gids_all))
    counts = counts_full[:E]
    order = torch.argsort(gids_all, stable=True)
    sorted_g = gids_all[order]
    raw_start = torch.cumsum(counts_full, 0) - counts_full
    rank = torch.arange(nk, device=dev) - raw_start[sorted_g]
    aoff = torch.cat([counts.new_zeros(1),
                      torch.cumsum(_round_up(counts, bm), 0)])
    m = _round_up(nk, bm) + E * bm
    dest = torch.where(sorted_g < E, aoff[sorted_g.clamp(max=E - 1)] + rank,
                       aoff[E] + rank)
    gbuf = torch.searchsorted(aoff[1:], torch.arange(m, device=dev),
                              right=True).to(torch.int32)
    return order, rank, dest, gbuf, counts.to(torch.int32)


def _act(h, act):
    """``jax.nn.gelu``'s default is the tanh approximation."""
    return _tF.gelu(h, approximate="tanh") if act == "gelu" else _tF.relu(h)


class _GroupBias(torch.autograd.Function):
    """Row i's bias ``b[gids[i]]`` in fp32 for b [G, h], zero for trash rows
    (``gids == G``). The forward is an exact gather. The backward sums each
    group's rows of dy as one matmul, ``onehot^T @ dy``, where the JAX
    package's gather of an appended zero row would scatter M rows into
    G + 1 (PyTorch's indexing backward sorts them). That matmul runs with
    the fp32 matmul precision pinned to "highest", so a caller's TF32
    setting cannot round dy."""

    @staticmethod
    def forward(ctx, b, gids):
        ctx.save_for_backward(gids)
        ctx.num_groups, ctx.b_dtype = b.shape[0], b.dtype
        bz = torch.cat([b.float(), b.new_zeros((1, b.shape[1]),
                                               dtype=torch.float32)])
        return bz.index_select(0, gids)

    @staticmethod
    def backward(ctx, dy):
        (gids,) = ctx.saved_tensors
        onehot = (gids[:, None] == torch.arange(
            ctx.num_groups, device=gids.device)).to(dy.dtype)
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            db = onehot.T @ dy
        finally:
            torch.set_float32_matmul_precision(prev)
        return db.to(ctx.b_dtype), None


def _expert_ffn_grouped(x, gids, w1, b1, w2, b2, act, bm):
    """Two grouped matmuls plus biases over ragged expert buckets: x [M, d],
    gids [M] in [0, G] (G = trash), rows aligned to ``bm``. Returns fp32
    [M, d]; trash rows stay zero, alignment rows carry their bucket's id and
    are never gathered back."""
    g = w1.shape[0]
    h1 = grouped_matmul(x, w1, gids, block_rows=bm)
    h1 = h1 + _GroupBias.apply(b1.reshape(g, -1), gids)
    a = _act(h1, act).to(x.dtype)
    y = grouped_matmul(a, w2, gids, block_rows=bm)
    return y + _GroupBias.apply(b2.reshape(g, -1), gids)


def _shared_ffn(xv, shared, act):
    """The dense shared-expert branch, or None. Weights in the JAX layout
    ([in, out])."""
    if not shared:
        return None
    sw1, sb1, sw2, sb2 = shared
    h = _act(xv @ sw1 + sb1, act)
    return (h @ sw2 + sb2).float()


def _gshard_aux(probs, topi, E):
    """The GShard load-balance aux loss (one implementation for both
    dispatch modes); a dropped selection (-1) counts for no expert."""
    me = probs.mean(0)
    hits = topi[..., None] == torch.arange(E, device=topi.device)
    ce = hits.float().sum(1).mean(0)
    return (me * ce).sum() * E


class _ValueOf(torch.autograd.Function):
    """`value`'s value with `x`'s gradient: the forward returns `value`
    (a detached tensor of x's shape), the backward passes the cotangent to
    `x` as it is."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def _reduce_stats(l_aux, dropped, counts, token_group=None):
    """The stat convention of every dispatch body (the JAX package's
    token-axes rule): over the rank's token group, counts and dropped
    summed, ``l_aux`` averaged (its value the mean, its gradient this
    rank's own), in one all-reduce; counts in fp32."""
    counts = counts.float()
    if token_group is None or token_group.nranks == 1:
        return l_aux, dropped, counts
    from paddle_tpu_torch.distributed import collective

    stats = torch.cat([l_aux.detach().float().reshape(1),
                       dropped.detach().float().reshape(1),
                       counts.detach()])
    collective.all_reduce(stats, group=token_group)
    mean = (stats[0] / token_group.nranks).to(l_aux.dtype)
    return _ValueOf.apply(l_aux, mean), stats[1], stats[2:]


def _agree(group, **vals):
    """Raise unless every rank of `group` holds the same integer values
    (one all-reduce of [v, -v], its max; every rank raises together)."""
    if group is None or group.nranks == 1:
        return
    from paddle_tpu_torch.distributed import collective

    mine = [int(v) for v in vals.values()]
    dev = ("cpu" if group.backend == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    t = torch.tensor(mine + [-v for v in mine], dtype=torch.long, device=dev)
    collective.all_reduce(t, op=collective.ReduceOp.MAX, group=group)
    got = t.tolist()
    hi, lo = got[:len(mine)], [-v for v in got[len(mine):]]
    if hi != lo:
        spread = {k: (a, b) for k, a, b in zip(vals, lo, hi) if a != b}
        raise ValueError(
            f"the ranks of the ep group disagree on {spread} (least, "
            f"largest; this rank {dict(zip(vals, mine))}): the all-to-all's "
            f"slices would not match. Give every rank the same "
            f"moe_block_rows flag, tuning cache and token count")


def _dropless_moe(xv, gv, generator, w1, b1, w2, b2, *shared, E, k, act,
                  ep=1, ep_group=None, token_group=None, routing=()):
    """Token-choice dropless dispatch: xv [N, d] tokens, gv [N, E] gate
    logits, expert weights this rank's [E/ep, ...] block; ``shared``
    optionally the shared-expert MLP (sw1, sb1, sw2, sb2); ``generator``
    feeds random routing. Buckets align to ``pick_block_rows``. At ep > 1
    the tokens reach their experts' owners over `ep_group`, and the stats
    reduce over `token_group`. Returns (out [N, d], l_aux, dropped = 0,
    counts [E], layout)."""
    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import \
        _route

    n, d = xv.shape
    topv, topi, probs = _route(gv.float(), generator, k=k, routing=routing)
    nk = n * k
    bm = pick_block_rows(nk, E, xv.device)
    flat_e = topi.reshape(-1)                                    # [Nk]
    routed = flat_e >= 0
    # -1 (GShard random-routing drop) -> the trash group E: those copies
    # ride the layout with combine weight 0 and are never computed
    gids_all = torch.where(routed, flat_e, E)
    order, rank, dest, gbuf, counts = ragged_layout(gids_all, E, bm)
    tok_sorted = order // k                                      # [Nk]
    # copy j of token t sits at flat row t*k+j: one gather of xv
    # (index_select: its backward is an index_add, not a sort)
    xs = xv.index_select(0, tok_sorted)
    wgt_sorted = topv.reshape(-1)[order] * routed[order].float()  # fp32
    if ep > 1:
        _agree(ep_group, block_rows=bm, tokens=n)
        el = E // ep
        # the owner of each sorted copy (ep for trash) and its
        # block-aligned slot in the owner's slice: experts are contiguous
        # per owner, so the sorted stream is too
        sorted_g = gids_all[order]
        owner = torch.div(sorted_g, el, rounding_mode="floor")
        le = sorted_g - owner * el
        aligned2 = _round_up(counts.long().reshape(ep, el), bm)
        ends2 = torch.cumsum(aligned2, 1)                        # [ep, El]
        cap = _round_up(nk, bm) + el * bm                        # static
        oc = owner.clamp(max=ep - 1)
        slot = (ends2 - aligned2)[oc, le.clamp(max=el - 1)] + rank
        live = owner < ep
        # trash copies land on a spare row past the slices
        row = torch.where(live, oc * cap + slot, ep * cap)
        sbuf = xv.new_zeros((ep * cap + 1, d)).index_copy(0, row, xs)
        # each slice's ids from its aligned ends: padding rows carry
        # their bucket's id (zero payloads, one expert a block), El past
        # the buckets
        sgid = torch.searchsorted(
            ends2, torch.arange(cap, device=xv.device).expand(ep, cap)
            .contiguous(), right=True).to(torch.int32)
        # dispatch (the reference's global_scatter): each owner's slice
        # goes to it, with its ids
        rbuf = global_scatter(sbuf[:-1], None, None, group=ep_group)
        rgid = global_scatter(sgid.reshape(-1), None, None, group=ep_group)
        # the shared expert between the exchanges, as the JAX package
        # places it
        ysh = _shared_ffn(xv, shared, act)
        ybuf = _expert_ffn_grouped(rbuf, rgid, w1, b1, w2, b2, act, bm)
        # combine (the reference's global_gather), back at the source
        yret = global_gather(ybuf.to(xv.dtype), None, None, group=ep_group)
        yk = yret.index_select(0, torch.where(live, row, 0)).float()
        layout = (rgid, bm)
    else:
        buf = xv.new_zeros((gbuf.shape[0], d)).index_copy(0, dest, xs)
        ysh = _shared_ffn(xv, shared, act)
        ybuf = _expert_ffn_grouped(buf, gbuf, w1, b1, w2, b2, act, bm)
        yk = ybuf.index_select(0, dest)                          # fp32
        layout = (gbuf, bm)
    # unpermute + combine in fp32: one scatter-add folds the k copies
    out = yk.new_zeros((n, d)).index_add(0, tok_sorted,
                                         yk * wgt_sorted[:, None])
    if ysh is not None:
        out = out + ysh
    l_aux, dropped, counts = _reduce_stats(
        _gshard_aux(probs, topi, E), xv.new_zeros((), dtype=torch.float32),
        counts, token_group)
    return (out.to(xv.dtype), l_aux.to(xv.dtype), dropped, counts, layout)


def _expert_choice_moe(xv, gv, generator, w1, b1, w2, b2, *shared, E, k,
                       act, ep=1, ep_group=None, token_group=None,
                       routing=()):
    """Expert-choice routing (Zhou et al.): every expert picks its top-C
    tokens by router score, C = k*N/E rounded to the block size, so the
    buckets are full, equal and block-aligned by construction. A token may
    be picked by zero or several experts; combine weights are the picked
    softmax scores (fp32); l_aux = 0. At ep > 1 the expert-major buffer's
    [ep, E/ep * C, d] owner slices ride the all-to-all over `ep_group`.
    ``generator`` and ``routing`` are unused (the JAX signature)."""
    n, d = xv.shape
    probs = torch.softmax(gv.float(), dim=-1)                    # [N, E]
    c0 = max(1, (k * n + E - 1) // E)
    bm = pick_block_rows(E * _round_up(c0, 8), E, xv.device)
    bm = min(bm, max(8, n))
    c = min(_round_up(c0, bm), (n // bm) * bm) or n
    if c % bm:
        bm = math.gcd(bm, c)
    ev, ei = torch.topk(probs.T, c, dim=-1)                      # [E, C]
    flat_i = ei.reshape(-1)
    bufx = xv.index_select(0, flat_i)                            # [E*C, d]
    if ep > 1:
        _agree(ep_group, block_rows=bm, capacity=c)
        el = E // ep
        # expert-major: the owners' slices are static [El*C, d] blocks
        rbuf = global_scatter(bufx, None, None, group=ep_group)
        ysh = _shared_ffn(xv, shared, act)
        gids = torch.arange(el, dtype=torch.int32, device=xv.device)\
            .repeat_interleave(c).repeat(ep)
        ybuf = _expert_ffn_grouped(rbuf, gids, w1, b1, w2, b2, act, bm)
        y = global_gather(ybuf.to(xv.dtype), None, None,
                          group=ep_group).float()
    else:
        gids = torch.arange(E, dtype=torch.int32,
                            device=xv.device).repeat_interleave(c)
        ysh = _shared_ffn(xv, shared, act)
        y = _expert_ffn_grouped(bufx, gids, w1, b1, w2, b2, act, bm)
    out = y.new_zeros((n, d)).index_add(0, flat_i, y * ev.reshape(-1)[:, None])
    if ysh is not None:
        out = out + ysh
    l_aux, dropped, counts = _reduce_stats(
        xv.new_zeros((), dtype=torch.float32),
        xv.new_zeros((), dtype=torch.float32),
        torch.full((E,), float(c), device=xv.device), token_group)
    return (out.to(xv.dtype), l_aux.to(xv.dtype), dropped, counts,
            (gids, bm))
