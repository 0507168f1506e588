"""Ring attention of the port (``paddle_tpu_torch.parallel.ring_attention``)
on 4 gloo ranks (CPU) against the JAX package's ``ring_attention`` under
``shard_map`` over ``{"sep": 4}``, and its pieces against their JAX and
single-rank counterparts.

One spawn of 4 ranks (``distributed.spawn``, gloo on loopback) runs every
rank-side case: each rank takes its contiguous quarter of the sequence of
the same seeded q, k, v and output cotangent, runs the ring forward and
its backward, and pickles its shard of the output and of dq, dk, dv. The
test process joins the shards and holds them against JAX, built from the
same numpy inputs on 4 of the 8 host devices of ``tests/conftest.py``:

* equal heads, causal and not: JAX's ``ring_attention`` under
  ``shard_map``; outputs rtol 1e-4, atol 1e-5 (JAX's own rule,
  ``tests/test_ring_attention.py:54``), q, k, v gradients (``jax.vjp``
  through the JAX ring with the same cotangent) rtol 1e-3, atol 1e-4
  (:78-79);
* GQA (4 query heads on 2 kv heads; the port's ring moves the kv heads
  only, JAX's ring needs equal heads): JAX's dense attention with the K/V
  heads repeated, at the same rules;
* packed rows whose documents cross the shards (so a query row sees no
  key of some blocks): JAX's dense segment-masked attention and the
  port's own single-rank packed flash attention, no NaN anywhere.

In this process: the plain block attention against JAX's ``_block_attn``
(fp32 1e-6, a q chunk that does not divide the shard), the flash plain
versions' ``kv_segment_ids`` on a block pair with a row that sees no key
(out 0, lse -inf, zero gradients for that row, no NaN), the log-sum-exp
merge of two -inf rows, a group of one rank (plain flash attention), and
the missing group's error.
"""
import math
import os
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

B, S, D = 2, 32, 16
N = 4
SPAWN_TIMEOUT_S = 180
CASES = {                     # label: (q heads, kv heads, causal, packed)
    "causal": (2, 2, True, False),
    "noncausal": (2, 2, False, False),
    "gqa_causal": (4, 2, True, False),
    "packed_causal": (4, 2, True, True),
    "packed_noncausal": (2, 2, False, True),
}


def _inputs(hq, hkv, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, hq, D).astype(np.float32)
    k = rng.randn(B, S, hkv, D).astype(np.float32)
    v = rng.randn(B, S, hkv, D).astype(np.float32)
    do = rng.randn(B, S, hq, D).astype(np.float32)
    return q, k, v, do


def _segments():
    """[B, S] packed ids: documents that cross the 8-token shards; row 0's
    last document starts at 25, so its rows see no key of shards 0-2."""
    seg = np.zeros((B, S), np.int32)
    for row, starts in enumerate(((5, 25), (9, 18))):
        for j, start in enumerate(starts):
            seg[row, start:] = j + 1
    return seg


def _ring_rank(out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.parallel.ring_attention import (RingAttention,
                                                          ring_attention)

    env = dist.init_parallel_env()
    mesh = build_mesh({"sep": N})
    group = mesh.group("sep")
    r, per = group.rank, S // N
    part = slice(r * per, (r + 1) * per)
    out = {"rank": env.rank, "coord": mesh.coord()}
    for label, (hq, hkv, causal, packed) in CASES.items():
        q, k, v, do = (torch.from_numpy(a[:, part].copy())
                       for a in _inputs(hq, hkv))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        if packed:
            seg = torch.from_numpy(_segments()[:, part].copy())
            o = RingAttention.apply(q, k, v, group, causal, None, seg)
        else:
            o = ring_attention(q, k, v, group=group, causal=causal)
        o.backward(do)
        out[label] = [t.detach().numpy() for t in (o, q.grad, k.grad,
                                                    v.grad)]
    with open(os.path.join(out_dir, f"rank{env.rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring_attention"))
    spawn(_ring_rank, (out,), nprocs=N, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(N):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


def _joined(ranks, label):
    """The ranks' shards of (out, dq, dk, dv) joined along the sequence."""
    return [np.concatenate([ranks[r][label][i] for r in range(N)], 1)
            for i in range(4)]


def _shard_map(fn, mesh, in_specs, out_specs):
    try:
        from jax import shard_map

        return shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
    except (ImportError, TypeError):
        from jax.experimental.shard_map import shard_map

        return shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_rep=False)


def _jax_ring(causal, arrays):
    """(out, dq, dk, dv) of JAX's ring over {"sep": 4}, the gradients by
    ``jax.vjp`` with the cotangent `do`."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from paddle_tpu.distributed.mesh import build_mesh, set_mesh
    from paddle_tpu.parallel.ring_attention import ring_attention

    q, k, v, do = (jnp.asarray(a) for a in arrays)
    mesh = build_mesh({"sep": N})
    try:
        spec = PartitionSpec(None, "sep")
        fn = jax.jit(_shard_map(
            lambda a, b, c: ring_attention(a, b, c, causal=causal), mesh,
            (spec, spec, spec), spec))
        out, vjp = jax.vjp(fn, q, k, v)
        grads = vjp(do)
    finally:
        set_mesh(None)
    return [np.asarray(t) for t in (out, *grads)]


def _jax_dense(arrays, causal, seg=None):
    """(out, dq, dk, dv) of JAX's dense attention with the K/V heads
    repeated up to the query heads and, with `seg`, the segment mask."""
    import jax
    import jax.numpy as jnp

    q, k, v, do = (jnp.asarray(a) for a in arrays)
    g = q.shape[2] // k.shape[2]

    def attn(q, k, v):
        kr, vr = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(D)
        valid = jnp.ones((S, S), bool)
        if causal:
            valid = jnp.tril(valid)
        valid = valid[None, None]
        if seg is not None:
            sg = jnp.asarray(seg)
            valid = valid & (sg[:, None, :, None] == sg[:, None, None, :])
        s = jnp.where(valid, s, -1e30)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), vr)

    out, vjp = jax.vjp(attn, q, k, v)
    return [np.asarray(t) for t in (out, *vjp(do))]


def _assert_close(got, want, what):
    names = ("out", "dq", "dk", "dv")
    for name, a, b in zip(names, got, want):
        assert np.isfinite(a).all(), (what, name)
        rtol, atol = (1e-4, 1e-5) if name == "out" else (1e-3, 1e-4)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("label", ["causal", "noncausal"])
def test_ring_matches_jax_ring_under_shard_map(ranks, label):
    hq, hkv, causal, _ = CASES[label]
    arrays = _inputs(hq, hkv)
    _assert_close(_joined(ranks, label), _jax_ring(causal, arrays), label)


def test_gqa_ring_matches_jax_dense_with_repeated_kv_heads(ranks):
    hq, hkv, causal, _ = CASES["gqa_causal"]
    got = _joined(ranks, "gqa_causal")
    assert got[2].shape == (B, S, hkv, D)       # only the kv heads travel
    _assert_close(got, _jax_dense(_inputs(hq, hkv), causal), "gqa")


@pytest.mark.parametrize("label", ["packed_causal", "packed_noncausal"])
def test_packed_ring_matches_dense_and_single_rank(ranks, label):
    from paddle_tpu_torch.ops.cuda.flash_attention import FlashAttention

    hq, hkv, causal, _ = CASES[label]
    arrays = _inputs(hq, hkv)
    seg = _segments()
    got = _joined(ranks, label)
    _assert_close(got, _jax_dense(arrays, causal, seg), label)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    out = FlashAttention.apply(q, k, v, causal, None, torch.from_numpy(seg))
    out.backward(torch.from_numpy(arrays[3]))
    _assert_close(got, [t.detach().numpy() for t in (out, q.grad, k.grad,
                                                      v.grad)],
                  label + " vs single rank")


def test_mesh_coordinates_of_the_sep_ranks(ranks):
    assert [r["coord"] for r in ranks] == [{"sep": i} for i in range(N)]


def test_block_attn_matches_jax_block_attn():
    """The plain block attention (the ring's CPU forward) against JAX's
    ``_block_attn``: one chunk, a dividing chunk and a chunk of 3 that
    does not divide 8 (ceil tiling), causal at global positions of two
    different shards (every row sees a key) and not."""
    import jax.numpy as jnp

    from paddle_tpu.parallel.ring_attention import _block_attn as jax_block
    from paddle_tpu_torch.parallel.ring_attention import _block_attn

    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 8, 2, 4).astype(np.float32) for _ in range(3))
    qpos, kpos = np.arange(8, 16), np.arange(4, 12)
    for causal in (True, False):
        want = jax_block(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)),
                         0.5, causal, q_chunk=8)
        for chunk in (8, 2, 3):
            got = _block_attn(*(torch.from_numpy(a) for a in (q, k, v, qpos,
                                                              kpos)),
                              0.5, causal, q_chunk=chunk)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)


def test_kv_segment_ids_row_with_no_visible_key():
    """A q stretch against a k stretch of one packed row: query rows whose
    document has no key in the stretch get out 0 and lse -inf, and give
    zero dq and nothing to dk, dv; no NaN. The plain versions agree with a
    dense computation over the visible pairs."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    rng = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 8, 2, 16)
                                    .astype(np.float32)) for _ in range(4))
    qseg = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 2]], dtype=torch.int32)
    kseg = torch.tensor([[0, 0, 1, 1, 1, 1, 1, 1]], dtype=torch.int32)
    out, lse = fa.flash_attention_fwd(q, k, v, segment_ids=qseg,
                                      kv_segment_ids=kseg)
    assert torch.isfinite(out).all()
    assert (out[:, 3:] == 0).all() and torch.isinf(lse[:, :, 3:]).all()
    assert (lse[:, :, 3:] < 0).all() and torch.isfinite(lse[:, :, :3]).all()
    valid = (qseg[0, :, None] == kseg[0, None, :])
    s = torch.einsum("qhd,khd->hqk", q[0], k[0]) / 4.0
    p = torch.softmax(s.masked_fill(~valid, -1e30), -1) * valid
    np.testing.assert_allclose(out[0, :3], torch.einsum(
        "hqk,khd->qhd", p, v[0])[:3], rtol=1e-5, atol=1e-6)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                        segment_ids=qseg, kv_segment_ids=kseg)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    assert (dq[:, 3:] == 0).all()
    assert (dk[:, :2] == 0).all() and (dv[:, :2] == 0).all()
    # the rows that see no key change nothing: drop them and dk, dv agree
    do2 = do.clone()
    do2[:, 3:] = 0
    _, dk2, dv2 = fa.flash_attention_bwd(q, k, v, out, lse, do2,
                                         segment_ids=qseg,
                                         kv_segment_ids=kseg)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    with pytest.raises(ValueError, match="kv_segment_ids needs"):
        fa.flash_attention_fwd(q, k, v, kv_segment_ids=kseg)


def test_merge_keeps_rows_that_see_nothing_at_zero():
    from paddle_tpu_torch.parallel.ring_attention import _merge

    out = torch.zeros(1, 2, 1, 4)
    lse = torch.full((1, 1, 2), float("-inf"))
    out_j = torch.ones(1, 2, 1, 4)
    lse_j = torch.tensor([[[float("-inf"), 0.5]]])
    _merge(out, lse, out_j, lse_j)
    assert torch.equal(out[0, 0], torch.zeros(1, 4))
    assert torch.equal(out[0, 1], torch.ones(1, 4))
    assert torch.isinf(lse[0, 0, 0]) and float(lse[0, 0, 1]) == 0.5


def test_group_of_one_is_plain_flash_attention():
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.ops.cuda.flash_attention import FlashAttention
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(4, 2))
    got = ring_attention(q, k, v, group=Group(id=-1, ranks=(0,)),
                         causal=True)
    assert torch.equal(got, FlashAttention.apply(q, k, v, True, None, None))


def test_ring_without_a_sep_group_raises():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import get_mesh, set_mesh
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    prev = fleet._hcg[0], get_mesh()
    fleet._hcg[0] = None
    set_mesh(None)
    try:
        q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 2))
        with pytest.raises(ValueError, match="'sep' is not bound"):
            ring_attention(q, k, v)
    finally:
        fleet._hcg[0] = prev[0]
        set_mesh(prev[1])
