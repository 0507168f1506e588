"""Megatron sequence parallelism of the port
(``distributed.fleet.utils.sequence_parallel_utils``) on 2 gloo ranks
(CPU) against the JAX package's under ``shard_map`` over ``{"mp": 2}``.

One spawn of 2 ranks (``distributed.spawn``, gloo on loopback, the rank
mesh ``{"mp": 2}``, so every op finds its group itself) runs every case
on the same seeded numpy inputs and output cotangents, one per rank, and
pickles its outputs and gradients. The JAX references run each op per
rank inside ``shard_map`` (the ranks' inputs, outputs and cotangents
stacked along a leading "mp" axis), its gradients by ``jax.vjp``; rank r
of the port is held to JAX's rank r, fp32, rtol and atol 1e-5:

* the three paired collectives along the sequence (dim 0):
  ``all_gather`` (reduce-scatter backward), ``scatter`` (all-gather
  backward), ``reduce_scatter`` (all-gather backward), and the
  ``AllGatherOp``/``ScatterOp``/``ReduceScatterOp`` aliases;
* ``identity_in_fwd_allreduce_in_bwd`` against the function JAX's
  ``_c_identity`` applies (``_identity_fwd_psum_bwd``);
* ``ColumnSequenceParallelLinear`` and ``RowSequenceParallelLinear``
  with their shards of one full ``[in, out]`` weight
  (``models.convert.shard_linear``): outputs, the input's gradient, the
  weight and bias shards' gradients. The row layer's bias is marked
  ``sequence_parallel``; with ``register_sequence_parallel_allreduce_hooks``
  its gradient is the sum of JAX's per-rank gradients (each sees its own
  segment of the sequence), without the hook each rank's own.

In this process: over no group each op is the identity, and the
``shard_linear``/``gather_linear`` round trip.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn import spawn

MP = 2
S, B, H = 4, 3, 5           # a rank's [S, B, H] for the collectives
D_IN, D_OUT = 6, 8          # the linear layers' full features
SPAWN_TIMEOUT_S = 120


def _inputs():
    """Per-rank inputs and cotangents, stacked along a leading mp axis."""
    rng = np.random.RandomState(5)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    return {
        "all_gather": (r(MP, S, B, H), r(MP, MP * S, B, H)),
        "scatter": (r(MP, S, B, H), r(MP, S // MP, B, H)),
        "reduce_scatter": (r(MP, S, B, H), r(MP, S // MP, B, H)),
        "identity": (r(MP, S, B, H), r(MP, S, B, H)),
        "column": (r(MP, S // MP, B, D_IN), r(MP, S, B, D_OUT // MP)),
        "row": (r(MP, S, B, D_OUT // MP), r(MP, S // MP, B, D_IN)),
        "column_w": r(D_IN, D_OUT), "column_b": r(D_OUT),
        "row_w": r(D_OUT, D_IN), "row_b": r(D_IN),
    }


def _sp_rank(out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as sp)
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.convert import shard_linear

    env = dist.init_parallel_env()
    build_mesh({"mp": MP})
    r = env.rank
    data = _inputs()
    out = {}

    def run(label, fn):
        x = torch.from_numpy(data[label][0][r].copy()).requires_grad_()
        y = fn(x)
        y.backward(torch.from_numpy(data[label][1][r].copy()))
        return [y.detach().numpy(), x.grad.numpy()]

    for label, fn in (("all_gather", sp.all_gather),
                      ("scatter", sp.scatter),
                      ("reduce_scatter", sp.reduce_scatter),
                      ("identity", sp.identity_in_fwd_allreduce_in_bwd)):
        out[label] = run(label, fn)
    for label, op in (("all_gather", sp.AllGatherOp),
                      ("scatter", sp.ScatterOp),
                      ("reduce_scatter", sp.ReduceScatterOp)):
        out[label + "_op"] = run(label, op.apply)
    for kind, cls in (("column", sp.ColumnSequenceParallelLinear),
                      ("row", sp.RowSequenceParallelLinear)):
        for hooked in (False, True):
            layer = cls(D_IN if kind == "column" else D_OUT,
                        D_OUT if kind == "column" else D_IN)
            layer.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   shard_linear(kind, r, MP,
                                                data[kind + "_w"],
                                                data[kind + "_b"]).items()})
            handles = (sp.register_sequence_parallel_allreduce_hooks(layer)
                       if hooked else [])
            y, gx = run(kind, layer)
            out[f"{kind}_hooked" if hooked else kind] = {
                "y": y, "dx": gx, "dw": layer.weight.grad.numpy(),
                "db": layer.bias.grad.numpy(), "hooks": len(handles),
                "marks": {n: (getattr(p, "mp_sharded", False),
                              sp.is_sequence_parallel_parameter(p))
                          for n, p in layer.named_parameters()}}
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sequence_parallel"))
    spawn(_sp_rank, (out,), nprocs=MP, timeout=SPAWN_TIMEOUT_S)
    res = []
    for r in range(MP):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


def _per_rank_vjp(fn, args, ct):
    """(outputs, gradients of every arg) of `fn` run per rank under
    shard_map over {"mp": 2}: args and ct stacked along a leading mp
    axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from paddle_tpu.distributed.mesh import build_mesh, set_mesh

    try:
        from jax import shard_map

        kw = {"check_vma": False}
    except ImportError:
        from jax.experimental.shard_map import shard_map

        kw = {"check_rep": False}
    mesh = build_mesh({"mp": MP})
    try:
        spec = PartitionSpec("mp")
        g = jax.jit(shard_map(lambda *a: fn(*[t[0] for t in a])[None],
                              mesh=mesh, in_specs=spec, out_specs=spec,
                              **kw))
        y, vjp = jax.vjp(g, *(jnp.asarray(a) for a in args))
        grads = vjp(jnp.asarray(ct))
    finally:
        set_mesh(None)
    return np.asarray(y), [np.asarray(t) for t in grads]


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("label", ["all_gather", "scatter", "reduce_scatter",
                                   "identity"])
def test_paired_collectives_match_jax(ranks, label):
    from paddle_tpu.distributed.fleet.layers.mpu.mp_ops import (
        _identity_fwd_psum_bwd)
    from paddle_tpu.distributed.fleet.utils import (
        sequence_parallel_utils as jsp)

    fn = {"all_gather": jsp._allgather_seq, "scatter": jsp._scatter_seq,
          "reduce_scatter": jsp._reduce_scatter_seq,
          "identity": _identity_fwd_psum_bwd}[label]
    x, ct = _inputs()[label]
    y, (gx,) = _per_rank_vjp(fn, (x,), ct)
    names = [label] + ([label + "_op"] if label != "identity" else [])
    for r in range(MP):
        for name in names:
            _close(ranks[r][name][0], y[r], f"{name} out, rank {r}")
            _close(ranks[r][name][1], gx[r], f"{name} dx, rank {r}")


@pytest.mark.parametrize("kind", ["column", "row"])
def test_sequence_parallel_linears_match_jax(ranks, kind):
    from paddle_tpu.distributed.fleet.utils import (
        sequence_parallel_utils as jsp)

    data = _inputs()
    x, ct = data[kind]
    w, b = data[kind + "_w"], data[kind + "_b"]
    if kind == "column":       # columns of [in, out] and of the bias
        ws = np.stack(np.split(w, MP, axis=1))
        bs = np.stack(np.split(b, MP))

        def fn(x, w, b):
            return jsp._allgather_seq(x) @ w + b
    else:                      # rows of [in, out], the bias whole
        ws = np.stack(np.split(w, MP, axis=0))
        bs = np.stack([b] * MP)

        def fn(x, w, b):
            return jsp._reduce_scatter_seq(x @ w) + b
    y, (gx, gw, gb) = _per_rank_vjp(fn, (x, ws, bs), ct)
    for r in range(MP):
        for name in (kind, kind + "_hooked"):
            got = ranks[r][name]
            _close(got["y"], y[r], f"{name} y, rank {r}")
            _close(got["dx"], gx[r], f"{name} dx, rank {r}")
            _close(got["dw"], gw[r].T, f"{name} dw, rank {r}")
            want_b = gb[r]
            if kind == "row" and name.endswith("hooked"):
                want_b = gb.sum(0)      # the hook sums it over mp
            _close(got["db"], want_b, f"{name} db, rank {r}")


def test_marks_and_hooks(ranks):
    """Shards carry ``mp_sharded``; only the row layer's bias is marked
    ``sequence_parallel``, so the hook helper registers one hook there
    and none on the column layer."""
    for r in range(MP):
        assert ranks[r]["column"]["marks"] == {"weight": (True, False),
                                               "bias": (True, False)}
        assert ranks[r]["row"]["marks"] == {"weight": (True, False),
                                            "bias": (False, True)}
        assert ranks[r]["column_hooked"]["hooks"] == 0
        assert ranks[r]["row_hooked"]["hooks"] == 1


def test_ops_are_identities_without_a_group():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as sp)
    from paddle_tpu_torch.distributed.mesh import get_mesh, set_mesh

    prev = fleet._hcg[0], get_mesh()
    fleet._hcg[0] = None
    set_mesh(None)
    try:
        x = torch.randn(4, 2, 3)
        for fn in (sp.all_gather, sp.scatter, sp.reduce_scatter,
                   sp.identity_in_fwd_allreduce_in_bwd):
            assert fn(x) is x
        layer = sp.ColumnSequenceParallelLinear(3, 5)
        assert layer.weight.shape == (5, 3)
        assert not getattr(layer.weight, "mp_sharded", False)
        torch.testing.assert_close(layer(x), torch.nn.functional.linear(
            x, layer.weight, layer.bias))
        assert sp.register_sequence_parallel_allreduce_hooks(layer) == []
    finally:
        fleet._hcg[0] = prev[0]
        set_mesh(prev[1])


def test_shard_linear_round_trip():
    from paddle_tpu_torch.models.convert import gather_linear, shard_linear

    rng = np.random.RandomState(0)
    w, b = rng.randn(6, 8).astype(np.float32), rng.randn(8).astype(np.float32)
    col = [shard_linear("column", r, 2, w, b) for r in range(2)]
    assert col[1]["weight"].shape == (4, 6)
    np.testing.assert_array_equal(col[1]["weight"], w[:, 4:].T)
    np.testing.assert_array_equal(col[1]["bias"], b[4:])
    back = gather_linear("column", col)
    np.testing.assert_array_equal(back["weight"], w)
    np.testing.assert_array_equal(back["bias"], b)
    row = [shard_linear("row", r, 2, w, b) for r in range(2)]
    np.testing.assert_array_equal(row[0]["weight"], w[:3].T)
    np.testing.assert_array_equal(row[0]["bias"], b)
    np.testing.assert_array_equal(gather_linear("row", row)["weight"], w)
    with pytest.raises(ValueError, match="not a multiple"):
        shard_linear("row", 0, 4, w[:6], b)
