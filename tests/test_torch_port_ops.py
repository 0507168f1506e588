"""The port's Paddle op library (``paddle_tpu_torch.ops``: creation, math,
manipulation, reduction, comparison, linalg, and the ``Tensor`` methods
they install) against the JAX package's on the CPU: each op on the same
seeded numpy inputs in both packages; the outputs' values and dtypes, then
the gradient of sum(output * a fixed random cotangent) with respect to
every float input, fp32 within 1e-5 (1e-4 for the factorizations and
solves). The random creation ops draw other streams than JAX's threefry,
so they are held to shape, dtype and statistics."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle

TOL = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    from paddle_tpu_torch.core import device

    prev = device.current_place()
    tpaddle.set_device("cpu")
    yield
    device._place = prev


def _rng(seed=0):
    return np.random.RandomState(seed)


def _f(*shape, seed=0, lo=None, hi=None):
    r = _rng(seed)
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


X = _f(3, 4)
Y = _f(3, 4, seed=1)
POS = _f(3, 4, lo=0.5, hi=2.0)
UNIT = _f(3, 4, lo=-0.9, hi=0.9)
BIG = _f(3, 4, lo=1.1, hi=3.0)
IDX = np.array([2, 0, 1], np.int64)
SPD = (lambda a: a @ a.T + 4 * np.eye(4, dtype=np.float32))(_f(4, 4))


def _case(fn, *inputs, grad=True, tol=TOL):
    return (fn, inputs, grad, tol)


CASES = {
    # ---- math: unary
    **{name: _case(lambda P, x, n=name: getattr(P, n)(x), X)
       for name in ("exp", "expm1", "abs", "neg", "square", "floor",
                    "ceil", "round", "trunc", "sin", "cos", "tan", "atan",
                    "sinh", "cosh", "tanh", "asinh", "erf", "deg2rad",
                    "rad2deg", "frac", "sign")},
    **{name: _case(lambda P, x, n=name: getattr(P, n)(x), POS)
       for name in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt",
                    "reciprocal")},
    **{name: _case(lambda P, x, n=name: getattr(P, n)(x), UNIT)
       for name in ("asin", "acos", "atanh", "erfinv")},
    "acosh": _case(lambda P, x: P.acosh(x), BIG),
    **{name: _case(lambda P, x, n=name: getattr(P, n)(x),
                   np.array([1.0, np.nan, np.inf, -np.inf], np.float32),
                   grad=False)
       for name in ("isnan", "isinf", "isfinite")},
    # ---- math: binary and the rest
    **{name: _case(lambda P, x, y, n=name: getattr(P, n)(x, y), X, Y)
       for name in ("add", "subtract", "multiply", "divide", "maximum",
                    "minimum", "fmax", "fmin", "atan2", "logaddexp",
                    "hypot")},
    "remainder": _case(lambda P, x, y: P.remainder(x, y), X, POS),
    "floor_divide": _case(lambda P, x, y: P.floor_divide(x, y), X, POS,
                          grad=False),
    "pow_tensor": _case(lambda P, x, y: P.pow(x, y), POS, Y),
    "pow_scalar": _case(lambda P, x: P.pow(x, 3), X),
    "clip": _case(lambda P, x: P.clip(x, -0.5, 0.7), X),
    "scale": _case(lambda P, x: P.scale(x, 2.5, 0.5), X),
    "scale_before": _case(lambda P, x: P.scale(x, 2.5, 0.5,
                                               bias_after_scale=False), X),
    "lerp": _case(lambda P, x, y: P.lerp(x, y, 0.3), X, Y),
    "lerp_tensor": _case(lambda P, x, y, w: P.lerp(x, y, w), X, Y, POS),
    "nan_to_num": _case(lambda P, x: P.nan_to_num(x, nan=1.5, posinf=9.0),
                        np.array([1.0, np.nan, np.inf, -2.0], np.float32),
                        grad=False),
    "logit": _case(lambda P, x: P.logit(x, eps=1e-3),
                   _f(3, 4, lo=0.05, hi=0.95)),
    "stanh": _case(lambda P, x: P.stanh(x), X),
    "dunder_mix": _case(lambda P, x, y: (x * 2 - y / 3 + 1.5) ** 2
                        - x @ y.T @ x, X, Y),
    # ---- reduction
    "sum_all": _case(lambda P, x: P.sum(x), X),
    "sum_axis_keep": _case(lambda P, x: P.sum(x, axis=1, keepdim=True), X),
    "sum_axes": _case(lambda P, x: x.sum(axis=[0, 1]), X),
    "sum_int_dtype": _case(lambda P, x: P.sum(P.cast(x, "int32")), X,
                           grad=False),
    "mean": _case(lambda P, x: P.mean(x, axis=0), X),
    "mean_all": _case(lambda P, x: x.mean(), X),
    "max": _case(lambda P, x: P.max(x, axis=1), X),
    "min_keep": _case(lambda P, x: P.min(x, axis=0, keepdim=True), X),
    "amax": _case(lambda P, x: P.amax(x), X),
    "prod": _case(lambda P, x: P.prod(x, axis=1), X),
    "prod_all": _case(lambda P, x: P.prod(x), X),
    "argmax": _case(lambda P, x: P.argmax(x, axis=1), X, grad=False),
    "argmin_all": _case(lambda P, x: P.argmin(x), X, grad=False),
    "argmax_keep": _case(lambda P, x: P.argmax(x, axis=0, keepdim=True), X,
                         grad=False),
    "all_any": _case(lambda P, x: (P.all(x > -5.0), P.any(x > 1.0, axis=1)),
                     X, grad=False),
    "logsumexp": _case(lambda P, x: P.logsumexp(x, axis=1), X),
    "std": _case(lambda P, x: P.std(x, axis=1), X),
    "var_biased": _case(lambda P, x: P.var(x, unbiased=False), X),
    "median_even": _case(lambda P, x: P.median(x, axis=1), X),
    "median_odd": _case(lambda P, x: P.median(x, axis=0), X),
    "count_nonzero": _case(lambda P, x: P.count_nonzero(P.floor(x), axis=1),
                           X, grad=False),
    "nansum": _case(lambda P, x: P.nansum(x, axis=1), X),
    "nanmean": _case(lambda P, x: P.nanmean(x), X),
    "cumsum": _case(lambda P, x: P.cumsum(x, axis=1), X),
    "cumsum_flat": _case(lambda P, x: P.cumsum(x), X),
    "cumprod": _case(lambda P, x: P.cumprod(x, dim=0), X),
    "cummax": _case(lambda P, x: P.cummax(x, axis=1), X),
    "cummin": _case(lambda P, x: P.cummin(x, axis=0), X),
    "kthvalue": _case(lambda P, x: P.kthvalue(x, 2, axis=1), X),
    "mode": _case(lambda P, x: P.mode(x, axis=1),
                  np.array([[1, 2, 2], [3, 3, 1]], np.float32), grad=False),
    # ---- manipulation
    "reshape": _case(lambda P, x: P.reshape(x, [2, -1]), X),
    "transpose": _case(lambda P, x: P.transpose(x, [1, 0]), X),
    "T": _case(lambda P, x: x.T, X),
    "concat": _case(lambda P, x, y: P.concat([x, y], axis=1), X, Y),
    "stack": _case(lambda P, x, y: P.stack([x, y], axis=0), X, Y),
    "split_sections": _case(lambda P, x: P.split(x, [1, -1, 2], axis=1), X),
    "chunk": _case(lambda P, x: x.chunk(2, axis=1), X),
    "tensor_split": _case(lambda P, x: P.tensor_split(x, 3, axis=1), X),
    "squeeze": _case(lambda P, x: P.squeeze(P.reshape(x, [3, 1, 4, 1]),
                                            axis=[1, 3]), X),
    "unsqueeze": _case(lambda P, x: P.unsqueeze(x, [0, 2]), X),
    "flatten": _case(lambda P, x: P.flatten(P.reshape(x, [3, 2, 2]), 1), X),
    "cast": _case(lambda P, x: P.cast(x, "float64"), X),
    "astype_int": _case(lambda P, x: x.astype("int64"), X, grad=False),
    "gather": _case(lambda P, x, i: P.gather(x, i, axis=0), X, IDX),
    "gather_axis1": _case(lambda P, x, i: P.gather(x, i, axis=1), X, IDX),
    "gather_nd": _case(lambda P, x, i: P.gather_nd(x, i), X,
                       np.array([[0, 1], [2, 3]], np.int64)),
    "index_select": _case(lambda P, x, i: P.index_select(x, i, axis=1), X,
                          IDX),
    "index_sample": _case(lambda P, x, i: P.index_sample(x, i), X,
                          np.array([[0, 3], [1, 1], [2, 0]], np.int64)),
    "scatter": _case(lambda P, x, i, u: P.scatter(x, i, u), X,
                     np.array([2, 0], np.int64), _f(2, 4, seed=3)),
    "scatter_add": _case(lambda P, x, i, u: P.scatter(x, i, u,
                                                      overwrite=False),
                         X, np.array([2, 0, 2], np.int64), _f(3, 4, seed=3)),
    "scatter_nd_add": _case(lambda P, x, i, u: P.scatter_nd_add(x, i, u), X,
                            np.array([[0, 1], [2, 2], [0, 1]], np.int64),
                            _f(3, seed=4)),
    "take_along_axis": _case(lambda P, x, i: P.take_along_axis(x, i, 1), X,
                             np.array([[0, 3], [1, 1], [2, 0]], np.int64)),
    "put_along_axis": _case(lambda P, x, i, u: P.put_along_axis(x, i, u, 1),
                            X, np.array([[0, 3], [1, 2], [2, 0]], np.int64),
                            _f(3, 2, seed=5)),
    "put_along_axis_add": _case(
        lambda P, x, i, u: P.put_along_axis(x, i, u, 1, reduce="add"), X,
        np.array([[0, 3], [1, 2], [2, 0]], np.int64), _f(3, 2, seed=5)),
    "tile": _case(lambda P, x: P.tile(x, [2, 1]), X),
    "expand": _case(lambda P, x: P.expand(P.reshape(x, [3, 1, 4]),
                                          [3, 2, -1]), X),
    "broadcast_to": _case(lambda P, x: P.broadcast_to(x, [2, 3, 4]), X),
    "expand_as": _case(lambda P, x, y: P.expand_as(P.sum(x, axis=0), y), X,
                       Y),
    "flip": _case(lambda P, x: P.flip(x, [0, 1]), X),
    "roll": _case(lambda P, x: P.roll(x, 2, axis=1), X),
    "roll_flat": _case(lambda P, x: P.roll(x, 5), X),
    "where": _case(lambda P, x, y: P.where(x > y, x, y), X, Y),
    "where_scalar": _case(lambda P, x: P.where(x > 0, x, 0.5), X),
    "masked_fill": _case(lambda P, x: P.masked_fill(x, x < 0, -1.0), X),
    "topk": _case(lambda P, x: P.topk(x, 2, axis=1), X),
    "topk_smallest": _case(lambda P, x: P.topk(x, 2, axis=0, largest=False),
                           X),
    "sort_desc": _case(lambda P, x: P.sort(x, axis=1, descending=True), X),
    "argsort": _case(lambda P, x: P.argsort(x, axis=0), X, grad=False),
    "argsort_desc_ties": _case(lambda P, x: P.argsort(x, descending=True),
                               np.array([3, 1, 3, 2, 1], np.float32),
                               grad=False),
    "unbind": _case(lambda P, x: P.unbind(x, axis=1), X),
    "slice": _case(lambda P, x: P.slice(x, [0, 1], [1, 0], [3, -1]), X),
    "strided_slice": _case(lambda P, x: P.strided_slice(x, [1], [0], [4],
                                                        [2]), X),
    "repeat_interleave": _case(lambda P, x: P.repeat_interleave(x, 2, 0), X),
    "moveaxis": _case(lambda P, x: P.moveaxis(P.reshape(x, [3, 2, 2]), 0, 2),
                      X),
    "swapaxes": _case(lambda P, x: P.swapaxes(x, 0, 1), X),
    "pad_constant": _case(lambda P, x: P.pad(x, [1, 0, 2, 1], value=0.5), X),
    "pad_nchw": _case(lambda P, x: P.pad(P.reshape(x, [1, 1, 3, 4]),
                                         [1, 2, 0, 1]), X),
    "crop": _case(lambda P, x: P.crop(x, [2, 2], [1, 1]), X),
    "tensordot": _case(lambda P, x, y: P.tensordot(x, y, [[1], [1]]), X, Y),
    "rot90": _case(lambda P, x: P.rot90(x, 1, [0, 1]), X),
    "atleast_2d": _case(lambda P, x: P.atleast_2d(P.sum(x)), X),
    "view_as": _case(lambda P, x, y: P.view_as(x, P.reshape(y, [4, 3])), X,
                     Y),
    "masked_select": _case(lambda P, x: P.masked_select(x, x > 0), X,
                           grad=False),
    "nonzero": _case(lambda P, x: P.nonzero(x > 0), X, grad=False),
    "unique": _case(lambda P, x: P.unique(x, return_counts=True),
                    np.array([3, 1, 3, 2, 1], np.int64), grad=False),
    "bincount": _case(lambda P, x: P.bincount(x, minlength=6),
                      np.array([3, 1, 3, 2, 1], np.int64), grad=False),
    "searchsorted": _case(lambda P, s, v: P.searchsorted(s, v, right=True),
                          np.array([1.0, 2.0, 2.0, 5.0], np.float32),
                          np.array([2.0, 0.0, 6.0], np.float32), grad=False),
    "numel": _case(lambda P, x: P.numel(x), X, grad=False),
    "getitem": _case(lambda P, x: x[1:, ::2] * 2 + x[0, :2], X),
    # ---- comparison
    **{name: _case(lambda P, x, y, n=name: getattr(P, n)(x, y), X,
                   np.where(_rng(7).rand(3, 4) > 0.5, X, Y), grad=False)
       for name in ("equal", "not_equal", "less_than", "less_equal",
                    "greater_than", "greater_equal", "isclose")},
    **{name: _case(lambda P, x, y, n=name: getattr(P, n)(x > 0, y > 0), X,
                   Y, grad=False)
       for name in ("logical_and", "logical_or", "logical_xor")},
    "logical_not": _case(lambda P, x: P.logical_not(x > 0), X, grad=False),
    **{name: _case(lambda P, x, y, n=name: getattr(P, n)(x, y),
                   np.array([5, 3, 12], np.int64),
                   np.array([6, 5, 10], np.int64), grad=False)
       for name in ("bitwise_and", "bitwise_or", "bitwise_xor")},
    "bitwise_not": _case(lambda P, x: P.bitwise_not(x),
                         np.array([5, 3, 12], np.int64), grad=False),
    "allclose_equal_all": _case(
        lambda P, x: (P.allclose(x, x + 1e-7), P.equal_all(x, x),
                      P.equal_all(x, x + 1.0)), X, grad=False),
    # ---- linalg
    "matmul": _case(lambda P, x, y: P.matmul(x, y, transpose_y=True), X, Y),
    "matmul_tx": _case(lambda P, x, y: P.matmul(x, y, transpose_x=True), X,
                       Y),
    "bmm": _case(lambda P, x, y: P.bmm(P.reshape(x, [1, 3, 4]),
                                       P.reshape(y, [1, 4, 3])), X, Y),
    "mv": _case(lambda P, x, v: P.mv(x, v), X, _f(4, seed=2)),
    "dot": _case(lambda P, x, y: P.dot(x, y), X, Y),
    "t": _case(lambda P, x: P.t(x), X),
    "outer": _case(lambda P, x, y: P.outer(x, y), _f(3), _f(4, seed=1)),
    "inner": _case(lambda P, x, y: P.inner(x, y), X, Y),
    "cross": _case(lambda P, x, y: P.cross(x, y), _f(3, 3), _f(3, 3, seed=1)),
    "norm_fro": _case(lambda P, x: P.norm(x), X),
    "norm_p1_axis": _case(lambda P, x: P.norm(x, p=1, axis=1), X),
    "norm_inf": _case(lambda P, x: P.norm(x, p=np.inf, axis=0), X),
    "dist": _case(lambda P, x, y: P.dist(x, y, p=3), X, Y),
    "einsum": _case(lambda P, x, y: P.einsum("ij,kj->ik", x, y), X, Y),
    "matrix_power": _case(lambda P, a: P.matrix_power(a, 3), SPD / 4),
    "multi_dot": _case(lambda P, x, y, a: P.multi_dot([x, a, y.T]), X, Y,
                       SPD),
    "kron": _case(lambda P, x, y: P.kron(x, y), _f(2, 2), _f(2, 3, seed=1)),
    "cholesky": _case(lambda P, a: P.cholesky(a), SPD, tol=LOOSE),
    "inv": _case(lambda P, a: P.inv(a), SPD, tol=LOOSE),
    "solve": _case(lambda P, a, b: P.solve(a, b), SPD, _f(4, 2, seed=3),
                   tol=LOOSE),
    "triangular_solve": _case(
        lambda P, a, b: P.triangular_solve(P.triu(a), b), SPD,
        _f(4, 2, seed=3), tol=LOOSE),
    "triangular_solve_lower_t": _case(
        lambda P, a, b: P.triangular_solve(P.tril(a), b, upper=False,
                                           transpose=True), SPD,
        _f(4, 2, seed=3), tol=LOOSE),
    "det": _case(lambda P, a: P.det(a), SPD / 4, tol=LOOSE),
    "slogdet": _case(lambda P, a: P.slogdet(a), SPD, tol=LOOSE),
    "pinv": _case(lambda P, x: P.pinv(x), X, tol=LOOSE),
    "eigvalsh": _case(lambda P, a: P.eigvalsh(a), SPD, tol=LOOSE),
    "matrix_rank": _case(lambda P, x: P.matrix_rank(x), X, grad=False),
    "qr_product": _case(lambda P, x: P.matmul(*P.qr(P.t(x))), X, tol=LOOSE),
    "svd_values": _case(lambda P, x: P.svd(x)[1], X, tol=LOOSE),
    # ---- creation over inputs
    "tril": _case(lambda P, x: P.tril(x, -1), X),
    "triu": _case(lambda P, x: P.triu(x, 1), X),
    "diag": _case(lambda P, v: P.diag(v, 1), _f(3)),
    "diagflat": _case(lambda P, x: P.diagflat(x), _f(2, 2)),
    "one_hot": _case(lambda P, i: P.one_hot(i, 4), IDX, grad=False),
    "zeros_ones_like": _case(lambda P, x: (P.zeros_like(x),
                                           P.ones_like(x, dtype="int32"),
                                           P.full_like(x, 2.5)), X,
                             grad=False),
}


def _to_np(o):
    return o.numpy() if hasattr(o, "numpy") else np.asarray(o)


def _run(P, name):
    fn, inputs, grad, _ = CASES[name]
    ts = [P.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in inputs]
    out = fn(P, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    res = {"out": [_to_np(o) for o in outs],
           "dtype": [o.dtype.name for o in outs]}
    if grad:
        loss = None
        for i, o in enumerate(outs):
            if o.dtype.name.startswith("float") and not o.stop_gradient:
                cot = P.to_tensor(_f(*o.shape, seed=100 + i)) if o.shape \
                    else P.to_tensor(np.float32(1.5))
                term = (o * cot).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        res["grads"] = [None if t.grad is None else t.grad.numpy()
                        for t in ts]
    return res


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_and_gradient_match_jax(name):
    tol = CASES[name][3]
    want, got = _run(jpaddle, name), _run(tpaddle, name)
    assert got["dtype"] == want["dtype"]
    for w, g in zip(want["out"], got["out"]):
        assert g.shape == w.shape
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, **tol)
        else:
            np.testing.assert_array_equal(g, w)
    for w, g in zip(want.get("grads", ()), got.get("grads", ())):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_allclose(g, w, **tol)


CREATION = {
    "zeros": lambda P: P.zeros([2, 3]),
    "ones_int": lambda P: P.ones([2], dtype="int32"),
    "full_int": lambda P: P.full([2, 2], 3),
    "full_bool": lambda P: P.full([2], True),
    "full_float": lambda P: P.full([2], 1.5, dtype="float64"),
    "arange_int": lambda P: P.arange(5),
    "arange_float": lambda P: P.arange(0.0, 2.0, 0.5),
    "linspace": lambda P: P.linspace(0, 1, 5),
    "eye": lambda P: P.eye(3, 4),
    "meshgrid": lambda P: P.meshgrid(P.arange(3), P.arange(2)),
    "tril_indices": lambda P: P.tril_indices(3, 3),
    "triu_indices": lambda P: P.triu_indices(3, 4, 1),
    "assign": lambda P: P.assign(np.array([1.0, 2.0], np.float32)),
    "to_tensor_f64": lambda P: P.to_tensor(np.array([1.5])),
}


@pytest.mark.parametrize("name", sorted(CREATION))
def test_creation_matches_jax(name):
    want, got = CREATION[name](jpaddle), CREATION[name](tpaddle)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    for w, g in zip(want, got):
        assert g.dtype.name == w.dtype.name and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()), **TOL)


RANDOM = {
    "rand": (lambda P: P.rand([4000]), "float32", 0.5, 1 / 12),
    "randn": (lambda P: P.randn([4000]), "float32", 0.0, 1.0),
    "uniform": (lambda P: P.uniform([4000], min=-2.0, max=2.0), "float32",
                0.0, 16 / 12),
    "normal": (lambda P: P.normal(1.0, 2.0, [4000]), "float32", 1.0, 4.0),
    "randint": (lambda P: P.randint(0, 10, [4000]), "int64", 4.5, 99 / 12),
    "randperm": (lambda P: P.randperm(4000), "int64", 1999.5,
                 (4000 ** 2 - 1) / 12),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_by_statistics(name):
    """Shape and dtype, mean and variance within 5 standard errors of the
    distribution's, in both packages; paddle.seed reproduces. (The JAX
    package's ``normal`` gives float64 under its x64 mode; the port's
    gives the default dtype, as Paddle does.)"""
    fn, dtype, mean, var = RANDOM[name]
    for P in (jpaddle, tpaddle):
        P.seed(7)
        a = fn(P)
        P.seed(7)
        b = fn(P)
        assert a.shape == [4000]
        assert a.dtype.name == dtype or (P is jpaddle and name == "normal")
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        v = a.numpy().astype(np.float64)
        assert abs(v.mean() - mean) < 5 * np.sqrt(var / v.size)
        assert abs(v.var() - var) < 0.1 * var
    if name == "randperm":
        np.testing.assert_array_equal(np.sort(v), np.arange(4000))


def test_in_place_variants_rebind():
    """The `op_` variants and increment give the result under the same
    Tensor, as in the JAX package."""
    for P in (jpaddle, tpaddle):
        x = P.to_tensor(X)
        y = P.add_(x, P.to_tensor(Y))
        assert y is x
        P.scale_(x, 2.0)
        P.clip_(x, -1.0, 1.0)
        P.increment(x, 0.5)
        np.testing.assert_allclose(x.numpy(), np.clip((X + Y) * 2, -1, 1)
                                   + 0.5, **TOL)


def test_methods_installed_on_tensor():
    """Every method name the JAX package installs that the port has ported
    is a Tensor method of the port."""
    import paddle_tpu.ops as jops
    import paddle_tpu_torch.ops as tops

    ported = [n for n in jops._METHODS if hasattr(tops, n)]
    assert len(ported) > 120
    for n in ported:
        assert hasattr(tpaddle.Tensor, n), n
    x = tpaddle.to_tensor(X)
    np.testing.assert_allclose(x.exp().sum(axis=1).numpy(),
                               np.exp(X).sum(1), **TOL)
    np.testing.assert_allclose(x.astype("float64").numpy(), X, **TOL)


def test_setitem_on_an_op_output_is_differentiable():
    """h[idx] = value on a tensor that requires grad writes out of place
    under autograd: the gradient reaches both what h was computed from
    (outside the written slots) and the written value (analytic here:
    the JAX package's tape loses both, its node taking itself as input)."""
    x = tpaddle.to_tensor(X, stop_gradient=False)
    y = tpaddle.to_tensor(Y, stop_gradient=False)
    h = x * 2
    h[0] = y[1]
    h[1:, 2] = 7.0
    (h * x).sum().backward()
    hv = 2 * X
    hv[0] = Y[1]
    hv[1:, 2] = 7.0
    mask = np.ones_like(X)
    mask[0] = 0
    mask[1:, 2] = 0
    np.testing.assert_allclose(h.numpy(), hv, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), hv + 2 * X * mask, **TOL)
    want_y = np.zeros_like(Y)
    want_y[1] = X[0]
    np.testing.assert_allclose(y.grad.numpy(), want_y, **TOL)
    w = tpaddle.to_tensor(X)
    w.stop_gradient = False          # a leaf that requires grad: in place
    storage = w._value.data_ptr()
    w[0, 0] = 5.0
    assert w._value.data_ptr() == storage and w.is_leaf
    assert float(w[0, 0]) == 5.0
