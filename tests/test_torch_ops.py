"""The port's op library (``paddle_tpu_torch.ops``) held against the JAX
package's: the cases of ``tests/test_ops.py`` and
``tests/test_ops_extras.py`` one for one, then one parametrised test
over every op of the reference's Tensor-method list
(``monkey_patch_tensor``) and of ``extras.__all__``, forward and, where
the op has one, gradient, on the same seeded numpy inputs in f32."""
import ast
import inspect

import numpy as np
import pytest
import scipy.special as sps

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import both, on_cpu  # noqa: F401

R = np.random.RandomState(0)


def rnd(*shape):
    return R.rand(*shape).astype(np.float32)


def close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t.numpy()), np.asarray(j.numpy()),
                               rtol=rtol, atol=atol)


def run(name, *args, **kw):
    """``name`` over the same arguments in both packages (numpy arrays
    become tensors; lists of them, lists of tensors)."""
    def conv(pkg, a):
        if isinstance(a, np.ndarray):
            return pkg.to_tensor(a)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [pkg.to_tensor(v) for v in a]
        return a
    return tuple(getattr(pkg.ops, name)(*[conv(pkg, a) for a in args], **kw)
                 for pkg in (ptt, pt))


# -- tests/test_ops.py, case for case ------------------------------------------
class TestMath:
    def test_binary_broadcast(self):
        close(*run("add", rnd(3, 1, 4), rnd(2, 1)))

    def test_scale(self):
        x = rnd(3)
        close(*run("scale", x, 2.0, 1.0))
        close(*run("scale", x, 2.0, 1.0, bias_after_scale=False))

    def test_clip(self):
        t, j = run("clip", np.array([-2.0, 0.5, 3.0], np.float32), 0.0, 1.0)
        close(t, j)
        np.testing.assert_allclose(t.numpy(), [0, 0.5, 1])

    def test_cumsum(self):
        x = rnd(2, 3)
        close(*run("cumsum", x, 1))
        close(*run("cumsum", x))

    def test_remainder_floordiv(self):
        a = np.array([7.0, -7.0], np.float32)
        b = np.array([3.0, 3.0], np.float32)
        close(*run("remainder", a, b))
        close(*run("floor_divide", a, b))


class TestReduction:
    def test_sum_axes(self):
        x = rnd(2, 3, 4)
        close(*run("sum", x), rtol=1e-5)
        close(*run("sum", x, axis=1), rtol=1e-5)
        close(*run("sum", x, axis=[0, 2], keepdim=True), rtol=1e-5)

    def test_mean_std_var(self):
        x = rnd(4, 5)
        close(*run("mean", x, 0), rtol=1e-5)
        close(*run("std", x), rtol=1e-5)
        close(*run("var", x, unbiased=False), rtol=1e-5)

    def test_argmax_argmin(self):
        x = rnd(3, 5)
        close(*run("argmax", x, 1))
        close(*run("argmin", x, 0))
        assert ptt.argmax(ptt.to_tensor(x), 1).dtype == ptt.int64

    def test_topk(self):
        x = rnd(2, 8)
        (tv, ti), (jv, ji) = run("topk", x, 3)
        close(tv, jv)
        close(ti, ji)
        (tv, _), (jv, _) = run("topk", x, 3, largest=False)
        close(tv, jv)

    def test_logsumexp(self):
        close(*run("logsumexp", rnd(3, 4), 1), rtol=1e-4)

    def test_all_any(self):
        x = np.array([[True, False], [True, True]])
        close(*run("all", x, axis=1))
        close(*run("any", x, axis=0))
        t = ptt.to_tensor(x)
        np.testing.assert_array_equal(ptt.ops.OPS["all"](t, axis=1).numpy(),
                                      x.all(1))


class TestManipulation:
    def test_reshape_transpose(self):
        x = rnd(2, 3, 4)
        t, j = run("reshape", x, [4, 6])
        assert t.shape == j.shape == [4, 6]
        close(*run("transpose", x, [2, 0, 1]))

    def test_concat_stack_split(self):
        a, b = rnd(2, 3), rnd(2, 3)
        close(*run("concat", [a, b], 1))
        close(*run("stack", [a, b], 0))
        parts, jparts = run("split", rnd(6, 2), 3)
        assert len(parts) == len(jparts) == 3 and parts[0].shape == [2, 2]
        parts, jparts = run("split", rnd(7, 2), [2, -1, 3])
        assert [p.shape[0] for p in parts] == [2, 2, 3]
        for p, q in zip(parts, jparts):
            close(p, q)

    def test_squeeze_unsqueeze_flatten(self):
        x = rnd(1, 3, 1, 4)
        assert run("squeeze", x)[0].shape == [3, 4]
        assert run("squeeze", x, 0)[0].shape == [3, 1, 4]
        t, j = run("unsqueeze", rnd(3), [0, 2])
        assert t.shape == j.shape == [1, 3, 1]
        t, j = run("flatten", rnd(2, 3, 4), 1, 2)
        assert t.shape == j.shape == [2, 12]

    def test_gather_scatter(self):
        x = rnd(5, 3)
        idx = np.array([0, 3])
        close(*run("gather", x, idx))
        close(*run("scatter", x, idx, rnd(2, 3)))

    def test_gather_nd(self):
        close(*run("gather_nd", rnd(3, 4, 5), np.array([[0, 1], [2, 3]])))

    def test_where_nonzero(self):
        c = np.array([[True, False], [False, True]])
        close(*run("where", c, rnd(2, 2), rnd(2, 2)))
        close(*run("nonzero", c))

    def test_pad(self):
        t, j = run("pad", rnd(2, 3), [1, 1, 2, 2])
        assert t.shape == j.shape == [4, 7]
        close(t, j)

    def test_tril_triu(self):
        x = rnd(4, 4)
        close(*run("tril", x))
        close(*run("triu", x, 1))

    def test_tile_expand(self):
        x = rnd(1, 3)
        assert run("tile", x, [2, 2])[0].shape == [2, 6]
        assert run("expand", x, [4, 3])[0].shape == [4, 3]
        t, j = run("expand", x, [4, -1])
        assert t.shape == [4, 3]
        close(t, j)

    def test_sort_argsort(self):
        x = rnd(3, 5)
        close(*run("sort", x, 1))
        close(*run("argsort", x, 1))

    def test_one_hot(self):
        close(*run("one_hot", np.array([0, 2, 1]), 3))

    def test_take_put_along_axis(self):
        x = rnd(3, 4)
        idx = np.array([[1], [0], [2]])
        close(*run("take_along_axis", x, idx, 1, broadcast=False))
        close(*run("put_along_axis", x, idx, 9.0, 1))

    def test_flip_roll(self):
        x = rnd(3, 4)
        close(*run("flip", x, 0))
        close(*run("roll", x, 1, 1))


class TestLinalg:
    def test_matmul_transpose_flags(self):
        a, b = rnd(3, 4), rnd(5, 4)
        close(*run("matmul", a, b, transpose_y=True), rtol=1e-5)
        close(*run("matmul", a.T.copy(), b.T.copy(), transpose_x=True),
              rtol=1e-5)

    def test_bmm(self):
        close(*run("bmm", rnd(2, 3, 4), rnd(2, 4, 5)), rtol=1e-5)

    def test_einsum(self):
        close(*run("einsum", "ij,jk->ik", rnd(3, 4), rnd(4, 5)), rtol=1e-5)

    def test_norm(self):
        x = rnd(3, 4)
        close(*run("norm", x), rtol=1e-5)
        close(*run("norm", x, p=1, axis=1), rtol=1e-5)

    def test_solve_inverse_det(self):
        a = rnd(3, 3) + np.eye(3, dtype=np.float32) * 3
        close(*run("solve", a, rnd(3, 2)), rtol=1e-4)
        close(*run("inverse", a), rtol=1e-4)
        close(*run("det", a), rtol=1e-4)

    def test_svd_qr_cholesky(self):
        a = rnd(4, 3)
        u, s, vt = ptt.svd(ptt.to_tensor(a))
        np.testing.assert_allclose((u.numpy() * s.numpy()) @ vt.numpy(), a,
                                   rtol=1e-4, atol=1e-5)
        close(s, pt.svd(pt.to_tensor(a))[1], rtol=1e-4)
        q, r = ptt.qr(ptt.to_tensor(a))
        np.testing.assert_allclose(q.numpy() @ r.numpy(), a, rtol=1e-4,
                                   atol=1e-5)
        spd = a.T @ a + np.eye(3, dtype=np.float32)
        close(*run("cholesky", spd), rtol=1e-4)


# -- tests/test_ops_extras.py, case for case ------------------------------------
def test_kron_trace_mm_tensordot():
    a = np.arange(4, dtype=np.float32).reshape(2, 2)
    b = np.ones((2, 2), np.float32)
    close(*run("kron", a, b))
    close(*run("trace", a))
    close(*run("mm", a, b))
    close(*run("tensordot", a, b, axes=1))


def test_trapezoid_family():
    y = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    close(*run("trapezoid", y, dx=0.5))
    t, j = run("cumulative_trapezoid", y, dx=1.0)
    close(t, j)
    np.testing.assert_allclose(t.numpy(), [1.5, 4.0, 7.5], rtol=1e-6)


def test_angles_and_special():
    x = np.array([0.5, 1.5], np.float32)
    for name in ("rad2deg", "deg2rad", "i0", "i1"):
        close(*run(name, x), rtol=1e-5)
    np.testing.assert_allclose(ptt.i0(ptt.to_tensor(x)).numpy(), sps.i0(x),
                               rtol=1e-5)
    a = np.array([0.5, 2.0], np.float32)
    v = np.array([1.5, 0.3], np.float32)
    close(*run("igamma", a, v), rtol=1e-5)
    close(*run("igammac", a, v), rtol=1e-5)
    close(*run("polygamma", x, 1), rtol=1e-4)


def test_renorm_caps_norms():
    x = np.array([[3.0, 4.0], [0.3, 0.4]], np.float32)
    t, j = run("renorm", x, p=2.0, axis=0, max_norm=1.0)
    close(t, j)
    np.testing.assert_allclose(np.linalg.norm(t.numpy()[0]), 1.0, rtol=1e-5)


def test_label_smooth_and_splits():
    close(*run("label_smooth", np.eye(4, dtype=np.float32)[:2],
               epsilon=0.1))
    x = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    for name, args in (("vsplit", (2,)), ("tensor_split", ([1, 3],))):
        kw = {"axis": 0} if name == "tensor_split" else {}
        tp, jp = run(name, x, *args, **kw)
        assert [p.shape for p in tp] == [p.shape for p in jp]
        for p, q in zip(tp, jp):
            close(p, q)
    tu, ju = run("unstack", x, axis=1)
    assert len(tu) == 3 and tu[0].shape == [4, 2]
    for p, q in zip(tu, ju):
        close(p, q)


def test_matrix_exp_vander_householder_pdist():
    a = np.diag([0.0, np.log(2.0)]).astype(np.float32)
    close(*run("matrix_exp", a), rtol=1e-5, atol=1e-6)
    close(*run("vander", np.array([1.0, 2.0, 3.0], np.float32)))
    close(*run("pdist", np.array([[0.0, 0.0], [3.0, 4.0], [0.0, 1.0]],
                                 np.float32)))


def test_inplace_clone_index_fill():
    x = ptt.to_tensor(np.array([1.0, 5.0, -3.0], np.float32))
    c = ptt.clone(x)
    ptt.clip_(x, min=0.0, max=2.0)
    np.testing.assert_allclose(x.numpy(), [1.0, 2.0, 0.0])
    np.testing.assert_allclose(c.numpy(), [1.0, 5.0, -3.0])
    ptt.increment(x, 1.0)
    np.testing.assert_allclose(x.numpy(), [2.0, 3.0, 1.0])
    close(*run("index_fill", np.zeros((3, 2), np.float32),
               np.array([0, 2]), 0, 7.0))
    assert int(ptt.rank(ptt.to_tensor(np.zeros((2, 3)))).numpy()) == 2


def test_quantile_digitize_polar_binomial():
    x = np.array([1.0, np.nan, 3.0, 2.0], np.float32)
    close(*run("nanquantile", x, 0.5))
    close(*run("digitize", np.array([0.5, 1.5, 5.0], np.float32),
               np.array([0.0, 1.0, 2.0], np.float32)))
    close(*run("polar", np.array([2.0], np.float32),
               np.array([np.pi / 2], np.float32)), atol=1e-6)
    ptt.seed(0)
    draws = ptt.binomial(ptt.to_tensor(np.array([100], np.int64)),
                         ptt.to_tensor(np.array([0.3], np.float32)))
    assert draws.dtype == ptt.int64 and 10 < int(draws.numpy()[0]) < 60


def test_extras_gradients():
    jx, x = both(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32), False)
    ptt.ops.sum(ptt.kron(x, x)).backward()
    pt.ops.sum(pt.kron(jx, jx)).backward()
    close(x.grad, jx.grad)


def test_cumulative_trapezoid_with_x_2d():
    y = np.arange(12, dtype=np.float32).reshape(3, 4)
    x = np.cumsum(np.ones((3, 4), np.float32), axis=0)
    close(*run("cumulative_trapezoid", y, x, axis=0), rtol=1e-5)


def test_binomial_large_count():
    """The reference switches to a normal approximation above 4096
    trials; PyTorch's sampler is exact at any count. Both stay inside a
    6-sigma window."""
    ptt.seed(1)
    draws = ptt.binomial(ptt.to_tensor(np.array([1_000_000], np.int64)),
                         ptt.to_tensor(np.array([0.5], np.float32)))
    assert 497_000 < int(draws.numpy()[0]) < 503_000


def test_unique_consecutive_keeps_paddles_meaning():
    """Paddle's ``unique_consecutive`` collapses runs; the reference
    returns the sorted unique values instead (a reference-side caveat,
    ROADMAP §3)."""
    x = np.array([1, 1, 3, 3, 2, 1])
    t, j = run("unique_consecutive", x)
    np.testing.assert_array_equal(t.numpy(), [1, 3, 2, 1])
    np.testing.assert_array_equal(j.numpy(), [1, 2, 3])
    out, inv, counts = ptt.unique_consecutive(
        ptt.to_tensor(x), return_inverse=True, return_counts=True)
    np.testing.assert_array_equal(inv.numpy(), [0, 0, 1, 1, 2, 3])
    np.testing.assert_array_equal(counts.numpy(), [2, 2, 1, 1])


def test_decomposition_gradients_the_reference_cannot_take():
    """The reference's tape cannot differentiate ``svd`` (it hands
    ``jax.vjp`` a tuple for the named result); the port's gradient of
    the singular values is the known one, u vᵀ (a reference-side
    caveat, ROADMAP §3)."""
    a = np.random.RandomState(2).rand(4, 3).astype(np.float32)
    x = ptt.to_tensor(a, stop_gradient=False)
    u, s, vt = ptt.svd(x)
    s.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), u.numpy() @ vt.numpy(),
                               rtol=1e-4, atol=1e-5)
    jx = pt.to_tensor(a, stop_gradient=False)
    with pytest.raises(ValueError):
        pt.svd(jx)[1].sum().backward()


# -- the op table ----------------------------------------------------------------
def _reference_method_list():
    """The list literal inside the reference's ``monkey_patch_tensor``."""
    src = inspect.getsource(pt.ops.monkey_patch_tensor)
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and \
                node.targets[0].id == "method_names":
            return [e.value for e in node.value.elts]
    raise AssertionError("method_names not found")


REF_METHODS = _reference_method_list()
EXTRAS = list(pt.ops.extras.__all__)
TABLE_OPS = list(dict.fromkeys(REF_METHODS + EXTRAS))


def _spd(n):
    a = np.random.RandomState(5).rand(n, n).astype(np.float32)
    return a @ a.T + n * np.eye(n, dtype=np.float32)


def _u(*s):  # positive, away from 0
    return np.random.RandomState(11).rand(*s).astype(np.float32) * 0.8 + 0.2


def _n(*s):
    return np.random.RandomState(12).randn(*s).astype(np.float32)


def _i(*s, hi=4):
    return np.random.RandomState(13).randint(0, hi, s).astype(np.int64)


def _b(*s):
    return np.random.RandomState(14).rand(*s) > 0.5


X, Y = _n(3, 4), _n(3, 4) + 0.1
# op -> (args, kwargs); the default is a unary op on X
SPECS = {
    "add": ((X, Y), {}), "subtract": ((X, Y), {}), "multiply": ((X, Y), {}),
    "divide": ((X, _u(3, 4)), {}), "floor_divide": ((X, _u(3, 4)), {}),
    "remainder": ((X, _u(3, 4)), {}), "pow": ((_u(3, 4), Y), {}),
    "maximum": ((X, Y), {}), "minimum": ((X, Y), {}),
    "log": ((_u(3, 4),), {}), "log2": ((_u(3, 4),), {}),
    "log10": ((_u(3, 4),), {}), "log1p": ((_u(3, 4),), {}),
    "sqrt": ((_u(3, 4),), {}), "rsqrt": ((_u(3, 4),), {}),
    "reciprocal": ((_u(3, 4),), {}),
    "clip": ((X, -0.5, 0.5), {}), "scale": ((X, 2.0, 0.5), {}),
    "cumsum": ((X, 1), {}), "cumprod": ((_u(3, 4), 1), {}),
    "equal": ((_i(3, 4), _i(3, 4)), {}), "not_equal": ((X, Y), {}),
    "less_than": ((X, Y), {}), "less_equal": ((X, Y), {}),
    "greater_than": ((X, Y), {}), "greater_equal": ((X, Y), {}),
    "logical_and": ((_b(3, 4), _b(3, 4)), {}),
    "logical_or": ((_b(3, 4), _b(3, 4)), {}),
    "logical_not": ((_b(3, 4),), {}),
    "logical_xor": ((_b(3, 4), _b(3, 4)), {}),
    "bitwise_and": ((_i(3, 4, hi=9), _i(3, 4, hi=7)), {}),
    "bitwise_or": ((_i(3, 4, hi=9), _i(3, 4, hi=7)), {}),
    "bitwise_xor": ((_i(3, 4, hi=9), _i(3, 4, hi=7)), {}),
    "bitwise_not": ((_i(3, 4, hi=9),), {}),
    "allclose": ((X, X + 1e-7), {}), "isclose": ((X, Y), {}),
    "equal_all": ((X, X), {}), "lerp": ((X, Y, 0.3), {}),
    "nan_to_num": ((np.array([np.nan, np.inf, -np.inf, 1.0],
                             np.float32),), {}),
    "isnan": ((np.array([np.nan, 1.0], np.float32),), {}),
    "isinf": ((np.array([np.inf, 1.0], np.float32),), {}),
    "isfinite": ((np.array([np.inf, 1.0], np.float32),), {}),
    "sum": ((X, 1), {}), "mean": ((X, 0), {}), "prod": ((_u(3, 4), 1), {}),
    "max": ((X, 1), {}), "min": ((X, 0), {}), "amax": ((X, 1), {}),
    "amin": ((X, [0, 1]), {}), "std": ((X, 1), {}), "var": ((X, 0), {}),
    "median": ((X, 1), {}), "logsumexp": ((X, 1), {}),
    "argmax": ((X, 1), {}), "argmin": ((X, 0), {}),
    "all": ((_b(3, 4), 1), {}), "any": ((_b(3, 4), 0), {}),
    "topk": ((X, 2), {}), "kthvalue": ((X, 2), {}),
    "mode": ((np.array([[1., 2., 2., 3.], [4., 4., 1., 1.]], np.float32),),
             {}),
    "count_nonzero": ((_i(3, 4), 1), {}),
    "nanmean": ((np.array([[1.0, np.nan], [3.0, 4.0]], np.float32), 1), {}),
    "nansum": ((np.array([[1.0, np.nan], [3.0, 4.0]], np.float32), 1), {}),
    "quantile": ((X, 0.3), {"axis": 1}),
    "cast": ((X, "float16"), {}), "reshape": ((X, [0, 2, 2]), {}),
    "transpose": ((X, [1, 0]), {}), "concat": (([X, Y], 1), {}),
    "split": ((X, [1, -1, 1], 1), {}), "chunk": ((X, 2, 1), {}),
    "squeeze": ((X[None], 0), {}), "unsqueeze": ((X, [0, 2]), {}),
    "flatten": ((X[None],), {}), "tile": ((X, [2, 1]), {}),
    "expand": ((X[:1], [3, -1]), {}), "broadcast_to": ((X[:1], [3, 4]), {}),
    "expand_as": ((X[:1], Y), {}), "flip": ((X, [0, 1]), {}),
    "roll": ((X, 2, 1), {}), "gather": ((X, np.array([2, 0]), 0), {}),
    "gather_nd": ((X, np.array([[0, 1], [2, 3]])), {}),
    "take_along_axis": ((X, np.array([[1], [0], [3]]), 1), {}),
    "put_along_axis": ((X, np.array([[1], [0], [3]]), 5.0, 1), {}),
    "scatter": ((X, np.array([2, 0]), Y[:2]), {}),
    "scatter_nd_add": ((X, np.array([[0], [2]]), Y[:2]), {}),
    "index_select": ((X, np.array([3, 1]), 1), {}),
    "index_sample": ((X, np.array([[0, 3], [1, 1], [2, 0]])), {}),
    "index_add": ((X, np.array([0, 2]), 0, Y[:2]), {}),
    "masked_select": ((X, _b(3, 4)), {}),
    "masked_fill": ((X, _b(3, 4), 2.0), {}),
    "where": ((_b(3, 4), X, Y), {}), "nonzero": ((_b(3, 4),), {}),
    "tril": ((X, -1), {}), "triu": ((X, 1), {}),
    "pad": ((X, [1, 2]), {"mode": "reflect"}),
    "repeat_interleave": ((X, 2, 0), {}), "sort": ((X, 1), {}),
    "argsort": ((X, 0), {"descending": True}), "unbind": ((X, 1), {}),
    "unique": ((_i(3, 4),), {}), "diagonal": ((X, 1), {}),
    "diff": ((X, 1, 1), {}), "moveaxis": ((X[None], 0, 2), {}),
    "swapaxes": ((X, 0, 1), {}), "one_hot": ((_i(5), 4), {}),
    "slice": ((X, [0, 1], [1, 0], [3, 3]), {}),
    "strided_slice": ((X, [1], [3], [0], [-2]), {}),
    "bucketize": ((X, np.array([-1.0, 0.0, 1.0], np.float32)), {}),
    "searchsorted": ((np.array([-1.0, 0.0, 1.0], np.float32), X), {}),
    "matmul": ((X, Y.T.copy()), {}), "bmm": ((_n(2, 3, 4), _n(2, 4, 2)), {}),
    "dot": ((X, Y), {}), "mv": ((X, _n(4)), {}), "norm": ((X,), {"p": 3}),
    "dist": ((X, Y), {"p": 3.0}), "cross": ((_n(2, 3), _n(2, 3)), {}),
    "cholesky": ((_spd(3),), {}), "qr": ((X.T.copy(),), {}),
    "svd": ((X,), {}), "eig": ((_spd(3) + _n(3, 3),), {}),
    "eigh": ((_spd(3),), {}), "det": ((_spd(3),), {}),
    "slogdet": ((_spd(3),), {}), "inverse": ((_spd(3),), {}),
    "pinv": ((X,), {}), "solve": ((_spd(3), _n(3, 2)), {}),
    "matrix_power": ((_spd(3) / 4, 3), {}), "t": ((X,), {}),
    "histogram": ((X,), {"bins": 5}), "bincount": ((_i(8, hi=5),), {}),
    "addmm": ((_n(3, 2), X, _n(4, 2)), {"beta": 0.5, "alpha": 2.0}),
    "outer": ((_n(3), _n(4)), {}), "inner": ((X, Y), {}),
    # extras
    "kron": ((_n(2, 2), _n(2, 3)), {}), "trapezoid": ((X,), {"dx": 0.5}),
    "cumulative_trapezoid": ((X,), {"dx": 0.5}),
    "polygamma": ((_u(3, 4) + 0.5, 1), {}),
    "igamma": ((_u(3, 4) + 0.5, _u(3, 4)), {}),
    "igammac": ((_u(3, 4) + 0.5, _u(3, 4)), {}),
    "renorm": ((X, 2.0, 0, 1.0), {}), "floor_mod": ((X, _u(3, 4)), {}),
    "clip_": ((X.copy(), -0.5, 0.5), {}),
    "label_smooth": ((np.eye(4, dtype=np.float32)[:3],), {"epsilon": 0.2}),
    "increment": ((X.copy(), 2.0), {}),
    "nanquantile": ((np.array([[1.0, np.nan, 3.0], [2.0, 5.0, 1.0]],
                              np.float32), 0.4), {"axis": 1}),
    "digitize": ((X, np.array([-1.0, 0.0, 1.0], np.float32)), {}),
    "polar": ((_u(3, 4), X), {}), "matrix_exp": ((X[:3, :3] / 2,), {}),
    "vander": ((_n(3),), {}),
    "householder_product": ((X.T.copy(), _u(3)), {}),
    "pdist": ((_n(4, 3),), {}), "tensordot": ((X, Y.T.copy()), {"axes": 1}),
    "mm": ((X, Y.T.copy()), {}), "trace": ((X,), {"offset": 1}),
    "unstack": ((X, 1), {}), "index_fill": ((X, np.array([0, 2]), 1, 3.0),
                                            {}),
    "rank": ((X,), {}), "vsplit": ((_n(4, 2), 2), {}),
    "hsplit": ((_n(2, 4), [1, 3]), {}), "dsplit": ((_n(2, 2, 4), 2), {}),
    "tensor_split": ((X, 3, 1), {}),
    "binomial": ((np.array([5, 50, 500], np.int64),
                  np.array([0.1, 0.5, 0.9], np.float32)), {}),
}
UNARY = ((X,), {})  # the spec of every op not listed
# ops with no gradient in one of the packages, or whose output is not
# differentiable: forward only
NO_GRAD = {"floor_divide", "remainder", "floor_mod", "sign", "floor",
           "ceil", "round", "trunc", "histogram", "bincount", "clip_",
           "increment", "digitize", "bucketize", "searchsorted", "polygamma",
           "igamma", "igammac", "i0", "i1", "polar", "eig", "householder_product",
           "nanquantile", "median", "quantile", "kthvalue", "mode", "pinv",
           "matrix_exp", "lu", "unique",
           # the reference cannot differentiate these (ROADMAP §3): its
           # tape hands jax.vjp a tuple for svd's and eigh's named
           # results, and pdist's norm of the zero diagonal gives NaN
           "svd", "eigh", "pdist"}
# results equal only up to a sign per singular/eigen vector: compare what
# the decomposition reconstructs
RECONSTRUCT = {"svd", "qr", "eig", "eigh"}
LOOSE = {"sum", "mean", "prod", "std", "var", "median", "logsumexp",
         "quantile", "nanmean", "nansum", "norm", "dist", "cholesky", "svd",
         "det", "slogdet", "inverse", "pinv", "solve", "matrix_power", "qr",
         "eigh", "eig", "matmul", "bmm", "dot", "mv", "addmm", "inner",
         "kron", "matrix_exp", "householder_product", "pdist", "tensordot",
         "mm", "renorm", "trapezoid", "cumulative_trapezoid", "polygamma",
         "igamma", "igammac", "nanquantile", "cumprod"}


def _float_inputs(args):
    return [i for i, a in enumerate(args)
            if isinstance(a, np.ndarray) and a.dtype == np.float32]


def _outs(r):
    return list(r) if isinstance(r, (tuple, list)) else [r]


def _reconstruct(name, outs):
    o = [np.asarray(v.numpy()) for v in outs]
    if name == "svd":
        return [(o[0] * o[1]) @ o[2], o[1]]
    if name == "qr":
        return [o[0] @ o[1], np.abs(o[1])]
    if name == "eigh":
        return [(o[1] * o[0]) @ o[1].T, o[0]]
    return [np.sort_complex(o[0])]  # eig


def test_op_table_covers_the_reference_lists():
    assert ptt.ops.TENSOR_METHODS == REF_METHODS
    assert all(hasattr(ptt.ops.extras, n) for n in EXTRAS)


@pytest.mark.parametrize("name", TABLE_OPS)
def test_op_table(name):
    """``name`` in both packages on the same inputs: every output equal
    (values; int64 where the reference stores int32), and the gradient of
    a weighted sum of the first float output with respect to each float
    input."""
    args, kw = SPECS.get(name, UNARY)
    fidx = [] if name in NO_GRAD else _float_inputs(args)
    res = {}
    for pkg in (ptt, pt):
        targs = []
        for i, a in enumerate(args):
            if isinstance(a, np.ndarray):
                a = pkg.to_tensor(a.copy(), stop_gradient=i not in fidx)
            elif isinstance(a, list) and isinstance(a[0], np.ndarray):
                a = [pkg.to_tensor(v) for v in a]
            targs.append(a)
        out = _outs(getattr(pkg.ops, name)(*targs, **kw))
        grads = []
        first = next((o for o in out if o.dtype.name.startswith("float")),
                     None)
        if fidx and first is not None:
            w = np.asarray(np.random.RandomState(3).rand(*first.shape),
                           np.float32)
            (first * pkg.to_tensor(w)).sum().backward()
            grads = [targs[i].grad for i in fidx]
        res[pkg] = (out, grads)
    (tout, tg), (jout, jg) = res[ptt], res[pt]
    rtol, atol = (1e-4, 1e-5) if name in LOOSE else (1e-5, 1e-6)
    assert len(tout) == len(jout)
    if name == "binomial":  # random: the draws differ by contract
        assert tout[0].dtype == ptt.int64 and tout[0].shape == jout[0].shape
        n = np.asarray(args[0])
        assert (tout[0].numpy() >= 0).all() and (tout[0].numpy() <= n).all()
    elif name in RECONSTRUCT:
        for a, b in zip(_reconstruct(name, tout), _reconstruct(name, jout)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    else:
        for t, j in zip(tout, jout):
            tn, jn = np.asarray(t.numpy()), np.asarray(j.numpy())
            assert tn.shape == jn.shape, (t.shape, j.shape)
            assert tn.dtype.kind == jn.dtype.kind or \
                {tn.dtype.kind, jn.dtype.kind} <= {"i", "u"}
            np.testing.assert_allclose(tn, jn, rtol=rtol, atol=atol)
    for t, j in zip(tg, jg):
        # an input read only for its shape (expand_as's y) gets no
        # gradient in PyTorch, and zeros from the reference's tape
        t = np.zeros(j.shape, np.float32) if t is None else t.numpy()
        j = np.zeros(t.shape, np.float32) if j is None else j.numpy()
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5)


# -- faults F5-F8 (ROADMAP §3) and the float64 pin ------------------------------
def _pair_values(t, j):
    return np.asarray(t.numpy()), np.asarray(j.numpy())


@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16])
def test_integer_scans_keep_their_dtype(name, dtype):
    """F5: the scans keep a narrow integer dtype and wrap as the
    reference's jnp scans do (torch widens them to int64)."""
    x = np.array([100, 100, 100], dtype) if dtype != np.int16 else \
        np.array([30000, 30000, 5], dtype)
    tn, jn = _pair_values(*run(name, x))
    assert tn.dtype == jn.dtype == dtype
    np.testing.assert_array_equal(tn, jn)
    if name == "cumsum" and dtype == np.int8:
        assert tn.tolist() == [100, -56, 44]


@pytest.mark.parametrize("name", ["sum", "prod", "nansum", "trace", "dot"])
def test_unsigned_reductions_widen_to_int64(name):
    """F5, pinned divergence: a uint8 reduction gives int64 in the port
    (its integer results are int64, as for int32) where the reference
    gives uint32; the values are equal."""
    x = np.array([[2, 1], [3, 4]], np.uint8)
    args = (x[0], x[1]) if name == "dot" else (x,)
    tn, jn = _pair_values(*run(name, *args))
    assert tn.dtype == np.int64 and jn.dtype == np.uint32
    np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_as_complex_refuses_half_precision(dtype):
    """F6: a float16 (or bfloat16) pair raises TypeError at the call, as
    the reference's ``lax.complex`` does (it used to return a complex32
    tensor whose dtype raised)."""
    x = np.ones((2, 2), np.float32)
    for pkg in (ptt, pt):
        with pytest.raises(TypeError):
            pkg.ops.as_complex(pkg.to_tensor(x).astype(dtype))
    t, j = run("as_complex", x)
    assert str(t.dtype).endswith("complex64")
    np.testing.assert_array_equal(*_pair_values(t, j))


_A = np.array([[4, 1], [1, 3]], np.int32)
_V = np.array([3, 4], np.int32)
_B = np.array([True, False, True])
F7_CASES = {
    "hypot": (_V, _V), "logaddexp": (_V, _V), "igamma": (_V, _V),
    "igammac": (_V, _V), "pdist": (_A,), "polar": (_V, _V),
    "det": (_A,), "slogdet": (_A,), "inverse": (_A,), "pinv": (_A,),
    "matrix_rank": (_A,), "cholesky": (_A,), "cholesky_solve": (_A, _A),
    "eigh": (_A,), "eigvalsh": (_A,), "lu": (_A,), "qr": (_A,),
    "svd": (_A,), "solve": (_A, _A), "triangular_solve": (_A, _A),
    "lstsq": (_A, _A), "matrix_exp": (_A,),
    "abs[bool]": (_B,), "ceil[bool]": (_B,), "floor[bool]": (_B,),
    "trunc[bool]": (_B,), "argmax[bool]": (_B,), "argmin[bool]": (_B,),
}


def _signless(name, arrs):
    """Factors that are unique up to the sign of each vector."""
    if name in ("eigh", "svd", "qr"):
        return [np.abs(a) for a in arrs]
    return arrs


@pytest.mark.parametrize("case", sorted(F7_CASES))
def test_integer_and_bool_inputs_promote_as_the_reference(case):
    """F7: integer inputs the reference promotes to float (complex64 for
    ``polar``) compute there in the port too, and bool inputs to the
    rounding ops and to argmax/argmin give what the reference gives.
    Integer result dtypes are int64 where the reference's are int32 (the
    pinned divergence of ``test_to_tensor_int_dtype``)."""
    name = case.split("[")[0]
    t, j = run(name, *F7_CASES[case])
    touts = t if isinstance(t, (tuple, list)) else (t,)
    jouts = j if isinstance(j, (tuple, list)) else (j,)
    assert len(touts) == len(jouts)
    tn = [np.asarray(v.numpy()) for v in touts]
    jn = [np.asarray(v.numpy()) for v in jouts]
    for a, b in zip(tn, jn):
        assert a.dtype.kind == b.dtype.kind or \
            {a.dtype.kind, b.dtype.kind} <= {"i", "u"}, (a.dtype, b.dtype)
        assert a.dtype.kind not in "iu" or a.dtype == np.int64 or \
            a.dtype == b.dtype
    if name == "lstsq":  # the residuals of a square system are empty
        tn, jn = [tn[0], tn[2], tn[3]], [jn[0], jn[2], jn[3]]
    for a, b in zip(_signless(name, tn), _signless(name, jn)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_digamma_at_zero_and_heaviside_of_integers():
    """F8, pinned divergences: ``digamma(0)`` is -inf in the port
    (torch's) and nan in the reference (both nan at -1 and equal
    elsewhere); ``heaviside`` of integers keeps the integer dtype
    (Paddle's), where the reference returns float32 with equal values."""
    t, j = _pair_values(*run("digamma", np.array([0.0, -1.0, 1.5, 3.0],
                                                 np.float32)))
    assert t[0] == -np.inf and np.isnan(j[0])
    assert np.isnan(t[1]) and np.isnan(j[1])
    np.testing.assert_allclose(t[2:], j[2:], rtol=1e-5)
    t, j = _pair_values(*run("heaviside", np.array([1, 0, -3], np.int32),
                             np.array([0, 1, 1], np.int32)))
    assert t.dtype.kind == "i" and j.dtype == np.float32
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("how", ["array", "dtype"])
def test_to_tensor_keeps_float64(how):
    """Pinned divergence: float64 stays float64 in the port (Paddle's),
    where the reference runs JAX with x64 off and gives float32."""
    x = np.array([0.1, 1.0 / 3.0])
    t, j = (pkg.to_tensor(x) if how == "array" else
            pkg.to_tensor(x.tolist(), dtype="float64") for pkg in (ptt, pt))
    assert str(t.dtype).endswith("float64") and \
        str(j.dtype).endswith("float32")
    np.testing.assert_array_equal(t.numpy(), x)
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-7)
