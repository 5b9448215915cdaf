"""The port's autograd API (``core/autograd.py``) and ``PyLayer``
(``autograd/py_layer.py``) held against the JAX package, case for case
with ``tests/test_autograd.py``, on the same numpy inputs. The
numeric-gradient checks keep that test's ``rtol 1e-2, atol 1e-3``; the
analytic gradients are compared with the JAX package's at f32
precision."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import both, on_cpu  # noqa: F401


def numeric_grad(f, x, eps=1e-3):
    """Central finite differences of scalar f at numpy point x."""
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        i = it.multi_index
        xp = x.copy()
        xp[i] += eps
        xm = x.copy()
        xm[i] -= eps
        g[i] = (f(xp) - f(xm)) / (2 * eps)
        it.iternext()
    return g


@pytest.mark.parametrize("op_name", [
    "exp", "log", "sqrt", "tanh", "sigmoid", "sin", "cos", "square", "abs",
    "rsqrt", "log1p", "erf",
])
def test_unary_numeric_grad(op_name):
    rng = np.random.RandomState(0)
    x_np = (rng.rand(3, 4).astype(np.float32) * 0.8 + 0.2)
    op = getattr(ptt, op_name)
    x = ptt.to_tensor(x_np, stop_gradient=False)
    op(x).sum().backward()
    num = numeric_grad(
        lambda v: float(op(ptt.to_tensor(v)).sum().numpy()), x_np)
    np.testing.assert_allclose(x.grad.numpy(), num, rtol=1e-2, atol=1e-3)
    jx = pt.to_tensor(x_np, stop_gradient=False)
    getattr(pt, op_name)(jx).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_chain_rule():
    x = ptt.to_tensor(2.0, stop_gradient=False)
    y = x * x * x  # dy/dx = 3x^2 = 12
    y.backward()
    np.testing.assert_allclose(float(x.grad.numpy()), 12.0, rtol=1e-6)


def test_grad_accumulation():
    x = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0, 5.0])
    x.clear_grad()
    assert x.grad is None


def test_branching_graph():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    a = x * 2
    b = x * 3
    (a + b).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])


def test_matmul_grad():
    rng = np.random.RandomState(0)
    A = rng.rand(3, 4).astype(np.float32)
    B = rng.rand(4, 5).astype(np.float32)
    (ja, ta), (jb, tb) = both(A, False), both(B, False)
    (ta @ tb).sum().backward()
    (ja @ jb).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), ja.grad.numpy(), rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), jb.grad.numpy(), rtol=1e-5)


def test_stop_gradient_blocks():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    y = ptt.to_tensor([2.0])
    (x * y).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0])
    assert y.grad is None


def test_detach_cuts_graph():
    x = ptt.to_tensor([3.0], stop_gradient=False)
    y = (x * 2).detach() * x
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])


def test_no_grad_context():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    with ptt.no_grad():
        y = x * 2
    assert y.stop_gradient
    assert y.grad_fn is None  # the reference's y._grad_node


def test_no_grad_decorator():
    @ptt.no_grad()
    def f(t):
        return t * 2

    x = ptt.to_tensor([1.0], stop_gradient=False)
    assert f(x).stop_gradient
    assert ptt.is_grad_enabled()


def test_multi_output_op_grad():
    x_np = np.random.RandomState(1).rand(2, 6).astype(np.float32)
    jx, x = both(x_np, False)
    vals, idx = ptt.topk(x, 3)
    vals.sum().backward()
    jv, _ = pt.topk(jx, 3)
    jv.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy())
    assert idx.stop_gradient  # int output not differentiable


def test_non_scalar_backward_requires_grad_tensor():
    x = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError):
        (x * 2).backward()
    (x * 2).backward(ptt.to_tensor([1.0, 1.0]))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])


def test_backward_frees_graph_unless_retained():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    y = (x * 2).sum()
    y.backward(retain_graph=True)
    y.backward(retain_graph=False)
    np.testing.assert_allclose(x.grad.numpy(), [4.0])
    with pytest.raises(RuntimeError):
        y.backward()  # the graph was freed by the second pass


def test_tensor_register_hook():
    x = ptt.to_tensor([1.0, 1.0], stop_gradient=False)
    calls = []

    def double_hook(g):
        calls.append(type(g))
        return g * 2

    x.register_hook(double_hook)
    (x * 3).sum().backward()
    assert calls == [ptt.Tensor]
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 6.0])


def test_grad_api():
    x = ptt.to_tensor([2.0], stop_gradient=False)
    y = (x * x).sum()
    (gx,) = ptt.grad(y, x)
    np.testing.assert_allclose(gx.numpy(), [4.0])
    assert x.grad is None  # .grad untouched by paddle.grad


def test_grad_allow_unused():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    u = ptt.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError):
        ptt.grad((x * 2).sum(), [x, u])
    gx, gu = ptt.grad((x * 2).sum(), [x, u], allow_unused=True)
    assert gu is None
    np.testing.assert_allclose(gx.numpy(), [2.0])


def test_grad_create_graph():
    """Second order through ``create_graph``, as the reference's replay
    path: d2(x^3)/dx2 = 6x."""
    jx, x = both([2.0], False)
    (g,) = ptt.grad((x ** 3).sum(), x, create_graph=True)
    (g2,) = ptt.grad(g.sum(), x)
    (jg,) = pt.grad((jx ** 3).sum(), jx, create_graph=True)
    (jg2,) = pt.grad(jg.sum(), jx)
    np.testing.assert_allclose(g2.numpy(), jg2.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g2.numpy(), [12.0])


def test_broadcast_grad():
    x = ptt.to_tensor(np.ones((3, 4), np.float32), stop_gradient=False)
    b = ptt.to_tensor(np.ones((4,), np.float32), stop_gradient=False)
    ((x + b) * 2).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), [6.0] * 4)


def test_pylayer():
    import paddle_tpu_torch.autograd as ag

    class Double(ag.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, dy):
            return dy * 2

    x = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    y = Double.apply(x)
    assert type(y) is ptt.Tensor
    np.testing.assert_allclose(y.numpy(), [2.0, 4.0])
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])


def test_pylayer_saved_tensors_kwargs_and_non_tensor_args():
    """``ctx.saved_tensor()``, a keyword argument, a Python scalar among
    the inputs and two outputs, against the JAX package's PyLayer."""
    def make(ag, ops):
        class ScaledExp(ag.PyLayer):
            @staticmethod
            def forward(ctx, x, k, shift=0.0):
                y = ops.exp(x * k + shift)
                ctx.save_for_backward(y)
                ctx.k = k
                return y, y * 2

            @staticmethod
            def backward(ctx, dy, dz):
                (y,) = ctx.saved_tensor()
                return (dy + dz * 2) * y * ctx.k
        return ScaledExp

    x_np = np.array([0.1, 0.5, -0.3], np.float32)
    outs = []
    for pkg in (pt, ptt):
        x = pkg.to_tensor(x_np, stop_gradient=False)
        y, z = make(pkg.autograd, pkg).apply(x, 1.5, shift=0.2)
        (y.sum() + z.sum()).backward()
        outs.append((y.numpy(), x.grad.numpy()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6)


def test_getitem_grad():
    x = ptt.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                      stop_gradient=False)
    x[0].sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [[1, 1, 1], [0, 0, 0]])


def test_check_nan_inf_flag():
    ptt.set_flags({"check_nan_inf": True})
    try:
        x = ptt.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(FloatingPointError):
            ptt.log(x - 1.0) * 1.0  # log(0) = -inf
        assert ptt.get_flags("check_nan_inf") == {"check_nan_inf": True}
    finally:
        ptt.set_flags({"check_nan_inf": False})
    assert float((ptt.log(ptt.to_tensor([1.0]) - 1.0)).numpy()[0]) == \
        -np.inf


def test_set_grad_enabled_and_enable_grad():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    with ptt.no_grad():
        with ptt.enable_grad():
            assert not (x * 2).stop_gradient
        assert (x * 2).stop_gradient
    with ptt.set_grad_enabled(False):
        assert not ptt.is_grad_enabled()
    assert ptt.is_grad_enabled() and torch.is_grad_enabled()
