"""``paddle.static`` on the port against the JAX package, on the CPU in
float32: the Program/Executor workflow (``static/graph.py``: a recorded
program replayed on each run, with ``minimize``'s optimizer stepping on
the replayed loss's gradients), ``static.nn``'s builders, and its
control flow with the cases of the reference's
``tests/test_control_flow.py`` and ``tests/test_static_enforce.py``.

Weights cross through numpy: a builder's layer is made in both packages
and the port's takes the reference's weights. Values at the layers'
tolerance (rtol 1e-4, atol 1e-5), gradients at twice it."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu import static as jstatic
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import static
from paddle_tpu_torch.static import nn as snn
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax
from torch_api_common import on_cpu  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def static_mode():
    pt.enable_static()
    ptt.enable_static()
    yield
    pt.disable_static()
    ptt.disable_static()


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _bridge(jlayer, tlayer):
    load_numpy_state(tlayer, state_dict_from_jax(jlayer))


def t(x, sg=True):
    return ptt.to_tensor(np.asarray(x, np.float32), stop_gradient=sg)


def j(x, sg=True):
    return pt.to_tensor(np.asarray(x, np.float32), stop_gradient=sg)


# ------------------------------ Program/Executor -----------------------------
def _regression(mod, st):
    """``examples/static_regression.py``'s program in one package."""
    prog = st.Program()
    with st.program_guard(prog):
        x = st.data("x", [None, 13], "float32")
        y = st.data("y", [None, 1], "float32")
        pred = st.nn.fc(x, size=1)
        loss = mod.ops.mean(mod.ops.square(mod.ops.subtract(pred, y)))
        opt = mod.optimizer.SGD(learning_rate=0.1)
        opt.minimize(loss)
    return prog, loss, pred._static_layer, opt


def test_static_regression_loss_curve_equals_the_references(static_mode):
    """The example's workflow: data → fc → loss → minimize → 30 runs on
    the same feeds; the losses and the trained weights equal the
    reference's, and minimize collected the fc's two parameters."""
    jprog, jloss, jlayer, _ = _regression(pt, jstatic)
    tprog, tloss, tlayer, topt = _regression(ptt, static)
    _bridge(jlayer, tlayer)
    assert [id(p) for p in topt._parameter_list] == \
        [id(tlayer.weight), id(tlayer.bias)]
    rng = np.random.RandomState(0)
    w_true = rng.randn(13, 1).astype(np.float32)
    jexe, texe = jstatic.Executor(), static.Executor()
    assert texe.run(static.default_startup_program()) == []
    jl, tl = [], []
    for _ in range(30):
        xb = rng.randn(64, 13).astype(np.float32)
        feed = {"x": xb, "y": xb @ w_true}
        jl.append(float(jexe.run(jprog, feed=feed, fetch_list=[jloss])[0]))
        tl.append(float(texe.run(tprog, feed=feed, fetch_list=[tloss])[0]))
    np.testing.assert_allclose(tl, jl, **FWD)
    assert tl[-1] < tl[0] * 1e-3
    np.testing.assert_allclose(tlayer.weight.detach().numpy(),
                               _np(jlayer.weight), **GRAD)


def test_fetch_without_optimizer_and_missing_feed(static_mode):
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data(name="x", shape=[None, 4], dtype="float32")
        out = ptt.ops.sum(ptt.ops.multiply(x, x))
    exe = static.Executor()
    for b in (2, 5):
        xv = np.arange(4 * b, dtype=np.float32).reshape(b, 4)
        (got,) = exe.run(prog, feed={"x": xv}, fetch_list=[out])
        np.testing.assert_allclose(got, (xv * xv).sum(), rtol=1e-6)
    (got,) = exe.run(prog, feed={"x": np.ones((1, 4), np.float32)},
                     fetch_list=[out], return_numpy=False)
    assert type(got) is ptt.Tensor and float(got) == 4.0
    with pytest.raises(ValueError, match="missing feed"):
        exe.run(prog, feed={}, fetch_list=[out])
    outside = ptt.ops.sum(x * 2)
    with pytest.raises(ValueError, match="outside this program"):
        exe.run(prog, feed={"x": np.ones((1, 4), np.float32)},
                fetch_list=[outside])


def test_mode_toggles():
    assert ptt.in_dynamic_mode()
    ptt.enable_static()
    assert not ptt.in_dynamic_mode()
    ptt.disable_static()
    assert ptt.in_dynamic_mode()
    with pytest.raises(ValueError, match="dygraph"):
        ptt.optimizer.SGD(learning_rate=0.1)


def _builder_program(mod, st, builder):
    prog = st.Program()
    with st.program_guard(prog):
        if builder == "fc":
            x = st.data("x", [None, 3, 4], "float32")
            out = st.nn.fc(x, size=5, num_flatten_dims=1,
                           activation="relu")
        elif builder == "embedding":
            x = st.data("x", [None, 6], "int64")
            out = st.nn.embedding(x, size=(20, 8))
        else:
            x = st.data("x", [None, 3, 4, 4], "float32")
            out = st.nn.batch_norm(x)
    return prog, out


@pytest.mark.parametrize("builder", ["fc", "embedding", "batch_norm"])
def test_builders_replay_at_any_batch(builder, static_mode):
    """Each builder inside a program, its layer given the reference's
    weights after the build, replayed at two batch sizes: the reference
    program's fetches."""
    jprog, jout = _builder_program(pt, jstatic, builder)
    tprog, tout = _builder_program(ptt, static, builder)
    _bridge(jout._static_layer, tout._static_layer)
    rng = np.random.RandomState(3)
    for b in (2, 7):
        shape = {"fc": (b, 3, 4), "embedding": (b, 6),
                 "batch_norm": (b, 3, 4, 4)}[builder]
        xv = rng.randint(0, 20, shape) if builder == "embedding" else \
            rng.randn(*shape).astype(np.float32)
        ref = jstatic.Executor().run(jprog, feed={"x": xv},
                                     fetch_list=[jout])[0]
        got = static.Executor().run(tprog, feed={"x": xv},
                                    fetch_list=[tout])[0]
        np.testing.assert_allclose(got, np.asarray(ref), **FWD)


def test_cond_with_operands_replays_on_the_fed_value(static_mode):
    """``cond`` with operands is one node of the program: each run takes
    the branch of its own feed. (The reference's program records no
    comparison op, so its predicate keeps the build-time value: a
    reference caveat, ROADMAP §3; the expected values here are numpy's.)"""
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [None], "float32")
        y = snn.cond(ptt.ops.sum(x) > 0, lambda a: a * 2,
                     lambda a: a - 1, operands=(x,))
    for xv in ([1.0, 2.0], [-1.0, -2.0, 0.5]):
        xv = np.asarray(xv, np.float32)
        (got,) = static.Executor().run(prog, feed={"x": xv},
                                       fetch_list=[y])
        np.testing.assert_allclose(got, xv * 2 if xv.sum() > 0 else xv - 1)


def test_while_loop_replays_on_the_fed_value(static_mode):
    """A Newton iteration as one program node: each run converges on its
    own feed."""
    prog = static.Program()
    with static.program_guard(prog), ptt.no_grad():
        v = static.data("v", [1], "float32")
        (root,) = snn.while_loop(
            lambda y, a: ptt.ops.abs(y * y - a).sum() > 1e-6,
            lambda y, a: [(y + a / y) / 2.0, a], [ptt.ops.ones_like(v), v]
        )[:1]
    for a in (2.0, 9.0):
        (got,) = static.Executor().run(
            prog, feed={"v": np.asarray([a], np.float32)}, fetch_list=[root])
        np.testing.assert_allclose(got, [np.sqrt(a)], rtol=1e-5)


# --------------------------------- cond --------------------------------------
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_closure_runs_the_taken_branch(sign):
    xs = [1.0, 2.0]
    ref = jstatic.nn.cond(j(np.float32(sign)) > 0, lambda: j(xs) * 2,
                          lambda: j(xs) * 3)
    got = snn.cond(t(np.float32(sign)) > 0, lambda: t(xs) * 2,
                   lambda: t(xs) * 3)
    np.testing.assert_allclose(_np(got), _np(ref))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_operands_differentiate_as_the_reference(sign):
    grads = []
    for mk, nn_ in ((j, jstatic.nn), (t, snn)):
        x = mk([1.0, 2.0], sg=False)
        out = nn_.cond(mk(np.float32(sign)) > 0, lambda a: a * a * 2,
                       lambda a: a * 3, operands=(x,))
        out.sum().backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **GRAD)


def test_cond_dict_outputs_and_refusals():
    x = t([1.0, 2.0], sg=False)
    out = snn.cond(t(np.float32(1.0)) > 0,
                   lambda a: {"y": a * 2, "z": (a + 1, a - 1)},
                   lambda a: {"y": a * 3, "z": (a, a)}, operands=(x,))
    np.testing.assert_allclose(_np(out["y"]), [2.0, 4.0])
    np.testing.assert_allclose(_np(out["z"][0]), [2.0, 3.0])
    out["y"].sum().backward()
    np.testing.assert_allclose(_np(x.grad), [2.0, 2.0])
    ran = []
    assert snn.cond(t(np.float32(-1.0)) > 0,
                    lambda: ran.append(1) or x * 2) is None and not ran
    with pytest.raises(ValueError, match="BOTH branches"):
        snn.cond(t(np.float32(1.0)) > 0, lambda a: a, operands=(t([1.0]),))
    with pytest.raises(ValueError, match="different structures"):
        snn.cond(t(np.float32(1.0)) > 0, lambda a: {"x": a * 2},
                 lambda a: {"y": a * 3}, operands=(t([1.0], sg=False),))


# ------------------------------- while_loop ----------------------------------
def test_while_loop_newton_equals_the_reference():
    def run(mod, nn_, mk):
        def cond_fn(i, y):
            err = mod.ops.abs(y * y - 2.0)
            return mod.ops.logical_and(err > 1e-6, i < 50)
        i0 = mod.to_tensor(np.int32(0))
        return nn_.while_loop(cond_fn, lambda i, y: (i + 1, (y + 2.0 / y)
                                                     / 2.0),
                              [i0, mk(np.float32(1.0))])
    (ji, jy), (ti, ty) = run(pt, jstatic.nn, j), run(ptt, snn, t)
    assert int(_np(ti)) == int(_np(ji)) < 50
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-6)
    assert abs(float(_np(ty)) - np.sqrt(2.0)) < 1e-5


def test_while_loop_is_forward_only():
    with pytest.raises(ValueError, match="forward-only"):
        snn.while_loop(lambda y: y < 10, lambda y: y * 2,
                       [t(np.float32(1.0), sg=False)])
    fc = tnn.Linear(2, 2)
    with pytest.raises(ValueError, match="forward-only"):
        snn.while_loop(lambda y: y.sum() < 10, lambda y: fc(y),
                       [t([1.0, 1.0])])
    step = lambda h: fc(h)  # noqa: E731
    with pytest.raises(ValueError, match="forward-only"):
        snn.while_loop(lambda h: ptt.ops.max(ptt.ops.abs(h)) < 10.0,
                       lambda h: step(h), [t(np.zeros((1, 2)))])
    with ptt.no_grad():
        (y,) = snn.while_loop(lambda y: y < 10.0, lambda y: y * 2.0,
                              [t(np.float32(1.0), sg=False)])
    assert float(_np(y)) == 16.0


def test_loop_until_converged_layer_equals_the_reference():
    """``tests/test_control_flow.py``'s IterNorm: a layer whose forward
    halves a detached activation until max |x| <= 1."""
    def forward(mod, nn_, fc, x):
        h = fc(x)
        return nn_.while_loop(
            lambda v: mod.ops.max(mod.ops.abs(v)) > 1.0,
            lambda v: v / 2.0, [h.detach()])[0]
    pt.seed(0)
    jfc, tfc = jnn.Linear(4, 4), tnn.Linear(4, 4)
    _bridge(jfc, tfc)
    x = np.array([[8.0, 1.0, -16.0, 0.5]] * 2, np.float32)
    ref = forward(pt, jstatic.nn, jfc, j(x))
    got = forward(ptt, snn, tfc, t(x))
    np.testing.assert_allclose(_np(got), _np(ref), **FWD)
    assert np.abs(_np(got)).max() <= 1.0


# --------------------------- bounded_while_loop ------------------------------
def _newton(mod, nn_, mk):
    a = mk(np.float32(2.0), sg=False)
    x = mk(np.float32(1.5), sg=False)
    (out,) = nn_.bounded_while_loop(
        lambda xv: mod.abs(xv * xv - a) > 1e-4,
        lambda xv: xv - (xv * xv - a) / (2.0 * xv), [x], max_iters=25)
    out.backward()
    return float(_np(out)), float(_np(a.grad)), float(_np(x.grad))


def test_bounded_newton_gradients_equal_the_references():
    ref = _newton(pt, jstatic.nn, j)
    got = _newton(ptt, snn, t)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], 1 / (2 * np.sqrt(2.0)), rtol=1e-3)


def _fixed_point(mod, nn_, mk, lin, x, max_iters):
    """Iterate ``h = h/2 + tanh(lin(h) + x)/2`` until the update is below
    1e-3 (closures over ``lin``, as the reference's collector finds)."""
    def step(h):
        return 0.5 * h + 0.5 * mod.tanh(lin(h) + x)

    def body(h, d):
        h2 = step(h)
        return [h2, mod.max(mod.abs(h2 - h))]

    def cond_fn(h, d):
        return d > 1e-3
    return nn_.bounded_while_loop(cond_fn, body,
                                  [mod.zeros_like(x), mk(np.float32(1.0))],
                                  max_iters=max_iters)[0]


def test_bounded_gradients_through_a_layer_equal_the_references():
    """Parameter gradients through the loop (a layer the closures
    capture) equal the reference's on the same weights."""
    pt.seed(3)
    jlin, tlin = jnn.Linear(4, 4), tnn.Linear(4, 4)
    _bridge(jlin, tlin)
    X = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    grads = []
    for mod, nn_, mk, lin in ((pt, jstatic.nn, j, jlin),
                              (ptt, snn, t, tlin)):
        _fixed_point(mod, nn_, mk, lin, mk(X), 50).mean().backward()
        grads.append(_np(lin.weight.grad))
    assert np.abs(grads[1]).max() > 0
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-6)


def test_bounded_loop_trains_a_fixed_point_block():
    """A deep-equilibrium-style block trained through the loop: the first
    losses equal the reference's on the same weights, and the port's fall
    by half over 25 Adam steps."""
    rng = np.random.RandomState(0)
    X = rng.randn(8, 4).astype(np.float32)
    Y = (rng.randn(8, 4) * 0.3).astype(np.float32)
    pt.seed(0)
    jlin, tlin = jnn.Linear(4, 4), tnn.Linear(4, 4)
    _bridge(jlin, tlin)
    curves = []
    for mod, nn_, mk, lin, steps in ((pt, jstatic.nn, j, jlin, 3),
                                     (ptt, snn, t, tlin, 25)):
        o = mod.optimizer.Adam(learning_rate=3e-2,
                               parameters=lin.parameters())
        x, y = mk(X), mk(Y)
        losses = []
        for _ in range(steps):
            loss = mod.nn.MSELoss()(_fixed_point(mod, nn_, mk, lin, x, 40),
                                    y)
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(_np(loss)))
        curves.append(losses)
    np.testing.assert_allclose(curves[1][:3], curves[0], rtol=1e-4)
    assert curves[1][-1] < curves[1][0] * 0.5, curves[1][::8]


def test_bounded_loop_edges():
    (out,) = snn.bounded_while_loop(lambda i: i < 1e9, lambda i: i + 1.0,
                                    [t(np.float32(0.0))], max_iters=7)
    assert float(_np(out)) == 7.0
    x = t(np.float32(3.0))
    assert snn.bounded_while_loop(lambda v: v > 0, lambda v: v - 1, [x],
                                  max_iters=0)[0] is x
    with pytest.raises(ValueError, match="loop vars"):
        snn.bounded_while_loop(lambda h: h < 5, lambda h: [h + 1, h],
                               [t(np.float32(0.0))], max_iters=3)
    ptt.seed(5)
    blocks = [tnn.Linear(4, 4), tnn.Linear(4, 4)]
    xv = t(np.random.RandomState(0).randn(2, 4))

    def body(h, d):
        h2 = 0.5 * h + 0.5 * ptt.tanh(blocks[1](blocks[0](h)) + xv)
        return [h2, ptt.max(ptt.abs(h2 - h))]
    h, _ = snn.bounded_while_loop(lambda h, d: d > 1e-3, body,
                                  [ptt.zeros_like(xv), t(np.float32(1.0))],
                                  max_iters=40)
    h.mean().backward()
    for b in blocks:  # layers held in a list receive gradients
        assert np.abs(_np(b.weight.grad)).max() > 0


# ----------------------------- case / switch_case ----------------------------
@pytest.mark.parametrize("preds,want", [((0.0, 1.0), 20.0),
                                        ((1.0, 1.0), 10.0),
                                        ((0.0, 0.0), 30.0)])
def test_case_first_true_wins(preds, want):
    for mk, nn_ in ((j, jstatic.nn), (t, snn)):
        x = mk([1.0])
        out = nn_.case([(mk(np.float32(preds[0])) > 0, lambda: x * 10),
                        (mk(np.float32(preds[1])) > 0, lambda: x * 20)],
                       default=lambda: x * 30)
        np.testing.assert_allclose(_np(out), [want])
    out = snn.case([(t(np.float32(0.0)) > 0, lambda: t([1.0]))],
                   default=None)
    np.testing.assert_allclose(_np(out), [1.0])


@pytest.mark.parametrize("index,want", [(2, 20.0), (1, 10.0), (7, -1.0)])
def test_switch_case(index, want):
    for mod, nn_ in ((pt, jstatic.nn), (ptt, snn)):
        x = mod.to_tensor(np.asarray([1.0], np.float32))
        out = nn_.switch_case(mod.to_tensor(np.int32(index)),
                              {1: lambda: x * 10, 2: lambda: x * 20},
                              default=lambda: -x)
        np.testing.assert_allclose(_np(out), [want])
    fns = [lambda i=i: t(np.float32(i)) * 2.0 for i in range(10)]
    assert float(_np(snn.switch_case(t(np.float32(4)).astype("int32"),
                                     fns))) == 8.0
    assert float(_np(snn.switch_case(99, fns))) == 18.0
