"""The port's SPMD pipeline against ``paddle_tpu``'s, on the CPU.

Gloo worlds of 2 and 4 ranks (``tests/torch_pp_worker.py``, suite
``spmd``, started once for the file) run ``pipeline_spmd`` (forward,
gradients, pytree boundaries), ``SpmdPipelineParallel``,
``TrainStep(mesh=)`` over an ``SpmdPipelineLayer`` (pp, and at 4 ranks
dp 2 x pp 2), the converters' host <-> SPMD resume and the hetero
pipeline with a tied layer, one stage a rank. The oracles, at the
reference tests' tolerances (tests/test_spmd_pipeline.py): the JAX
package's ``pipeline_spmd`` under ``jax.value_and_grad`` on 2 or 4 of
the conftest's devices (atol 1e-5), its ``TrainStep`` over its
``SpmdPipelineLayer``, its host-scheduled ``PipelineParallel`` over the
same chunk weights for ``SpmdPipelineParallel``'s trajectory (the
reference holds its two engines equal, :265; its SPMD engine traces
anew at every step, ~14 s a step here), its converters, and its eager
sequential stack for the hetero pipeline (as the reference's own test,
:428).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import P as JP
from paddle_tpu.distributed.auto_parallel import converter as jconv

import torch_dist_worker as W
import torch_pp_worker as PW
from test_torch_bridge import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds():
    started = {n: W.Ranks("spmd", n, script=PW.__file__) for n in WORLDS}
    yield started
    for w in started.values():
        w.close()


def port(worlds, n, case):
    return [r[case] for r in worlds[n].results()]


def jt(a):
    return pt.to_tensor(np.asarray(a, dtype=np.float32))


def _jbody(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


@functools.lru_cache(maxsize=None)
def jax_spmd_grad(n):
    """The reference's output and gradients of ``mean(out**2)`` for the
    worker's ``case_spmd_grad`` (S = n, v 2, M 4)."""
    mesh = jdist.init_mesh({"pp": n}, devices=jax.devices()[:n])
    v = 2
    Ws, bs = PW.spmd_params(v, n, 3)
    xs = jnp.asarray(np.random.RandomState(3).randn(4, 2, 8).astype(
        np.float32))

    def loss(W_, b_, x):
        out = jfleet.pipeline_spmd(_jbody, {"W": W_, "b": b_}, x, mesh=mesh,
                                   num_virtual_stages=v)
        return (out ** 2).mean(), out
    (_, out), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(Ws.reshape(v, n, 8, 8)), jnp.asarray(bs.reshape(v, n, 8)),
        xs)
    return [np.asarray(a) for a in (out, *g)]


@pytest.mark.parametrize("n", WORLDS)
def test_forward_matches_the_sequential_chunks(worlds, n):
    """Any micro-count, any virtual depth (reference :30): the pipelined
    result equals the chunks run in order."""
    for v, M in PW.SPMD_FWD:
        Ws, bs = PW.spmd_params(v, n, v * 10 + M)
        xs = np.random.RandomState(M).randn(M, 2, 8).astype(np.float32)
        want = PW.sequential_np(xs, Ws, bs)
        for got in port(worlds, n, "spmd_forward"):
            np.testing.assert_allclose(got[(v, M)], want, atol=1e-5,
                                       err_msg=f"v={v} M={M}")


@pytest.mark.parametrize("n", WORLDS)
def test_forward_and_gradients_match_the_reference(worlds, n):
    """The output and the gradients of the stacked parameters (each
    stage's slice, zero elsewhere) and of the inputs (summed over pp)
    equal the reference's ``jax.grad`` through its scan (:48)."""
    out, dW, db, dx = jax_spmd_grad(n)
    for r, got in enumerate(port(worlds, n, "spmd_grad")):
        np.testing.assert_allclose(got["out"], out, atol=1e-5)
        np.testing.assert_allclose(got["dW"], dW[:, r], atol=1e-5)
        np.testing.assert_allclose(got["db"], db[:, r], atol=1e-5)
        np.testing.assert_allclose(got["dx"], dx, atol=1e-5)
        assert got["others_zero"]


@pytest.mark.parametrize("n", WORLDS)
def test_pytree_boundary_activations(worlds, n):
    """A tuple rides the ring (reference :84)."""
    Ws, _ = PW.spmd_params(1, n, 5)
    xs = np.random.RandomState(5).randn(4, 2, 8).astype(np.float32)
    ref, ra = xs, np.zeros((4, 2), np.float32)
    for c in range(n):
        ref = np.tanh(ref @ Ws[c])
        ra = ra + ref.sum(-1)
    for got in port(worlds, n, "spmd_pytree"):
        np.testing.assert_allclose(got["out"], ref, atol=1e-5)
        np.testing.assert_allclose(got["aux"], ra, atol=1e-4)


@pytest.mark.parametrize("S,v,M", [(4, 2, 4), (4, 1, 4), (2, 3, 6),
                                   (4, 4, 8), (3, 2, 5)])
def test_schedule_stats_equal_the_reference(S, v, M):
    from paddle_tpu_torch.distributed import fleet
    assert fleet.spmd_schedule_stats(S, v, M) == \
        jfleet.spmd_schedule_stats(S, v, M)


def _jax_host_engine(n, v, state):
    """The reference's host-scheduled engine over the chunk weights of a
    stacked ``SpmdPipelineLayer`` state, chunk c = r*S + s."""
    jdist.init_mesh({"dp": 1, "pp": n}, devices=jax.devices()[:n])
    layers = []
    for c in range(n * v):
        r, s = divmod(c, n)
        lin = jnn.Linear(8, 8)
        lin.set_state_dict({"weight": state["0__weight"][r, s],
                            "bias": state["0__bias"][r, s]})
        layers += [lin, jnn.Tanh()]
    pl = jfleet.PipelineLayer(layers, num_stages=n,
                              num_virtual_pipeline_stages=v,
                              loss_fn=jnn.MSELoss())
    return pl, layers


@pytest.mark.parametrize("n", WORLDS)
def test_engine_trains_as_the_reference(worlds, n):
    """``SpmdPipelineParallel`` (v 2, 4 micro-batches, AdamW, 5 steps):
    losses, trained weights and ``eval_batch`` equal the reference's
    host engine on the same chunks; the stats are the reference's
    analytic ones; ``state_dict()`` gives the full ``[v, S, ...]``
    tensors on every rank while each holds ``[v, 1, ...]``."""
    v = 2
    pl, layers = _jax_host_engine(n, v, PW.spmd_layer_state(v, n, 0))
    eng = jfleet.PipelineParallel(pl, accumulate_steps=4)
    o = jopt.AdamW(learning_rate=3e-3, parameters=eng.parameters())
    rng = np.random.RandomState(0)
    X = rng.randn(8, 8).astype(np.float32)
    Y = (rng.randn(8, 8) * 0.1).astype(np.float32)
    want = [float(eng.train_batch((jt(X), jt(Y)), o).numpy())
            for _ in range(5)]
    want_eval = float(eng.eval_batch((jt(X), jt(Y))).numpy())
    W_ = np.stack([np.asarray(layers[2 * c].weight.numpy())
                   for c in range(n * v)]).reshape(v, n, 8, 8)
    for r, got in enumerate(port(worlds, n, "spmd_engine")):
        np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)
        np.testing.assert_allclose(got["eval"], want_eval, rtol=1e-4)
        assert got["stats"] == jfleet.spmd_schedule_stats(n, v, 4)
        assert got["state"]["0__weight"].shape == (v, n, 8, 8)
        np.testing.assert_allclose(got["state"]["0__weight"], W_, rtol=1e-4,
                                   atol=1e-5)
        assert got["local"] == {"0__weight": (v, 1, 8, 8),
                                "0__bias": (v, 1, 8)}


@pytest.mark.parametrize("n", WORLDS)
def test_each_stage_keeps_only_its_chunks(worlds, n):
    """Built one chunk at a time, a stage keeps its own chunks' values
    (those of every chunk built in order under the same seed) and, for
    the templates, their structure on the meta device; the hetero
    layer holds no block of another stage."""
    v = 4 // n
    for s, got in enumerate(port(worlds, n, "spmd_build")):
        for k, full in got["whole"].items():
            want = full.reshape((2, n) + full.shape[1:])[:, s:s + 1]
            np.testing.assert_array_equal(got["local"][k], want)
        assert got["template"] == ["meta"]
        own = {r * n + s for r in range(v)}
        assert [c for c, b in enumerate(got["blocks"]) if b is not None] \
            == sorted(own)
        assert all(b == ["meta"] for b in got["blocks"] if b is not None)
        for r, flat in enumerate(got["own_flat"]):
            np.testing.assert_array_equal(got["trunk"][r, 0, :flat.size],
                                          flat)
            assert not got["trunk"][r, 0, flat.size:].any()


@functools.lru_cache(maxsize=None)
def jax_train_step(name, n):
    shape, v, spec = {"pp": ({"pp": n}, 1, None),
                      "dp_pp": ({"dp": 2, "pp": 2}, 2, JP(None, "dp"))}[name]
    mesh = jdist.init_mesh(shape, devices=jax.devices()[:n])
    pl = jfleet.SpmdPipelineLayer(lambda: jnn.Sequential(
        jnn.Linear(8, 8), jnn.Tanh()), num_virtual_stages=v, mesh=mesh)
    pl.set_state_dict(PW.spmd_layer_state(v, shape["pp"], 2))
    o = jopt.AdamW(learning_rate=1e-3, parameters=pl.parameters())
    mse = jnn.MSELoss()

    def loss_fn(m, x, y):
        return mse(pt.reshape(m(x), [-1, 8]), pt.reshape(y, [-1, 8]))
    step = pt.jit.TrainStep(pl, loss_fn, o, mesh=mesh,
                            **({} if spec is None else {"input_spec": spec}))
    rng = np.random.RandomState(2)
    Xm = rng.randn(4, 4, 8).astype(np.float32)
    Ym = rng.randn(4, 4, 8).astype(np.float32)
    return [float(step(jt(Xm), jt(Ym)).numpy()) for _ in range(3)]


@pytest.mark.parametrize("n,name", [(2, "pp"), (4, "pp"), (4, "dp_pp")])
def test_train_step_over_the_mesh_matches_the_reference(worlds, n, name):
    """``TrainStep(mesh=)`` over an ``SpmdPipelineLayer``: the stacked
    parameters split on pp are reduced over no axis but the batch's;
    at dp 2 x pp 2 the micro-batches split over dp (reference :175,
    :245)."""
    want = jax_train_step(name, n)
    for got in port(worlds, n, "spmd_train_step"):
        np.testing.assert_allclose(got[name], want, **LOSS_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_host_and_spmd_engines_resume_each_other(worlds, n):
    """Train 2 steps, convert the state, resume 2 on the other engine:
    the uninterrupted trajectory (reference :329-363, rtol 5e-4)."""
    for got in port(worlds, n, "converter_resume"):
        for a in ("s", "h"):
            np.testing.assert_allclose(got[f"{a}_part"], got[f"{a}_full"][:2],
                                       rtol=1e-6)
            np.testing.assert_allclose(got[f"{a}_resumed"],
                                       got[f"{a}_full"][2:], rtol=5e-4)


def test_converters_match_the_reference():
    """The converters are the reference's numpy code: the same keys and
    arrays both ways, parameter-less layers too (reference :619)."""
    from paddle_tpu_torch.distributed import auto_parallel as ap
    state = PW.spmd_layer_state(2, 4, 7)
    want = jconv.spmd_state_to_pipeline(state, 4, 2,
                                        block_is_container=False)
    got = ap.spmd_state_to_pipeline(state, 4, 2, block_is_container=False)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = ap.pipeline_state_to_spmd(got, 4, 2, block_is_container=False)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    holes = {f"{i}.weight": np.full((4, 4), i, np.float32)
             for i in range(0, 8, 2)}
    a = ap.pipeline_state_to_spmd(holes, 4, 1, prefix="")
    b = jconv.pipeline_state_to_spmd(holes, 4, 1, prefix="")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="lead with"):
        ap.spmd_state_to_pipeline({k: np.zeros((3, 3)) for k in state}, 4, 2)


class _JSharedUser(jnn.Layer):
    def __init__(self, d=8):
        super().__init__()
        self.fc = jnn.Linear(d, d)

    def forward(self, x, shared):
        return pt.tanh(self.fc(shared(x)))


class _JPlain(jnn.Layer):
    def __init__(self, d=8):
        super().__init__()
        self.fc = jnn.Linear(d, d)

    def forward(self, x):
        return pt.tanh(self.fc(x))


@pytest.mark.parametrize("n", WORLDS)
def test_hetero_pipeline_with_a_tied_layer(worlds, n):
    """[tied user, plain, plain, tied user] over S x v = 4 chunks: each
    chunk's state is the reference layer's; the loss, every chunk's
    gradient and the tied layer's (the sum of both uses, over pp) and
    two SGD steps equal the reference's eager stack (:428-489)."""
    v = 4 // n
    state = PW.hetero_state(v, n, 33)
    jdist.init_mesh({"pp": n}, devices=jax.devices()[:n])
    jhl = jfleet.SpmdHeteroPipelineLayer(
        [_JSharedUser, _JPlain, _JPlain, _JSharedUser],
        num_virtual_stages=v, shared_factory=lambda: jnn.Linear(8, 8))
    jhl.set_state_dict(state)
    chunks = [jhl.chunk_state_dict(c) for c in range(4)]
    blocks = [_JSharedUser(), _JPlain(), _JPlain(), _JSharedUser()]
    for blk, st in zip(blocks, chunks):
        blk.set_state_dict({k: jt(a) for k, a in st.items()})
    shared = jnn.Linear(8, 8)
    shared.set_state_dict({"weight": state["shared.weight"],
                           "bias": state["shared.bias"]})
    params = [p for b in blocks for p in b.parameters()] + \
        list(shared.parameters())
    o = jopt.SGD(learning_rate=0.05, parameters=params)
    rng = np.random.RandomState(33)
    losses = []
    for step in range(2):
        X = rng.randn(4, 2, 8).astype(np.float32)
        h = jt(X.reshape(8, 8))
        for blk in blocks:
            h = blk(h, shared) if isinstance(blk, _JSharedUser) else blk(h)
        loss = (h * h).mean()
        loss.backward()
        if step == 0:
            trunk = np.concatenate([np.concatenate(
                [np.asarray(blk.fc.weight.grad.numpy()).reshape(-1),
                 np.asarray(blk.fc.bias.grad.numpy())]) for blk in blocks])
            grads = dict(trunk=trunk.reshape(v, n, -1),
                         shared_w=np.asarray(shared.weight.grad.numpy()),
                         shared_b=np.asarray(shared.bias.grad.numpy()))
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    for r, got in enumerate(port(worlds, n, "hetero_tied")):
        for c in range(4):
            for k, a in chunks[c].items():
                np.testing.assert_array_equal(got["chunks"][c][k], a)
        np.testing.assert_allclose(got["losses"], losses, rtol=5e-4)
        np.testing.assert_allclose(got["trunk"][:, 0],
                                   grads["trunk"][:, r], atol=1e-5)
        np.testing.assert_allclose(got["shared_w"], grads["shared_w"],
                                   atol=1e-5)
        np.testing.assert_allclose(got["shared_b"], grads["shared_b"],
                                   atol=1e-5)
