"""The port's ``PipelineLayer`` and ``PipelineParallel`` against
``paddle_tpu``'s, on the CPU.

Gloo worlds of 2 and 4 ranks (``tests/torch_pp_worker.py``, suites
``pp`` and ``pp4``, started once for the file) run the reference's
pipeline cases on a mesh ``{"pp": n}``, one stage a rank: segmentation
and placement, the sequential forward, 1F1B (v 1) and the interleave
(v 2), ``recompute_interval``, a ``SharedLayerDesc`` across stages,
tuple activations, ``eval_batch`` and the spans. The JAX package's
``fleet.PipelineParallel`` on the same weights, on 2 or 4 of the
conftest's devices, is the oracle at its own tests' tolerances
(tests/test_pipeline.py: losses rtol 1e-4 / atol 1e-6, the sequential
forward rtol 1e-5 / atol 1e-6), and ``last_schedule_stats`` equals its
dict.

Pinned divergences (ROADMAP §3): each rank builds only its own chunks
and ``state_dict()`` holds them (Paddle's per-stage state); a
``SharedLayerDesc`` is one layer a stage, the copies made equal by a
broadcast at build time and their gradients summed over the holders;
another mesh axis above 1 is refused.
"""
import functools

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt

import torch_dist_worker as W
import torch_pp_worker as PW
from test_torch_bridge import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds():
    started = {2: W.Ranks("pp", 2, script=PW.__file__),
               4: W.Ranks("pp4", 4, script=PW.__file__)}
    yield started
    for w in started.values():
        w.close()


def port(worlds, n, case):
    return [r[case] for r in worlds[n].results()]


# -- the reference's side ------------------------------------------------------
class _SplitHead(jnn.Layer):
    def __init__(self, d=8):
        super().__init__()
        self.lin = jnn.Linear(d, d)
        self.aux = jnn.Linear(d, d)

    def forward(self, x):
        return self.lin(x), self.aux(x)


class _DualBlock(jnn.Layer):
    def __init__(self, d=8):
        super().__init__()
        self.a = jnn.Linear(d, d)
        self.b = jnn.Linear(d, d)

    def forward(self, x, aux):
        return (jnn.functional.relu(self.a(x)),
                jnn.functional.relu(self.b(aux)))


class _MergeHead(jnn.Layer):
    def __init__(self, d=8):
        super().__init__()
        self.lin = jnn.Linear(2 * d, d)

    def forward(self, x, aux):
        return self.lin(pt.concat([x, aux], axis=-1))


KINDS = {"Linear": jnn.Linear, "ReLU": jnn.ReLU, "GELU": jnn.GELU,
         "SplitHead": _SplitHead, "DualBlock": _DualBlock,
         "MergeHead": _MergeHead}


def jt(a):
    return pt.to_tensor(np.asarray(a, dtype=np.float32))


def jax_mesh(n):
    # the reference's PipelineLayer reads its stages' devices off a mesh
    # of two axes or more
    return jdist.init_mesh({"dp": 1, "pp": n}, devices=jax.devices()[:n])


def jax_pipeline(spec, seed, n, descs=None, **kw):
    jax_mesh(n)
    pl = jfleet.PipelineLayer(
        descs or [jfleet.LayerDesc(KINDS[i[0]], *i[1:]) for i in spec],
        num_stages=n, loss_fn=jnn.MSELoss(), **kw)
    if spec is not None:
        pl.set_state_dict(PW.stack_state(spec, seed))
    return pl


def jax_train(pl, X, Y, n_micro, steps=PW.PP_STEPS, sgd=False):
    pp = jfleet.PipelineParallel(pl, accumulate_steps=n_micro)
    op = jopt.SGD(learning_rate=0.1, parameters=pp.parameters()) if sgd \
        else jopt.AdamW(learning_rate=0.01, parameters=pp.parameters())
    losses = [float(pp.train_batch((jt(X), jt(Y)), op).numpy())
              for _ in range(steps)]
    return dict(losses=losses, stats=pp.last_schedule_stats,
                state={k: np.asarray(v.numpy())
                       for k, v in pl.state_dict().items()})


@functools.lru_cache(maxsize=None)
def jax_schedules(n):
    X, Y = PW.pp_batch(1)
    out = {v: jax_train(jax_pipeline(PW.deep_spec(), 7, n,
                                     num_virtual_pipeline_stages=v),
                        X, Y, PW.PP_MICRO) for v in (1, 2)}
    out["recompute"] = jax_train(jax_pipeline(PW.deep_spec(), 9, n,
                                              recompute_interval=2), X, Y, 4)
    return out


def _check_run(got_ranks, want):
    for r, got in enumerate(got_ranks):
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   **LOSS_TOL, err_msg=f"rank {r}")
        assert got["stats"] == want["stats"]
        for k, val in got["state"].items():
            np.testing.assert_allclose(val, want["state"][k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {r} {k}")


# -- the tests -------------------------------------------------------------------
@pytest.mark.parametrize("n", WORLDS)
def test_segmentation_and_round_robin_placement(worlds, n):
    """Uniform segmentation as the reference's; chunk c on stage c % n;
    each rank built and holds its own chunk's layers only."""
    want = [len(seg) for seg in jax_pipeline(None, 0, n, descs=[
        jfleet.LayerDesc(KINDS[i[0]], *i[1:])
        for i in PW.descs_spec()])._stage_layers]
    for r, got in enumerate(port(worlds, n, "pipeline_layer")):
        assert list(np.diff(got["bounds"])) == want
        assert got["stage"] == r
        assert got["chunk_stages"] == [c % n for c in range(n)]
        b = got["bounds"]
        assert got["local"] == list(range(b[r], b[r + 1]))
        assert got["keys"] == sorted(
            f"layers.{i}.{p}" for i in got["local"]
            if PW.descs_spec()[i][0] == "Linear" for p in ("bias", "weight"))


@pytest.mark.parametrize("n", WORLDS)
def test_only_local_chunks_are_built(worlds, n):
    """A ready layer placed on another stage is dropped (the reference
    keeps every layer in its one process)."""
    for r, got in enumerate(port(worlds, n, "pipeline_layer")):
        assert got["ready_kept"] == (r == n - 1)
        assert got["mixed_local"] == [2 * r, 2 * r + 1]


@pytest.mark.parametrize("n", WORLDS)
def test_boundary_handshake_is_sent_once_a_shape(worlds, n):
    """A boundary's shapes and dtypes cross once for each micro-batch
    shape (two messages), then its tensors alone; a new batch shape
    takes one more handshake, an old one none."""
    for r, got in enumerate(port(worlds, n, "boundary_handshake")):
        crossings = int(r < n - 1) + int(r > 0)  # activation, cotangent
        tensors = 4 * crossings                  # 4 micro-batches a step
        assert got["sends"] == [tensors + 2 * crossings, tensors,
                                tensors + 2 * crossings, tensors]
        # two batch shapes; each crossing this rank sends or receives
        assert got["keys"] == 2 * 2 * crossings
        assert np.isfinite(got["losses"]).all()


@pytest.mark.parametrize("n", WORLDS)
def test_sequential_forward_matches_the_reference(worlds, n):
    """The chunks one after another; every rank returns the output."""
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    want = np.asarray(jax_pipeline(PW.descs_spec(), 3, n)(jt(x)).numpy())
    for got in port(worlds, n, "pipeline_layer"):
        np.testing.assert_allclose(got["fwd"], want, **FWD_TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("v", [1, 2], ids=["1f1b", "interleave"])
def test_schedules_match_the_reference(worlds, n, v):
    """Losses, ``last_schedule_stats`` and the trained weights of 1F1B
    and the interleave (8 micro-batches, AdamW, 3 steps)."""
    _check_run([res[v] for res in port(worlds, n, "schedules")],
               jax_schedules(n)[v])


@pytest.mark.parametrize("n", WORLDS)
def test_recompute_interval_matches_the_reference(worlds, n):
    _check_run([res["recompute"] for res in port(worlds, n, "schedules")],
               jax_schedules(n)["recompute"])


@pytest.mark.parametrize("n", WORLDS)
def test_shared_layer_desc_across_stages(worlds, n):
    """Divergence: the tied layer is one object a stage. The first
    holder's weights reach the last stage at build time although the
    ranks drew their own; after training both copies equal the
    plain model's one layer, stepped once a batch with the gradients of
    both uses summed. The reference's tied pipeline is no oracle here: it
    commits the layer's parameters to one stage's device and cannot step
    across stages, and its ``parameters()`` lists them at each position,
    so its optimizer steps them twice. The oracle is the JAX package's
    plain model with the layer at both ends, micro-batched as the
    reference's own non-pipelined oracle (tests/test_pipeline.py:74)."""
    rng = np.random.RandomState(5)
    w = (rng.randn(4, 4) * 0.5).astype(np.float32)
    b = (rng.randn(4) * 0.1).astype(np.float32)
    lin = jnn.Linear(4, 4)
    lin.set_state_dict({"weight": w, "bias": b})
    op = jopt.SGD(learning_rate=0.1, parameters=lin.parameters())
    X, Y = PW.pp_batch(6, n=8, d_in=4, d_out=4)
    want = []
    for _ in range(PW.PP_STEPS):
        mb = []
        for k in range(2):
            h = lin(jt(X[4 * k:4 * k + 4]))
            for _ in range(2 * n - 2):
                h = jnn.functional.relu(h)
            loss = jnn.MSELoss()(lin(h), jt(Y[4 * k:4 * k + 4]))
            loss.backward(pt.to_tensor(np.float32(0.5)))
            mb.append(float(loss.numpy()))
        op.step()
        op.clear_grad(set_to_zero=False)
        want.append(np.mean(mb))
    want_state = {"weight": np.asarray(lin.weight.numpy()),
                  "bias": np.asarray(lin.bias.numpy())}
    got = port(worlds, n, "shared_desc")
    last = 2 * n - 1
    np.testing.assert_array_equal(got[0]["built"]["layers.0.weight"],
                                  got[-1]["built"][f"layers.{last}.weight"])
    assert not np.array_equal(got[-1]["drawn"],
                              got[0]["built"]["layers.0.weight"])
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["losses"], want, **LOSS_TOL)
        for k, val in res["state"].items():
            np.testing.assert_allclose(val, want_state[k.split(".")[-1]],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_tuple_activations_match_the_reference(worlds, n):
    """Tuple activations cross stages after the p2p meta handshake
    (reference tests/test_pipeline.py:302), and a tuple model input is
    micro-split per element."""
    rng = np.random.RandomState(4)
    X = rng.randn(8, 8).astype(np.float32)
    Y = rng.randn(8, 8).astype(np.float32)
    spec = PW.dual_spec() if n == 4 else [PW.dual_spec()[0],
                                          PW.dual_spec()[3]]
    want = jax_train(jax_pipeline(spec, 21, n), X, Y, 4, steps=4)
    blocks = [("DualBlock",)] * (n - 1) + [("MergeHead",)]
    pp = jfleet.PipelineParallel(jax_pipeline(blocks, 22, n),
                                 accumulate_steps=2)
    o = jopt.SGD(learning_rate=0.01, parameters=pp.parameters())
    xa, xb, y = (rng.randn(4, 8).astype(np.float32) for _ in range(3))
    tuple_loss = float(pp.train_batch(((jt(xa), jt(xb)), jt(y)), o).numpy())
    for res in port(worlds, n, "tuple_activations"):
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   **LOSS_TOL)
        assert res["stats"] == want["stats"]
        np.testing.assert_allclose(res["tuple_input_loss"], tuple_loss,
                                   **LOSS_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_eval_batch_and_spans(worlds, n):
    """``eval_batch`` gives the reference's loss on every rank; each rank
    records ``pp_fwd``/``pp_bwd`` spans for its own chunks and the last
    stage ``pp_loss`` (reference :590-614)."""
    X, Y = PW.pp_batch(2)
    pp = jfleet.PipelineParallel(jax_pipeline(
        PW.deep_spec(), 5, n, num_virtual_pipeline_stages=2),
        accumulate_steps=4)
    want = float(pp.eval_batch((jt(X), jt(Y))).numpy())
    for r, res in enumerate(port(worlds, n, "eval_and_spans")):
        np.testing.assert_allclose(res["eval"], want, rtol=1e-5)
        chunks = [c for c in range(2 * n) if c % n == r]
        spans = {f"pp_{k}_m{m}_c{c}" for k in ("fwd", "bwd")
                 for m in range(4) for c in chunks}
        if r == n - 1:
            spans |= {f"pp_loss_m{m}" for m in range(4)}
        assert set(res["spans"]) == spans


def test_another_mesh_axis_is_refused(worlds):
    """Divergence: the reference runs each stage on its first device, so
    a dp axis is taken by nothing; the port refuses it."""
    for got in port(worlds, 4, "other_axis_refused"):
        assert got is not None and "'dp': 2" in got


@pytest.mark.parametrize("S,v,M", [(2, 1, 4), (4, 1, 8), (2, 2, 4),
                                   (4, 2, 8), (4, 2, 12), (3, 1, 5)])
def test_schedule_orders_equal_the_reference(S, v, M):
    """The schedules are the reference's pure Python: the same order of
    units and the same accounting (one process holds every stage)."""
    from paddle_tpu_torch.distributed import fleet
    pl = fleet.PipelineLayer(PW.port_descs(PW.deep_spec()), num_stages=S,
                             num_virtual_pipeline_stages=v, device="cpu")
    got = fleet.PipelineParallel(pl)._build_schedule(M)
    jpl = jax_pipeline(None, 0, S, descs=[
        jfleet.LayerDesc(KINDS[i[0]], *i[1:]) for i in PW.deep_spec()],
        num_virtual_pipeline_stages=v)
    assert got == jfleet.PipelineParallel(jpl)._build_schedule(M)


@pytest.mark.parametrize("method", ["layer:Linear", "uniform_params"])
def test_other_segmentations_match_the_reference(method):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    spec = [("Linear", 8, 8), ("ReLU",)] * 8 if method.startswith("layer") \
        else [("Linear", 64, 64)] * 7
    descs = PW.port_descs(spec)
    jdescs = [jfleet.LayerDesc(KINDS[i[0]], *i[1:]) for i in spec]
    if method == "uniform_params":
        descs = [fleet.LayerDesc(nn.Embedding, 1000, 64)] + descs
        jdescs = [jfleet.LayerDesc(jnn.Embedding, 1000, 64)] + jdescs
    pl = fleet.PipelineLayer(descs, num_stages=4, seg_method=method,
                             device="cpu")
    jpl = jax_pipeline(None, 0, 4, descs=jdescs, seg_method=method)
    assert list(np.diff(pl._bounds)) == [len(s) for s in jpl._stage_layers]


def test_entry_points_default_to_cuda_and_raise_without_it():
    """A ``PipelineLayer`` builds its local chunks on the card unless
    given ``device="cpu"`` (or ``set_device("cpu")``); without a ``pp``
    axis one process holds every stage."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    from paddle_tpu_torch.distributed import fleet
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet.PipelineLayer(PW.port_descs(PW.descs_spec()), num_stages=2)
    pl = fleet.PipelineLayer(PW.port_descs(PW.descs_spec()), num_stages=2,
                             device="cpu")
    assert pl.stage_id is None and all(pl.is_local(c) for c in range(2))
    assert {p.device.type for p in pl.parameters()} == {"cpu"}
    with pytest.raises(RuntimeError, match="'pp'"):
        fleet.SpmdPipelineLayer(lambda: None)
