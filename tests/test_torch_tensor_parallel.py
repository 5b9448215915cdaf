"""The port's tensor parallelism against ``paddle_tpu``'s, on the CPU.

Gloo ranks of ``tests/torch_dist_worker.py`` (suite ``tp2``: 2 ranks on
``mp``; suite ``tp4``: 4 ranks on dp 2 x mp 2; both started once for the
file) run the mpu layers, a Megatron MLP, the tiny Llama with
``tensor_parallel=True`` (its untied head through the vocab-parallel
cross entropy, and a tied vocab of 32768 through the fused chunked CE
split over ``mp``) and collectives over a 2-D mesh. The oracle is the
JAX package in this process: its dense layers and its mesh runs on the
conftest's virtual devices, at ``tests/test_tp_layers.py``'s tolerance
(rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import P as JP

import torch_dist_worker as W
from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_distributed import jax_llama_losses, jax_mesh, jax_mse, jt

TP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def worlds():
    two, four = W.Ranks("tp2", 2), W.Ranks("tp4", 4)
    yield {"tp2": two, "tp4": four}
    two.close()
    four.close()


def port(worlds, suite, case, rank=0):
    return worlds[suite].results()[rank][case]


# -- the mpu layers --------------------------------------------------------------
def _dense(x, w, b):
    """y = x @ W + b and the gradients of sum(y^2)."""
    y = x @ w + b
    return y, 2 * y @ w.T, x.T @ (2 * y)


@pytest.mark.parametrize("name", ["col_gather", "col_split", "row"])
def test_parallel_linear_matches_the_dense_layer(worlds, name):
    """Output, input gradient and the weight gradient gathered whole
    equal the dense layer's (tests/test_tp_layers.py:27-72); each rank
    holds its block under the reference's spec."""
    inp = port(worlds, "tp2", "mpu")["inputs"]
    rng = np.random.RandomState(0)
    x16 = rng.randn(4, 16).astype(np.float32)
    x32 = rng.randn(4, 32).astype(np.float32)
    x, w = (x32, inp["w2"]) if name == "row" else (x16, inp["w"])
    y, dx, dw = _dense(x, w["weight"], w["bias"])
    spec = {"col_gather": (None, "mp"), "col_split": (None, "mp"),
            "row": ("mp", None)}[name]
    for r in range(2):
        got = port(worlds, "tp2", "mpu", r)[name]
        want_y = y[:, 16 * r:16 * r + 16] if name == "col_split" else y
        np.testing.assert_allclose(got["y"], want_y, **TP_TOL)
        if name != "col_split":
            np.testing.assert_allclose(got["dx"], dx, **TP_TOL)
            np.testing.assert_allclose(got["dw"], dw, **TP_TOL)
        assert got["spec"] == spec
        assert got["local_shape"] == ((16, 16) if name != "row"
                                      else (16, 16))
        np.testing.assert_array_equal(got["state"]["weight"], w["weight"])
    assert port(worlds, "tp2", "mpu")["no_bias"] is None
    # paddle.distributed.split builds the parallel layers from a call
    assert port(worlds, "tp2", "mpu")["split"] == (
        (4, 32), "ColumnParallelLinear", (2, 3, 16),
        "VocabParallelEmbedding")


def test_reference_parallel_linear_is_its_dense_layer():
    """The oracle above is the reference's own contract: its column
    layer on an mp mesh equals x @ W + b."""
    mesh = jax_mesh({"mp": 2})
    col = jfleet.ColumnParallelLinear(16, 32, has_bias=True, mesh=mesh)
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    np.testing.assert_allclose(col(jt(x)).numpy(), x @ col.weight.numpy()
                               + col.bias.numpy(), **TP_TOL)


def test_vocab_parallel_embedding_matches_the_reference(worlds):
    inp = port(worlds, "tp2", "mpu")["inputs"]
    mesh = jax_mesh({"mp": 2})
    emb = jfleet.VocabParallelEmbedding(64, 16, mesh=mesh)
    emb.set_state_dict(inp["wemb"])
    toks = np.array([[0, 5, 63], [10, 20, 40]], dtype=np.int32)
    want = np.asarray(emb(jt(toks)).numpy())
    dw = np.zeros((64, 16), np.float32)
    np.add.at(dw, toks.reshape(-1), 2 * want.reshape(-1, 16))
    for r in range(2):
        got = port(worlds, "tp2", "mpu", r)["emb"]
        np.testing.assert_allclose(got["y"], want, rtol=1e-5)
        np.testing.assert_allclose(got["dw"], dw, **TP_TOL)


def test_parallel_cross_entropy_matches_the_reference(worlds):
    """Loss (trailing 1 kept) and the logits' gradient on each rank's
    vocab block; an ignored label gives 0 and no gradient."""
    inp = port(worlds, "tp2", "mpu")["inputs"]
    logits, labels = inp["logits"], inp["labels"]
    mesh = jax_mesh({"mp": 2})
    want = np.asarray(jfleet.ParallelCrossEntropy(mesh=mesh)(
        jt(logits), jt(labels.astype(np.int32))).numpy())
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    valid = labels != -100
    p[np.arange(8)[valid], labels[valid]] -= 1
    p[~valid] = 0
    for r in range(2):
        got = port(worlds, "tp2", "mpu", r)["pce"]
        assert got["loss"].shape == (8, 1)
        np.testing.assert_allclose(got["loss"], want, **TP_TOL)
        np.testing.assert_allclose(got["dlogits"], p[:, 32 * r:32 * r + 32],
                                   **TP_TOL)


def test_tp_mlp_training_matches_the_reference(worlds):
    """The Megatron MLP, 10 AdamW steps at mp 2, against the reference's
    TP MLP on its mp mesh (tests/test_tp_layers.py:99-140)."""
    mesh = jax_mesh({"mp": 2})

    class TPMLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.up = jfleet.ColumnParallelLinear(
                16, 64, has_bias=True, gather_output=False, mesh=mesh)
            self.down = jfleet.RowParallelLinear(64, 16,
                                                 input_is_parallel=True,
                                                 mesh=mesh)

        def forward(self, x):
            return self.down(jnn.functional.relu(self.up(x)))
    m = TPMLP()
    w = W.mlp_weights((16, 64, 16), 5)
    m.set_state_dict({"up.weight": w["0.weight"], "up.bias": w["0.bias"],
                      "down.weight": w["2.weight"],
                      "down.bias": w["2.bias"]})
    X, Y = W.regression(32, 16, 16)
    o = pt.optimizer.AdamW(learning_rate=0.01, parameters=m.parameters())
    s = pt.jit.TrainStep(m, jax_mse, o, mesh=mesh)
    want = [float(s(jt(X), jt(Y)).numpy()) for _ in range(10)]
    for r in range(2):
        np.testing.assert_allclose(port(worlds, "tp2", "tp_mlp", r)["losses"],
                                   want, **TP_TOL)


# -- the Llama ---------------------------------------------------------------------
@pytest.mark.parametrize("uneven", [False, True])
def test_llama_mp2_matches_the_reference(worlds, uneven):
    """``LlamaConfig(tensor_parallel=True)`` at mp 2 (untied head, the
    vocab-parallel cross entropy) through fleet.init and
    ``TrainStep(mesh=, bucketed=True)``: losses and global norms of 3
    steps equal the reference's tensor-parallel run on its mp mesh."""
    cfg = dict(W.TINY, tensor_parallel=True)
    batches = W.llama_batches(cfg["vocab_size"], uneven)
    jax_mesh({"mp": 2})
    losses, norms = jax_llama_losses(cfg, batches, mesh=jdist.get_mesh())
    for r in range(2):
        got = port(worlds, "tp2", "llama_mp", r)[f"untied uneven={uneven}"]
        np.testing.assert_allclose(got["losses"], losses, **TP_TOL)
        np.testing.assert_allclose(got["norms"], norms, **TP_TOL)


@pytest.mark.parametrize("uneven", [False, True])
def test_llama_fused_ce_over_a_vocab_split_matches_the_reference(
        worlds, uneven):
    """A tied vocab of 32768 takes the fused chunked CE, each rank over
    its half of the table with the row max, the sum of exponentials and
    the target logit all-reduced: losses and global norms (so the
    gradients) equal the reference's fused CE on one device."""
    cfg = dict(W.TIED_BIG, tensor_parallel=True)
    batches = W.llama_batches(cfg["vocab_size"], uneven)
    losses, norms = jax_llama_losses(dict(cfg, tensor_parallel=False),
                                     batches)
    for r in range(2):
        got = port(worlds, "tp2", "llama_mp", r)[
            f"tied_fused_ce uneven={uneven}"]
        np.testing.assert_allclose(got["losses"], losses, **TP_TOL)
        np.testing.assert_allclose(got["norms"], norms, **TP_TOL)


@pytest.mark.parametrize("uneven", [False, True])
def test_llama_dp2_mp2_matches_the_reference(worlds, uneven):
    """dp 2 x mp 2 on 4 ranks against the reference's run on its
    {"dp": 2, "mp": 2} mesh (GSPMD: one mean over the global batch)."""
    cfg = dict(W.TINY, tensor_parallel=True)
    batches = W.llama_batches(cfg["vocab_size"], uneven)
    jax_mesh({"dp": 2, "mp": 2})
    losses, norms = jax_llama_losses(cfg, batches, mesh=jdist.get_mesh(),
                                     bucketed=False)
    for r in range(4):
        got = port(worlds, "tp4", "llama_dp_mp", r)[f"uneven={uneven}"]
        np.testing.assert_allclose(got["losses"], losses, **TP_TOL)
        np.testing.assert_allclose(got["norms"], norms, **TP_TOL)
        assert got["all_reduces"] == [1] * W.STEPS


def test_tp_llama_keeps_its_block_of_the_one_device_init(worlds):
    """Every rank holds its block (heads, FFN columns, vocab rows) of
    the weights the one-device model of the same seed draws, and the
    bridge gathers them whole; mp must divide the KV heads."""
    want = W.llama_state(W.TINY, seed=4)
    for r in range(2):
        got = port(worlds, "tp2", "llama_mp", r)
        assert got["init"]["local"]["model.layers.0.self_attn.q_proj.weight"] \
            == (64, 32)
        assert got["init"]["local"]["model.layers.0.self_attn.k_proj.weight"] \
            == (64, 16)
        assert got["init"]["local"]["model.embed_tokens.weight"] == (128, 64)
        assert got["init"]["local"]["model.layers.0.mlp.down_proj.weight"] \
            == (64, 64)
        assert sorted(got["init"]["full"]) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(got["init"]["full"][n], want[n],
                                          err_msg=n)
        assert "must divide num_key_value_heads" in got["kv_heads_check"]


def test_collectives_over_a_2d_mesh(worlds):
    """Groups of one axis and of both on a dp 2 x mp 2 mesh, against the
    reference's regions on 4 devices."""
    mesh = jax_mesh({"dp": 2, "mp": 2})
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    f = jdist.spmd(lambda a: jdist.all_reduce(a, group=jdist.Group("mp")),
                   mesh=mesh, in_specs=JP("dp", "mp"),
                   out_specs=JP("dp", "mp"))
    g = jdist.spmd(lambda a: jdist.all_reduce(
        a, group=jdist.Group(("dp", "mp"))), mesh=mesh,
        in_specs=JP(("dp", "mp")), out_specs=JP(("dp", "mp")))
    want_mp = np.asarray(f(jt(x)).numpy())
    want_all = np.asarray(g(jt(np.arange(8, dtype=np.float32))).numpy())
    for r in range(4):
        got = port(worlds, "tp4", "mesh2d", r)
        np.testing.assert_allclose(got["mp_sum"], want_mp)
        np.testing.assert_allclose(got["all_sum"], want_all)
        assert got["coord"] == (r, r // 2, r % 2)
