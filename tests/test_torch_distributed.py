"""The port's ``paddle.distributed`` against ``paddle_tpu``'s, on the CPU.

Two gloo ranks (``tests/torch_dist_worker.py``, suite ``dist``, started
once for the file) run the collectives, placements, topology, the object
collectives, ``compat``, data parallelism, the three ZeRO levels and the
Llama ``TrainStep`` at dp 2; the JAX package is the oracle in this
process, on 2 of the conftest's 8 virtual devices, at its own tests'
tolerances (``tests/test_distributed.py`` and ``tests/test_zero.py``).

Pinned divergences (ROADMAP §3): a collective outside ``spmd`` runs
across the processes (the reference raises); the world size counts
processes (the reference counts devices); the bucket size is an
argument, and the reference's variables are not read; the modules later
slices port are not exported; and the data-parallel loss is one mean
over the global batch's valid tokens, which is the reference's GSPMD
step (its bucketed shard_map step averages per-rank means).
"""
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import P as JP
from paddle_tpu.jit import bucketing as jbucketing
from paddle_tpu.models.llama import LlamaConfig as JaxCfg
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM

import torch_dist_worker as W
from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import undrawn_jax_init

# tests/test_distributed.py:217 and tests/test_zero.py:71
DP_TOL = dict(rtol=2e-4, atol=1e-6)
ZERO_TOL = dict(rtol=3e-4, atol=1e-6)


@pytest.fixture(scope="module")
def ranks():
    world = W.Ranks("dist", 2)
    yield world
    world.close()


def port(ranks, case, rank=0):
    return ranks.results()[rank][case]


def jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return jdist.init_mesh(shape, devices=jax.devices()[:n])


def jt(a):
    return pt.to_tensor(np.asarray(a))


def jax_mlp(sizes, seed):
    with undrawn_jax_init():
        m = jnn.Sequential(jnn.Linear(sizes[0], sizes[1]), jnn.ReLU(),
                           jnn.Linear(sizes[1], sizes[2]))
    m.set_state_dict(W.mlp_weights(sizes, seed))
    return m


def jax_mse(m, x, y):
    return jnn.MSELoss()(m(x), y)


def jax_llama_losses(cfg_kw, batches, mesh=None, bucketed=None):
    """Losses and global norms of the JAX package's TrainStep on the
    worker's weights and batches."""
    with undrawn_jax_init():
        jm = JaxLM(JaxCfg(**cfg_kw))
    jm.set_state_dict(W.llama_state({**cfg_kw, "tensor_parallel": False}))
    jm.train()
    opt = pt.optimizer.AdamW(learning_rate=W.LR, parameters=jm.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    step = pt.jit.TrainStep(jm, lambda m, x, y: m(x, labels=y)[1], opt,
                            mesh=mesh, bucketed=bucketed)
    losses, norms = [], []
    for ids, labels in batches:
        losses.append(float(np.asarray(step(
            jt(ids.astype(np.int32)), jt(labels.astype(np.int32))).data)))
        norms.append(float(np.asarray(step.last_grad_norm)))
    return losses, norms


# -- collectives ---------------------------------------------------------------
REGIONS = {
    "sum": (lambda g: lambda x: jdist.all_reduce(x, group=g), "col8", None),
    "max": (lambda g: lambda x: jdist.all_reduce(
        x, op=jdist.ReduceOp.MAX, group=g), "col8", None),
    "min": (lambda g: lambda x: jdist.all_reduce(
        x, op=jdist.ReduceOp.MIN, group=g), "col8", None),
    "avg": (lambda g: lambda x: jdist.all_reduce(
        x, op=jdist.ReduceOp.AVG, group=g), "col8", None),
    "prod": (lambda g: lambda x: jdist.all_reduce(
        x + 1, op=jdist.ReduceOp.PROD, group=g), "col8", None),
    "all_gather": (lambda g: lambda x: jdist.all_gather(x, group=g),
                   "rows16", JP("dp", None)),
    "reduce_scatter": (lambda g: lambda x: jdist.reduce_scatter(x, group=g),
                       "flat64", None),
    "broadcast": (lambda g: lambda x: jdist.broadcast(x, src=1, group=g),
                  "col8", None),
    "all_to_all": (lambda g: lambda x: jdist.all_to_all(
        x, group=g, split_axis=1, concat_axis=0), "sq64", None),
    "p2p_shift": (lambda g: lambda x: jdist.p2p_shift(x, group=g, shift=1),
                  "col8", None),
    "scatter": (lambda g: lambda x: jdist.scatter(x, src=1, group=g),
                "flat64", None),
    "reduce": (lambda g: lambda x: jdist.reduce(x, dst=0, group=g),
               "col8", None),
    "replicated_out": (lambda g: lambda x: jdist.all_reduce(x.sum(),
                                                            group=g),
                       "col8", JP()),
}


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_collective_in_a_region_matches_the_reference(ranks, name):
    """Each collective inside ``spmd`` over dp 2 gives the global value
    the reference's region gives, on both ranks."""
    make, key, out_spec = REGIONS[name]
    mesh = jax_mesh({"dp": 2})
    f = jdist.spmd(make(jdist.Group("dp")), mesh=mesh, in_specs=JP("dp"),
                   out_specs=JP("dp") if out_spec is None else out_spec)
    want = np.asarray(f(jt(W.collective_inputs()[key])).numpy())
    for r in range(2):
        np.testing.assert_allclose(
            port(ranks, "collectives", r)[name], want, rtol=1e-6)


def test_a_collective_outside_spmd_runs_across_processes(ranks):
    """Divergence: each rank's own tensor is reduced across the
    processes, where the reference raises outside a region."""
    jax_mesh({"dp": 2})
    with pytest.raises(RuntimeError):
        jdist.all_reduce(jt([1.0]), group=jdist.Group("dp"))
    for r in range(2):
        np.testing.assert_allclose(port(ranks, "collectives", r)["outside"],
                                   [3.0])


def test_world_size_counts_processes(ranks):
    """Divergence: rank and world size are the process's and the number
    of processes (the reference: devices under one process)."""
    jax_mesh({"dp": 2})
    assert jdist.get_world_size() == jax.device_count() == 8
    assert [port(ranks, "collectives", r)["world"] for r in range(2)] == \
        [(0, 2, 2, 0), (1, 2, 2, 1)]


def test_point_to_point_and_tasks(ranks):
    r0, r1 = (port(ranks, "collectives", r) for r in range(2))
    np.testing.assert_array_equal(r1["send_recv"], [0, 1, 2])
    np.testing.assert_array_equal(r0["send_recv"], [0, 10, 20])
    np.testing.assert_array_equal(r0["batch_p2p"], [1, 1])
    np.testing.assert_array_equal(r1["batch_p2p"], [0, 0])
    for r in (r0, r1):
        np.testing.assert_array_equal(r["stream"][0], [3, 3])
        assert r["stream"][1] is True
        np.testing.assert_array_equal(r["stream_sync"], [2])
        assert [float(p[0]) for p in r["gather"]] == [0.0, 1.0]
        assert r["backend"] == "GLOO"


def test_object_collectives_and_the_job_store(ranks):
    r0, r1 = (port(ranks, "collectives", r) for r in range(2))
    for r in (r0, r1):
        assert r["all_gather_object"] == [{"rank": 0, "tag": "x"},
                                          {"rank": 1, "tag": "xx"}]
        assert r["broadcast_object_list"] == [1, "mine"]
    assert r0["scatter_object_list"] == [{"to": 0}]
    assert r1["scatter_object_list"] == [{"to": 1}]
    assert sorted([r0["store_add"], r1["store_add"]]) == [1, 2]
    assert (r0["store_peer"], r1["store_peer"]) == ("v1", "v0")


def test_host_groups_and_mesh_shapes_are_checked(ranks):
    r0 = port(ranks, "collectives")
    assert "host-rank" in r0["host_group_device_collective"]
    assert "does not cover 2 processes" in r0["mesh_mismatch"]
    with pytest.raises(ValueError):
        jdist.init_mesh({"dp": 3})


# -- placements and topology ---------------------------------------------------
def test_placements_match_the_reference(ranks):
    mesh = jax_mesh({"dp": 2})
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    ja = jdist.shard_tensor(jt(x), mesh, [jdist.Shard(0)])
    assert tuple(ja._sharding_spec) == ("dp", None)
    for r in range(2):
        got = port(ranks, "placements", r)
        np.testing.assert_array_equal(got["local"], x[2 * r:2 * r + 2])
        assert got["spec"] == ("dp", None)
        np.testing.assert_array_equal(got["full"], np.asarray(
            jdist.reshard(ja, mesh, [jdist.Replicate()]).numpy()))
        np.testing.assert_array_equal(got["col_local"], x[:, 3 * r:3 * r + 3])
        assert got["col_spec"] == (None, "dp")
        np.testing.assert_array_equal(got["constraint"], x)
        np.testing.assert_array_equal(got["plain_constraint"], x)
        assert "Partial" in got["partial"]


def test_topology_matches_the_reference(ranks):
    from paddle_tpu_torch.distributed import CommunicateTopology
    dims = [2, 1, 2, 2]
    ref = jdist.CommunicateTopology(["data", "pipe", "sharding", "model"],
                                    dims)
    ours = CommunicateTopology(["data", "pipe", "sharding", "model"], dims)
    for axis in ("data", "sharding", "model"):
        assert ours.get_comm_list(axis) == ref.get_comm_list(axis)
        assert ours.get_axis_list(axis, 1) == ref.get_axis_list(axis, 1)
    assert ours.get_coord(5) == ref.get_coord(5)
    assert ours.get_rank(data=1, pipe=0, sharding=1, model=0) == \
        ref.get_rank(data=1, pipe=0, sharding=1, model=0)
    got = port(ranks, "topology")
    assert (got["mp"], got["dp"], got["mp_group"]) == (2, 1, 2)
    assert got["mesh"] == {"dp": 1, "pp": 1, "sharding": 1, "mp": 2}
    assert got["worker"] == (0, 2)
    assert got["tp_model_passes"] == "Linear"
    assert got["dp_wraps"] == "DataParallel"


# -- data parallelism and ZeRO --------------------------------------------------
def test_data_parallel_mlp_matches_the_reference(ranks):
    """tests/test_distributed.py:193: 8 AdamW steps of an MLP at dp 2
    equal the reference's DataParallel run."""
    X, Y = W.regression(64, 16, 4)
    mesh = jax_mesh({"dp": 2})
    m = jdist.DataParallel(jax_mlp((16, 32, 4), 3), mesh=mesh)
    o = pt.optimizer.AdamW(learning_rate=0.01, parameters=m.parameters())
    s = pt.jit.TrainStep(m, jax_mse, o)
    want = [float(s(jt(X), jt(Y)).numpy()) for _ in range(W.MLP_STEPS)]
    for r in range(2):
        got = port(ranks, "dp_mlp", r)
        np.testing.assert_allclose(got["losses"], want, **DP_TOL)
    np.testing.assert_array_equal(port(ranks, "dp_mlp", 0)["w"],
                                  port(ranks, "dp_mlp", 1)["w"])


def test_apply_collective_grads_averages_eager_gradients(ranks):
    """After an eager backward on each rank's rows, the wrapper's
    ``apply_collective_grads`` leaves the full batch's gradient on both
    ranks; ``scale_loss`` is the identity; a ``ProcessMesh`` becomes a
    ``DeviceMesh`` (the reference's ``to_jax``)."""
    pm = jdist.ProcessMesh([0, 1], dim_names=["x"])
    assert pm.shape == [2] and pm.get_dim_size("x") == 2
    for r in range(2):
        got = port(ranks, "dp_mlp", r)
        for n, g in got["full_grads"].items():
            np.testing.assert_allclose(got["eager_grads"][n], g, rtol=1e-5,
                                       atol=1e-6, err_msg=n)
        assert got["scale_loss"] == 7.0
        assert got["process_mesh"] == (("x",), (2,))


@pytest.fixture(scope="module")
def zero_base():
    X, Y = W.regression(32, 16, 8)
    m = jax_mlp((16, 64, 8), 3)
    o = pt.optimizer.AdamW(learning_rate=0.01, parameters=m.parameters())
    s = pt.jit.TrainStep(m, jax_mse, o)
    return [float(s(jt(X), jt(Y)).numpy()) for _ in range(W.MLP_STEPS)]


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_zero_level_matches_the_reference(ranks, zero_base, level):
    """tests/test_zero.py:71: each level's losses over the sharding axis
    equal the reference's group-sharded run and its plain run; each rank
    holds half of what the level shards."""
    X, Y = W.regression(32, 16, 8)
    mesh = jax_mesh({"sharding": 2})
    m = jax_mlp((16, 64, 8), 3)
    o = pt.optimizer.AdamW(learning_rate=0.01, parameters=m.parameters())
    m, o, _ = jdist.group_sharded_parallel(m, o, level=level)
    s = pt.jit.TrainStep(m, jax_mse, o, mesh=mesh,
                         input_spec=JP("sharding"))
    want = [float(s(jt(X), jt(Y)).numpy()) for _ in range(W.MLP_STEPS)]
    np.testing.assert_allclose(want, zero_base, **ZERO_TOL)
    for r in range(2):
        got = port(ranks, "zero", r)[level]
        np.testing.assert_allclose(got["losses"], want, **ZERO_TOL)
        assert got["moment_shape"] == (8, 64)
        assert got["param_shape"] == ((8, 64) if level == "p_g_os"
                                      else (16, 64))


def test_zero_save_gathers_the_full_model(ranks):
    for r in range(2):
        got = port(ranks, "zero", r)
        assert got["p_g_os"]["saved_shape"] == (16, 64)
        assert got["p_g_os"]["saved_rows_equal"]
        assert "level must be one of" in got["bad_level"]


# -- the Llama at dp 2 ------------------------------------------------------------
@pytest.mark.parametrize("uneven", [False, True])
def test_llama_dp2_matches_the_reference(ranks, uneven):
    """fleet.init -> distributed_model -> distributed_optimizer ->
    TrainStep(mesh=, bucketed=True), 3 AdamW steps with a global-norm
    clip, against the reference's GSPMD mesh run: one mean over the
    global batch, also for the batch whose second half keeps few labels
    (the reference's bucketed shard_map step would average the ranks'
    means there, and reports a global norm summed over its shards)."""
    batches = W.llama_batches(W.TINY["vocab_size"], uneven)
    mesh = jax_mesh({"dp": 2})
    losses, norms = jax_llama_losses(W.TINY, batches, mesh=mesh,
                                     bucketed=False)
    for r in range(2):
        got = port(ranks, "llama_dp", r)[f"uneven={uneven}"]
        np.testing.assert_allclose(got["losses"], losses, **DP_TOL)
        np.testing.assert_allclose(got["norms"], norms, rtol=2e-4)
        # one bucket at the default 25 MB: one all-reduce a step
        assert got["all_reduces"] == [1] * W.STEPS
        assert len(got["buckets"]) == 1


def test_each_bucket_is_one_all_reduce_a_step(ranks):
    """A 0.02 MB bucket size plans several buckets (the reference's plan
    for the same shapes); each step issues one all-reduce per bucket,
    and neither the bucketing nor per-parameter reduction moves the
    losses."""
    got = port(ranks, "llama_dp")
    small = got["small_buckets"]
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    m = LlamaForCausalLM(LlamaConfig(**W.TINY), device="cpu")
    train = {n: np.zeros(p.shape, np.float32) for n, p in
             m.named_parameters()}
    want = jbucketing.plan_comm_buckets(train, int(0.02 * 1024 * 1024))
    assert [tuple(b) for b in small["buckets"]] == want
    assert small["all_reduces"] == [len(want)] * W.STEPS
    assert got["unbucketed"]["all_reduces"] == [len(train)] * W.STEPS
    for run in (small, got["unbucketed"]):
        np.testing.assert_allclose(run["losses"],
                                   got["uneven=False"]["losses"], rtol=1e-6)


def test_bucket_size_is_an_argument(monkeypatch):
    """Divergence: PADDLE_TPU_COMM_BUCKET_MB and PADDLE_TPU_BUCKETED_GRADS
    are not read; the size is DataParallel's comm_buffer_size (25 MB
    by default, the reference's)."""
    from paddle_tpu_torch.jit import bucketing
    monkeypatch.setenv("PADDLE_TPU_COMM_BUCKET_MB", "0.001")
    monkeypatch.setenv("PADDLE_TPU_BUCKETED_GRADS", "0")
    assert bucketing.comm_bucket_bytes() == 25 * 1024 * 1024
    assert jbucketing.comm_bucket_bytes() != bucketing.comm_bucket_bytes()
    ts = {f"p{i}": torch.zeros(1024) for i in range(4)}
    assert bucketing.plan_comm_buckets(ts) == [("p3", "p2", "p1", "p0")]
    assert bucketing.plan_comm_buckets(ts, 8192) == [("p3", "p2"),
                                                     ("p1", "p0")]
    assert not hasattr(bucketing, "bucketed_enabled")


def test_unported_distributed_modules_are_not_exported():
    """Divergence: the auto_parallel engine and rpc wait for their
    slices; every other name of the reference's ``paddle.distributed`` is
    exported (``launch`` since its slice: the launcher module), and of
    ``fleet`` every name. ``auto_parallel`` holds only the checkpoint
    converters: its ``Engine``, ``Strategy``, planner and cost model are
    not exported."""
    import ast

    import paddle_tpu_torch.distributed as dist
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "paddle_tpu", "distributed")

    def imported(*parts):
        names = set()
        src = open(os.path.join(root, *parts, "__init__.py")).read()
        for node in ast.parse(src).body:
            if isinstance(node, ast.ImportFrom):
                names |= {a.asname or a.name for a in node.names}
        return names
    names = imported()
    assert set(dist.UNPORTED) <= names
    for name in names - set(dist.UNPORTED):
        assert hasattr(dist, name), name
    for name in dist.UNPORTED:
        assert not hasattr(dist, name), name
    assert set(dist.UNPORTED) == {"Engine", "Strategy", "rpc"}
    from paddle_tpu_torch.distributed import launch
    assert dist.launch is launch and callable(launch.main)
    for name in imported("fleet"):
        assert hasattr(dist.fleet, name), name
    ap = dist.auto_parallel
    for name in ("Converter", "pipeline_state_to_spmd",
                 "spmd_state_to_pipeline", "uniform_chunk_bounds"):
        assert hasattr(ap, name), name
    for name in ("Engine", "Strategy", "Planner", "CostEstimator",
                 "Cluster", "auto_shard_params"):
        assert name in imported("auto_parallel") and \
            not hasattr(ap, name), name


def test_init_parallel_env_needs_a_card_or_gloo(monkeypatch):
    """Without a card the default (nccl) backend raises; a mesh needs the
    process group; nothing falls back quietly."""
    import paddle_tpu_torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for kw in ({}, {"backend": "nccl"}):
        with pytest.raises(RuntimeError, match="gloo"):
            dist.init_parallel_env(**kw)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        dist.init_mesh({"dp": 1})
    assert dist.get_rank() == 0 and dist.get_world_size() == 1
    x = torch.ones(2)
    assert dist.all_reduce(x) is x


def test_spawn_hands_each_process_its_rank(tmp_path):
    """``spawn`` starts the processes; ``init_parallel_env`` in each
    reads the rank and world size it set and joins them."""
    import paddle_tpu_torch.distributed as dist
    dist.spawn(W.spawned_rank, args=(str(tmp_path),), nprocs=2)
    got = sorted(p.read_text() for p in tmp_path.glob("rank*"))
    assert got == ["0 2 3.0", "1 2 3.0"]
