"""One rank of the port's distributed tests (gloo on the CPU).

    python tests/torch_dist_worker.py SUITE RANK WORLD HOST:PORT OUTDIR

Each rank joins the world through ``init_parallel_env(backend="gloo")``,
runs the suite's cases and pickles ``{case: result}`` into
``OUTDIR/SUITE.rank<RANK>.pkl`` (a failed case records its traceback
under ``"error:<case>"``), then destroys the process group. The suites:
``dist`` (world 2: collectives, placements, topology, the object
collectives, ``compat``, data parallelism, ZeRO, the Llama at dp 2),
``tp2`` (world 2: the mpu layers, a tensor-parallel MLP, the Llama at
mp 2 with both loss heads) and ``tp4`` (world 4: the Llama at dp 2 x mp
2, collectives over a 2-D mesh).

The weights and batches come from the helpers below, which the tests
call too, so the JAX package sees the same numbers. This file imports
neither ``jax`` nor ``paddle_tpu``.
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
# a tied vocab at the fused chunked CE's threshold, one layer
TIED_BIG = dict(TINY, vocab_size=32768, num_hidden_layers=1,
                tie_word_embeddings=True)
LR = 1e-2
STEPS = 3
MLP_STEPS = 8


# -- data shared with the tests ----------------------------------------------
def llama_state(cfg_kw, seed=0) -> dict:
    """The numpy weights of a one-device port Llama of ``cfg_kw``."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.utils.bridge import numpy_state
    return numpy_state(LlamaForCausalLM(LlamaConfig(**cfg_kw),
                                        device="cpu", seed=seed))


def llama_batches(vocab, uneven=False, n=STEPS, B=4, S=16, seed=1):
    """``n`` (ids, labels) int64 batches. ``uneven``: the second half of
    the rows (dp rank 1's) keeps only 2 labels a row, the rest -100."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
        labels = ids.copy()
        if uneven:
            labels[B // 2:, 3:] = -100
            labels[0, 5:7] = -100
        out.append((ids, labels))
    return out


def mlp_weights(sizes, seed) -> dict:
    """``{"<i>.weight", "<i>.bias"}`` of a Linear / ReLU / Linear stack."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, (a, b) in zip((0, 2), zip(sizes[:-1], sizes[1:])):
        out[f"{i}.weight"] = (rng.randn(a, b) / np.sqrt(a)).astype(
            np.float32)
        out[f"{i}.bias"] = (0.1 * rng.randn(b)).astype(np.float32)
    return out


def regression(n, d_in, d_out, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d_in).astype(np.float32)
    return X, X @ rng.randn(d_in, d_out).astype(np.float32)


def collective_inputs():
    return {"col8": np.arange(8, dtype=np.float32).reshape(8, 1),
            "rows16": np.arange(16, dtype=np.float32).reshape(8, 2),
            "flat64": np.arange(64, dtype=np.float32),
            "sq64": np.arange(64, dtype=np.float32).reshape(8, 8)}


# -- the port's side ----------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mlp(sizes, seed):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    m = nn.Sequential(nn.Linear(sizes[0], sizes[1], device="cpu"),
                      nn.ReLU(), nn.Linear(sizes[1], sizes[2], device="cpu"))
    load_numpy_state(m, mlp_weights(sizes, seed))
    return m


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _llama_run(cfg_kw, batches, mesh=None, wrap=None, **step_kw):
    """Losses and the global-norm of STEPS TrainSteps of the Llama."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.bridge import load_numpy_state, numpy_state
    model = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu")
    load_numpy_state(model, llama_state({**cfg_kw,
                                         "tensor_parallel": False}))
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    if wrap is not None:
        model, opt = wrap(model, opt)
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[1], opt,
                     mesh=mesh, **step_kw)
    losses, norms, reduces = [], [], []
    for ids, labels in batches:
        losses.append(float(step(_t(ids), _t(labels))))
        norms.append(float(step.last_grad_norm))
        plan = step._mesh_plan
        reduces.append(None if plan is None else plan.last_all_reduces)
    plan = step._mesh_plan
    return {"losses": losses, "norms": norms, "all_reduces": reduces,
            "buckets": None if plan is None or plan.comm_buckets is None
            else [list(b) for b in plan.comm_buckets],
            "state": numpy_state(model)}


def case_collectives(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import P
    mesh = dist.init_mesh({"dp": 2})
    g = dist.Group("dp")
    inp = {k: _t(v) for k, v in collective_inputs().items()}

    def region(fn, x, spec=P("dp"), out=P("dp")):
        return dist.spmd(fn, mesh=mesh, in_specs=spec,
                         out_specs=out)(x).numpy()
    out = {
        "sum": region(lambda x: dist.all_reduce(x, group=g), inp["col8"]),
        "max": region(lambda x: dist.all_reduce(
            x, op=dist.ReduceOp.MAX, group=g), inp["col8"]),
        "min": region(lambda x: dist.all_reduce(
            x, op=dist.ReduceOp.MIN, group=g), inp["col8"]),
        "avg": region(lambda x: dist.all_reduce(
            x, op=dist.ReduceOp.AVG, group=g), inp["col8"]),
        "prod": region(lambda x: dist.all_reduce(
            x + 1, op=dist.ReduceOp.PROD, group=g), inp["col8"]),
        "all_gather": region(lambda x: dist.all_gather(x, group=g),
                             inp["rows16"], out=P("dp", None)),
        "reduce_scatter": region(lambda x: dist.reduce_scatter(x, group=g),
                                 inp["flat64"]),
        "broadcast": region(lambda x: dist.broadcast(x, src=1, group=g),
                            inp["col8"]),
        "all_to_all": region(lambda x: dist.all_to_all(
            x, group=g, split_axis=1, concat_axis=0), inp["sq64"]),
        "p2p_shift": region(lambda x: dist.p2p_shift(x, group=g, shift=1),
                            inp["col8"]),
        "scatter": region(lambda x: dist.scatter(x, src=1, group=g),
                          inp["flat64"]),
        "reduce": region(lambda x: dist.reduce(x, dst=0, group=g),
                         inp["col8"]),
        "replicated_out": region(lambda x: dist.all_reduce(x.sum(),
                                                           group=g),
                                 inp["col8"], out=P()),
    }
    # outside a region: each rank's own tensor, reduced across processes
    out["outside"] = dist.all_reduce(torch.tensor([1.0 + r]),
                                     group=g).numpy()
    out["world"] = (dist.get_rank(), dist.get_world_size(),
                    dist.get_world_size(g), dist.get_rank(g))
    # point to point and the async forms
    buf = torch.zeros(3)
    if r == 0:
        dist.send(torch.arange(3.0), dst=1)
        task = dist.irecv(buf, src=1)
        task.wait()
    else:
        dist.recv(buf, src=0)
        dist.isend(buf * 10, dst=0).wait()
    out["send_recv"] = buf.numpy()
    bufs = [torch.full((2,), float(r)), torch.zeros(2)]
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, bufs[0], 1 - r),
        dist.P2POp(dist.irecv, bufs[1], 1 - r)])
    for t in tasks:
        t.wait()
    out["batch_p2p"] = bufs[1].numpy()
    t = dist.stream.all_reduce(torch.ones(2) * (r + 1), sync_op=False)
    out["stream"] = (t.wait().numpy(), t.is_completed())
    out["stream_sync"] = dist.stream.all_reduce(
        torch.ones(1), use_calc_stream=True).wait().numpy()
    out["gather"] = [p.numpy() for p in dist.gather(torch.tensor([r * 1.0]))]
    objs: list = []
    dist.all_gather_object(objs, {"rank": r, "tag": "x" * (r + 1)})
    out["all_gather_object"] = objs
    lst = [r, "mine"] if r == 1 else [None]
    dist.broadcast_object_list(lst, src=1)
    out["broadcast_object_list"] = lst
    got: list = []
    dist.scatter_object_list(got, [{"to": 0}, {"to": 1}] if r == 0 else None,
                             src=0)
    out["scatter_object_list"] = got
    dist.barrier()
    store = dist.tcp_store.job_store()
    store.set(f"k{r}", f"v{r}")
    out["store_add"] = store.add("counter", 1)
    dist.barrier()
    out["store_peer"] = store.wait(f"k{1 - r}").decode()
    out["backend"] = dist.get_backend()
    host = dist.new_group(ranks=[1])
    try:
        dist.all_reduce(torch.ones(1), group=host)
        out["host_group_device_collective"] = "ran"
    except RuntimeError as e:
        out["host_group_device_collective"] = str(e)
    try:
        dist.init_mesh({"dp": 3})
        out["mesh_mismatch"] = "built"
    except ValueError as e:
        out["mesh_mismatch"] = str(e)
    dist.init_mesh({"dp": 2})
    return out


def case_placements(r):
    import paddle_tpu_torch.distributed as dist
    mesh = dist.get_mesh()
    x = torch.arange(24.0).reshape(4, 6)
    a = dist.shard_tensor(x, mesh, [dist.Shard(0)])
    b = dist.reshard(a, mesh, [dist.Replicate()])
    c = dist.shard_tensor(x, spec=dist.P(None, "dp"))
    try:
        dist.shard_tensor(x, mesh, [dist.Partial()])
        partial = "placed"
    except NotImplementedError as e:
        partial = str(e)
    return {"local": a.to_local().numpy(), "spec": tuple(dist.spec_of(a)),
            "full": b.to_local().numpy(), "col_local": c.to_local().numpy(),
            "col_spec": tuple(c._sharding_spec), "partial": partial,
            "constraint": dist.with_sharding_constraint(
                c, dist.P()).to_local().numpy(),
            "plain_constraint": dist.with_sharding_constraint(
                x, dist.P("dp")).numpy()}


def case_topology(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 1,
                        "sharding_degree": 1}
    hcg = fleet.init(is_collective=True, strategy=s)
    out = {"mp": hcg.get_model_parallel_world_size(),
           "dp": hcg.get_data_parallel_world_size(),
           "mesh": dict(zip(dist.get_mesh().mesh_dim_names,
                            dist.get_mesh().shape)),
           "mp_group": hcg.get_model_parallel_group().nranks,
           "worker": (fleet.worker_index(), fleet.worker_num()),
           "tp_model_passes": fleet.distributed_model(torch.nn.Linear(2, 2))
           .__class__.__name__}
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    fleet.init(strategy=s)
    out["dp_wraps"] = type(fleet.distributed_model(
        _mlp((4, 4, 4), 0))).__name__
    dist.init_mesh({"dp": 2})
    return out


def case_dp_mlp(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    X, Y = regression(64, 16, 4)
    m = dist.DataParallel(_mlp((16, 32, 4), 3), mesh=dist.get_mesh())
    opt = AdamW(learning_rate=0.01, parameters=m.parameters())
    step = TrainStep(m, _mse, opt)
    losses = [float(step(_t(X), _t(Y))) for _ in range(MLP_STEPS)]
    w = m._layers[0].weight.detach().numpy()
    # an eager backward on this rank's rows, then the wrapper's average
    rows = slice(32 * r, 32 * r + 32)
    _mse(m, _t(X[rows]), _t(Y[rows])).backward()
    m.apply_collective_grads()
    eager = {n: p.grad.numpy().copy() for n, p in m.named_parameters()}
    full = _mlp((16, 32, 4), 3)
    m2 = dist.DataParallel(full)
    for p, q in zip(full.parameters(), m._layers.parameters()):
        p.data.copy_(q.detach())
    _mse(full, _t(X), _t(Y)).backward()
    whole = {n: p.grad.numpy() for n, p in full.named_parameters()}
    pm = dist.ProcessMesh([0, 1], dim_names=["x"]).to_device_mesh()
    return {"losses": losses, "w": w, "eager_grads": eager,
            "full_grads": whole, "scale_loss": m2.scale_loss(7.0),
            "process_mesh": (tuple(pm.mesh_dim_names), tuple(pm.shape))}


def case_zero(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    import tempfile
    mesh = dist.init_mesh({"sharding": 2})
    X, Y = regression(32, 16, 8)
    out = {}
    for level in ("os", "os_g", "p_g_os"):
        m = _mlp((16, 64, 8), 3)
        opt = AdamW(learning_rate=0.01, parameters=m.parameters())
        m, opt, _ = dist.group_sharded_parallel(m, opt, level=level)
        step = TrainStep(m, _mse, opt, mesh=mesh,
                         input_spec=dist.P("sharding"))
        losses = [float(step(_t(X), _t(Y))) for _ in range(MLP_STEPS)]
        w = m[0].weight
        out[level] = {
            "losses": losses, "param_shape": tuple(w.shape),
            "moment_shape": tuple(opt._state[id(w)]["moment1"].shape)}
        if level == "p_g_os":
            d = tempfile.mkdtemp(prefix="zero_save_") if r == 0 else None
            obj = [d]
            dist.broadcast_object_list(obj, src=0)
            dist.save_group_sharded_model(m, obj[0], opt)
            dist.barrier()
            from paddle_tpu_torch.framework.io import load
            back = load(os.path.join(obj[0], "model.pdmodel"), device="cpu")
            out[level]["saved_shape"] = tuple(back["0.weight"].shape)
            out[level]["saved_rows_equal"] = bool(torch.equal(
                back["0.weight"][8 * r: 8 * r + 8].cpu(), w.detach()))
    try:
        dist.group_sharded_parallel(_mlp((4, 4, 4), 0), AdamW(
            parameters=_mlp((4, 4, 4), 0).parameters()), level="zz")
    except ValueError as e:
        out["bad_level"] = str(e)
    dist.init_mesh({"dp": 2})
    return out


def case_llama_dp(r):
    """The tentpole's data-parallel path: fleet.init -> distributed_model
    -> distributed_optimizer -> TrainStep(mesh=, bucketed=True)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    out = {}
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}

    def fleet_wrap(model, opt):
        fleet.init(is_collective=True, strategy=s)
        return fleet.distributed_model(model), \
            fleet.distributed_optimizer(opt)
    for uneven in (False, True):
        out[f"uneven={uneven}"] = _llama_run(
            TINY, llama_batches(TINY["vocab_size"], uneven), wrap=fleet_wrap,
            mesh=None, bucketed=True)
    # a small bucket size: several buckets, one all-reduce each a step
    out["small_buckets"] = _llama_run(
        TINY, llama_batches(TINY["vocab_size"]),
        wrap=lambda m, o: (dist.DataParallel(m, comm_buffer_size=0.02), o))
    out["unbucketed"] = _llama_run(
        TINY, llama_batches(TINY["vocab_size"]),
        wrap=lambda m, o: (dist.DataParallel(m), o), bucketed=False)
    dist.init_mesh({"dp": 2})
    return out


def case_mpu(r):
    """The mpu layers at mp 2 against their dense math."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.utils.bridge import load_numpy_state, numpy_state
    dist.init_mesh({"mp": 2})
    rng = np.random.RandomState(0)
    x16 = _t(rng.randn(4, 16).astype(np.float32)).requires_grad_()
    x32 = _t(rng.randn(4, 32).astype(np.float32)).requires_grad_()
    out = {}

    def run(name, layer, x, weights):
        load_numpy_state(layer, weights)
        y = layer(x)
        x.grad = None
        (y * y).sum().backward()
        out[name] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                     "dw": dist.collective.gather_block(
                         layer.weight.grad, layer.weight._sharding_spec,
                         layer._mesh).numpy(),
                     "spec": tuple(layer.weight._sharding_spec),
                     "local_shape": tuple(layer.weight.shape),
                     "state": numpy_state(layer)}
    w = {"weight": rng.randn(16, 32).astype(np.float32),
         "bias": rng.randn(32).astype(np.float32)}
    run("col_gather", fleet.ColumnParallelLinear(
        16, 32, has_bias=True, device="cpu"), x16, w)
    run("col_split", fleet.ColumnParallelLinear(
        16, 32, has_bias=True, gather_output=False, device="cpu"), x16, w)
    w2 = {"weight": rng.randn(32, 16).astype(np.float32),
          "bias": rng.randn(16).astype(np.float32)}
    run("row", fleet.RowParallelLinear(32, 16, device="cpu"), x32, w2)
    out["no_bias"] = fleet.ColumnParallelLinear(4, 8, device="cpu").bias
    emb = fleet.VocabParallelEmbedding(64, 16, device="cpu")
    wemb = {"weight": rng.randn(64, 16).astype(np.float32)}
    load_numpy_state(emb, wemb)
    toks = _t(np.array([[0, 5, 63], [10, 20, 40]], dtype=np.int64))
    e = emb(toks)
    (e * e).sum().backward()
    out["emb"] = {"y": e.detach().numpy(), "dw": dist.collective.gather_block(
        emb.weight.grad, emb.weight._sharding_spec, emb._mesh).numpy()}
    logits = rng.randn(8, 64).astype(np.float32)
    labels = rng.randint(0, 64, 8).astype(np.int64)
    labels[2] = -100
    lt = _t(logits[:, 32 * r: 32 * r + 32].copy()).requires_grad_()
    loss = fleet.ParallelCrossEntropy()(lt, _t(labels))
    loss.sum().backward()
    out["pce"] = {"loss": loss.detach().numpy(), "dlogits": lt.grad.numpy()}
    out["inputs"] = {"w": w, "w2": w2, "wemb": wemb, "logits": logits,
                     "labels": labels}
    y = dist.split(x16.detach(), (16, 32), operation="linear", axis=1)
    e = dist.split(toks, (64, 16), operation="embedding")
    out["split"] = (tuple(y.shape), type(y._split_layer).__name__,
                    tuple(e.shape), type(e._split_layer).__name__)
    return out


def case_tp_mlp(r):
    """The Megatron MLP (column up, row down) trained at mp 2."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.bridge import load_numpy_state

    class TPMLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.up = fleet.ColumnParallelLinear(
                16, 64, has_bias=True, gather_output=False, device="cpu")
            self.down = fleet.RowParallelLinear(
                64, 16, input_is_parallel=True, device="cpu")

        def forward(self, x):
            return self.down(torch.relu(self.up(x)))
    mesh = dist.init_mesh({"mp": 2})
    X, Y = regression(32, 16, 16)
    m = TPMLP()
    w = mlp_weights((16, 64, 16), 5)
    load_numpy_state(m, {"up.weight": w["0.weight"], "up.bias": w["0.bias"],
                         "down.weight": w["2.weight"],
                         "down.bias": w["2.bias"]})
    opt = AdamW(learning_rate=0.01, parameters=m.parameters())
    step = TrainStep(m, _mse, opt, mesh=mesh)
    return {"losses": [float(step(_t(X), _t(Y))) for _ in range(10)]}


def case_llama_mp(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 1,
                        "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=s)
    mesh = dist.get_mesh()
    out = {}
    for name, cfg in (("untied", TINY), ("tied_fused_ce", TIED_BIG)):
        cfg = dict(cfg, tensor_parallel=True)
        for uneven in (False, True):
            out[f"{name} uneven={uneven}"] = _llama_run(
                cfg, llama_batches(cfg["vocab_size"], uneven), mesh=mesh,
                bucketed=True)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.utils.bridge import numpy_state
    # the tensor-parallel init keeps this rank's block of the one-device
    # model's draws
    tp = LlamaForCausalLM(LlamaConfig(**dict(TINY, tensor_parallel=True)),
                          device="cpu", seed=4)
    out["init"] = {"local": {n: tuple(p.shape)
                             for n, p in tp.named_parameters()},
                   "full": numpy_state(tp)}
    try:
        LlamaForCausalLM(LlamaConfig(**dict(TINY, tensor_parallel=True,
                                            num_key_value_heads=1)),
                         device="cpu")
        out["kv_heads_check"] = "built"
    except ValueError as e:
        out["kv_heads_check"] = str(e)
    return out


def case_llama_dp_mp(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1,
                        "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=s)
    mesh = dist.get_mesh()
    out = {}
    cfg = dict(TINY, tensor_parallel=True)
    for uneven in (False, True):
        out[f"uneven={uneven}"] = _llama_run(
            cfg, llama_batches(cfg["vocab_size"], uneven), mesh=mesh,
            bucketed=True)
    return out


def case_mesh2d(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import P
    mesh = dist.init_mesh({"dp": 2, "mp": 2})
    x = torch.arange(16.0).reshape(4, 4)
    f = dist.spmd(lambda a: dist.all_reduce(a, group=dist.Group("mp")),
                  mesh=mesh, in_specs=P("dp", "mp"), out_specs=P("dp", "mp"))
    g = dist.spmd(lambda a: dist.all_reduce(
        a, group=dist.Group(("dp", "mp"))), mesh=mesh,
        in_specs=P(("dp", "mp")), out_specs=P(("dp", "mp")))
    return {"mp_sum": f(x).numpy(), "all_sum": g(torch.arange(8.0)).numpy(),
            "coord": (dist.get_rank(), dist.mesh.axis_index(mesh, "dp"),
                      dist.mesh.axis_index(mesh, "mp"))}


def case_build(r):
    """One rank: a mesh TrainStep with bucketed=True and a
    tensor-parallel Llama build and run."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    mesh = dist.init_mesh({"dp": 1})
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    step = TrainStep(m, lambda m, x: m(x, labels=x)[1],
                     AdamW(parameters=m.parameters()), mesh=mesh,
                     bucketed=True)
    loss = float(step(torch.zeros(2, 8, dtype=torch.long)))
    dist.init_mesh({"mp": 1})
    tp = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=True),
                          device="cpu")
    att = tp.model.layers[0].self_attn
    from paddle_tpu_torch.distributed import fleet
    try:  # the mpu layers resolve device=None to the card, as every layer
        fleet.ColumnParallelLinear(4, 8)
        default = "built"
    except RuntimeError as e:
        default = str(e)
    return {"loss": loss, "all_reduces": step._mesh_plan.last_all_reduces,
            "tp_heads": (att.n_heads, att.n_kv), "default_device": default}


SUITES = {"dist": [case_collectives, case_placements, case_topology,
                   case_dp_mlp, case_zero, case_llama_dp],
          "tp2": [case_mpu, case_tp_mlp, case_llama_mp],
          "tp4": [case_mesh2d, case_llama_dp_mp],
          "build": [case_build]}


class Ranks:
    """A world of ``world`` worker processes running ``suite`` of the
    worker file ``script`` (this one by default), started at once (the
    tests' module fixtures make one per file); their output goes to
    ``log.txt`` in their directory."""

    def __init__(self, suite, world, timeout=600, script=None):
        import shutil
        import subprocess
        import tempfile
        from paddle_tpu_torch.distributed.tcp_store import (_load_lib,
                                                            free_port)
        _load_lib()  # one build before the ranks start
        self.suite, self.world, self.timeout = suite, world, timeout
        self.dir = tempfile.mkdtemp(prefix=f"torch_dist_{suite}_")
        self._rmtree = shutil.rmtree
        master = f"127.0.0.1:{free_port()}"
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        self._log = open(os.path.join(self.dir, "log.txt"), "w")
        self.procs = [subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__), suite,
             str(r),
             str(world), master, self.dir], env=env, stdout=self._log,
            stderr=subprocess.STDOUT) for r in range(world)]
        self._results = None

    def results(self) -> list:
        """Every rank's ``{case: result}``; raises with the ranks' errors
        and log when a rank failed."""
        if self._results is None:
            import time
            deadline = time.monotonic() + self.timeout
            rcs = []
            for p in self.procs:
                try:
                    rcs.append(p.wait(max(deadline - time.monotonic(), 1)))
                except Exception:
                    p.kill()
                    rcs.append(p.wait())
            out = []
            for r in range(self.world):
                path = os.path.join(self.dir, f"{self.suite}.rank{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        out.append(pickle.load(f))
                else:
                    out.append({})
            errors = [v for d in out for k, v in d.items()
                      if k.startswith("error:")]
            if any(rcs) or errors:
                self._log.flush()
                with open(os.path.join(self.dir, "log.txt")) as f:
                    log = f.read()[-4000:]
                raise RuntimeError(f"{self.suite} ranks exited {rcs}:\n"
                                   + "\n".join(errors) + "\n" + log)
            self._results = out
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self._log.close()
        self._rmtree(self.dir, ignore_errors=True)


def main(argv, suites=None):
    """Run one rank of ``suites[suite]`` (this file's suites by
    default)."""
    suite, rank, world, master, outdir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(backend="gloo", rank=rank, world_size=world,
                           master=master)
    results = {}
    ok = True
    for case in (suites or SUITES)[suite]:
        name = case.__name__[len("case_"):]
        try:
            results[name] = case(rank)
        except Exception:
            ok = False
            results[f"error:{name}"] = traceback.format_exc()
            break  # the ranks would no longer call the same collectives
    with open(os.path.join(outdir, f"{suite}.rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    if ok:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))


def spawned_rank(outdir):
    """The body of the ``spawn`` test: join the world ``spawn`` set up,
    all-reduce, write ``rank world sum``."""
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(backend="gloo")
    t = dist.all_reduce(torch.tensor([1.0 + dist.get_rank()]))
    with open(os.path.join(outdir, f"rank{dist.get_rank()}"), "w") as f:
        f.write(f"{dist.get_rank()} {dist.get_world_size()} {float(t[0])}")
    dist.destroy_process_group()
