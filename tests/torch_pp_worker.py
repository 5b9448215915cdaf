"""One rank of the port's pipeline and sequence-parallel tests (gloo on
the CPU).

    python tests/torch_pp_worker.py SUITE RANK WORLD HOST:PORT OUTDIR

Started by ``torch_dist_worker.Ranks(suite, world, script=...)``; each
rank pickles ``{case: result}`` into ``OUTDIR/SUITE.rank<RANK>.pkl``.
The suites, each for a world of 2 or 4:

* ``sp`` — ``ring_attention`` (the composite and the kernel path, causal
  and not), ``ulysses_attention``, ``scatter_sequence`` /
  ``gather_sequence`` and their refusals, on a mesh ``{"sp": n}``;
* ``pp`` — ``PipelineLayer`` and ``PipelineParallel`` (1F1B and the
  interleave, tied layers, recompute, tuple activations, ``eval_batch``,
  spans) on ``{"pp": n}``; ``pp4`` adds the refusal of a mesh with
  another axis (dp 2 x pp 2);
* ``spmd`` — ``pipeline_spmd``, ``SpmdPipelineParallel``,
  ``TrainStep(mesh=)`` (at 4 ranks also dp 2 x pp 2), the converters'
  host <-> SPMD resume and the hetero pipeline with a tied layer.

The data and weights come from the helpers below, which the tests call
too, so the JAX package sees the same numbers. This file imports neither
``jax`` nor ``paddle_tpu``.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

# -- data shared with the tests ----------------------------------------------
#: (B, S, H, D) of the ring cases: the composite, and the kernel path
#: (smaller: the reference's ring-flash runs its kernels interpreted)
RING_SHAPE = {False: (2, 32, 4, 16), True: (2, 16, 2, 8)}
ULYSSES_SHAPE = (2, 16, 4, 8)
PP_STEPS = 3
PP_MICRO = 8          # 1F1B / interleave micro-batches
SPMD_FWD = ((1, 4), (2, 4), (1, 6), (2, 6))   # (v, M) of the forward cases


def qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def ring_seed(use_flash, causal):
    return 10 + 2 * int(use_flash) + int(causal)


def descs_spec():
    """The reference test's 7-layer stack (tests/test_pipeline.py:23):
    ``(name, in, out)`` with None sizes for activations."""
    return [("Linear", 8, 16), ("ReLU",), ("Linear", 16, 16), ("GELU",),
            ("Linear", 16, 8), ("ReLU",), ("Linear", 8, 2)]


def deep_spec(n=8, d=8):
    """``n`` Linear + GELU blocks and a head (tests/test_pipeline.py:149)."""
    out = []
    for _ in range(n):
        out += [("Linear", d, d), ("GELU",)]
    return out + [("Linear", d, 2)]


def dual_spec():
    """The tuple-activation stack (tests/test_pipeline.py:317)."""
    return [("SplitHead",), ("DualBlock",), ("DualBlock",), ("MergeHead",)]


def stack_state(spec, seed, prefix="layers."):
    """Numpy weights ``{prefix}{i}.{name}`` of every parameter of
    ``spec``'s layers (Paddle's ``[in, out]`` layout)."""
    rng = np.random.RandomState(seed)
    out = {}

    def lin(key, a, b):
        out[f"{key}.weight"] = (rng.randn(a, b) / np.sqrt(a)).astype(
            np.float32)
        out[f"{key}.bias"] = (0.1 * rng.randn(b)).astype(np.float32)
    for i, item in enumerate(spec):
        key = f"{prefix}{i}"
        if item[0] == "Linear":
            lin(key, item[1], item[2])
        elif item[0] == "SplitHead":
            lin(key + ".lin", 8, 8)
            lin(key + ".aux", 8, 8)
        elif item[0] == "DualBlock":
            lin(key + ".a", 8, 8)
            lin(key + ".b", 8, 8)
        elif item[0] == "MergeHead":
            lin(key + ".lin", 16, 8)
    return out


def pp_batch(seed, n=16, d_in=8, d_out=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d_in).astype(np.float32),
            rng.randn(n, d_out).astype(np.float32))


def spmd_params(v, S, seed, d=8):
    """Stacked ``{"W": [v, S, d, d], "b": [v, S, d]}`` and chunk-order
    copies ``Ws [C, d, d]``, ``bs [C, d]`` (reference
    tests/test_spmd_pipeline.py:24)."""
    rng = np.random.RandomState(seed)
    Ws = (rng.randn(v * S, d, d) * 0.3).astype(np.float32)
    bs = (rng.randn(v * S, d) * 0.1).astype(np.float32)
    return Ws, bs


def spmd_layer_state(v, S, seed, d=8):
    """``SpmdPipelineLayer``'s stacked state of ``Linear(d, d) + Tanh``
    blocks (keys as the reference mangles them)."""
    Ws, bs = spmd_params(v, S, seed, d)
    return {"0__weight": Ws.reshape(v, S, d, d),
            "0__bias": bs.reshape(v, S, d)}


def hetero_state(v, S, seed, d=8):
    """``SpmdHeteroPipelineLayer``'s ``trunk_flat`` (every chunk one
    ``Linear(d, d)``: weight then bias) and its tied ``Linear(d, d)``."""
    rng = np.random.RandomState(seed)
    L = d * d + d
    return {"trunk_flat": (rng.randn(v, S, L) * 0.3).astype(np.float32),
            "shared.weight": (rng.randn(d, d) * 0.3).astype(np.float32),
            "shared.bias": (rng.randn(d) * 0.1).astype(np.float32)}


def sequential_np(x, Ws, bs):
    h = x
    for W_, b_ in zip(Ws, bs):
        h = np.tanh(h @ W_ + b_)
    return h


# -- the port's side ----------------------------------------------------------
def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().cpu().numpy().copy()


def _world():
    import paddle_tpu_torch.distributed as dist
    return dist.get_world_size()


def _mesh(shape):
    import paddle_tpu_torch.distributed as dist
    return dist.init_mesh(shape)


# sequence parallelism ----------------------------------------------------------
def _local(a, rank, n, dim=1):
    return np.split(a, n, axis=dim)[rank]


def case_ring(rank):
    """Each rank's output shard and q/k/v gradient shards of the global
    mean, for both paths and both masks; ``use_flash=None`` on CPU
    tensors must be the composite, bit for bit."""
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"sp": n})
    out = {}
    for use_flash in (False, True):
        for causal in (False, True):
            arrs = qkv(RING_SHAPE[use_flash], ring_seed(use_flash, causal))
            q, k, v = (_t(_local(a, rank, n), grad=True) for a in arrs)
            o = fleet.ring_attention(q, k, v, causal=causal,
                                     use_flash=use_flash)
            (o.sum() / (o.numel() * n)).backward()
            out[(use_flash, causal)] = dict(
                o=_np(o), dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
    arrs = qkv(RING_SHAPE[False], ring_seed(False, True))
    q, k, v = (_t(_local(a, rank, n)) for a in arrs)
    auto = fleet.ring_attention(q, k, v, causal=True)
    out["auto_is_composite"] = bool(torch.equal(
        auto, fleet.ring_attention(q, k, v, causal=True, use_flash=False)))
    return out


def case_ulysses(rank):
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"sp": n})
    out = {}
    for causal in (False, True):
        arrs = qkv(ULYSSES_SHAPE, 20 + int(causal))
        q, k, v = (_t(_local(a, rank, n), grad=True) for a in arrs)
        o = fleet.ulysses_attention(q, k, v, causal=causal)
        (o.sum() / (o.numel() * n)).backward()
        out[causal] = dict(o=_np(o), dq=_np(q.grad), dk=_np(k.grad),
                           dv=_np(v.grad))
    return out


def case_scatter_gather(rank):
    """The round trip, this rank's shard, and the gradient of the
    gathered sum."""
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"sp": n})
    x = np.random.RandomState(0).randn(2, 16, 8).astype(np.float32)
    xt = _t(x, grad=True)
    s = fleet.scatter_sequence(xt)
    g = fleet.gather_sequence(s)
    g.sum().backward()
    return dict(shard=_np(s), gathered=_np(g), grad=_np(xt.grad))


def case_sp_refusals(rank):
    """The missing-axis error, the GQA refusal and the indivisible
    sequence, each as the message it raises."""
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    got = {}

    def catch(key, fn):
        try:
            fn()
            got[key] = None
        except Exception as e:  # recorded for the test to assert on
            got[key] = (type(e).__name__, str(e))
    _mesh({"dp": n})
    q = _t(np.zeros((1, 4, 4, 8), np.float32))
    catch("no_axis", lambda: fleet.ring_attention(q, q, q))
    catch("no_axis_ulysses", lambda: fleet.ulysses_attention(q, q, q))
    _mesh({"sp": n})
    kv = _t(np.zeros((1, 4, 2, 8), np.float32))
    catch("gqa", lambda: fleet.ring_attention(q, kv, kv))
    catch("gqa_flash", lambda: fleet.ring_attention(q, kv, kv,
                                                    use_flash=True))
    catch("indivisible", lambda: fleet.scatter_sequence(
        _t(np.zeros((1, 4 * n + 1, 4, 8), np.float32))))
    catch("uneven_shards", lambda: fleet.ring_attention(
        q, _t(np.zeros((1, 5, 4, 8), np.float32)),
        _t(np.zeros((1, 5, 4, 8), np.float32))))
    catch("ulysses_heads", lambda: fleet.ulysses_attention(
        *(_t(np.zeros((1, 4, n + 1, 8), np.float32)),) * 3))
    return got


# pipelines --------------------------------------------------------------------
class _SplitHead(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        from paddle_tpu_torch import nn
        self.lin = nn.Linear(d, d)
        self.aux = nn.Linear(d, d)

    def forward(self, x):
        return self.lin(x), self.aux(x)


class _DualBlock(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        from paddle_tpu_torch import nn
        self.a = nn.Linear(d, d)
        self.b = nn.Linear(d, d)

    def forward(self, x, aux):
        return torch.relu(self.a(x)), torch.relu(self.b(aux))


class _MergeHead(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        from paddle_tpu_torch import nn
        self.lin = nn.Linear(2 * d, d)

    def forward(self, x, aux):
        return self.lin(torch.cat([x, aux], dim=-1))


def port_descs(spec):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    kinds = {"Linear": nn.Linear, "ReLU": nn.ReLU, "GELU": nn.GELU,
             "SplitHead": _SplitHead, "DualBlock": _DualBlock,
             "MergeHead": _MergeHead}
    return [fleet.LayerDesc(kinds[item[0]], *item[1:]) for item in spec]


def _pipeline(spec, seed, **kw):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    pl = fleet.PipelineLayer(port_descs(spec), loss_fn=nn.MSELoss(),
                             device="cpu", **kw)
    pl.set_state_dict(stack_state(spec, seed))
    return pl


def _train(pl, X, Y, n_micro, steps=PP_STEPS, sgd=False):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD, AdamW
    pp = fleet.PipelineParallel(pl, accumulate_steps=n_micro)
    op = SGD(learning_rate=0.1, parameters=pp.parameters()) if sgd else \
        AdamW(learning_rate=0.01, parameters=pp.parameters())
    losses = [float(pp.train_batch((_t(X), _t(Y)), op))
              for _ in range(steps)]
    return dict(losses=losses, stats=pp.last_schedule_stats,
                state={k: _np(v) for k, v in pl.state_dict().items()})


def case_pipeline_layer(rank):
    """Segmentation, placement, what each rank built, and the sequential
    forward (every rank returns the last stage's output)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"pp": n})
    pl = _pipeline(descs_spec(), 3)
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    ready = nn.Linear(8, 8, device="cpu")   # a built layer for stage n-1
    mixed = fleet.PipelineLayer(
        port_descs(deep_spec(n - 1)[:-1]) + [ready, nn.GELU()],
        device="cpu")
    with torch.no_grad():
        fwd = _np(pl(_t(x)))
    return dict(bounds=pl._bounds, stage=pl.stage_id,
                chunk_stages=[pl.chunk_stage(c) for c in range(pl.num_chunks)],
                local=sorted(int(k) for k in pl.layers._modules),
                keys=sorted(pl.state_dict()), fwd=fwd,
                ready_kept=any(m is ready for m in mixed.modules()),
                mixed_local=sorted(int(k) for k in mixed.layers._modules))


def case_schedules(rank):
    """1F1B (v 1) and the interleave (v 2) on the deep stack: losses, the
    schedule's accounting and the trained weights; with a recompute
    interval of 2 too."""
    n = _world()
    _mesh({"pp": n})
    X, Y = pp_batch(1)
    out = {}
    for v in (1, 2):
        out[v] = _train(_pipeline(deep_spec(), 7,
                                  num_virtual_pipeline_stages=v), X, Y,
                        PP_MICRO)
    out["recompute"] = _train(_pipeline(deep_spec(), 9,
                                        recompute_interval=2), X, Y, 4)
    return out


def case_shared_desc(rank):
    """A ``SharedLayerDesc`` on the first and the last stage: the first
    holder's weights broadcast at build (the ranks drew different ones),
    the gradients summed over both, one value after training."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"pp": n})
    paddle.seed(100 + rank)
    descs = [fleet.SharedLayerDesc("emb", nn.Linear, 4, 4)]
    descs += [fleet.LayerDesc(nn.ReLU) for _ in range(2 * n - 2)]
    descs.append(fleet.SharedLayerDesc("emb", nn.Linear, 4, 4))
    pl = fleet.PipelineLayer(descs, loss_fn=nn.MSELoss(), device="cpu")
    built = {k: _np(v) for k, v in pl.state_dict().items()}
    paddle.seed(100 + rank)   # what this rank drew for its copy
    drawn = _np(nn.Linear(4, 4, device="cpu").weight)
    rng = np.random.RandomState(5)
    w = (rng.randn(4, 4) * 0.5).astype(np.float32)
    b = (rng.randn(4) * 0.1).astype(np.float32)
    last = len(descs) - 1
    pl.set_state_dict({"layers.0.weight": w, "layers.0.bias": b,
                       f"layers.{last}.weight": w,
                       f"layers.{last}.bias": b})
    X, Y = pp_batch(6, n=8, d_in=4, d_out=4)
    return dict(built=built, drawn=drawn, **_train(pl, X, Y, 2, sgd=True))


def case_tuple_activations(rank):
    """Tuple activations across stages (the p2p meta handshake), and a
    tuple model input micro-split per element."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    n = _world()
    _mesh({"pp": n})
    rng = np.random.RandomState(4)
    X = rng.randn(8, 8).astype(np.float32)
    Y = rng.randn(8, 8).astype(np.float32)
    spec = dual_spec() if n == 4 else [dual_spec()[0], dual_spec()[3]]
    res = _train(_pipeline(spec, 21), X, Y, 4, steps=4)
    blocks = [("DualBlock",)] * (n - 1) + [("MergeHead",)]
    pl = _pipeline(blocks, 22)
    pp = fleet.PipelineParallel(pl, accumulate_steps=2)
    o = SGD(learning_rate=0.01, parameters=pp.parameters())
    xa, xb, y = (rng.randn(4, 8).astype(np.float32) for _ in range(3))
    res["tuple_input_loss"] = float(pp.train_batch(
        ((_t(xa), _t(xb)), _t(y)), o))
    return res


def case_eval_and_spans(rank):
    """``eval_batch``'s loss on every rank, and the span names this
    rank's profiler recorded during a ``train_batch``."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    n = _world()
    _mesh({"pp": n})
    X, Y = pp_batch(2)
    pl = _pipeline(deep_spec(), 5, num_virtual_pipeline_stages=2)
    pp = fleet.PipelineParallel(pl, accumulate_steps=4)
    ev = float(pp.eval_batch((_t(X), _t(Y))))
    p = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    p.start()
    pp.train_batch((_t(X), _t(Y)),
                   SGD(learning_rate=0.01, parameters=pp.parameters()))
    p.stop()
    names = sorted({e.name for e in p._events if e.name.startswith("pp_")})
    return dict(eval=ev, spans=names)


def case_boundary_handshake(rank):
    """The messages this rank sends in four 1F1B steps (4 micro-batches):
    16 rows, 16 again, 8 (a new micro-batch shape) and 16; and the
    boundary keys it keeps."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    n = _world()
    _mesh({"pp": n})
    X, Y = pp_batch(6)
    pl = _pipeline(deep_spec(), 6)
    pp = fleet.PipelineParallel(pl, accumulate_steps=4)
    o = SGD(learning_rate=0.01, parameters=pp.parameters())
    send, sends = C.send, [0]

    def counted(*a, **kw):
        sends[0] += 1
        return send(*a, **kw)
    C.send = counted
    per_step, losses = [], []
    try:
        for rows in (16, 16, 8, 16):
            sends[0] = 0
            losses.append(float(pp.train_batch(
                (_t(X[:rows]), _t(Y[:rows])), o)))
            per_step.append(sends[0])
    finally:
        C.send = send
    return dict(sends=per_step, losses=losses,
                keys=len(pl.__dict__["_p2p_metas"]))


def case_other_axis_refused(rank):
    """A mesh with another axis above 1 is refused by PipelineParallel."""
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"dp": 2, "pp": n // 2})
    pl = _pipeline(deep_spec(), 7)
    try:
        fleet.PipelineParallel(pl)
        return None
    except NotImplementedError as e:
        return str(e)


# the SPMD pipeline -------------------------------------------------------------
def _body(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def case_spmd_forward(rank):
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"pp": n})
    out = {}
    for v, M in SPMD_FWD:
        Ws, bs = spmd_params(v, n, v * 10 + M)
        xs = np.random.RandomState(M).randn(M, 2, 8).astype(np.float32)
        with torch.no_grad():
            got = fleet.pipeline_spmd(
                _body, {"W": _t(Ws.reshape(v, n, 8, 8)),
                        "b": _t(bs.reshape(v, n, 8))}, _t(xs),
                num_virtual_stages=v)
        out[(v, M)] = _np(got)
    return out


def case_spmd_grad(rank):
    """The gradients of ``mean(out**2)`` (v 2, M 4): this stage's slice of
    the stacked parameters and the inputs' (summed over pp)."""
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"pp": n})
    v, M = 2, 4
    Ws, bs = spmd_params(v, n, 3)
    W = _t(Ws.reshape(v, n, 8, 8), grad=True)
    b = _t(bs.reshape(v, n, 8), grad=True)
    xs = _t(np.random.RandomState(3).randn(M, 2, 8).astype(np.float32),
            grad=True)
    out = fleet.pipeline_spmd(_body, {"W": W, "b": b}, xs,
                              num_virtual_stages=v)
    (out ** 2).mean().backward()
    return dict(out=_np(out), dW=_np(W.grad[:, rank]), db=_np(b.grad[:, rank]),
                dx=_np(xs.grad),
                others_zero=bool((W.grad[:, [s for s in range(n)
                                             if s != rank]] == 0).all()))


def case_spmd_pytree(rank):
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"pp": n})
    Ws, _ = spmd_params(1, n, 5)

    def body(p, xy):
        x, aux = xy
        x2 = torch.tanh(x @ p["W"])
        return (x2, aux + x2.sum(-1))
    xs = np.random.RandomState(5).randn(4, 2, 8).astype(np.float32)
    with torch.no_grad():
        o, aux = fleet.pipeline_spmd(
            body, {"W": _t(Ws.reshape(1, n, 8, 8))},
            (_t(xs), torch.zeros(4, 2)))
    return dict(out=_np(o), aux=_np(aux))


def _block():
    from paddle_tpu_torch import nn
    return nn.Sequential(nn.Linear(8, 8), nn.Tanh())


def case_spmd_engine(rank):
    """``SpmdPipelineParallel`` (v 2, M 4, AdamW): losses, stats, the full
    stacked state on every rank, and ``eval_batch``."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    n = _world()
    _mesh({"pp": n})
    pl = fleet.SpmdPipelineLayer(_block, num_virtual_stages=2,
                                 loss_fn=nn.MSELoss(), device="cpu")
    pl.set_state_dict(spmd_layer_state(2, n, 0))
    eng = fleet.SpmdPipelineParallel(pl, accumulate_steps=4)
    o = AdamW(learning_rate=3e-3, parameters=eng.parameters())
    rng = np.random.RandomState(0)
    X = rng.randn(8, 8).astype(np.float32)
    Y = (rng.randn(8, 8) * 0.1).astype(np.float32)
    losses = [float(eng.train_batch((_t(X), _t(Y)), o)) for _ in range(5)]
    state = {k: _np(v) for k, v in pl.state_dict().items()}
    local = {k: tuple(p.shape) for k, p in pl.named_parameters()}
    return dict(losses=losses, stats=eng.last_schedule_stats, state=state,
                local=local, eval=float(eng.eval_batch((_t(X), _t(Y)))))


def case_spmd_build(rank):
    """What each stage keeps of the chunks it builds: ``SpmdPipelineLayer``
    (v 2) and the hetero layer (4 chunks) under one seed, against every
    chunk built whole in order under the same seed; where their
    templates' parameters live."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    n = _world()
    _mesh({"pp": n})
    paddle.seed(11)
    pl = fleet.SpmdPipelineLayer(_block, num_virtual_stages=2, device="cpu")
    paddle.seed(11)
    whole = [_block() for _ in range(2 * n)]
    v = 4 // n
    paddle.seed(12)
    hl = fleet.SpmdHeteroPipelineLayer(
        HETERO, num_virtual_stages=v, device="cpu",
        shared_factory=lambda: nn.Linear(8, 8))
    paddle.seed(12)
    hwhole = [f() for f in HETERO]
    own_flat = [torch.cat([p.detach().reshape(-1)
                           for p in hwhole[r * n + rank].parameters()])
                for r in range(v)]
    blocks = hl.__dict__["_blocks"]
    return dict(
        local={k: _np(p) for k, p in pl.named_parameters()},
        whole={k: np.stack([_np(p) for p in
                            (dict(b.named_parameters())[k.replace("__", ".")]
                             for b in whole)]) for k in ("0__weight",
                                                         "0__bias")},
        template=sorted({p.device.type for p in
                         pl.__dict__["_template"].parameters()}),
        trunk=_np(hl.trunk_flat), own_flat=[_np(f) for f in own_flat],
        blocks=[None if b is None else sorted(
            {p.device.type for p in (b.block if hasattr(b, "shared")
                                     else b).parameters()})
            for b in blocks])


def case_spmd_train_step(rank):
    """``TrainStep(mesh=)`` over an ``SpmdPipelineLayer``: pp alone and,
    at 4 ranks, dp 2 x pp 2 with the micro-batches split over dp."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import P, fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    n = _world()
    mse = nn.MSELoss()

    def loss_fn(m, x, y):
        return mse(m(x).reshape(-1, 8), y.reshape(-1, 8))
    rng = np.random.RandomState(2)
    Xm = rng.randn(4, 4, 8).astype(np.float32)
    Ym = rng.randn(4, 4, 8).astype(np.float32)
    out = {}
    plans = [("pp", {"pp": n}, 1, None)]
    if n == 4:
        plans.append(("dp_pp", {"dp": 2, "pp": 2}, 2, P(None, "dp")))
    for name, shape, v, spec in plans:
        mesh = _mesh(shape)
        pl = fleet.SpmdPipelineLayer(_block, num_virtual_stages=v,
                                     device="cpu")
        pl.set_state_dict(spmd_layer_state(v, shape["pp"], 2))
        o = AdamW(learning_rate=1e-3, parameters=pl.parameters())
        step = TrainStep(pl, loss_fn, o, mesh=mesh, input_spec=spec)
        out[name] = [float(step(_t(Xm), _t(Ym))) for _ in range(3)]
    return out


def case_converter_resume(rank):
    """The host engine and the SPMD engine resume each other through the
    converters (reference tests/test_spmd_pipeline.py:329-363): 2 steps,
    convert, 2 more, against 4 uninterrupted."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.auto_parallel import (
        pipeline_state_to_spmd, spmd_state_to_pipeline)
    from paddle_tpu_torch.optimizer import SGD
    n = _world()
    _mesh({"pp": n})
    v, micro = 2, 8
    rng = np.random.RandomState(42)
    data = [(_t(rng.randn(micro, 8).astype(np.float32)),
             _t(rng.randn(micro, 8).astype(np.float32))) for _ in range(4)]

    def spmd():
        spl = fleet.SpmdPipelineLayer(_block, num_virtual_stages=v,
                                      loss_fn=nn.MSELoss(), device="cpu")
        spl.set_state_dict(spmd_layer_state(v, n, 21))
        eng = fleet.SpmdPipelineParallel(spl, accumulate_steps=micro)
        return spl, eng, SGD(learning_rate=0.1, parameters=eng.parameters())

    def host():
        pl = fleet.PipelineLayer([fleet.LayerDesc(_block)
                                  for _ in range(n * v)],
                                 num_virtual_pipeline_stages=v,
                                 loss_fn=nn.MSELoss(), device="cpu")
        pl.set_state_dict(spmd_state_to_pipeline(
            spmd_layer_state(v, n, 23), n, v, block_is_container=False))
        eng = fleet.PipelineParallel(pl, accumulate_steps=micro)
        return pl, eng, SGD(learning_rate=0.1, parameters=eng.parameters())

    def host_state(pl):
        # each stage holds its own layers (as Paddle's): merge them
        parts = []
        dist.all_gather_object(parts, {k: _np(t) for k, t in
                                       pl.state_dict().items()})
        return {k: val for d in parts for k, val in d.items()}

    _, eng, o = spmd()
    s_full = [float(eng.train_batch(d, o)) for d in data]
    spl, eng, o = spmd()
    s_part = [float(eng.train_batch(d, o)) for d in data[:2]]
    pl, heng, ho = host()
    pl.set_state_dict(spmd_state_to_pipeline(spl.state_dict(), n, v,
                                             block_is_container=False))
    s_resumed = [float(heng.train_batch(d, ho)) for d in data[2:]]

    pl, heng, ho = host()
    h_full = [float(heng.train_batch(d, ho)) for d in data]
    pl, heng, ho = host()
    h_part = [float(heng.train_batch(d, ho)) for d in data[:2]]
    spl, eng, o = spmd()
    spl.set_state_dict(pipeline_state_to_spmd(host_state(pl), n, v,
                                              block_is_container=False))
    h_resumed = [float(eng.train_batch(d, o)) for d in data[2:]]
    return dict(s_full=s_full, s_part=s_part, s_resumed=s_resumed,
                h_full=h_full, h_part=h_part, h_resumed=h_resumed)


class _SharedUserBlock(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        from paddle_tpu_torch import nn
        self.fc = nn.Linear(d, d)

    def forward(self, x, shared):
        return torch.tanh(self.fc(shared(x)))


class _PlainBlock(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        from paddle_tpu_torch import nn
        self.fc = nn.Linear(d, d)

    def forward(self, x):
        return torch.tanh(self.fc(x))


HETERO = [_SharedUserBlock, _PlainBlock, _PlainBlock, _SharedUserBlock]


def case_hetero_tied(rank):
    """A tied ``Linear`` used by the first and the last chunk (4 chunks:
    S x v = 4): the loss, this stage's trunk gradient, the shared
    layer's gradient (summed over pp), each chunk's state, and two SGD
    steps' losses."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    n = _world()
    _mesh({"pp": n})
    v = 4 // n
    hl = fleet.SpmdHeteroPipelineLayer(
        HETERO, num_virtual_stages=v, device="cpu",
        shared_factory=lambda: nn.Linear(8, 8))
    hl.set_state_dict(hetero_state(v, n, 33))
    chunks = [hl.chunk_state_dict(c) for c in range(4)]
    rng = np.random.RandomState(33)
    o = SGD(learning_rate=0.05, parameters=hl.parameters())
    losses, grads = [], None
    for step in range(2):
        X = rng.randn(4, 2, 8).astype(np.float32)
        out = hl(_t(X))
        loss = (out * out).mean()
        loss.backward()
        if step == 0:
            grads = dict(trunk=_np(hl.trunk_flat.grad),
                         shared_w=_np(hl.shared.weight.grad),
                         shared_b=_np(hl.shared.bias.grad))
        o.step()
        o.clear_grad()
        losses.append(float(loss))
    return dict(chunks=chunks, losses=losses, **grads)


def gloo_staging_rank(out_dir, device):
    """The body of the card test of gloo's host staging, run by
    ``distributed.spawn`` on two ranks: ``send``/``recv``,
    ``p2p_shift``, ``all_gather`` and ``all_to_all`` over gloo on
    tensors on ``device`` ("cuda" or "cpu"), in f32 and bf16; writes
    the results (as f32 numpy) and whether the calls staged."""
    import pickle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.observability.comm import comm_totals
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_parallel_env(backend="gloo")
    r = dist.get_rank()
    res = {}
    bytes0 = comm_totals()["comm_bytes_total"]
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt)[6:]
        x = (torch.arange(24, dtype=torch.float32).reshape(4, 6) +
             100 * r).to(device, dt)
        got = torch.empty_like(x)
        if r == 0:
            dist.send(x, dst=1)
            dist.recv(got, src=1)
        else:
            dist.recv(got, src=0)
            dist.send(x, dst=0)
        res["send_recv", key] = got
        res["p2p_shift", key] = dist.p2p_shift(x)
        res["all_gather", key] = dist.all_gather(x)
        parts = []
        dist.all_gather(parts, x)
        res["all_gather_list", key] = torch.cat(parts)
        res["all_to_all", key] = dist.all_to_all(x, split_axis=1,
                                                 concat_axis=0)
        assert all(t.device.type == device and t.dtype == dt
                   for t in (got, res["p2p_shift", key]))
    out = {k: v.float().cpu().numpy() for k, v in res.items()}
    out["staged"] = C.staged(C._resolve(None)[0],
                             torch.zeros(1, device=device))
    out["bytes"] = comm_totals()["comm_bytes_total"] - bytes0
    with open(os.path.join(out_dir, f"{device}{r}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


SUITES = {
    "sp": [case_ring, case_ulysses, case_scatter_gather, case_sp_refusals],
    "pp": [case_pipeline_layer, case_schedules, case_shared_desc,
           case_tuple_activations, case_eval_and_spans,
           case_boundary_handshake],
    "spmd": [case_spmd_forward, case_spmd_grad, case_spmd_pytree,
             case_spmd_engine, case_spmd_build, case_spmd_train_step,
             case_converter_resume, case_hetero_tied],
}
#: the 4-rank pipeline world also holds a mesh with another axis
SUITES["pp4"] = SUITES["pp"] + [case_other_axis_refused]


if __name__ == "__main__":
    import paddle_tpu_torch as _paddle
    _paddle.set_device("cpu")
    sys.exit(W.main(sys.argv[1:], SUITES))
