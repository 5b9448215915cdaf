"""One rank of the port's expert-parallel and tensor-parallel serving
tests (gloo on the CPU).

    python tests/torch_ep_worker.py SUITE RANK WORLD HOST:PORT OUTDIR

Started by ``torch_dist_worker.Ranks(suite, world, script=...)``; each
rank pickles ``{case: result}`` into ``OUTDIR/SUITE.rank<RANK>.pkl``.
The suites, each for a world of 2:

* ``ep`` — ``MoELayer`` on ``{"ep": 2}`` in both token layouts (the
  batch whole on every rank, and its rows split over ``ep``) for every
  gate, at a capacity where drops occur, with a token mask, and where
  ``ep`` does not divide the experts; then the tiny ``MoeForCausalLM``
  through ``TrainStep(mesh=)`` at ep 2 in both layouts and with
  ``tensor_parallel=True`` on ``{"mp": 2}``;
* ``tps`` — ``ServingEngine(mesh=)`` on ``{"mp": 2}``: the tiny
  tensor-parallel Llama (plain and ``int8_wo``), a model served whole,
  the tiny tensor-parallel MoE, one request through ``Server`` on the
  driver, the refusals, and a driver that idles past the group's
  collective timeout before it serves.

The data and weights come from the helpers below, which the tests call
too, so the JAX package sees the same numbers. This file imports neither
``jax`` nor ``paddle_tpu``.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

# -- data shared with the tests ----------------------------------------------
D, HID = 16, 32
#: (name, gate, top_k, capacity_factor, dispatch_mode, experts, masked)
LAYER_CASES = [
    ("gshard", "gshard", 2, 1.25, "ragged", 8, False),
    ("gshard_dense", "gshard", 2, 1.25, "dense", 8, False),
    ("switch", "switch", 1, 1.25, "ragged", 8, False),
    ("naive", "naive", 2, 1.25, "ragged", 8, False),
    ("gshard_cf1", "gshard", 2, 1.0, "ragged", 8, False),
    ("switch_cf1_dense", "switch", 1, 1.0, "dense", 8, False),
    ("masked_cf1", "gshard", 2, 1.0, "ragged", 8, True),
    ("replicated", "gshard", 2, 1.0, "ragged", 5, False),
]
LAYOUTS = ("whole", "rows")
MOE_TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                moe_intermediate_size=32, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=2,
                num_experts=4, num_experts_per_tok=2,
                num_shared_experts=1, first_k_dense_replace=1)
MOE_LR = 1e-2
MOE_STEPS = 3
#: the serving model: the reference test's tiny tied Llama
# (tests/test_prefix_cache.py:25-33)
SERVE_LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   tie_word_embeddings=True)
SERVE_MOE = dict(MOE_TINY, num_attention_heads=4, num_key_value_heads=2)
SERVE_KW = dict(max_batch=2, max_blocks=16, block_size=4, prefill_chunk=4)
SERVE_NEW = 6


def layer_weights(E, seed) -> dict:
    """Numpy weights of a ``MoELayer(D, HID, E)``: a gate, expert stacks
    at the reference's init ranges, and non-zero biases."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return {"gate.weight": (0.5 * rng.randn(D, E)).astype(f),
            "w1": rng.uniform(-D ** -0.5, D ** -0.5, (E, D, HID)).astype(f),
            "b1": (0.1 * rng.randn(E, HID)).astype(f),
            "w2": rng.uniform(-HID ** -0.5, HID ** -0.5,
                              (E, HID, D)).astype(f),
            "b2": (0.1 * rng.randn(E, D)).astype(f)}


def layer_inputs(seed):
    """``x`` [2, 12, D], the loss projection and a token mask."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 12, D).astype(np.float32)
    proj = rng.randn(2, 12, D).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[0, 8:] = False
    mask[1, :2] = False
    return x, proj, mask


def moe_state(cfg_kw, seed=0) -> dict:
    """The numpy weights of a one-device port ``MoeForCausalLM``."""
    from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.utils.bridge import numpy_state
    return numpy_state(MoeForCausalLM(MoeConfig(**cfg_kw), device="cpu",
                                      seed=seed))


def moe_batches(n=MOE_STEPS, B=4, S=16, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, MOE_TINY["vocab_size"], (B, S)).astype(np.int64)
            for _ in range(n)]


def serve_prompts(seed=5):
    """Three prompts; the third shares the first's first 8 tokens (two
    whole blocks), so the prefix cache and copy-on-write take part."""
    rng = np.random.RandomState(seed)
    a, b = [[int(t) for t in rng.randint(1, 128, n)] for n in (9, 6)]
    return [a, b, a[:8] + [int(t) for t in rng.randint(1, 128, 3)]]


def llama_serve_state(seed=11) -> dict:
    """The serving Llama's weights: the port's seeded init with every
    matrix scaled to std 0.5, so greedy streams vary token to token (at
    the init's std of 0.02 they repeat one token)."""
    return {k: v * 25.0 if v.ndim == 2 else v
            for k, v in W.llama_state(SERVE_LLAMA, seed).items()}


# -- the expert-parallel layer ------------------------------------------------
def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layer_case(case, layout, mesh, group):
    """One forward and backward of the layer: ``sum(y * proj) + l_aux``
    over the global batch. Under ``rows`` each rank runs its row of the
    batch inside ``splitting_batch`` and back-propagates its share of the
    global aux; what comes back is global (rows and partial gradients
    gathered or summed over ``ep``), with the routing the layer used."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.collective import gather_block
    from paddle_tpu_torch.distributed.fleet import MoELayer
    from paddle_tpu_torch.distributed.fleet import moe as moe_mod
    from paddle_tpu_torch.distributed.parallel import splitting_batch
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    name, gate, top_k, cf, mode, E, masked = case
    m = MoELayer(D, HID, E, gate=gate, top_k=top_k, capacity_factor=cf,
                 dispatch_mode=mode, device="cpu", mesh=mesh)
    load_numpy_state(m, layer_weights(E, 7))
    x, proj, mask = layer_inputs(8)
    seen = {}
    route, split = moe_mod.route, moe_mod._route_split

    def keep(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            seen["r"] = out[0] if isinstance(out, tuple) and \
                isinstance(out[0], moe_mod.Routing) else out
            return out
        return run
    moe_mod.route, moe_mod._route_split = keep(route), keep(split)
    try:
        rank = dist.get_rank()
        if layout == "rows":
            rows = slice(rank, rank + 1)
            xs = _t(x[rows]).requires_grad_(True)
            with splitting_batch(("ep",), ("ep",)):
                y = m(xs, token_mask=_t(mask[rows]) if masked else None)
            share = 1.0 / group.nranks
            pr = _t(proj[rows])
        else:
            xs = _t(x).requires_grad_(True)
            y = m(xs, token_mask=_t(mask) if masked else None)
            share, pr = 1.0, _t(proj)
        ((y * pr).sum() + m.l_aux * share).backward()
    finally:
        moe_mod.route, moe_mod._route_split = route, split
    r = seen["r"]
    C = r.capacity
    slots = torch.where(r.kept, r.idx_k.t() * C + r.pos,
                        torch.full_like(r.pos, E * C))
    out = {"y": y.detach(), "dx": xs.grad, "slots": slots}
    if layout == "rows":
        out = {k: dist.all_gather(v.contiguous(), group=group,
                                  axis=1 if k == "slots" else 0)
               for k, v in out.items()}
    grads = {}
    for n, p in m.named_parameters():
        g = p.grad
        spec = getattr(p, "_sharding_spec", None)
        if spec is not None:
            g = gather_block(g.contiguous(), spec, mesh)
        elif layout == "rows":
            g = dist.all_reduce(g.clone(), group=group)
        grads[n] = g.numpy()
    out = {k: v.numpy() for k, v in out.items()}
    out.update(grads=grads, l_aux=float(m.l_aux), capacity=C,
               dropped=int(m.last_dropped), sharded=m.sharded,
               local_experts=int(m.w1.shape[0]),
               specs={n: getattr(p, "_sharding_spec", None)
                      for n, p in m.named_parameters()})
    return out


def case_ep_layer(r):
    import paddle_tpu_torch.distributed as dist
    mesh = dist.init_mesh({"ep": 2})
    group = dist.Group("ep", mesh)
    return {f"{c[0]}/{layout}": _layer_case(c, layout, mesh, group)
            for c in LAYER_CASES for layout in LAYOUTS}


def case_ep_init(r):
    """An ep-sharded layer's seeded init keeps this rank's block of the
    one-device layer's draws."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import MoELayer
    from paddle_tpu_torch.utils.bridge import numpy_state
    mesh = dist.init_mesh({"ep": 2})
    ep = MoELayer(D, HID, 8, device="cpu", seed=3, mesh=mesh)
    one = MoELayer(D, HID, 8, device="cpu", seed=3)
    return {"local": tuple(ep.w1.shape), "full": numpy_state(ep),
            "one": numpy_state(one)}


# -- the MoE model through TrainStep ------------------------------------------
def _moe_run(cfg_kw, mesh, input_spec):
    """Losses, global norms, each step's drops of the routed layer and
    the gradient reductions of MOE_STEPS TrainSteps."""
    from paddle_tpu_torch.distributed.collective import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.bridge import load_numpy_state, numpy_state
    model = MoeForCausalLM(MoeConfig(**cfg_kw), device="cpu")
    load_numpy_state(model, moe_state({**cfg_kw, "tensor_parallel": False}))
    opt = AdamW(learning_rate=MOE_LR, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, lambda m, x: m(x, labels=x)[1], opt, mesh=mesh,
                     input_spec=None if input_spec is None
                     else P(*input_spec))
    losses, norms, dropped = [], [], []
    for ids in moe_batches():
        losses.append(float(step(_t(ids))))
        norms.append(float(step.last_grad_norm))
        dropped.append(int(model.layers[1].mlp.last_dropped))
    plan = step._mesh_plan
    return {"losses": losses, "norms": norms, "dropped": dropped,
            "reduce_axes": {n: plan.reduce_axes(n) for n in plan._params},
            "buckets": None if plan.comm_buckets is None
            else [list(b) for b in plan.comm_buckets],
            "state": numpy_state(model)}


def case_ep_model(r):
    import paddle_tpu_torch.distributed as dist
    mesh = dist.init_mesh({"ep": 2})
    return {layout: _moe_run(MOE_TINY, mesh, spec)
            for layout, spec in (("rows", ("ep",)), ("whole", ()))}


def case_plan_frees_its_model(r):
    """A bucketed ``TrainStep(mesh=)`` that goes out of scope frees its
    model: its gradient hooks hold the plan weakly."""
    import gc
    import weakref
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.collective import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    mesh = dist.init_mesh({"ep": 2})

    def run():
        m = MoeForCausalLM(MoeConfig(**MOE_TINY), device="cpu")
        step = TrainStep(m, lambda mm, x: mm(x, labels=x)[1],
                         AdamW(parameters=m.parameters()), mesh=mesh,
                         input_spec=P("ep"), bucketed=True)
        step(_t(moe_batches(1)[0]))
        return weakref.ref(m), weakref.ref(step._mesh_plan)
    refs = run()
    gc.collect()
    return [r() is None for r in refs]


def case_mp_model(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
    mesh = dist.init_mesh({"mp": 2})
    out = {"mp": _moe_run(dict(MOE_TINY, tensor_parallel=True), mesh,
                          None)}
    m = MoeForCausalLM(MoeConfig(**dict(MOE_TINY, tensor_parallel=True)),
                       device="cpu")
    att = m.layers[0].self_attn
    out["heads"] = (att.n_heads, att.n_kv)
    # a row-split block owns its storage, not the full weight's
    w = att.o_proj.weight
    out["o_proj_storage"] = (w.untyped_storage().nbytes(),
                             w.numel() * w.element_size())
    out["shared_spec"] = m.layers[1].shared_expert.gate_proj.weight \
        ._sharding_spec
    out["expert_sharded"] = m.layers[1].mlp.sharded
    return out


# -- tensor-parallel serving ----------------------------------------------------
def _engine(model, mesh, **kw):
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, device="cpu", mesh=mesh,
                         **dict(SERVE_KW, **kw))


def _serve(eng, prompts):
    """Every rank calls it: the driver submits and steps, the followers
    follow; the streams (driver) and the engine's own figures. First the
    driver takes a step of padding only (``memory_report``'s), which its
    followers take with it and which must change nothing."""
    if eng.is_driver:
        eng._zero_work_step()
    handles = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts] \
        if eng.is_driver else []
    eng.run_until_idle()
    streams = [h.result(60)["token_ids"] for h in handles]
    eng.cache.allocator.assert_no_leaks()
    st = eng.stats()
    return {"streams": streams, "tensor_parallel": st["tensor_parallel"],
            "steps": eng.steps, "driver": eng.is_driver,
            "pool_heads": int(eng.cache.k_pools[0].shape[2]),
            "prefix_hits": (st["prefix_cache"] or {}).get("hits")}


def _tp_llama(mesh, tensor_parallel=True, **cfg):
    """The serving Llama on this rank (its weights loaded unless ``cfg``
    changes its shapes)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    model = LlamaForCausalLM(LlamaConfig(**dict(
        SERVE_LLAMA, tensor_parallel=tensor_parallel, **cfg)), device="cpu")
    if not cfg:
        load_numpy_state(model, llama_serve_state())
    return model


def case_tp_serve(r):
    import warnings
    import paddle_tpu_torch.distributed as dist
    mesh = dist.init_mesh({"mp": 2})
    prompts = serve_prompts()
    out = {"plain": _serve(_engine(_tp_llama(mesh), mesh), prompts),
           "int8_wo": _serve(_engine(_tp_llama(mesh), mesh,
                                     quantize="int8_wo"), prompts)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        whole = _engine(_tp_llama(mesh, tensor_parallel=False), mesh)
    out["whole_warning"] = [str(w.message) for w in caught
                            if w.category is RuntimeWarning]
    out["whole"] = _serve(whole, prompts)
    # a follower refuses what only the driver does
    eng = _engine(_tp_llama(mesh), mesh)
    if not eng.is_driver:
        try:
            eng.submit([1, 2, 3])
            out["follower_submit"] = "accepted"
        except RuntimeError as e:
            out["follower_submit"] = str(e)
    # what the mesh path does not port raises
    try:
        eng.export_kv_blocks([])
        out["handoff"] = "exported"
    except NotImplementedError as e:
        out["handoff"] = str(e)
    from paddle_tpu_torch import tuning
    try:
        _engine(tuning.apply_lora(_tp_llama(mesh, tensor_parallel=False),
                                  n_slots=2), mesh)
        out["lora"] = "built"
    except NotImplementedError as e:
        out["lora"] = str(e)
    try:
        _engine(_tp_llama(mesh, tensor_parallel=False,
                          num_key_value_heads=1), mesh)
        out["n_kv_check"] = "built"
    except ValueError as e:
        out["n_kv_check"] = str(e)
    return out


def case_tp_moe_serve(r):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    mesh = dist.init_mesh({"mp": 2})
    model = MoeForCausalLM(MoeConfig(**dict(SERVE_MOE, tensor_parallel=True)),
                           device="cpu")
    load_numpy_state(model, moe_state(SERVE_MOE, seed=2))
    return _serve(_engine(model, mesh), serve_prompts())


def case_tp_server(r):
    """One request through ``Server`` on the driver; the follower runs
    ``start()`` and ``shutdown()``."""
    import json
    import urllib.request
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.serving import Server
    mesh = dist.init_mesh({"mp": 2})
    eng = _engine(_tp_llama(mesh), mesh)
    if not eng.is_driver:
        eng.start()
        eng.shutdown()
        return {"driver": False, "steps": eng.steps}
    with Server(eng) as srv:
        req = urllib.request.Request(
            f"{srv.url}/generate",
            data=json.dumps({"prompt_ids": serve_prompts()[0],
                             "max_new_tokens": SERVE_NEW}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
    return {"driver": True, "token_ids": body["token_ids"],
            "steps": eng.steps}


def case_tp_idle(r):
    """Both ranks in ``start()`` with the ``mp`` group's collective
    timeout cut to 2 s: the driver idles 6 s, then serves one request.
    Without the driver's keep-alive words the follower's wait for the
    next step would fail at the timeout, and the driver's next step
    with it."""
    from datetime import timedelta
    from torch.distributed import distributed_c10d as c10d
    import paddle_tpu_torch.distributed as dist
    mesh = dist.init_mesh({"mp": 2})
    pg = mesh.get_group("mp")
    before = pg._get_backend(torch.device("cpu")).options._timeout
    c10d._set_pg_timeout(timedelta(seconds=2), pg)
    try:
        eng = _engine(_tp_llama(mesh), mesh)
        eng.start()
        toks = None
        if eng.is_driver:
            time.sleep(6)
            toks = eng.submit(serve_prompts()[0], max_new_tokens=SERVE_NEW
                              ).result(60)["token_ids"]
        eng.shutdown()
    finally:
        c10d._set_pg_timeout(before, pg)
    return {"token_ids": toks, "steps": eng.steps,
            "keepalive_s": eng._keepalive_s}


SUITES = {"ep": [case_ep_layer, case_ep_init, case_ep_model,
                 case_plan_frees_its_model, case_mp_model],
          "tps": [case_tp_serve, case_tp_moe_serve, case_tp_server,
                  case_tp_idle]}


if __name__ == "__main__":
    sys.exit(W.main(sys.argv[1:], SUITES))
