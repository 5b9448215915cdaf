"""The port's Mixture-of-Experts layer and MoE language model against the
JAX package's, on the CPU.

Weights cross through numpy (``state_dict_from_jax`` ->
``load_numpy_state``); inputs are made with numpy. ``MoELayer``: every
gate at top-1/2/4 with capacity drops, both dispatch modes at a tight and
an ample capacity, and ``token_mask``. The routing picks and the kept
assignments must be exactly equal (a zero row of input makes an exact
tie among all experts, which both must break toward the lower index);
outputs and ``l_aux`` match at rtol 1e-5 / atol 1e-6, the reference's own
ragged-vs-dense tolerance (``tests/test_moe.py``), and the gradients of
the input and of every weight at rtol 1e-4 / atol 1e-6. ``MoeForCausalLM``
(the tiny preset): logits, both loss routes with every gradient, and
three ``TrainStep`` steps of AdamW with a global-norm clip, after which
every parameter and moment must match, as ``tests/test_torch_train.py``
holds the Llama model. Everything is float32.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as pt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.mesh import mesh_scope
from paddle_tpu.models import moe as jmoe
from paddle_tpu_torch.distributed.fleet import MoELayer
from paddle_tpu_torch.distributed.fleet.moe import route
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.bridge import (load_numpy_state, numpy_state,
                                           optimizer_state_to_numpy)

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
D, HID, E = 16, 32, 8


@pytest.fixture(autouse=True)
def no_global_mesh():
    """The JAX layer shards its experts on a global mesh that another test
    of the same worker may have left behind; these tests run without."""
    with mesh_scope(None):
        yield


def _np(t):
    return np.asarray(t.data if hasattr(t, "data") else t)


def _layers(gate, top_k, cf, mode, seed):
    """The JAX layer with random weights (biases too) and its port twin."""
    pt.seed(seed)
    jm = jfleet.MoELayer(D, HID, num_experts=E, gate=gate, top_k=top_k,
                         capacity_factor=cf, dispatch_mode=mode)
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        if name in ("b1", "b2"):
            p.set_value(0.1 * rng.randn(*p.shape).astype(np.float32))
    tm = MoELayer(D, HID, E, gate=gate, top_k=top_k, capacity_factor=cf,
                  dispatch_mode=mode, device="cpu")
    load_numpy_state(tm, state_dict_from_jax(jm))
    return jm, tm


def _jax_routing(jm, x, mask, monkeypatch):
    """The JAX layer's top-k picks and, in ragged mode, its token->slot
    map (kept assignments hold ``e*C + position``, dropped ones ``E*C``),
    recorded from a forward without gradients."""
    seen = {}
    top_k = jax.lax.top_k

    def record_top_k(a, k):
        vals, idx = top_k(a, k)
        seen["idx_k"] = np.asarray(idx)
        return vals, idx
    monkeypatch.setattr(jax.lax, "top_k", record_top_k)
    moves = jfleet.moe._ragged_moves

    def record_moves(n_slots):
        dispatch, combine = moves(n_slots)

        def rec_dispatch(xt, slot_src, slots_stack):
            seen["slots"] = np.asarray(slots_stack)
            return dispatch(xt, slot_src, slots_stack)
        return rec_dispatch, combine
    monkeypatch.setattr(jfleet.moe, "_ragged_moves", record_moves)
    with pt.no_grad():
        jm(pt.to_tensor(x), **({} if mask is None else
                              {"token_mask": pt.to_tensor(mask)}))
    monkeypatch.undo()
    return seen


def _compare(gate, top_k, cf, mode, monkeypatch, mask=None, seed=0):
    jm, tm = _layers(gate, top_k, cf, mode, seed)
    rng = np.random.RandomState(seed + 100)
    x = rng.randn(2, 12, D).astype(np.float32)
    x[1, 5] = 0.0  # uniform probabilities: an exact tie among all experts
    proj = rng.randn(2, 12, D).astype(np.float32)
    kw_j = {} if mask is None else {"token_mask": pt.to_tensor(mask)}
    kw_t = {} if mask is None else {"token_mask": torch.from_numpy(mask)}

    seen = _jax_routing(jm, x, mask, monkeypatch)
    K = tm.gate.top_k
    valid = None if mask is None else torch.from_numpy(mask).reshape(-1)
    r = route(torch.from_numpy(x).reshape(-1, D), tm.gate.weight, K, cf,
              valid)
    np.testing.assert_array_equal(r.idx_k.numpy(), seen["idx_k"])
    assert list(r.idx_k[12 + 5].numpy()) == list(range(K))
    if mode == "ragged":
        C = r.capacity
        slots = torch.where(r.kept, r.idx_k.t() * C + r.pos,
                            torch.full_like(r.pos, E * C))
        np.testing.assert_array_equal(slots.numpy(), seen["slots"])

    xj = pt.to_tensor(x, stop_gradient=False)
    yj = jm(xj, **kw_j)
    lj = (yj * pt.to_tensor(proj)).sum() + jm.l_aux
    lj.backward()
    xt = torch.from_numpy(x).requires_grad_()
    yt = tm(xt, **kw_t)
    ((yt * torch.from_numpy(proj)).sum() + tm.l_aux).backward()

    np.testing.assert_allclose(yt.detach().numpy(), _np(yj), **FWD_TOL)
    np.testing.assert_allclose(float(tm.l_aux.detach()),
                               float(_np(jm.l_aux)), **FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _np(xj.grad), **GRAD_TOL)
    jgrads = {n: _np(p.grad) for n, p in jm.named_parameters()}
    tgrads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], err_msg=n,
                                   **GRAD_TOL)
    return tm, r, yt.detach()


@pytest.mark.parametrize("gate", ["naive", "switch", "gshard"])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_gates_with_capacity_drops_match_jax(gate, top_k, monkeypatch):
    """Ragged dispatch at capacity factor 0.5: assignments drop, and the
    gates are renormalised over the kept ones."""
    tm, r, _ = _compare(gate, top_k, 0.5, "ragged", monkeypatch,
                     seed=top_k + 10 * len(gate))
    n_dropped = int((~r.kept).sum())
    assert n_dropped > 0 and int(tm.last_dropped) == n_dropped
    assert tm.last_capacity == max(int(0.5 * 24 * top_k / E), 1)


@pytest.mark.parametrize("mode,cf", [("dense", 0.5), ("dense", 8.0),
                                     ("ragged", 8.0)])
def test_dispatch_modes_match_jax(mode, cf, monkeypatch):
    _, r, _ = _compare("gshard", 2, cf, mode, monkeypatch, seed=3)
    assert bool(r.kept.all()) is (cf == 8.0)


@pytest.mark.parametrize("mode", ["ragged", "dense"])
def test_token_mask_matches_jax(mode, monkeypatch):
    """Masked tokens take the sentinel expert: no capacity, no count, no
    aux-loss weight, and a zero output row."""
    mask = np.ones((2, 12), bool)
    mask[0, 7:] = False
    mask[1, :3] = False
    _, r, y = _compare("gshard", 2, 0.5, mode, monkeypatch, mask=mask,
                       seed=4)
    masked = ~torch.from_numpy(mask)
    assert int(r.counts.sum()) == 2 * int(mask.sum())
    assert not bool(r.kept[:, masked.reshape(-1)].any())
    assert bool((y[masked] == 0).all())


def test_layer_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        MoELayer(D, HID, E, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="dispatch_mode"):
        MoELayer(D, HID, E, dispatch_mode="scatter", device="cpu")


# ------------------------------ the MoE model -------------------------------
def _models(seed, **kw):
    pt.seed(seed)
    jm = jmoe.MoeForCausalLM(jmoe.MoeConfig.tiny(**kw))
    tm = MoeForCausalLM(MoeConfig.tiny(**kw), device="cpu")
    load_numpy_state(tm, state_dict_from_jax(jm))
    return jm, tm


def test_parameter_names_bridge_unchanged():
    """The port's names are the reference's (no ``model.`` prefix), and a
    JAX state dict round-trips byte for byte."""
    jm, tm = _models(30)
    state = state_dict_from_jax(jm)
    assert "layers.1.mlp.w1" in state and "lm_head.weight" in state
    assert "layers.1.shared_expert.gate_proj.weight" in state
    back = numpy_state(tm)
    assert sorted(back) == sorted(state)
    assert all(back[n].tobytes() == state[n].tobytes() for n in state)


@pytest.mark.parametrize("route_", ["logits_ce", "fused_ce"])
def test_loss_and_every_gradient_match_jax(route_):
    """Vocab 128: cross entropy over the logits; vocab 32768: the fused
    chunked CE on the untied head. Both add the aux loss; -100 labels are
    ignored."""
    kw = {"vocab_size": 32768} if route_ == "fused_ce" else {}
    jm, tm = _models(31, **kw)
    ids = np.random.RandomState(5).randint(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = ids.copy()
    labels[0, 4:9] = -100
    if route_ == "logits_ce":
        ref = _np(jm(pt.to_tensor(ids)))
        with torch.no_grad():
            logits = tm(torch.from_numpy(ids))
        np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    _, jl = jm(pt.to_tensor(ids), labels=pt.to_tensor(labels))
    jl.backward()
    out, tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tl.backward()
    assert out is None
    np.testing.assert_allclose(float(tl.detach()), float(_np(jl)), rtol=1e-5)
    jg = {n: _np(p.grad) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n], err_msg=n,
                                   **GRAD_TOL)
    aux = tm.aux_loss()
    assert aux is not None and float(aux.detach()) > 0
    tm.clear_decode_side_effects()
    assert tm.aux_loss() is None


def test_three_train_steps_match_jax():
    """AdamW (lr 1e-4) with a global-norm clip of 1.0 through TrainStep
    in both packages: the loss at rtol 1e-5, parameters and moments at
    rtol 1e-4, atol 1e-6."""
    jm, tm = _models(32)
    ids = np.random.RandomState(6).randint(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)

    def loss(m, x):
        return m(x, labels=x)[1]
    jopt = pt.optimizer.AdamW(learning_rate=1e-4,
                              parameters=jm.parameters(),
                              grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    jstep = pt.jit.TrainStep(jm, loss, jopt)
    topt = AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, loss, topt)
    for _ in range(3):
        jl = float(_np(jstep(pt.to_tensor(ids))))
        np.testing.assert_allclose(float(tstep(torch.from_numpy(ids))), jl,
                                   rtol=1e-5)
    jstate = state_dict_from_jax(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jstate[n],
                                   err_msg=n, **GRAD_TOL)
    jsd = {k: (v if isinstance(v, int) else _np(v))
           for k, v in jopt.state_dict().items()}
    tsd = optimizer_state_to_numpy(topt)
    assert sorted(tsd) == sorted(jsd) and tsd["@step_count"] == 3
    for key in jsd:
        if key != "@step_count":
            np.testing.assert_allclose(tsd[key], jsd[key], err_msg=key,
                                       **GRAD_TOL)


def test_model_refuses_what_is_not_ported():
    tm = MoeForCausalLM(MoeConfig.tiny(), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="not ported"):
        tm(ids, caches=[None, None])
    with pytest.raises(NotImplementedError, match="not ported"):
        tm.generate(ids)
    with pytest.raises(NotImplementedError, match="not ported"):
        MoeForCausalLM(MoeConfig.tiny(tensor_parallel=True), device="cpu")
    with pytest.raises(ValueError, match="length >= 2"):
        tm(ids[:, :1], labels=ids[:, :1])
