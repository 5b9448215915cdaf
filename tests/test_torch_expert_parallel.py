"""The port's expert parallelism against ``paddle_tpu``'s, on the CPU.

Two gloo ranks of ``tests/torch_ep_worker.py`` (suite ``ep``, started
once for the file) run ``MoELayer`` on ``{"ep": 2}`` and the tiny
``MoeForCausalLM`` through ``TrainStep(mesh=)``. The oracle is the JAX
package in this process on 2 of the conftest's virtual devices: its
layer with the expert stacks sharded on its ``{"ep": 2}`` mesh (GSPMD
turns the stacked einsums into the exchange), and its ``TrainStep`` over
that mesh with ``input_spec=P()`` (``tests/test_moe.py:106-124``), or
over ``{"mp": 2}`` for ``tensor_parallel=True``.

Both of the port's token layouts must give the reference's global
numbers: the batch whole on every rank (a partial combine all-reduced
over ``ep``) and its rows split over ``ep`` (tokens exchanged by
``all_to_all``). Layer outputs, ``l_aux`` and every gradient match at
rtol 1e-4 / atol 1e-5; each assignment's capacity slot (so the drop
pattern) and the drop count equal the reference's exactly; the model's
losses match at rtol 1e-5, as the one-process MoE tests hold them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import P as JP
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import moe as jmoe

import torch_dist_worker as W
import torch_ep_worker as EW
from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import undrawn_jax_init
from test_torch_distributed import jax_mesh, jt
from test_torch_moe import _jax_reference

EP_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5)


@pytest.fixture(scope="module")
def ranks():
    world = W.Ranks("ep", 2, script=EW.__file__)
    yield world
    world.close()


def port(ranks, case, rank=0):
    return ranks.results()[rank][case]


def _expected_slots(idx_k, E, C, valid):
    """The reference's capacity slots from its top-k picks ``[T, K]``:
    the pick-major running count per expert, ``e*C + position`` where it
    is below ``C``, ``E*C`` for a drop or a masked token."""
    T, K = idx_k.shape
    seen = np.zeros(E, np.int64)
    out = np.full((K, T), E * C, np.int64)
    for k in range(K):
        for t in range(T):
            if not valid[t]:
                continue
            e = idx_k[t, k]
            if seen[e] < C:
                out[k, t] = e * C + seen[e]
            seen[e] += 1
    return out


_REFERENCE = {}


def _reference_layer(case):
    """The reference's layer of ``case`` on its ep mesh, run once for both
    layouts: ``_jax_reference``'s picks, slots, output, aux and
    gradients."""
    if case not in _REFERENCE:
        name, gate, top_k, cf, mode, E, masked = case
        x, proj, mask = EW.layer_inputs(8)
        pt.seed(0)
        with undrawn_jax_init():
            jm = jfleet.MoELayer(EW.D, EW.HID, num_experts=E, gate=gate,
                                 top_k=top_k, capacity_factor=cf,
                                 dispatch_mode=mode,
                                 mesh=jax_mesh({"ep": 2}))
        jm.set_state_dict(EW.layer_weights(E, 7))
        with pytest.MonkeyPatch.context() as mp:
            _REFERENCE[case] = _jax_reference(
                jm, x, proj, mask if masked else None, mp)
    return _REFERENCE[case]


@pytest.mark.parametrize("layout", EW.LAYOUTS)
@pytest.mark.parametrize("case", EW.LAYER_CASES, ids=lambda c: c[0])
def test_layer_matches_the_reference(ranks, case, layout):
    """Output, ``l_aux``, the input's and every weight's gradient (the
    expert stacks gathered from their ``ep`` blocks) against the
    reference's layer on its ep mesh; the capacity slots and the drop
    count exactly. Every rank reports the same global numbers."""
    name, gate, top_k, cf, mode, E, masked = case
    x, proj, mask = EW.layer_inputs(8)
    seen, y, l_aux, gx, grads = _reference_layer(case)
    T = x.shape[0] * x.shape[1]
    C = max(int(cf * T * top_k / E), 1)
    valid = mask.reshape(-1) if masked else np.ones(T, bool)
    slots = _expected_slots(seen["idx_k"], E, C, valid)
    if mode == "ragged":  # the reference's own slot map
        np.testing.assert_array_equal(seen["slots"], slots)
    for r in range(2):
        got = port(ranks, "ep_layer", r)[f"{name}/{layout}"]
        assert got["capacity"] == C
        np.testing.assert_array_equal(got["slots"], slots)
        assert got["dropped"] == int((slots[:, valid] == E * C).sum())
        np.testing.assert_allclose(got["y"], y, **EP_TOL)
        np.testing.assert_allclose(got["l_aux"], l_aux, **EP_TOL)
        np.testing.assert_allclose(got["dx"], gx, **EP_TOL)
        for n, g in grads.items():
            np.testing.assert_allclose(got["grads"][n], g, err_msg=n,
                                       **EP_TOL)
        assert got["sharded"] == (E % 2 == 0)
        assert got["local_experts"] == (E // 2 if E % 2 == 0 else E)


def test_capacity_edge_drops_assignments(ranks):
    """The capacity-factor-1.0 cases drop assignments, so the exact slot
    comparison above covers the capacity edge in both layouts."""
    for name in ("gshard_cf1", "switch_cf1_dense", "masked_cf1"):
        for layout in EW.LAYOUTS:
            assert port(ranks, "ep_layer")[f"{name}/{layout}"][
                "dropped"] > 0


def test_sharded_stacks_carry_their_spec_and_init(ranks):
    """Each rank keeps 4 of 8 experts under ``P("ep", ...)``; the seeded
    init keeps this rank's block of the one-device layer's draws."""
    got = port(ranks, "ep_layer")["gshard/whole"]["specs"]
    assert got["w1"] == ("ep", None, None) and got["b1"] == ("ep", None)
    assert got["gate.weight"] is None
    assert port(ranks, "ep_layer")["replicated/rows"]["specs"]["w1"] is None
    for r in range(2):
        init = port(ranks, "ep_init", r)
        assert init["local"] == (4, EW.D, EW.HID)
        for n, v in init["one"].items():
            np.testing.assert_array_equal(init["full"][n], v, err_msg=n)


# -- the MoE model ------------------------------------------------------------------
def _jax_moe_losses(cfg_kw, mesh, input_spec):
    with undrawn_jax_init():
        jm = jmoe.MoeForCausalLM(jmoe.MoeConfig(**cfg_kw))
    jm.set_state_dict(EW.moe_state({**cfg_kw, "tensor_parallel": False}))
    jm.train()
    opt = pt.optimizer.AdamW(learning_rate=EW.MOE_LR,
                             parameters=jm.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    step = pt.jit.TrainStep(jm, lambda m, x: m(x, labels=x)[1], opt,
                            mesh=mesh, input_spec=input_spec)
    losses, norms = [], []
    for ids in EW.moe_batches():
        losses.append(float(np.asarray(step(jt(ids.astype(np.int32))).data)))
        norms.append(float(np.asarray(step.last_grad_norm)))
    return losses, norms


def _one_process_drops():
    """The routed layer's drops over the same three steps in one process
    (the port's one-device MoE equals the reference's,
    tests/test_torch_moe.py)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    model = MoeForCausalLM(MoeConfig(**EW.MOE_TINY), device="cpu")
    load_numpy_state(model, EW.moe_state(EW.MOE_TINY))
    opt = AdamW(learning_rate=EW.MOE_LR, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, lambda m, x: m(x, labels=x)[1], opt)
    out = []
    for ids in EW.moe_batches():
        step(torch.from_numpy(ids))
        out.append(int(model.layers[1].mlp.last_dropped))
    return out


def test_moe_model_ep2_matches_the_reference(ranks):
    """The tiny MoE LM, 3 AdamW steps with a global-norm clip at ep 2,
    the batch split over ``ep`` (``input_spec=P("ep")``) and whole on
    every rank (``P()``): losses and norms equal the reference's run on
    its ep mesh, and each step's drops the one-process run's."""
    losses, norms = _jax_moe_losses(EW.MOE_TINY, jax_mesh({"ep": 2}), JP())
    drops = _one_process_drops()
    for r in range(2):
        for layout in ("rows", "whole"):
            got = port(ranks, "ep_model", r)[layout]
            np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
            np.testing.assert_allclose(got["norms"], norms, **EP_TOL)
            assert got["dropped"] == drops


def test_expert_stacks_are_never_reduced_over_ep(ranks):
    """Under the row split the batch axis is ``ep`` and the expert stacks
    are split on it: their gradients are summed over no axis and sit in
    no all-reduce bucket, while the gate and the attention are summed
    over ``ep``. With the batch whole nothing is reduced."""
    got = port(ranks, "ep_model")["rows"]
    stacks = [n for n in got["reduce_axes"]
              if n.startswith("layers.1.mlp.") and n[-2:] in ("w1", "w2",
                                                              "b1", "b2")]
    assert len(stacks) == 4
    bucketed = {n for b in got["buckets"] for n in b}
    for n in stacks:
        assert got["reduce_axes"][n] == () and n not in bucketed
    for n in ("layers.1.mlp.gate.weight",
              "layers.0.self_attn.q_proj.weight"):
        assert got["reduce_axes"][n] == ("ep",) and n in bucketed
    whole = port(ranks, "ep_model")["whole"]
    assert set(whole["reduce_axes"].values()) == {()}
    for r in range(2):
        s = port(ranks, "ep_model", r)["rows"]["state"]
        assert s["layers.1.mlp.w1"].shape == (4, 32, 32)


def test_a_dropped_mesh_step_frees_its_model(ranks):
    """Gradient hooks of a bucketed ``TrainStep(mesh=)`` hold its plan
    weakly, so a step and model that go out of scope are freed (a strong
    hook kept both alive: the parameter owns its hooks where the cycle
    collector cannot see them)."""
    for r in range(2):
        assert port(ranks, "plan_frees_its_model", r) == [True, True]


def test_moe_model_tensor_parallel_matches_the_reference(ranks):
    """``MoeConfig(tensor_parallel=True)`` at mp 2: the attention, dense
    MLP and shared experts split over ``mp``, the embedding, ``lm_head``
    and routed experts whole; 3 steps equal the reference's
    tensor-parallel run on its mp mesh."""
    cfg = dict(EW.MOE_TINY, tensor_parallel=True)
    jax_mesh({"mp": 2})
    losses, norms = _jax_moe_losses(cfg, jdist.get_mesh(), None)
    for r in range(2):
        got = port(ranks, "mp_model", r)
        np.testing.assert_allclose(got["mp"]["losses"], losses, **LOSS_TOL)
        np.testing.assert_allclose(got["mp"]["norms"], norms, **EP_TOL)
        assert got["heads"] == (1, 1)
        nbytes, own = got["o_proj_storage"]
        assert nbytes == own  # the block's own storage, not the full one
        assert got["shared_spec"] == (None, "mp")
        assert got["expert_sharded"] is False
