"""The port's fused multi-tensor update (``jit/fused_update.py``) and the
fused ``TrainStep``, on the CPU, where every bucket takes the plain
versions of the kernels.

Mirrors the JAX package's tests/test_fused_optimizer.py: the fused
bucket update is bit-equal to the port's own per-parameter loop for
every elementwise rule in f32; a fused ``TrainStep`` matches the loop
(rtol 5e-6, atol 1e-7: under a global-norm clip the norm sums in another
order) across clips, bf16 masters (rtol 2e-2, atol 1e-3), parameter
groups with a scheduler, AdamW's ``lr_ratio`` and decay mask, a frozen
subset and Lamb in the residue; and the flat state stays coherent with
``state_dict``, ``set_state_dict`` and eager steps. A fused ``TrainStep``
of the tiny Llama matches the JAX package's fused ``TrainStep`` over
three steps on bridged weights (the loss at rtol 1e-5, parameters and
moments at rtol 1e-4, atol 1e-6, as tests/test_torch_train.py).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch.jit.train_step as ts_mod
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.fused_update import (build_flat_states,
                                               build_layout,
                                               fused_clip_and_update)
from paddle_tpu_torch.utils.bridge import optimizer_state_to_numpy

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import bridged, jax_tiny, state_dict_from_jax

TOL = dict(rtol=5e-6, atol=1e-7)


class MLP(torch.nn.Module):
    """8 -> 32 -> 4 with biases, weights from a numpy seed."""

    def __init__(self, seed=0, dtype=torch.float32):
        super().__init__()
        rng = np.random.RandomState(seed)
        for name, shape in (("w0", (8, 32)), ("b0", (32,)), ("w1", (32, 4)),
                            ("b1", (4,))):
            setattr(self, name, torch.nn.Parameter(torch.from_numpy(
                (0.3 * rng.randn(*shape)).astype(np.float32)).to(dtype)))

    def forward(self, x):
        return torch.relu(x @ self.w0 + self.b0) @ self.w1 + self.b1


class Named(torch.nn.Parameter):
    """A parameter with a Paddle-style ``name``, which torch parameters
    lack."""
    name = ""


def _data(dtype=torch.float32):
    rng = np.random.RandomState(0)
    x = rng.randn(32, 8).astype(np.float32)
    y = x @ rng.randn(8, 4).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype)


def _loss(m, x, y):
    return ((m(x) - y).float() ** 2).mean()


def _run(make_opt, fused, steps=5, dtype=torch.float32, seed=7):
    m = MLP(seed, dtype)
    o = make_opt(m)
    s = TrainStep(m, _loss, o, fused=fused)
    x, y = _data(dtype)
    losses = [float(s(x, y)) for _ in range(steps)]
    return m, o, s, losses


def _assert_close(m1, m2, tol=TOL):
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), **tol)


def _assert_state_dicts_match(sd1, sd2, rtol=0.0, atol=0.0):
    assert sorted(sd1) == sorted(sd2)
    for k, b in sd2.items():
        a = sd1[k]
        if not isinstance(b, torch.Tensor):
            assert a == b, k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


# every elementwise rule, with the decays it can fold
FUSABLE = {
    "sgd": lambda ps: topt.SGD(learning_rate=0.05, parameters=ps),
    "momentum": lambda ps: topt.Momentum(learning_rate=0.01, momentum=0.9,
                                         parameters=ps),
    "momentum_nesterov": lambda ps: topt.Momentum(
        learning_rate=0.01, momentum=0.9, use_nesterov=True, parameters=ps),
    "adam": lambda ps: topt.Adam(learning_rate=0.01, parameters=ps),
    "adam_l2": lambda ps: topt.Adam(learning_rate=0.01, parameters=ps,
                                    weight_decay=0.1),
    "adam_l1": lambda ps: topt.Adam(learning_rate=0.01, parameters=ps,
                                    weight_decay=treg.L1Decay(0.1)),
    "adamw": lambda ps: topt.AdamW(learning_rate=0.01, parameters=ps,
                                   weight_decay=0.1),
    "adagrad": lambda ps: topt.Adagrad(learning_rate=0.1, parameters=ps),
    "rmsprop_centered": lambda ps: topt.RMSProp(
        learning_rate=0.01, momentum=0.9, centered=True, parameters=ps),
    "rmsprop": lambda ps: topt.RMSProp(learning_rate=0.01, parameters=ps),
    "adadelta": lambda ps: topt.Adadelta(parameters=ps),
    "adamax": lambda ps: topt.Adamax(learning_rate=0.01, parameters=ps),
}


@pytest.mark.parametrize("name", sorted(FUSABLE))
def test_fused_bucket_update_is_bit_equal_to_the_loop(name):
    """The same gradients into one bucket update and into the rule one
    parameter at a time: equal bits in every parameter and accumulator."""
    m_loop, m_fused = MLP(), MLP()
    o_loop = FUSABLE[name](list(m_loop.parameters()))
    o_fused = FUSABLE[name](list(m_fused.parameters()))
    params = dict(m_fused.named_parameters())
    rng = np.random.RandomState(3)
    layout = build_layout(o_fused, params, list(params))
    assert layout.buckets and not layout.residue
    flats = build_flat_states(o_fused, layout, params)
    lr = np.float32(o_fused.get_lr())
    for _ in range(3):
        grads = {n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 for n, p in params.items()}
        o_loop._apply(o_loop._param_groups[0],
                      list(zip(m_loop.parameters(), grads.values())), lr)
        res, gnorm = fused_clip_and_update(o_fused, layout, params, grads,
                                           flats, [lr])
        assert res == {} and gnorm is None  # no residue, no clip
    for a, b in zip(m_loop.parameters(), m_fused.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    for pa, pb in zip(m_loop.parameters(), m_fused.parameters()):
        sa, sb = o_loop._state[id(pa)], o_fused._state[id(pb)]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k].numpy(), sb[k].numpy(),
                                          err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", ["adamw", "sgd", "momentum"])
def test_train_step_fused_matches_loop(name):
    def mk(m):
        return FUSABLE[name](list(m.parameters()))
    m1, o1, s1, l1 = _run(mk, fused=True)
    m2, o2, s2, l2 = _run(mk, fused=False)
    assert s1._layout is not None and s2._layout is None
    np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-7)
    _assert_close(m1, m2)
    _assert_state_dicts_match(o1.state_dict(), o2.state_dict(), rtol=1e-5,
                              atol=1e-7)


@pytest.mark.parametrize("clip", ["global_norm", "value", "norm"])
def test_train_step_fused_matches_loop_under_a_clip(clip):
    """The global norm is folded into the update; ClipGradByValue and the
    per-tensor ClipGradByNorm clip before it (the pre-clip path)."""
    def mk(m):
        c = {"global_norm": tnn.ClipGradByGlobalNorm(0.5),
             "value": tnn.ClipGradByValue(0.01),
             "norm": tnn.ClipGradByNorm(0.05)}[clip]
        cls = topt.AdamW if clip == "global_norm" else topt.SGD
        return cls(learning_rate=0.05, parameters=m.parameters(),
                   grad_clip=c)
    m1, _, s1, _ = _run(mk, fused=True)
    m2, _, s2, _ = _run(mk, fused=False)
    _assert_close(m1, m2)
    if clip == "global_norm":
        np.testing.assert_allclose(float(s1.last_grad_norm),
                                   float(s2.last_grad_norm), rtol=1e-6)
    else:
        assert s1.last_grad_norm is None and s2.last_grad_norm is None


def test_master_weights_bf16():
    def mk(m):
        return topt.AdamW(learning_rate=0.01, parameters=m.parameters(),
                          multi_precision=True)
    m1, o1, _, _ = _run(mk, fused=True, dtype=torch.bfloat16)
    m2, o2, _, _ = _run(mk, fused=False, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in m1.parameters())
    _assert_close(m1, m2, dict(rtol=2e-2, atol=1e-3))
    sd1, sd2 = o1.state_dict(), o2.state_dict()
    assert any(k.endswith(".master_weight") for k in sd1)
    _assert_state_dicts_match(sd1, sd2, rtol=1e-4, atol=1e-5)
    for p in m1.parameters():  # the parameter is its master, rounded
        master = o1._state[id(p)]["master_weight"]
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_param_groups_per_group_lr_and_decay_with_a_scheduler():
    outs, scheds = [], []
    for fused in (True, False):
        m = MLP(7)
        sched = topt.lr.StepDecay(0.5, step_size=1, gamma=0.1)
        o = topt.AdamW(learning_rate=0.01, parameters=[
            {"params": [m.w0, m.b0], "weight_decay": 0.1},
            {"params": [m.w1, m.b1], "learning_rate": sched,
             "weight_decay": 0.0}])
        s = TrainStep(m, _loss, o, fused=fused)
        x, y = _data()
        for _ in range(4):
            s(x, y)
            sched.step()  # takes effect on the next step
        if fused:
            assert len(s._layout.buckets) == 2
        outs.append(m)
        scheds.append(s)
    _assert_close(*outs)


def test_adamw_lr_ratio_and_decay_mask():
    outs = []
    for fused in (True, False):
        m = MLP(7)
        for n in ("b0", "b1"):  # the decay mask reads Paddle-style names
            setattr(m, n, Named(getattr(m, n).detach()))
            getattr(m, n).name = n
        o = topt.AdamW(learning_rate=0.01, parameters=m.parameters(),
                       weight_decay=0.1,
                       lr_ratio=lambda p: 0.1 if p.dim() == 1 else 1.0,
                       apply_decay_param_fun=lambda n: n not in ("b0", "b1"))
        s = TrainStep(m, _loss, o, fused=fused)
        x, y = _data()
        for _ in range(3):
            s(x, y)
        if fused:
            b = s._layout.buckets
            assert len(b) == 2
            assert {x.lr_ratio for x in b} == {None, 0.1}
            assert {x.decay_coeff for x in b} == {0.0, 0.1}
        outs.append(m)
    _assert_close(*outs)


def test_frozen_subset_stays_frozen():
    m = MLP(3)
    o = topt.AdamW(learning_rate=0.05, parameters=[m.w1, m.b1])
    s = TrainStep(m, _loss, o)
    before, head = m.w0.detach().clone(), m.w1.detach().clone()
    s(*_data())
    assert s._layout is not None and s._layout.buckets
    assert s._layout.fused_names == ["w1", "b1"]
    assert torch.equal(m.w0.detach(), before) and m.w0.grad is None
    assert not torch.allclose(m.w1.detach(), head)


def test_lamb_stays_in_the_per_parameter_loop():
    def mk(m):
        return topt.Lamb(learning_rate=0.01, lamb_weight_decay=0.5,
                         parameters=m.parameters(),
                         exclude_from_weight_decay_fn=lambda p: p.dim() == 1)
    m1, _, s1, _ = _run(mk, fused=True, steps=3)
    m2, _, _, _ = _run(mk, fused=False, steps=3)
    assert s1._layout is None  # Lamb never fuses
    _assert_close(m1, m2)


def test_state_is_views_of_the_flats_and_never_rebuilt(monkeypatch):
    """The per-parameter entries are views of the flat buffers (no second
    copy), the flats are built once, and a scheduler's tick plans
    nothing again."""
    builds, layouts = [], []
    orig_build, orig_layout = ts_mod.build_flat_states, ts_mod.build_layout
    monkeypatch.setattr(ts_mod, "build_flat_states",
                        lambda *a: builds.append(1) or orig_build(*a))
    monkeypatch.setattr(ts_mod, "build_layout",
                        lambda *a: layouts.append(1) or orig_layout(*a))
    m = MLP()
    sched = topt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    o = topt.AdamW(learning_rate=sched, parameters=m.parameters())
    s = TrainStep(m, _loss, o)
    x, y = _data()
    for _ in range(4):
        s(x, y)
        sched.step()
    assert len(builds) == 1 and len(layouts) == 1
    (b,), (f,) = s._layout.buckets, s._plan[2]
    for n, p in zip(b.names, m.parameters()):
        st = o._state[id(p)]
        for k in ("moment1", "moment2"):
            assert st[k].untyped_storage().data_ptr() == \
                f[k].untyped_storage().data_ptr()
        assert st["beta1_pow"].untyped_storage().data_ptr() == \
            f["beta1_pow"].untyped_storage().data_ptr()
    assert float(f["beta1_pow"][0]) == pytest.approx(0.9 ** 4)


def test_state_dict_reflects_fused_steps():
    m1, o1, _, _ = _run(lambda m: FUSABLE["adamw"](m.parameters()), True, 2)
    m2, o2, _, _ = _run(lambda m: FUSABLE["adamw"](m.parameters()), False,
                        2)
    sd = o1.state_dict()
    assert all(float(v.abs().max()) > 0 for k, v in sd.items()
               if k.endswith(".moment1"))
    _assert_state_dicts_match(sd, o2.state_dict())


def test_set_state_dict_wins_over_the_flats():
    """Zeroed moments loaded after three fused steps: the next step
    builds its flats from them, as the loop does from the same state."""
    outs = []
    for fused in (True, False):
        m = MLP()
        o = topt.AdamW(learning_rate=0.01, parameters=m.parameters())
        s = TrainStep(m, _loss, o, fused=fused)
        x, y = _data()
        for _ in range(3):
            s(x, y)
        sd = optimizer_state_to_numpy(o)
        zeroed = {k: (np.zeros_like(v) if isinstance(v, np.ndarray) and
                      "pow" not in k else v) for k, v in sd.items()}
        o.set_state_dict({k: torch.from_numpy(v) if isinstance(
            v, np.ndarray) else v for k, v in zeroed.items()})
        s(x, y)
        outs.append((m, o))
    _assert_close(outs[0][0], outs[1][0])
    _assert_state_dicts_match(outs[0][1].state_dict(),
                              outs[1][1].state_dict(), **TOL)
    # one step from zeroed moments: |moment1| = (1 - beta1) * |g|, far
    # below what four accumulated steps leave
    m1 = outs[0][1].state_dict()["param_0.moment1"]
    assert float(m1.abs().max()) < 0.2


def test_fused_then_eager_steps():
    """Two fused steps, then two eager steps, against the same on the
    loop: the eager steps update the flats through the views."""
    outs = []
    for fused in (True, False):
        m, o, s, _ = _run(lambda m: FUSABLE["momentum"](m.parameters()),
                          fused, steps=2)
        x, y = _data()
        for _ in range(2):
            _loss(m, x, y).backward()
            o.step()
            o.clear_grad()
        s(x, y)  # and a fused step after them
        outs.append(m)
    _assert_close(*outs)


@pytest.mark.parametrize("case", ["adamw_global_clip", "momentum_groups"])
def test_fused_train_step_matches_jax_fused(case):
    """Three fused steps of the tiny Llama in both packages on bridged
    weights: AdamW with a global-norm clip (Adam's bucket update), and
    Momentum over two parameter groups, one on a StepDecay schedule (the
    plain bucket update of a rule with no kernel)."""
    jm = jax_tiny(31)
    jm.train()
    tm = bridged(jm)
    ids = np.random.RandomState(9).randint(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)

    def loss_fn(m, x):
        return m(x, labels=x)[1]

    def make(mod, model, nn):
        ps = list(model.parameters())
        if case == "adamw_global_clip":
            return mod.AdamW(learning_rate=1e-3, parameters=ps,
                             grad_clip=nn.ClipGradByGlobalNorm(1.0)), None
        sched = mod.lr.StepDecay(0.5, step_size=1, gamma=0.5)
        return mod.Momentum(learning_rate=0.02, momentum=0.9, parameters=[
            {"params": ps[:3]},
            {"params": ps[3:], "learning_rate": sched}]), sched

    jopt, jsched = make(pt.optimizer, jm, pt.nn)
    topt_, tsched = make(topt, tm, tnn)
    jstep = pt.jit.TrainStep(jm, loss_fn, jopt, fused=True)
    tstep = TrainStep(tm, loss_fn, topt_, fused=True)
    for _ in range(3):
        jl = float(np.asarray(jstep(pt.to_tensor(ids)).data))
        np.testing.assert_allclose(float(tstep(torch.from_numpy(ids))), jl,
                                   rtol=1e-5)
        for sched in (jsched, tsched):
            if sched is not None:
                sched.step()
    assert tstep._layout.buckets and not tstep._layout.residue
    jstate = state_dict_from_jax(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jstate[n], err_msg=n,
                                   rtol=1e-4, atol=1e-6)
    jsd = {k: (v if isinstance(v, int) else np.asarray(v.data))
           for k, v in jopt.state_dict().items() if k != "LR_Scheduler"}
    tsd = optimizer_state_to_numpy(topt_)
    assert sorted(tsd) == sorted(jsd) and tsd["@step_count"] == 3
    for key in jsd:
        if key != "@step_count":
            np.testing.assert_allclose(tsd[key], jsd[key], err_msg=key,
                                       rtol=1e-4, atol=1e-6)
