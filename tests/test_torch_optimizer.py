"""The port's optimizer rules, clips, regularizers and learning-rate
schedulers against the JAX package's, on the CPU.

Each rule takes three eager steps on the same weights and gradients in
both packages (numpy arrays handed to each), at the tolerance the JAX
package's own test of that rule uses against its numpy oracle
(tests/test_optimizer.py). The clips and ``L1Decay`` get the same
gradients. Every scheduler's ``lr`` over 30 steps must equal the JAX
package's float for float, before and after a state round trip.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import clip as jclip
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import regularizer as treg

from test_torch_bridge import one_torch_thread  # noqa: F401

SHAPES = ((4, 3), (5,))


def _np(t):
    return np.asarray(t.data if hasattr(t, "data") else t)


def _weights_and_grads(seed=0, steps=3):
    rng = np.random.RandomState(seed)
    w = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    g = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
         for _ in range(steps)]
    return w, g


# name -> (class name, keyword arguments given the regularizer module,
# rtol of the JAX package's test of the rule)
RULES = {
    "sgd": ("SGD", lambda reg: dict(learning_rate=0.1), 1e-6),
    "momentum": ("Momentum",
                 lambda reg: dict(learning_rate=0.1, momentum=0.9), 1e-6),
    "momentum_nesterov": ("Momentum", lambda reg: dict(
        learning_rate=0.1, momentum=0.9, use_nesterov=True), 1e-6),
    "adam": ("Adam", lambda reg: dict(learning_rate=0.01, epsilon=1e-8),
             1e-5),
    "adam_l2_in_moments": ("Adam", lambda reg: dict(
        learning_rate=0.01, weight_decay=0.1), 1e-5),
    "adam_l1_in_moments": ("Adam", lambda reg: dict(
        learning_rate=0.01, weight_decay=reg.L1Decay(0.1)), 1e-5),
    "adamw": ("AdamW", lambda reg: dict(learning_rate=0.01,
                                        weight_decay=0.1), 1e-5),
    "adagrad": ("Adagrad", lambda reg: dict(learning_rate=0.1,
                                            epsilon=1e-6), 1e-5),
    "rmsprop": ("RMSProp", lambda reg: dict(
        learning_rate=0.01, rho=0.9, epsilon=1e-6, momentum=0.9), 1e-5),
    "rmsprop_centered": ("RMSProp", lambda reg: dict(
        learning_rate=0.01, rho=0.9, epsilon=1e-6, momentum=0.9,
        centered=True), 1e-5),
    "adadelta": ("Adadelta", lambda reg: dict(rho=0.95, epsilon=1e-6),
                 1e-5),
    "adamax": ("Adamax", lambda reg: dict(learning_rate=0.01), 1e-5),
    "lamb": ("Lamb", lambda reg: dict(learning_rate=0.01,
                                      lamb_weight_decay=0.01), 1e-4),
}


def _run_jax(cls, kw, w, grads, sched=None):
    ps = [pt.Parameter(x.copy()) for x in w]
    o = getattr(jopt, cls)(parameters=ps, **kw)
    out = []
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = pt.to_tensor(g)
        o.step()
        out.append([_np(p).copy() for p in ps])
        if sched is not None:
            sched.step()
    return out, [{k: _np(v) for k, v in o._state[id(p)].items()}
                 for p in ps]


def _run_port(cls, kw, w, grads, sched=None):
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w]
    o = getattr(topt, cls)(parameters=ps, **kw)
    out = []
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        o.step()
        out.append([p.detach().numpy().copy() for p in ps])
        if sched is not None:
            sched.step()
    return out, [{k: v.numpy() for k, v in o._state[id(p)].items()}
                 for p in ps]


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_matches_jax_over_three_steps(name):
    cls, kw, rtol = RULES[name]
    w, grads = _weights_and_grads(seed=len(name))
    ours, ostate = _run_port(cls, kw(treg), w, grads)
    ref, rstate = _run_jax(cls, kw(jreg), w, grads)
    for step, (a, b) in enumerate(zip(ours, ref)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-7,
                                       err_msg=f"{name} step {step + 1}")
    for a, b in zip(ostate, rstate):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"{name}.{k}")


def test_lamb_exclude_fn_and_fusable_flags():
    w, grads = _weights_and_grads(seed=3)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w]
    o = topt.Lamb(learning_rate=0.01, lamb_weight_decay=0.5, parameters=ps,
                  exclude_from_weight_decay_fn=lambda p: p.dim() == 1)
    assert o._param_group_kwargs(ps[1], o._param_groups[0])[
        "lamb_weight_decay"] == 0.0
    assert o._param_group_kwargs(ps[0], o._param_groups[0])[
        "lamb_weight_decay"] == 0.5
    fusable = {n for n in topt.__all__
               if getattr(getattr(topt, n), "_fusable_update", False)}
    assert fusable == {n for n in jopt.__all__
                       if getattr(getattr(jopt, n), "_fusable_update",
                                  False)}
    assert "Lamb" not in fusable and {"Adam", "AdamW"} <= fusable


# -- clips and regularizers ---------------------------------------------------
def _pairs(package, grads):
    if package == "jax":
        ps = [pt.Parameter(np.zeros_like(g)) for g in grads]
        return [(p, pt.to_tensor(g)) for p, g in zip(ps, grads)]
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    return [(p, torch.from_numpy(g)) for p, g in zip(ps, grads)]


@pytest.mark.parametrize("clip", [
    "value", "value_min_max", "norm_above", "norm_below",
    "global_norm_above", "global_norm_below"])
def test_clip_matches_jax(clip):
    _, (grads, *_) = _weights_and_grads(seed=5)
    cls, args = {
        "value": ("ClipGradByValue", (0.5,)),
        "value_min_max": ("ClipGradByValue", (0.3, -0.1)),
        "norm_above": ("ClipGradByNorm", (1.0,)),
        "norm_below": ("ClipGradByNorm", (100.0,)),
        "global_norm_above": ("ClipGradByGlobalNorm", (1.0,)),
        "global_norm_below": ("ClipGradByGlobalNorm", (100.0,)),
    }[clip]
    ours = getattr(tnn, cls)(*args)(_pairs("torch", grads))
    ref = getattr(jclip, cls)(*args)(_pairs("jax", grads))
    for (_, a), (_, b), g in zip(ours, ref, grads):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-7)
        if clip.endswith("below"):  # below the threshold: a no-op
            np.testing.assert_array_equal(a.numpy(), g)


def test_l1_and_l2_decay_match_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(6)
    p = rng.randn(6, 5).astype(np.float32)
    p[0, :2] = 0.0  # sign(0) = 0
    g = rng.randn(6, 5).astype(np.float32)
    for name in ("L1Decay", "L2Decay"):
        ours = getattr(treg, name)(0.25)(torch.from_numpy(p),
                                         torch.from_numpy(g))
        ref = getattr(jreg, name)(0.25)(jnp.asarray(p), jnp.asarray(g))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7)


# -- learning-rate schedulers ---------------------------------------------------
SCHEDULERS = {
    "NoamDecay": lambda lr: lr.NoamDecay(d_model=64, warmup_steps=10,
                                         learning_rate=2.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([5, 12, 20],
                                                   [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.1, gamma=0.1),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.1, gamma=0.3),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.1, decay_steps=12,
                                                     power=2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, cycle=True),
    "LinearWarmup_cosine": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(0.1, T_max=20, eta_min=0.001),
        warmup_steps=6, start_lr=0.0, end_lr=0.1),
    "LinearWarmup_float": lambda lr: lr.LinearWarmup(0.1, 8, 0.01, 0.1),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.1, [4, 9, 17],
                                                   gamma=0.3),
    "StepDecay": lambda lr: lr.StepDecay(0.1, step_size=4, gamma=0.5),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(
        0.1, lambda e: 0.9 if e % 3 else 0.99),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(0.1,
                                                               T_max=9),
    "OneCycleLR": lambda lr: lr.OneCycleLR(0.1, total_steps=25),
    "OneCycleLR_three_phase_linear": lambda lr: lr.OneCycleLR(
        0.1, total_steps=25, anneal_strategy="linear", three_phase=True),
    "CyclicLR": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=4,
                                       step_size_down=6,
                                       mode="triangular2"),
    "CyclicLR_exp": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=5,
                                           mode="exp_range",
                                           exp_gamma=0.97),
    "CosineAnnealingWarmRestarts": lambda lr:
        lr.CosineAnnealingWarmRestarts(0.1, T_0=4, T_mult=2,
                                       eta_min=0.001),
}
# a loss that falls, stalls and falls again
PLATEAU_LOSSES = [3.0, 2.5, 2.4, 2.4, 2.41, 2.4, 2.39, 2.4, 2.2, 2.1, 2.1,
                  2.1, 2.1, 2.1, 1.9, 1.9, 1.9, 1.9, 1.9, 1.8, 1.8, 1.8,
                  1.8, 1.8, 1.8, 1.7, 1.7, 1.7, 1.7, 1.7]


def _lrs(sched, steps=30):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_lrs_equal_jax_float_for_float(name):
    ours, ref = SCHEDULERS[name](topt.lr), SCHEDULERS[name](jopt.lr)
    assert _lrs(ours) == _lrs(ref)
    # a state round trip into a fresh scheduler continues the sequence
    again = SCHEDULERS[name](topt.lr)
    again.set_state_dict(ours.state_dict())
    assert _lrs(again, 5) == _lrs(ref, 5)


def test_reduce_on_plateau_matches_jax():
    kw = dict(mode="min", factor=0.5, patience=2, threshold=1e-3,
              cooldown=1, min_lr=0.004)
    ours = topt.lr.ReduceOnPlateau(0.1, **kw)
    ref = jopt.lr.ReduceOnPlateau(0.1, **kw)
    got, want = [], []
    for i, loss in enumerate(PLATEAU_LOSSES):
        # the port takes a 0-d tensor or a float
        ours.step(torch.tensor(loss) if i % 2 else loss)
        ref.step(loss)
        got.append(ours())
        want.append(ref())
    assert got == want and len(set(got)) > 2
    again = topt.lr.ReduceOnPlateau(0.1, **kw)
    again.set_state_dict(ours.state_dict())
    again.step(5.0)
    ref.step(5.0)
    assert again() == ref() and again.num_bad_epochs == ref.num_bad_epochs


def test_scheduler_drives_an_optimizer_as_in_jax():
    """A warmup-cosine schedule through eager SGD steps, the scheduler
    ticking after each step, in both packages; ``set_lr`` refuses, and
    the schedule rides the state dict."""
    w, grads = _weights_and_grads(seed=7, steps=6)

    def sched(lr):
        return lr.LinearWarmup(lr.CosineAnnealingDecay(0.5, T_max=8), 3,
                               0.0, 0.5)
    s_ours, s_ref = sched(topt.lr), sched(jopt.lr)
    ours, _ = _run_port("Momentum", dict(learning_rate=s_ours), w, grads,
                        s_ours)
    ref, _ = _run_jax("Momentum", dict(learning_rate=s_ref), w, grads,
                      s_ref)
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    p = torch.nn.Parameter(torch.zeros(3))
    o = topt.SGD(learning_rate=s_ours, parameters=[p])
    assert o.get_lr() == s_ours()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        o.set_lr(0.1)
    sd = o.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 6
    o2 = topt.SGD(learning_rate=sched(topt.lr), parameters=[p])
    o2.set_state_dict(sd)
    assert o2.get_lr() == o.get_lr()
    o3 = topt.SGD(learning_rate=0.1, parameters=[p])
    o3.set_lr_scheduler(sched(topt.lr))
    assert o3.get_lr() == 0.0
    with pytest.raises(TypeError, match="LRScheduler"):
        topt.SGD(learning_rate=object(), parameters=[p])


def test_minimize_is_backward_and_step():
    w, (grads, *_) = _weights_and_grads(seed=8)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w]
    o = topt.SGD(learning_rate=0.1, parameters=ps)
    loss = sum((p * torch.from_numpy(g)).sum() for p, g in zip(ps, grads))
    _, pairs = o.minimize(loss)
    for (p, pg), x, g in zip(pairs, w, grads):
        np.testing.assert_array_equal(pg.numpy(), g)
        np.testing.assert_allclose(p.detach().numpy(), x - 0.1 * g,
                                   rtol=1e-6)
