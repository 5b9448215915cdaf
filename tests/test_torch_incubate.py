"""``paddle.incubate`` on the port against the JAX package's, on the CPU
in float32: the fused layer set (``incubate.nn``) at the tolerances of
``tests/test_flash_attention.py:68`` for anything through attention
(rtol 2e-4, atol 2e-5) and of ``tests/test_layers.py`` otherwise (rtol
1e-4, atol 1e-5; parameter gradients twice that), on weights moved through the
bridge; LookAhead, ModelAverage and EMA over the same SGD steps at rtol
1e-5, with LookAhead's state under the reference's keys; the
auto-checkpoint's resume, and a job the reference wrote resumed by the
port; the functional and forward-mode autodiff against the reference's
results at rtol 1e-5; and ASP's masks equal the reference's, with the
2:4 pattern surviving a decorated step.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.incubate as jinc
import paddle_tpu.incubate.nn as jinn
import paddle_tpu_torch as ptt
import paddle_tpu_torch.incubate as inc
import paddle_tpu_torch.incubate.nn as inn
from paddle_tpu.distributed.mesh import mesh_scope
from paddle_tpu_torch.utils.bridge import load_numpy_state, numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_value_and_grads, state_dict_from_jax
from torch_api_common import on_cpu  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
ATTN = dict(rtol=2e-4, atol=2e-5)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def no_global_mesh():
    """``FusedEcMoe``'s JAX layer shards its experts on a global mesh that
    another test of the same worker may have left behind."""
    with mesh_scope(None):
        yield


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _twin(jax_layer, port_layer):
    load_numpy_state(port_layer, state_dict_from_jax(jax_layer))
    return port_layer


def _both(jax_layer, port_layer, xs, cot, tol, grad_tol, kw=None):
    """Output and every parameter gradient of ``sum(layer(*xs, **kw) *
    cot)`` in both packages (the JAX side under one ``jax.jit`` of
    ``value_and_grad``, as its ``TrainStep`` computes them), compared."""
    kw = kw or {}

    def jloss(m, *ts):
        out = m(*ts[:len(xs)], **dict(zip(kw, ts[len(xs):])))
        return (out * pt.to_tensor(cot)).sum(), out
    _, jout, jg, _ = jax_value_and_grads(jax_layer, jloss, *xs,
                                         *kw.values())
    tout = port_layer(*map(torch.as_tensor, xs),
                      **{k: torch.as_tensor(v) for k, v in kw.items()})
    (tout * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(_np(tout), jout, **tol)
    for n, p in port_layer.named_parameters():
        if p.grad is None:  # a parameter the configuration never reads
            assert not np.any(jg[n]), n
            continue
        np.testing.assert_allclose(_np(p.grad), jg[n], err_msg=n,
                                   **grad_tol)


# ------------------------------ incubate.nn ---------------------------------
@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_matches_jax(transpose):
    pt.seed(0)
    jl = jinn.FusedLinear(8, 4, transpose_weight=transpose)
    tl = _twin(jl, inn.FusedLinear(8, 4, transpose_weight=transpose, **CPU))
    assert list(tl.weight.shape) == ([4, 8] if transpose else [8, 4])
    rng = np.random.RandomState(0)
    _both(jl, tl, [rng.randn(2, 8).astype(np.float32)],
          rng.randn(2, 4).astype(np.float32), FWD, GRAD)


@pytest.mark.parametrize("pre_ln,masked", [(False, False), (True, False),
                                           (False, True)])
def test_fused_attention_matches_jax(pre_ln, masked):
    """The packed ``qkv_weight [3, H, hd, E]`` layer, pre- and post-LN;
    with an additive ``attn_mask`` it takes the flash kernels' full-bias
    path."""
    pt.seed(1)
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0,
              normalize_before=pre_ln)
    jl = jinn.FusedMultiHeadAttention(16, 4, **kw)
    tl = _twin(jl, inn.FusedMultiHeadAttention(16, 4, **kw, **CPU))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 16).astype(np.float32)
    extra = {}
    if masked:
        m = np.where(rng.rand(2, 1, 6, 6) < 0.3, -1e9, 0.0)
        m[..., 0] = 0.0  # every row sees a key
        extra["attn_mask"] = m.astype(np.float32)
    _both(jl, tl, [x], rng.randn(2, 6, 16).astype(np.float32), ATTN, ATTN,
          extra)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_fused_feed_forward_matches_jax(pre_ln):
    pt.seed(2)
    kw = dict(dropout_rate=0.0, normalize_before=pre_ln)
    jl = jinn.FusedFeedForward(8, 16, **kw)
    tl = _twin(jl, inn.FusedFeedForward(8, 16, **kw, **CPU))
    rng = np.random.RandomState(2)
    _both(jl, tl, [rng.randn(2, 4, 8).astype(np.float32)],
          rng.randn(2, 4, 8).astype(np.float32), FWD, GRAD)


@pytest.mark.parametrize("stack", [False, True])
def test_fused_encoder_layer_and_stack_match_jax(stack):
    """``FusedTransformerEncoderLayer`` (post-LN, ReLU) and a 2-layer
    ``FusedMultiTransformer`` (pre-LN, GELU): outputs and every
    gradient."""
    pt.seed(3)
    if stack:
        jl = jinn.FusedMultiTransformer(16, 2, 32, num_layers=2)
        tl = inn.FusedMultiTransformer(16, 2, 32, num_layers=2, **CPU)
    else:
        jl = jinn.FusedTransformerEncoderLayer(16, 2, 32, dropout_rate=0.0)
        tl = inn.FusedTransformerEncoderLayer(16, 2, 32, dropout_rate=0.0,
                                              **CPU)
    _twin(jl, tl)
    rng = np.random.RandomState(3)
    _both(jl, tl, [rng.randn(2, 5, 16).astype(np.float32)],
          rng.randn(2, 5, 16).astype(np.float32), ATTN, ATTN)


@pytest.mark.parametrize("with_gate", [False, True])
def test_fused_ec_moe_matches_jax(with_gate):
    """Without a gate the layer's own top-2 routing (``MoELayer``); with
    the caller's logits every expert, combined by their softmax."""
    pt.seed(4)
    jl = jinn.FusedEcMoe(8, 16, num_experts=4)
    tl = _twin(jl, inn.FusedEcMoe(8, 16, num_experts=4, **CPU))
    rng = np.random.RandomState(4)
    xs = [rng.randn(2, 6, 8).astype(np.float32)]
    if with_gate:
        xs.append(rng.randn(2, 6, 4).astype(np.float32))
    _both(jl, tl, xs, rng.randn(2, 6, 8).astype(np.float32), FWD, GRAD)


@pytest.mark.parametrize("case", ["plain", "scale", "bias"])
def test_memory_efficient_attention_matches_jax(case):
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, 8, 4, 16).astype(np.float32) for _ in range(3))
    kw = {"scale": 0.3} if case == "scale" else {}
    if case == "bias":
        kw["attn_bias"] = rng.randn(2, 4, 8, 8).astype(np.float32)
    want = jinn.memory_efficient_attention(
        *(pt.to_tensor(a) for a in (q, k, v)), training=False,
        **{n: (pt.to_tensor(a) if n == "attn_bias" else a)
           for n, a in kw.items()})
    got = inn.memory_efficient_attention(
        *(torch.as_tensor(a) for a in (q, k, v)), training=False,
        **{n: (torch.as_tensor(a) if n == "attn_bias" else a)
           for n, a in kw.items()})
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)


# --------------------------- incubate.optimizer -----------------------------
def _linear_pair(seed):
    pt.seed(seed)
    jm = pt.nn.Linear(4, 4)
    tm = _twin(jm, ptt.nn.Linear(4, 4))
    x = np.random.RandomState(seed).randn(8, 4).astype(np.float32)
    return jm, tm, x


def _sgd_steps(jm, tm, x, jwrap, twrap, n, after=None):
    """``n`` SGD steps of mean(square(m(x))) in both packages through the
    wrappers ``jwrap``/``twrap`` (each given its optimizer)."""
    jopt = pt.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    topt = ptt.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())
    jw, tw = jwrap(jopt), twrap(topt)
    for _ in range(n):
        for m, opt, w, api in ((jm, jopt, jw, pt), (tm, topt, tw, ptt)):
            loss = api.mean(api.square(m(api.to_tensor(x))))
            loss.backward()
            (w if hasattr(w, "step") else opt).step()
            opt.clear_grad()
            if after is not None:
                after(w)
    return jw, tw


def test_lookahead_matches_jax_and_keeps_its_state_keys():
    jm, tm, x = _linear_pair(0)
    jla, tla = _sgd_steps(jm, tm, x,
                          lambda o: jinc.optimizer.LookAhead(o, 0.5, 2),
                          lambda o: inc.optimizer.LookAhead(o, 0.5, 2), 5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), state_dict_from_jax(jm)[n],
                                   rtol=1e-5, err_msg=n)
    assert tla._slow[id(tm.weight)].device == tm.weight.device
    sd = tla.state_dict()
    assert set(sd) == set(jla.state_dict()) == {"inner", "step", "slow"}
    assert sorted(sd["slow"]) == sorted(jla.state_dict()["slow"]) == [0, 1]
    la2 = inc.optimizer.LookAhead(tla.inner_optimizer, k=2)
    la2.set_state_dict(sd)
    assert la2._step == 5
    with pytest.raises(ValueError):
        inc.optimizer.LookAhead(tla.inner_optimizer, alpha=2.0)


@pytest.mark.parametrize("kind", ["model_average", "ema"])
def test_averagers_match_jax(kind):
    """ModelAverage's streaming mean over 4 steps and EMA (decay 0.7,
    with the warm-up) over 4 updates: the averaged weights inside
    ``apply()`` equal the reference's, and the live ones come back."""
    jm, tm, x = _linear_pair(2)
    if kind == "model_average":
        make = [lambda m, mod=mod: mod.ModelAverage(parameters=m.parameters())
                for mod in (jinc.optimizer, inc.optimizer)]
        after = lambda w: w.step()  # noqa: E731
    else:
        make = [lambda m, mod=mod: mod.ExponentialMovingAverage(
            m.parameters(), decay=0.7, thres_steps=1)
            for mod in (jinc.optimizer, inc.optimizer)]
        after = lambda w: w.update()  # noqa: E731
    avgs = [make[0](jm), make[1](tm)]
    cell = iter(avgs * 4)
    _sgd_steps(jm, tm, x, lambda o: o, lambda o: o, 4,
               after=lambda _: after(next(cell)))
    live = _np(tm.weight).copy()
    with avgs[0].apply(), avgs[1].apply():
        np.testing.assert_allclose(_np(tm.weight), _np(jm.weight.data),
                                   rtol=1e-5)
        assert not np.allclose(_np(tm.weight), live)
    np.testing.assert_allclose(_np(tm.weight), live, rtol=0)


# --------------------------- incubate.checkpoint ----------------------------
def test_train_epoch_range_resumes_and_reads_the_reference(tmp_path):
    """The port's job resumes where it stopped (a new model restored,
    epochs 3-4 after 0-2, ``meta.json`` naming the last epoch); and a job
    the reference wrote (epochs 0-1) is resumed by the port at epoch 2
    with the reference's weights."""
    x = np.ones((4, 4), np.float32)
    ptt.seed(0)
    m = ptt.nn.Linear(4, 2)
    opt = ptt.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    seen = []
    for epoch in inc.checkpoint.TrainEpochRange(3, str(tmp_path), model=m,
                                                optimizer=opt, name="job1"):
        loss = ptt.mean(ptt.square(m(ptt.to_tensor(x))))
        loss.backward()
        opt.step()
        opt.clear_grad()
        seen.append(epoch)
    assert seen == [0, 1, 2]
    w = _np(m.weight).copy()
    ptt.seed(99)
    m2 = ptt.nn.Linear(4, 2)
    r2 = inc.checkpoint.train_epoch_range(5, save_dir=str(tmp_path),
                                          model=m2, name="job1")
    assert r2.restored_from == 3
    np.testing.assert_array_equal(_np(m2.weight), w)
    assert list(r2) == [3, 4]
    meta = json.load(open(os.path.join(str(tmp_path), "job1", "meta.json")))
    assert meta["epoch"] == 4

    pt.seed(1)
    jm = pt.nn.Linear(4, 2)
    list(jinc.checkpoint.TrainEpochRange(2, str(tmp_path), model=jm,
                                         name="ref"))
    m3 = ptt.nn.Linear(4, 2)
    r3 = inc.checkpoint.TrainEpochRange(4, str(tmp_path), model=m3,
                                        name="ref")
    assert r3.restored_from == 2
    np.testing.assert_array_equal(_np(m3.weight), _np(jm.weight.data))


# ---------------------------- incubate.autograd -----------------------------
def _pair_call(fn_j, fn_t, *arrays):
    return (fn_j(*(pt.to_tensor(a) for a in arrays)),
            fn_t(*(ptt.to_tensor(a) for a in arrays)))


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)


def test_jvp_and_vjp_match_jax():
    x = np.array([0.3, 1.1, -0.4], np.float32)
    v = np.array([1.0, -2.0, 0.5], np.float32)
    (jo, jd), (to, td) = _pair_call(
        lambda a, b: jinc.autograd.jvp(pt.sin, a, b),
        lambda a, b: inc.autograd.jvp(ptt.sin, a, b), x, v)
    _close(to, jo)
    _close(td, jd)
    assert type(td) is ptt.Tensor
    _, jd1 = jinc.autograd.jvp(lambda t: t * t, pt.to_tensor(x))
    _, td1 = inc.autograd.jvp(lambda t: t * t, ptt.to_tensor(x))
    _close(td1, jd1)
    a, b = np.array([1.0, 2.0], np.float32), np.array([3.0, 4.0], np.float32)
    jo, (ja, jb) = jinc.autograd.vjp(pt.multiply,
                                     [pt.to_tensor(a), pt.to_tensor(b)])
    to, (ta, tb) = inc.autograd.vjp(ptt.multiply,
                                    [ptt.to_tensor(a), ptt.to_tensor(b)])
    for g, w in ((to, jo), (ta, ja), (tb, jb)):
        _close(g, w)


def test_jacobian_and_hessian_match_jax():
    """Dense, batched and multi-input Jacobians; a quadratic's Hessian
    and a multi-input one."""
    W = np.array([[1.0, 2.0, 0.0], [0.5, -1.0, 3.0]], np.float32)
    x = np.array([0.2, -0.3, 0.7], np.float32)
    xb = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    a, b = np.array([1.0, 2.0], np.float32), np.array([3.0], np.float32)
    A = np.array([[2.0, 1.0], [1.0, 4.0]], np.float32)
    cases = [
        (lambda m, api: m.Jacobian(
            lambda t: api.matmul(api.to_tensor(W), t), api.to_tensor(x)),
         (3, 2)),
        (lambda m, api: m.Jacobian(lambda t: t * t, api.to_tensor(xb),
                                   is_batched=True), None),
        (lambda m, api: m.Jacobian(
            lambda s, t: s * api.expand(t, [2]),
            [api.to_tensor(a), api.to_tensor(b)]), None),
        (lambda m, api: m.Hessian(
            lambda t: 0.5 * api.sum(t * api.matmul(api.to_tensor(A), t)),
            api.to_tensor(A[0])), None),
        (lambda m, api: m.Hessian(
            lambda s, t: api.sum(s * s * t),
            [api.to_tensor(a[:1]), api.to_tensor(b)]), None),
    ]
    for make, _ in cases:
        j = make(jinc.autograd, pt)
        t = make(inc.autograd, ptt)
        assert t.shape == j.shape
        _close(t.numpy(), j.numpy())
    jac = cases[0][0](inc.autograd, ptt)
    _close(jac[0, :], W[0])


def test_forward_grad_grad_and_prim_toggles_match_jax():
    xs = np.array([0.5, 1.5], np.float32)
    v = np.array([1.0, -1.0], np.float32)
    out = []
    for api, mod in ((pt, jinc.autograd), (ptt, inc.autograd)):
        x = api.to_tensor(xs, stop_gradient=False)
        y = api.sum(api.sin(x) * x)
        (jv,) = mod.forward_grad([y], [x], [api.to_tensor(v)])
        s = api.to_tensor(np.array(1.2, np.float32), stop_gradient=False)
        g2 = mod.grad(mod.grad(s * s * s, s), s)
        out.append((jv, g2))
    for got, want in zip(out[1], out[0]):
        _close(got, want)
    _close(out[1][1], 6 * 1.2)
    m = inc.autograd
    assert not m.prim_enabled()
    m.enable_prim()
    assert m.prim_enabled()
    m.disable_prim()
    assert not m.prim_enabled()


# ------------------------------ incubate.asp --------------------------------
def test_asp_masks_match_jax():
    rng = np.random.RandomState(0)
    mat = rng.randn(8, 16).astype(np.float32)
    for fn in ("get_mask_1d", "get_mask_2d_greedy"):
        got = getattr(inc.asp, fn)(mat, 2, 4)
        np.testing.assert_array_equal(got, getattr(jinc.asp, fn)(mat, 2, 4))
    assert inc.asp.check_mask_1d(mat * inc.asp.get_mask_1d(mat))
    assert inc.asp.calculate_density(torch.as_tensor(mat)) == 1.0


def test_asp_prune_and_decorate_match_jax():
    """``prune_model`` (``fc2`` excluded) and a decorated SGD step in both
    packages: equal pruned weights, equal weights after the step, the
    2:4 pattern kept, ``fc2`` dense."""
    def net(nn):
        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = nn.Linear(8, 16)
                self.fc2 = nn.Linear(16, 4)

            def forward(self, x):
                return self.fc2(self.fc1(x))
        return Net()

    pt.seed(5)
    jm = net(pt.nn)
    tm = _twin(jm, net(ptt.nn))
    x = np.random.RandomState(5).randn(4, 8).astype(np.float32)
    models = ((jm, pt, jinc.asp), (tm, ptt, inc.asp))
    for m, api, asp in models:
        asp.set_excluded_layers(m, ["fc2.weight"])
        asp.prune_model(m, n=2, m=4)
        opt = asp.decorate(api.optimizer.SGD(learning_rate=0.05,
                                             parameters=m.parameters()))
        loss = api.mean(api.square(m(api.to_tensor(x))))
        loss.backward()
        opt.step()
        asp.reset_excluded_layers(m)
    assert sorted(inc.asp.ASPHelper.masks_for(tm)) == ["fc1.weight"]
    js = state_dict_from_jax(jm)
    for n, p in numpy_state(tm).items():
        np.testing.assert_allclose(p, js[n], rtol=1e-5, atol=1e-7,
                                   err_msg=n)
    assert inc.asp.check_mask_1d(_np(tm.fc1.weight), 2, 4)
    assert inc.asp.calculate_density(tm.fc1.weight) <= 0.5
    assert inc.asp.calculate_density(tm.fc2.weight) > 0.9
