"""The port's layer set (``paddle_tpu_torch.nn``) against the JAX
package's own layers, on the CPU: every activation, ``LayerNorm`` with
and without parameters, the biased ``Linear``, the convolutions, each
ported loss, ``MultiHeadAttention`` (self, cross, ``need_weights``, the
``Cache`` step by step against the full causal pass, the causal-tagged
mask) and the encoder and decoder stacks; the initializers by their
statistics and fans (seeded draws cannot match across frameworks), the
generator and dropout, and the containers' parameter names.

Weights cross through numpy (``state_dict_from_jax`` ->
``load_numpy_state``); inputs are made from a numpy seed; everything is
float32. Tolerances are those of the reference's ``tests/test_layers.py``
(rtol 1e-4, atol 1e-5) for outputs and twice them for gradients (rtol
2e-4, atol 2e-5: a backward sums in other orders); attention at the
flash tests' rtol 2e-4, atol 2e-5 (``tests/test_flash_attention.py:68``).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
ATTN = dict(rtol=2e-4, atol=2e-5)
CPU = dict(device="cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _twin(jax_layer, port_layer):
    """``port_layer`` with ``jax_layer``'s weights."""
    load_numpy_state(port_layer, state_dict_from_jax(jax_layer))
    return port_layer


def _run_jax(layer, xs, cot, grad_inputs=True):
    """Output, input grads and ``{name: grad}`` of sum(out * cot)."""
    ts = [pt.to_tensor(x, stop_gradient=not grad_inputs) for x in xs]
    out = layer(*ts)
    (out * pt.to_tensor(cot)).sum().backward()
    return (_np(out), [_np(t.grad) for t in ts] if grad_inputs else [],
            {n: _np(p.grad) for n, p in layer.named_parameters()})


def _run_port(layer, xs, cot, grad_inputs=True):
    ts = [torch.from_numpy(x).requires_grad_(grad_inputs) for x in xs]
    out = layer(*ts)
    (out * torch.from_numpy(cot)).sum().backward()
    return (_np(out), [_np(t.grad) for t in ts] if grad_inputs else [],
            {n: _np(p.grad) for n, p in layer.named_parameters()})


def _assert_same(jax_layer, port_layer, xs, grad_inputs=True, seed=0):
    ref = _run_jax(jax_layer, xs, _cot(jax_layer, xs, seed), grad_inputs)
    ours = _run_port(port_layer, xs, _cot(jax_layer, xs, seed), grad_inputs)
    np.testing.assert_allclose(ours[0], ref[0], **FWD)
    for a, b in zip(ours[1], ref[1]):
        np.testing.assert_allclose(a, b, **GRAD)
    assert sorted(ours[2]) == sorted(ref[2])
    for n in ref[2]:
        np.testing.assert_allclose(ours[2][n], ref[2][n], err_msg=n, **GRAD)


def _cot(jax_layer, xs, seed):
    """A seeded cotangent of the output's shape."""
    shape = _np(jax_layer(*[pt.to_tensor(x) for x in xs])).shape
    return np.random.RandomState(100 + seed).randn(*shape).astype(np.float32)


def _x(*shape, seed=0, scale=2.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# ------------------------------ activations ----------------------------------
ACTIVATIONS = {
    "CELU": {}, "ELU": {"alpha": 0.7}, "GELU": {},
    "GELU_tanh": {"approximate": True}, "GLU": {}, "Hardshrink": {},
    "Hardsigmoid": {}, "Hardswish": {}, "Hardtanh": {}, "LeakyReLU": {},
    "LogSigmoid": {}, "LogSoftmax": {}, "Maxout": {"groups": 2},
    "Mish": {}, "PReLU": {"num_parameters": 4}, "ReLU": {}, "ReLU6": {},
    "RReLU": {}, "SELU": {}, "Sigmoid": {}, "Silu": {}, "Softmax": {},
    "Softplus": {}, "Softshrink": {}, "Softsign": {}, "Swish": {},
    "Tanh": {}, "Tanhshrink": {}, "ThresholdedReLU": {},
}


def test_every_activation_of_the_reference_is_ported():
    from paddle_tpu.nn.layer import activation as ja
    from paddle_tpu_torch.nn.layer import activation as ta
    assert sorted(ta.__all__) == sorted(ja.__all__)
    assert sorted({k.split("_")[0] for k in ACTIVATIONS}) == \
        sorted(ja.__all__)


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_matches_jax(name):
    """Forward and input gradient (RReLU at inference, where it is not
    random; PReLU's per-channel slope gets its gradient too)."""
    cls = name.split("_")[0]
    kw = ACTIVATIONS[name]
    jl = getattr(jnn, cls)(**kw)
    extra = CPU if cls == "PReLU" else {}
    tl = _twin(jl, getattr(tnn, cls)(**kw, **extra))
    if cls == "RReLU":
        jl.eval()
        tl.eval()
    _assert_same(jl, tl, [_x(3, 4, 6, seed=len(name))])


# --------------------------- Linear, LayerNorm -------------------------------
@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(bias):
    pt.seed(1)
    jl = jnn.Linear(6, 5, bias_attr=None if bias else False)
    tl = _twin(jl, tnn.Linear(6, 5, bias_attr=None if bias else False,
                              **CPU))
    assert (tl.bias is None) is (not bias)
    _assert_same(jl, tl, [_x(2, 3, 6)])


def test_linear_defaults_and_attrs():
    """Paddle's defaults: a Xavier-uniform weight over (in + out) and a
    zero bias; an initializer in either attr sets the start values; a
    ``ParamAttr(trainable=False)`` weight needs no gradient."""
    ptt.seed(3)
    m = tnn.Linear(300, 500, **CPU)
    limit = math.sqrt(6.0 / 800)
    w = m.weight.detach()
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > \
        0.99 * limit
    assert abs(float(w.std()) - limit / math.sqrt(3)) < 0.01 * limit
    assert torch.all(m.bias == 0)
    m = tnn.Linear(4, 3, weight_attr=I.Constant(0.5),
                   bias_attr=I.Constant(-1.0), **CPU)
    assert torch.all(m.weight == 0.5) and torch.all(m.bias == -1.0)
    from paddle_tpu_torch.param_attr import ParamAttr
    m = tnn.Linear(4, 3, weight_attr=ParamAttr(trainable=False), **CPU)
    assert not m.weight.requires_grad and m.bias.requires_grad


@pytest.mark.parametrize("affine", ["both", "none", "weight_only",
                                    "eps_1e-12"])
def test_layer_norm_matches_jax(affine):
    kw = {"none": dict(weight_attr=False, bias_attr=False),
          "weight_only": dict(bias_attr=False),
          "eps_1e-12": dict(epsilon=1e-12)}.get(affine, {})
    jl = jnn.LayerNorm(8, **kw)
    tl = tnn.LayerNorm(8, **kw, **CPU)
    assert (tl.weight is None) == (affine == "none")
    assert (tl.bias is None) == (affine in ("none", "weight_only"))
    if affine != "none":
        rng = np.random.RandomState(2)
        st = {n: v + rng.randn(*v.shape).astype(np.float32)
              for n, v in state_dict_from_jax(jl).items()}
        jl.set_state_dict({n: pt.to_tensor(v) for n, v in st.items()})
    _twin(jl, tl)
    _assert_same(jl, tl, [_x(2, 5, 8, seed=3)])


def test_embedding_padding_idx_and_default_init():
    ptt.seed(4)
    m = tnn.Embedding(2000, 64, padding_idx=0, **CPU)
    assert torch.all(m.weight[0] == 0)
    assert abs(float(m.weight[1:].detach().std()) - 1.0) < 0.02
    out = m(torch.tensor([[0, 3]]))
    assert torch.all(out[0, 0] == 0)
    assert torch.equal(out[0, 1], m.weight[3])


def test_identity_flatten_dropout_layers():
    x = torch.randn(2, 3, 4)
    assert tnn.Identity()(x) is x
    assert tnn.Flatten()(x).shape == (2, 12)
    assert tnn.Flatten(0, 1)(x).shape == (6, 4)
    d = tnn.Dropout(0.5)
    d.eval()
    assert d(x) is x
    d = tnn.Dropout(0.5, mode="downscale_in_infer")
    d.eval()
    torch.testing.assert_close(d(x), x * 0.5)


# ------------------------------ convolutions ---------------------------------
CONV2D = {
    "patchify": dict(kernel_size=2, stride=2),
    "k3_pad1_groups2": dict(kernel_size=3, padding=1, groups=2),
    "same_stride2": dict(kernel_size=3, stride=2, padding="SAME"),
    "uneven_pad": dict(kernel_size=3, padding=[0, 1, 1, 2]),
    "dilated": dict(kernel_size=3, dilation=2, padding=2),
    "nhwc": dict(kernel_size=3, padding=1, data_format="NHWC"),
    "no_bias": dict(kernel_size=3, bias_attr=False),
}


@pytest.mark.parametrize("name", sorted(CONV2D))
def test_conv2d_matches_jax(name):
    kw = CONV2D[name]
    pt.seed(5)
    jl = jnn.Conv2D(4, 6, **kw)
    tl = _twin(jl, tnn.Conv2D(4, 6, **kw, **CPU))
    shape = (2, 9, 9, 4) if name == "nhwc" else (2, 4, 9, 9)
    _assert_same(jl, tl, [_x(*shape, seed=6)])


@pytest.mark.parametrize("cls,shape,kw", [
    ("Conv1D", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("Conv3D", (1, 2, 5, 6, 5), dict(kernel_size=3, padding=1)),
    ("Conv2DTranspose", (2, 3, 5, 5),
     dict(kernel_size=3, stride=2, padding=1, output_padding=1)),
    ("Conv2DTranspose", (2, 4, 5, 5),
     dict(kernel_size=3, stride=2, padding=[0, 1, 1, 2], groups=2)),
    ("Conv1DTranspose", (2, 3, 7), dict(kernel_size=4, stride=3)),
])
def test_other_convolutions_match_jax(cls, shape, kw):
    pt.seed(7)
    jl = getattr(jnn, cls)(shape[1], 4, **kw)
    tl = _twin(jl, getattr(tnn, cls)(shape[1], 4, **kw, **CPU))
    _assert_same(jl, tl, [_x(*shape, seed=8)])


def test_conv_default_init_and_layout():
    """Paddle's conv default Normal(0, sqrt(2 / fan_in)) over the
    ``[out, in/groups, *k]`` layout, which is PyTorch's."""
    ptt.seed(9)
    m = tnn.Conv2D(16, 256, kernel_size=3, groups=2, **CPU)
    assert tuple(m.weight.shape) == (256, 8, 3, 3)
    std = math.sqrt(2.0 / (8 * 9))
    assert abs(float(m.weight.detach().std()) - std) < 0.03 * std
    torch.testing.assert_close(
        m(torch.ones(1, 16, 3, 3)),
        torch.nn.functional.conv2d(torch.ones(1, 16, 3, 3), m.weight,
                                   m.bias, groups=2))


# --------------------------------- losses ------------------------------------
def _loss_inputs(name, rng):
    if name in ("CrossEntropyLoss", "NLLLoss"):
        logits = rng.randn(6, 5).astype(np.float32)
        if name == "NLLLoss":
            logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        labels = rng.randint(0, 5, 6).astype(np.int32)
        labels[2] = -100
        return logits, labels
    if name == "BCELoss":
        return (rng.uniform(0.05, 0.95, (4, 3)).astype(np.float32),
                rng.randint(0, 2, (4, 3)).astype(np.float32))
    if name == "BCEWithLogitsLoss":
        return (rng.randn(4, 3).astype(np.float32),
                rng.randint(0, 2, (4, 3)).astype(np.float32))
    if name == "KLDivLoss":
        lp = rng.randn(4, 5).astype(np.float32)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        t = rng.uniform(0.01, 1, (4, 5)).astype(np.float32)
        return lp, t / t.sum(-1, keepdims=True)
    return rng.randn(4, 3).astype(np.float32), \
        rng.randn(4, 3).astype(np.float32)


LOSSES = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
          "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss"]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name, reduction):
    a, b = _loss_inputs(name, np.random.RandomState(LOSSES.index(name)))
    jl = getattr(jnn, name)(reduction=reduction)
    tl = getattr(tnn, name)(reduction=reduction)
    ja = pt.to_tensor(a, stop_gradient=False)
    jout = jl(ja, pt.to_tensor(b))
    jout.sum().backward()
    ta = torch.from_numpy(a).requires_grad_()
    tout = tl(ta, torch.from_numpy(b))
    tout.sum().backward()
    np.testing.assert_allclose(_np(tout), _np(jout), **FWD)
    np.testing.assert_allclose(_np(ta.grad), _np(ja.grad), **GRAD)


def test_loss_options_match_jax():
    """The weighted forms, BCE's ``pos_weight``, SmoothL1's ``delta``
    and KL's ``batchmean``."""
    rng = np.random.RandomState(11)
    z, t = rng.randn(4, 3).astype(np.float32), \
        rng.randint(0, 2, (4, 3)).astype(np.float32)
    w, pw = rng.uniform(0.5, 2, (4, 3)).astype(np.float32), \
        rng.uniform(0.5, 2, 3).astype(np.float32)
    T = torch.from_numpy
    cases = [
        (JF.binary_cross_entropy_with_logits(
            pt.to_tensor(z), pt.to_tensor(t), pt.to_tensor(w),
            pos_weight=pt.to_tensor(pw)),
         F.binary_cross_entropy_with_logits(T(z), T(t), T(w),
                                            pos_weight=T(pw))),
        (JF.smooth_l1_loss(pt.to_tensor(z), pt.to_tensor(t), delta=0.5),
         F.smooth_l1_loss(T(z), T(t), delta=0.5))]
    lp, lbl = _loss_inputs("NLLLoss", rng)
    cw = rng.uniform(0.5, 2, 5).astype(np.float32)
    cases.append((JF.nll_loss(pt.to_tensor(lp), pt.to_tensor(lbl),
                              pt.to_tensor(cw)),
                  F.nll_loss(T(lp), T(lbl), T(cw))))
    lp, q = _loss_inputs("KLDivLoss", rng)
    cases.append((JF.kl_div(pt.to_tensor(lp), pt.to_tensor(q), "batchmean"),
                  F.kl_div(T(lp), T(q), "batchmean")))
    for ref, ours in cases:
        np.testing.assert_allclose(_np(ours), _np(ref), **FWD)


# --------------------------- MultiHeadAttention ------------------------------
def _mha_pair(seed=12, **kw):
    pt.seed(seed)
    jl = jnn.MultiHeadAttention(16, 4, **kw)
    return jl, _twin(jl, tnn.MultiHeadAttention(16, 4, **kw, **CPU))


def test_mha_self_attention_matches_jax():
    jl, tl = _mha_pair()
    x = _x(2, 7, 16, seed=13, scale=1.0)
    ref = _run_jax(jl, [x], _cot(jl, [x], 1))
    ours = _run_port(tl, [x], _cot(jl, [x], 1))
    np.testing.assert_allclose(ours[0], ref[0], **ATTN)
    np.testing.assert_allclose(ours[1][0], ref[1][0], **ATTN)
    for n in ref[2]:
        np.testing.assert_allclose(ours[2][n], ref[2][n], err_msg=n, **ATTN)


def test_mha_cross_attention_with_a_bool_mask_matches_jax():
    pt.seed(14)
    jl = jnn.MultiHeadAttention(16, 4, kdim=12, vdim=10)
    tl = _twin(jl, tnn.MultiHeadAttention(16, 4, kdim=12, vdim=10, **CPU))
    q, k, v = _x(2, 5, 16, seed=1), _x(2, 9, 12, seed=2), _x(2, 9, 10, seed=3)
    mask = np.random.RandomState(4).rand(2, 1, 5, 9) > 0.3
    mask[..., 0] = True
    ref = jl(*[pt.to_tensor(a) for a in (q, k, v)],
             attn_mask=pt.to_tensor(mask))
    ours = tl(*[torch.from_numpy(a) for a in (q, k, v)],
              attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(ours), _np(ref), **ATTN)


def test_mha_need_weights_matches_jax():
    jl, tl = _mha_pair(need_weights=True)
    x = _x(2, 6, 16, seed=15, scale=1.0)
    mask = np.where(np.tril(np.ones((6, 6), bool)), 0.0,
                    -1e9).astype(np.float32)
    ref_out, ref_w = jl(pt.to_tensor(x), attn_mask=pt.to_tensor(mask))
    out, w = tl(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    assert tuple(w.shape) == (2, 4, 6, 6)
    np.testing.assert_allclose(_np(w), _np(ref_w), **ATTN)
    np.testing.assert_allclose(_np(out), _np(ref_out), **ATTN)


def test_mha_cache_step_by_step_equals_the_causal_pass():
    """Decoding one token at a time through a growing ``Cache`` gives the
    full pass under the causal-tagged mask, in the port and in the
    reference."""
    jl, tl = _mha_pair(seed=16)
    tl.eval()
    x = _x(2, 6, 16, seed=17, scale=1.0)
    jmask = jnn.Transformer.generate_square_subsequent_mask(6)
    tmask = tnn.Transformer.generate_square_subsequent_mask(6, **CPU)
    ref_full = _np(jl(pt.to_tensor(x), attn_mask=jmask))
    full = tl(torch.from_numpy(x), attn_mask=tmask)
    np.testing.assert_allclose(_np(full), ref_full, **ATTN)
    cache = tl.gen_cache(torch.from_numpy(x))
    assert tuple(cache.k.shape) == (2, 0, 4, 4)
    steps = []
    for t in range(6):
        out, cache = tl(torch.from_numpy(x[:, t:t + 1]), cache=cache)
        steps.append(out)
    assert tuple(cache.k.shape) == (2, 6, 4, 4)
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), **ATTN)


def test_causal_tag_takes_the_causal_path_without_reading_the_mask():
    """A tagged mask is never read: zeros carrying the tag give the
    causal result, untagged zeros the full one."""
    rng = np.random.RandomState(18)
    q = torch.from_numpy(rng.randn(2, 8, 2, 8).astype(np.float32))
    tagged = torch.zeros(8, 8)
    tagged._causal_diag = True
    causal = F.scaled_dot_product_attention(q, q, q, is_causal=True)
    torch.testing.assert_close(
        F.scaled_dot_product_attention(q, q, q, attn_mask=tagged), causal)
    full = F.scaled_dot_product_attention(q, q, q,
                                          attn_mask=torch.zeros(8, 8))
    assert not torch.allclose(full, causal)
    m = tnn.Transformer.generate_square_subsequent_mask(5, **CPU)
    assert m._causal_diag and m.dtype == torch.float32
    assert float(m[0, 1]) == float(np.finfo(np.float32).min) and \
        float(m[1, 0]) == 0.0


# ------------------------- encoder / decoder stacks --------------------------
@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_encoder_matches_jax(normalize_before):
    pt.seed(19)
    kw = dict(dropout=0.0, activation="gelu",
              normalize_before=normalize_before)
    jl = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(16, 4, 32, **kw),
                                2, jnn.LayerNorm(16))
    tl = _twin(jl, tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(16, 4, 32, **kw, **CPU), 2,
        tnn.LayerNorm(16, **CPU)))
    names = [n for n, _ in tl.named_parameters()]
    assert "layers.1.self_attn.q_proj.bias" in names and \
        "norm.weight" in names
    # the stack's layers start as copies of the first, as in Paddle
    torch.testing.assert_close(tl.layers[0].linear1.weight,
                               tl.layers[1].linear1.weight)
    _assert_same(jl, tl, [_x(2, 6, 16, seed=20, scale=1.0)])


def test_transformer_decoder_and_full_model_match_jax():
    """The encoder-decoder with the causal-tagged target mask, and the
    decoder's incremental cache (self ``Cache`` + cross ``StaticCache``)
    step by step against the full pass."""
    pt.seed(21)
    kw = dict(d_model=16, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=32, dropout=0.0)
    jm = jnn.Transformer(**kw)
    tm = _twin(jm, tnn.Transformer(**kw, **CPU))
    tm.eval()
    src, tgt = _x(2, 7, 16, seed=22, scale=1.0), _x(2, 5, 16, seed=23,
                                                    scale=1.0)
    ref = _np(jm(pt.to_tensor(src), pt.to_tensor(tgt),
                 tgt_mask=jnn.Transformer.generate_square_subsequent_mask(5)))
    tmask = tnn.Transformer.generate_square_subsequent_mask(5, **CPU)
    full = tm(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask)
    np.testing.assert_allclose(_np(full), ref, **ATTN)
    memory = tm.encoder(torch.from_numpy(src))
    cache = tm.decoder.gen_cache(memory)
    steps = []
    for t in range(5):
        out, cache = tm.decoder(torch.from_numpy(tgt[:, t:t + 1]), memory,
                                cache=cache)
        steps.append(out)
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), **ATTN)


# ------------------------------ initializers ---------------------------------
def test_fans_and_gain_follow_paddle():
    from paddle_tpu.nn import initializer as JI
    for shape in ([7], [30, 50], [8, 4, 3, 3], [6, 2, 5]):
        assert I._fans(shape) == JI._fans(shape)
    for nl, p in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("conv2d", None)):
        assert I.calculate_gain(nl, p) == JI.calculate_gain(nl, p)


@pytest.mark.parametrize("name,shape,want_std", [
    ("Normal", [400, 300], 0.5),
    ("TruncatedNormal", [400, 300], 0.5 * 0.8796),
    ("Uniform", [400, 300], 2.0 / math.sqrt(12)),
    ("XavierNormal", [400, 300], math.sqrt(2.0 / 700)),
    ("XavierUniform", [400, 300], math.sqrt(6.0 / 700) / math.sqrt(3)),
    ("XavierUniform", [64, 32, 3, 3],
     math.sqrt(6.0 / (9 * 96)) / math.sqrt(3)),
    ("KaimingNormal", [400, 300], math.sqrt(2.0 / 400)),
    ("KaimingUniform", [64, 32, 3, 3], math.sqrt(2.0 / 288)),
])
def test_initializer_statistics(name, shape, want_std):
    """Mean, spread and bounds of a large draw (a Linear is [in, out]: its
    fan_in is shape[0])."""
    kw = {"Normal": dict(mean=1.0, std=0.5),
          "TruncatedNormal": dict(mean=1.0, std=0.5),
          "Uniform": dict(low=-1.0, high=1.0)}.get(name, {})
    ptt.seed(22)
    t = getattr(I, name)(**kw)(shape, "float32", "cpu")
    assert tuple(t.shape) == tuple(shape) and t.dtype == torch.float32
    mean = kw.get("mean", 0.0)
    assert abs(float(t.mean()) - mean) < 0.02 * max(want_std, 0.1)
    assert abs(float(t.std()) - want_std) < 0.02 * want_std
    if name == "TruncatedNormal":
        assert float((t - 1.0).abs().max()) <= 2 * 0.5 + 1e-6
    if "Uniform" in name:
        lim = want_std * math.sqrt(3)
        assert float(t.abs().max()) <= lim * (1 + 1e-6)


def test_initializers_are_seeded_and_dtype_independent():
    ptt.seed(5)
    a = I.Normal()([50, 20], "float32", "cpu")
    b = I.Normal()([50, 20], "bfloat16", "cpu")
    ptt.seed(5)
    c = I.Normal()([50, 20], "float32", "cpu")
    d = I.Normal()([50, 20], "bfloat16", "cpu")
    assert torch.equal(a, c) and torch.equal(b, d)
    assert not torch.equal(a.to(torch.bfloat16), b)  # the second draw
    ptt.seed(5)
    assert torch.equal(I.Normal()([50, 20], "bfloat16", "cpu"),
                       a.to(torch.bfloat16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            I.Normal()([2, 2])


def test_constant_assign_orthogonal_dirac():
    assert torch.all(I.Constant(2.5)([3, 4], "float32", "cpu") == 2.5)
    v = np.arange(6, dtype=np.float32)
    torch.testing.assert_close(I.Assign(v)([2, 3], "float32", "cpu"),
                               torch.from_numpy(v).reshape(2, 3))
    ptt.seed(6)
    for shape in ([6, 10], [10, 6], [4, 2, 3]):
        q = I.Orthogonal(gain=2.0)(shape, "float32", "cpu")
        flat = q.reshape(shape[0], -1)
        gram = flat @ flat.t() if shape[0] <= flat.shape[1] else \
            flat.t() @ flat
        torch.testing.assert_close(gram, 4.0 * torch.eye(gram.shape[0]),
                                   atol=1e-5, rtol=0)
    from paddle_tpu.nn import initializer as JI
    for shape, groups in (([4, 4, 3, 3], 1), ([6, 2, 3], 2)):
        np.testing.assert_array_equal(
            _np(I.Dirac(groups)(shape, "float32", "cpu")),
            _np(JI.Dirac(groups)(shape)))


# ------------------------ generator, dropout, containers ---------------------
def test_generator_state_and_guard():
    ptt.seed(7)
    g = gen.torch_generator("cpu")
    state = gen.get_rng_state()
    a = torch.rand(4, generator=g)
    gen.set_rng_state(state)
    assert torch.equal(torch.rand(4, generator=gen.torch_generator("cpu")),
                       a)
    with gen.rng_guard(123):
        b = torch.rand(4, generator=gen.torch_generator("cpu"))
    with gen.rng_guard(123):
        assert torch.equal(
            torch.rand(4, generator=gen.torch_generator("cpu")), b)
    # the guard restored the stream it interrupted
    gen.set_rng_state(state)
    torch.rand(4, generator=gen.torch_generator("cpu"))
    after = torch.rand(4, generator=gen.torch_generator("cpu"))
    gen.set_rng_state(state)
    torch.rand(4, generator=gen.torch_generator("cpu"))
    with gen.rng_guard(1):
        torch.rand(4, generator=gen.torch_generator("cpu"))
    assert torch.equal(torch.rand(4, generator=gen.torch_generator("cpu")),
                       after)
    assert ptt.seed(9) is gen.default_generator and \
        gen.default_generator.seed() == 9


def test_dropout_is_seeded_and_scales_as_paddle():
    x = torch.ones(200, 300)
    ptt.seed(8)
    a = F.dropout(x, 0.25)
    ptt.seed(8)
    b = F.dropout(x, 0.25)
    assert torch.equal(a, b)
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.01
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    c = F.dropout(x, 0.25, mode="downscale_in_infer")
    assert set(torch.unique(c).tolist()) == {0.0, 1.0}
    torch.testing.assert_close(
        F.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
        x * 0.75)
    assert F.dropout(x, 0.25, training=False) is x
    rows = F.dropout(x, 0.5, axis=0)  # one draw per row
    assert bool(((rows == 0).all(1) | (rows == 2.0).all(1)).all())
    assert torch.all(F.dropout(x, 1.0) == 0)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.1, mode="bogus")


def test_containers_name_parameters_as_paddle():
    kw = CPU
    pt.seed(9)
    jseq = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    tseq = tnn.Sequential(tnn.Linear(3, 4, **kw), tnn.ReLU(),
                          tnn.Linear(4, 2, **kw))
    assert [n for n, _ in tseq.named_parameters()] == \
        [n for n, _ in jseq.named_parameters()]
    _twin(jseq, tseq)
    _assert_same(jseq, tseq, [_x(5, 3)])
    named = tnn.Sequential(("fc", tnn.Linear(3, 4, **kw)))
    assert [n for n, _ in named.named_parameters()] == ["fc.weight",
                                                        "fc.bias"]
    ll = tnn.LayerList([tnn.Linear(2, 2, **kw)])
    ll.append(tnn.Linear(2, 3, **kw))
    assert [n for n, _ in ll.named_parameters()][-1] == "1.bias" and \
        len(ll) == 2
    ld = tnn.LayerDict({"a": tnn.Linear(2, 2, **kw)})
    assert "a" in ld and [n for n, _ in ld.named_parameters()] == \
        ["a.weight", "a.bias"]
    pl = tnn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    assert [n for n, _ in pl.named_parameters()] == ["0"]
