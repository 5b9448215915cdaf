"""The port's batch, group, instance, local-response and spectral norms
and its pools (``paddle_tpu_torch.nn``) against the JAX package's own
layers, on the CPU: outputs, input and parameter gradients, and the
running statistics after two training forwards (the reference's biased
variance and momentum 0.9, which PyTorch's own update does not follow).

Weights and buffers cross through numpy (``state_dict_from_jax`` ->
``load_numpy_state``); inputs are made from a numpy seed; everything is
float32, at the tolerance of the reference's ``tests/test_layers.py``
(rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = dict(device="cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _x(*shape, seed=0):
    return (1.5 * np.random.RandomState(seed).randn(*shape) + 0.3).astype(
        np.float32)


def _twin(jax_layer, port_layer):
    load_numpy_state(port_layer, state_dict_from_jax(jax_layer))
    return port_layer


def _both(jax_layer, port_layer, x, seed=0):
    """One forward and backward of sum(out * cot) through each layer:
    (output, input grad, {name: param grad}) per side."""
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_layer(xt)
    cot = np.random.RandomState(100 + seed).randn(*out.shape).astype(
        np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    ours = (_np(out), _np(xt.grad),
            {n: _np(p.grad) for n, p in port_layer.named_parameters()})
    xj = pt.to_tensor(x, stop_gradient=False)
    outj = jax_layer(xj)
    (outj * pt.to_tensor(cot)).sum().backward()
    ref = (_np(outj), _np(xj.grad),
           {n: _np(p.grad) for n, p in jax_layer.named_parameters()})
    return ours, ref


def _assert_same(jax_layer, port_layer, x, seed=0):
    ours, ref = _both(jax_layer, port_layer, x, seed)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    np.testing.assert_allclose(ours[1], ref[1], **TOL)
    assert sorted(ours[2]) == sorted(ref[2])
    for n in ref[2]:
        np.testing.assert_allclose(ours[2][n], ref[2][n], err_msg=n, **TOL)


def _assert_buffers(jax_layer, port_layer):
    ref = {n: _np(b) for n, b in jax_layer.named_buffers()}
    ours = {n: _np(b) for n, b in port_layer.named_buffers()}
    assert sorted(ours) == sorted(ref)
    for n in ref:
        np.testing.assert_allclose(ours[n], ref[n], err_msg=n, **TOL)


# ------------------------------ batch norm -----------------------------------
BN_CASES = {
    "1D_NC": ("BatchNorm1D", (6, 4), {}),
    "1D_NCL": ("BatchNorm1D", (3, 4, 5), {}),
    "2D": ("BatchNorm2D", (2, 4, 3, 5), {}),
    "3D": ("BatchNorm3D", (2, 4, 2, 3, 3), {}),
    "2D_NHWC": ("BatchNorm2D", (2, 3, 5, 4), {"data_format": "NHWC"}),
    "alias": ("BatchNorm", (2, 4, 3, 3), {"momentum": 0.7}),
    "no_affine": ("BatchNorm2D", (2, 4, 3, 3),
                  {"weight_attr": False, "bias_attr": False}),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_trains_and_evaluates_as_jax(case):
    """Two training forwards (outputs and every gradient, then the
    running statistics), then an eval forward on the moved statistics."""
    cls, shape, kw = BN_CASES[case]
    pt.seed(1)
    jl = getattr(jnn, cls)(4, **kw)
    tl = _twin(jl, getattr(tnn, cls)(4, **kw, **CPU))
    for i in range(2):
        _assert_same(jl, tl, _x(*shape, seed=i), seed=i)
    _assert_buffers(jl, tl)
    assert not np.allclose(_np(tl._mean), 0.0)
    jl.eval()
    tl.eval()
    _assert_same(jl, tl, _x(*shape, seed=5), seed=5)
    _assert_buffers(jl, tl)


def test_batch_norm_use_global_stats_trains_on_the_running_stats():
    """``use_global_stats=True`` normalises with the running buffers in
    training and leaves them where they are."""
    pt.seed(2)
    jl = jnn.BatchNorm2D(4, use_global_stats=True)
    tl = tnn.BatchNorm2D(4, use_global_stats=True, **CPU)
    state = state_dict_from_jax(jl)
    state["_mean"] = np.array([0.5, -1.0, 0.0, 2.0], np.float32)
    state["_variance"] = np.array([2.0, 0.5, 1.0, 3.0], np.float32)
    load_numpy_state(tl, state)
    jl.set_state_dict({k: pt.to_tensor(v) for k, v in state.items()})
    _assert_same(jl, tl, _x(2, 4, 3, 3))
    _assert_buffers(jl, tl)
    np.testing.assert_array_equal(_np(tl._mean), state["_mean"])


def test_functional_batch_norm_updates_to_the_reference_formula():
    """The update is ``momentum * running + (1 - momentum) * batch`` with
    the biased batch variance, written out here in numpy."""
    x = _x(5, 3, 4)
    rm = np.array([0.1, 0.2, -0.3], np.float32)
    rv = np.array([1.5, 0.5, 2.0], np.float32)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    out = F.batch_norm(torch.from_numpy(x), trm, trv, training=True,
                       momentum=0.8, data_format="NCL")
    mean, var = x.mean(axis=(0, 2)), x.var(axis=(0, 2))
    np.testing.assert_allclose(_np(trm), 0.8 * rm + 0.2 * mean, **TOL)
    np.testing.assert_allclose(_np(trv), 0.8 * rv + 0.2 * var, **TOL)
    want = (x - mean[None, :, None]) / np.sqrt(var[None, :, None] + 1e-5)
    np.testing.assert_allclose(_np(out), want, rtol=1e-4, atol=1e-4)


def test_bfloat16_batch_norm_keeps_bfloat16_running_stats():
    """As the reference's ``Layer.to(dtype)`` casts floating buffers, a
    bfloat16 layer keeps its running statistics in bfloat16."""
    tl = tnn.BatchNorm2D(4, dtype="bfloat16", **CPU)
    x = torch.from_numpy(_x(2, 4, 3, 3)).to(torch.bfloat16)
    assert tl(x).dtype == torch.bfloat16
    assert tl._mean.dtype == tl._variance.dtype == torch.bfloat16
    assert tl.float()._mean.dtype == torch.float32


def test_convert_sync_batchnorm():
    """Every batch norm of a stack becomes a ``SyncBatchNorm`` with its
    parameters and statistics; on one process it computes as before."""
    pt.seed(3)
    jm = jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4), jnn.ReLU())
    tm = _twin(jm, tnn.Sequential(tnn.Conv2D(3, 4, 3, **CPU),
                                  tnn.BatchNorm2D(4, **CPU), tnn.ReLU()))
    jm(pt.to_tensor(_x(2, 3, 6, 6, seed=7)))
    tm(torch.from_numpy(_x(2, 3, 6, 6, seed=7)))
    js = jnn.SyncBatchNorm.convert_sync_batchnorm(jm)
    ts = tnn.SyncBatchNorm.convert_sync_batchnorm(tm)
    assert isinstance(ts[1], tnn.SyncBatchNorm)
    assert isinstance(js[1], jnn.SyncBatchNorm)
    _assert_buffers(js, ts)
    _assert_same(js, ts, _x(2, 3, 6, 6))
    _assert_buffers(js, ts)


# ------------------------- group / instance / LRN ----------------------------
@pytest.mark.parametrize("shape", [(2, 6, 5), (2, 6, 3, 4)])
def test_group_norm(shape):
    pt.seed(4)
    jl = jnn.GroupNorm(3, 6)
    tl = _twin(jl, tnn.GroupNorm(3, 6, **CPU))
    with torch.no_grad():  # a scale and shift that are not 1 and 0
        tl.weight.uniform_(0.5, 1.5)
        tl.bias.uniform_(-0.5, 0.5)
    jl.set_state_dict({k: pt.to_tensor(_np(v)) for k, v in
                       tl.state_dict().items()})
    _assert_same(jl, tl, _x(*shape))


@pytest.mark.parametrize("cls,shape", [("InstanceNorm1D", (2, 3, 6)),
                                       ("InstanceNorm2D", (2, 3, 4, 5)),
                                       ("InstanceNorm3D", (2, 3, 2, 3, 4))])
def test_instance_norm(cls, shape):
    pt.seed(5)
    jl = getattr(jnn, cls)(3)
    tl = _twin(jl, getattr(tnn, cls)(3, **CPU))
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "scale"]
    _assert_same(jl, tl, _x(*shape))


@pytest.mark.parametrize("size", [3, 4])
def test_local_response_norm(size):
    jl = jnn.LocalResponseNorm(size, alpha=0.1, beta=0.75, k=2.0)
    tl = tnn.LocalResponseNorm(size, alpha=0.1, beta=0.75, k=2.0)
    _assert_same(jl, tl, _x(2, 6, 3, 4))


def test_channel_last_instance_group_and_lrn_raise():
    """The reference reads axis 1 as the channels whatever the format;
    the port carries channels-first only and says so."""
    x = torch.from_numpy(_x(2, 4, 4, 6))
    for call in (lambda: F.group_norm(x, 2, data_format="NHWC"),
                 lambda: F.instance_norm(x, data_format="NHWC"),
                 lambda: F.local_response_norm(x, 3, data_format="NHWC")):
        with pytest.raises(NotImplementedError, match="channels-first"):
            call()


def test_spectral_norm_same_vectors_through_the_bridge():
    """The power-iteration vectors cross as buffers; two forwards give
    the reference's outputs, weight gradients (through sigma and the
    iterates) and updated vectors."""
    pt.seed(6)
    jl = jnn.SpectralNorm([4, 3, 2], dim=1, power_iters=2)
    tl = _twin(jl, tnn.SpectralNorm([4, 3, 2], dim=1, power_iters=2, **CPU))
    assert sorted(n for n, _ in tl.named_buffers()) == \
        ["weight_u", "weight_v"]
    for i in range(2):
        _assert_same(jl, tl, _x(4, 3, 2, seed=i), seed=i)
        _assert_buffers(jl, tl)


# ------------------------------- pooling -------------------------------------
POOLS = {
    1: ((2, 3, 9), 3, 2, 1),
    2: ((2, 3, 8, 9), (3, 2), (2, 2), (1, 1)),
    3: ((1, 2, 7, 8, 6), 3, 2, 1),
}


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("ceil_mode", [False, True])
def test_max_pool(nd, ceil_mode):
    shape, k, s, p = POOLS[nd]
    jl = getattr(jnn, f"MaxPool{nd}D")(k, s, p, ceil_mode=ceil_mode)
    tl = getattr(tnn, f"MaxPool{nd}D")(k, s, p, ceil_mode=ceil_mode)
    _assert_same(jl, tl, _x(*shape))


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
def test_avg_pool(nd, ceil_mode, exclusive):
    """Exclusive divides by the window's input elements, padding and the
    ceil overhang left out; non-exclusive always by the kernel's size."""
    shape, k, s, p = POOLS[nd]
    jl = getattr(jnn, f"AvgPool{nd}D")(k, s, p, ceil_mode=ceil_mode,
                                       exclusive=exclusive)
    tl = getattr(tnn, f"AvgPool{nd}D")(k, s, p, ceil_mode=ceil_mode,
                                       exclusive=exclusive)
    _assert_same(jl, tl, _x(*shape))


def test_ceil_mode_keeps_the_last_partial_window():
    x = torch.from_numpy(_x(1, 1, 8, 8))
    assert F.max_pool2d(x, 3, 2, 1).shape[-1] == 4
    assert F.max_pool2d(x, 3, 2, 1, ceil_mode=True).shape[-1] == 5


@pytest.mark.parametrize("fmt,shape,mode", [("NLC", (2, 9, 3), "max"),
                                            ("NHWC", (2, 8, 9, 3), "avg"),
                                            ("NHWC", (2, 8, 9, 3), "max")])
def test_channel_last_pool(fmt, shape, mode):
    nd = len(shape) - 2
    name = f"{'Max' if mode == 'max' else 'Avg'}Pool{nd}D"
    jl = getattr(jnn, name)(3, 2, 1, ceil_mode=True, data_format=fmt)
    tl = getattr(tnn, name)(3, 2, 1, ceil_mode=True, data_format=fmt)
    _assert_same(jl, tl, _x(*shape))


def test_height_pool_with_stride_none():
    """PP-OCR's ``kernel_size=[h, 1]``, no stride: the stride is the
    kernel, so the height collapses to 1 and the width stays."""
    x = _x(2, 4, 6, 10)
    jo = JF.max_pool2d(pt.to_tensor(x), kernel_size=[6, 1])
    to = F.max_pool2d(torch.from_numpy(x), kernel_size=[6, 1])
    assert tuple(to.shape) == (2, 4, 1, 10)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    _assert_same(jnn.AvgPool2D([3, 1]), tnn.AvgPool2D([3, 1]), x)


@pytest.mark.parametrize("mode", ["Avg", "Max"])
@pytest.mark.parametrize("nd,shape,out", [(1, (2, 3, 7), 3),
                                          (2, (2, 3, 7, 5), (3, 2)),
                                          (3, (1, 2, 5, 7, 4), (2, 3, 3))])
def test_adaptive_pool_uneven_bins(mode, nd, shape, out):
    jl = getattr(jnn, f"Adaptive{mode}Pool{nd}D")(out)
    tl = getattr(tnn, f"Adaptive{mode}Pool{nd}D")(out)
    _assert_same(jl, tl, _x(*shape))


def test_adaptive_pool_channel_last():
    jl = jnn.AdaptiveAvgPool2D((3, 2), data_format="NHWC")
    tl = tnn.AdaptiveAvgPool2D((3, 2), data_format="NHWC")
    _assert_same(jl, tl, _x(2, 7, 5, 3))


def test_max_pool_index_and_unpool_round_trip():
    """The reference's ``max_pool2d_with_index`` and ``max_unpool2d`` (and
    the ``MaxUnPool2D`` layer): the same values, flat indices and
    scattered planes; the unpool's gradient too."""
    x = _x(2, 3, 8, 8, seed=6)
    jout, jidx = JF.max_pool2d_with_index(pt.to_tensor(x), 2, stride=2)
    tout, tidx = F.max_pool2d_with_index(torch.from_numpy(x), 2, stride=2)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    np.testing.assert_array_equal(_np(tidx), _np(jidx))
    jun = JF.max_unpool2d(jout, jidx, 2, stride=2)
    tun = tnn.MaxUnPool2D(2, stride=2)(tout, tidx)
    np.testing.assert_allclose(_np(tun), _np(jun), **TOL)
    wide = F.max_unpool2d(tout, tidx, 2, stride=2, output_size=[9, 9])
    assert tuple(wide.shape) == (2, 3, 9, 9)


def test_pool_options_not_ported_raise():
    x = torch.from_numpy(_x(1, 1, 8, 8))
    with pytest.raises(NotImplementedError, match="half the window"):
        F.max_pool2d(x, 2, 2, 2)
    with pytest.raises(NotImplementedError, match="return_mask"):
        tnn.MaxPool2D(2, return_mask=True)
    with pytest.raises(NotImplementedError, match="return_mask"):
        F.adaptive_max_pool2d(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="NCHW"):
        F.max_unpool2d(x, x.long(), 2, data_format="NHWC")
