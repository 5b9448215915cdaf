"""``paddle_tpu_torch.quantization`` against ``paddle_tpu.quantization``.

Weight-only PTQ (``weight_only``) on the bridged tiny Llama: the picked
leaves, the int8 values (equal), the scales (rtol 1e-6), the fp8 values
(equal), the sensitivity gate, ``calibrate``'s tap names in order with
their abs-maxes (rtol 1e-5), and ``calibration_from_checkpoint`` reading
a checkpoint of the reference. The QAT/PTQ framework and real int8
execution on the reference test's ``Net`` (``tests/test_quantization.py``),
weights moved through the bridge: fake quantization, its straight-through
gradient, the moving-average scale, QAT training, ``QAT.convert``,
``PTQ`` calibration and convert, and ``convert_to_int8`` with per-tensor
and per-channel scales, 4-bit weights and the convolution's padding forms,
each at the reference test's tolerance.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu.jit.functional import functional_state
from paddle_tpu.quantization import weight_only as jwo
from paddle_tpu_torch import nn
from paddle_tpu_torch import quantization as q
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.quantization import weight_only as wo
from paddle_tpu_torch.quantization.int8 import (int8_matmul,
                                                int8_matmul_exact)
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import (bridged, jax_tiny, one_torch_thread,  # noqa: F401
                               state_dict_from_jax)


def _jstate(jm):
    train, frozen, buffers = functional_state(jm)
    return {**train, **frozen, **buffers}


def _tstate(tm):
    return dict(tm.named_parameters())


# ------------------------------ weight-only PTQ -------------------------------
@pytest.mark.parametrize("tied", [True, False])
def test_int8_weight_quantization_equals_jax(tied):
    """The same leaves are picked (every projection and, untied, the
    head; no embedding or norm), with equal int8 values and scales at
    rtol 1e-6; ``dequantize`` gives the reference's weights."""
    jm = jax_tiny(1, tie_word_embeddings=tied)
    tm = bridged(jm)
    jqs = jwo.quantize_state(_jstate(jm), "int8_wo")
    tqs = wo.quantize_state(_tstate(tm), "int8_wo")
    picked = sorted(k for k, v in jqs.items()
                    if isinstance(v, jwo.QuantizedLeaf))
    assert picked == sorted(k for k, v in tqs.items()
                            if isinstance(v, wo.QuantizedLeaf))
    assert ("lm_head.weight" in picked) is (not tied)
    assert not any("embed" in k or "norm" in k for k in picked)
    for k in picked:
        j, t = jqs[k], tqs[k]
        assert t.q.dtype == torch.int8 and t.axis == j.axis == 1
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q),
                                      err_msg=k)
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(t.dequantize().numpy(),
                                   np.asarray(j.dequantize()), rtol=1e-6,
                                   err_msg=k)
        assert t.nbytes == j.nbytes
    assert wo.quantized_bytes(tqs) == jwo.quantized_bytes(jqs)
    assert q.quantization_metrics()["weight_leaves"].value() == len(picked)


def test_fp8_weight_quantization_equals_jax():
    """``fp8_wo``: float8_e4m3fn values equal to the reference's element
    for element (compared as bits; the differing elements would be
    listed), scale = absmax / 448."""
    jm = jax_tiny(2)
    tm = bridged(jm)
    jqs = jwo.quantize_state(_jstate(jm), "fp8_wo")
    tqs = wo.quantize_state(_tstate(tm), "fp8_wo")
    for k, j in jqs.items():
        if not isinstance(j, jwo.QuantizedLeaf):
            continue
        t = tqs[k]
        assert t.q.dtype == torch.float8_e4m3fn
        ours = t.q.view(torch.uint8).numpy()
        ref = np.asarray(j.q).view(np.uint8)
        diff = np.argwhere(ours != ref)
        assert diff.size == 0, (k, [(tuple(i), ours[tuple(i)],
                                     ref[tuple(i)]) for i in diff[:8]])
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-6)


def test_sensitivity_gate_equals_jax():
    """The reference's gate case: layer 0's attention tap screams
    outliers, layer 1's is healthy; the same names are skipped by both,
    at the default ratio and at an explicit one."""
    jm = jax_tiny(3)
    tm = bridged(jm)
    cal = {"version": 1, "taps": {
        "layers.0.attn": {"absmax": 1000.0, "p99": 1.0},
        "layers.1.attn": {"absmax": 2.0, "p99": 1.0},
        "layers.1.mlp_act": {"absmax": 40.0, "p99": 1.0}}}
    names = sorted(_tstate(tm))
    for ratio in (None, 1.5):
        kw = {} if ratio is None else {"ratio": ratio}
        got = wo.sensitive_params(names, cal, **kw)
        assert got == jwo.sensitive_params(names, cal, ratio)
    assert wo.sensitive_params(names, None) == set()
    skip = wo.sensitive_params(names, cal)
    assert any("layers.0.self_attn" in k for k in skip)
    assert any("layers.1.mlp" in k for k in skip)
    tqs = wo.quantize_state(_tstate(tm), "int8_wo", calibration=cal)
    jqs = jwo.quantize_state(_jstate(jm), "int8_wo", calibration=cal)
    assert sorted(k for k, v in tqs.items()
                  if isinstance(v, wo.QuantizedLeaf)) == \
        sorted(k for k, v in jqs.items() if isinstance(v, jwo.QuantizedLeaf))


def test_calibrate_equals_jax_and_reads_a_reference_checkpoint(tmp_path):
    """``calibrate`` on the bridged Llama: the reference's tap names in
    order and their abs-maxes at rtol 1e-5. ``calibration_from_checkpoint``
    reads the ``"numerics"`` entry of a checkpoint that the reference
    saved (a directory) and of a ``.pdparams`` file, and gives None for a
    checkpoint without one."""
    jm = jax_tiny(4)
    tm = bridged(jm)
    ids = np.random.RandomState(4).randint(0, 256, (2, 10)).astype(np.int32)
    want = jwo.calibrate(jm, pt.to_tensor(ids))
    got = wo.calibrate(tm, torch.from_numpy(ids))
    assert list(got["taps"]) == list(want["taps"])
    for name, s in want["taps"].items():
        np.testing.assert_allclose(got["taps"][name]["absmax"], s["absmax"],
                                   rtol=1e-5, err_msg=name)
        assert got["taps"][name]["p99"] == got["taps"][name]["absmax"]
    from paddle_tpu.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_=False)
    mgr.save(3, {"w": np.ones(2, np.float32), "numerics": want})
    assert wo.calibration_from_checkpoint(str(tmp_path / "ckpt")) == want
    from paddle_tpu_torch.framework import save
    save({"w": torch.ones(2), "numerics": got}, str(tmp_path / "c.pdparams"))
    assert wo.calibration_from_checkpoint(str(tmp_path / "c.pdparams")) \
        == got
    save({"w": torch.ones(2)}, str(tmp_path / "plain.pdparams"))
    assert wo.calibration_from_checkpoint(
        str(tmp_path / "plain.pdparams")) is None


class _MpMesh:
    """A stand-in for rank 1 of a mesh ``{"mp": 2}``: what
    ``shard_quantized`` reads to cut its block."""
    mesh_dim_names = ("mp",)
    shape = (2,)

    def get_coordinate(self):
        return [1]


def test_shard_quantized_waits_for_the_mesh():
    """``shard_quantized`` on the port's mesh (the reference's
    :282-295): the values take the weight's spec, the 1-D scales the
    spec's entry at the channel axis — this rank's half for a
    column-parallel weight, whole for a row-parallel one — so each
    block dequantizes to its block of the full dequantized weight.
    ``tests/test_torch_tp_serving.py`` serves it over gloo ranks."""
    w = torch.randn(4, 8)
    leaf = wo.quantize_leaf(w, "int8_wo")
    full = leaf.dequantize()
    col = wo.shard_quantized(leaf, _MpMesh(), (None, "mp"))
    assert col.q.shape == (4, 4) and col.scale.shape == (4,)
    assert torch.equal(col.q, leaf.q[:, 4:]) and col.axis == 1
    assert torch.equal(col.dequantize(), full[:, 4:])
    row = wo.shard_quantized(leaf, _MpMesh(), ("mp", None))
    assert row.q.shape == (2, 8) and torch.equal(row.scale, leaf.scale)
    assert torch.equal(row.dequantize(), full[2:])
    whole = wo.shard_quantized(leaf, _MpMesh(), None)
    assert torch.equal(whole.q, leaf.q) and whole.dtype == torch.float32
    with pytest.raises(ValueError, match="quantize mode"):
        wo.quantize_state({}, "int4_wo")


# ------------------------------ QAT / PTQ / int8 ------------------------------
class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.act = jnn.ReLU()
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class TNet(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 16, device="cpu")
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(16, 4, device="cpu")

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def _nets(seed, jcls=JNet, tcls=TNet, edit=None):
    """The reference's model and the port's, with the same weights
    (``edit`` may change the numpy state first)."""
    pt.seed(seed)
    jm = jcls()
    state = state_dict_from_jax(jm)
    if edit is not None:
        state = edit(state)
        jm.set_state_dict(state)
    tm = tcls()
    load_numpy_state(tm, state)
    return jm, tm


def _out(model, x, torch_side):
    if torch_side:
        with torch.no_grad():
            return model(torch.from_numpy(x)).numpy()
    return model(pt.to_tensor(x)).numpy()


def _pair(jcfg_kw, tcfg_kw):
    return jq.QuantConfig(**jcfg_kw), q.QuantConfig(**tcfg_kw)


def test_fake_quant_ste_and_moving_average():
    """The reference's three fake-quant cases, on both packages: the
    abs-max grid, the identity gradient and the moving-average scale."""
    from paddle_tpu.quantization.quanters import \
        FakeQuanterWithAbsMaxObserverLayer as JFQ
    from paddle_tpu_torch.quantization.quanters import \
        FakeQuanterWithAbsMaxObserverLayer as TFQ
    x = np.array([-1.0, -0.5, 0.0, 0.26, 1.0], np.float32)
    jfq, tfq = JFQ(bit_length=8), TFQ(bit_length=8)
    jfq.train()
    tfq.train()
    want = jfq(pt.to_tensor(x)).numpy()
    xt = torch.from_numpy(x).requires_grad_()
    got = tfq(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(want, np.round(x * 127) / 127, rtol=1e-6)
    got.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones(5, np.float32))
    jfq, tfq = JFQ(moving_rate=0.9), TFQ(moving_rate=0.9)
    jfq.train()
    tfq.train()
    for v in (2.0, 4.0):
        jfq(pt.to_tensor(np.array([v], np.float32)))
        tfq(torch.tensor([v]))
        assert float(tfq.scales()) == float(jfq.scales().numpy())
    assert float(tfq.scales()) == pytest.approx((0.9 * 2 + 4) / 1.9)


def test_qat_training_and_convert_equal_jax():
    """QAT with fake quanters on activation and weight: the wrappers
    replace both linears (the original untouched, no parameter twice),
    six Adam steps give the reference's losses (rtol 1e-5), and
    ``QAT.convert`` bakes the reference's weights on the 255-level
    grid (rtol 1e-5)."""
    jm, tm = _nets(0)
    kw = dict(activation=jq.FakeQuanterWithAbsMaxObserver(),
              weight=jq.FakeQuanterWithAbsMaxObserver())
    tkw = dict(activation=q.FakeQuanterWithAbsMaxObserver(),
               weight=q.FakeQuanterWithAbsMaxObserver())
    jqat, tqat = jq.QAT(jq.QuantConfig(**kw)), q.QAT(q.QuantConfig(**tkw))
    jqm, tqm = jqat.quantize(jm), tqat.quantize(tm)
    assert isinstance(tqm.fc1, q.QuantedLinear) and \
        isinstance(tqm.fc2, q.QuantedLinear)
    assert isinstance(tm.fc1, nn.Linear)
    params = list(tqm.parameters())
    assert len(params) == len({id(p) for p in params}) == 4
    jqm.train()
    tqm.train()
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = x @ rng.randn(8, 4).astype(np.float32)
    jopt = pt.optimizer.Adam(learning_rate=0.01,
                             parameters=jqm.parameters())
    topt = Adam(learning_rate=0.01, parameters=tqm.parameters())
    for _ in range(6):
        jl = ((jqm(pt.to_tensor(x)) - pt.to_tensor(y)) ** 2).mean()
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = ((tqm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                                   rtol=1e-5)
    jdep, tdep = jqat.convert(jqm), tqat.convert(tqm)
    assert isinstance(tdep.fc1, nn.Linear)
    for name in ("fc1", "fc2"):
        np.testing.assert_allclose(
            getattr(tdep, name).weight.detach().numpy(),
            np.asarray(getattr(jdep, name).weight.data), rtol=1e-5,
            atol=1e-7, err_msg=name)
    w = tdep.fc1.weight.detach().numpy()
    grid = w / (float(tqm.fc1.weight_quanter.scales()) / 127)
    np.testing.assert_allclose(grid, np.round(grid), atol=1e-3)


def test_config_resolution_by_layer_name_and_type():
    """add_layer_config survives the quantize deepcopy, add_name_config
    matches the full dotted path, add_type_config matches by type, and
    ``@quanter`` makes a factory, as the reference's review cases."""
    _, tm = _nets(5)
    cfg = q.QuantConfig()
    cfg.add_layer_config(tm.fc1, activation=q.FakeQuanterWithAbsMaxObserver(),
                         weight=q.FakeQuanterWithAbsMaxObserver())
    qm = q.QAT(cfg).quantize(tm)
    assert isinstance(qm.fc1, q.QuantedLinear) and \
        isinstance(qm.fc2, nn.Linear)

    class Outer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.block = TNet()

        def forward(self, x):
            return self.block(x)
    cfg = q.QuantConfig()
    cfg.add_name_config("block.fc1",
                        activation=q.FakeQuanterWithAbsMaxObserver(),
                        weight=q.FakeQuanterWithAbsMaxObserver())
    qm = q.QAT(cfg).quantize(Outer())
    assert isinstance(qm.block.fc1, q.QuantedLinear)
    assert isinstance(qm.block.fc2, nn.Linear)
    cfg = q.QuantConfig()
    cfg.add_type_config(nn.Linear,
                        activation=q.FakeQuanterWithAbsMaxObserver(),
                        weight=q.FakeQuanterWithAbsMaxObserver())
    assert isinstance(q.QAT(cfg).quantize(TNet()).fc2, q.QuantedLinear)

    @q.quanter("MyQ")
    class MyQ(q.BaseQuanter):
        def __init__(self, k=1):
            super().__init__()
            self.k = k

        def forward(self, x):
            return x

        def scales(self):
            return None
    f = MyQ(k=3)
    assert isinstance(f, q.QuanterFactory) and f._instance(None).k == 3


def _ptq_pair(seed, weight="fq", jcls=JNet, tcls=TNet, shape=(16, 8),
              n_calib=4, bits=8, edit=None):
    """PTQ-calibrated and converted models of both packages, the same
    weights and calibration batches."""
    jm, tm = _nets(seed, jcls, tcls, edit)
    wf = {"fq": (jq.FakeQuanterWithAbsMaxObserver(bit_length=bits),
                 q.FakeQuanterWithAbsMaxObserver(bit_length=bits)),
          "pc": (jq.PerChannelAbsmaxObserver(),
                 q.PerChannelAbsmaxObserver())}[weight]
    jptq = jq.PTQ(jq.QuantConfig(activation=jq.AbsmaxObserver(),
                                 weight=wf[0]))
    tptq = q.PTQ(q.QuantConfig(activation=q.AbsmaxObserver(),
                               weight=wf[1]))
    jobs, tobs = jptq.quantize(jm), tptq.quantize(tm)
    rng = np.random.RandomState(seed)
    for _ in range(n_calib):
        x = rng.randn(*shape).astype(np.float32)
        jobs(pt.to_tensor(x))
        with torch.no_grad():
            tobs(torch.from_numpy(x))
    return (jm, tm, jptq.convert(jobs), tptq.convert(tobs), rng)


@pytest.mark.parametrize("weight,bits", [("fq", 8), ("pc", 8), ("fq", 4)])
def test_ptq_and_int8_linear_equal_jax(weight, bits):
    """PTQ calibration and convert, then ``convert_to_int8``: the
    activation scale equals the reference's, the int8 weights are equal,
    and the deployed (fake-quant) and int8 outputs equal the reference's
    at its test's tolerance (rtol 1e-5, atol 1e-5); the int8 model
    matches its own simulation as the reference's does."""
    jm, tm, jdep, tdep, rng = _ptq_pair(21 + bits, weight, bits=bits)
    assert isinstance(tdep.fc1, q.QuantedLinear)
    assert float(tdep.fc1.activation_quanter.scales()) == \
        float(jdep.fc1.activation_quanter.scales().numpy())
    assert not tdep.fc1.activation_quanter.training
    x = rng.randn(16, 8).astype(np.float32)
    np.testing.assert_allclose(_out(tdep, x, True), _out(jdep, x, False),
                               rtol=1e-5, atol=1e-5)
    ji8, ti8 = jq.convert_to_int8(jdep), q.convert_to_int8(tdep)
    assert isinstance(ti8.fc1, q.Int8Linear) and ti8.fc1.w_bits == bits
    assert ti8.fc1.w_q.dtype == torch.int8
    np.testing.assert_array_equal(ti8.fc1.w_q.numpy(),
                                  np.asarray(ji8.fc1.w_q.data))
    if weight == "pc":
        assert np.asarray(ti8.fc1.w_scale).shape == (16,)
    got = _out(ti8, x, True)
    np.testing.assert_allclose(got, _out(ji8, x, False), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, _out(tdep, x, True), rtol=1e-5,
                               atol=1e-5)
    ref = _out(tm, x, True)
    assert np.abs(ref - got).mean() < 0.1 * np.abs(ref).mean() + 0.05


class JConv(jnn.Layer):
    def __init__(self, padding=1, data_format="NCHW", out=8):
        super().__init__()
        self.conv = jnn.Conv2D(3, out, 3, padding=padding,
                               data_format=data_format)

    def forward(self, x):
        return self.conv(x)


class TConv(nn.Layer):
    def __init__(self, padding=1, data_format="NCHW", out=8):
        super().__init__()
        self.conv = nn.Conv2D(3, out, 3, padding=padding,
                              data_format=data_format, device="cpu")

    def forward(self, x):
        return self.conv(x)


@pytest.mark.parametrize("padding,fmt,weight", [
    (1, "NCHW", "fq"), ([1, 2], "NCHW", "fq"), (1, "NHWC", "fq"),
    ("SAME", "NCHW", "fq"), (1, "NCHW", "pc")])
def test_int8_conv_equals_jax(padding, fmt, weight):
    """``Int8Conv2D`` (an exact int32 accumulation) on the padding forms,
    NHWC and per-channel scales: the int8 outputs equal the reference's
    and the deployed simulation at its test's tolerance (1e-4)."""
    shape = (2, 3, 8, 8) if fmt == "NCHW" else (2, 8, 8, 3)
    kw = dict(padding=padding, data_format=fmt)
    jm, tm, jdep, tdep, rng = _ptq_pair(
        7, weight, lambda: JConv(**kw), lambda: TConv(**kw), shape, 3)
    x = rng.randn(*shape).astype(np.float32)
    ji8, ti8 = jq.convert_to_int8(jdep), q.convert_to_int8(tdep)
    assert isinstance(ti8.conv, q.Int8Conv2D)
    if weight == "pc":
        assert ti8.conv.w_axis == 0 and \
            np.asarray(ti8.conv.w_scale).shape == (8,)
    got = _out(ti8, x, True)
    np.testing.assert_allclose(got, _out(ji8, x, False), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, _out(tdep, x, True), rtol=1e-4,
                               atol=1e-4)


def test_int8_refusals_pruned_channels_and_state():
    """Uncalibrated quanters and a per-channel activation observer are
    refused; a pruned (all-zero) output channel converts and matches the
    simulation; a per-channel scale survives ``state_dict``."""
    lin = nn.Linear(4, 4, device="cpu")
    quanted = q.QuantedLinear(lin, q.SingleLayerConfig(
        q.FakeQuanterWithAbsMaxObserver(), q.FakeQuanterWithAbsMaxObserver()))
    holder = nn.Sequential(quanted)
    with pytest.raises(ValueError, match="calibrated|scales"):
        q.convert_to_int8(holder)
    _, tm = _nets(27)
    ptq = q.PTQ(q.QuantConfig(activation=q.PerChannelAbsmaxObserver(),
                              weight=q.FakeQuanterWithAbsMaxObserver()))
    obs = ptq.quantize(tm)
    obs(torch.randn(4, 8))
    with pytest.raises(ValueError, match="per-tensor"):
        ptq.convert(obs)

    def prune(state):
        state = dict(state)
        state["fc1.weight"] = state["fc1.weight"].copy()
        state["fc1.weight"][:, 0] = 0.0
        return state
    _, _, jdep, tdep, rng = _ptq_pair(35, "pc", shape=(8, 8), n_calib=3,
                                      edit=prune)
    x = rng.randn(8, 8).astype(np.float32)
    got = _out(q.convert_to_int8(tdep), x, True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _out(tdep, x, True), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, _out(jq.convert_to_int8(jdep), x, False),
                               rtol=1e-4, atol=1e-4)
    qm = q.QAT(q.QuantConfig(weight=q.PerChannelAbsmaxObserver())).quantize(
        TNet())
    qm.train()
    qm(torch.randn(4, 8))
    fresh = q.QAT(q.QuantConfig(
        weight=q.PerChannelAbsmaxObserver())).quantize(TNet())
    fresh.set_state_dict(qm.state_dict())
    assert torch.equal(fresh.fc1.weight_quanter.scales(),
                       qm.fc1.weight_quanter.scales())


@pytest.mark.parametrize("m,k,n", [(4, 8, 16), (33, 24, 40), (17, 7, 9)])
def test_int8_matmul_exact_branch(m, k, n):
    """On the CPU (and for the shapes ``torch._int_mm`` refuses on the
    card) the int8 product is the exact branch: equal to an int64 matmul,
    at the extremes of the grid too."""
    g = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    a[0] = 127
    b[:, 0] = 127
    want = (a.long() @ b.long()).int()
    for fn in (int8_matmul, int8_matmul_exact):
        got = fn(a, b)
        assert got.dtype == torch.int32 and torch.equal(got, want)
