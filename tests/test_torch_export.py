"""Export and deployment on the port, against the JAX package, on the CPU
in float32: ``jit.save``/``jit.load`` over ``torch.export``,
``static.InputSpec``, ``inference.Config``/``Predictor`` and its handle
API, K1 as the registered op ``paddle_tpu::flash_fwd`` inside the
exported graph, and ``device.cuda``'s refusal without a card.

Weights cross through ``state_dict_from_jax``/``load_numpy_state``. The
tiny Llama's round trip is held against the reference's own ``jit.save``
→ ``jit.load`` at the reference test's tolerance (rtol 2e-4, atol 2e-5;
``tests/test_jit_save_load.py:124-125``), at the example's batch and at
others; the predictor against the port's eager forward at rtol 1e-5,
atol 1e-6 (``tests/test_inference.py:37``)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu.models import llama as jl
from paddle_tpu.static import InputSpec as JInputSpec
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.jit.serialization import load_program
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops.pallas import flash_attention as tfa
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax
from torch_api_common import on_cpu  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ROUND_TRIP = dict(rtol=2e-4, atol=2e-5)
PREDICTOR = dict(rtol=1e-5, atol=1e-6)
# the reference's dynamic-batch test model (test_jit_save_load.py:102)
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=2,
           num_key_value_heads=1, max_position_embeddings=64,
           tie_word_embeddings=True)


def _ids(b, s=16, seed=0):
    return np.random.RandomState(seed + b).randint(0, 64, (b, s)) \
        .astype(np.int64)


@pytest.fixture(scope="module")
def llama_pair(tmp_path_factory):
    """The reference's tiny Llama and its port twin, each exported with
    ``InputSpec([None, 16], "int64")`` by its own ``jit.save``."""
    pt.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**CFG))
    jm.eval()
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**CFG), device="cpu").eval()
    load_numpy_state(tm, state_dict_from_jax(jm))
    d = tmp_path_factory.mktemp("export")
    pt.jit.save(jm, str(d / "jax"),
                input_spec=[JInputSpec([None, 16], "int64", "ids")])
    ptt.jit.save(tm, str(d / "port"),
                 input_spec=[InputSpec([None, 16], "int64", "ids")])
    return jm, tm, d


def test_input_spec():
    spec = InputSpec([None, 8], "float32", name="x")
    assert spec.shape == (-1, 8) and spec.name == "x"
    assert spec.dtype == ptt.float32 and spec.dtype.name == "float32"
    assert repr(spec) == "InputSpec(shape=(-1, 8), dtype=float32, name=x)"
    t = ptt.to_tensor(np.zeros((2, 3), np.int32), place="cpu")
    s = InputSpec.from_tensor(t, name="t")
    assert s.shape == (2, 3) and s.dtype.name == "int32" and s.name == "t"
    assert InputSpec.from_tensor(torch.zeros(4, 1)).shape == (4, 1)
    with pytest.raises(NotImplementedError, match="jit.save"):
        ptt.static.save_inference_model("p", [], [])
    with pytest.raises(NotImplementedError, match="jit.load"):
        ptt.static.load_inference_model("p")


@pytest.mark.parametrize("batch", [2, 1, 3])
def test_llama_round_trip_equals_the_references(llama_pair, batch):
    """The port's ``jit.save`` → ``jit.load`` against the reference's, at
    the example's batch (2) and at two others through the shared dynamic
    batch dim; both equal their eager forwards."""
    jm, tm, d = llama_pair
    ids = _ids(batch)
    ref = np.asarray(pt.jit.load(str(d / "jax"))(pt.to_tensor(ids)).numpy())
    loaded = ptt.jit.load(str(d / "port"), device="cpu")
    out = loaded(torch.from_numpy(ids))
    assert isinstance(loaded, ptt.jit.TranslatedLayer)
    assert out.shape == (batch, 16, 64) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, **ROUND_TRIP)
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out.numpy(), eager, **PREDICTOR)


def test_the_exported_graph_holds_the_flash_op(llama_pair):
    """K1 is one ``paddle_tpu::flash_fwd`` node a layer in the saved
    program; running it on the CPU computes the plain version and counts
    no launch."""
    _, _, d = llama_pair
    program, device = load_program(str(d / "port"), "cpu")
    assert device == torch.device("cpu")
    nodes = [n for n in program.graph.nodes
             if n.target is torch.ops.paddle_tpu.flash_fwd.default]
    assert len(nodes) == CFG["num_hidden_layers"]
    before = tfa.launches_fwd
    program.module()(torch.from_numpy(_ids(2)))
    assert tfa.launches_fwd == before


def test_predictor_equals_the_eager_forward(llama_pair):
    """``Predictor(Config(path))`` with ``disable_gpu()``: ``run([ids])``
    and the handle API give the port's eager logits, at two batch
    sizes."""
    _, tm, d = llama_pair
    cfg = Config(str(d / "port") + ".pdmodel")
    cfg.disable_gpu()
    pred = create_predictor(cfg)
    assert pred.get_input_names() == ["x0"]
    for batch in (2, 4):
        ids = _ids(batch, seed=7)
        with torch.no_grad():
            eager = tm(torch.from_numpy(ids)).numpy()
        (out,) = pred.run([ids])
        np.testing.assert_allclose(out, eager, **PREDICTOR)
    pred.get_input_handle("x0").copy_from_cpu(_ids(3))
    pred.run()
    (name,) = pred.get_output_names()
    handle = pred.get_output_handle(name)
    assert handle.shape() == [3, 16, 64]
    with torch.no_grad():
        eager = tm(torch.from_numpy(_ids(3))).numpy()
    np.testing.assert_allclose(handle.copy_to_cpu(), eager, **PREDICTOR)
    with pytest.raises(ValueError, match="output handle"):
        handle.copy_from_cpu(_ids(3))
    with pytest.raises(ValueError, match="expects 1 inputs"):
        pred.run([_ids(2), _ids(2)])
    with pytest.raises(FileNotFoundError, match="jit.save"):
        create_predictor(Config(str(d / "nope")))


def test_predictor_runs_on_the_card_unless_asked(llama_pair, monkeypatch):
    """Without ``disable_gpu()`` (and with no ``set_device``), a predictor
    asks for the card, and raises where there is none."""
    from paddle_tpu_torch import device
    _, _, d = llama_pair
    monkeypatch.setattr(device, "_chosen", [None])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        create_predictor(Config(str(d / "port")))


def test_a_fresh_process_loads_the_program(llama_pair):
    """The op is registered where the flash-attention module is imported,
    so a fresh process needs nothing else to load and run the program."""
    _, tm, d = llama_pair
    code = (
        "import numpy as np, torch\n"
        "import paddle_tpu_torch.ops.pallas.flash_attention\n"
        f"with open({str(d / 'port.pdmodel')!r}, 'rb') as f:\n"
        "    p = torch.export.load(f)\n"
        "ids = torch.from_numpy(np.load(__import__('sys').argv[1]))\n"
        "np.save(__import__('sys').argv[2], p.module()(ids).detach().numpy())\n")
    np.save(d / "ids.npy", _ids(5))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code, str(d / "ids.npy"),
                        str(d / "out.npy")], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "jax" not in r.stderr.lower()
    with torch.no_grad():
        eager = tm(torch.from_numpy(_ids(5))).numpy()
    np.testing.assert_allclose(np.load(d / "out.npy"), eager, **PREDICTOR)


class _Net(tnn.Layer):
    """A user's layer (its forward sees Paddle ``Tensor``s)."""

    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16)
        self.fc2 = tnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(ptt.nn.functional.relu(self.fc1(x)))


class _Expand(tnn.Layer):
    """Batch-derived dims through ``expand``/``broadcast_to``/``zeros``
    (``tests/test_jit_save_load.py:140``)."""

    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(8, 8)

    def forward(self, x):
        b = x.shape[0]
        bias = tops.expand(tops.zeros([1, 8]), [b, 8])
        mask = tops.broadcast_to(tops.ones([1, 8]), [b, 8])
        return self.fc(x) + bias + mask


def test_user_layers_round_trip(tmp_path, on_cpu):
    """A user's ``Layer`` through the predictor's handle API, and the
    reference's dynamic-batch cases (batch-derived shapes, a transformer
    encoder layer) against the port's eager forward."""
    ptt.seed(0)
    net = _Net().eval()
    ptt.jit.save(net, str(tmp_path / "net"),
                 input_spec=[InputSpec([2, 8], "float32", "x")])
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    pred = create_predictor(Config(str(tmp_path / "net")))
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(x)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(out, net(ptt.to_tensor(x)).numpy(),
                               **PREDICTOR)
    enc = tnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0).eval()
    for name, layer, shape, batches in (
            ("expand", _Expand().eval(), [None, 8], (1, 4)),
            ("enc", enc, [None, 12, 32], (2, 7))):
        ptt.jit.save(layer, str(tmp_path / name),
                     input_spec=[InputSpec(shape, "float32", "x")])
        back = ptt.jit.load(str(tmp_path / name))
        for b in batches:
            x = ptt.to_tensor(np.random.RandomState(b).randn(
                b, *shape[1:]).astype(np.float32))
            got = back(x)
            assert type(got) is ptt.Tensor
            np.testing.assert_allclose(got.numpy(), layer(x).numpy(),
                                       **ROUND_TRIP)


def test_save_keeps_the_state_and_the_modes(tmp_path, on_cpu):
    """``.pdiparams`` holds the state dict; the program bakes the weights
    (a later change to the live layer does not reach it); every
    sublayer's train mode is restored; no ``input_spec`` raises; a
    bfloat16 layer raises, naming the route for its state."""
    ptt.seed(1)
    m = tnn.Sequential(tnn.Linear(4, 8), tnn.Dropout(0.5),
                       tnn.Linear(8, 2))
    m.train()
    m[1].eval()
    path = str(tmp_path / "m")
    ptt.jit.save(m, path, input_spec=[InputSpec([3, 4], "float32")])
    assert m.training and m[0].training and not m[1].training
    sd = ptt.load(path + ".pdiparams", device="cpu")
    np.testing.assert_array_equal(sd["0.weight"].numpy(),
                                  m[0].weight.detach().numpy())
    loaded = ptt.jit.load(path)
    x = ptt.to_tensor(np.ones((3, 4), np.float32))
    before = loaded(x).numpy()
    m.eval()
    np.testing.assert_allclose(before, m(x).numpy(), **PREDICTOR)
    with torch.no_grad():
        m[0].weight.zero_()
    np.testing.assert_array_equal(loaded(x).numpy(), before)
    with pytest.raises(ValueError, match="input_spec"):
        ptt.jit.save(m, str(tmp_path / "x"))
    bf16 = tnn.Linear(4, 2, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="CheckpointManager"):
        ptt.jit.save(bf16, str(tmp_path / "bf16"),
                     input_spec=[InputSpec([2, 4], "bfloat16")])


def test_to_static_wrapped_layers_and_functions_export(tmp_path, on_cpu):
    """``jit.save`` of what ``to_static`` returns exports the layer (or
    the function) it wraps."""
    ptt.seed(2)
    net = _Net().eval()
    x = ptt.to_tensor(np.random.RandomState(1).randn(2, 8)
                      .astype(np.float32))
    ptt.jit.save(ptt.jit.to_static(net), str(tmp_path / "layer"),
                 input_spec=[InputSpec([None, 8], "float32")])
    np.testing.assert_allclose(ptt.jit.load(str(tmp_path / "layer"))(
        x).numpy(), net(x).numpy(), **PREDICTOR)
    fn = ptt.jit.to_static(lambda a: ptt.tanh(a) * 2.0)
    ptt.jit.save(fn, str(tmp_path / "fn"),
                 input_spec=[InputSpec([None, 8], "float32")])
    assert not os.path.exists(str(tmp_path / "fn.pdiparams"))
    np.testing.assert_allclose(ptt.jit.load(str(tmp_path / "fn"))(
        x).numpy(), np.tanh(x.numpy()) * 2.0, **PREDICTOR)


def test_int8_layers_export_like_the_references(tmp_path, on_cpu):
    """``quantization.convert_to_int8``'s layer (int8 weights) exported
    by both packages on the same weights: the loaded programs agree."""
    from paddle_tpu import quantization as jq
    from paddle_tpu_torch import quantization as tq
    pt.seed(0)
    jlin = jnn.Linear(16, 4)
    tlin = tnn.Linear(16, 4)
    load_numpy_state(tlin, state_dict_from_jax(jlin))
    jint8 = jq.convert_to_int8(jnn.Sequential(jlin))
    tint8 = tq.convert_to_int8(tnn.Sequential(tlin))
    x = np.random.RandomState(3).randn(8, 16).astype(np.float32)
    pt.jit.save(jint8, str(tmp_path / "j"),
                input_spec=[JInputSpec([8, 16], "float32")])
    ptt.jit.save(tint8, str(tmp_path / "t"),
                 input_spec=[InputSpec([8, 16], "float32")])
    ref = np.asarray(pt.jit.load(str(tmp_path / "j"))(
        pt.to_tensor(x)).numpy())
    got = ptt.jit.load(str(tmp_path / "t"))(ptt.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, **ROUND_TRIP)


def test_streams_and_events_need_a_card():
    """``device.cuda``'s ``Stream``/``Event`` are PyTorch's on the card;
    without one, asking for them raises."""
    from paddle_tpu_torch.device import cuda
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_kernels.py "
                    "holds the stream and event on it")
    for make in (cuda.Stream, cuda.Event, cuda.current_stream,
                 lambda: cuda.Stream(priority=1)):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            make()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        with cuda.stream_guard(None):
            pass
