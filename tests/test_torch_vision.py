"""The port's ``vision`` package (``paddle_tpu_torch.vision``) against the
JAX package's, on the CPU: ResNet-18's eval forward on bridged weights
and running statistics, ResNet-50's parameter count, the model zoo's
parameter and buffer names, LeNet training on ``FakeData`` through the
port's ``DataLoader`` and ``AdamW`` (the reference's own
``tests/test_vision.py`` case), the transforms against the reference's
arrays, ``FakeData``'s determinism and MNIST's idx reader.

Weights and buffers cross through numpy; inputs come from a numpy seed;
float32 at the reference's ``tests/test_layers.py`` tolerance (rtol
1e-4, atol 1e-5).
"""
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.vision as jv
from paddle_tpu.vision import transforms as JT
from paddle_tpu.vision.datasets import FakeData as JaxFakeData
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.vision as tv
from paddle_tpu_torch import io
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.bridge import load_numpy_state
from paddle_tpu_torch.vision import transforms as T
from paddle_tpu_torch.vision.datasets import MNIST, FakeData, FashionMNIST

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)


def _names(model):
    return sorted([n for n, _ in model.named_parameters()] +
                  [n for n, _ in model.named_buffers()])


def test_resnet18_eval_forward_matches_jax_with_bridged_buffers():
    """Running statistics drawn away from 0 and 1 go into both models
    through the bridge; the eval forward normalises with them."""
    pt.seed(0)
    jm = jv.resnet18(num_classes=10)
    state = state_dict_from_jax(jm)
    rng = np.random.RandomState(1)
    for n in state:
        if n.endswith("._mean"):
            state[n] = (0.1 * rng.randn(*state[n].shape)).astype(np.float32)
        elif n.endswith("._variance"):
            state[n] = rng.uniform(0.5, 1.5, state[n].shape).astype(
                np.float32)
    jm.set_state_dict({k: pt.to_tensor(v) for k, v in state.items()})
    tm = tv.resnet18(num_classes=10, device="cpu")
    load_numpy_state(tm, state)
    jm.eval()
    tm.eval()
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out, np.asarray(jm(pt.to_tensor(x)).data),
                               **TOL)


def test_resnet50_structure():
    """Bottleneck expansion: the head takes 2048 features; ~25.6 M
    parameters, the reference's count exactly."""
    tm = tv.resnet50(num_classes=7, device="cpu")
    assert tuple(tm.fc.weight.shape) == (2048, 7)
    n = sum(p.numel() for p in tm.parameters())
    assert 23_000_000 < n < 27_000_000
    jm = jv.resnet50(num_classes=7)
    assert n == sum(int(np.prod(p.shape)) for p in jm.parameters())
    assert _names(tm) == sorted(
        [k for k, _ in jm.named_parameters()] +
        [k for k, _ in jm.named_buffers()])


@pytest.mark.parametrize("name,kw", [
    ("LeNet", {"num_classes": 4}),
    ("mobilenet_v1", {"scale": 0.25, "num_classes": 5}),
    ("mobilenet_v2", {"scale": 0.25, "num_classes": 5}),
])
def test_model_zoo_names_and_shapes(name, kw):
    """Each model's parameters and buffers carry the reference's names and
    shapes, so its state crosses the bridge unchanged."""
    pt.seed(2)
    jm = getattr(jv.models, name)(**kw)
    tm = getattr(tv.models, name)(**kw, device="cpu")
    load_numpy_state(tm, state_dict_from_jax(jm))
    side = 28 if name == "LeNet" else 32
    cin = 1 if name == "LeNet" else 3
    tm.eval()
    with torch.no_grad():
        out = tm(torch.zeros(1, cin, side, side))
    assert tuple(out.shape) == (1, kw["num_classes"])


def test_vgg_features_names():
    from paddle_tpu.vision.models.vgg import _make_features as jax_features
    from paddle_tpu_torch.vision.models.vgg import _CFGS, _make_features
    jf = jax_features(_CFGS["A"], batch_norm=True)
    tf = _make_features(_CFGS["A"], batch_norm=True, device="cpu")
    assert _names(tf) == sorted([k for k, _ in jf.named_parameters()] +
                                [k for k, _ in jf.named_buffers()])


def test_pretrained_raises():
    for make in (tv.resnet18, tv.models.vgg11, tv.models.mobilenet_v2):
        with pytest.raises(NotImplementedError, match="load_numpy_state"):
            make(pretrained=True, device="cpu")


def test_lenet_trains_on_fakedata():
    """The reference's case: class = argmax of 4 fixed projections of a
    FakeData image; 15 epochs of AdamW through the port's DataLoader."""
    ptt.seed(1)
    ds = FakeData(num_samples=64, image_shape=(1, 28, 28), num_classes=4)
    W = np.random.RandomState(0).randn(784, 4).astype(np.float32)
    items = [(x, np.int64((x.reshape(-1) @ W).argmax()))
             for x, _ in [ds[i] for i in range(64)]]
    X = np.stack([x for x, _ in items])
    Y = np.stack([y for _, y in items])
    dl = io.DataLoader(io.TensorDataset([X, Y]), batch_size=16,
                       shuffle=True)
    m = tv.LeNet(num_classes=4, device="cpu")
    opt = AdamW(learning_rate=2e-3, parameters=m.parameters())
    ce = tnn.CrossEntropyLoss()
    losses = []
    for _ in range(15):
        for xb, yb in dl:
            loss = ce(m(torch.as_tensor(xb)), torch.as_tensor(yb))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) * 0.7


def test_fakedata_is_deterministic_and_equals_the_reference():
    ds = FakeData(num_samples=10, image_shape=(3, 8, 8), seed=3)
    x1, y1 = ds[5]
    x2, y2 = ds[5]
    np.testing.assert_array_equal(x1, x2)
    assert y1 == y2 == 5
    jx, jy = JaxFakeData(num_samples=10, image_shape=(3, 8, 8), seed=3)[5]
    np.testing.assert_array_equal(x1, jx)
    assert len(ds) == 10 and isinstance(ds, io.Dataset)
    tds = FakeData(num_samples=4, image_shape=(8, 8, 3),
                   transform=T.Compose([T.Transpose()]))
    assert tds[0][0].shape == (3, 8, 8)


def test_transforms_equal_the_reference_arrays():
    rng = np.random.RandomState(0)
    img8 = (rng.rand(10, 8, 3) * 255).astype(np.uint8)
    imgf = rng.rand(10, 8, 3).astype(np.float32)
    chw = rng.rand(3, 6, 5).astype(np.float32)
    cases = [
        ("ToTensor", (), img8), ("ToTensor", ("HWC",), img8),
        ("Normalize", ([0.5, 0.4, 0.3], [0.2, 0.3, 0.4]), chw),
        ("Resize", ((5, 4),), imgf), ("Resize", (6,), img8),
        ("CenterCrop", (4,), imgf), ("Transpose", (), imgf),
        ("RandomHorizontalFlip", (1.0,), imgf),
        ("RandomVerticalFlip", (1.0,), imgf),
    ]
    for name, args, img in cases:
        ours = getattr(T, name)(*args)(img)
        ref = getattr(JT, name)(*args)(img)
        assert ours.dtype == ref.dtype, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    for name, args in (("RandomCrop", (6, 1)), ("BrightnessTransform", (0.3,))):
        np.random.seed(5)
        ours = getattr(T, name)(*args)(img8)
        np.random.seed(5)
        ref = getattr(JT, name)(*args)(img8)
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def _write_idx(root, prefix, n):
    data = np.random.RandomState(0).randint(0, 255, (n, 28, 28),
                                            dtype=np.uint8)
    labels = np.arange(n, dtype=np.uint8)
    (root / f"{prefix}-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 2051, n, 28, 28) + data.tobytes())
    (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, n) + labels.tobytes())
    return data


def test_mnist_reads_idx_files(tmp_path):
    data = _write_idx(tmp_path, "t10k", 5)
    ds = MNIST(root=str(tmp_path), mode="test",
               transform=T.Compose([T.ToTensor()]))
    assert len(ds) == 5
    img, y = ds[3]
    np.testing.assert_array_equal(img, data[3][None] / np.float32(255.0))
    assert y == 3


def test_missing_datasets_raise_and_download_nothing(tmp_path):
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        MNIST(root=str(tmp_path))
    assert MNIST._cache_name != FashionMNIST._cache_name
    with pytest.raises(FileNotFoundError, match="fashion-mnist"):
        FashionMNIST(root=str(tmp_path / "fashion-mnist"), mode="test")
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        tv.datasets.Cifar10(data_file=str(tmp_path / "none.tar.gz"))
