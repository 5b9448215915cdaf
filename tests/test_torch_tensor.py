"""The port's Paddle ``Tensor`` (``paddle_tpu_torch.core.tensor``) held
against the JAX package's, case for case with ``tests/test_tensor.py``,
on the same numpy inputs; plus the facade's own contract: it is a
``torch.Tensor`` subclass that leaves ``torch.Tensor`` untouched."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import both, on_cpu  # noqa: F401


def test_to_tensor_defaults():
    j, t = both([1.0, 2.0, 3.0])
    assert t.shape == j.shape == [3]
    assert t.dtype == ptt.float32 and j.dtype == pt.float32
    assert t.stop_gradient is True
    np.testing.assert_allclose(t.numpy(), j.numpy())
    assert t.place == "cpu"


def test_to_tensor_int_dtype():
    t = ptt.to_tensor([1, 2, 3])
    assert t.dtype == ptt.int64  # the reference stores int32 (x64 off)
    t2 = ptt.to_tensor(np.arange(4, dtype=np.int32))
    assert t2.dtype == ptt.int32 == pt.to_tensor(
        np.arange(4, dtype=np.int32)).dtype.name


def test_dtype_cast():
    j, t = both([1.5, 2.5])
    assert t.astype("int32").dtype == ptt.int32
    np.testing.assert_array_equal(t.astype("int32").numpy(),
                                  j.astype("int32").numpy())
    b = t.astype(ptt.bfloat16)
    assert b.dtype == ptt.bfloat16 and b.dtype.name == "bfloat16"
    np.testing.assert_array_equal(b.numpy(),
                                  np.asarray(j.astype(pt.bfloat16).numpy(),
                                             np.float32))


def test_creation_ops():
    assert ptt.zeros([2, 3]).shape == [2, 3]
    assert ptt.ones([4]).numpy().sum() == 4
    for name, args in (("full", ([2, 2], 7.0)), ("arange", (10,)),
                       ("eye", (3,)), ("linspace", (0, 1, 5))):
        np.testing.assert_allclose(getattr(ptt, name)(*args).numpy(),
                                   getattr(pt, name)(*args).numpy(),
                                   rtol=1e-6)
    assert ptt.arange(10).dtype == ptt.int64
    assert ptt.zeros([2]).place == "cpu"


def test_random_reproducible():
    ptt.seed(7)
    a = ptt.randn([4, 4]).numpy()
    ptt.seed(7)
    b = ptt.randn([4, 4]).numpy()
    np.testing.assert_array_equal(a, b)
    c = ptt.randn([4, 4]).numpy()
    assert not np.array_equal(b, c)


def test_arithmetic_dunders():
    (jx, tx), (jy, ty) = both([1.0, 2.0]), both([3.0, 4.0])
    for f in (lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
              lambda x, y: y / x, lambda x, y: x ** 2, lambda x, y: 2.0 + x,
              lambda x, y: -x, lambda x, y: 2.0 - x, lambda x, y: x @ y,
              lambda x, y: 3.0 / x, lambda x, y: y % 3.0):
        out = f(tx, ty)
        assert isinstance(out, ptt.Tensor) and type(out) is ptt.Tensor
        np.testing.assert_allclose(out.numpy(), f(jx, jy).numpy(),
                                   rtol=1e-6)
    np.testing.assert_allclose(abs(ptt.to_tensor([-1.0, 2.0])).numpy(),
                               [1, 2])


def test_comparisons():
    (jx, tx), (jy, ty) = both([1.0, 2.0, 3.0]), both([2.0, 2.0, 2.0])
    for f in (lambda x, y: x < y, lambda x, y: x == y, lambda x, y: x >= y,
              lambda x, y: x != y, lambda x, y: x > y, lambda x, y: x <= y):
        np.testing.assert_array_equal(f(tx, ty).numpy(), f(jx, jy).numpy())


def test_indexing():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    j, t = both(x)
    for idx in (0, (slice(None), 1), (slice(1, None), slice(2, None))):
        np.testing.assert_allclose(t[idx].numpy(), j[idx].numpy())
    ji, ti = both([0, 2])
    np.testing.assert_allclose(t[ti].numpy(), j[ji].numpy())


def test_setitem():
    x = ptt.zeros([3, 3])
    x[1, 1] = 5.0
    assert x.numpy()[1, 1] == 5.0
    x[0] = ptt.ones([3])
    np.testing.assert_allclose(x.numpy()[0], [1, 1, 1])


def test_inplace_mutation():
    x = ptt.ones([2, 2])
    v0 = x.inplace_version
    x.zero_()
    assert x.numpy().sum() == 0
    assert x.inplace_version == v0 + 1
    x.fill_(3.0)
    np.testing.assert_allclose(x.numpy(), np.full((2, 2), 3.0))
    x.set_value(np.eye(2))
    np.testing.assert_allclose(x.numpy(), np.eye(2))


def test_item_and_scalars():
    s = ptt.to_tensor(3.5)
    assert s.item() == 3.5
    assert float(s) == 3.5
    assert int(ptt.to_tensor(7)) == 7
    assert s.size == 1
    assert s.ndim == 0
    assert int(ptt.to_tensor(np.zeros((2, 3))).numel()) == 6


def test_detach_clone():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    y = (x * 2).detach()
    assert y.stop_gradient and type(y) is ptt.Tensor
    c = x.clone()
    assert not np.shares_memory(c.numpy(), x.numpy())


def test_repr_smoke():
    r = repr(ptt.to_tensor([1.0, 2.0], stop_gradient=False))
    assert "Tensor" in r and "stop_gradient=False" in r


def test_numpy_interop():
    x = ptt.to_tensor([[1.0, 2.0]])
    assert np.asarray(x).shape == (1, 2)
    assert len(x) == 1
    assert np.asarray(x.data).shape == (1, 2)
    # numpy() works on a tensor that needs a gradient
    w = ptt.to_tensor([1.0], stop_gradient=False)
    assert w.numpy().tolist() == [1.0]


def test_parameter():
    p = ptt.Parameter(np.zeros((2, 2), np.float32))
    assert not p.stop_gradient
    assert p.persistable
    assert p.trainable
    assert isinstance(p, torch.nn.Parameter) and isinstance(p, ptt.Tensor)
    # a parameter keeps torch's methods, so its shape is a torch.Size
    # (the reference's is a list; ROADMAP §3)
    assert isinstance(p.shape, torch.Size) and p.shape == (2, 2)
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable


def test_tensor_inplace_and_convenience_methods():
    x = ptt.to_tensor(np.ones((2, 3), np.float32))
    x.add_(1.0).multiply_(2.0).subtract_(1.0)
    np.testing.assert_allclose(np.asarray(x.data), 3 * np.ones((2, 3)))
    x.clip_(max=2.5)
    assert float(np.asarray(x.data).max()) == 2.5
    assert x.element_size() == 4 and x.nelement() == 6
    assert x.is_contiguous() and x.contiguous() is x
    # the reference's x.cuda() is a no-op (it has no CUDA); the port's
    # moves the tensor to the card, and raises where there is none
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            x.cuda()
    assert x.bfloat16().dtype.name == "bfloat16"
    assert x.half().dtype.name == "float16"
    assert x.float().dtype.name == "float32"
    y = x.sub(ptt.to_tensor(np.ones((2, 3), np.float32)))
    np.testing.assert_allclose(np.asarray(y.data), np.asarray(x.data) - 1)

    ptt.seed(0)
    u = ptt.to_tensor(np.zeros((100,), np.float32))
    u.uniform_(0.0, 1.0)
    arr = np.asarray(u.data)
    assert 0 <= arr.min() and arr.max() <= 1 and arr.std() > 0.1
    n = ptt.to_tensor(np.zeros((500,), np.float32))
    n.normal_(mean=2.0, std=0.1)
    assert abs(float(np.asarray(n.data).mean()) - 2.0) < 0.05
    e = ptt.to_tensor(np.zeros((500,), np.float32))
    e.exponential_(lam=2.0)
    assert abs(float(np.asarray(e.data).mean()) - 0.5) < 0.1


def test_inplace_preserves_dtype_and_seeded_uniform():
    j, t = both(np.array([1, 2], np.int32))
    t.add_(0.9)  # must not promote to float
    j.add_(0.9)
    assert t.dtype.name == "int32"
    np.testing.assert_array_equal(t.numpy(), j.numpy())

    a = ptt.to_tensor(np.zeros(16, np.float32)).uniform_(0, 1, seed=42)
    b = ptt.to_tensor(np.zeros(16, np.float32)).uniform_(0, 1, seed=42)
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))


def test_inplace_shape_guard_and_clip_dtype():
    t = ptt.to_tensor(np.array([1.0], np.float32))
    with pytest.raises(ValueError, match="shape"):
        t.add_(ptt.to_tensor(np.ones((2, 3), np.float32)))
    j, ti = both(np.array([1, 2, 3], np.int32))
    ti.clip_(min=0.5, max=2.5)
    j.clip_(min=0.5, max=2.5)
    assert ti.dtype.name == "int32"
    np.testing.assert_array_equal(ti.numpy(), j.numpy())
    # seed parity with ops.uniform
    a = ptt.to_tensor(np.zeros(4, np.float32)).uniform_(0, 1, seed=7)
    b = ptt.uniform([4], min=0.0, max=1.0, seed=7)
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))


def test_save_and_load_a_tensor(tmp_path):
    """``paddle.save`` takes ``Tensor``s; ``paddle.load`` gives plain
    torch tensors back (the reference gives ``Tensor``s; ROADMAP §3),
    which ``set_state_dict`` and every op take."""
    path = str(tmp_path / "t.pdparams")
    ptt.save({"t": ptt.to_tensor([1.0, 2.0])}, path)
    back = ptt.load(path, device="cpu")["t"]
    assert type(back) is torch.Tensor
    np.testing.assert_array_equal(ptt.ops.multiply(back, 2).numpy(),
                                  [2.0, 4.0])


# -- the facade's own contract ------------------------------------------------
def test_torch_tensor_keeps_its_signatures():
    """``import paddle_tpu_torch`` patches nothing of ``torch.Tensor``:
    its ``transpose``, ``sum``, ``reshape`` and ``shape`` keep torch's
    meaning, and the Paddle methods live on the port's subclass only."""
    z = torch.arange(6.0).reshape(2, 3)
    assert z.transpose(0, 1).shape == torch.Size([3, 2])
    assert z.sum(0).tolist() == [3.0, 5.0, 7.0]
    assert z.sum(dim=1, keepdim=True).shape == (2, 1)
    assert isinstance(z.shape, torch.Size)
    assert not hasattr(torch.Tensor, "stop_gradient")
    assert torch.Tensor.transpose is torch._C.TensorBase.transpose
    t = ptt.to_tensor(z.numpy())
    assert t.transpose([1, 0]).shape == [3, 2]
    assert t.sum(axis=1, keepdim=True).shape == [2, 1]
    # a torch op on a Tensor returns a plain tensor, at no extra cost
    assert type(torch.add(t, 1)) is torch.Tensor


def test_facade_unwraps_on_the_autograd_graph():
    """The plain alias the op library computes on stays on the graph: a
    backward through it fills the leaf ``Tensor``'s ``.grad``."""
    x = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    plain = x.as_subclass(torch.Tensor)
    (plain * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
    assert type(x.grad) is ptt.Tensor
