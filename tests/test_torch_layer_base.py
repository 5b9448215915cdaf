"""``nn.Layer`` of the port (``paddle_tpu_torch/nn/layer_base.py``) held
against the JAX package's ``Layer``: its methods on the same layer
trees, state dicts that cross the numpy bridge with their keys
unchanged, the facade boundary (a port ``forward`` sees plain
``torch.Tensor``s, a user's ``forward`` sees Paddle ``Tensor``s), and
``set_device``."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax
from torch_api_common import on_cpu  # noqa: F401


def _user_net(pkg):
    nn = pkg.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8)
            self.fc2 = nn.Linear(8, 3)
            self.scale = self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(2.0))
            self.register_buffer("count", pkg.zeros([1]), persistable=False)
            self.register_buffer("stat", pkg.ones([3]))

        def forward(self, x):
            h = self.fc1(x)
            # Paddle methods on what a sublayer returns
            h = h.transpose([1, 0]).transpose([1, 0])
            return self.fc2(pkg.tanh(h)) * self.scale + self.stat

    return Net()


def _twins():
    j = _user_net(pt)
    t = _user_net(ptt)
    t.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                      j.state_dict().items()})
    return j, t


def test_user_layer_matches_the_reference():
    j, t = _twins()
    # the same keys; PyTorch orders each layer's buffers after its own
    # parameters, the reference after every parameter (ROADMAP §3)
    assert sorted(t.state_dict()) == sorted(j.state_dict())
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    x = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    jx, tx = pt.to_tensor(x), ptt.to_tensor(x)
    jy, ty = j(jx), t(tx)
    assert type(ty) is ptt.Tensor
    np.testing.assert_allclose(ty.numpy(), jy.numpy(), rtol=1e-5, atol=1e-6)
    jy.sum().backward()
    ty.sum().backward()
    for (n, jp), (_, tp) in zip(j.named_parameters(), t.named_parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_layer_methods():
    j, t = _twins()
    assert isinstance(t, ptt.nn.Layer) and isinstance(t, torch.nn.Module)
    assert len(t.parameters()) == len(j.parameters()) == 5
    assert isinstance(t.parameters(), list)
    assert len(t.parameters(include_sublayers=False)) == 1
    assert [type(s).__name__ for s in t.sublayers()] == \
        [type(s).__name__ for s in j.sublayers()]
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    assert [n for n, _ in t.named_sublayers(include_self=True)][0] == ""
    assert len(list(t.children())) == 2
    assert "count" not in t.state_dict() and "stat" in t.state_dict()
    assert t.full_name() == j.full_name() == "net"
    seen = []
    t.apply(lambda m: seen.append(type(m).__name__))
    assert seen[-1] == "Net"
    t.eval()
    assert not t.training and not t.fc1.training
    t.train()
    assert t.fc2.training
    p = t.fc1.weight
    assert isinstance(p, ptt.Parameter) and p.trainable
    t(ptt.ones([2, 4])).sum().backward()
    assert p.grad is not None
    t.clear_gradients()
    assert float(p.grad.abs().sum()) == 0.0
    t.clear_gradients(set_to_zero=False)
    assert p.grad is None
    extra = ptt.Parameter(np.ones(2, np.float32))
    t.add_parameter("extra", extra)
    assert t.extra is extra
    t.add_sublayer("head", ptt.nn.Linear(3, 2))
    assert "head.weight" in t.state_dict()


def test_set_state_dict_reports_and_checks_shapes():
    _, t = _twins()
    sd = {k: v.numpy() for k, v in t.state_dict().items()}
    missing, unexpected = t.set_state_dict({**sd, "nope": np.zeros(1)})
    assert missing == [] and unexpected == ["nope"]
    sd.pop("stat")
    missing, _ = t.set_state_dict(sd)
    assert missing == ["stat"]
    with pytest.raises(ValueError, match="shape mismatch"):
        t.set_state_dict({"fc1.weight": np.zeros((2, 2), np.float32)})


def test_to_astype_and_bfloat16():
    _, t = _twins()
    t.to(dtype="bfloat16")
    assert t.fc1.weight.dtype == torch.bfloat16
    t.astype("float32")
    assert t.fc1.weight.dtype == torch.float32
    t.bfloat16().float()
    assert t.to(device="cpu") is t and t.fc1.weight.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t.to(device="gpu")


def test_hooks_pre_and_post():
    _, t = _twins()
    calls = []
    h1 = t.register_forward_pre_hook(
        lambda layer, inputs: calls.append(("pre", type(inputs[0]))))
    h2 = t.register_forward_post_hook(
        lambda layer, inputs, out: out * 0)
    out = t(ptt.ones([2, 4]))
    assert calls == [("pre", ptt.Tensor)] and float(out.abs().sum()) == 0
    h1.remove()
    h2.remove()
    assert float(t(ptt.ones([2, 4])).abs().sum()) > 0


def test_llama_state_dict_crosses_the_bridge_with_keys_unchanged():
    """The rebased Llama keeps its keys, parameter order and bridge: a
    state dict read from the JAX model loads through ``set_state_dict``
    and gives the reference's logits."""
    jm = jax_tiny()
    tm = bridged(jm)
    sd = state_dict_from_jax(jm)
    assert list(tm.state_dict()) == list(sd)
    assert [n for n, _ in tm.named_parameters()] == list(sd)
    other = ptt.models.LlamaForCausalLM(ptt.models.LlamaConfig.tiny(),
                                        seed=5)
    missing, unexpected = other.set_state_dict(sd)
    assert missing == [] and unexpected == []
    ids = np.random.RandomState(0).randint(0, 256, (2, 8))
    ref = jm(pt.to_tensor(ids)).numpy()
    np.testing.assert_allclose(other(ptt.to_tensor(ids)).numpy(), ref,
                               rtol=1e-4, atol=1e-5)
    assert isinstance(other, ptt.nn.Layer)
    assert all(isinstance(m, ptt.nn.Layer) for m in other.sublayers())


def test_port_forward_sees_only_plain_tensors():
    """A forward pre-hook inside ``LlamaForCausalLM`` (and on it) sees
    plain ``torch.Tensor``s when the model is called with Paddle
    ``Tensor``s; the outputs come back as ``Tensor``s, and a call with
    plain tensors stays plain."""
    m = ptt.models.LlamaForCausalLM(ptt.models.LlamaConfig.tiny())
    seen = []

    def hook(layer, inputs):
        seen.extend(type(a) for a in inputs if isinstance(a, torch.Tensor))
    for layer in [m, m.model, m.model.layers[0].self_attn,
                  m.model.layers[1].mlp.down_proj, m.model.norm]:
        layer.register_forward_pre_hook(hook)
    ids = ptt.to_tensor(np.arange(16).reshape(2, 8))
    logits, loss = m(ids, labels=ids)
    assert seen and set(seen) == {torch.Tensor}
    assert type(logits) is ptt.Tensor and type(loss) is ptt.Tensor
    out = m(torch.arange(16).reshape(2, 8))
    assert type(out) is torch.Tensor


def test_user_layer_inside_a_port_container():
    """A user's layer inside ``nn.Sequential`` gets Paddle ``Tensor``s and
    hands plain ones back to the container."""
    seen = []

    class Probe(ptt.nn.Layer):
        def forward(self, x):
            seen.append(type(x))
            return x.transpose([1, 0]).transpose([1, 0]) * 2

    seq = ptt.nn.Sequential(ptt.nn.Linear(3, 3), Probe(), ptt.nn.ReLU())
    out = seq(ptt.ones([2, 3]))
    assert seen == [ptt.Tensor] and type(out) is ptt.Tensor
    assert type(seq(torch.ones(2, 3))) is torch.Tensor


def test_set_device_choice_and_refusal():
    assert ptt.get_device() == "cpu"
    assert ptt.zeros([1]).place == "cpu"
    assert ptt.device.resolve_device(None) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptt.set_device("gpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptt.set_device("gpu:0")
    assert ptt.get_device() == "cpu"  # a refused choice changes nothing
    with pytest.raises(ValueError):
        ptt.set_device("tpu")
    assert ptt.device.memory_allocated() == 0  # the CPU keeps no stats


def test_functional_takes_paddle_tensors_in_a_user_forward():
    """A user's ``forward`` calls ``nn.functional`` on the ``Tensor``s it
    gets; the loss matches the JAX package's on the same weights."""
    def make(pkg):
        F = pkg.nn.functional

        class Head(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(4, 3)

            def forward(self, x, y):
                logits = F.relu(self.fc(x)).reshape([-1, 3])
                return F.cross_entropy(logits, y)
        return Head()
    j, t = make(pt), make(ptt)
    t.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    rng = np.random.RandomState(1)
    x, y = rng.rand(6, 4).astype(np.float32), rng.randint(0, 3, (6,))
    jl = j(pt.to_tensor(x), pt.to_tensor(y))
    tl = t(ptt.to_tensor(x), ptt.to_tensor(y))
    assert type(tl) is ptt.Tensor
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), rtol=1e-5)
