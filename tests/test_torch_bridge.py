"""numpy state-dict bridge between ``paddle_tpu`` and ``paddle_tpu_torch``.

Holds :func:`state_dict_from_jax`, the JAX side of the bridge, which the
other ``test_torch_*`` files import: the port itself never touches
``paddle_tpu``. Weights always cross through numpy, never through
matching the two frameworks' random generators.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.utils.bridge import (BRIDGED_BUFFERS,
                                           load_numpy_state, numpy_state)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run tiny tensors: one intra-op thread is as
    fast, and keeps these tests from crowding the CPU that the suite's
    timing-sensitive tests share under parallel workers. Other test
    files import this fixture; the thread count is restored after each
    module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def state_dict_from_jax(model, buffers=True) -> dict:
    """``{qualified name: numpy array}`` of a ``paddle_tpu`` model's
    parameters — the names its functional state uses — and, unless
    ``buffers=False``, of its buffers that the bridge carries
    (``BRIDGED_BUFFERS``: running statistics, SpectralNorm's vectors),
    read through ``named_buffers()``."""
    out = {n: np.asarray(p.data) for n, p in model.named_parameters()}
    if buffers:
        out.update(buffers_from_jax(model))
    return out


def buffers_from_jax(model) -> dict:
    """``{qualified name: numpy array}`` of the bridged buffers of a
    ``paddle_tpu`` model."""
    return {n: np.asarray(b.data) for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] in BRIDGED_BUFFERS}


def jax_tiny(seed=0, **kw):
    pt.seed(seed)
    m = LlamaForCausalLM(LlamaConfig.tiny(**kw))
    m.eval()
    return m


def bridged(jax_model, **kw):
    """The port's twin of ``jax_model`` on the CPU, weights bridged."""
    cfg = tl.LlamaConfig(**{f: getattr(jax_model.cfg, f) for f in
                            tl.LlamaConfig.__dataclass_fields__})
    m = tl.LlamaForCausalLM(cfg, device="cpu", **kw)
    load_numpy_state(m, state_dict_from_jax(jax_model))
    return m


@pytest.mark.parametrize("tied", [False, True])
def test_round_trip_is_byte_identical(tied):
    """The Llama state is its parameters alone: none of the port's own
    buffers (the RoPE tables) crosses, so the key set is the parameter
    names, as before the bridge carried buffers."""
    jm = jax_tiny(1, tie_word_embeddings=tied)
    state = state_dict_from_jax(jm)
    assert sorted(state) == sorted(n for n, _ in jm.named_parameters())
    back = numpy_state(bridged(jm))
    assert sorted(back) == sorted(state)
    assert ("lm_head.weight" in state) is (not tied)
    for name, arr in state.items():
        assert back[name].dtype == arr.dtype, name
        assert back[name].shape == arr.shape, name
        assert back[name].tobytes() == arr.tobytes(), name


def test_mismatches_raise_before_any_write():
    jm = jax_tiny(2)
    port = bridged(jm)
    before = numpy_state(port)
    state = state_dict_from_jax(jm)
    bad = dict(state)
    bad.pop("model.norm.weight")
    with pytest.raises(KeyError, match="model.norm.weight"):
        load_numpy_state(port, bad)
    bad = dict(state, **{"model.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="model.extra.weight"):
        load_numpy_state(port, bad)
    bad = {k: v + 1 for k, v in state.items()}
    bad["model.norm.weight"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_numpy_state(port, bad)
    bad = {k: v + 1 for k, v in state.items()}
    bad["model.norm.weight"] = state["model.norm.weight"].astype(np.float16)
    with pytest.raises(TypeError, match="dtype"):
        load_numpy_state(port, bad)
    after = numpy_state(port)
    assert all(after[k].tobytes() == before[k].tobytes() for k in before)


def test_bfloat16_arrays_carry_their_bits():
    jm = jax_tiny(3)
    import jax.numpy as jnp
    state = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
             for k, v in state_dict_from_jax(jm).items()}
    cfg = tl.LlamaConfig.tiny()
    port = tl.LlamaForCausalLM(cfg, device="cpu", dtype="bfloat16")
    load_numpy_state(port, state)
    w = port.model.layers[0].self_attn.q_proj.weight
    ref = state["model.layers.0.self_attn.q_proj.weight"]
    assert w.dtype == torch.bfloat16
    assert w.view(torch.int16).numpy().tobytes() == \
        ref.view(np.int16).tobytes()
    with pytest.raises(TypeError, match="bfloat16"):
        numpy_state(port)


def test_round_trip_with_buffers_is_byte_identical():
    """A model with batch norms: the parameters and the running
    statistics (``_mean``, ``_variance``) cross both ways bit for bit,
    after a training forward in the reference has moved the statistics
    off their initial zeros and ones; a state without the buffers
    raises."""
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    pt.seed(4)
    jm = jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4),
                        jnn.ReLU(), jnn.Conv2D(4, 2, 1), jnn.BatchNorm2D(2))
    jm(pt.to_tensor(np.random.RandomState(0).randn(2, 3, 6, 6)
                    .astype(np.float32)))
    state = state_dict_from_jax(jm)
    bufs = buffers_from_jax(jm)
    assert sorted(bufs) == ["1._mean", "1._variance", "4._mean",
                            "4._variance"]
    assert not np.allclose(bufs["1._mean"], 0.0)
    port = tnn.Sequential(tnn.Conv2D(3, 4, 3, device="cpu"),
                          tnn.BatchNorm2D(4, device="cpu"), tnn.ReLU(),
                          tnn.Conv2D(4, 2, 1, device="cpu"),
                          tnn.BatchNorm2D(2, device="cpu"))
    load_numpy_state(port, state)
    back = numpy_state(port)
    assert sorted(back) == sorted(state)
    for name, arr in state.items():
        assert back[name].tobytes() == arr.tobytes(), name
    with pytest.raises(KeyError, match="_mean"):
        load_numpy_state(port, state_dict_from_jax(jm, buffers=False))
