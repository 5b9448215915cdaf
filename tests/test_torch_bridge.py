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
from paddle_tpu_torch.utils.bridge import load_numpy_state, numpy_state


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


def state_dict_from_jax(model) -> dict:
    """``{qualified name: numpy array}`` of a ``paddle_tpu`` model's
    parameters — the names its functional state uses."""
    return {n: np.asarray(p.data) for n, p in model.named_parameters()}


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
    jm = jax_tiny(1, tie_word_embeddings=tied)
    state = state_dict_from_jax(jm)
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
