"""numpy state-dict bridge between ``paddle_tpu`` and ``paddle_tpu_torch``.

Holds :func:`state_dict_from_jax`, the JAX side of the bridge, which the
other ``test_torch_*`` files import: the port itself never touches
``paddle_tpu``. Weights always cross through numpy, never through
matching the two frameworks' random generators.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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


@contextlib.contextmanager
def undrawn_jax_init():
    """Inside the block the JAX package's initializers draw nothing:
    ``jax.random``'s ``normal``, ``truncated_normal`` and ``uniform`` give
    zeros. A test builds a reference model in it only when it loads every
    weight afterwards (the port's, through :func:`load_into_jax`), so no
    draw is ever read; it saves one XLA compile of a random kernel per
    parameter shape (~0.4 s each on the CPU)."""
    def normal(key, shape=(), dtype=None, **kw):
        return jnp.zeros(shape, dtype or jnp.float32)

    def truncated_normal(key, lower, upper, shape=None, dtype=None, **kw):
        return jnp.zeros(shape or (), dtype or jnp.float32)

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0, **kw):
        return jnp.zeros(shape, dtype or jnp.float32)
    fakes = {"normal": normal, "truncated_normal": truncated_normal,
             "uniform": uniform}
    saved = {n: getattr(jax.random, n) for n in fakes}
    for n, f in fakes.items():
        setattr(jax.random, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(jax.random, n, f)


def load_into_jax(jax_model, port_model):
    """Copy the port model's parameters and bridged buffers into the JAX
    model (the bridge's other direction), with every name checked."""
    state = numpy_state(port_model)
    missing, unexpected = jax_model.set_state_dict(state)
    assert not unexpected, unexpected
    assert not set(missing) & set(state_dict_from_jax(jax_model)), missing
    return state


def jax_value_and_grads(model, loss_fn, *arrays):
    """The JAX package's loss on ``arrays`` and the gradient of every
    trainable parameter of ``model``, as its ``TrainStep`` computes them
    (``paddle_tpu/jit/train_step.py:384-400``: ``jax.value_and_grad`` over
    the functional state, the model called with its storage swapped),
    under one ``jax.jit``: the function its eager tape computes, in one
    XLA compile instead of one per op and shape. ``loss_fn(model,
    *tensors)`` returns ``(loss, aux)``. Returns numpy ``(loss, aux,
    {name: gradient}, {name: buffer as the call left it})``; the model's
    own storage is untouched."""
    from paddle_tpu.core.autograd import no_grad
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.jit.functional import functional_state, swap_state
    train, frozen, buffers = functional_state(model)

    def loss_of(tr, *arrs):
        with no_grad(), swap_state(model, {**tr, **frozen, **buffers}) \
                as out_bufs:
            loss, aux = loss_fn(model, *[Tensor(a) for a in arrs])
            aux = jax.tree_util.tree_map(
                lambda t: t.data if isinstance(t, Tensor) else t, aux,
                is_leaf=lambda t: isinstance(t, Tensor))
        return loss.data, (aux, out_bufs)
    (loss, (aux, bufs)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(train, *arrays)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return np.asarray(loss), as_np(aux), as_np(grads), as_np(bufs)


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


@pytest.mark.parametrize("n_slots", [0, 2])
def test_lora_leaves_cross_under_the_reference_names(n_slots):
    """LoRA adapters (``tuning.apply_lora``) cross the bridge under the
    reference's names, ``...q_proj.lora_A``/``lora_B``, in the 2-D
    training form and the ``[n_slots + 1, ...]`` serving stacks, bit for
    bit both ways."""
    from paddle_tpu import tuning as jtuning
    from paddle_tpu_torch import tuning
    jm = jax_tiny(5)
    jtuning.apply_lora(jm, jtuning.LoRAConfig(rank=4), n_slots=n_slots)
    state = state_dict_from_jax(jm)
    lora = sorted(k for k in state if ".lora_" in k)
    assert len(lora) == 2 * 2 * 7
    assert "model.layers.0.self_attn.q_proj.lora_A" in lora
    assert state[lora[0]].ndim == (3 if n_slots else 2)
    cfg = tl.LlamaConfig(**{f: getattr(jm.cfg, f) for f in
                            tl.LlamaConfig.__dataclass_fields__})
    tm = tl.LlamaForCausalLM(cfg, device="cpu")
    tuning.apply_lora(tm, tuning.LoRAConfig(rank=4), n_slots=n_slots)
    load_numpy_state(tm, state)
    back = numpy_state(tm)
    assert sorted(back) == sorted(state)
    assert all(back[k].tobytes() == state[k].tobytes() for k in state)


@pytest.mark.parametrize("layer", ["multi_transformer", "ec_moe"])
def test_incubate_nn_names_cross_unchanged(layer):
    """``incubate.nn``'s fused layers keep the reference's parameter
    names and shapes (the packed ``qkv_weight [3, H, hd, E]``, the
    ``linear1``/``ln2`` families, ``FusedEcMoe``'s ``moe.*``), so a JAX
    state dict loads into the port and comes back bit for bit."""
    import paddle_tpu.incubate.nn as jinn
    from paddle_tpu.distributed.mesh import mesh_scope
    from paddle_tpu_torch.incubate import nn as inn
    pt.seed(6)
    with mesh_scope(None):
        if layer == "multi_transformer":
            jm = jinn.FusedMultiTransformer(16, 2, 32, num_layers=2)
            tm = inn.FusedMultiTransformer(16, 2, 32, num_layers=2,
                                           device="cpu")
            name = "layers.1.fused_attn.qkv_weight"
            shape = (3, 2, 8, 16)
        else:
            jm = jinn.FusedEcMoe(8, 16, num_experts=4)
            tm = inn.FusedEcMoe(8, 16, num_experts=4, device="cpu")
            name, shape = "moe.w1", (4, 8, 16)
        state = state_dict_from_jax(jm)
    assert state[name].shape == shape
    load_numpy_state(tm, state)
    back = numpy_state(tm)
    assert sorted(back) == sorted(state)
    assert all(back[k].tobytes() == state[k].tobytes() for k in state)
