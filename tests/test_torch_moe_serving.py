"""MoE serving and decoding on the port against ``paddle_tpu``, on the
CPU in float32: the MoE LM behind the port's ``ServingEngine`` gives the
JAX engine's greedy streams exactly (a multi-chunk prefill, a shared
prefix with the prefix cache on and off, the RPA and gather read paths),
a request's tokens do not depend on the engine's slot count
(``tests/test_serving.py::test_moe_served_independent_of_inactive_slots``),
``quantize="int8_wo"``, int8 KV and LoRA tenant slots do what the
reference's do, and ``generate``/``generate_compiled`` give the JAX
package's tokens. ``aux_loss()`` is the reference's after the eager
``generate`` and ``None`` after the others.

Both engines run the same step geometry (``step_tokens`` 8), so both
route with the same expert capacity. The JAX tokens come from its
compiled loop, which equals its eager ``generate`` for the MoE LM
(``tests/test_compiled_generate.py::test_moe_compiled_equals_eager_greedy``).
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import tuning as jtuning
from paddle_tpu.distributed.mesh import mesh_scope
from paddle_tpu.models import moe as jmoe
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import tuning
from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

# the reference test's MoE: 4/2 heads, 4 experts top-2, one shared, the
# first layer dense
CFG = dict(num_attention_heads=4, num_key_value_heads=2)
KW = dict(max_batch=4, max_blocks=32, block_size=4, prefill_chunk=4)
LORA = dict(rank=4, alpha=8.0)


@pytest.fixture(autouse=True, scope="module")
def no_global_mesh():
    """The JAX MoE layer shards its experts on a global mesh that another
    test of the same worker may have left behind; these tests run
    without."""
    with mesh_scope(None):
        yield


def _pair(seed, n_slots=0):
    """A JAX MoE LM and its port twin on the CPU, weights bridged (after
    ``apply_lora(n_slots=)`` on both, when asked)."""
    pt.seed(seed)
    jm = jmoe.MoeForCausalLM(jmoe.MoeConfig.tiny(**CFG))
    jm.eval()
    tm = MoeForCausalLM(MoeConfig.tiny(**CFG), device="cpu")
    tm.eval()
    if n_slots:
        jtuning.apply_lora(jm, jtuning.LoRAConfig(**LORA), n_slots=n_slots)
        tuning.apply_lora(tm, tuning.LoRAConfig(**LORA), n_slots=n_slots)
    load_numpy_state(tm, state_dict_from_jax(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(3)


def _prompts():
    """Lengths 9, 5 and 13 (multi-chunk prefills at chunk 4), then two
    prompts sharing two full blocks of prefix."""
    rng = np.random.RandomState(0)
    prefix = list(rng.randint(1, 128, 8))
    return [list(rng.randint(1, 128, n)) for n in (9, 5, 13)] + \
        [prefix + [5, 6], prefix + [7]]


def _streams(engine, jobs, n=6):
    handles = [engine.submit(list(p), max_new_tokens=n, adapter_id=a)
               for p, a in jobs]
    engine.run_until_idle()
    out = [h.result(30)["token_ids"] for h in handles]
    engine.cache.allocator.assert_no_leaks()
    return out


def _jax_engine(jm, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # int8 KV: rpa -> gather warning
        return JaxEngine(jm, **kw)


@pytest.fixture(scope="module")
def jax_streams(pair):
    """The JAX engine's streams of ``_prompts()``, prefix cache on and
    off (one compile each)."""
    jm, _ = pair
    jobs = [(p, 0) for p in _prompts()]
    return {pc: _streams(_jax_engine(jm, prefix_cache=pc, **KW), jobs)
            for pc in (True, False)}


@pytest.mark.parametrize("impl", ["rpa", "gather"])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_moe_engine_streams_equal_jax(pair, jax_streams, impl,
                                      prefix_cache):
    """Multi-chunk prefills and a shared prefix: the port's MoE engine
    gives the JAX engine's greedy streams exactly; with the prefix cache
    on, the second prompt of the shared prefix hits it. The gates'
    ``l_aux`` is cleared after every step."""
    _, tm = pair
    eng = ServingEngine(tm, device="cpu", attn_impl=impl,
                        prefix_cache=prefix_cache, **KW)
    got = _streams(eng, [(p, 0) for p in _prompts()])
    assert got == jax_streams[prefix_cache]
    assert tm.aux_loss() is None
    st = eng.stats()
    assert st["step_tokens"] == 8 and st["max_model_len"] == 32 * 4
    if prefix_cache:
        assert st["prefix_cache"]["hits"] > 0


def test_moe_served_independent_of_inactive_slots(pair):
    """The reference test's case: one request gives the same tokens in a
    1-slot and a 4-slot engine (padding takes no expert capacity: the
    token mask from the sentinel sequence id), and the JAX engine's."""
    jm, tm = pair
    p = list(np.random.RandomState(21).randint(1, 128, 9))
    outs = [_streams(ServingEngine(tm, device="cpu", **dict(
        KW, max_batch=mb)), [(p, 0)])[0] for mb in (1, 4)]
    # the position cap comes through _attn_cfg(): MoeConfig has none
    big = ServingEngine(tm, device="cpu", **dict(KW, max_blocks=4096))
    assert big.max_model_len == 8192
    assert outs[0] == outs[1]
    assert outs[0] == _streams(_jax_engine(jm, **dict(KW, max_batch=1)),
                               [(p, 0)])[0]
    assert tm.aux_loss() is None


@pytest.mark.parametrize("option", ["int8_wo", "int8_kv"])
def test_quantized_moe_engine_streams_equal_jax(option):
    """``quantize="int8_wo"`` quantizes the 2-D projections by name (the
    experts' 3-D stacks and the gate stay in their dtype) and
    ``kv_dtype="int8"`` reads int8 pools through the gather path: each
    gives the JAX engine's streams with the same option."""
    jm, tm = _pair(5)
    kw = dict(quantize="int8_wo") if option == "int8_wo" else \
        dict(kv_dtype="int8")
    jobs = [(p, 0) for p in _prompts()[:3]]
    ref = _streams(_jax_engine(jm, **kw, **KW), jobs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServingEngine(tm, device="cpu", **kw, **KW)
    assert _streams(eng, jobs) == ref
    if option == "int8_wo":
        assert "layers.1.self_attn.q_proj.weight" in eng._qleaves
        assert "lm_head.weight" in eng._qleaves
        assert not any(k.endswith((".w1", ".w2", "gate.weight"))
                       for k in eng._qleaves)
        assert tm.layers[1].mlp.w1.dtype == torch.float32
    else:
        assert eng.attn_impl == "gather"
        assert eng.cache.k_pools[0].dtype == torch.int8
    assert tm.aux_loss() is None


def test_lora_slots_on_the_moe_engine():
    """LoRA tenant slots on the MoE LM, as the reference has them (the
    default targets' 2-D projections carry the stacks, the expert stacks
    none): the base slot and a loaded tenant each give the JAX engine's
    stream."""
    jm, tm = _pair(7, n_slots=2)
    stacks = {k: v for k, v in tm.named_parameters() if "lora_" in k}
    assert any(".self_attn." in k for k in stacks)
    assert not any(".mlp.w" in k for k in stacks)
    rng = np.random.RandomState(8)
    tenant = {k: (rng.randn(*v.shape[1:]) * 0.5).astype(np.float32)
              for k, v in stacks.items()}
    jeng = JaxEngine(jm, **KW)
    eng = ServingEngine(tm, device="cpu", **KW)
    jeng.load_adapter(1, tenant, name="a")
    eng.load_adapter(1, tenant, name="a")
    p = _prompts()[0]
    jobs = [(p, 0), (p, 1)]
    got = _streams(eng, jobs)
    assert got == _streams(jeng, jobs)
    assert got[0] != got[1]


def test_generate_and_generate_compiled_equal_jax(pair):
    """Greedy ``generate`` (the eager growing cache) and
    ``generate_compiled`` (static buffers; its one-shot and chunked
    prefills) give the JAX package's tokens. After the eager
    ``generate`` the gates keep the last decode step's ``l_aux``, as the
    reference's do: ``aux_loss()`` equals the reference's after its eager
    ``generate`` (two new tokens: the reference compiles each op of each
    step) at the layers' tolerance. After ``generate_compiled`` it is
    ``None`` in both packages, and a fresh training forward gives a real
    one again."""
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 128, (2, 8))
    ref = np.asarray(jm.generate_compiled(
        pt.to_tensor(ids.astype(np.int64)), max_new_tokens=8,
        temperature=0.0).numpy())
    t = torch.as_tensor(ids)
    got = tm.generate(t, max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    tm.generate(t, max_new_tokens=2, temperature=0.0)
    jm.generate(pt.to_tensor(ids.astype(np.int64)), max_new_tokens=2,
                temperature=0.0)
    np.testing.assert_allclose(float(tm.aux_loss()),
                               float(np.asarray(jm.aux_loss().numpy())),
                               rtol=1e-4, atol=1e-5)
    jm.clear_decode_side_effects()
    for chunk in (0, 4):
        got = tm.generate_compiled(t, max_new_tokens=8, prefill_chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert tm.aux_loss() is None
    tm(t, labels=t)
    aux = tm.aux_loss()
    assert aux is not None and bool(torch.isfinite(aux))
    tm.clear_decode_side_effects()
