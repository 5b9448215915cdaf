"""``LlamaForCausalLM.generate_compiled`` of the port
(``models/generation.compiled_generate`` over the static KV buffers of
``LlamaAttention._static_forward``) held against the JAX package on
bridged weights: the Llama cases of ``tests/test_compiled_generate.py``
one for one, on the CPU route (the decode step eager, every index on the
device), with the tokens compared to the reference's. The captured route
runs on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``
phase 15)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import generation
from paddle_tpu_torch.models import llama as tl
from test_torch_bridge import load_into_jax, undrawn_jax_init
from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import on_cpu  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    """The reference test's model (``_tiny``) in both packages, with the
    port's seeded weights."""
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128,
              tie_word_embeddings=True)
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**kw), device="cpu", seed=0)
    with undrawn_jax_init():
        jm = LlamaForCausalLM(LlamaConfig(**kw))
    load_into_jax(jm, tm)
    jm.eval()
    tm.eval()
    return jm, tm


def _ids(b, s, seed, low=0):
    return np.random.RandomState(seed).randint(low, 128, (b, s)) \
        .astype(np.int64)


def _pad_left(prompts, pad_id=0):
    """Right-align 1-D prompts: ``(ids, mask)``."""
    S = max(len(p) for p in prompts)
    ids = np.full((len(prompts), S), pad_id, np.int64)
    mask = np.zeros((len(prompts), S), np.int64)
    for b, p in enumerate(prompts):
        ids[b, S - len(p):] = p
        mask[b, S - len(p):] = 1
    return ids, mask


def _port(tm, ids, **kw):
    return tm.generate_compiled(torch.as_tensor(ids), **kw).numpy()


def _ref(jm, ids, **kw):
    if "attention_mask" in kw:
        kw["attention_mask"] = pt.to_tensor(kw["attention_mask"])
    return np.asarray(jm.generate_compiled(pt.to_tensor(ids), **kw).numpy())


def test_compiled_equals_eager_greedy(pair):
    jm, tm = pair
    ids = _ids(2, 12, 0)
    comp = _port(tm, ids, max_new_tokens=16, temperature=0.0)
    eager = tm.generate(torch.as_tensor(ids), max_new_tokens=16,
                        temperature=0.0).numpy()
    np.testing.assert_array_equal(comp, eager)
    np.testing.assert_array_equal(
        comp, _ref(jm, ids, max_new_tokens=16, temperature=0.0))


@pytest.mark.parametrize("B", [1, 4])
def test_compiled_greedy_batch_sizes(pair, B):
    _, tm = pair
    ids = _ids(B, 8, B)
    comp = _port(tm, ids, max_new_tokens=8, temperature=0.0)
    # the port's eager generate equals the reference's
    # (tests/test_torch_generate.py)
    eager = tm.generate(torch.as_tensor(ids), max_new_tokens=8,
                        temperature=0.0).numpy()
    np.testing.assert_array_equal(comp, eager)


def test_compiled_eos_padding(pair):
    """Finished rows keep emitting eos, the prompt is kept, and the whole
    budget runs (no early exit), as the reference's."""
    jm, tm = pair
    ids = _ids(2, 6, 3)
    first = int(tm.generate(torch.as_tensor(ids), max_new_tokens=1,
                            temperature=0.0)[0, -1])
    out = _port(tm, ids, max_new_tokens=10, temperature=0.0,
                eos_token_id=first)
    assert out.shape == (2, 16)
    np.testing.assert_array_equal(out[:, :6], ids)
    assert (out[0, 6:] == first).all()
    np.testing.assert_array_equal(
        out, _ref(jm, ids, max_new_tokens=10, temperature=0.0,
                  eos_token_id=first))


def test_static_cache_matches_concat_cache(pair):
    """The fixed-shape path gives the growing cache's hidden states
    (prefill and one decode step) and the reference's static path's,
    and moves the position on the device."""
    jm, tm = pair
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 128, (2, 7))
    tok = rng.randint(0, 128, (2, 1))
    n = tm.cfg.num_hidden_layers
    with torch.no_grad():
        h1, caches = tm.model(torch.as_tensor(ids), caches=[(None, None)] * n)
        h2, _ = tm.model(torch.as_tensor(tok), caches=caches)
        shape = (2, 12, tm.cfg.num_key_value_heads,
                 tm.cfg.hidden_size // tm.cfg.num_attention_heads)
        st = [(torch.zeros(shape), torch.zeros(shape),
               torch.zeros((), dtype=torch.int32)) for _ in range(n)]
        g1, st = tm.model(torch.as_tensor(ids), caches=st)
        g2, st = tm.model(torch.as_tensor(tok), caches=st)
    np.testing.assert_allclose(g1.numpy(), h1.numpy(), atol=2e-5)
    np.testing.assert_allclose(g2.numpy(), h2.numpy(), atol=2e-5)
    assert int(st[0][2]) == 8 and st[0][2].dtype == torch.int32
    jst = [(pt.to_tensor(jnp.zeros(shape, jnp.float32)),
            pt.to_tensor(jnp.zeros(shape, jnp.float32)),
            pt.to_tensor(jnp.zeros((), jnp.int32))) for _ in range(n)]
    # the reference's static path as one program (its to_static equals
    # its eager call: tests/test_jit.py::TestToStatic::test_layer_parity)
    sm = pt.jit.to_static(jm.model)
    j1, jst = sm(pt.to_tensor(ids), caches=jst)
    j2, _ = sm(pt.to_tensor(tok), caches=jst)
    np.testing.assert_allclose(g1.numpy(), j1.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), j2.numpy(), rtol=1e-4, atol=1e-5)


def test_compiled_cache_reused(pair):
    _, tm = pair
    tm.__dict__.pop("_compiled_generate", None)
    ids = _ids(1, 5, 1)
    _port(tm, ids, max_new_tokens=4)
    assert len(tm.__dict__["_compiled_generate"]) == 1
    _port(tm, ids, max_new_tokens=4)
    assert len(tm.__dict__["_compiled_generate"]) == 1  # same signature
    _port(tm, ids, max_new_tokens=6)
    assert len(tm.__dict__["_compiled_generate"]) == 2


def test_compiled_cache_keeps_the_last_sixteen_signatures(pair):
    """The LRU cap of the reference (``_COMPILED_CACHE_CAP``): the
    least recently used signature goes first."""
    _, tm = pair
    tm.__dict__.pop("_compiled_generate", None)
    ids = _ids(1, 3, 2)
    for n in range(1, generation._COMPILED_CACHE_CAP + 2):
        _port(tm, ids, max_new_tokens=n)
    cache = tm.__dict__["_compiled_generate"]
    assert len(cache) == generation._COMPILED_CACHE_CAP
    assert sorted(sig[2] for sig in cache) == \
        list(range(2, generation._COMPILED_CACHE_CAP + 2))


def test_chunked_prefill_matches_one_shot(pair):
    _, tm = pair
    ids = _ids(2, 12, 7)
    one = _port(tm, ids, max_new_tokens=8, temperature=0.0)
    chunked = _port(tm, ids, max_new_tokens=8, temperature=0.0,
                    prefill_chunk=4)
    np.testing.assert_array_equal(chunked, one)
    whole = _port(tm, ids, max_new_tokens=8, temperature=0.0,
                  prefill_chunk=12)
    np.testing.assert_array_equal(whole, one)
    with pytest.raises(ValueError, match="divide"):
        _port(tm, ids, max_new_tokens=4, prefill_chunk=5)


def test_ragged_batch_matches_solo_runs(pair):
    """Each row of a left-padded batch equals its prompt's solo run, and
    the batch equals the reference's ragged output."""
    jm, tm = pair
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 128, n).astype(np.int64) for n in (5, 9, 12)]
    ids, mask = _pad_left(prompts)
    out = _port(tm, ids, max_new_tokens=8, temperature=0.0,
                attention_mask=torch.as_tensor(mask))
    S = ids.shape[1]
    for b, p in enumerate(prompts):
        solo = _port(tm, p[None, :], max_new_tokens=8, temperature=0.0)[0]
        np.testing.assert_array_equal(out[b, S:], solo[len(p):],
                                      err_msg=f"row {b}")
    np.testing.assert_array_equal(
        out, _ref(jm, ids, max_new_tokens=8, temperature=0.0,
                  attention_mask=mask))


def test_ragged_equal_lengths_match_unmasked(pair):
    _, tm = pair
    ids = _ids(3, 7, 12)
    got = _port(tm, ids, max_new_tokens=6, temperature=0.0,
                attention_mask=np.ones_like(ids))
    want = _port(tm, ids, max_new_tokens=6, temperature=0.0)
    np.testing.assert_array_equal(got, want)


def test_ragged_entry_reused_across_pad_patterns(pair):
    """The mask is an input: two pad patterns share one entry."""
    _, tm = pair
    tm.__dict__.pop("_compiled_generate", None)
    rng = np.random.RandomState(13)
    for lens in [(3, 6), (6, 4)]:
        ids, mask = _pad_left([rng.randint(1, 128, n) for n in lens])
        _port(tm, ids, max_new_tokens=3, temperature=0.0,
              attention_mask=mask)
    assert len(tm.__dict__["_compiled_generate"]) == 1


def test_ragged_rejects_right_padding(pair):
    _, tm = pair
    ids = _ids(2, 6, 14, low=1)
    mask = np.ones((2, 6), np.int64)
    mask[0, 4:] = 0
    with pytest.raises(ValueError, match="LEFT-padded"):
        _port(tm, ids, max_new_tokens=2, temperature=0.0,
              attention_mask=mask)


def test_ragged_with_chunked_prefill(pair):
    _, tm = pair
    rng = np.random.RandomState(15)
    ids, mask = _pad_left([rng.randint(1, 128, n) for n in (4, 8)])
    want = _port(tm, ids, max_new_tokens=5, temperature=0.0,
                 attention_mask=mask)
    got = _port(tm, ids, max_new_tokens=5, temperature=0.0, prefill_chunk=4,
                attention_mask=mask)
    np.testing.assert_array_equal(got, want)


def test_padded_training_forward_matches_solo(pair):
    """The cacheless path: a right-padded row's real positions give the
    solo run's logits, and the reference's."""
    jm, tm = pair
    solo = _ids(1, 5, 16, low=1)
    ids = np.concatenate([solo, np.zeros((1, 3), np.int64)], 1)
    mask = np.concatenate([np.ones((1, 5)), np.zeros((1, 3))], 1) \
        .astype(np.int64)
    with torch.no_grad():
        padded = tm(torch.as_tensor(ids),
                    attention_mask=torch.as_tensor(mask)).numpy()
        alone = tm(torch.as_tensor(solo)).numpy()
    np.testing.assert_allclose(padded[:, :5], alone, rtol=2e-4, atol=2e-5)
    ref = pt.jit.to_static(jm)(pt.to_tensor(ids),
                               attention_mask=pt.to_tensor(mask)).numpy()
    np.testing.assert_allclose(padded[:, :5], np.asarray(ref)[:, :5],
                               rtol=1e-4, atol=1e-5)


def test_paddle_tensors_and_sampling(pair):
    """A Paddle ``Tensor`` in gives one out; sampling draws in-vocabulary
    tokens from ``core.generator``, and ``seed(n)`` repeats them; greedy
    decoding draws nothing."""
    _, tm = pair
    ids = _ids(2, 6, 17)
    out = tm.generate_compiled(ptt.to_tensor(ids), max_new_tokens=4)
    assert type(out) is ptt.Tensor and out.shape == [2, 10]
    ptt.seed(3)
    a = _port(tm, ids, max_new_tokens=6, temperature=1.0, top_k=8,
              top_p=0.9)
    ptt.seed(3)
    state = ptt.get_rng_state()
    _port(tm, ids, max_new_tokens=6, temperature=0.0)
    after = ptt.get_rng_state()
    assert all(torch.equal(state[1][k], after[1][k]) for k in state[1])
    b = _port(tm, ids, max_new_tokens=6, temperature=1.0, top_k=8,
              top_p=0.9)
    np.testing.assert_array_equal(a, b)
    assert ((a[:, 6:] >= 0) & (a[:, 6:] < 128)).all()
