"""``LlamaForCausalLM.generate`` of the port (``models/generation.py``'s
``generate_loop`` over the eager growing ``(k, v)`` cache) held against
the JAX package's ``generate`` on bridged weights: the greedy tokens
equal, token for token; the prefill and decode logits equal at the
layers' tolerance; and every greedy token equals the argmax of the
cacheless forward over the sequence so far (the port's replay
oracle)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401
from torch_api_common import on_cpu  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    jm = jax_tiny(seed=3)
    return jm, bridged(jm)


def _prompt(b=2, s=7, seed=0):
    return np.random.RandomState(seed).randint(1, 256, (b, s))


def _reference_tokens(jm, ids, n, eos=None):
    """The reference's greedy tokens through its compiled loop, which
    equals its eager ``generate`` token for token
    (``tests/test_compiled_generate.py::test_compiled_equals_eager_greedy``)
    in one XLA compile instead of one per op and cache length. It runs the
    whole budget, finished rows emitting ``eos``; the eager loop stops
    after the step at which every row has emitted it, so the reference's
    eager output is this one cut there."""
    out = np.asarray(jm.generate_compiled(
        pt.to_tensor(ids), max_new_tokens=n, temperature=0,
        eos_token_id=eos).numpy())
    if eos is not None:
        done = np.logical_or.accumulate(out[:, ids.shape[1]:] == eos, 1)
        if done.all(0).any():
            out = out[:, :ids.shape[1] + int(done.all(0).argmax()) + 1]
    return out


def test_greedy_tokens_equal_the_reference(pair):
    jm, tm = pair
    ids = _prompt()
    ref = _reference_tokens(jm, ids, 12)
    out = tm.generate(ptt.to_tensor(ids), max_new_tokens=12, temperature=0)
    assert type(out) is ptt.Tensor
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.shape == [2, 7 + 12]


def test_cached_logits_equal_the_reference(pair):
    """The prefill's and one decode step's logits through the eager cache,
    against the JAX model's cached forward, at the layers' tolerance."""
    jm, tm = pair
    ids = _prompt(s=5)
    L = jm.cfg.num_hidden_layers
    jh, jc = jm.model(pt.to_tensor(ids), caches=[(None, None)] * L)
    with torch.no_grad():
        th, tc = tm.model(torch.as_tensor(ids), caches=[(None, None)] * L)
    np.testing.assert_allclose(th.numpy(), jh.numpy(), rtol=1e-4, atol=1e-5)
    tok = np.array([[3], [9]])
    jh, _ = jm.model(pt.to_tensor(tok), caches=jc)
    with torch.no_grad():
        th, tc2 = tm.model(torch.as_tensor(tok), caches=tc)
    np.testing.assert_allclose(th.numpy(), jh.numpy(), rtol=1e-4, atol=1e-5)
    assert tc2[0][0].shape == (2, 6, jm.cfg.num_key_value_heads,
                               jm.cfg.hidden_size
                               // jm.cfg.num_attention_heads)


def test_greedy_tokens_replay_the_cacheless_forward(pair):
    _, tm = pair
    ids = torch.as_tensor(_prompt(b=3, s=4, seed=1))
    out = tm.generate(ids, max_new_tokens=10, temperature=0)
    assert type(out) is torch.Tensor
    with torch.no_grad():
        for t in range(4, out.shape[1]):
            logits = tm(out[:, :t])
            assert torch.equal(logits[:, -1].argmax(-1), out[:, t])


def test_eos_ends_the_loop_early(pair):
    jm, tm = pair
    ids = _prompt()
    first = tm.generate(ptt.to_tensor(ids), max_new_tokens=3,
                        temperature=0).numpy()
    eos = int(first[0, 7])  # row 0 emits it first
    out = tm.generate(ptt.to_tensor(ids), max_new_tokens=12, temperature=0,
                      eos_token_id=eos).numpy()
    np.testing.assert_array_equal(out, _reference_tokens(jm, ids, 12, eos))
    assert (out[0, 7:] == eos).all()


def test_sampling_repeats_under_the_same_seed(pair):
    _, tm = pair
    ids = ptt.to_tensor(_prompt())
    ptt.seed(11)
    a = tm.generate(ids, max_new_tokens=6, temperature=0.8, top_k=20,
                    top_p=0.9).numpy()
    ptt.seed(11)
    b = tm.generate(ids, max_new_tokens=6, temperature=0.8, top_k=20,
                    top_p=0.9).numpy()
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < 256)).all()


def test_moe_generate_still_raises():
    """The MoE LM's ``generate`` runs since the MoE serving slice (its
    tokens against the reference's are in ``test_torch_moe_serving.py``)
    and keeps the last decode step's ``l_aux``, as the reference's eager
    ``generate`` does: ``aux_loss()`` afterwards equals the reference's
    on bridged weights at the layers' tolerance. What still raises is a
    ragged ``generate_compiled``: the MoE forward takes no
    ``attention_mask``, as the reference's does not."""
    from paddle_tpu.models import moe as jmoe
    from paddle_tpu_torch.models.generation import compiled_generate
    from paddle_tpu_torch.models.moe import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    from test_torch_bridge import state_dict_from_jax
    pt.seed(5)
    jm = jmoe.MoeForCausalLM(jmoe.MoeConfig.tiny())
    jm.eval()
    m = MoeForCausalLM(MoeConfig.tiny(), device="cpu")
    m.eval()
    load_numpy_state(m, state_dict_from_jax(jm))
    ids = torch.ones(2, 3, dtype=torch.long)
    assert m.generate(ids, max_new_tokens=2, temperature=0).shape == (2, 5)
    jm.generate(pt.to_tensor(ids.numpy()), max_new_tokens=2, temperature=0)
    np.testing.assert_allclose(float(m.aux_loss()),
                               float(np.asarray(jm.aux_loss().numpy())),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(TypeError, match="attention_mask"):
        compiled_generate(m, ids, max_new_tokens=2,
                          attention_mask=np.array([[0, 1, 1], [1, 1, 1]]))
