"""The port's Llama serving path against ``paddle_tpu`` on bridged weights.

Components first (RMSNorm, Linear, Embedding, SiLU, the RoPE tables and
the interleaved rotation), then one unified token-packed step of
``LlamaConfig.tiny`` — decode rows and a prefill chunk over a pre-filled
paged cache — through both backbones with the same ``RaggedLayerCache``
metadata: hidden states, last-token logits and the updated pools.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import llama as jl
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
    DEFAULT_TILE_Q, build_step_maps, rpa_max_steps)

from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401

COMPONENT_ATOL = 1e-6
STEP_TOL = dict(rtol=1e-4, atol=1e-4)  # other summation order


def _np(x):
    return np.asarray(x.data if isinstance(x, Tensor) else x)


@pytest.fixture(scope="module")
def pair():
    jm = jax_tiny(4)
    return jm, bridged(jm)


def test_rms_norm_and_silu(pair):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32) * 3
    w = rng.randn(64).astype(np.float32)
    ref = _np(JF.rms_norm(pt.to_tensor(x), pt.to_tensor(w), 1e-5))
    ours = TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(ours.numpy(), ref, atol=COMPONENT_ATOL)
    ref = _np(JF.silu(pt.to_tensor(x)))
    np.testing.assert_allclose(TF.silu(torch.from_numpy(x)).numpy(), ref,
                               atol=COMPONENT_ATOL)
    # the model's norm layer on bridged weights
    jm, tm = pair
    ref = _np(jm.model.layers[0].input_layernorm(pt.to_tensor(x)))
    # parameters are trainable: the layer's output carries autograd
    ours = tm.model.layers[0].input_layernorm(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(ours.numpy(), ref, atol=COMPONENT_ATOL)


def test_linear_and_embedding(pair):
    jm, tm = pair
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 64).astype(np.float32)
    for name in ("q_proj", "k_proj", "o_proj"):
        ref = _np(getattr(jm.model.layers[1].self_attn, name)(
            pt.to_tensor(x)))
        ours = getattr(tm.model.layers[1].self_attn, name)(
            torch.from_numpy(x)).detach()
        np.testing.assert_allclose(ours.numpy(), ref, atol=COMPONENT_ATOL)
    ids = rng.randint(0, 256, (2, 9)).astype(np.int32)
    ref = _np(jm.model.embed_tokens(pt.to_tensor(ids)))
    ours = tm.model.embed_tokens(torch.from_numpy(ids)).detach()
    np.testing.assert_allclose(ours.numpy(), ref, atol=COMPONENT_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_tables_and_rotation(dtype):
    theta = 500000.0
    cos_j, sin_j = jl._rope_cache(128, 16, theta, dtype)
    cos32, sin32 = tl._rope_cache(128, 16, theta)
    tdt = getattr(torch, dtype)
    cos_t = torch.from_numpy(cos32).to(tdt)
    sin_t = torch.from_numpy(sin32).to(tdt)
    # the same table, bit for bit, in the model dtype
    assert cos_t.float().numpy().tobytes() == \
        np.asarray(cos_j, np.float32).tobytes()
    assert sin_t.float().numpy().tobytes() == \
        np.asarray(sin_j, np.float32).tobytes()
    rng = np.random.RandomState(2)
    x = rng.randn(10, 4, 16).astype(np.float32)
    pidx = rng.randint(0, 128, 10)
    ref = np.asarray(jl._rot_interleaved(
        jnp.asarray(x), jnp.asarray(np.asarray(cos32)[pidx])[:, None, :],
        jnp.asarray(np.asarray(sin32)[pidx])[:, None, :]))
    ours = tl._rot_interleaved(torch.from_numpy(x),
                               torch.from_numpy(cos32)[pidx][:, None, :],
                               torch.from_numpy(sin32)[pidx][:, None, :])
    np.testing.assert_allclose(ours.numpy(), ref, atol=COMPONENT_ATOL)


def _step_metadata(rng, cfg, block_size=4, max_seqs=4, mbps=12,
                   pool_blocks=40):
    """Three decode rows at varied depths plus one 9-token prefill chunk
    over 5 cached tokens, packed like the engine packs them, and pools
    pre-filled with random 'earlier' context."""
    seqs = [(1, 6), (1, 13), (1, 2), (9, 5)]
    tile_q = DEFAULT_TILE_Q
    T = -(-(max_seqs + 9) // tile_q) * tile_q
    hd = cfg.hidden_size // cfg.num_attention_heads
    bt = np.zeros((max_seqs + 1, mbps), np.int32)
    cu = np.zeros(max_seqs + 2, np.int32)
    ctx = np.zeros(max_seqs + 1, np.int32)
    sid = np.full(T, max_seqs, np.int32)
    pos = np.zeros(T, np.int32)
    last = np.zeros(max_seqs, np.int32)
    kv_lens, nxt, off = [], 1, 0
    for s, (n, c) in enumerate(seqs):
        npg = -(-(n + c) // block_size)
        bt[s, :npg] = np.arange(nxt, nxt + npg)
        nxt += npg
        ctx[s] = c
        sid[off:off + n] = s
        pos[off:off + n] = c + np.arange(n)
        cu[s + 1] = off + n
        last[s] = off + n - 1
        kv_lens.append(n + c)
        off += n
    cu[len(seqs) + 1:] = off
    ssq, sbk = build_step_maps(
        cu[:len(seqs) + 1], kv_lens, total_tokens=T, tile_q=tile_q,
        block_size=block_size,
        max_steps=rpa_max_steps(tile_q, mbps, max_seqs),
        max_seqs=max_seqs)
    shape = (pool_blocks + 1, block_size, cfg.num_key_value_heads, hd)
    pools = [rng.randn(*shape).astype(np.float32)
             for _ in range(2 * cfg.num_hidden_layers)]
    tokens = rng.randint(1, cfg.vocab_size, (1, T)).astype(np.int32)
    return dict(tokens=tokens, meta=(bt, cu, ctx, sid, pos, ssq, sbk),
                pools=pools, last=last, valid=sid < max_seqs)


@pytest.mark.parametrize("tied", [False, True])
def test_unified_ragged_step_matches_jax(tied):
    jm = jax_tiny(5 + tied, tie_word_embeddings=tied)
    tm = bridged(jm)
    nl = jm.cfg.num_hidden_layers
    d = _step_metadata(np.random.RandomState(7), jm.cfg)
    meta = d["meta"]

    jcaches = [jpa.RaggedLayerCache(
        Tensor(jnp.asarray(d["pools"][2 * i])),
        Tensor(jnp.asarray(d["pools"][2 * i + 1])),
        *[Tensor(jnp.asarray(m)) for m in meta]) for i in range(nl)]
    with no_grad(), jpa.impl_override("gather"):
        jh, jnew = jm.model(Tensor(jnp.asarray(d["tokens"])), caches=jcaches)
        jsel = Tensor(jh.data[0][jnp.asarray(d["last"])][:, None, :])
        jlogits = _np(jm._logits(jsel))[:, 0]
    jh = _np(jh)[0]

    valid = d["valid"]
    for impl in ("rpa", "gather"):
        pools = [torch.from_numpy(p.copy()) for p in d["pools"]]
        tmeta = [torch.from_numpy(m) for m in meta]
        tcaches = [tpa.RaggedLayerCache(pools[2 * i], pools[2 * i + 1],
                                        *tmeta) for i in range(nl)]
        with torch.no_grad():
            th, _ = tm.model(torch.from_numpy(d["tokens"]), caches=tcaches,
                             attn_impl=impl)
            tsel = th[0][torch.from_numpy(d["last"]).long()][:, None, :]
            tlogits = tm._logits(tsel)[:, 0].numpy()
        np.testing.assert_allclose(th[0].numpy()[valid], jh[valid],
                                   **STEP_TOL)
        np.testing.assert_allclose(tlogits, jlogits, **STEP_TOL)
        # block 0 is the null block: every padding token writes its slot
        # 0, and which duplicate wins is unspecified in both packages (no
        # live step ever reads it), so the comparison starts at block 1
        for i in range(nl):
            np.testing.assert_allclose(pools[2 * i].numpy()[1:],
                                       _np(jnew[i].k_pool)[1:], **STEP_TOL)
            np.testing.assert_allclose(pools[2 * i + 1].numpy()[1:],
                                       _np(jnew[i].v_pool)[1:], **STEP_TOL)
            # in place: the caches hold the very tensors that were updated
            assert tcaches[i].k_pool is pools[2 * i]


def test_sample_token_filters_like_the_reference():
    """Greedy is argmax; top-k 1 and a tiny top-p leave one candidate, so
    every draw is the argmax in both packages, whatever the generators;
    a wide top-k keeps the draw inside the k best."""
    from paddle_tpu.models.generation import sample_token as jax_sample
    from paddle_tpu_torch.models.generation import sample_token
    rng = np.random.RandomState(9)
    logits = rng.randn(4, 50).astype(np.float32) * 3
    want = logits.argmax(-1)
    g = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits)
    for kw in (dict(temperature=0.0, top_k=0, top_p=1.0),
               dict(temperature=0.7, top_k=1, top_p=1.0),
               dict(temperature=1.3, top_k=0, top_p=1e-6)):
        ours = sample_token(t, generator=g, **kw).numpy()
        ref = np.asarray(jax_sample(jnp.asarray(logits), **kw))
        assert np.array_equal(ours, want) and np.array_equal(ref, want)
    top5 = np.argsort(logits, -1)[:, -5:]
    for _ in range(20):
        draw = sample_token(t, 1.0, 5, 1.0, generator=g).numpy()
        assert all(d in row for d, row in zip(draw, top5))
