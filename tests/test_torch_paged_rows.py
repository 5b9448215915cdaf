"""The per-row block-paged path of the port (``ops.paged_attention``'s
``PagedLayerCache``, ``write_to_pool``, ``paged_attention_step``) through
Llama and the MoE LM, against the JAX package's on bridged weights, on
the CPU in float32; and the read-path override.

Three rows of 7, 3 and 10 prompt tokens are prefilled in chunks of 4
through their own block tables (block size 4, right-padded tails, a row
that finishes early carrying ``new_lens`` 0), then decoded three steps
of one token a row in the same padded ``[B, 4]`` chunk (one input shape,
so the reference's step, jitted, compiles once), as
``tests/test_serving.py::test_paged_cache_matches_concat_cache`` drives
one row; that test's own single-row prefill and ``[1, 1]`` decode
against the growing cache runs on the port too. Each step's final-norm hidden states at the valid
positions are held against the reference's at the layers' tolerance
(rtol 1e-4, atol 1e-5; ``tests/test_layers.py``); the reference's own
test holds its paged path to its growing cache at atol 2e-5, which the
port's path is held to as well. The MoE's padded tokens claim no
expert capacity, as the reference's token mask (``models/moe.py:132``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed.mesh import mesh_scope
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import moe as jmoe
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as pa

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import load_into_jax, undrawn_jax_init

TOL = dict(rtol=1e-4, atol=1e-5)
LENS = [7, 3, 10]
CHUNK, BS, NBLK = 4, 4, 4


@pytest.fixture(autouse=True, scope="module")
def no_global_mesh():
    with mesh_scope(None):
        yield


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _tables():
    """Row b owns blocks 1 + b*NBLK .. (b+1)*NBLK; the pools hold them all
    plus the null block 0."""
    return np.array([[1 + b * NBLK + i for i in range(NBLK)]
                     for b in range(len(LENS))], np.int32)


class _Rows:
    """Drives both models' trunks over the rows' chunks and decode steps
    through the per-row paged caches, the port's pools updated in place
    and the reference's threaded through its returned caches."""

    def __init__(self, jtrunk, ttrunk, n_layers, n_kv, hd):
        shape = (len(LENS) * NBLK + 1, BS, n_kv, hd)
        self.jt, self.tt = jtrunk, ttrunk
        self.jpools = [(jnp.zeros(shape, jnp.float32),) * 2
                       for _ in range(n_layers)]
        self.jit_step = jax.jit(self._jax_step)
        self.tpools = [[torch.zeros(shape) for _ in range(2)]
                       for _ in range(n_layers)]
        self.ctx = np.zeros(len(LENS), np.int32)

    def _jax_step(self, ids, bt, ctx, nl, pools):
        jc = [jpa.PagedLayerCache(pt.Tensor(k), pt.Tensor(v), pt.Tensor(bt),
                                  pt.Tensor(ctx), pt.Tensor(nl))
              for k, v in pools]
        h, new = self.jt(pt.Tensor(ids), caches=jc)
        return h.data, [(c.k_pool.data, c.v_pool.data) for c in new]

    def step(self, ids, new_lens):
        bt, ctx = _tables(), self.ctx.copy()
        nl = np.asarray(new_lens, np.int32)
        tc = [pa.PagedLayerCache(k, v, torch.from_numpy(bt),
                                 torch.from_numpy(ctx), torch.from_numpy(nl))
              for k, v in self.tpools]
        # the reference's step traced once as one program (every step has
        # the same shapes), its pools threaded through
        jh, self.jpools = self.jit_step(ids, bt, ctx, nl, self.jpools)
        th, tnew = self.tt(torch.from_numpy(ids), caches=tc)
        assert all(a.k_pool is b[0] for a, b in zip(tnew, self.tpools))
        self.ctx = self.ctx + nl
        return _np(th), np.asarray(jh)


def _drive(rows, vocab):
    """Chunked prefill with padded tails, then three decode steps fed the
    port's greedy picks; the valid hidden rows of every step compared."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, vocab, n) for n in LENS]
    done = [0] * len(LENS)
    while any(d < n for d, n in zip(done, LENS)):
        ids = np.zeros((len(LENS), CHUNK), np.int64)
        nl = []
        for b, p in enumerate(prompts):
            k = min(CHUNK, len(p) - done[b])
            ids[b, :k] = p[done[b]:done[b] + k]
            done[b] += k
            nl.append(k)
        th, jh = rows.step(ids, nl)
        for b, k in enumerate(nl):
            np.testing.assert_allclose(th[b, :k], jh[b, :k], **TOL)
    last = th[:, 0]
    for _ in range(3):
        ids = np.zeros((len(LENS), CHUNK), np.int64)
        ids[:, 0] = np.abs(last[:, :5]).argmax(-1) + 1
        th, jh = rows.step(ids, [1] * len(LENS))
        np.testing.assert_allclose(th[:, :1], jh[:, :1], **TOL)
        last = th[:, 0]


def test_llama_paged_rows_equal_the_reference():
    with undrawn_jax_init():
        jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
            num_hidden_layers=2))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                          device="cpu", seed=1)
    load_into_jax(jm, tm)
    cfg = tm.cfg
    hd = cfg.hidden_size // cfg.num_attention_heads
    rows = _Rows(jm.model, tm.model, cfg.num_hidden_layers,
                 cfg.num_key_value_heads, hd)
    _drive(rows, cfg.vocab_size)
    # the reference's own check: one row's paged prefill and decode equal
    # its growing (concat) cache's hidden states
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, 128, (1, 7)))
    h1, kv = tm.model(ids, caches=[(None, None)] * 2)
    tok = torch.tensor([[17]])
    h2, _ = tm.model(tok, caches=kv)
    shape = (NBLK + 1, BS, cfg.num_key_value_heads, hd)
    pools = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    bt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    for x, ctx, want in ((ids, 0, h1), (tok, 7, h2)):
        pc = [pa.PagedLayerCache(k, v, bt, torch.tensor([ctx]),
                                 torch.tensor([x.shape[1]]))
              for k, v in pools]
        got, _ = tm.model(x, caches=pc)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    pc = [pa.PagedLayerCache(k, v, bt, torch.tensor([0]), torch.tensor([1]))
          for k, v in pools]
    with pytest.raises(NotImplementedError, match="derive positions"):
        tm.model(tok, caches=pc, attention_mask=torch.ones(1, 1))


def test_moe_paged_rows_equal_the_reference():
    """The MoE LM's routed layer masks the padded tails out of routing
    (``token_mask[b, i] = i < new_lens[b]``), as the reference's per-row
    branch: the hidden states equal the reference's at every step."""
    cfg = dict(num_attention_heads=4, num_key_value_heads=2)
    with undrawn_jax_init():
        jm = jmoe.MoeForCausalLM(jmoe.MoeConfig.tiny(**cfg))
    jm.eval()
    tm = MoeForCausalLM(MoeConfig.tiny(**cfg), device="cpu", seed=3)
    tm.eval()
    load_into_jax(jm, tm)
    c = tm.cfg
    rows = _Rows(jm, tm, c.num_hidden_layers, c.num_key_value_heads,
                 c.hidden_size // c.num_attention_heads)
    _drive(rows, c.vocab_size)


def test_write_to_pool_and_step_redirect_padding():
    """Padded tokens land in the null block only; a row's live blocks
    hold exactly its valid tokens, as the reference's ``write_to_pool``."""
    pool = torch.zeros(5, 2, 1, 1)
    jpool = pt.to_tensor(np.zeros((5, 2, 1, 1), np.float32))
    bt = np.array([[1, 2], [3, 4]], np.int32)
    new = np.arange(1, 7, dtype=np.float32).reshape(2, 3, 1, 1)
    pos = np.array([[0, 1, 2], [1, 2, 3]], np.int64)
    valid = np.array([[True, True, False], [True, True, True]])
    pa.write_to_pool(pool, torch.from_numpy(new), torch.from_numpy(bt),
                     torch.from_numpy(pos), torch.from_numpy(valid))
    ref = jpa.write_to_pool(jpool.data, new, bt, pos, valid)
    np.testing.assert_array_equal(_np(pool)[1:], np.asarray(ref)[1:])


def test_impl_override_and_the_env_knob(monkeypatch):
    """``paged_attention_impl`` is the override on this thread, else
    ``rpa`` with a card and ``gather`` without; the reference's
    ``PADDLE_TPU_PAGED_ATTN_IMPL`` is not read (a pinned divergence). A
    token-packed step with ``attn_impl=None`` takes the resolved path."""
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN_IMPL", "rpa")
    assert pa.paged_attention_impl() == "gather"  # no card here
    with pa.impl_override("rpa"):
        assert pa.paged_attention_impl() == "rpa"
        with pa.impl_override(None):  # clears the pin, as the reference
            assert pa.paged_attention_impl() == "gather"
        with pa.impl_override("gather"):
            assert pa.paged_attention_impl() == "gather"
        assert pa.paged_attention_impl() == "rpa"
    assert pa.paged_attention_impl() == "gather"
    with pytest.raises(ValueError, match="want rpa"):
        with pa.impl_override("auto"):
            pass
    calls = []
    real = pa.ragged_gather_attention
    monkeypatch.setattr(pa, "ragged_gather_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    T, n, hd = 2, 2, 4
    bt = torch.tensor([[1], [0]], dtype=torch.int32)
    args = (torch.randn(T, n, hd), torch.randn(T, 1, hd),
            torch.randn(T, 1, hd), torch.zeros(2, 4, 1, hd),
            torch.zeros(2, 4, 1, hd), bt, torch.tensor([0, 2, 2]),
            torch.tensor([0, 0]), torch.tensor([0, 0]), torch.tensor([0, 1]),
            torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32))
    pa.ragged_paged_attention_step(*args, attn_impl=None)
    assert calls == [1]
