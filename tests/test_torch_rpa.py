"""The port's ragged-paged-attention module against the JAX reference.

On the CPU the port's RPA wrapper computes its plain PyTorch version
(``ragged_paged_attention_reference``); these tests hold it, the port's
gather path, the host-side work lists (``build_step_maps``) and the in-place pool
scatter against ``paddle_tpu`` (its RPA Pallas kernel in interpret mode,
as ``tests/test_ragged_paged_attention.py`` runs it). The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_kernels.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.pallas import ragged_paged_attention as trpa

from test_torch_bridge import one_torch_thread  # noqa: F401

# the JAX package's ops.pallas re-exports the function under the module's
# name, so reach the module itself through importlib
jrpa = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")

ATOL = 2e-5  # the JAX RPA test's own f32 tolerance


def _random_mix(rng, block_size, max_seqs=6, tile_q=8):
    """A ragged mix of (new_len, context_len): decode rows, prefill
    chunks straddling q tiles, and a new_len == 0 padding slot."""
    n = rng.randint(2, max_seqs)
    seqs = []
    for _ in range(n):
        kind = rng.randint(3)
        if kind == 0:
            seqs.append((1, int(rng.randint(0, 3 * block_size))))
        elif kind == 1:
            seqs.append((int(rng.randint(2, 2 * tile_q + 3)),
                         int(rng.randint(0, 2 * block_size))))
        else:
            seqs.append((0, 0))
    if all(s == 0 for s, _ in seqs):
        seqs[0] = (3, 1)
    return seqs


def _case(rng, seqs, block_size, n_kv, grp, hd=16, tile_q=8, mbps=8,
          pool_blocks=40):
    """Everything both packages need for one token-packed step, as numpy
    (the shape of ``_ragged_case`` in the JAX RPA test)."""
    n_heads = n_kv * grp
    max_seqs = len(seqs) + 1
    total_new = sum(n for n, _ in seqs)
    T = -(-max(total_new, 1) // tile_q) * tile_q
    bt = np.zeros((max_seqs + 1, mbps), np.int32)
    nxt, kv_lens = 1, []
    for s, (n, c) in enumerate(seqs):
        kv_lens.append(n + c)
        npg = -(-(n + c) // block_size)
        bt[s, :npg] = np.arange(nxt, nxt + npg)
        nxt += npg
    assert nxt - 1 <= pool_blocks
    cu = np.zeros(max_seqs + 2, np.int32)
    cu[1:len(seqs) + 1] = np.cumsum([n for n, _ in seqs])
    cu[len(seqs) + 1:] = cu[len(seqs)]
    ctx = np.zeros(max_seqs + 1, np.int32)
    ctx[:len(seqs)] = [c for _, c in seqs]
    sid = np.full(T, max_seqs, np.int32)
    pos = np.zeros(T, np.int32)
    off = 0
    for s, (n, c) in enumerate(seqs):
        sid[off:off + n] = s
        pos[off:off + n] = c + np.arange(n)
        off += n
    kp = rng.randn(pool_blocks + 1, block_size, n_kv, hd).astype(np.float32)
    vp = rng.randn(*kp.shape).astype(np.float32)
    knew = rng.randn(T, n_kv, hd).astype(np.float32)
    vnew = rng.randn(T, n_kv, hd).astype(np.float32)
    q = rng.randn(T, n_heads, hd).astype(np.float32)
    max_steps = jrpa.rpa_max_steps(tile_q, mbps, pool_blocks)
    ssq, sbk = jrpa.build_step_maps(
        cu[:len(seqs) + 1], kv_lens, total_tokens=T, tile_q=tile_q,
        block_size=block_size, max_steps=max_steps, max_seqs=max_seqs)
    return dict(q=q, kp=kp, vp=vp, knew=knew, vnew=vnew, bt=bt, cu=cu,
                ctx=ctx, sid=sid, pos=pos, ssq=ssq, sbk=sbk,
                max_seqs=max_seqs, hd=hd)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", range(6))
def test_build_step_maps_equals_reference(seed):
    rng = np.random.RandomState(seed)
    for bs, tile_q in ((4, 8), (8, 8), (16, 4)):
        seqs = _random_mix(rng, bs, tile_q=tile_q)
        cu = np.concatenate([[0], np.cumsum([n for n, _ in seqs])])
        kv = [n + c for n, c in seqs]
        T = -(-max(int(cu[-1]), 1) // tile_q) * tile_q
        # the port bounds the work list by the sequences a tile can
        # overlap, not by the pool (the prefix cache shares pages)
        max_steps = trpa.rpa_max_steps(tile_q, 8, len(seqs))
        assert max_steps == min(tile_q, len(seqs)) * 8
        kw = dict(total_tokens=T, tile_q=tile_q, block_size=bs,
                  max_steps=max_steps, max_seqs=len(seqs))
        ours = trpa.build_step_maps(cu, kv, **kw)
        ref = jrpa.build_step_maps(cu, kv, **kw)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for fn in (trpa.build_step_maps, jrpa.build_step_maps):
            with pytest.raises(ValueError, match="max_steps"):
                fn(cu, [bs * 50] * len(kv), **kw)
            with pytest.raises(ValueError, match="multiple"):
                fn(cu, kv, **dict(kw, total_tokens=T + 1))


@pytest.mark.parametrize("block_size", [4, 8])
def test_write_tokens_to_pool_equals_reference(block_size):
    rng = np.random.RandomState(block_size)
    c = _case(rng, [(5, 3), (1, 9), (0, 0), (7, 0)], block_size, n_kv=2,
              grp=2)
    for pool, new in (("kp", "knew"), ("vp", "vnew")):
        ref = np.asarray(jpa.write_tokens_to_pool(
            jnp.asarray(c[pool]), jnp.asarray(c[new]), jnp.asarray(c["bt"]),
            jnp.asarray(c["sid"]), jnp.asarray(c["pos"])))
        ours = _t(c[pool])
        ret = tpa.write_tokens_to_pool(ours, _t(c[new]), _t(c["bt"]),
                                       _t(c["sid"]), _t(c["pos"]))
        assert ret is ours  # in place: the pool is not copied
        assert np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("block_size,grp", [(8, 1), (8, 4), (16, 1),
                                            (16, 4)])
def test_reference_and_gather_match_jax(block_size, grp):
    """The port's plain RPA and gather paths vs JAX RPA (interpret) and
    JAX gather, on mixes with prefill chunks straddling q tiles, decode
    rows, and a padding slot."""
    rng = np.random.RandomState(block_size * 10 + grp)
    seqs = [(5, 0), (1, 2 * block_size + 3), (0, 0), (1, 3),
            (9, block_size), (12, 5)]
    c = _case(rng, seqs, block_size, n_kv=2, grp=grp)
    scale = 1.0 / np.sqrt(c["hd"])
    jk = jpa.write_tokens_to_pool(jnp.asarray(c["kp"]), jnp.asarray(
        c["knew"]), jnp.asarray(c["bt"]), jnp.asarray(c["sid"]),
        jnp.asarray(c["pos"]))
    jv = jpa.write_tokens_to_pool(jnp.asarray(c["vp"]), jnp.asarray(
        c["vnew"]), jnp.asarray(c["bt"]), jnp.asarray(c["sid"]),
        jnp.asarray(c["pos"]))
    j_rpa = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["bt"]),
        jnp.asarray(c["cu"]), jnp.asarray(c["ctx"]), c["ssq"], c["sbk"]))
    j_gather = np.asarray(jpa.ragged_gather_attention(
        jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["bt"]),
        jnp.asarray(c["sid"]), jnp.asarray(c["pos"]), scale=scale))
    tk, tv = _t(c["kp"]), _t(c["vp"])
    meta = [_t(c[k]) for k in ("bt", "cu", "ctx", "sid", "pos", "ssq",
                               "sbk")]
    bt, cu, ctx, sid, pos, ssq, sbk = meta
    t_out = {}
    for impl in ("rpa", "gather"):
        k2, v2 = tk.clone(), tv.clone()
        t_out[impl] = tpa.ragged_paged_attention_step(
            _t(c["q"]), _t(c["knew"]), _t(c["vnew"]), k2, v2, bt, cu, ctx,
            sid, pos, ssq, sbk, attn_impl=impl).reshape(
                c["q"].shape).numpy()
        assert np.array_equal(k2.numpy(), np.asarray(jk))
        assert np.array_equal(v2.numpy(), np.asarray(jv))
    valid = c["sid"] < c["max_seqs"]
    np.testing.assert_allclose(t_out["rpa"][valid], j_rpa[valid],
                               atol=ATOL)
    np.testing.assert_allclose(t_out["gather"][valid], j_gather[valid],
                               atol=ATOL)
    np.testing.assert_allclose(t_out["rpa"][valid], t_out["gather"][valid],
                               atol=ATOL)
    # padding rows of the plain RPA version come out exactly 0
    assert np.all(t_out["rpa"][~valid] == 0.0)
    assert np.all(j_rpa[~valid] == 0.0)


def test_reference_gather_view_equals_reference():
    rng = np.random.RandomState(3)
    pool = rng.randn(6, 4, 2, 8).astype(np.float32)
    bt = np.array([[1, 3, 0], [2, 0, 0]], np.int32)
    ours = tpa.gather_pool(_t(pool), _t(bt)).numpy()
    ref = np.asarray(jpa.gather_pool(jnp.asarray(pool), jnp.asarray(bt)))
    assert np.array_equal(ours, ref)


# ------------------- the bf16 kernel's split, in plain PyTorch -------------------
# (tile_q, min_pages, max_chunks): chunks of 1, 2 and 3 pages, and the
# kernel's own chunking (min_pages and max_chunks of the module)
SPLIT_CASES = [(8, 1, 64), (8, 2, 64), (16, 3, 64), (32, 2, 3),
               (8, None, None), (16, None, None), (32, None, None)]


@pytest.mark.parametrize("tile_q,min_pages,max_chunks", SPLIT_CASES)
def test_split_emulation_matches_jax(one_torch_thread, tile_q, min_pages,
                                     max_chunks):
    """K4's bf16 design (per-chunk ``(m, l, acc)`` over the work list,
    then the log-sum-exp combine) against the JAX RPA kernel in interpret
    mode at the JAX test's f32 tolerance. The mix has a long decode
    context spanning many chunks, decode rows sharing a tile with a
    prefill chunk (so they see no key in the prefill sequence's chunks),
    two sequences sharing their first pages, a padding slot and a padding
    tail, whose rows are exactly 0. The port's step maps equal the
    reference's at this tile."""
    rng = np.random.RandomState(tile_q + (min_pages or 0))
    bs = 4
    seqs = [(1, 45), (1, 9), (0, 0), (13, 6), (1, 2), (2 * tile_q + 3, 7)]
    c = _case(rng, seqs, bs, n_kv=2, grp=2, tile_q=tile_q, mbps=24,
              pool_blocks=60)
    c["bt"][1, :2] = c["bt"][0, :2]  # sequence 1 shares sequence 0's pages
    kv = [n + ctx for n, ctx in seqs]
    cu = np.concatenate([[0], np.cumsum([n for n, _ in seqs])])
    kw = dict(total_tokens=c["q"].shape[0], tile_q=tile_q, block_size=bs,
              max_steps=trpa.rpa_max_steps(tile_q, 24, c["max_seqs"]),
              max_seqs=c["max_seqs"])
    ssq, sbk = trpa.build_step_maps(cu, kv, **kw)
    for a, b in zip((ssq, sbk), jrpa.build_step_maps(cu, kv, **kw)):
        assert np.array_equal(a, b)
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["bt"]), jnp.asarray(c["cu"]), jnp.asarray(c["ctx"]),
        ssq, sbk))
    got = trpa._rpa_split_plain(
        _t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["bt"]), _t(c["cu"]),
        _t(c["ctx"]), _t(ssq), _t(sbk), min_pages=min_pages,
        max_chunks=max_chunks).numpy()
    valid = c["sid"] < c["max_seqs"]
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)
    assert np.all(got[~valid] == 0.0)
    if min_pages is not None:  # the split really cut the long context
        info, _ = trpa._rpa_items_plain(_t(ssq), c["max_seqs"], min_pages,
                                        max_chunks)
        assert int(info[3]) > 1


def _items_by_loops(step_seq, max_seqs, min_pages, max_chunks):
    """The work list written as loops over a numpy step map."""
    info, items = [], []
    for row in step_seq:
        dead = np.nonzero(row >= max_seqs)[0]
        live = int(dead[0]) if len(dead) else len(row)
        length = max(min_pages, -(-live // max_chunks))
        n = -(-live // length)
        info += [live, length, len(items), n]
        items += [len(info) // 4 - 1] * n
    return info + [len(items)], items


@pytest.mark.parametrize("seed", range(4))
def test_work_list_matches_an_enumeration(seed):
    """The plain version of the bf16 kernel's work list against
    loops over the step map: each tile's live prefix, cut into at most
    max_chunks chunks of at least min_pages steps, the chunks numbered
    tile after tile; a dead tile has none."""
    rng = np.random.RandomState(seed)
    for bs, tile_q in ((4, 8), (8, 16), (4, 32)):
        seqs = _random_mix(rng, bs, tile_q=tile_q) + [(1, 40 * bs)]
        cu = np.concatenate([[0], np.cumsum([n for n, _ in seqs])])
        kv = [n + c for n, c in seqs]
        T = (-(-int(cu[-1]) // tile_q) + 2) * tile_q  # two dead tiles
        ssq, _ = trpa.build_step_maps(
            cu, kv, total_tokens=T, tile_q=tile_q, block_size=bs,
            max_steps=trpa.rpa_max_steps(tile_q, 64, len(seqs)),
            max_seqs=len(seqs))
        for min_pages, max_chunks in ((1, 4), (2, 16), (3, 2)):
            info, items = trpa._rpa_items_plain(_t(ssq), len(seqs),
                                                min_pages, max_chunks)
            want_info, want_items = _items_by_loops(ssq, len(seqs),
                                                    min_pages, max_chunks)
            assert info.tolist() == want_info
            assert items.shape == (ssq.shape[0] * max_chunks,)
            assert items[:len(want_items)].tolist() == want_items
