"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the port's wrappers compute their plain versions; these
tests hold them, the autograd function around them and the plain
``flash_attention_reference`` against ``paddle_tpu``'s Pallas flash
kernels in interpret mode (with small explicit tiles, as
``tests/test_flash_attention.py`` runs them), across causal,
offset-causal, GQA, segment ids with fully masked rows, row, full and
bool bias, and dropout. The dropout hash must equal the reference's bit
for bit. The CUDA kernels themselves are held against the plain version
on the card by ``tests/test_torch_kernels.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops.pallas import flash_attention as tfa

from test_torch_bridge import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

# tests/test_flash_attention.py's own f32 tolerances (:69, :282)
O_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _seg(rows, b):
    return np.repeat(np.asarray([rows], np.int32), b, 0)


def _case(name, rng, B=2, Hq=4, Sq=32, Sk=32, D=16):
    """(q/k/v shapes' kv heads, kv length, kwargs) of one named case."""
    hkv, kw = 2, {}
    if name == "causal":
        kw = dict(causal=True)
    elif name == "offset_causal":
        Sk, kw = 48, dict(causal=True)
    elif name == "gqa_group_4":
        hkv, kw = 1, dict(causal=True)
    elif name == "mha":
        hkv, kw = 4, dict(causal=False)
    elif name == "segments_dead_rows":
        # q rows of segment 9 see no key: exact 0 and zero gradient
        kw = dict(causal=True,
                  q_segment_ids=_seg([1] * 20 + [9] * 12, B),
                  kv_segment_ids=_seg([1] * 12 + [2] * 20, B))
    elif name == "row_bias":
        kw = dict(bias=rng.randn(B, 1, 1, Sk).astype(np.float32))
    elif name == "full_bias":
        kw = dict(causal=True,
                  bias=rng.randn(1, Hq, Sq, Sk).astype(np.float32))
    elif name == "bool_bias":
        mask = rng.rand(B, 1, 1, Sk) > 0.3
        mask[..., 0] = True  # every row keeps a live key
        kw = dict(bias=mask)
    elif name == "dropout":
        kw = dict(causal=True, dropout_p=0.2, dropout_seed=1234)
    return hkv, Sk, kw


CASES = ["causal", "offset_causal", "gqa_group_4", "mha",
         "segments_dead_rows", "row_bias", "full_bias", "bool_bias",
         "dropout"]


@pytest.mark.parametrize("name", CASES)
def test_matches_jax_forward_and_gradients(name):
    rng = np.random.RandomState(CASES.index(name))
    B, Hq, Sq, D = 2, 4, 32, 16
    hkv, Sk, kw = _case(name, rng, B, Hq, Sq, D=D)
    q = rng.randn(B, Hq, Sq, D).astype(np.float32)
    k = rng.randn(B, hkv, Sk, D).astype(np.float32)
    v = rng.randn(B, hkv, Sk, D).astype(np.float32)
    do = rng.randn(B, Hq, Sq, D).astype(np.float32)

    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    jo, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_bhsd(
        a, b, c, block_q=16, block_k=16, **jkw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    jo = np.asarray(jo)

    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    # the autograd function over the wrappers (CPU: plain versions) and
    # autograd through the plain reference must both match
    for impl in ("wrapper", "reference"):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        if impl == "wrapper":
            o = tfa.flash_attention_bhsd(*ts, block_q=16, block_k=16, **tkw)
        else:
            o, lse = tfa.flash_attention_reference(*ts, **tkw)
            assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
        o.backward(torch.from_numpy(do))
        np.testing.assert_allclose(o.detach().numpy(), jo, **O_TOL)
        for t, jg in zip(ts, jgrads):
            np.testing.assert_allclose(t.grad.numpy(), jg, **GRAD_TOL)
        if name == "segments_dead_rows":
            assert np.all(o.detach().numpy()[:, :, 20:] == 0.0)
            assert np.all(ts[0].grad.numpy()[:, :, 20:] == 0.0)


def test_bshd_layout_and_3d_inputs_match_jax():
    rng = np.random.RandomState(11)
    q = rng.randn(2, 32, 4, 16).astype(np.float32)   # [B, S, H, D]
    k = rng.randn(2, 32, 2, 16).astype(np.float32)
    ours = tfa.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(k), causal=True)
    # the reference's Tensor-API wrapper needs its eager core; its bhsd
    # core on swapped axes is the same function
    ref = jfa.flash_attention_bhsd(
        jnp.swapaxes(jnp.asarray(q), 1, 2), jnp.swapaxes(jnp.asarray(k), 1, 2),
        jnp.swapaxes(jnp.asarray(k), 1, 2), causal=True, block_q=16,
        block_k=16)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jnp.swapaxes(ref, 1, 2)), **O_TOL)
    q3 = rng.randn(3, 32, 16).astype(np.float32)
    seg = _seg([1] * 10 + [2] * 22, 3)
    ours3 = tfa.flash_attention_bhsd(
        torch.from_numpy(q3), torch.from_numpy(q3), torch.from_numpy(q3),
        causal=True, q_segment_ids=torch.from_numpy(seg),
        kv_segment_ids=torch.from_numpy(seg))
    ref3 = jfa.flash_attention_bhsd(
        jnp.asarray(q3), jnp.asarray(q3), jnp.asarray(q3), causal=True,
        q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
        block_q=16, block_k=16)
    np.testing.assert_allclose(ours3.numpy(), np.asarray(ref3), **O_TOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_is_the_reference_hash_bit_for_bit(p):
    """Over heads, q and k tiles and seeds (negative and past 2**31 as
    int32 wraps them), the keep mask equals ``_dropout_keep``'s."""
    thr = jfa._threshold(p)
    assert thr == tfa._threshold(p)
    bq = bk = 16
    for bh in (0, 1, 7, 63, 40000):
        for seed in (0, 1, -5, 2**31 - 1, -2**31, 123456789):
            for j, i in ((0, 0), (3, 1), (70, 129)):
                ref = np.asarray(jfa._dropout_keep(
                    np.asarray([seed], np.int32), jnp.int32(bh), j, i,
                    block_q=bq, block_k=bk, threshold=thr))
                qp = torch.arange(bq)[:, None] + j * bq
                kp = torch.arange(bk)[None, :] + i * bk
                ours = tfa.dropout_keep(bh, qp, kp, seed, thr).numpy()
                assert np.array_equal(ours, ref), (bh, seed, j, i)


def test_wrappers_count_only_kernel_launches_and_refuse_other_devices():
    rng = np.random.RandomState(12)
    q = torch.from_numpy(rng.randn(1, 2, 16, 16).astype(np.float32))
    before = (tfa.launches_fwd, tfa.launches_dq, tfa.launches_dkv)
    q.requires_grad_()
    tfa.flash_attention_bhsd(q, q, q, causal=True).sum().backward()
    assert (tfa.launches_fwd, tfa.launches_dq, tfa.launches_dkv) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bhsd(q.detach().to("meta"), q.to("meta"),
                                 q.to("meta"))


def test_refusals():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 4, 16)
    with pytest.raises(NotImplementedError, match="kv_len < q_len"):
        tfa.flash_attention_bhsd(q, k, k, causal=True)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention_bhsd(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="both q and kv"):
        tfa.flash_attention_bhsd(q, q, q,
                                 q_segment_ids=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention_bhsd(q, torch.zeros(1, 3, 8, 16),
                                 torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="bias tail"):
        tfa.flash_attention_bhsd(q, q, q, bias=torch.zeros(1, 1, 3, 8))


def test_kernel_parameters_carry_the_geometry():
    """The launch parameters the CUDA wrappers hand the kernels, built on
    the CPU: shapes, GQA heads, masks, and the dropout threshold, seed
    (as uint32) and scale."""
    q = torch.zeros(2, 8, 40, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 56, 64, dtype=torch.bfloat16)
    seg = torch.ones(2, 40, dtype=torch.int32)
    qf, kf, _, g, _ = tfa._geometry(
        q, k, k, True, None, torch.zeros(1, 8, 40, 56), seg,
        torch.ones(2, 56, dtype=torch.int32), 0.25, -3)
    p = tfa._params(qf, kf, g, q=12345, out1=678)
    assert (p.bhq, p.bhkv, p.sq, p.sk, p.hq, p.hkv, p.head_dim, p.dtype) \
        == (16, 4, 40, 56, 8, 2, 64, 1)
    assert (p.causal, p.has_bias, p.bias_bb, p.bias_hb, p.bias_rows,
            p.has_seg, p.has_dropout) == (1, 1, 1, 8, 40, 1, 1)
    assert p.threshold == 2**30 and p.seed == 2**32 - 3
    assert p.sm_scale == pytest.approx(0.125)
    assert p.drop_scale == pytest.approx(1 / 0.75)
    assert (p.q, p.out1, p.k) == (12345, 678, None)
    assert p.bias == g.bias.data_ptr() and p.kv_seg == g.kv_seg.data_ptr()


# ------------------------- K1 as a registered op ----------------------------
def _op_args(name, rng):
    """Arguments of ``paddle_tpu::flash_fwd`` for one geometry."""
    q = torch.from_numpy(rng.randn(4, 16, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 24, 32).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 24, 32).astype(np.float32))
    bias = seg_q = seg_k = None
    causal, drop, seed = name == "causal_gqa", 0.0, 0
    if name == "bias_dropout":
        bias = torch.from_numpy(rng.randn(1, 16, 24).astype(np.float32))
        drop, seed = 0.2, 2**32 - 5
    if name == "segments":
        seg_q = torch.from_numpy(_seg([1] * 8 + [2] * 8, 2))
        seg_k = torch.from_numpy(_seg([1] * 12 + [2] * 12, 2))
    return (q, k, v, bias, seg_q, seg_k, 2, 1, causal, 32 ** -0.5, 1, 1,
            drop, seed, -1)


@pytest.mark.parametrize("name", ["causal_gqa", "bias_dropout", "segments"])
def test_flash_fwd_is_a_registered_op(name):
    """``flash_attention_fwd`` goes through ``paddle_tpu::flash_fwd``:
    ``torch.library.opcheck`` passes on the CPU (schema, fake
    implementation against the body, registration), and the op gives
    the plain forward's ``(o, lse)`` with no launch counted."""
    args = _op_args(name, np.random.RandomState(3))
    torch.library.opcheck(torch.ops.paddle_tpu.flash_fwd.default, args)
    before = tfa.launches_fwd
    q, k, v, bias, sq, sk, hq, hkv, causal, scale, bb, hb, p, seed, _ = args
    g = tfa.FlashGeometry(hq=hq, hkv=hkv, causal=causal, sm_scale=scale,
                          bias=bias, bias_bh=(bb, hb), q_seg=sq, kv_seg=sk,
                          dropout_p=p, seed=seed)
    o, lse = tfa.flash_attention_fwd(q, k, v, g)
    want_o, want_lse = tfa._forward_plain(q, k, v, g)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert tfa.launches_fwd == before


# ------------------------------ trainable mask -------------------------------
def _sdpa_pair(q, kv, mask, mask_trainable, **kw):
    """The reference's and the port's ``scaled_dot_product_attention`` on
    the same inputs: outputs, and the gradients of ``sum(sin(out))`` in
    q, k, v and (if trainable) the mask."""
    import paddle_tpu as pt
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    jq, jk, jv = (pt.to_tensor(a, stop_gradient=False) for a in (q, kv, kv))
    jm = pt.to_tensor(mask, stop_gradient=not mask_trainable)
    jout = JF.scaled_dot_product_attention(jq, jk, jv, attn_mask=jm, **kw)
    pt.ops.sin(jout).sum().backward()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, kv, kv))
    tm = torch.from_numpy(mask).requires_grad_(mask_trainable)
    tout = TF.scaled_dot_product_attention(tq, tk, tv, attn_mask=tm, **kw)
    torch.sin(tout).sum().backward()
    jg = [np.asarray(t.grad.numpy()) for t in (jq, jk, jv)]
    tg = [t.grad.numpy() for t in (tq, tk, tv)]
    if mask_trainable:
        jg.append(np.asarray(jm.grad.numpy()))
        tg.append(tm.grad.numpy())
    return (tout.detach().numpy(), np.asarray(jout.numpy())), tg, jg


@pytest.mark.parametrize("kw", [{}, {"is_causal": True}],
                         ids=["full", "causal"])
def test_trainable_mask_gets_the_references_gradient(kw):
    """A float mask that requires grad takes the reference's composite
    (``tests/test_flash_attention.py:537``): output and the gradients of
    q, k, v and the mask equal the reference's at flash f32's tolerance,
    with GQA (4 query heads over 2 kv heads)."""
    rng = np.random.RandomState(21)
    q = rng.randn(2, 8, 4, 16).astype(np.float32)
    kv = rng.randn(2, 8, 2, 16).astype(np.float32)
    mask = (rng.randn(1, 4, 8, 8) * 0.5).astype(np.float32)
    (out, ref), tg, jg = _sdpa_pair(q, kv, mask, True, **kw)
    np.testing.assert_allclose(out, ref, **O_TOL)
    assert len(tg) == 4 and np.abs(tg[3]).max() > 0
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **O_TOL)


def test_trainable_mask_with_segments_and_a_constant_mask_alike():
    """Segment ids on the composite route (a row with no live key comes
    out zero, as in the reference); and a constant mask (the kernels'
    route) gives the trainable one's output."""
    rng = np.random.RandomState(22)
    q = rng.randn(2, 8, 2, 16).astype(np.float32)
    mask = rng.randn(1, 1, 8, 8).astype(np.float32)
    seg = _seg([1] * 5 + [2] * 3, 2)
    kw = dict(q_segment_ids=torch.from_numpy(seg),
              kv_segment_ids=torch.from_numpy(seg))
    import paddle_tpu as pt
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    jm = pt.to_tensor(mask, stop_gradient=False)
    ref = JF.scaled_dot_product_attention(
        pt.to_tensor(q), pt.to_tensor(q), pt.to_tensor(q), attn_mask=jm,
        q_segment_ids=pt.to_tensor(seg), kv_segment_ids=pt.to_tensor(seg))
    pt.ops.sin(ref).sum().backward()
    tm = torch.from_numpy(mask).requires_grad_()
    tq = torch.from_numpy(q)
    ours = TF.scaled_dot_product_attention(tq, tq, tq, attn_mask=tm, **kw)
    torch.sin(ours).sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(),
                               np.asarray(ref.numpy()), **O_TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jm.grad.numpy()),
                               **O_TOL)
    const = TF.scaled_dot_product_attention(tq, tq, tq,
                                            attn_mask=tm.detach(), **kw)
    np.testing.assert_allclose(const.numpy(), ours.detach().numpy(),
                               **O_TOL)


def test_a_bool_mask_cannot_be_made_trainable():
    """The reference raises ``ValueError`` at the attention call for a
    bool mask marked trainable; PyTorch keeps no gradient on a bool
    tensor, so the port raises the same error where the mask is marked."""
    import paddle_tpu_torch as ptt
    m = ptt.to_tensor(np.ones((1, 1, 4, 4), bool), place="cpu")
    with pytest.raises(ValueError, match="cannot receive a gradient"):
        m.stop_gradient = False
    with pytest.raises(ValueError, match="cannot receive a gradient"):
        ptt.to_tensor(np.ones((4, 4), bool), place="cpu",
                      stop_gradient=False)
