"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the card's routes of the vision slice (the LSTM and GRU on
PyTorch's fused recurrence, the batch norms' running statistics, CTC)
against the port's CPU results. Every test here is marked ``cuda`` and
skips where PyTorch sees no CUDA device: a CUDA kernel has no CPU mode. The file imports neither JAX
nor ``paddle_tpu``, so it also runs on a machine without them:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.pallas import flash_attention as fa
from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rpa_case(rng, seqs, block_size, n_kv, grp, hd, tile_q=8, mbps=8,
              pool_blocks=24):
    """One token-packed step: ``seqs`` is a list of (new_len,
    context_len); new_len 0 is a padding slot that owns no tokens."""
    max_seqs = len(seqs) + 1
    T = -(-max(sum(n for n, _ in seqs), 1) // tile_q) * tile_q
    bt = np.zeros((max_seqs + 1, mbps), np.int32)
    cu = np.zeros(max_seqs + 2, np.int32)
    ctx = np.zeros(max_seqs + 1, np.int32)
    valid = np.zeros(T, bool)
    nxt, off, kv_lens = 1, 0, []
    for s, (n, c) in enumerate(seqs):
        npg = -(-(n + c) // block_size)
        bt[s, :npg] = np.arange(nxt, nxt + npg)
        nxt += npg
        ctx[s] = c
        cu[s + 1] = off + n
        valid[off:off + n] = True
        kv_lens.append(n + c)
        off += n
    cu[len(seqs) + 1:] = off
    ssq, sbk = rpa.build_step_maps(
        cu[:len(seqs) + 1], kv_lens, total_tokens=T, tile_q=tile_q,
        block_size=block_size,
        max_steps=rpa.rpa_max_steps(tile_q, mbps, max_seqs),
        max_seqs=max_seqs)
    shape = (pool_blocks + 1, block_size, n_kv, hd)
    floats = [rng.randn(T, n_kv * grp, hd), rng.randn(*shape),
              rng.randn(*shape)]
    ints = [bt, cu, ctx, ssq, sbk]
    return floats, ints, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 1e-4),
    # both sides round an f32 result to bfloat16 once: one bf16 unit
    # (2**-7 of the value) apart at most
    (torch.bfloat16, 4e-3, 8e-3)])
@pytest.mark.parametrize("block_size,grp,hd", [(8, 1, 64), (16, 4, 128),
                                               (64, 8, 128)])
def test_rpa_kernel_matches_plain_version(cuda_device, dtype, atol, rtol,
                                          block_size, grp, hd):
    """Mixes of prefill chunks straddling q tiles, decode rows and a
    padding slot; head dims 64 and 128; GQA groups up to 8 (two rows per
    warp); and a block size whose pages need more than 48 KB of shared
    memory. Padding rows must come out exactly 0."""
    rng = np.random.RandomState(block_size + grp)
    seqs = [(5, 0), (1, 2 * block_size + 3), (0, 0), (1, 3),
            (9, block_size), (12, 5)]
    floats, ints, valid = _rpa_case(rng, seqs, block_size, n_kv=2, grp=grp,
                                    hd=hd)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in floats] + \
        [torch.from_numpy(a).to(cuda_device) for a in ints]
    before = rpa.ragged_paged_attention.launches
    out = rpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert rpa.ragged_paged_attention.launches == before + 1
    ref = rpa.ragged_paged_attention_reference(*args)
    valid = torch.from_numpy(valid).to(cuda_device)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               atol=atol, rtol=rtol)
    assert bool((out[~valid] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 4e-3, 8e-3)])
def test_rpa_serving_step_pads_a_small_head_dim(cuda_device, dtype, atol,
                                                rtol):
    """A test-size model's head_dim 16 (``LlamaConfig.tiny()``, which the
    reference's ``examples/serve_llama.py`` serves) reaches the kernel
    zero-padded to its hd-64 instance by the serving step, and gives the
    plain version's result at hd 16."""
    from paddle_tpu_torch.ops.paged_attention import \
        _pad_to_kernel_head_dim
    rng = np.random.RandomState(16)
    floats, ints, valid = _rpa_case(rng, [(5, 0), (1, 11), (0, 0), (3, 4)],
                                    8, n_kv=2, grp=2, hd=16)
    q, kp, vp = [torch.from_numpy(a).to(cuda_device, dtype) for a in floats]
    meta = [torch.from_numpy(a).to(cuda_device) for a in ints]
    padded = rpa.ragged_paged_attention.launches_padded
    qp, kpp, vpp = _pad_to_kernel_head_dim(q, kp, vp)
    assert qp.shape[-1] == kpp.shape[-1] == 64
    assert rpa.ragged_paged_attention.launches_padded == padded + 1
    out = rpa.ragged_paged_attention(qp, kpp, vpp, *meta,
                                     sm_scale=0.25)[..., :16]
    ref = rpa.ragged_paged_attention_reference(q, kp, vp, *meta,
                                               sm_scale=0.25)
    valid = torch.from_numpy(valid).to(cuda_device)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_rpa_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.RandomState(0)
    floats, ints, _ = _rpa_case(rng, [(3, 2)], 8, n_kv=1, grp=1, hd=64)
    q, kp, vp = [torch.from_numpy(a).to(cuda_device, torch.float32)
                 for a in floats]
    meta = [torch.from_numpy(a).to(cuda_device) for a in ints]
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        rpa.ragged_paged_attention(q.double(), kp.double(), vp.double(),
                                   *meta)
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention(q, kp, vp, meta[0].long(), *meta[1:])
    with pytest.raises(ValueError, match="head_dim"):
        rpa.ragged_paged_attention(q[..., :32], kp[..., :32],
                                   vp[..., :32], *meta)


def _rpa_bf16_args(rng, seqs, block_size, grp, hd, tile_q, device,
                   n_kv=2, shared=0, dtype=torch.bfloat16):
    """bf16 (or ``dtype``) card arguments of one step; the first
    ``shared`` pages of sequences 0 and 1 are the same physical pages (a
    shared prefix)."""
    mbps = max(-(-(n + c) // block_size) for n, c in seqs) + 1
    pages = sum(-(-(n + c) // block_size) for n, c in seqs)
    floats, ints, valid = _rpa_case(rng, seqs, block_size, n_kv=n_kv,
                                    grp=grp, hd=hd, tile_q=tile_q,
                                    mbps=mbps, pool_blocks=pages + 1)
    if shared:
        ints[0][1, :shared] = ints[0][0, :shared]
    args = [torch.from_numpy(a).to(device, dtype) for a in floats] \
        + [torch.from_numpy(a).to(device) for a in ints]
    return args, torch.from_numpy(valid).to(device)


# (block_size, group, hd, tile_q) of the bf16 split kernel: rows = tile_q x
# group up to its 128
RPA_BF16_GEOMETRY = [(bs, grp, hd, tq) for bs in (8, 16, 64)
                     for grp in (1, 4, 8) for hd in (64, 128)
                     for tq in (8, 16, 32) if tq * grp <= 128]


@pytest.mark.cuda
@pytest.mark.parametrize("block_size,grp,hd,tile_q", RPA_BF16_GEOMETRY)
def test_rpa_bf16_split_kernel(cuda_device, block_size, grp, hd, tile_q):
    """The bf16 design (work list on the device, chunks of a tile merged
    by the combine pass, pages by TMA, wgmma) against the plain version:
    a ~3000-token decode context spanning many chunks, a prefill chunk
    straddling q tiles over cached tokens, decode rows, two sequences
    sharing their first pages, a padding slot and a padding tail, whose
    rows must be exactly 0. The device work list equals its plain
    version; one launch a call."""
    rng = np.random.RandomState(block_size * 100 + grp * 10 + tile_q)
    seqs = [(1, 2990), (1, 2 * block_size + 3), (0, 0), (37, 300),
            (1, 5), (9, block_size), (1, 1)]
    args, valid = _rpa_bf16_args(rng, seqs, block_size, grp, hd, tile_q,
                                 cuda_device, shared=2)
    before = rpa.ragged_paged_attention.launches
    out = rpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert rpa.ragged_paged_attention.launches == before + 1
    ref = rpa.ragged_paged_attention_reference(*args)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               atol=4e-3, rtol=8e-3)
    assert bool((out[~valid] == 0).all())
    _, info, items = rpa._rpa_wgmma(*args, 1.0 / hd ** 0.5)
    ssq = args[6]
    min_pages = rpa._min_pages(block_size)
    want_info, want_items = rpa._rpa_items_plain(
        ssq.cpu(), args[3].shape[0] - 1, min_pages,
        rpa._max_chunks(ssq.shape[1], min_pages))
    assert torch.equal(info.cpu(), want_info)
    n = int(want_info[-1])
    assert n > ssq.shape[0] // 2  # the long context is split
    assert torch.equal(items[:n].cpu(), want_items[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 4e-3, 8e-3)])
@pytest.mark.parametrize("rank", [0, 1])
def test_rpa_at_a_tensor_parallel_rank_heads(cuda_device, dtype, atol, rtol,
                                             rank):
    """Tensor-parallel serving at mp 2 runs K4 on each rank's heads:
    Llama-3-8B's 32 query / 8 KV heads (hd 128) split to 16 / 4, whole
    GQA groups of 4. The kernel on rank ``rank``'s heads of a full step
    gives the plain version's result on those heads of the whole, and
    launches once."""
    rng = np.random.RandomState(40 + rank)
    seqs = [(1, 700), (1, 37), (0, 0), (120, 260), (1, 16), (1, 1)]
    args, valid = _rpa_bf16_args(rng, seqs, 16, 4, 128, 8, cuda_device,
                                 n_kv=8, shared=2, dtype=dtype)
    q, kp, vp = args[:3]
    mine = [q[:, 16 * rank:16 * rank + 16].contiguous(),
            kp[:, :, 4 * rank:4 * rank + 4].contiguous(),
            vp[:, :, 4 * rank:4 * rank + 4].contiguous()]
    before = rpa.ragged_paged_attention.launches
    out = rpa.ragged_paged_attention(*mine, *args[3:])
    torch.cuda.synchronize()
    assert rpa.ragged_paged_attention.launches == before + 1
    ref = rpa.ragged_paged_attention_reference(*args).reshape(
        q.shape)[:, 16 * rank:16 * rank + 16]
    assert out.shape == ref.shape
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               atol=atol, rtol=rtol)
    assert bool((out[~valid] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tile_q", [8, 16, 32])
def test_rpa_bf16_decode_step_with_padding_tiles(cuda_device, tile_q):
    """An engine's decode-only step: every decode row in the first tile,
    every later tile padding (no live step), contexts long enough to cut
    the first tile into its most chunks; decode rows whose sequence owns
    no page of a chunk see no key there and keep their state."""
    rng = np.random.RandomState(tile_q)
    seqs = [(1, int(c)) for c in rng.randint(1500, 3000, 8)]
    args, valid = _rpa_bf16_args(rng, seqs, 16, 4, 128, tile_q, cuda_device)
    T = args[0].shape[0]
    pad = torch.zeros(4 * tile_q, *args[0].shape[1:], device=cuda_device,
                      dtype=torch.bfloat16)
    q = torch.cat([args[0], pad])  # four more tiles of padding
    ssq, sbk = (torch.cat([a, torch.full((4, a.shape[1]), v,
                                         dtype=a.dtype, device=a.device)])
                for a, v in ((args[6], args[3].shape[0] - 1), (args[7], 0)))
    full = [q] + args[1:6] + [ssq, sbk]
    out = rpa.ragged_paged_attention(*full)
    torch.cuda.synchronize()
    ref = rpa.ragged_paged_attention_reference(*full)
    torch.testing.assert_close(out[:T][valid].float(),
                               ref[:T][valid].float(), atol=4e-3, rtol=8e-3)
    assert bool((out[:T][~valid] == 0).all()) and bool((out[T:] == 0).all())


# K4 in float16 against its plain version: float16 keeps three more
# mantissa bits than bfloat16 and the kernel rounds at the same places (P
# to v's dtype before the value product, the output once), so its limit
# sits between its own largest errors on the card (1.2e-4 and 2.4e-4 on
# chip_smoke.py phase 3's two mixes) and bfloat16's (9.8e-4 and 2.0e-3):
# an f16 instance that packed P or its output at bfloat16's precision
# fails it, which the serving-shape test shows with the bf16 kernel
RPA_F16_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("decode_only", [False, True])
def test_rpa_f16_matches_plain_at_the_serving_shapes(cuda_device, hd,
                                                      decode_only):
    """The f16 instance at chip_smoke.py phase 3's geometry (32 query
    and 8 kv heads, block 16, q tile 8, pages scattered over a
    2048-block pool) and at the engine's head_dims 64 and 128: six
    decode rows over 100-3000 cached tokens with a 512-token prefill
    chunk over 1024 (phase 3's mix), or eight decode rows over phase
    4's prompts (the decode-only mix). One launch, counted in
    ``launches`` and ``launches_f16``; padding rows exactly 0."""
    rng = np.random.RandomState(hd + decode_only)
    if decode_only:
        seqs = [(1, n + 16) for n in (128, 384, 640, 896, 1280, 1664,
                                      2048, 1536)]
    else:
        seqs = [(1, int(c)) for c in rng.randint(100, 3001, 6)] + \
            [(512, 1024)]
    floats, ints, valid = _rpa_case(rng, seqs, 16, n_kv=8, grp=4, hd=hd,
                                    tile_q=8, mbps=512, pool_blocks=2048)
    perm = rng.permutation(np.arange(1, 2049)).astype(np.int32)
    ints[0] = np.where(ints[0] > 0, perm[ints[0] - 1], 0).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device, torch.float16)
            for a in floats] + [torch.from_numpy(a).to(cuda_device)
                                for a in ints]
    before = (rpa.ragged_paged_attention.launches,
              rpa.ragged_paged_attention.launches_f16)
    out = rpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.float16
    assert (rpa.ragged_paged_attention.launches,
            rpa.ragged_paged_attention.launches_f16) == \
        (before[0] + 1, before[1] + 1)
    ref = rpa.ragged_paged_attention_reference(*args)
    valid = torch.from_numpy(valid).to(cuda_device)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               **RPA_F16_TOL)
    assert bool((out[~valid] == 0).all())
    # the bf16 instance on the same values misses the f16 limit
    bf = rpa.ragged_paged_attention(*[a.bfloat16() for a in args[:3]],
                                    *args[3:])
    assert not torch.allclose(bf[valid].float(), ref[valid].float(),
                              **RPA_F16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size,grp,hd,tile_q", [
    (8, 1, 64, 8), (16, 4, 128, 8), (16, 8, 64, 16), (64, 4, 128, 32)])
def test_rpa_f16_split_kernel(cuda_device, block_size, grp, hd, tile_q):
    """The f16 instance on the bf16 split kernel's mix (a long decode
    context over many chunks, a prefill chunk straddling tiles, shared
    pages, padding), one and two warpgroups, and its work list equal to
    the plain version's."""
    rng = np.random.RandomState(block_size * 100 + grp * 10 + tile_q)
    seqs = [(1, 2990), (1, 2 * block_size + 3), (0, 0), (37, 300),
            (1, 5), (9, block_size), (1, 1)]
    args, valid = _rpa_bf16_args(rng, seqs, block_size, grp, hd, tile_q,
                                 cuda_device, shared=2, dtype=torch.float16)
    out = rpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ref = rpa.ragged_paged_attention_reference(*args)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               **RPA_F16_TOL)
    assert bool((out[~valid] == 0).all())
    plain = rpa._rpa_split_plain(*args)
    torch.testing.assert_close(out[valid].float(), plain[valid].float(),
                               **RPA_F16_TOL)


@pytest.mark.cuda
def test_rpa_bf16_refuses_what_the_kernel_does_not_take(cuda_device):
    """The bf16 kernel loads q and the pools by TMA: a q one element into
    its storage is refused, as is a block size that does not tile its
    64-key stages."""
    rng = np.random.RandomState(1)
    args, _ = _rpa_bf16_args(rng, [(5, 20), (1, 9)], 16, 4, 128, 8,
                             cuda_device)
    q = args[0]
    buf = torch.zeros(q.numel() + 8, device=cuda_device, dtype=q.dtype)
    q_off = buf[1:1 + q.numel()].view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        rpa.ragged_paged_attention(q_off, *args[1:])
    args4, _ = _rpa_bf16_args(rng, [(5, 20), (1, 9)], 4, 4, 128, 8,
                              cuda_device)
    with pytest.raises(ValueError, match="block_size"):
        rpa.ragged_paged_attention(*args4)


# ------------------------------ flash attention -----------------------------
def _flash_case(name, rng, dtype, hd, device):
    """q/k/v ``[B*H, S, D]`` and the geometry of one sweep case, the
    shapes of ``chip_smoke.py``'s phase 6(b) cut small."""
    B, hq, hkv, sq, sk = 2, 8, 2, 200, 200
    kw = dict(causal=True)
    if name == "offset_causal":
        sk = 264
    elif name.startswith("gqa_"):
        hkv = hq // int(name.split("_")[1])
    elif name == "segments_dead_rows":
        qs = np.repeat([[1] * 120 + [7] * 80], B, 0)
        ks = np.repeat([[1] * 70 + [2] * 130], B, 0)
        kw.update(q_segment_ids=qs, kv_segment_ids=ks)
    elif name == "row_bias":
        kw = dict(causal=False, bias=rng.randn(B, 1, 1, sk))
    elif name == "full_bias":
        kw["bias"] = rng.randn(1, hq, sq, sk)
    elif name == "dropout":
        kw.update(dropout_p=0.1, dropout_seed=77)
    elif name == "ragged":
        sq = sk = 131  # not a multiple of the kernels' 64-row tiles
    shape = lambda h, s: (B, h, s, hd)  # noqa: E731
    qkv = [torch.from_numpy(rng.randn(*shape(h, s))).to(device, dtype)
           for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    kw = {k: torch.from_numpy(np.asarray(v)).to(device) if
          isinstance(v, np.ndarray) else v for k, v in kw.items()}
    q, k, v, g, _ = fa._geometry(*qkv, kw.pop("causal"), None,
                                 kw.pop("bias", None),
                                 kw.pop("q_segment_ids", None),
                                 kw.pop("kv_segment_ids", None),
                                 kw.pop("dropout_p", 0.0),
                                 kw.pop("dropout_seed", None))
    return q, k, v, g


def _rel_err(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-6))


FLASH_CASES = ["causal", "offset_causal", "gqa_1", "gqa_4", "gqa_8",
               "segments_dead_rows", "row_bias", "full_bias", "dropout",
               "ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 2e-4),
    # the kernels round p (and ds) to bf16 against a running max, the
    # plain version against the row's final max: a few bf16 units apart
    (torch.bfloat16, 2e-2),
    # the same rounding in f16, which keeps three more mantissa bits. On
    # an H100 over these cases f16 read at most 8.3e-4 and bf16 1.0e-3 to
    # 3.9e-3 (16 of the 20 above 1.5e-3): an f16 instance that rounded at
    # bf16's precision fails most cases
    (torch.float16, 1.5e-3)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("name", FLASH_CASES)
def test_flash_kernels_match_plain_versions(cuda_device, dtype, tol, hd,
                                            name):
    """K1 against the plain forward; K2 and K3 against the plain
    backward on the same lse and delta; each wrapper counts one launch.
    Errors are relative to the largest magnitude of the plain result."""
    rng = np.random.RandomState(FLASH_CASES.index(name) + hd)
    q, k, v, g = _flash_case(name, rng, dtype, hd, cuda_device)
    do = torch.randn_like(q)
    counts = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    o, lse = fa.flash_attention_fwd(q, k, v, g)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, g)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, g)
    torch.cuda.synchronize()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == \
        tuple(c + 1 for c in counts)
    ro, rlse = fa._forward_plain(q, k, v, g)
    rdq = fa._dq_plain(q, k, v, do, lse, delta, g)
    rdk, rdv = fa._dkv_plain(q, k, v, do, lse, delta, g)
    for got, want in ((o, ro), (lse, rlse), (dq, rdq), (dk, rdk),
                      (dv, rdv)):
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= tol
    if name == "segments_dead_rows":  # exact zeros, not small numbers
        dead = (g.q_seg[0] == 7)
        assert bool((o[:, dead] == 0).all()) and bool((dq[:, dead] == 0).all())
        assert bool((lse[:, dead] == 0).all())


@pytest.mark.cuda
def test_flash_autograd_matches_reference_autograd(cuda_device):
    """End to end through ``torch.autograd``: the kernels' gradients
    against autograd through ``flash_attention_reference`` (f32)."""
    rng = np.random.RandomState(5)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(  # noqa: E731
        np.float32)).to(cuda_device).requires_grad_()
    q, k, v = mk(2, 8, 150, 128), mk(2, 2, 150, 128), mk(2, 2, 150, 128)
    do = torch.randn(2, 8, 150, 128, device=cuda_device)
    o = fa.flash_attention_bhsd(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), do)
    ro, _ = fa.flash_attention_reference(q, k, v, causal=True)
    rgrads = torch.autograd.grad(ro, (q, k, v), do)
    torch.testing.assert_close(o, ro, rtol=2e-4, atol=2e-5)
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernels_do_not_take(cuda_device):
    """A head_dim above the widest instance (128) raises; one below it
    is zero-padded by the autograd wrapper, but the kernels' own entry
    points take only their instances' head_dims."""
    q = torch.zeros(1, 2, 64, 200, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bhsd(q, q, q)
    q3, k3, v3, g = fa._geometry(*[torch.zeros(
        1, 2, 64, 72, device=cuda_device)] * 3, False, None, None, None,
        None, 0.0, None)[:4]
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q3, k3, v3, g)
    q = torch.zeros(1, 2, 64, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa.flash_attention_bhsd(q.double(), q.double(), q.double())


def _padded_case(name, rng, dtype, device):
    """``chip_smoke.py``'s phase 6(b) cases for the ERNIE and DiT paths:
    DiT-XL/2's head_dim 72 (non-causal, S 256, 16 heads) and ERNIE-base's
    attention (non-causal, head_dim 64, S 512, 12 heads, dropout 0.1)."""
    if name == "head_dim_72":
        B, h, s, hd, drop, seed = 2, 16, 256, 72, 0.0, None
    else:
        B, h, s, hd, drop, seed = 2, 12, 512, 64, 0.1, 2024
    qkv = [torch.from_numpy(rng.randn(B, h, s, hd)).to(device, dtype)
           for _ in range(3)]
    return fa._geometry(*qkv, False, None, None, None, None, drop, seed)[:4]


def _check_padded_launch(q, k, v, g, tol, width):
    """K1-K3 through ``padded_launch`` (inputs padded to ``width`` as
    ``flash_attention_bhsd`` pads them, outputs sliced back) against the
    plain versions at the caller's head_dim; the padded columns must be
    exactly 0 and padded launches are counted apart."""
    d = q.shape[-1]
    do = torch.randn_like(q)
    padded = fa.launches_padded
    (o, lse, delta, dq, dk, dv), tail = fa.padded_launch(q, k, v, do, g)
    torch.cuda.synchronize()
    assert tail == 0.0
    assert g.padded_from == (d if width != d else None)
    assert fa.launches_padded - padded == (3 if width != d else 0)
    ro, rlse = fa._forward_plain(q, k, v, g)
    rdq = fa._dq_plain(q, k, v, do, lse, delta, g)
    rdk, rdv = fa._dkv_plain(q, k, v, do, lse, delta, g)
    for got, want in ((o, ro), (lse, rlse), (dq, rdq), (dk, rdk),
                      (dv, rdv)):
        assert got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", ["head_dim_72", "ernie_shape"])
def test_flash_kernels_at_the_ernie_and_dit_shapes(cuda_device, dtype, tol,
                                                   name):
    """K1-K3 at DiT-XL/2's head_dim 72 (-> the 128 instances at the
    scale of 72) and at ERNIE-base's attention, against the plain
    versions (the tolerances of
    ``test_flash_kernels_match_plain_versions``)."""
    rng = np.random.RandomState(31)
    q, k, v, g = _padded_case(name, rng, dtype, cuda_device)
    _check_padded_launch(q, k, v, g, tol,
                         128 if name == "head_dim_72" else 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd,width", [(32, 64), (80, 128)])
@pytest.mark.parametrize("name", ["causal", "gqa_4", "dropout", "ragged"])
def test_flash_kernels_at_padded_head_dims(cuda_device, dtype, tol, hd,
                                           width, name):
    """A head_dim below 64 runs on the hd-64 instances and one between
    64 and 128 on the hd-128 instances, zero-padded: K1-K3 against the
    plain versions on ``test_flash_kernels_match_plain_versions``'s
    cases at the same tolerances."""
    rng = np.random.RandomState(FLASH_CASES.index(name) + hd)
    q, k, v, g = _flash_case(name, rng, dtype, hd, cuda_device)
    _check_padded_launch(q, k, v, g, tol, width)


@pytest.mark.cuda
def test_flash_autograd_at_head_dim_72(cuda_device):
    """``flash_attention_bshd`` at DiT-XL/2's head_dim, f32, through
    autograd: o and the gradients of q, k, v against autograd through
    the plain reference, and one padded launch per kernel."""
    rng = np.random.RandomState(32)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(  # noqa: E731
        np.float32)).to(cuda_device).requires_grad_()
    q, k, v = mk(2, 256, 16, 72), mk(2, 256, 16, 72), mk(2, 256, 16, 72)
    do = torch.randn(2, 256, 16, 72, device=cuda_device)
    padded = fa.launches_padded
    o = fa.flash_attention_bshd(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.launches_padded - padded == 3
    ro, _ = fa.flash_attention_reference(
        *[t.transpose(1, 2) for t in (q, k, v)])
    rgrads = torch.autograd.grad(ro.transpose(1, 2), (q, k, v), do)
    torch.testing.assert_close(o, ro.transpose(1, 2), rtol=2e-4, atol=2e-5)
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,sk", [(333, 333), (64, 1000)])
def test_flash_fwd_bf16_ragged_and_offset_causal(cuda_device, hd, sq, sk):
    """The bf16 forward (tensor cores, tiles by TMA) where its tiles meet
    the edges: 333 rows per head, so a q tile and a key tile run past the
    end of one head's rows (the 3-D tensor maps read zeros there, never
    the next head's rows), and 64 q rows over 1000 keys (offset causal:
    a q tile smaller than the kernel's 128 rows, keys past the last tile
    of 64)."""
    rng = np.random.RandomState(sq + hd)
    B, hq, hkv = 2, 8, 2
    qkv = [torch.from_numpy(rng.randn(B, h, s, hd)).to(cuda_device,
                                                      torch.bfloat16)
           for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    q, k, v, g, _ = fa._geometry(*qkv, True, None, None, None, None, 0.0,
                                 None)
    before = fa.launches_fwd
    o, lse = fa.flash_attention_fwd(q, k, v, g)
    torch.cuda.synchronize()
    assert fa.launches_fwd == before + 1
    ro, rlse = fa._forward_plain(q, k, v, g)
    for got, want in ((o, ro), (lse, rlse)):
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [513, 600, 1000, 2047])
def test_flash_fwd_bf16_at_the_decode_shapes(cuda_device, sk):
    """K1 as ``generate``'s decode step runs it: one query row per head
    over ``sk`` cached keys (offset causal: the row sees every key), GQA
    16/4, head_dim 128, bf16; 63 of the kernel's 64 tile rows are dead
    and the diagonal lands in the last key tile. Against the plain
    version at ``chip_smoke.py``'s ``FLASH_TOL`` (atol = rtol = 1e-2 for
    o and lse), and through ``nn.functional.scaled_dot_product_attention``
    as the eager cache calls it."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(sk)
    B, hq, hkv, hd = 4, 16, 4, 128
    qkv = [torch.from_numpy(rng.randn(B, h, s, hd)).to(cuda_device,
                                                      torch.bfloat16)
           for h, s in ((hq, 1), (hkv, sk), (hkv, sk))]
    q, k, v, g, _ = fa._geometry(*qkv, True, None, None, None, None, 0.0,
                                 None)
    before = fa.launches_fwd
    o, lse = fa.flash_attention_fwd(q, k, v, g)
    torch.cuda.synchronize()
    assert fa.launches_fwd == before + 1
    ro, rlse = fa._forward_plain(q, k, v, g)
    for got, want in ((o, ro), (lse, rlse)):
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                   rtol=1e-2)
    with torch.no_grad():
        out = F.scaled_dot_product_attention(
            *[t.transpose(1, 2) for t in qkv], is_causal=True)
    assert fa.launches_fwd == before + 2
    torch.testing.assert_close(out.transpose(1, 2).reshape(o.shape).float(),
                               ro.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_fwd_row_with_every_score_masked(cuda_device, dtype, hd):
    """Causal attention with a -inf bias on one q row: every visible score
    of that row is clamped to the mask value, so the forward averages v
    over the keys of the tiles it visits, keys 0 .. min(Sk, 64 * (last
    live key tile + 1)) - 1 of the row's 64-row tile, the set the backward
    kernels assume. Every other row matches the plain version."""
    rng = np.random.RandomState(hd)
    B, hq, hkv, sq, sk, row = 1, 4, 2, 200, 264, 100
    qkv = [torch.from_numpy(rng.randn(B, h, s, hd)).to(cuda_device, dtype)
           for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    bias = torch.zeros(1, 1, sq, sk, device=cuda_device)
    bias[0, 0, row] = float("-inf")
    q, k, v, g, _ = fa._geometry(*qkv, True, None, bias, None, None, 0.0,
                                 None)
    o, lse = fa.flash_attention_fwd(q, k, v, g)
    torch.cuda.synchronize()
    ro, _ = fa._forward_plain(q, k, v, g)
    keep = torch.arange(sq, device=cuda_device) != row
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert bool(torch.isfinite(o).all())
    assert _rel_err(o[:, keep], ro[:, keep]) <= tol
    q0 = row // 64 * 64
    n_keys = min(sk, 64 * ((q0 + 63 + sk - sq) // 64 + 1))
    group = hq // hkv
    mean = v.float()[:, :n_keys].mean(dim=1)  # [B*Hkv, D]
    want = mean.repeat_interleave(group, dim=0)
    torch.testing.assert_close(o[:, row].float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_fwd_bf16_refuses_a_misaligned_base(cuda_device):
    """TMA reads from 16-byte aligned addresses only: a q that starts one
    element into its storage is refused, not copied or sent elsewhere."""
    shape = (2, 64, 64)
    buf = torch.zeros(2 * 64 * 64 + 8, device=cuda_device,
                      dtype=torch.bfloat16)
    q = buf[1:1 + 2 * 64 * 64].view(shape)
    k = torch.zeros(shape, device=cuda_device, dtype=torch.bfloat16)
    g = fa.FlashGeometry(hq=1, hkv=1, causal=False, sm_scale=0.125)
    before = fa.launches_fwd
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd(q, k, k, g)
    assert fa.launches_fwd == before


BWD_CASES = ["masked_row", "segments_dead_rows", "offset_causal_64x1000",
             "ragged_333", "gqa_8"]


def _bwd_case(name, rng, hd, device):
    """bf16 q/k/v ``[B*H, S, D]`` and the geometry of one case of the
    backward's visited-key test (all causal)."""
    B, hq, hkv, sq, sk = 2, 8, 2, 200, 200
    bias = qs = ks = None
    if name == "masked_row":  # test_flash_fwd_row_with_every_score_masked
        B, hq, hkv, sq, sk = 1, 4, 2, 200, 264
        bias = torch.zeros(1, 1, sq, sk, device=device)
        bias[0, 0, 100] = float("-inf")
    elif name == "segments_dead_rows":
        qs = torch.tensor([[1] * 120 + [7] * 80] * B, device=device)
        ks = torch.tensor([[1] * 70 + [2] * 130] * B, device=device)
    elif name == "offset_causal_64x1000":
        sq, sk = 64, 1000
    elif name == "ragged_333":
        sq = sk = 333
    elif name == "gqa_8":
        hkv = hq // 8
    qkv = [torch.from_numpy(rng.randn(B, h, s, hd)).to(device, torch.bfloat16)
           for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    q, k, v, g, _ = fa._geometry(*qkv, True, None, bias, qs, ks, 0.0, None)
    return q, k, v, g


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("name", BWD_CASES)
def test_flash_bwd_bf16_matches_the_f32_fma_kernels(cuda_device, hd, name):
    """The bf16 dq and dk/dv kernels (tensor cores) against the f32 FMA
    kernels on the same values cast to f32, with the same lse and delta.
    The plain versions cannot pin which keys the kernels visit: a row whose
    every visible score is masked (``masked_row``, lse = the mask value)
    gets p = 1 on every in-range key of the (64-row, 64-key) tile pairs
    the FMA kernels visit and p = 0 elsewhere, and the bf16 kernels must
    visit exactly those pairs. Rows with no live key keep exactly 0 dq.
    Errors are relative to the largest magnitude of the f32 result; both
    sides round to bf16 at other places (ds, p_drop, the outputs)."""
    rng = np.random.RandomState(BWD_CASES.index(name) + 10 * hd)
    q, k, v, g = _bwd_case(name, rng, hd, cuda_device)
    do = torch.from_numpy(rng.randn(*q.shape)).to(cuda_device, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, g)
    delta = (do.float() * o.float()).sum(-1)
    counts = (fa.launches_dq, fa.launches_dkv)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, g)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, g)
    f32 = [t.float() for t in (q, k, v, do)]
    rdq = fa.flash_attention_dq(*f32, lse, delta, g)
    rdk, rdv = fa.flash_attention_dkv(*f32, lse, delta, g)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (counts[0] + 2,
                                                 counts[1] + 2)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= 2e-2
    if name == "masked_row":  # the row alone, and every other row alone
        keep = torch.arange(q.shape[1], device=cuda_device) != 100
        assert bool((lse[:, 100] < -1e38).all())
        assert _rel_err(dq[:, 100], rdq[:, 100]) <= 2e-2
        assert _rel_err(dq[:, keep], rdq[:, keep]) <= 2e-2
    if name == "segments_dead_rows":  # exact zeros, not small numbers
        dead = g.q_seg[0] == 7
        assert bool((dq[:, dead] == 0).all())


@pytest.mark.cuda
def test_flash_bwd_bf16_refuses_a_misaligned_base(cuda_device):
    """The bf16 dq and dk/dv kernels load q, k, v and do by TMA: a do that
    starts one element into its storage is refused, not copied or sent
    elsewhere, and no launch is counted."""
    shape = (2, 64, 64)
    buf = torch.zeros(2 * 64 * 64 + 8, device=cuda_device,
                      dtype=torch.bfloat16)
    do = buf[1:1 + 2 * 64 * 64].view(shape)
    q = torch.zeros(shape, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(2, 64, device=cuda_device)
    g = fa.FlashGeometry(hq=1, hkv=1, causal=False, sm_scale=0.125)
    before = (fa.launches_dq, fa.launches_dkv)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_dq(q, q, q, do, lse, lse, g)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_dkv(q, q, q, do, lse, lse, g)
    assert (fa.launches_dq, fa.launches_dkv) == before


def _within(got, want, atol, rtol):
    """Finite, and within atol + rtol * |want| everywhere."""
    got, want = got.detach().float(), want.detach().float()
    return bool(torch.isfinite(got).all()) and not bool(
        ((got - want).abs() > atol + rtol * want.abs()).any())


@pytest.mark.cuda
def test_flash_bf16_on_a_packed_batch_at_the_training_shape(cuda_device):
    """K1, K2 and K3 in bf16 at the training shape (B=4, S=2048, Hq=16,
    Hkv=4, hd=128) on the segment ids of a packed batch, as ``Model.fit``
    over ``DataPipeline(pack=True)`` hands them over: many documents a
    row and a padding tail of segment 0. Held against autograd through
    ``flash_attention_reference`` at ``chip_smoke.py``'s bf16 limits
    (``FLASH_TOL``: atol = rtol = 1e-2 for o and lse, 2e-2 for the
    gradients)."""
    from paddle_tpu_torch.data import SequencePacker
    rng = np.random.RandomState(0)
    B, hq, hkv, S, hd = 4, 16, 4, 2048, 128
    packer, batches = SequencePacker(S, B), []
    while not batches:
        batches = packer.add(rng.randint(1, 1000, rng.randint(32, 700)))
    seg = torch.from_numpy(batches[0]["attention_mask"]).to(cuda_device)
    assert int(seg.max(1).values.min()) >= 3  # several documents a row
    assert bool((seg[:, -1] == 0).any())      # and a padding tail
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mk = lambda h: torch.randn(B, h, S, hd, device=cuda_device,  # noqa
                               dtype=torch.bfloat16, generator=gen)
    q4, k4, v4, do4 = mk(hq), mk(hkv), mk(hkv), mk(hq)
    q, k, v, g, _ = fa._geometry(q4, k4, v4, True, None, None, seg, seg,
                                 0.0, None)
    do = do4.reshape(q.shape)
    counts = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    o, lse = fa.flash_attention_fwd(q, k, v, g)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, g)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, g)
    torch.cuda.synchronize()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == \
        tuple(c + 1 for c in counts)
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    ro, rlse = fa.flash_attention_reference(*leaves, causal=True,
                                            q_segment_ids=seg,
                                            kv_segment_ids=seg)
    rdq, rdk, rdv = torch.autograd.grad(ro, leaves, do4)
    assert _within(o, ro.reshape(o.shape), 1e-2, 1e-2)
    assert _within(lse, rlse.reshape(lse.shape), 1e-2, 1e-2)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert _within(got, want.reshape(got.shape), 2e-2, 2e-2)


# ------------------------------ grouped matmul ------------------------------
# kernel vs plain: max |err| over the largest |plain| value, by the dtype of
# the result: f32 sums in another order; bf16 results are rounded once on
# each side, so they may sit one bf16 unit (2**-7 of the value) apart
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _gmm_case(name, device):
    """``chip_smoke.py`` phase 8(b)'s cases, cut small: (lhs [R, M], sizes,
    rhs [E, M, H], g [R, H]), all f32; rows past the groups are 0 unless
    the case is ``tail_rows_not_zero``."""
    E, M, H, R = 8, 256, 192, 1024
    sizes = [100, 0, 300, 1, 1, 0, 400, 150]
    if name == "hot_expert":
        sizes = [0, 1, 922, 0, 1, 50, 50, 0]  # 90% of the rows in one
    elif name == "widths_1000_333":
        M, H = 1000, 333
    elif name == "one_expert":
        E, sizes = 1, [1000]
    gen = torch.Generator(device=device).manual_seed(len(name))
    mk = lambda *s: torch.randn(*s, device=device, generator=gen)  # noqa
    lhs, rhs, g = mk(R, M), mk(E, M, H), mk(R, H)
    if name == "tail_rows_not_zero":
        sizes = [100, 0, 300, 1, 1, 0, 200, 150]
    else:
        lhs[sum(sizes):] = 0
    return lhs, torch.tensor(sizes, dtype=torch.int32, device=device), rhs, g


def _aligned(rows, sizes, bm):
    """Each group's rows padded with zero rows to a multiple of bm."""
    out, padded, o = [], [], 0
    for n in sizes.tolist():
        p = -(-n // bm) * bm
        block = rows.new_zeros(p, rows.shape[1])
        block[:n] = rows[o:o + n]
        out.append(block)
        padded.append(p)
        o += n
    return torch.cat(out), torch.tensor(padded, dtype=torch.int32,
                                        device=rows.device)


def _gmm_rel_err(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-6))


GMM_CASES = ["mixed", "hot_expert", "tail_rows_not_zero", "widths_1000_333",
             "one_expert"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", GMM_CASES)
def test_gmm_kernels_match_plain_versions(cuda_device, dtype, name):
    """K5-K8 against their plain versions, with gmm's backward form (f32 g
    against the strided rhsᵀ view); each wrapper counts one launch a call.
    Rows past the groups (K5) and empty experts (K6) are exactly 0."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    lhs32, sizes, rhs32, g32 = _gmm_case(name, cuda_device)
    E, R, n, bm = rhs32.shape[0], lhs32.shape[0], int(sizes.sum()), 32
    offs = gm._offsets_ext(sizes, R)
    al32, al_sizes = _aligned(lhs32, sizes, bm)
    g_al32 = torch.randn(al32.shape[0], g32.shape[1], device=cuda_device)
    be = gm._block_experts(al_sizes, al32.shape[0] // bm, E, bm)
    lhs, rhs, al, g_al = (t.to(dtype) for t in (lhs32, rhs32, al32, g_al32))
    counts = (gm.launches_gmm, gm.launches_tgmm, gm.launches_gmm_aligned,
              gm.launches_tgmm_aligned)
    got = {
        "K5": gm._gmm_fwd(lhs, rhs, offs),
        "K5 rhsT": gm._gmm_fwd(g32, rhs.transpose(1, 2), offs),
        "K6": gm._tgmm_fwd(lhs.float(), g32, offs, E),
        "K7": gm._gmm_aligned_fwd(al, rhs, be, bm),
        "K7 rhsT": gm._gmm_aligned_fwd(g_al, rhs.transpose(1, 2), be, bm),
        "K8": gm._tgmm_aligned_fwd(al, g_al, be, E, bm)}
    torch.cuda.synchronize()
    assert (gm.launches_gmm, gm.launches_tgmm, gm.launches_gmm_aligned,
            gm.launches_tgmm_aligned) == (counts[0] + 2, counts[1] + 1,
                                          counts[2] + 2, counts[3] + 1)
    want = {
        "K5": gm._gmm_plain(lhs, rhs, offs),
        "K5 rhsT": gm._gmm_plain(g32, rhs.transpose(1, 2), offs),
        "K6": gm._tgmm_plain(lhs.float(), g32, offs, E),
        "K7": gm._gmm_aligned_plain(al, rhs, be, bm),
        "K7 rhsT": gm._gmm_aligned_plain(g_al, rhs.transpose(1, 2), be, bm),
        "K8": gm._tgmm_aligned_plain(al, g_al, be, E, bm)}
    live = al_sizes > 0  # K8 leaves an expert with no block unwritten
    for key in got:
        a, b = (got[key][live], want[key][live]) if key == "K8" else \
            (got[key], want[key])
        assert bool(torch.isfinite(a).all()), key
        assert _gmm_rel_err(a, b) <= GMM_TOL[a.dtype], key
    assert bool((got["K5"][n:] == 0).all())
    assert bool((got["K5 rhsT"][n:] == 0).all())
    assert bool((got["K6"][sizes == 0] == 0).all())


def _plain_gmm(lhs, rhs, sizes):
    """Autograd-differentiable plain grouped matmul: each group's rows
    times its expert's matrix in f32, rows past the groups 0, cast to
    lhs's dtype at the end."""
    outs, o = [], 0
    for e, n in enumerate(sizes.tolist()):
        outs.append(lhs[o:o + n].float() @ rhs[e].float())
        o += n
    outs.append(lhs.new_zeros(lhs.shape[0] - o, rhs.shape[2]).float())
    return torch.cat(outs).to(lhs.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_autograd_matches_plain_autograd(cuda_device, dtype):
    """gmm and gmm_aligned through ``torch.autograd`` on the card against
    autograd through the plain grouped product, on the same inputs."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    lhs32, sizes, rhs32, g32 = _gmm_case("mixed", cuda_device)
    al32, al_sizes = _aligned(lhs32, sizes, 64)
    for fn, rows, gs, bm in ((gm.gmm, lhs32, sizes, 128),
                             (gm.gmm_aligned, al32, al_sizes, 64)):
        dy = torch.randn(rows.shape[0], rhs32.shape[2], device=cuda_device)
        leaves = [t.detach().to(dtype).requires_grad_()
                  for t in (rows, rhs32)]
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(*leaves, gs, bm=bm)
        grads = torch.autograd.grad(out, leaves, dy.to(dtype))
        rout = _plain_gmm(*ref, gs)
        rgrads = torch.autograd.grad(rout, ref, dy.to(dtype))
        assert _gmm_rel_err(out, rout) <= GMM_TOL[dtype]
        for a, b in zip(grads, rgrads):
            assert a.dtype == b.dtype == dtype
            assert bool(torch.isfinite(a).all())
            assert _gmm_rel_err(a, b) <= GMM_TOL[dtype]
        if fn is gm.gmm_aligned:  # experts with no rows: exactly 0
            assert bool((grads[1][al_sizes == 0] == 0).all())


@pytest.mark.cuda
def test_gmm_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    lhs, sizes, rhs, g = _gmm_case("mixed", cuda_device)
    with pytest.raises(TypeError, match="dtypes"):
        gm.gmm(lhs.to(torch.bfloat16), rhs, sizes, bm=128)  # bf16 x f32
    with pytest.raises(TypeError, match="dtypes"):
        gm.gmm(lhs.half(), rhs.half(), sizes, bm=128)
    with pytest.raises(ValueError, match="contiguous"):
        gm.gmm(lhs.t().contiguous().t(), rhs, sizes, bm=128)
    with pytest.raises(ValueError, match="one device"):
        gm.gmm(lhs, rhs, sizes.cpu(), bm=128)
    with pytest.raises(ValueError, match="one device"):
        gm.tgmm(lhs, g.cpu(), sizes, 8, bm=128)
    with pytest.raises(ValueError, match="divide"):
        gm.gmm_aligned(lhs[:1000], rhs, sizes, bm=128)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GMM_CASES + ["edges_mid_tile",
                                              "misaligned_lhs"])
def test_gmm_bf16_tensor_core_kernel(cuda_device, name):
    """K5 in bf16 (tensor cores): the device's tile list equals its plain
    version; the loader of each operand is TMA where TMA can describe it
    and registers where it cannot (rhs rows of 333 bf16 are 666 bytes; an
    lhs one element into its storage); group edges in the middle of a
    128-row tile, one-row groups and a hot expert; rows past the groups
    exactly 0, also when lhs holds data there."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    case = "mixed" if name in ("edges_mid_tile", "misaligned_lhs") else name
    lhs32, sizes, rhs32, _ = _gmm_case(case, cuda_device)
    if name == "edges_mid_tile":  # every edge inside a tile, none on one
        sizes = torch.tensor([37, 1, 90, 0, 129, 1, 255, 300],
                             device=cuda_device, dtype=torch.int32)
        lhs32[int(sizes.sum()):] = 0
    R, n = lhs32.shape[0], int(sizes.sum())
    lhs, rhs = lhs32.to(torch.bfloat16), rhs32.to(torch.bfloat16)
    if name == "misaligned_lhs":
        buf = torch.zeros(lhs.numel() + 8, device=cuda_device,
                          dtype=torch.bfloat16)
        lhs = buf[1:1 + lhs.numel()].view(lhs.shape).copy_(lhs)
    offs = gm._offsets_ext(sizes, R)
    tiles = gm._gmm_tiles(offs, R)
    assert torch.equal(tiles.cpu(), gm._gmm_tiles(offs.cpu(), R))
    want = ("tma", "registers" if rhs.shape[2] % 8 else "tma")
    if name == "misaligned_lhs":
        want = ("registers", "tma")
    assert gm._gmm_loaders(lhs, rhs) == want
    before = gm.launches_gmm
    out = gm._gmm_fwd(lhs, rhs, offs)
    torch.cuda.synchronize()
    assert gm.launches_gmm == before + 1
    ref = gm._gmm_plain(lhs, rhs, offs)
    assert bool(torch.isfinite(out).all())
    assert _gmm_rel_err(out, ref) <= GMM_TOL[torch.bfloat16]
    assert bool((out[n:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [32, 128])
@pytest.mark.parametrize("name", GMM_CASES)
def test_gmm_aligned_bf16_tensor_core_kernel(cuda_device, name, bm):
    """K7 in bf16 runs K5's tensor-core kernel over the runs of its block
    experts: the device's tile list equals its plain twin; forward and
    the rhsᵀ form of its backward (rhs read K-major by TMA where its rows
    allow) against the plain version, with two trailing blocks past the
    groups that hold data (they clamp to expert E-1 and are computed);
    one launch a call."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    lhs32, sizes, rhs32, g32 = _gmm_case(name, cuda_device)
    E, M, H = rhs32.shape
    al32, al_sizes = _aligned(lhs32, sizes, bm)
    al32 = torch.cat([al32, torch.randn(2 * bm, M, device=cuda_device)])
    R = al32.shape[0]
    g_al = torch.randn(R, H, device=cuda_device).to(torch.bfloat16)
    be = gm._block_experts(al_sizes, R // bm, E, bm)
    offs = gm._aligned_offsets(be, E, bm)
    assert torch.equal(offs.cpu(), gm._aligned_offsets(be.cpu(), E, bm))
    assert torch.equal(gm._gmm_tiles(offs, R).cpu(),
                       gm._gmm_tiles(offs.cpu(), R))
    al, rhs = al32.to(torch.bfloat16), rhs32.to(torch.bfloat16)
    rhs_t = rhs.transpose(1, 2)
    assert gm._gmm_loaders(al, rhs) == (
        "tma", "registers" if H % 8 else "tma")
    assert gm._gmm_loaders(g_al, rhs_t) == (
        "registers" if H % 8 else "tma",
        "registers" if H % 8 else "tma_k_major")
    before = gm.launches_gmm_aligned
    out = gm._gmm_aligned_fwd(al, rhs, be, bm)
    d_lhs = gm._gmm_aligned_fwd(g_al, rhs_t, be, bm)
    torch.cuda.synchronize()
    assert gm.launches_gmm_aligned == before + 2
    for got, want in ((out, gm._gmm_aligned_plain(al, rhs, be, bm)),
                      (d_lhs, gm._gmm_aligned_plain(g_al, rhs_t, be, bm))):
        assert got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got).all())
        assert _gmm_rel_err(got, want) <= GMM_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("name", GMM_CASES)
def test_tgmm_split_kernel(cuda_device, name):
    """K6 (f32 in, split into three bf16 values on the tensor cores)
    against its plain version at the f32 limit: ragged expert edges, the
    hot expert, one expert, rows of 333 columns (which TMA cannot
    describe: copied by cp.async, 4 bytes at a time); an empty expert
    exactly 0; one launch a call."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    lhs, sizes, _, g = _gmm_case(name, cuda_device)
    offs = gm._offsets_ext(sizes, lhs.shape[0])
    assert gm._tgmm_loader(lhs, g) == (
        "cp.async" if name == "widths_1000_333" else "tma")
    before = gm.launches_tgmm
    got = gm._tgmm_fwd(lhs, g, offs, sizes.shape[0])
    torch.cuda.synchronize()
    assert gm.launches_tgmm == before + 1
    want = gm._tgmm_plain(lhs, g, offs, sizes.shape[0])
    assert bool(torch.isfinite(got).all())
    assert _gmm_rel_err(got, want) <= GMM_TOL[torch.float32]
    assert bool((got[sizes == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 45056])
def test_tgmm_split_kernel_long_contraction(cuda_device, rows):
    """K6 on one hot expert that sums every row (45056: the 44k-row hot
    expert the f32 limit was set for) stays within the f32 limit: its
    accumulation error must not grow with the contraction length past
    it."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    lhs = torch.randn(rows, 512, device=cuda_device, generator=gen)
    g = torch.randn(rows, 256, device=cuda_device, generator=gen)
    sizes = torch.tensor([0, rows, 0], dtype=torch.int32, device=cuda_device)
    offs = gm._offsets_ext(sizes, rows)
    got = gm._tgmm_fwd(lhs, g, offs, 3)
    want = gm._tgmm_plain(lhs, g, offs, 3)
    assert _gmm_rel_err(got, want) <= GMM_TOL[torch.float32]
    assert bool((got[0] == 0).all()) and bool((got[2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 45056])
def test_tgmm_aligned_bf16_kernel_long_contraction(cuda_device, rows):
    """K8 in bf16 (tensor cores, accumulators restarted every 1024 rows)
    on one hot expert that sums every row, beside two experts with no
    block: the live expert within the f32 limit of its plain version, and
    through ``gmm_aligned``'s backward the empty experts' d_rhs exactly
    0."""
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    gen = torch.Generator(device=cuda_device).manual_seed(rows + 1)
    bm = 128
    lhs = torch.randn(rows, 512, device=cuda_device, generator=gen) \
        .to(torch.bfloat16)
    g = torch.randn(rows, 256, device=cuda_device, generator=gen) \
        .to(torch.bfloat16)
    sizes = torch.tensor([0, rows, 0], dtype=torch.int32, device=cuda_device)
    be = gm._block_experts(sizes, rows // bm, 3, bm)
    assert gm._tgmm_aligned_loader(lhs, g) == "tma"
    before = gm.launches_tgmm_aligned
    got = gm._tgmm_aligned_fwd(lhs, g, be, 3, bm)
    torch.cuda.synchronize()
    assert gm.launches_tgmm_aligned == before + 1
    want = gm._tgmm_aligned_plain(lhs, g, be, 3, bm)
    assert bool(torch.isfinite(got[1]).all())
    assert _gmm_rel_err(got[1], want[1]) <= GMM_TOL[torch.float32]
    rhs = torch.randn(3, 512, 256, device=cuda_device, generator=gen) \
        .to(torch.bfloat16).requires_grad_()
    out = gm.gmm_aligned(lhs, rhs, sizes, bm=bm)
    d_rhs, = torch.autograd.grad(out, rhs, g)
    assert bool((d_rhs[0] == 0).all()) and bool((d_rhs[2] == 0).all())
    assert _gmm_rel_err(d_rhs[1], want[1].to(torch.bfloat16)) <= \
        GMM_TOL[torch.bfloat16]


# -- the fused optimizer kernels (jit/fused_update.py) ------------------------
# bucket layouts: tensor shapes, and which parameters and gradients start
# one element past an allocation (off every 16-byte boundary). "7" and
# "4097" also put tensors at flat offsets that break the state's 16-byte
# alignment; "1000003" runs the 16-byte path with a scalar tail
ADAM_BUCKETS = {
    "1": (((1,),), False),
    "7": (((7,), (5,)), True),
    "4097": (((3,), (4097,), (64, 64)), True),
    "1000003": (((1000003,), (1000,)), False),
}
ADAM_KINDS = {  # parameter dtype, multi_precision
    "f32": (torch.float32, False), "bf16_master": (torch.bfloat16, True),
    "bf16": (torch.bfloat16, False), "f16_master": (torch.float16, True),
    "f16": (torch.float16, False)}


def _adam_opt(decay, ps, master):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.regularizer import L1Decay
    kw = dict(learning_rate=0.01, parameters=ps, multi_precision=master)
    if decay == "decoupled":
        return topt.AdamW(weight_decay=0.1, **kw)
    if decay == "lr_ratio":
        return topt.AdamW(weight_decay=0.1, lr_ratio=lambda p: 0.37, **kw)
    if decay == "l2":
        return topt.Adam(weight_decay=0.1, **kw)
    if decay == "l1":
        return topt.Adam(weight_decay=L1Decay(0.1), **kw)
    return topt.Adam(**kw)


def _bits(t):
    """The tensor's bits as integers: NaN and -0.0 compare as bits."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _on_card(arrays, dtype, misalign, device):
    """Contiguous tensors of ``arrays``; with ``misalign`` every other one
    starts one element into its allocation."""
    out = []
    for i, a in enumerate(arrays):
        off = 1 if misalign and i % 2 == 0 else 0
        buf = torch.empty(a.size + off, dtype=dtype, device=device)
        t = buf[off:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        out.append(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", sorted(ADAM_BUCKETS))
@pytest.mark.parametrize("decay", ["none", "decoupled", "lr_ratio", "l2",
                                   "l1"])
@pytest.mark.parametrize("kind", sorted(ADAM_KINDS))
def test_fused_adam_update_bit_equal_to_plain(cuda_device, kind, decay,
                                              bucket):
    """Three steps of one Adam/AdamW bucket through the kernel and
    through the plain bucket update, from the same state and gradients:
    every parameter, moment, master and beta power equal bit for bit. The
    clip's scale is below 1, or above it on every other layout."""
    import numpy as np
    from paddle_tpu_torch.jit import fused_update as fu
    dtype, master = ADAM_KINDS[kind]
    shapes, misalign = ADAM_BUCKETS[bucket]
    rng = np.random.RandomState(len(shapes) * 7 + len(decay))
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    scale = torch.tensor(0.625 if sorted(ADAM_BUCKETS).index(bucket) % 2
                         else 1.75, device=cuda_device)
    runs = []
    for update in (fu.fused_adam_update, fu.bucket_update_plain):
        ps = [torch.nn.Parameter(t) for t in _on_card(arrays, dtype, misalign,
                                                      cuda_device)]
        opt = _adam_opt(decay, ps, master)
        params = {f"p{i}": p for i, p in enumerate(ps)}
        layout = fu.build_layout(opt, params, list(params))
        (b,) = layout.buckets
        flats = fu.build_flat_states(opt, layout, params)
        lr = np.float32(0.01)
        if b.lr_ratio is not None:
            lr = np.float32(lr) * np.float32(b.lr_ratio)
        before = fu.launches_adam
        for gs in grads:
            update(opt, b, ps, _on_card(gs, dtype, misalign, cuda_device),
                   flats[0], float(lr), scale)
        torch.cuda.synchronize()
        assert fu.launches_adam == before + (
            3 if update is fu.fused_adam_update else 0)
        runs.append((ps, flats[0]))
    (pk, fk), (pp, fp) = runs
    for a, b in zip(pk, pp):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))
    for k in fp:
        assert torch.equal(_bits(fk[k]), _bits(fp[k])), k
    if kind != "f16":  # f16 moments underflow: eps = 1e-8 is 0 in f16
        assert bool(torch.isfinite(fk["moment2"].float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", sorted(ADAM_BUCKETS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fused_sqnorm_matches_plain_and_repeats(cuda_device, dtype, bucket):
    """A bucket's sum of squares within 1e-6 of the plain f32 sum (they
    add in other orders), and the same bits on a second run."""
    import numpy as np
    from paddle_tpu_torch.jit import fused_update as fu
    shapes, misalign = ADAM_BUCKETS[bucket]
    rng = np.random.RandomState(len(shapes))
    gs = _on_card([rng.randn(*s).astype(np.float32) for s in shapes], dtype,
                  misalign, cuda_device)
    before = fu.launches_sqnorm
    one, two = fu.fused_sqnorm(gs), fu.fused_sqnorm(gs)
    torch.cuda.synchronize()
    assert fu.launches_sqnorm == before + 2
    want = fu.sqnorm_plain(gs)
    assert one.dtype == torch.float32 and one.shape == ()
    assert abs(float(one) - float(want)) <= 1e-6 * float(want)
    assert torch.equal(one, two)


# ------------------------- the vision slice's card routes --------------------
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_rnn_card_route_matches_the_step_loop(cuda_device, name, direction,
                                              dtype, atol):
    """Two layers on the card take PyTorch's fused recurrence once a layer
    (the route counter says so) and agree with the same module's step
    loop on the CPU: outputs, final states and every gradient. A
    bfloat16 model computes in float32 (its default states are float32),
    so only its inputs and weights carry bfloat16's rounding; with a
    ``sequence_length`` the card runs the step loop and counts nothing."""
    import copy
    from paddle_tpu_torch import nn, seed
    from paddle_tpu_torch.nn.layer import rnn
    torch.backends.cudnn.allow_tf32 = False
    seed(3)
    card = getattr(nn, name)(24, 32, num_layers=2, direction=direction,
                             device=cuda_device, dtype=dtype)
    cpu = copy.deepcopy(card).cpu()
    x = torch.randn(4, 20, 24, generator=torch.Generator().manual_seed(0))
    runs = []
    for model, dev in ((card, cuda_device), (cpu, torch.device("cpu"))):
        xt = x.to(dev, dtype).requires_grad_(True)
        before = rnn.cudnn_calls
        out, fin = model(xt)
        calls = rnn.cudnn_calls - before
        fins = list(fin) if name == "LSTM" else [fin]
        loss = out.float().square().sum() + sum(
            f.float().sum() for f in fins)
        loss.backward()
        runs.append((calls, [out] + fins + [xt.grad] +
                     [p.grad for p in model.parameters()]))
    assert runs[0][0] == 2 and runs[1][0] == 0
    assert runs[0][1][0].dtype == dtype
    for a, b in zip(runs[0][1], runs[1][1]):
        scale = max(float(b.float().abs().max()), 1.0)
        assert float((a.float().cpu() - b.float()).abs().max()) <= \
            atol * scale
    before = rnn.cudnn_calls
    card(x.to(cuda_device, dtype),
         sequence_length=torch.tensor([20, 5, 9, 1], device=cuda_device))
    assert rnn.cudnn_calls == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_running_stats_on_the_card(cuda_device, dtype):
    """Two training forwards of ``BatchNorm2D`` on the card move the
    running statistics by the reference's rule (momentum 0.9, biased
    batch variance), written out in numpy; a bfloat16 layer keeps them
    in bfloat16."""
    from paddle_tpu_torch import nn
    bn = nn.BatchNorm2D(8, device=cuda_device, dtype=dtype)
    rm = np.zeros(8)
    rv = np.ones(8)
    rng = np.random.RandomState(0)
    for _ in range(2):
        x = (2.0 * rng.randn(16, 8, 7, 9) + 0.5).astype(np.float32)
        xt = torch.from_numpy(x).to(cuda_device, dtype)
        xd = xt.float().cpu().numpy().astype(np.float64)
        bn(xt)
        rm = 0.9 * rm + 0.1 * xd.mean(axis=(0, 2, 3))
        rv = 0.9 * rv + 0.1 * xd.var(axis=(0, 2, 3))
    assert bn._mean.dtype == bn._variance.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(bn._mean.float().cpu().numpy(), rm,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(bn._variance.float().cpu().numpy(), rv,
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_ctc_on_the_card_matches_the_cpu(cuda_device, reduction):
    """CTC with per-sample input lengths, in float32 on the card against
    the same call on the CPU: the loss and the gradient of the
    log-probabilities (rtol 1e-4, atol 1e-4, as the reference's CTC
    test)."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(1)
    T, B, C, L = 40, 6, 30, 12
    logits = torch.from_numpy(rng.randn(T, B, C).astype(np.float32))
    labels = torch.from_numpy(rng.randint(1, C, (B, L)))
    in_len = torch.tensor([40, 33, 25, 40, 30, 28])
    lbl_len = torch.tensor([12, 10, 7, 1, 12, 9])
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        lp = torch.log_softmax(logits, -1).to(dev).requires_grad_(True)
        loss = F.ctc_loss(lp, labels.to(dev), in_len.to(dev),
                          lbl_len.to(dev), reduction=reduction)
        loss.sum().backward()
        outs.append((loss.detach().cpu(), lp.grad.cpu()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------ CUDA-graph capture ---------------------------
def _tiny_llama(device, dtype="float32", layers=2):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=layers, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=128,
                      tie_word_embeddings=True)
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=3)
    model.eval()
    return model


@pytest.mark.cuda
def test_captured_decode_equals_the_eager_steps(cuda_device):
    """``generate_compiled`` on the card: the decode step is captured once
    per signature (its warm-up is the first decode step) and replayed for
    the rest; the greedy tokens equal the eager ``generate``'s (f32,
    head_dim 64); a second call with the same signature replays without a
    new capture; a left-padded ragged batch gives each row its solo run;
    chunked prefill equals one-shot."""
    from paddle_tpu_torch.jit import cuda_graph
    model = _tiny_llama(cuda_device)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (3, 16))).to(cuda_device)
    eager = model.generate(ids, max_new_tokens=12, temperature=0)
    before = cuda_graph.captures
    comp = model.generate_compiled(ids, max_new_tokens=12)
    assert cuda_graph.captures == before + 1
    assert torch.equal(comp, eager)
    again = model.generate_compiled(ids, max_new_tokens=12)
    assert cuda_graph.captures == before + 1  # replayed, not captured
    assert torch.equal(again, eager)
    chunked = model.generate_compiled(ids, max_new_tokens=12,
                                      prefill_chunk=4)
    assert torch.equal(chunked, eager)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 128, n) for n in (5, 9, 16)]
    pad = np.zeros((3, 16), np.int64)
    mask = np.zeros((3, 16), np.int64)
    for b, p in enumerate(prompts):
        pad[b, 16 - len(p):] = p
        mask[b, 16 - len(p):] = 1
    out = model.generate_compiled(torch.from_numpy(pad).to(cuda_device),
                                  max_new_tokens=8,
                                  attention_mask=torch.from_numpy(mask))
    for b, p in enumerate(prompts):
        solo = model.generate_compiled(
            torch.from_numpy(p[None]).to(cuda_device), max_new_tokens=8)
        assert torch.equal(out[b, 16:], solo[0, len(p):]), b


@pytest.mark.cuda
def test_captured_sampling_draws_from_the_registered_generator(cuda_device):
    """Sampling under capture: the draw (``torch.multinomial`` on
    ``core.generator``'s card stream, registered with the graph) gives
    in-vocabulary tokens that differ from replay to replay, and the same
    seed repeats them."""
    from paddle_tpu_torch.core import generator
    model = _tiny_llama(cuda_device)
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 128, (4, 8))).to(cuda_device)
    generator.seed(5)
    a = model.generate_compiled(ids, max_new_tokens=24, temperature=1.0)
    b = model.generate_compiled(ids, max_new_tokens=24, temperature=1.0)
    generator.seed(5)
    c = model.generate_compiled(ids, max_new_tokens=24, temperature=1.0)
    new = a[:, 8:]
    assert bool(((new >= 0) & (new < 128)).all())
    assert not torch.equal(a, b)
    assert torch.equal(a, c)
    # the decode steps differ from one another too: not one sample replayed
    assert len({tuple(r.tolist()) for r in new.T}) > 1


@pytest.mark.cuda
def test_to_static_replay_equals_eager(cuda_device):
    """``to_static`` of a Llama eval forward on the card: the captured
    replay equals the eager logits (the same kernels, f32); K1 counts one
    launch a layer a replay; a parameter update between calls is seen
    without a new capture; new storage (``set_state_dict`` of new
    tensors) captures again."""
    from paddle_tpu_torch.jit import cuda_graph, to_static
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    model = _tiny_llama(cuda_device)
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 128, (2, 64))).to(cuda_device)
    with torch.no_grad():
        eager = model(ids)
    sm = to_static(model)
    first = sm(ids)
    torch.testing.assert_close(first, eager, rtol=1e-5, atol=1e-5)
    k1 = fa.launches_fwd
    captures = cuda_graph.captures
    replay = sm(ids)
    assert fa.launches_fwd == k1 + 2 and cuda_graph.captures == captures
    torch.testing.assert_close(replay, eager, rtol=1e-5, atol=1e-5)
    assert len(sm.code_cache) == 1
    with torch.no_grad():
        model.model.norm.weight.mul_(2.0)
        doubled = model(ids)
    torch.testing.assert_close(sm(ids), doubled, rtol=1e-5, atol=1e-5)
    assert cuda_graph.captures == captures
    model.model.norm.weight = torch.nn.Parameter(
        model.model.norm.weight.detach().clone() * 0.5)
    with torch.no_grad():
        halved = model(ids)
    torch.testing.assert_close(sm(ids), halved, rtol=1e-5, atol=1e-5)
    assert cuda_graph.captures == captures + 1
    assert len(sm.code_cache) == 1


@pytest.mark.cuda
def test_capture_registers_the_dropout_generator(cuda_device):
    """A captured dropout draws from ``core.generator``'s card stream,
    registered with the graph: two replays give different masks, and a
    batch norm's running statistics move once a call."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.jit import to_static
    drop = nn.Dropout(0.5)
    drop.train()
    sm = to_static(drop)
    x = torch.ones(64, 64, device=cuda_device)
    masks = [sm(x) for _ in range(3)]  # capture, then two replays
    assert bool((masks[1] == 0).any())
    assert not torch.equal(masks[1], masks[2])
    assert not torch.equal(masks[0], masks[1])
    bn = nn.BatchNorm1D(6, device=cuda_device)
    bn.train()
    sb = to_static(bn)
    xb = torch.randn(16, 6, device=cuda_device) * 3 + 2
    means = []
    for _ in range(3):
        sb(xb)
        means.append(bn._mean.clone())
    # each call moves the statistics by the same rule once
    want = [xb.mean(0) * (1 - 0.9 ** (i + 1)) for i in range(3)]
    for got, w in zip(means, want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)



# ------------------------------ int8 execution -------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (64, 4096, 1024), (520, 128, 64), (40, 64, 96), (17, 8, 8),
    (24, 16, 40), (100, 72, 24), (8, 64, 32), (33, 24, 44), (20, 7, 9)])
def test_int8_matmul_on_the_card_is_exact(cuda_device, m, k, n):
    """``Int8Linear``'s product on the card: ``torch._int_mm`` where it
    takes the shape (M > 16, K and N multiples of 8), the exact float64
    branch elsewhere; both equal an int64 product on the CPU, at the
    grid's extremes too."""
    from paddle_tpu_torch.quantization.int8 import (int8_matmul,
                                                    int8_matmul_exact)
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    a[0], b[:, 0] = 127, -127
    want = (a.long() @ b.long()).int()
    for fn in (int8_matmul, int8_matmul_exact):
        got = fn(a.to(cuda_device), b.to(cuda_device))
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("padding,fmt", [(1, "NCHW"), ("SAME", "NHWC")])
def test_int8_layers_on_the_card_equal_the_cpu(cuda_device, padding, fmt):
    """``Int8Linear`` and ``Int8Conv2D`` on the card give the CPU's
    results: the same int8 weights, an exact int32 accumulation on both
    (the convolution in float64), one f32 rescale."""
    from paddle_tpu_torch.quantization import Int8Conv2D, Int8Linear
    g = torch.Generator().manual_seed(5)
    wq = torch.randint(-127, 128, (64, 96), generator=g, dtype=torch.int8)
    lin = Int8Linear(wq, np.linspace(0.5, 2.0, 96).astype(np.float32), 3.0,
                     torch.randn(96, generator=g), w_axis=1)
    x = torch.randn(40, 64, generator=g)
    cw = torch.randint(-127, 128, (8, 3, 3, 3), generator=g,
                       dtype=torch.int8)
    conv = Int8Conv2D(cw, 0.7, 2.5, torch.randn(8, generator=g), 1,
                      padding, 1, 1, fmt)
    xc = torch.randn(2, 3, 9, 9, generator=g)
    if fmt == "NHWC":
        xc = xc.permute(0, 2, 3, 1).contiguous()
    for layer, inp in ((lin, x), (conv, xc)):
        want = layer(inp)
        got = layer.to(cuda_device)(inp.to(cuda_device))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rpa_at_the_moe_geometry(cuda_device, dtype):
    """DeepSeekMoE-16B's attention on the bf16/f16 kernels: 16 KV heads,
    group 1, head_dim 128, block 16, tile 8: a 512-token prefill chunk
    over 1024 cached tokens, decode rows of 2047 and 130 tokens, a shared
    prefix and a padding tail, against the plain version at the serving
    check's bf16 tolerance (f16 at its own)."""
    rng = np.random.RandomState(16)
    seqs = [(512, 1024), (1, 2047), (1, 130), (0, 0), (1, 17)]
    args, valid = _rpa_bf16_args(rng, seqs, 16, 1, 128, 8, cuda_device,
                                 n_kv=16, shared=4, dtype=dtype)
    out = rpa.ragged_paged_attention(*args)
    ref = rpa.ragged_paged_attention_reference(*args)
    tol = dict(atol=4e-3, rtol=8e-3) if dtype == torch.bfloat16 else \
        dict(atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(), **tol)
    assert bool((out[~valid] == 0).all())


@pytest.mark.cuda
def test_rpa_tile_q_picks_a_tile_the_kernel_takes(cuda_device):
    """With ``FLAGS_use_autotune`` on the card, ``rpa_tile_q`` sweeps the
    tiles of rows <= 128 on the synthetic mix and caches its pick: one
    of them (only 8 at group 16), a hit the second time, and the kernel
    runs a step at the picked tile."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.ops.pallas import autotune as at
    cache = at.AutoTuneCache.instance()
    cache.clear()
    set_flags({"FLAGS_use_autotune": True})
    try:
        for n_heads, n_kv, cands in ((16, 16, (8, 16, 32)),
                                     (32, 2, (8,))):
            sig = (520, n_heads, n_kv, 128, 16, 128, 512, "bfloat16")
            tile = rpa.rpa_tile_q(*sig)
            assert tile in cands
            assert rpa.rpa_tile_q(*sig) == tile
        assert cache.stats()["hits"] == 2 and cache.stats()["misses"] == 2
    finally:
        set_flags({"FLAGS_use_autotune": False})
        cache.clear()
    rng = np.random.RandomState(3)
    args, valid = _rpa_bf16_args(rng, [(9, 16), (1, 40)], 16, 1, 128, tile,
                                 cuda_device, n_kv=2)
    out = rpa.ragged_paged_attention(*args)
    ref = rpa.ragged_paged_attention_reference(*args)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               atol=4e-3, rtol=8e-3)


def _tiny_moe(device, dtype=torch.float32, **kw):
    from paddle_tpu_torch.models.moe import MoeConfig, MoeForCausalLM
    cfg = MoeConfig.tiny(hidden_size=128, num_attention_heads=2,
                         num_key_value_heads=2, **kw)
    return MoeForCausalLM(cfg, device=device, dtype=dtype, seed=5).eval()


def _strict_capture(monkeypatch):
    """``CapturedGraph.capture`` with the function it captures run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read in its
    warm-up run raises (one during the capture itself is refused by the
    capture anyway)."""
    from paddle_tpu_torch.jit import cuda_graph
    capture = cuda_graph.CapturedGraph.capture

    def strict(self):
        fn = self._fn

        def checked():
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self._fn = checked
        return capture(self)
    monkeypatch.setattr(cuda_graph.CapturedGraph, "capture", strict)
    return cuda_graph


@pytest.mark.cuda
def test_moe_layer_replays_under_capture(cuda_device, monkeypatch):
    """``route`` counts with a fixed-bin ``scatter_add_`` (no host read),
    so ``MoELayer``'s forward, with and without a token mask, captures as
    a CUDA graph with the sync check set to error, and its replay on new
    inputs equals the eager forward: outputs, capacity drops, the
    auxiliary loss."""
    from paddle_tpu_torch.distributed.fleet import MoELayer
    cuda_graph = _strict_capture(monkeypatch)
    layer = MoELayer(64, 96, 8, top_k=2, activation="silu",
                     device=cuda_device, seed=3)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 24, 64, device=cuda_device, generator=g)
    mask = torch.rand(2, 24, device=cuda_device, generator=g) > 0.3
    for m in (None, mask):
        static_x = x.clone()

        def step():
            return (layer(static_x, token_mask=m), layer.l_aux,
                    layer.last_dropped)
        with torch.no_grad():
            graph = cuda_graph.CapturedGraph(step, cuda_device)
            graph.capture()
            new = torch.randn(2, 24, 64, device=cuda_device, generator=g)
            static_x.copy_(new)
            out, aux, dropped = graph.replay()
            want = layer(new, token_mask=m)
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(aux, layer.l_aux, atol=1e-6, rtol=1e-5)
        assert int(dropped) == int(layer.last_dropped)


@pytest.mark.cuda
def test_moe_generate_compiled_captures_without_a_sync(cuda_device,
                                                       monkeypatch):
    """The MoE LM's ``generate_compiled``: its decode step captures once
    per signature with the sync check set to error (no host read left in
    the step), the replayed greedy tokens equal the eager ``generate``'s
    (f32, head_dim 64), a second call replays, and ``aux_loss()`` is
    ``None`` after each. After the eager ``generate`` the gates keep the
    last decode step's ``l_aux``, as the reference's do: ``aux_loss()``
    equals the plain versions' on the CPU over the same weights, at the
    layers' tolerance."""
    model = _tiny_moe(cuda_device)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (4, 16))).to(cuda_device)
    eager = model.generate(ids, max_new_tokens=10, temperature=0)
    plain = _tiny_moe("cpu")
    plain.load_state_dict({k: v.cpu()
                           for k, v in model.state_dict().items()})
    assert torch.equal(plain.generate(ids.cpu(), max_new_tokens=10,
                                      temperature=0), eager.cpu())
    torch.testing.assert_close(model.aux_loss().cpu(), plain.aux_loss(),
                               rtol=1e-4, atol=1e-5)
    cuda_graph = _strict_capture(monkeypatch)
    before = cuda_graph.captures
    comp = model.generate_compiled(ids, max_new_tokens=10)
    assert cuda_graph.captures == before + 1
    assert torch.equal(comp, eager)
    assert model.aux_loss() is None
    assert torch.equal(model.generate_compiled(ids, max_new_tokens=10),
                       eager)
    assert cuda_graph.captures == before + 1


@pytest.mark.cuda
def test_moe_engine_serves_on_the_kernel(cuda_device):
    """The MoE LM behind ``ServingEngine`` on the card (bf16, head_dim
    64): K4 launched once a layer a step, greedy streams equal the
    gather engine's, no leaked block, ``aux_loss()`` ``None``."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _tiny_moe(cuda_device, torch.float32)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 128, n).tolist() for n in (9, 30, 5)]
    streams = {}
    for impl in ("rpa", "gather"):
        eng = ServingEngine(model, max_batch=4, max_blocks=64,
                            block_size=16, prefill_chunk=16, attn_impl=impl)
        before = rpa.ragged_paged_attention.launches
        hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        streams[impl] = [h.result(30)["token_ids"] for h in hs]
        launched = rpa.ragged_paged_attention.launches - before
        want = 2 * eng.steps if impl == "rpa" else 0
        assert launched == want
        eng.cache.allocator.assert_no_leaks()
        assert model.aux_loss() is None
    assert streams["rpa"] == streams["gather"]


# ------------------ export, deployment and the static graph -----------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_op_launches_k1_on_the_card(cuda_device, dtype):
    """``paddle_tpu::flash_fwd`` on CUDA tensors launches K1 (counted) and
    agrees with the plain version; a head_dim the kernel has no instance
    for raises there rather than compute the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = [torch.randn(2 * h, 96, 64, device=cuda_device, dtype=dtype,
                           generator=gen) for h in (4, 2, 2)]
    args = (q, k, v, None, None, None, 4, 2, True, 0.125, 1, 1, 0.0, 0, -1)
    before = fa.launches_fwd
    o, lse = torch.ops.paddle_tpu.flash_fwd(*args)
    assert fa.launches_fwd == before + 1
    g = fa.FlashGeometry(hq=4, hkv=2, causal=True, sm_scale=0.125)
    ro, rlse = fa._forward_plain(q, k, v, g)
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == torch.float32 else \
        dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, **tol)
    q3 = torch.zeros(2, 8, 200, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError, match="head_dim"):
        torch.ops.paddle_tpu.flash_fwd(q3, q3, q3, *args[3:])


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["cuda", "cpu"])
def test_exported_program_runs_k1_on_the_card(cuda_device, tmp_path, where):
    """``jit.save`` of a Llama (exported on the card, or on the CPU and
    moved by ``move_to_device_pass``) and ``inference.Predictor`` on the
    card: the graph holds ``paddle_tpu::flash_fwd``, a run launches K1
    once a layer, and the logits equal the eager forward's at two batch
    sizes (f32, hd 64)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.static import InputSpec
    model = _tiny_llama(cuda_device)
    exported = model if where == "cuda" else _tiny_llama("cpu")
    exported.load_state_dict({k: v.to(where)
                              for k, v in model.state_dict().items()})
    jit.save(exported, str(tmp_path / "m"),
             input_spec=[InputSpec([None, 24], "int64")])
    pred = Predictor(Config(str(tmp_path / "m")))
    nodes = [n for n in pred._module.graph.nodes
             if n.target is torch.ops.paddle_tpu.flash_fwd.default]
    assert len(nodes) == 2
    for b in (2, 3):
        ids = np.random.RandomState(b).randint(0, 128, (b, 24))
        before = fa.launches_fwd
        (out,) = pred.run([ids])
        assert fa.launches_fwd == before + 2
        with torch.no_grad():
            want = model(torch.from_numpy(ids).to(cuda_device))
        torch.testing.assert_close(torch.from_numpy(out), want.cpu(),
                                   atol=2e-5, rtol=2e-4)


@pytest.mark.cuda
def test_stream_and_event_on_the_card(cuda_device):
    """``paddle.device.cuda``'s ``Stream`` and ``Event`` (the reference's
    names and signatures) order a copy on a side stream before a read on
    the current one."""
    from paddle_tpu_torch.device import cuda as pcuda
    src = torch.arange(1 << 20, device=cuda_device, dtype=torch.float32)
    dst = torch.empty_like(src)
    side = pcuda.Stream(priority=1)
    assert isinstance(side, torch.cuda.Stream)
    side.wait_stream(pcuda.current_stream())
    with pcuda.stream_guard(side):
        dst.copy_(src * 2.0)
        ev = side.record_event()
    assert isinstance(ev, pcuda.Event)
    pcuda.current_stream().wait_event(ev)
    assert torch.equal((dst + 1.0).cpu(), src.cpu() * 2.0 + 1.0)
    ev.synchronize()
    assert ev.query()


@pytest.mark.cuda
def test_trainable_mask_on_the_card_equals_the_cpu(cuda_device):
    """A float mask that requires grad takes the composite on the card
    (no K1 launch): output and gradients equal the CPU's in f32."""
    import paddle_tpu_torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    base = [torch.randn(*s, generator=gen) for s in
            ((2, 32, 4, 64), (2, 32, 2, 64), (2, 32, 2, 64), (1, 4, 32, 32))]
    res = {}
    before = fa.launches_fwd
    for dev in ("cpu", cuda_device):
        xs = [x.detach().clone().to(dev).requires_grad_() for x in base]
        out = F.scaled_dot_product_attention(*xs[:3], attn_mask=xs[3])
        torch.sin(out).sum().backward()
        res[str(dev)] = [out] + [x.grad for x in xs]
    assert fa.launches_fwd == before
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=2e-3)


@pytest.mark.cuda
def test_control_flow_on_a_device_predicate_under_capture_raises(
        cuda_device):
    """A CUDA graph cannot branch on device data: ``static.nn.cond``,
    ``while_loop`` and ``switch_case`` on a card predicate raise under
    ``to_static``; eagerly they run."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.static import nn as snn
    x = torch.tensor([1.0, 2.0], device=cuda_device)

    def branch(t):
        return snn.cond(t.sum() > 0, lambda a: a * 2, lambda a: a - 1,
                        operands=(t,))
    torch.testing.assert_close(branch(x), x * 2)
    for fn in (branch,
               lambda t: snn.while_loop(lambda v: v.sum() < 10,
                                        lambda v: v * 2, [t])[0],
               lambda t: snn.switch_case(t.sum().int(),
                                         {3: lambda: t * 3})):
        with pytest.raises(NotImplementedError, match="CUDA graph"):
            to_static(fn)(x)


@pytest.mark.cuda
def test_static_program_trains_on_the_card(cuda_device):
    """``examples/static_regression.py``'s workflow with its placeholders
    and replay on the card: the loss falls as on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    paddle.enable_static()
    try:
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [None, 13], "float32")
            y = static.data("y", [None, 1], "float32")
            pred = static.nn.fc(x, size=1)
            loss = paddle.ops.mean(paddle.ops.square(
                paddle.ops.subtract(pred, y)))
            paddle.optimizer.SGD(learning_rate=0.1).minimize(loss)
        assert pred.device.type == "cuda"
        rng = np.random.RandomState(0)
        w = rng.randn(13, 1).astype(np.float32)
        exe = static.Executor()
        losses = []
        for _ in range(30):
            xb = rng.randn(64, 13).astype(np.float32)
            losses.append(float(exe.run(prog, feed={"x": xb, "y": xb @ w},
                                        fetch_list=[loss])[0]))
        assert losses[-1] < losses[0] * 1e-3, losses[::10]
    finally:
        paddle.disable_static()


@pytest.mark.cuda
def test_int8_layer_exports_on_the_card(cuda_device, tmp_path):
    """``convert_to_int8``'s ``Int8Linear`` (``torch._int_mm`` on the
    card) through ``jit.save``/``jit.load`` on the card equals the live
    int8 layer (``examples/int8_deploy.py``'s step 3)."""
    from paddle_tpu_torch import jit, nn, quantization as q
    from paddle_tpu_torch.static import InputSpec
    lin = nn.Linear(32, 16, device=cuda_device)
    model = q.convert_to_int8(nn.Sequential(lin)).eval()
    jit.save(model, str(tmp_path / "int8"),
             input_spec=[InputSpec([8, 32], "float32")])
    back = jit.load(str(tmp_path / "int8"))
    x = torch.randn(8, 32, device=cuda_device)
    with torch.no_grad():
        torch.testing.assert_close(back(x), model(x), atol=1e-6, rtol=0)


# ------------------ serving in production: handoff, threads, profile --------
def _serving_llama(device, dtype, head_dim=64, seed=5):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=4 * head_dim, num_attention_heads=4,
                           num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=seed)
    model.eval()
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("src_kv", [None, "int8"])
def test_kv_handoff_rows_equal_the_source_pool(cuda_device, src_kv):
    """``export_kv_blocks`` -> ``import_kv_blocks`` between two engines on
    the card: a bf16 replica's blocks arrive bit for bit; an int8-KV
    replica's arrive as its pools dequantized with their scales (the
    wire dtype is the compute dtype). The records stay on the card, and
    the decode side then serves the prompt with the blocks as cached
    tokens."""
    import warnings
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.fleet.router import prompt_digests
    model = _serving_llama(cuda_device, torch.bfloat16)
    kw = dict(max_batch=2, max_blocks=32, block_size=16, prefill_chunk=16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        src = ServingEngine(model, kv_dtype=src_kv, **kw)
    dst = ServingEngine(model, **kw)
    prompt = np.random.RandomState(4).randint(1, 256, 70).tolist()
    src.submit(prompt, max_new_tokens=1)
    src.run_until_idle()
    digs = prompt_digests(prompt, 16)
    recs = src.export_kv_blocks(digs)
    assert len(recs) == 4 and recs[0][1].device.type == "cuda"
    assert recs[0][1].dtype == torch.bfloat16
    assert dst.import_kv_blocks(recs) == 4
    sc, dc = src.cache, dst.cache
    for d, k, v in recs:
        b_src, b_dst = sc.prefix_cache.lookup(d), dc.prefix_cache.lookup(d)
        got_k = torch.stack([p[b_dst] for p in dc.k_pools])
        got_v = torch.stack([p[b_dst] for p in dc.v_pools])
        if src_kv is None:
            want_k = torch.stack([p[b_src] for p in sc.k_pools])
            want_v = torch.stack([p[b_src] for p in sc.v_pools])
        else:
            want_k = torch.stack([p[b_src].float() * s[b_src][..., None]
                                  for p, s in zip(sc.k_pools, sc.k_scales)]
                                 ).to(torch.bfloat16)
            want_v = torch.stack([p[b_src].float() * s[b_src][..., None]
                                  for p, s in zip(sc.v_pools, sc.v_scales)]
                                 ).to(torch.bfloat16)
        assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    h = dst.submit(prompt, max_new_tokens=3)
    dst.run_until_idle()
    h.result(30)
    assert h._req.cached_tokens_total == 64 and h._req.prefilled_tokens == 6
    src.cache.allocator.assert_no_leaks()
    dst.cache.allocator.assert_no_leaks()


@pytest.mark.cuda
def test_two_engine_threads_share_one_model_on_the_card(cuda_device):
    """Two engines, one model, two run threads launching K4 onto the
    card at once: every request gets the stream it gets alone, both
    engines launch the kernel, and their own counts sum to the global
    count."""
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_llama(cuda_device, torch.bfloat16)
    kw = dict(max_batch=4, max_blocks=64, block_size=16, prefill_chunk=32)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 256, n).tolist() for n in (9, 40, 23, 70, 5)]
    solo = []
    for p in prompts:
        eng = ServingEngine(model, **kw)
        h = eng.submit(p, max_new_tokens=12)
        eng.run_until_idle()
        solo.append(h.result(30)["token_ids"])
    engines = [ServingEngine(model, **kw) for _ in range(2)]
    before = rpa.ragged_paged_attention.launches
    for e in engines:
        e.start()
    try:
        hs = [engines[i % 2].submit(p, max_new_tokens=12)
              for i, p in enumerate(prompts * 2)]
        got = [h.result(120)["token_ids"] for h in hs]
    finally:
        for e in engines:
            e.shutdown()
    assert got == solo * 2
    own = [e.rpa_launches for e in engines]
    assert min(own) > 0
    assert sum(own) == rpa.ragged_paged_attention.launches - before


@pytest.mark.cuda
def test_a_profile_window_on_the_card_names_k4(cuda_device, tmp_path):
    """A bounded ``torch.profiler`` window opened on one thread while an
    engine serves on its own: the Chrome trace names K4's wgmma kernel,
    and a second window while the first is live is refused."""
    import json
    import os
    from paddle_tpu_torch.observability import profile
    from paddle_tpu_torch.serving import ServingEngine
    model = _serving_llama(cuda_device, torch.bfloat16)
    eng = ServingEngine(model, max_batch=2, max_blocks=32, block_size=16,
                        prefill_chunk=16)
    eng.start()
    profile.set_trace_dir(str(tmp_path))
    try:
        out = profile.start_capture("test")
        with pytest.raises(profile.CaptureBusy):
            profile.start_capture("test")
        eng.submit(list(range(1, 40)), max_new_tokens=8).result(60)
        assert profile.stop_capture() == out
    finally:
        profile.stop_capture()
        profile.set_trace_dir(None)
        eng.shutdown()
    with open(os.path.join(out, profile.TRACE_FILE)) as f:
        names = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]]
    assert any("rpa_wgmma_kernel" in n for n in names)


# ------------------------------ training in production ----------------------
def _bf16_train_step(device, fused=True):
    """A 2-layer bf16 Llama (head_dim 64: K1-K3 on wgmma) under a fused
    TrainStep with AdamW (f32 masters, clip 1.0), and one batch."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    model = _tiny_llama(device, dtype="bfloat16")
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, lambda m, t: m(t, labels=t)[1], opt,
                     fused=fused)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (2, 256))).to(device)
    return model, opt, step, x


@pytest.mark.cuda
def test_a_profiler_window_over_train_steps_names_k1_to_k3(cuda_device,
                                                           tmp_path):
    """``paddle.profiler.Profiler`` with the GPU target over five
    ``TrainStep`` calls (closed, ready, record 2): five steps in
    ``step_info``, the host trace holds the ``TrainStep`` spans of the
    window, and the device trace beside it names K1-K3's wgmma kernels
    and the fused Adam kernel."""
    import json
    import os
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import profile
    _, _, step, x = _bf16_train_step(cuda_device)
    profile.set_trace_dir(str(tmp_path / "captures"))
    try:
        prof = profiler.Profiler(
            targets=[profiler.ProfilerTarget.CPU,
                     profiler.ProfilerTarget.GPU],
            scheduler=profiler.make_scheduler(closed=1, ready=1, record=2))
        prof.start()
        for i in range(5):
            float(step(x))
            if i < 4:
                prof.step()
        prof.stop()
    finally:
        profile.set_trace_dir(None)
    assert prof.step_info()["steps"] == 5
    host = prof.export_chrome_tracing(str(tmp_path / "out"), "w0")
    spans = [e["name"] for e in json.load(open(host))["traceEvents"]]
    assert spans.count("TrainStep") == 2
    (dev,) = [f for f in os.listdir(tmp_path / "out") if "device" in f]
    with open(tmp_path / "out" / dev) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    for kernel in ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                   "flash_dkv_wgmma_kernel", "fused_adam_kernel"):
        assert any(kernel in n for n in names), kernel


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_attribution_on_the_card_restores_the_fused_buckets(cuda_device,
                                                            fused):
    """``attribute_train_step`` on the card (CUDA-event timing) after a
    fused step planned its flat buckets: the phases sum to the measured
    step; afterwards every parameter and optimizer state entry is
    bit-identical and still a view of the same flats, and the first
    step's next loss equals a twin's that never saw the attribution."""
    from paddle_tpu_torch.observability.attribution import \
        attribute_train_step
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    runs = []
    for attribute in (True, False):
        model, opt, step, x = _bf16_train_step(cuda_device)
        float(step(x))
        if attribute:
            flats = step._plan[2]
            params = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            state = {k: (d, dict(d), {kk: v.clone() for kk, v in d.items()})
                     for k, d in opt._state.items()}
            rep = attribute_train_step(model, opt, x, steps=2, warmup=1,
                                       reps=2, fused=fused,
                                       registry=MetricsRegistry())
            assert rep.check(0.05) and rep.peak > 0
            assert rep.phases["optimizer"]["seconds"] > 0
            for n, p in model.named_parameters():
                assert torch.equal(p, params[n]), n
            for k, (d, entries, values) in state.items():
                assert opt._state[k] is d
                for kk, v in d.items():
                    assert v is entries[kk] and torch.equal(v, values[kk])
            assert step._fused_plan(list(step._params))[1] is flats
        runs.append(float(step(x)))
    assert runs[0] == runs[1]


# ---------------- ring-flash's block calls and gloo's host staging ----------------
def _merge_blocks(o1, lse1, o2, lse2):
    """Two blocks' ``(o, lse)`` merged through their log-sum-exps, in
    f32 (``sequence_parallel._merge``)."""
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import _merge
    return _merge(o1.float(), lse1, o2, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 2e-4), (torch.bfloat16, 2e-2), (torch.float16, 1.5e-3)])
@pytest.mark.parametrize("hd", [64, 128, 72])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_block_calls_with_an_external_lse(cuda_device, dtype, tol, hd,
                                                causal):
    """Ring-flash's calls (``flash_block_fwd``/``flash_block_bwd``): K1 on
    the diagonal block (causal or not) and on a past block, each held
    against the plain forward; the two merged through their lse; K2 and
    K3 on each block with the merged output and the *global* lse, held
    against the plain backward on the same tensors, and their sum against
    K2/K3 run once over both key blocks (the ring's arithmetic is the
    whole row's). Tolerances as the kernel tests above; head_dim 72 runs
    zero-padded and counts in ``launches_padded``."""
    rng = np.random.RandomState(hd + int(causal))
    bh, s = 4, 192
    mk = lambda: torch.from_numpy(  # noqa: E731
        rng.randn(bh, s, hd)).to(cuda_device, dtype).contiguous()
    q, k1, v1, k2, v2, do = (mk() for _ in range(6))
    scale = 1.0 / np.sqrt(hd)
    counts = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
              fa.launches_padded)
    o1, lse1 = fa.flash_block_fwd(q, k1, v1, causal, scale)
    o2, lse2 = fa.flash_block_fwd(q, k2, v2, False, scale)
    o, lse = _merge_blocks(o1, lse1, o2, lse2)
    o = o.to(dtype)
    g1 = fa.FlashGeometry(hq=1, hkv=1, causal=causal, sm_scale=scale)
    g2 = fa.FlashGeometry(hq=1, hkv=1, causal=False, sm_scale=scale)
    grads = [fa.flash_block_bwd(q, kk, vv, o, lse, do, c, scale)
             for kk, vv, c in ((k1, v1, causal), (k2, v2, False))]
    torch.cuda.synchronize()
    padded = 6 if hd not in fa._HEAD_DIMS else 0
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
            fa.launches_padded) == (counts[0] + 2, counts[1] + 2,
                                    counts[2] + 2, counts[3] + padded)
    for got, (kk, vv, g) in zip(((o1, lse1), (o2, lse2)),
                                ((k1, v1, g1), (k2, v2, g2))):
        want = fa._forward_plain(q, kk, vv, g)
        for a, b in zip(got, want):
            assert _rel_err(a, b) <= tol
    delta = (do.float() * o.float()).sum(-1)
    for (dq, dk, dv), (kk, vv, g) in zip(grads, ((k1, v1, g1),
                                                 (k2, v2, g2))):
        want = (fa._dq_plain(q, kk, vv, do, lse, delta, g),
                *fa._dkv_plain(q, kk, vv, do, lse, delta, g))
        for a, b in zip((dq, dk, dv), want):
            assert bool(torch.isfinite(a).all()) and _rel_err(a, b) <= tol
    # the whole row at once: keys [past block, diagonal block], causal at
    # offset s (query i sees the past block and keys <= i of its own)
    kw, vw = torch.cat([k2, k1], 1), torch.cat([v2, v1], 1)
    gw = fa.FlashGeometry(hq=1, hkv=1, causal=causal, sm_scale=scale)
    if hd not in fa._HEAD_DIMS:
        (ow, lsew, _, dqw, dkw, dvw), _ = fa.padded_launch(q, kw, vw, do, gw)
    else:
        ow, lsew = fa.flash_attention_fwd(q, kw, vw, gw)
        dw = (do.float() * ow.float()).sum(-1)
        dqw = fa.flash_attention_dq(q, kw, vw, do, lsew, dw, gw)
        dkw, dvw = fa.flash_attention_dkv(q, kw, vw, do, lsew, dw, gw)
    assert _rel_err(o, ow) <= tol and _rel_err(lse, lsew) <= tol
    assert _rel_err(grads[0][0].float() + grads[1][0].float(), dqw) <= tol
    assert _rel_err(torch.cat([grads[1][1], grads[0][1]], 1), dkw) <= tol
    assert _rel_err(torch.cat([grads[1][2], grads[0][2]], 1), dvw) <= tol


@pytest.mark.cuda
def test_flash_block_calls_refuse_what_the_kernels_do_not_take(cuda_device):
    """No silent copy: a bf16 block one element into its storage is
    refused (TMA needs 16-byte aligned bases), as is a causal block with
    fewer keys than queries."""
    q = torch.randn(2, 64, 128, device=cuda_device, dtype=torch.bfloat16)
    buf = torch.zeros(q.numel() + 8, device=cuda_device, dtype=q.dtype)
    q_off = buf[1:1 + q.numel()].view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_block_fwd(q_off, q, q, False, 0.1)
    with pytest.raises(NotImplementedError):
        fa.flash_block_fwd(q, q[:, :32].contiguous(), q[:, :32].contiguous(),
                           True, 0.1)


@pytest.mark.cuda
def test_gloo_stages_cuda_tensors_through_the_host(cuda_device, tmp_path):
    """Gloo carries only broadcast and all-reduce for CUDA tensors: two
    ranks spawned over gloo on one card run send/recv, p2p_shift,
    all_gather (both forms) and all_to_all on CUDA tensors in f32 and
    bf16, staged through pinned host buffers, and get what the same
    calls give on CPU tensors, with the same bytes counted."""
    import pickle

    import paddle_tpu_torch.distributed as dist
    import torch_pp_worker as PW
    for device in ("cpu", "cuda"):
        dist.spawn(PW.gloo_staging_rank, args=(str(tmp_path), device),
                   nprocs=2)
    for r in range(2):
        got = {dev: pickle.loads((tmp_path / f"{dev}{r}.pkl").read_bytes())
               for dev in ("cpu", "cuda")}
        assert got["cuda"]["staged"] and not got["cpu"]["staged"]
        assert got["cuda"]["bytes"] == got["cpu"]["bytes"] > 0
        keys = [k for k in got["cpu"] if isinstance(k, tuple)]
        assert len(keys) == 10
        for k in keys:
            np.testing.assert_array_equal(got["cuda"][k], got["cpu"][k],
                                          err_msg=str(k))
        np.testing.assert_array_equal(got["cpu"]["send_recv", "float32"],
                                      np.arange(24).reshape(4, 6) +
                                      100 * (1 - r))


# ---- the layer, vision and paged-row leftovers: card against CPU ----------
def _cpu_and_card(fn, arrays, cuda_device, grad=(0,)):
    """``fn`` on CPU tensors and on their card copies: the outputs and the
    gradients of ``sum(out * cot)`` in ``arrays[i]`` for ``i`` in
    ``grad``, as numpy, CPU first."""
    res = []
    for dev in ("cpu", cuda_device):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(i in grad)
              for i, a in enumerate(arrays)]
        out = fn(*ts)
        if grad:
            cot = torch.from_numpy(np.random.RandomState(1).rand(
                *out.shape).astype(np.float32)).to(dev)
            (out * cot).sum().backward()
        res.append([out.detach().cpu().numpy()] +
                   [ts[i].grad.cpu().numpy() for i in grad])
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic", "area"])
@pytest.mark.parametrize("size", [(40, 52), (5, 7)], ids=["up", "down"])
def test_interpolate_on_the_card(cuda_device, mode, size):
    """``F.interpolate`` (the reference's ``jax.image.resize``) on the card
    equals the CPU's, forward and backward, up and antialiased down."""
    from paddle_tpu_torch.nn import functional as F
    x = np.random.RandomState(0).randn(2, 3, 10, 13).astype(np.float32)
    cpu, card = _cpu_and_card(lambda v: F.interpolate(v, size=size,
                                                      mode=mode),
                              [x], cuda_device)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "linear", "bicubic"])
@pytest.mark.parametrize("shape,size", [((2, 3, 11), (29,)),
                                        ((2, 3, 11), (4,)),
                                        ((1, 2, 5, 6, 7), (9, 4, 15)),
                                        ((1, 2, 5, 6, 7), (3, 13, 2))],
                         ids=["3d-up", "3d-down", "5d-mixed", "5d-mixed2"])
def test_interpolate_3d_and_5d_on_the_card(cuda_device, mode, shape, size):
    """The 3-D (a height-1 image) and 5-D (a plane pass, then a depth
    pass) resizes on the card equal the CPU's, forward and backward."""
    from paddle_tpu_torch.nn import functional as F
    if mode == "linear" and len(shape) == 5:
        mode = "trilinear"
    fmt = "NCW" if len(shape) == 3 else "NCDHW"
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    cpu, card = _cpu_and_card(lambda v: F.interpolate(
        v, size=size, mode=mode, data_format=fmt), [x], cuda_device)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_affine_grid_and_grid_sample_on_the_card(cuda_device, mode,
                                                 padding_mode):
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 16, 20).astype(np.float32)
    th = (np.eye(2, 3)[None] + 0.3 * rng.randn(2, 2, 3)).astype(np.float32)

    def run(v, t):
        return F.grid_sample(v, F.affine_grid(t, [2, 3, 12, 9]), mode,
                             padding_mode)
    cpu, card = _cpu_and_card(run, [x, th], cuda_device, grad=(0, 1))
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [2, -1])
def test_roi_align_and_roi_pool_on_the_card(cuda_device, ratio):
    """``roi_align`` forward and backward into the map, chunked over RoIs
    on both devices, and ``roi_pool``, on the card equal the CPU's."""
    from paddle_tpu_torch.vision import ops as V
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 30, 34).astype(np.float32)
    xy = rng.uniform(0, 90, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 60, (40, 2))],
                           1).astype(np.float32)
    num = torch.tensor([25, 15])
    cpu, card = _cpu_and_card(
        lambda v, b: V.roi_align(v, b, num.to(v.device), 7, 0.25, ratio),
        [x, boxes], cuda_device)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    cpu, card = _cpu_and_card(
        lambda v, b: V.roi_pool(v, b, num.to(v.device), 7, 0.25),
        [x, boxes], cuda_device, grad=())
    np.testing.assert_array_equal(card[0], cpu[0])


@pytest.mark.cuda
def test_nms_on_the_card(cuda_device):
    """The same kept indices on the card as on the CPU, with and without
    categories, score ties included."""
    from paddle_tpu_torch.vision import ops as V
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 200, (500, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 60, (500, 2))], 1).astype(np.float32))
    scores = torch.from_numpy(np.round(rng.rand(500) * 50).astype(
        np.float32))
    cats = torch.from_numpy(rng.randint(0, 8, 500))
    for kw in ({}, dict(category_idxs=cats, categories=[0, 1, 2, 5])):
        cpu = V.nms(boxes, 0.5, scores, **kw)
        card = V.nms(boxes.to(cuda_device), 0.5, scores.to(cuda_device),
                     **{k: (v.to(cuda_device) if torch.is_tensor(v) else v)
                        for k, v in kw.items()})
        assert card.device.type == "cuda" and card.dtype == torch.int64
        np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())


@pytest.mark.cuda
def test_paged_attention_step_on_the_card(cuda_device):
    """The per-row paged step (padded tails, GQA) on the card: the same
    output at the valid queries and the same pools as on the CPU."""
    from paddle_tpu_torch.ops import paged_attention as pa
    rng = np.random.RandomState(5)
    B, S, n_kv, grp, hd, bs = 3, 8, 2, 4, 64, 16
    q = rng.randn(B, S, n_kv * grp, hd).astype(np.float32)
    k = rng.randn(B, S, n_kv, hd).astype(np.float32)
    v = rng.randn(B, S, n_kv, hd).astype(np.float32)
    pools = rng.randn(2, 13, bs, n_kv, hd).astype(np.float32)
    bt = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    ctx = np.array([5, 0, 33], np.int32)
    new = np.array([8, 3, 0], np.int32)
    outs = []
    for dev in ("cpu", cuda_device):
        kp, vp = (torch.from_numpy(p.copy()).to(dev) for p in pools)
        out, kp, vp = pa.paged_attention_step(
            *(torch.from_numpy(a).to(dev) for a in (q, k, v)), kp, vp,
            *(torch.from_numpy(a).to(dev) for a in (bt, ctx, new)))
        outs.append([t.cpu().numpy() for t in (out, kp, vp)])
    (o_cpu, k_cpu, v_cpu), (o_card, k_card, v_card) = outs
    valid = np.arange(S)[None, :] < new[:, None]
    np.testing.assert_allclose(o_card[valid], o_cpu[valid], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(k_card[1:], k_cpu[1:])
    np.testing.assert_array_equal(v_card[1:], v_cpu[1:])
