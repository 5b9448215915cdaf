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
def test_rpa_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.RandomState(0)
    floats, ints, _ = _rpa_case(rng, [(3, 2)], 8, n_kv=1, grp=1, hd=64)
    q, kp, vp = [torch.from_numpy(a).to(cuda_device, torch.float32)
                 for a in floats]
    meta = [torch.from_numpy(a).to(cuda_device) for a in ints]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rpa.ragged_paged_attention(q.half(), kp.half(), vp.half(), *meta)
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention(q, kp, vp, meta[0].long(), *meta[1:])
    with pytest.raises(ValueError, match="head_dim"):
        rpa.ragged_paged_attention(q[..., :32], kp[..., :32],
                                   vp[..., :32], *meta)


def _rpa_bf16_args(rng, seqs, block_size, grp, hd, tile_q, device,
                   n_kv=2, shared=0):
    """bf16 card arguments of one step; the first ``shared`` pages of
    sequences 0 and 1 are the same physical pages (a shared prefix)."""
    mbps = max(-(-(n + c) // block_size) for n, c in seqs) + 1
    pages = sum(-(-(n + c) // block_size) for n, c in seqs)
    floats, ints, valid = _rpa_case(rng, seqs, block_size, n_kv=n_kv,
                                    grp=grp, hd=hd, tile_q=tile_q,
                                    mbps=mbps, pool_blocks=pages + 1)
    if shared:
        ints[0][1, :shared] = ints[0][0, :shared]
    args = [torch.from_numpy(a).to(device, torch.bfloat16) for a in floats] \
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
    _, info, items = rpa._rpa_bf16(*args, 1.0 / hd ** 0.5)
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
    (torch.bfloat16, 2e-2)])
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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_bhsd(q.half(), q.half(), q.half())


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
