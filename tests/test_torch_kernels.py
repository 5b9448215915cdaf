"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where PyTorch sees no
CUDA device: a CUDA kernel has no CPU mode. The file imports neither JAX
nor ``paddle_tpu``, so it also runs on a machine without them:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RPA kernel has no CPU mode")
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
        max_steps=rpa.rpa_max_steps(tile_q, mbps, pool_blocks),
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
