"""Ragged paged attention (RPA) — port of
``paddle_tpu/ops/pallas/ragged_paged_attention.py``.

The kernel: ``csrc/ragged_paged_attention.cu``, CUDA C++ for ``sm_90a``,
replacing the Pallas TPU kernel ``_rpa_kernel`` (reference ``:159``,
launched from ``_rpa_call`` at ``:262``). It computes token-packed
ragged GQA attention over the block-paged KV pool:

    q              : [total_tokens, n_heads, hd]
    k_pool/v_pool  : [num_blocks + 1, block_size, n_kv, hd]  (block 0 null)
    block_tables   : [max_seqs + 1, max_blocks_per_seq] int32
    cu_seqlens     : [max_seqs + 2] int32
    context_lens   : [max_seqs + 1] int32
    step_seq/blk   : [num_q_tiles, max_steps] int32 (``build_step_maps``)

Its bound on the H100 is bytes: each live page read once per kv head,
plus q and the output (see the source's header for what the first
kernel does about it, and ``PERF.md`` for its times).

:func:`ragged_paged_attention` launches the kernel for CUDA tensors, or
raises; for CPU tensors it computes :func:`ragged_paged_attention_reference`,
the plain PyTorch version of the same function, which is also what
``chip_smoke.py`` holds the kernel against on the card. Its ``launches``
attribute counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "build_step_maps", "rpa_max_steps", "DEFAULT_TILE_Q"]

#: flat-token tile height of the port's kernel: one warp per score row,
#: and 8 tokens x Llama-3's GQA group of 4 = 32 rows = one full
#: 1024-thread block (the kernel takes up to 128 rows, 4 per warp)
DEFAULT_TILE_Q = 8

# finite stand-in for -inf (the reference's _MASK_VALUE, :82)
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_ROWS = 128  # kMaxWarps * kMaxRowsPerWarp in the source


def rpa_max_steps(tile_q: int, max_blocks_per_seq: int,
                  max_batch: int) -> int:
    """Static bound on the per-tile work-list length. A tile of
    ``tile_q`` tokens overlaps at most ``min(tile_q, max_batch)``
    sequences, and each streams at most ``max_blocks_per_seq`` pages.
    The pool's block count is no bound: with the prefix cache on, the
    sequences of one tile share pages, so their page lists together can
    be longer than the pool."""
    return max(1, min(tile_q, max_batch) * max_blocks_per_seq)


def build_step_maps(cu_seqlens, kv_lens, *, total_tokens, tile_q,
                    block_size, max_steps, max_seqs):
    """Host-side (numpy) kernel work list for one engine step.

    ``cu_seqlens``: int array ``[num_seqs + 1]`` — prefix sums of the
    LIVE sequences' new-token counts (packed order). ``kv_lens``: int
    array ``[num_seqs]`` — each sequence's total KV length after this
    step's writes (``context_len + new_len``).

    Returns ``(step_seq, step_blk)``, both ``[num_q_tiles, max_steps]``
    int32: for q tile ``j``, the live steps enumerate every
    ``(sequence, kv page)`` pair the tile's tokens attend over — pages
    only up to ``ceil(kv_len / block_size)``, i.e. only the real
    context — as a prefix of the row. Dead steps carry the ``max_seqs``
    sentinel (the all-null block-table row).
    """
    cu = np.asarray(cu_seqlens, np.int64)
    kv = np.asarray(kv_lens, np.int64)
    num_seqs = len(kv)
    if total_tokens % tile_q:
        raise ValueError(
            f"total_tokens {total_tokens} not a multiple of tile_q "
            f"{tile_q}")
    num_tiles = total_tokens // tile_q
    step_seq = np.full((num_tiles, max_steps), max_seqs, np.int32)
    step_blk = np.zeros((num_tiles, max_steps), np.int32)
    for j in range(num_tiles):
        lo, hi = j * tile_q, (j + 1) * tile_q
        used = 0
        for s in range(num_seqs):
            if cu[s] >= cu[s + 1] or cu[s + 1] <= lo or cu[s] >= hi:
                # no tokens at all (a new_len == 0 padding slot) or none
                # in this tile: contributes no work steps
                continue
            n_pages = -(-int(kv[s]) // block_size)
            if used + n_pages > max_steps:
                raise ValueError(
                    f"tile {j} needs {used + n_pages} kv steps > "
                    f"max_steps {max_steps} — the scheduler admitted "
                    f"more pages than the static bound (bug)")
            step_seq[j, used:used + n_pages] = s
            step_blk[j, used:used + n_pages] = np.arange(n_pages)
            used += n_pages
    return step_seq, step_blk


def _geometry(q, k_pool, step_seq):
    T, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    if n_heads % n_kv:
        raise ValueError(
            f"q heads {n_heads} must be a multiple of kv heads {n_kv}")
    num_tiles = step_seq.shape[0]
    if num_tiles == 0 or T % num_tiles:
        raise ValueError(
            f"step maps have {num_tiles} tiles for {T} tokens")
    return T, n_heads, hd, n_kv, n_heads // n_kv, T // num_tiles


def ragged_paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     cu_seqlens, context_lens, step_seq,
                                     step_blk, *, sm_scale=None):
    """Plain PyTorch version of the kernel: the same work lists, the same
    visibility rule, a dense softmax per q tile in float32. Outputs at
    rows that see no key (padding tokens) are exactly 0."""
    T, n_heads, hd, n_kv, group, tile_q = _geometry(q, k_pool, step_seq)
    bs = k_pool.shape[1]
    max_seqs = block_tables.shape[0] - 1
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    dev = q.device
    out = torch.zeros(T, n_heads, hd, dtype=q.dtype, device=dev)
    live = (step_seq < max_seqs).sum(dim=1).cpu().tolist()
    cu = cu_seqlens.long()
    ctx = context_lens.long()
    slots = torch.arange(bs, device=dev)
    for j, n in enumerate(live):
        if n == 0:
            continue
        seq = step_seq[j, :n].long()
        blk = step_blk[j, :n].long()
        phys = block_tables[seq, blk].long()
        k = k_pool[phys].float()                      # [n, bs, n_kv, hd]
        v = v_pool[phys].float()
        tok = j * tile_q + torch.arange(tile_q, device=dev)
        start = cu[seq]
        owned = (tok[None, :] >= start[:, None]) & \
            (tok[None, :] < cu[seq + 1][:, None])     # [n, tq]
        qpos = ctx[seq][:, None] + tok[None, :] - start[:, None]
        kpos = blk[:, None] * bs + slots[None, :]     # [n, bs]
        vis = owned[:, :, None] & (kpos[:, None, :] <= qpos[:, :, None])
        vis = vis.permute(1, 0, 2).reshape(tile_q, 1, 1, n * bs)
        qt = q[j * tile_q:(j + 1) * tile_q].float().reshape(
            tile_q, n_kv, group, hd)
        s = torch.einsum("tkgd,nbkd->tkgnb", qt, k).reshape(
            tile_q, n_kv, group, n * bs) * sm_scale
        s = torch.where(vis, s, torch.full_like(s, _MASK_VALUE))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * vis
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("tkgx,xkd->tkgd", p,
                         v.reshape(n * bs, n_kv, hd))
        o = o / torch.where(l == 0, torch.ones_like(l), l)
        out[j * tile_q:(j + 1) * tile_q] = o.reshape(
            tile_q, n_heads, hd).to(q.dtype)
    return out


def _check_cuda_inputs(q, k_pool, v_pool, meta):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"RPA kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"RPA kernel takes head_dim in {_HEAD_DIMS}, not "
                         f"{q.shape[-1]}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
    if q.dim() != 3 or q.stride(-1) != 1:
        raise ValueError("q must be [T, n_heads, hd] with a contiguous "
                         "last dim")
    for name, t in meta.items():
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             f"on {q.device}")


def _lib():
    lib = _build.load("ragged_paged_attention")
    fn = lib.rpa_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, I] + [P] * 9 + [I] * 8 + [L] * 4 + \
            [ctypes.c_float, P]
        fn.restype = I
        lib.rpa_error_string.argtypes = [I]
        lib.rpa_error_string.restype = ctypes.c_char_p
    return lib


def ragged_paged_attention(q, k_pool, v_pool, block_tables, cu_seqlens,
                           context_lens, step_seq, step_blk, *,
                           sm_scale=None):
    """GQA attention for a token-packed ragged batch over paged KV.

    ``q`` [total_tokens, n_heads, hd]; pools
    ``[num_blocks + 1, block_size, n_kv, hd]`` (this step's new K/V
    already scattered in — the kernel only reads); metadata as in the
    module docstring. Returns ``[total_tokens, n_heads, hd]`` in q's
    dtype; outputs at padding tokens are exactly 0.

    CUDA tensors launch the kernel (or raise); CPU tensors compute the
    plain version.
    """
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, block_tables, cu_seqlens, context_lens,
            step_seq, step_blk, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"RPA runs on cuda or cpu tensors, not {q.device}")
    T, n_heads, hd, n_kv, group, tile_q = _geometry(q, k_pool, step_seq)
    meta = {"block_tables": block_tables, "cu_seqlens": cu_seqlens,
            "context_lens": context_lens, "step_seq": step_seq,
            "step_blk": step_blk}
    _check_cuda_inputs(q, k_pool, v_pool, meta)
    if tile_q * group > _MAX_ROWS:
        raise ValueError(
            f"tile of {tile_q} tokens x GQA group {group} = "
            f"{tile_q * group} rows > the kernel's {_MAX_ROWS}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    out = torch.empty(T, n_heads, hd, dtype=q.dtype, device=q.device)
    lib = _lib()
    num_tiles, max_steps = step_seq.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rpa_launch(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(),
            cu_seqlens.data_ptr(), context_lens.data_ptr(),
            step_seq.data_ptr(), step_blk.data_ptr(), out.data_ptr(),
            num_tiles, tile_q, group, k_pool.shape[1], n_kv, max_steps,
            block_tables.shape[0] - 1, block_tables.shape[1],
            q.stride(0), q.stride(1), out.stride(0), out.stride(1),
            float(sm_scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"RPA kernel launch failed: "
            f"{lib.rpa_error_string(rc).decode()} (cudaError {rc})")
    ragged_paged_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0 (CPU calls, which
#: compute the plain version, do not count)
ragged_paged_attention.launches = 0
