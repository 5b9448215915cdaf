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
plus q and the output. In bf16 and f16 (one design, templated on the
element type) the kernel splits each q tile's step list
into chunks of at most :data:`MAX_CHUNKS` per tile (built on the
device; :func:`_rpa_items_plain` is its plain version), walks the (chunk, kv head) items persistently with
pages brought in by TMA and the products on the tensor cores, and merges
the chunks of a tile in a combine pass (:func:`_rpa_split_plain` is the
same arithmetic in plain PyTorch). In float32 it runs the first port's
FMA kernel. See the source's header and ``PERF.md`` for the times.
Like the TPU kernel, which allocates its output in q's dtype and takes
any float, the wrapper takes float32, bfloat16 and float16, and returns
q's dtype.

:func:`ragged_paged_attention` launches the kernel for CUDA tensors, or
raises; for CPU tensors it computes :func:`ragged_paged_attention_reference`,
the plain PyTorch version of the same function, which is also what
``chip_smoke.py`` holds the kernel against on the card. Its ``launches``
attribute counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from . import _build, counters

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "build_step_maps", "rpa_max_steps", "rpa_tile_q",
           "DEFAULT_TILE_Q", "MAX_CHUNKS"]

#: flat-token tile height of the engine's steps: of the reference's
#: candidates (8, 16, 32), the fastest serving step on the H100 (PERF.md);
#: the kernels take at most 128 rows of tile_q x GQA group
DEFAULT_TILE_Q = 8
#: the tiles ``rpa_tile_q`` sweeps (the reference's ``_TILE_CANDIDATES``)
_TILE_CANDIDATES = (8, 16, 32)

#: the bf16 kernel's split: a tile's live steps are cut into chunks of
#: max(MIN_CHUNK_KEYS / block_size pages, ceil(live / MAX_CHUNKS)) steps,
#: so a tile has at most MAX_CHUNKS chunks, which bounds the scratch of
#: the partial results (num_tiles x MAX_CHUNKS x n_kv x rows x (hd + 2)
#: floats) with no host-side count
MAX_CHUNKS = 16
MIN_CHUNK_KEYS = 128

# finite stand-in for -inf (the reference's _MASK_VALUE, :82)
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_WGMMA_BLOCK_SIZES = (8, 16, 32, 64)  # pages that tile a 64-key stage
_MAX_ROWS = 128  # rows of a q tile either kernel takes


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


def _min_pages(block_size):
    """The shortest chunk, in pages: MIN_CHUNK_KEYS keys, at least one
    page."""
    return max(1, MIN_CHUNK_KEYS // block_size)


def _max_chunks(max_steps, min_pages):
    """Chunks a tile may have: MAX_CHUNKS, fewer where no step list can
    fill them."""
    return max(1, min(MAX_CHUNKS, -(-max_steps // min_pages)))


def _rpa_items_plain(step_seq, max_seqs, min_pages, max_chunks):
    """The bf16/f16 kernel's work list, the plain version of the source's
    ``rpa_items_kernel``. A tile's live steps are its step list before the
    first sentinel; they are cut into chunks of ``max(min_pages,
    ceil(live / max_chunks))`` steps. Returns ``info`` int32 ``[4 *
    num_tiles + 1]`` (per tile: live steps, chunk length, its first chunk,
    its chunks; then the chunks of all tiles) and ``items`` int32
    ``[num_tiles * max_chunks]``, the tile of each chunk (entries past the
    count are unused)."""
    num_tiles, max_steps = step_seq.shape
    dead = step_seq >= max_seqs
    live = torch.where(dead.any(dim=1), dead.int().argmax(dim=1),
                       torch.full((num_tiles,), max_steps,
                                  device=step_seq.device)).long()
    length = torch.clamp(-(-live // max_chunks), min=min_pages)
    n = -(-live // length)
    first = torch.cumsum(n, 0) - n
    total = n.sum().reshape(1)
    info = torch.cat([torch.stack([live, length, first, n], 1).reshape(-1),
                      total]).to(torch.int32)
    items = torch.zeros(num_tiles * max_chunks, dtype=torch.int32,
                        device=step_seq.device)
    items[:int(total)] = torch.repeat_interleave(
        torch.arange(num_tiles, device=step_seq.device, dtype=torch.int32),
        n)
    return info, items


def _rpa_split_plain(q, k_pool, v_pool, block_tables, cu_seqlens,
                     context_lens, step_seq, step_blk, *, sm_scale=None,
                     min_pages=None, max_chunks=None):
    """The bf16/f16 kernel's arithmetic in plain PyTorch (f32): each (chunk,
    kv head) item of :func:`_rpa_items_plain` keeps per row the partial
    state ``(m, l, acc)`` over its chunk's pages (pages no row of the tile
    can see are skipped, as the kernel skips their loads), with p rounded
    to v's dtype before the value product as the TPU kernel does; the
    combine then merges a tile's chunks with the log-sum-exp rescale.
    Rows that see no key in any chunk, and tiles with no live step, are
    exactly 0."""
    T, n_heads, hd, n_kv, group, tile_q = _geometry(q, k_pool, step_seq)
    bs = k_pool.shape[1]
    max_seqs = block_tables.shape[0] - 1
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if min_pages is None:
        min_pages = _min_pages(bs)
    if max_chunks is None:
        max_chunks = _max_chunks(step_seq.shape[1], min_pages)
    info, _ = _rpa_items_plain(step_seq, max_seqs, min_pages, max_chunks)
    info = info.tolist()
    dev = q.device
    out = torch.zeros(T, n_heads, hd, dtype=q.dtype, device=dev)
    cu = cu_seqlens.long()
    ctx = context_lens.long()
    slots = torch.arange(bs, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for j in range(step_seq.shape[0]):
        live, length, _, n = info[4 * j:4 * j + 4]
        if n == 0:
            continue
        tok = j * tile_q + torch.arange(tile_q, device=dev)
        qt = q[j * tile_q:(j + 1) * tile_q].float().reshape(
            tile_q, n_kv, group, hd)
        parts = []
        for c in range(n):
            i0 = c * length
            seq = step_seq[j, i0:min(live, i0 + length)].long()
            blk = step_blk[j, i0:min(live, i0 + length)].long()
            start, end = cu[seq], cu[seq + 1]
            last_tok = torch.clamp(end, max=(j + 1) * tile_q) - 1
            keep = blk * bs <= ctx[seq] + last_tok - start
            seq, blk, start, end = seq[keep], blk[keep], start[keep], \
                end[keep]
            phys = block_tables[seq, blk].long()
            k = k_pool[phys].float()                    # [np, bs, n_kv, hd]
            v = v_pool[phys]
            owned = (tok[None, :] >= start[:, None]) & \
                (tok[None, :] < end[:, None])           # [np, tq]
            qpos = ctx[seq][:, None] + tok[None, :] - start[:, None]
            kpos = blk[:, None] * bs + slots[None, :]  # [np, bs]
            vis = owned[:, :, None] & (kpos[:, None, :] <= qpos[:, :, None])
            vis = vis.permute(1, 0, 2).reshape(tile_q, 1, 1, -1)
            sc = torch.einsum("tkgd,nbkd->tkgnb", qt, k).reshape(
                tile_q, n_kv, group, -1) * sm_scale
            sc = torch.where(vis, sc, neg_inf)
            m = sc.amax(dim=-1, keepdim=True) if sc.shape[-1] else \
                torch.full((tile_q, n_kv, group, 1), float("-inf"),
                           device=dev)
            p = torch.where(vis, torch.exp(sc - m), torch.zeros_like(sc))
            l = p.sum(dim=-1, keepdim=True)
            acc = torch.einsum("tkgx,xkd->tkgd",
                               p.to(v_pool.dtype).float(),
                               v.float().reshape(-1, n_kv, hd))
            parts.append((m, l, acc))
        m = torch.stack([x[0] for x in parts])
        l = torch.stack([x[1] for x in parts])
        acc = torch.stack([x[2] for x in parts])
        big = torch.where(l > 0, m, neg_inf).amax(dim=0)
        big = torch.where(torch.isinf(big), torch.zeros_like(big), big)
        wgt = torch.where(l > 0, torch.exp(m - big), torch.zeros_like(m))
        l_all = (l * wgt).sum(dim=0)
        o = (acc * wgt).sum(dim=0) / torch.where(
            l_all == 0, torch.ones_like(l_all), l_all)
        out[j * tile_q:(j + 1) * tile_q] = o.reshape(
            tile_q, n_heads, hd).to(q.dtype)
    return out


def _check_cuda_inputs(q, k_pool, v_pool, meta):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"RPA kernel takes float32, bfloat16 or float16, "
                        f"not {q.dtype}")
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


class _Params(ctypes.Structure):
    """The source's ``RpaParams``, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "k_pool", "v_pool", "block_tables", "cu", "ctx", "step_seq",
        "step_blk", "out", "info", "items", "part_acc", "part_ml")] + [
        (n, ctypes.c_longlong) for n in ("q_st", "q_sh", "o_st", "o_sh")] + [
        (n, ctypes.c_int) for n in (
            "num_tiles", "tile_q", "group", "block_size", "n_kv",
            "max_steps", "max_seqs", "bt_width", "head_dim", "pool_blocks",
            "min_pages", "max_chunks", "dtype")] + [
        ("sm_scale", ctypes.c_float)]


def _lib():
    lib = _build.load("ragged_paged_attention")
    fn = lib.rpa_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, I] + [P] * 9 + [I] * 8 + [L] * 4 + \
            [ctypes.c_float, P]
        fn.restype = I
        lib.rpa_wgmma_launch.argtypes = [ctypes.POINTER(_Params), P]
        lib.rpa_wgmma_launch.restype = I
        lib.rpa_error_string.argtypes = [I]
        lib.rpa_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc):
    if rc != 0:
        raise RuntimeError(
            f"RPA kernel launch failed: "
            f"{lib.rpa_error_string(rc).decode()} (cudaError {rc})")


def _rpa_wgmma(q, k_pool, v_pool, block_tables, cu_seqlens, context_lens,
               step_seq, step_blk, sm_scale):
    """The bf16/f16 design on the card (q's dtype picks the instance):
    the work list, the persistent wgmma kernel and the combine pass.
    Returns ``(out, info, items)``, the last two as
    :func:`_rpa_items_plain` gives them (``items`` past the count
    unwritten)."""
    T, n_heads, hd, n_kv, group, tile_q = _geometry(q, k_pool, step_seq)
    bs = k_pool.shape[1]
    if bs not in _WGMMA_BLOCK_SIZES:
        raise ValueError(f"the bf16/f16 RPA kernel takes block_size in "
                         f"{_WGMMA_BLOCK_SIZES}, not {bs}")
    # 8 elements of two bytes: a 16-byte TMA stride, in either dtype
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)) or \
            q.stride(0) % 8 or q.stride(1) % 8:
        raise ValueError("the bf16/f16 RPA kernel loads q and the pools by "
                         "TMA: their bases and q's token and head strides "
                         "must be 16-byte aligned")
    num_tiles, max_steps = step_seq.shape
    rows = tile_q * group
    min_pages = _min_pages(bs)
    max_chunks = _max_chunks(max_steps, min_pages)
    dev = q.device
    info = torch.empty(4 * num_tiles + 1, dtype=torch.int32, device=dev)
    items = torch.empty(num_tiles * max_chunks, dtype=torch.int32,
                        device=dev)
    n_part = num_tiles * max_chunks * n_kv * rows
    part_acc = torch.empty(n_part * hd, dtype=torch.float32, device=dev)
    part_ml = torch.empty(n_part * 2, dtype=torch.float32, device=dev)
    out = torch.empty(T, n_heads, hd, dtype=q.dtype, device=dev)
    params = _Params(
        q=q.data_ptr(), k_pool=k_pool.data_ptr(), v_pool=v_pool.data_ptr(),
        block_tables=block_tables.data_ptr(), cu=cu_seqlens.data_ptr(),
        ctx=context_lens.data_ptr(), step_seq=step_seq.data_ptr(),
        step_blk=step_blk.data_ptr(), out=out.data_ptr(),
        info=info.data_ptr(), items=items.data_ptr(),
        part_acc=part_acc.data_ptr(), part_ml=part_ml.data_ptr(),
        q_st=q.stride(0), q_sh=q.stride(1), o_st=out.stride(0),
        o_sh=out.stride(1), num_tiles=num_tiles, tile_q=tile_q,
        group=group, block_size=bs, n_kv=n_kv, max_steps=max_steps,
        max_seqs=block_tables.shape[0] - 1, bt_width=block_tables.shape[1],
        head_dim=hd, pool_blocks=k_pool.shape[0], min_pages=min_pages,
        max_chunks=max_chunks, dtype=_DTYPE_CODE[q.dtype],
        sm_scale=float(sm_scale))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib, lib.rpa_wgmma_launch(ctypes.byref(params), stream))
    return out, info, items


def ragged_paged_attention(q, k_pool, v_pool, block_tables, cu_seqlens,
                           context_lens, step_seq, step_blk, *,
                           sm_scale=None):
    """GQA attention for a token-packed ragged batch over paged KV.

    ``q`` [total_tokens, n_heads, hd]; pools
    ``[num_blocks + 1, block_size, n_kv, hd]`` (this step's new K/V
    already scattered in — the kernel only reads); metadata as in the
    module docstring. Returns ``[total_tokens, n_heads, hd]`` in q's
    dtype; outputs at padding tokens are exactly 0.

    CUDA tensors launch the kernel (or raise): bf16 and f16 the split
    wgmma design, f32 the FMA kernel. CPU tensors compute the plain
    version. Every launch counts in ``launches``; the f16 ones also in
    ``launches_f16``.
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
    if q.dtype != torch.float32:
        out = _rpa_wgmma(q, k_pool, v_pool, block_tables, cu_seqlens,
                         context_lens, step_seq, step_blk, sm_scale)[0]
        _count_launch(q.dtype == torch.float16)
        return out
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
    _raise_on(lib, rc)
    _count_launch(False)
    return out


_count_lock = threading.Lock()
_thread_counts = threading.local()


def _count_launch(f16: bool):
    """One launch of the kernel: the process-wide counts, under a lock
    (two serving engines launch from two threads), and the calling
    thread's own count (:func:`thread_launches`)."""
    with _count_lock:
        ragged_paged_attention.launches += 1
        if f16:
            ragged_paged_attention.launches_f16 += 1
    _thread_counts.launches = getattr(_thread_counts, "launches", 0) + 1


def thread_launches() -> int:
    """The kernel launches made on the calling thread so far: a serving
    engine reads it around its step to count its own launches."""
    return getattr(_thread_counts, "launches", 0)


#: kernel launches since the count was last set to 0 (CPU calls, which
#: compute the plain version, do not count)
ragged_paged_attention.launches = 0
#: the serving step's calls at a head_dim zero-padded to an instance's
#: (``ops.paged_attention._pad_to_kernel_head_dim``)
ragged_paged_attention.launches_padded = 0
#: the launches of the float16 instances (also counted in ``launches``)
ragged_paged_attention.launches_f16 = 0
counters.register(__name__, "ragged_paged_attention.launches",
                  "ragged_paged_attention.launches_padded",
                  "ragged_paged_attention.launches_f16")


def rpa_tile_q(budget_tokens, n_heads, n_kv, head_dim, block_size,
               max_blocks_per_seq, pool_blocks, dtype="float32", *,
               device=None, default=DEFAULT_TILE_Q) -> int:
    """The flat-token tile height for an engine at this signature
    (reference :313-373): ``default``, or with ``FLAGS_use_autotune`` on
    the card the winner of a sweep over ``(8, 16, 32)``, measured once
    per signature and cached (``autotune.py``). The candidates are those
    the kernel takes, ``tile_q x (n_heads / n_kv) <= 128`` rows. Each is
    timed on the reference's synthetic mix: one prefill chunk over half
    the rounded budget, and decode rows for the rest with a page of
    context each, over a zero pool of ``pool_blocks`` pages; a head_dim
    without an instance is timed at the one the serving step pads it to.
    ``device`` is where the engine runs (``None``: the card); for the CPU
    it returns ``default`` and sweeps nothing. The engine rounds its
    budget up to a multiple of the tile, so any candidate is legal."""
    from paddle_tpu_torch.core.flags import flag
    if not flag("use_autotune"):
        return default
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return default
    from .autotune import autotune

    group = int(n_heads) // int(n_kv)
    hd_k = next((h for h in _HEAD_DIMS if h >= int(head_dim)), int(head_dim))
    tdtype = getattr(torch, str(dtype))
    sig = (int(budget_tokens), int(n_heads), int(n_kv), int(head_dim),
           int(block_size), int(max_blocks_per_seq), int(pool_blocks),
           str(dtype))
    cands = [t for t in _TILE_CANDIDATES if t * group <= _MAX_ROWS]

    def build(tile):
        T = -(-int(budget_tokens) // tile) * tile
        max_seqs = max(2, min(T, 8))
        max_steps = rpa_max_steps(tile, max_blocks_per_seq, max_seqs)
        n_dec = min(max_seqs - 1, max(1, T // 2))
        new_lens = [T - n_dec] + [1] * n_dec
        ctx = [0] + [block_size] * n_dec
        cu = np.zeros(max_seqs + 2, np.int32)
        cu[1:len(new_lens) + 1] = np.cumsum(new_lens)
        cu[len(new_lens) + 1:] = cu[len(new_lens)]
        ctx_arr = np.zeros(max_seqs + 1, np.int32)
        ctx_arr[:len(ctx)] = ctx
        kv_lens = [n + c for n, c in zip(new_lens, ctx)]
        bt = np.zeros((max_seqs + 1, max_blocks_per_seq), np.int32)
        nxt = 1
        for s, kv in enumerate(kv_lens):
            n_pages = -(-kv // block_size)
            bt[s, :n_pages] = np.arange(nxt, nxt + n_pages)
            nxt += n_pages
        if nxt - 1 > pool_blocks:
            raise ValueError("the synthetic mix needs more pages than the "
                             "pool holds")
        ssq, sbk = build_step_maps(
            cu[:len(new_lens) + 1], kv_lens, total_tokens=T, tile_q=tile,
            block_size=block_size, max_steps=max_steps, max_seqs=max_seqs)
        meta = [torch.from_numpy(a).to(dev)
                for a in (bt, cu, ctx_arr, ssq, sbk)]
        q = torch.zeros(T, n_heads, hd_k, dtype=tdtype, device=dev)
        pool = torch.zeros(pool_blocks + 1, block_size, n_kv, hd_k,
                           dtype=tdtype, device=dev)
        return lambda: ragged_paged_attention(q, pool, pool, *meta)

    return autotune("ragged_paged_attention", sig, cands, build, default)
