"""Block-paged KV-cache attention, token-packed form — port of
``paddle_tpu/ops/paged_attention.py``.

The serving engine stores each layer's KV cache as a pool of fixed-size
token blocks:

    k_pool / v_pool : [num_blocks + 1, block_size, n_kv, hd]
                      (block 0 is the reserved null block)

and runs every step over a flat token axis holding all scheduled
sequences' new tokens back to back (:class:`RaggedLayerCache`). Two read
paths share that layout:

* **rpa** — the ragged-paged-attention kernel
  (``ops/pallas/ragged_paged_attention.py``): on CUDA tensors the
  hand-written CUDA kernel, on CPU tensors its plain version;
* **gather** — gather every sequence's whole padded context and run a
  dense masked softmax (:func:`ragged_gather_attention`), the parity
  oracle. It is chosen only by an explicit ``attn_impl="gather"``.

Unlike the reference, the pools are updated **in place**: the JAX step
threads them functionally (pools in, pools out), which in PyTorch would
copy every layer's pool every step and double the cache's memory.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["RaggedLayerCache", "write_tokens_to_pool", "gather_pool",
           "ragged_gather_attention", "ragged_paged_attention_step"]


class RaggedLayerCache(NamedTuple):
    """One layer's view of the paged KV state in the token-packed form of
    the unified serving step. ``block_tables`` carries an extra all-null
    sentinel row (index ``max_seqs``) that padding tokens resolve
    through; the pools are per layer, the metadata shared."""
    k_pool: torch.Tensor        # [num_blocks + 1, block_size, n_kv, hd]
    v_pool: torch.Tensor        # [num_blocks + 1, block_size, n_kv, hd]
    block_tables: torch.Tensor  # [max_seqs + 1, max_blocks_per_seq] int32
    cu_seqlens: torch.Tensor    # [max_seqs + 2] int32 token-span prefix sums
    context_lens: torch.Tensor  # [max_seqs + 1] int32 cached tokens per seq
    seq_ids: torch.Tensor       # [T] int32 token -> sequence (max_seqs = pad)
    positions: torch.Tensor     # [T] int32 absolute position per token
    step_seq: torch.Tensor      # [num_q_tiles, max_steps] int32 work map
    step_blk: torch.Tensor      # [num_q_tiles, max_steps] int32 work map


def write_tokens_to_pool(pool, new, block_tables, seq_ids, positions):
    """Scatter ``new`` [T, n_kv, hd] into ``pool`` **in place** at each
    token's ``positions`` through its sequence's block-table row, and
    return the pool. Padding tokens (sentinel ``seq_ids`` -> the all-null
    table row) all land in (null block 0, slot 0); which of them wins
    does not matter, since no live step reads the null block."""
    bs, nblk = pool.shape[1], block_tables.shape[1]
    pos = positions.long()
    blk = torch.clamp(pos // bs, 0, nblk - 1)
    phys = block_tables[seq_ids.long(), blk].long()
    slot = torch.where(phys == 0, torch.zeros_like(pos), pos % bs)
    pool[phys, slot] = new.to(pool.dtype)
    return pool


def gather_pool(pool, block_tables):
    """[rows, max_blocks_per_seq * block_size, n_kv, hd] contiguous view
    of each table row's paged context (the gather read path)."""
    g = pool[block_tables.long()]  # [rows, nblk, bs, n_kv, hd]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *pool.shape[2:])


def ragged_gather_attention(q, k_pool, v_pool, block_tables, seq_ids,
                            positions, *, scale):
    """Token-packed GQA attention through the gather path: gather every
    sequence's whole padded context, pick each token's row, dense masked
    softmax. Costs the ``[T, L_max, n_kv, hd]`` materialisation the
    kernel removes; outputs at padding tokens are garbage."""
    T, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    grp = n_heads // n_kv
    keys = gather_pool(k_pool, block_tables)   # [max_seqs+1, L, n_kv, hd]
    vals = gather_pool(v_pool, block_tables)
    sid = seq_ids.long()
    kt, vt = keys[sid], vals[sid]              # [T, L, n_kv, hd]
    L = kt.shape[1]
    qg = q.reshape(T, n_kv, grp, hd)
    s = torch.einsum("tkgh,tlkh->tkgl", qg.float(), kt.float()) * scale
    visible = torch.arange(L, device=q.device)[None, :] <= \
        positions.long()[:, None]              # [T, L]
    s = s.masked_fill(~visible[:, None, None, :],
                      torch.finfo(torch.float32).min)
    w = torch.softmax(s, dim=-1).to(vt.dtype)
    out = torch.einsum("tkgl,tlkh->tkgh", w, vt)
    return out.reshape(T, n_heads, hd)


def ragged_paged_attention_step(q, k, v, k_pool, v_pool, block_tables,
                                cu_seqlens, context_lens, seq_ids,
                                positions, step_seq, step_blk, *,
                                scale=None, attn_impl="rpa"):
    """One unified serving step over the token-packed ragged layout.

    ``q`` [T, n_heads, hd] and ``k``/``v`` [T, n_kv, hd] are the
    (already position-encoded) projections of the step's flat tokens.
    Writes the new K/V into the pools in place (padding to the null
    block), then reads through the RPA kernel (``attn_impl="rpa"``; its
    plain version for CPU tensors) or the gather path. Returns
    ``out [T, n_heads * hd]``; outputs at padding tokens are garbage
    (gather) or 0 (rpa) and must be discarded by the caller.
    """
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import \
        ragged_paged_attention

    T, n_heads, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    write_tokens_to_pool(k_pool, k, block_tables, seq_ids, positions)
    write_tokens_to_pool(v_pool, v, block_tables, seq_ids, positions)
    if attn_impl == "rpa":
        out = ragged_paged_attention(
            q, k_pool, v_pool, block_tables, cu_seqlens, context_lens,
            step_seq, step_blk, sm_scale=scale)
    elif attn_impl == "gather":
        out = ragged_gather_attention(
            q, k_pool, v_pool, block_tables, seq_ids, positions,
            scale=scale)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} (want rpa|gather)")
    return out.reshape(T, n_heads * hd)
