"""Block-paged KV-cache attention — port of
``paddle_tpu/ops/paged_attention.py``.

The serving engine stores each layer's KV cache as a pool of fixed-size
token blocks:

    k_pool / v_pool : [num_blocks + 1, block_size, n_kv, hd]
                      (block 0 is the reserved null block)

and runs every step over a flat token axis holding all scheduled
sequences' new tokens back to back (:class:`RaggedLayerCache`). The
per-row form (:class:`PagedLayerCache`, reference :61-147) is for
callers outside the engine: ``[B, S]`` inputs with right padding, each
row's new tokens counted by ``new_lens``, read by
:func:`paged_attention_step` through the gather path, as in the
reference. Two read paths share the token-packed layout:

* **rpa** — the ragged-paged-attention kernel
  (``ops/pallas/ragged_paged_attention.py``): on CUDA tensors the
  hand-written CUDA kernel, on CPU tensors its plain version;
* **gather** — gather every sequence's whole padded context and run a
  dense masked softmax (:func:`ragged_gather_attention`), the parity
  oracle. It is chosen only by an explicit ``attn_impl="gather"``, or
  by ``attn_impl=None`` under :func:`paged_attention_impl`, which reads
  :func:`impl_override` and never the reference's
  ``PADDLE_TPU_PAGED_ATTN_IMPL``.

Unlike the reference, the pools are updated **in place**: the JAX step
threads them functionally (pools in, pools out), which in PyTorch would
copy every layer's pool every step and double the cache's memory.

int8 KV (reference :150-399): with scale pools in the cache
(``k_scale``/``v_scale``, ``[num_blocks + 1, block_size, n_kv]`` f32),
the step quantizes the new K/V per (token, kv head)
(:func:`quantize_kv_slots`), scatters values and scales into their pools
in place (:func:`write_kv_scales_to_pool`) and reads through the gather
path, which dequantizes the gathered context in f32. The RPA kernel reads
unquantized pools only: an int8 pool on the ``rpa`` path raises.

Tensor parallelism (reference :218-243, :367-391): the serving engine
pins its mesh with :func:`mesh_override` around its step, and
:func:`_tp_mesh` reads it, under the reference's names. The reference
``shard_map``s the kernel over the ``mp`` shards of q and of the pools;
here each process is one rank whose model already holds its
``n_heads/mp`` query and ``n_kv/mp`` KV heads, and whose pools hold the
same KV heads (the engine builds them so), so the kernel runs once on
the local heads with its arguments unchanged. Whole GQA groups stay on
one rank (both counts split by the same factor), so the group size is
unchanged; the step checks that the local heads form whole groups.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import torch

__all__ = ["PagedLayerCache", "RaggedLayerCache", "write_to_pool",
           "write_tokens_to_pool", "gather_pool", "paged_attention_step",
           "ragged_gather_attention", "ragged_paged_attention_step",
           "paged_attention_impl", "impl_override", "mesh_override",
           "quantize_kv_slots", "write_kv_scales_to_pool"]


class PagedLayerCache(NamedTuple):
    """One layer's view of the paged KV state in the per-row form: the
    pools are per layer, ``block_tables`` ``[B, max_blocks_per_seq]``
    int32, ``context_lens`` ``[B]`` (tokens already cached) and
    ``new_lens`` ``[B]`` (valid tokens of this call's ``[B, S]`` input)
    shared by the layers."""
    k_pool: torch.Tensor        # [num_blocks + 1, block_size, n_kv, hd]
    v_pool: torch.Tensor        # [num_blocks + 1, block_size, n_kv, hd]
    block_tables: torch.Tensor  # [B, max_blocks_per_seq] int32
    context_lens: torch.Tensor  # [B] int32
    new_lens: torch.Tensor      # [B] int32


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
    # int8-KV scale pools, paged like the value pools; None when the
    # pools hold the model's dtype
    k_scale: torch.Tensor = None  # [num_blocks + 1, block_size, n_kv] f32
    v_scale: torch.Tensor = None  # [num_blocks + 1, block_size, n_kv] f32


_impl_local = threading.local()


def paged_attention_impl() -> str:
    """The read path of a token-packed step called with ``attn_impl=None``:
    an :func:`impl_override` in effect on this thread, else ``"rpa"``
    when a CUDA card is visible and ``"gather"`` otherwise (reference
    :180-196, which reads ``PADDLE_TPU_PAGED_ATTN_IMPL`` between the two;
    the port reads no environment)."""
    override = getattr(_impl_local, "value", None)
    if override is not None:
        return override
    return "rpa" if torch.cuda.is_available() else "gather"


@contextlib.contextmanager
def impl_override(value):
    """Pin :func:`paged_attention_impl` for the calls inside the block on
    this thread; ``None`` pins nothing (the default applies inside, as
    the reference's clears an outer pin)."""
    if value is not None and value not in ("rpa", "gather"):
        raise ValueError(f"attn impl {value!r} (want rpa|gather|None)")
    prev = getattr(_impl_local, "value", None)
    _impl_local.value = value
    try:
        yield
    finally:
        _impl_local.value = prev


@contextlib.contextmanager
def mesh_override(mesh):
    """Pin a tensor-parallel mesh for the ragged calls inside the block
    on this thread (``None`` = one device, a no-op); the serving engine
    wraps its step in it."""
    prev = getattr(_impl_local, "mesh", None)
    _impl_local.mesh = mesh
    try:
        yield
    finally:
        _impl_local.mesh = prev


def _tp_mesh():
    """``(mesh, mp axis name)`` when a mesh with a model axis of more than
    one rank is pinned on this thread, else None."""
    mesh = getattr(_impl_local, "mesh", None)
    if mesh is None:
        return None
    from paddle_tpu_torch.distributed.fleet.mpu import _mp_axis
    from paddle_tpu_torch.distributed.mesh import axis_size
    try:
        axis = _mp_axis(mesh)
    except ValueError:
        return None
    return (mesh, axis) if axis_size(mesh, axis) > 1 else None


def _slots(pool, block_tables, seq_ids, positions):
    """(physical block, slot) of each token: its position through its
    sequence's block-table row; padding tokens (sentinel ``seq_ids`` ->
    the all-null table row) land in (null block 0, slot 0)."""
    bs, nblk = pool.shape[1], block_tables.shape[1]
    pos = positions.long()
    blk = torch.clamp(pos // bs, 0, nblk - 1)
    phys = block_tables[seq_ids.long(), blk].long()
    slot = torch.where(phys == 0, torch.zeros_like(pos), pos % bs)
    return phys, slot


def write_tokens_to_pool(pool, new, block_tables, seq_ids, positions):
    """Scatter ``new`` [T, n_kv, hd] into ``pool`` **in place** at each
    token's ``positions`` through its sequence's block-table row, and
    return the pool. Padding tokens (sentinel ``seq_ids`` -> the all-null
    table row) all land in (null block 0, slot 0); which of them wins
    does not matter, since no live step reads the null block."""
    phys, slot = _slots(pool, block_tables, seq_ids, positions)
    pool[phys, slot] = new.to(pool.dtype)
    return pool


def quantize_kv_slots(x):
    """Symmetric per-token, per-head int8 quantization of KV rows:
    ``x [..., n_kv, hd]`` -> ``(q int8 [..., n_kv, hd], scale f32
    [..., n_kv])`` with scale = max(absmax, 1e-8) / 127 (the dequant
    multiplier), rounded half to even and clipped to +-127 as the
    reference's ``jnp.round`` and ``jnp.clip``."""
    f = x.float()
    absmax = f.abs().amax(dim=-1)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def write_kv_scales_to_pool(scale_pool, scales, block_tables, seq_ids,
                            positions):
    """Scatter per-token dequant ``scales`` [T, n_kv] into the paged
    scale pool **in place**, at the (physical block, slot) the quantized
    values landed in (padding to the null block), and return it."""
    phys, slot = _slots(scale_pool, block_tables, seq_ids, positions)
    scale_pool[phys, slot] = scales.to(scale_pool.dtype)
    return scale_pool


def gather_pool(pool, block_tables):
    """[rows, max_blocks_per_seq * block_size, n_kv, hd] contiguous copy
    of each table row's paged context (the gather read path of both
    forms: a row is a sequence of the per-row batch, or of the
    token-packed step's table)."""
    g = pool[block_tables.long()]  # [rows, nblk, bs, n_kv, hd]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *pool.shape[2:])


def write_to_pool(pool, new, block_tables, positions, valid):
    """Scatter ``new`` [B, S, n_kv, hd] into ``pool`` **in place** at the
    logical ``positions`` [B, S] through ``block_tables``, and return the
    pool. Tokens with ``valid`` False land in (null block 0, slot 0)."""
    bs, nblk = pool.shape[1], block_tables.shape[1]
    pos = positions.long()
    blk = torch.clamp(pos // bs, 0, nblk - 1)
    phys = torch.gather(block_tables.long(), 1, blk)
    zero = torch.zeros_like(pos)
    phys = torch.where(valid, phys, zero)
    slot = torch.where(valid, pos % bs, zero)
    pool[phys, slot] = new.to(pool.dtype)
    return pool


def paged_attention_step(q, k, v, k_pool, v_pool, block_tables,
                         context_lens, new_lens, *, scale=None):
    """One attention step over the per-row paged cache (reference
    :87-131). ``q`` [B, S, n_heads, hd] and ``k``/``v`` [B, S, n_kv, hd]
    are this call's position-encoded projections (``S`` the chunk length,
    1 in decode). The new K/V go into the pools in place (tokens past
    ``new_lens`` to the null block); then each row's whole paged context
    is gathered and attended with key ``l`` visible to query ``i`` of row
    ``b`` iff ``l <= context_lens[b] + i``, softmax in f32. Returns
    ``(out [B, S, n_heads * hd], k_pool, v_pool)``; outputs at padded
    queries are garbage, for the caller to discard."""
    B, S, n_kv, hd = k.shape
    n_heads = q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    ar = torch.arange(S, device=q.device)
    pos = context_lens.long()[:, None] + ar[None, :]        # [B, S]
    valid = ar[None, :] < new_lens.long()[:, None]
    write_to_pool(k_pool, k, block_tables, pos, valid)
    write_to_pool(v_pool, v, block_tables, pos, valid)
    keys = gather_pool(k_pool, block_tables)                # [B, L, ...]
    vals = gather_pool(v_pool, block_tables)
    L = keys.shape[1]
    qg = q.reshape(B, S, n_kv, n_heads // n_kv, hd)
    s = torch.einsum("bskgh,blkh->bskgl", qg.float(), keys.float()) * scale
    visible = torch.arange(L, device=q.device)[None, None, :] <= \
        pos[:, :, None]                                     # [B, S, L]
    s = s.masked_fill(~visible[:, :, None, None, :],
                      torch.finfo(torch.float32).min)
    w = torch.softmax(s, dim=-1).to(vals.dtype)
    out = torch.einsum("bskgl,blkh->bskgh", w, vals)
    return out.reshape(B, S, n_heads * hd), k_pool, v_pool


def ragged_gather_attention(q, k_pool, v_pool, block_tables, seq_ids,
                            positions, *, scale, k_scale=None,
                            v_scale=None):
    """Token-packed GQA attention through the gather path: gather every
    sequence's whole padded context, pick each token's row, dense masked
    softmax. Costs the ``[T, L_max, n_kv, hd]`` materialisation the
    kernel removes; outputs at padding tokens are garbage. With int8
    pools (``k_scale``/``v_scale`` given) the gathered context is
    dequantized in f32 and the result is f32."""
    T, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    grp = n_heads // n_kv
    keys = gather_pool(k_pool, block_tables)   # [max_seqs+1, L, n_kv, hd]
    vals = gather_pool(v_pool, block_tables)
    sid = seq_ids.long()
    kt, vt = keys[sid], vals[sid]              # [T, L, n_kv, hd]
    if k_scale is not None:
        # the scale pools page and gather like the value pools
        ksc = gather_pool(k_scale, block_tables)[sid]  # [T, L, n_kv]
        vsc = gather_pool(v_scale, block_tables)[sid]
        kt = kt.float() * ksc[..., None]
        vt = vt.float() * vsc[..., None]
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


def _pad_to_kernel_head_dim(q, k_pool, v_pool):
    """On the card, a head_dim the RPA kernel has no instance for (a
    test-size model's 16, say) zero-padded to the next instance's, as
    ``flash_attention_bhsd`` pads K1-K3: zero columns of q and k leave
    every score as it was (the scale is the caller's), and the padded
    columns of v give output columns the step slices off. The pools are
    copied each call, so only small models should take this path; the
    calls are counted in ``ragged_paged_attention.launches_padded``."""
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    hd = q.shape[-1]
    if q.device.type != "cuda" or hd in rpa._HEAD_DIMS:
        return q, k_pool, v_pool
    width = next((w for w in rpa._HEAD_DIMS if w > hd), None)
    if width is None:
        return q, k_pool, v_pool  # the kernel's wrapper refuses it
    rpa.ragged_paged_attention.launches_padded += 1
    pad = (0, width - hd)
    return tuple(torch.nn.functional.pad(t, pad) for t in (q, k_pool,
                                                           v_pool))


def ragged_paged_attention_step(q, k, v, k_pool, v_pool, block_tables,
                                cu_seqlens, context_lens, seq_ids,
                                positions, step_seq, step_blk, *,
                                scale=None, attn_impl="rpa", k_scale=None,
                                v_scale=None):
    """One unified serving step over the token-packed ragged layout.

    ``q`` [T, n_heads, hd] and ``k``/``v`` [T, n_kv, hd] are the
    (already position-encoded) projections of the step's flat tokens.
    Writes the new K/V into the pools in place (padding to the null
    block), then reads through the RPA kernel (``attn_impl="rpa"``; its
    plain version for CPU tensors) or the gather path (``None``: as
    :func:`paged_attention_impl` says). Returns
    ``out [T, n_heads * hd]``; outputs at padding tokens are garbage
    (gather) or 0 (rpa) and must be discarded by the caller.

    With int8 pools (``k_scale``/``v_scale`` scale pools given) the new
    K/V are quantized per (token, kv head), values and scales scattered
    in place, and the gather path dequantizes on the fly (the output
    comes back in q's dtype). Only ``attn_impl="gather"`` reads int8
    pools: ``"rpa"`` raises.
    """
    from paddle_tpu_torch.ops.pallas.ragged_paged_attention import \
        ragged_paged_attention

    T, n_heads, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if attn_impl is None:
        attn_impl = paged_attention_impl()
    if _tp_mesh() is not None and n_heads % k_pool.shape[2]:
        raise ValueError(
            f"this rank's {n_heads} query heads do not form whole GQA "
            f"groups over its {k_pool.shape[2]} KV heads")
    if k_scale is not None:
        if attn_impl != "gather":
            raise ValueError(
                "int8 KV pools are read by the gather path only: the RPA "
                "kernel reads unquantized pools (ServingEngine(kv_dtype="
                "'int8') pins attn_impl='gather')")
        kq, ks = quantize_kv_slots(k)
        vq, vs = quantize_kv_slots(v)
        write_tokens_to_pool(k_pool, kq, block_tables, seq_ids, positions)
        write_tokens_to_pool(v_pool, vq, block_tables, seq_ids, positions)
        write_kv_scales_to_pool(k_scale, ks, block_tables, seq_ids,
                                positions)
        write_kv_scales_to_pool(v_scale, vs, block_tables, seq_ids,
                                positions)
        out = ragged_gather_attention(
            q, k_pool, v_pool, block_tables, seq_ids, positions,
            scale=scale, k_scale=k_scale, v_scale=v_scale)
        return out.to(q.dtype).reshape(T, n_heads * hd)
    if k_pool.dtype == torch.int8:
        raise ValueError("an int8 KV pool needs its scale pools "
                         "(k_scale, v_scale)")
    write_tokens_to_pool(k_pool, k, block_tables, seq_ids, positions)
    write_tokens_to_pool(v_pool, v, block_tables, seq_ids, positions)
    if attn_impl == "rpa":
        q_in, kp, vp = _pad_to_kernel_head_dim(q, k_pool, v_pool)
        out = ragged_paged_attention(
            q_in, kp, vp, block_tables, cu_seqlens, context_lens,
            step_seq, step_blk, sm_scale=scale)[..., :hd]
    elif attn_impl == "gather":
        out = ragged_gather_attention(
            q, k_pool, v_pool, block_tables, seq_ids, positions,
            scale=scale)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} (want rpa|gather)")
    return out.reshape(T, n_heads * hd)
