"""Llama-3 family — port of ``paddle_tpu/models/llama.py``: serving,
training and eager generation.

Ported: the config and its presets, the RoPE table and rotation, the
token-packed block-paged forward that the serving engine's unified step
runs (reference ``LlamaAttention._ragged_paged_forward``, ``:392``), the
per-row block-paged forward (``_paged_forward``, :370), the
cacheless forward that training runs (flash attention, with segment ids
from ``attention_mask`` and per-token ``position_ids``), the eager
growing ``(k, v)`` cache of ``generate`` (reference :267-280: the past
keys and values concatenated with the new ones, then offset-causal
attention over them), the RMSNorm/SwiGLU decoder around them, the logits
head and the causal-LM loss (the fused chunked CE for a tied vocab of at
least 32768), the static-cache path of ``generate_compiled`` (reference
``_static_forward``, :283-351: preallocated ``[B, L, n_kv, hd]`` buffers
written in place at a position held on the card), recompute
(``cfg.recompute`` through ``distributed.fleet.utils.recompute``), the
int8-KV branch of the paged forward (:407-436: scale pools in the
cache), the numerics taps (:475-626) and tensor parallelism
(``tensor_parallel=True``, :143-149 and :515-523): the projections are
``distributed.fleet``'s column/row-parallel layers over the default
mesh's ``mp`` axis (each rank keeps its heads and its FFN columns, so
``n_heads``/``n_kv`` are the local counts and ``mp`` must divide the KV
heads), the embedding is vocab-parallel, and the loss is the
vocab-parallel cross entropy (the fused chunked CE with the row max, the
sum of exponentials and the target logit all-reduced over ``mp``). The
init draws every full weight and keeps this rank's block, so a
tensor-parallel model equals the one-device model of the same seed.

Parameter names and shapes equal the reference's, so a numpy state dict
moves between the packages unchanged (``utils/bridge.py``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import cast_for
from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.core.tensor import unwrap_args, wrap
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.containers import LayerList
from paddle_tpu_torch.nn.layer_base import Layer
from paddle_tpu_torch.observability import numerics
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.fused_ce import causal_lm_loss

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "apply_rotary",
           "apply_rotary_positions"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    tensor_parallel: bool = False
    recompute: bool = False

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-size config."""
        base = dict(vocab_size=256, hidden_size=64,
                    intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=128)
        base.update(kw)
        return LlamaConfig(**base)


# every projection is bias-free and starts at zero: the owning model's
# _init_weights draws the Llama recipe (or the bridge loads the weights)
_ZERO_NO_BIAS = dict(weight_attr=I.Constant(0.0), bias_attr=False)


def _make_linear(cfg, d_in, d_out, kind, *, device, dtype):
    """A bias-free projection (reference :143-157): ``kind`` "col" splits
    the output features over ``mp`` (its input replicated), "row" the
    input features (its output all-reduced)."""
    if not cfg.tensor_parallel:
        return Linear(d_in, d_out, device=device, dtype=dtype,
                      **_ZERO_NO_BIAS)
    from paddle_tpu_torch.distributed.fleet import (ColumnParallelLinear,
                                                    RowParallelLinear)
    kw = dict(weight_attr=I.Constant(0.0), has_bias=False, device=device,
              dtype=dtype)
    if kind == "col":
        return ColumnParallelLinear(d_in, d_out, gather_output=False, **kw)
    return RowParallelLinear(d_in, d_out, input_is_parallel=True, **kw)


@functools.lru_cache(maxsize=32)
def _rope_cache(seq_len: int, dim: int, theta: float):
    """cos/sin tables ``[seq_len, dim/2]`` built in float64 numpy exactly
    as the reference builds them, rounded once to float32 (the caller
    casts to the model dtype)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(t, inv)  # [S, dim/2]
    return (np.cos(freqs).astype(np.float32),
            np.sin(freqs).astype(np.float32))


def _rot_interleaved(t, cos, sin):
    """The reference's rotation convention: even/odd lane pairs, rotated
    and re-interleaved (not the HF half-split). ``cos``/``sin`` broadcast
    against ``t`` [..., H, D/2]."""
    t1, t2 = t[..., 0::2], t[..., 1::2]
    return torch.stack([t1 * cos - t2 * sin, t2 * cos + t1 * sin],
                       dim=-1).reshape(t.shape)


def _rope_table(n, dim, theta, like):
    """cos/sin ``[n, dim/2]`` in ``like``'s dtype on its device."""
    cos, sin = _rope_cache(n, dim, float(theta))
    return (torch.from_numpy(cos).to(like.device, like.dtype),
            torch.from_numpy(sin).to(like.device, like.dtype))


def apply_rotary(q, k, theta: float = 500000.0, pos_offset: int = 0,
                 table_len: int = 0):
    """Rotate q, k (``[B, S, H, D]``) at positions ``pos_offset ..
    pos_offset + S - 1`` (reference :107)."""
    s, d = q.shape[1], q.shape[-1]
    cos, sin = _rope_table(max(table_len, pos_offset + s), d, theta, q)
    cos = cos[None, pos_offset:pos_offset + s, None, :]
    sin = sin[None, pos_offset:pos_offset + s, None, :]
    return _rot_interleaved(q, cos, sin), _rot_interleaved(k, cos, sin)


def apply_rotary_positions(q, k, position_ids, theta: float = 500000.0,
                           table_len: int = 0):
    """Rotate q, k (``[B, S, H, D]``) at per-token positions
    ``position_ids`` ``[B, S]``, clipped to the table (reference :124):
    the packed-sequence form, where each document restarts at 0."""
    s, d = q.shape[1], q.shape[-1]
    n = max(table_len, s)
    cos, sin = _rope_table(n, d, theta, q)
    return _rotate_at(q, k, position_ids, cos, sin)


def _rotate_at(q, k, position_ids, cos, sin):
    pidx = torch.clamp(position_ids.long(), 0, cos.shape[0] - 1)
    cos, sin = cos[pidx][:, :, None, :], sin[pidx][:, :, None, :]
    return _rot_interleaved(q, cos, sin), _rot_interleaved(k, cos, sin)


def _rope_at_least(owner, n: int):
    """``owner``'s RoPE table (its ``rope_cos``/``rope_sin`` buffers), or,
    for a buffer longer than ``max_position_embeddings``, one of ``n``
    rows made once and kept on ``owner`` (so a CUDA graph that reads it
    never makes it)."""
    if n <= owner.rope_cos.shape[0]:
        return owner.rope_cos, owner.rope_sin
    ext = owner.__dict__.setdefault("_rope_ext", {})
    key = (n, owner.rope_cos.device, owner.rope_cos.dtype)
    if key not in ext:
        ext[key] = _rope_table(n, owner.rope_cos.shape[1] * 2,
                               owner.cfg.rope_theta, owner.rope_cos)
    return ext[key]


def run_cached_layers(owner, x, caches, attn_impl="rpa", attention_mask=None,
                      position_ids=None, pos_offsets=None):
    """The per-cache-kind layer loop of the cached trunks, shared by
    :class:`LlamaModel` and ``models.moe.MoeForCausalLM``: ``x`` the
    embedded ids, one cache per layer of ``owner.layers``, each layer
    called as ``layer(x, cache, rope, ...)`` under the numerics scope
    ``layers.{i}``. Returns ``(x, caches)``.

    - static ``(k_buf, v_buf, pos)`` triples (``generate_compiled``): the
      RoPE table at least as long as the buffers, with ``attention_mask``
      the ``[B, L]`` key liveness and ``pos_offsets`` the ``[B]`` RoPE
      shift; each layer returns its triple with ``pos + S``;
    - eager ``(past_k, past_v)`` pairs (``generate``): each layer returns
      its grown pair;
    - :class:`~paddle_tpu_torch.ops.paged_attention.RaggedLayerCache`
      (the serving step): the pools are written in place through
      ``attn_impl``'s read path, and the caches come back as they were;
    - :class:`~paddle_tpu_torch.ops.paged_attention.PagedLayerCache`
      (the per-row form): the pools are written in place and read through
      the gather path, and the caches come back as they were.

    ``position_ids`` is a cacheless argument and raises here; so do
    ``attention_mask`` and ``pos_offsets`` outside the static form (the
    eager and paged caches derive positions and liveness from
    themselves)."""
    if len(caches) != len(owner.layers):
        raise ValueError(
            f"caches has {len(caches)} entries for "
            f"{len(owner.layers)} layers")
    if position_ids is not None:
        raise NotImplementedError(
            "position_ids is a cacheless (packed training) argument")
    static = type(caches[0]) is tuple and len(caches[0]) == 3
    if static:
        rope = _rope_at_least(owner, caches[0][0].shape[1])
        kw = dict(attention_mask=attention_mask, pos_offsets=pos_offsets)
    elif attention_mask is not None or pos_offsets is not None:
        raise NotImplementedError(
            "attention_mask and pos_offsets are the static cache's "
            "arguments; the eager and paged caches derive positions and "
            "liveness from themselves")
    else:
        rope = (owner.rope_cos, owner.rope_sin)
        kw = {}
    paged = isinstance(caches[0], pa.RaggedLayerCache)
    new = []
    for i, (layer, c) in enumerate(zip(owner.layers, caches)):
        with numerics.scope(f"layers.{i}"):
            if paged:
                x = layer(x, c, rope, attn_impl)
            elif isinstance(c, pa.PagedLayerCache):
                x, c = layer(x, c, rope)
            else:
                x, c = layer(x, tuple(c), rope, **kw)
        new.append(c)
    return x, new


def _mp_of(cfg):
    """The model-parallel group of a tensor-parallel config, checked
    against its head counts."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.mpu import _mp_axis
    from paddle_tpu_torch.distributed.mesh import get_mesh
    mesh = get_mesh()
    group = C.Group((_mp_axis(mesh),), mesh)
    if cfg.num_key_value_heads % group.nranks:
        raise ValueError(f"the model-parallel degree {group.nranks} must "
                         f"divide num_key_value_heads "
                         f"{cfg.num_key_value_heads}")
    return group


class LlamaAttention(Layer):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        mk = functools.partial(_make_linear, cfg, device=device, dtype=dtype)
        hq = cfg.num_attention_heads * self.head_dim
        hkv = cfg.num_key_value_heads * self.head_dim
        self.q_proj = mk(cfg.hidden_size, hq, "col")
        self.k_proj = mk(cfg.hidden_size, hkv, "col")
        self.v_proj = mk(cfg.hidden_size, hkv, "col")
        self.o_proj = mk(hq, cfg.hidden_size, "row")
        # this rank's heads (all of them without tensor parallelism)
        self.n_heads = self.q_proj.weight.shape[1] // self.head_dim
        self.n_kv = self.k_proj.weight.shape[1] // self.head_dim

    def forward(self, x, cache: Optional[pa.RaggedLayerCache], rope,
                attn_impl: str = "rpa", attention_mask=None,
                position_ids=None, pos_offsets=None):
        """With a cache: token-packed block-paged attention. ``x`` [1, T,
        hidden] carries every scheduled sequence's new tokens back to
        back; RoPE at the cache's per-token positions; the new K/V go
        into the pools in place; the read path is the RPA kernel or the
        gather path.

        Without one (``cache=None``): causal flash attention over ``x``
        [B, S, hidden] (reference :243-266). ``attention_mask`` [B, S]
        (1 real / 0 pad, or a packer's segment ids) becomes the kernel's
        segment ids; ``position_ids`` [B, S] sets per-token RoPE
        positions.

        With an eager ``(past_k, past_v)`` pair (``(None, None)`` before
        the prompt): ``generate``'s growing cache, returning ``(out,
        (k_all, v_all))`` (reference :267-280).

        With a static ``(k_buf, v_buf, pos)`` triple: ``generate_compiled``'s
        fixed-shape cache (:meth:`_static_forward`); ``attention_mask`` is
        then the ``[B, L]`` key liveness over the buffers and
        ``pos_offsets`` the ``[B]`` per-row RoPE shift.

        With a :class:`~paddle_tpu_torch.ops.paged_attention.PagedLayerCache`:
        the per-row block-paged form (:meth:`_paged_forward`), returning
        ``(out, cache)``; ``attention_mask`` and ``pos_offsets`` raise, as
        in the reference (:223-229)."""
        if cache is None:
            return self._cacheless_forward(x, rope, attention_mask,
                                           position_ids)
        if type(cache) is tuple and len(cache) == 3 and \
                position_ids is None:
            return self._static_forward(x, cache, rope, attention_mask,
                                        pos_offsets)
        if isinstance(cache, pa.PagedLayerCache):
            if attention_mask is not None or pos_offsets is not None:
                raise NotImplementedError(
                    "the paged path derives per-row positions and key "
                    "liveness from the cache itself; attention_mask/"
                    "pos_offsets do not apply")
        if attention_mask is not None or position_ids is not None or \
                pos_offsets is not None:
            raise NotImplementedError(
                "the cached paths derive per-token positions and key "
                "liveness from the cache itself")
        if isinstance(cache, pa.PagedLayerCache):
            return self._paged_forward(x, cache, rope)
        if not isinstance(cache, pa.RaggedLayerCache):
            return self._eager_cache_forward(x, cache, rope)
        T = x.shape[1]
        hd = self.head_dim
        q = self.q_proj(x).reshape(T, self.n_heads, hd)
        k = self.k_proj(x).reshape(T, self.n_kv, hd)
        v = self.v_proj(x).reshape(T, self.n_kv, hd)
        cos_t, sin_t = rope
        pidx = torch.clamp(cache.positions.long(), 0, cos_t.shape[0] - 1)
        cos, sin = cos_t[pidx][:, None, :], sin_t[pidx][:, None, :]
        out = pa.ragged_paged_attention_step(
            _rot_interleaved(q, cos, sin), _rot_interleaved(k, cos, sin),
            v, cache.k_pool, cache.v_pool, cache.block_tables,
            cache.cu_seqlens, cache.context_lens, cache.seq_ids,
            cache.positions, cache.step_seq, cache.step_blk,
            scale=1.0 / math.sqrt(hd), attn_impl=attn_impl,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
        return self.o_proj(out.reshape(1, T, -1))

    def _paged_forward(self, x, cache, rope):
        """The per-row block-paged form (reference :370-390): ``x`` [B, S,
        hidden] with row ``b``'s first ``new_lens[b]`` tokens real; RoPE
        at positions ``context_lens[b] + i`` (clipped to the table); the
        new K/V written into the pools in place and each row's paged
        context read through the gather path
        (``paged_attention_step``). The cache comes back as it was: the
        caller advances ``context_lens``."""
        B, S = x.shape[0], x.shape[1]
        hd = self.head_dim
        q = self.q_proj(x).reshape(B, S, self.n_heads, hd)
        k = self.k_proj(x).reshape(B, S, self.n_kv, hd)
        v = self.v_proj(x).reshape(B, S, self.n_kv, hd)
        cos_t, sin_t = rope
        pidx = torch.clamp(cache.context_lens.long()[:, None] + torch.arange(
            S, device=x.device)[None, :], 0, cos_t.shape[0] - 1)
        cos, sin = cos_t[pidx][:, :, None, :], sin_t[pidx][:, :, None, :]
        out, _, _ = pa.paged_attention_step(
            _rot_interleaved(q, cos, sin), _rot_interleaved(k, cos, sin), v,
            cache.k_pool, cache.v_pool, cache.block_tables,
            cache.context_lens, cache.new_lens, scale=1.0 / math.sqrt(hd))
        return self.o_proj(out), cache

    def _static_forward(self, x, cache, rope, key_mask=None,
                        pos_offsets=None):
        """The fixed-shape cache of ``generate_compiled`` (reference
        :283-351): RoPE at positions ``pos .. pos + S - 1`` (``pos`` an
        int32 0-d tensor on the model's device, never read on the host),
        the new keys and values written into the ``[B, L, n_kv, hd]``
        buffers at those indices in place (``index_copy_``), then
        attention over the whole buffer in f32, masked to the causal
        bound and, for a ragged batch, to the ``[B, L]`` key liveness
        ``key_mask``, as the reference computes it outside its Pallas
        kernels. ``pos_offsets`` ``[B]`` shifts each row's RoPE
        positions (clipped to ``[0, L)``), so a left-padded row's first
        real token sits at position 0 while every row writes at the same
        buffer index. Returns ``(out, (k_buf, v_buf, pos + S))``."""
        B, S = x.shape[0], x.shape[1]
        hd = self.head_dim
        grp = self.n_heads // self.n_kv
        q = self.q_proj(x).reshape(B, S, self.n_heads, hd)
        k = self.k_proj(x).reshape(B, S, self.n_kv, hd)
        v = self.v_proj(x).reshape(B, S, self.n_kv, hd)
        k_buf, v_buf, pos = cache
        L = k_buf.shape[1]
        cos_t, sin_t = rope
        idx = pos.long() + torch.arange(S, device=x.device)  # [S]
        if key_mask is not None or pos_offsets is not None:
            po = torch.zeros(B, dtype=torch.long, device=x.device) \
                if pos_offsets is None else pos_offsets.long()
            pidx = torch.clamp(idx[None, :] - po[:, None], 0, L - 1)
            cos = cos_t[pidx][:, :, None, :]
            sin = sin_t[pidx][:, :, None, :]
        else:
            cos = cos_t[idx][None, :, None, :]
            sin = sin_t[idx][None, :, None, :]
        q, k = _rot_interleaved(q, cos, sin), _rot_interleaved(k, cos, sin)
        k_buf.index_copy_(1, idx, k.to(k_buf.dtype))
        v_buf.index_copy_(1, idx, v.to(v_buf.dtype))
        qg = q.reshape(B, S, self.n_kv, grp, hd).float()
        s = torch.einsum("bskgh,blkh->bskgl", qg, k_buf.float()) * \
            (1.0 / math.sqrt(hd))
        live = torch.arange(L, device=x.device)[None, :] <= idx[:, None]
        live = live[None] if key_mask is None else \
            live[None] & key_mask.bool()[:, None, :]  # [B|1, S, L]
        s = torch.where(live[:, :, None, None, :], s,
                        torch.finfo(torch.float32).min)
        w = torch.softmax(s, dim=-1).to(v_buf.dtype)
        out = torch.einsum("bskgl,blkh->bskgh", w, v_buf)
        return (self.o_proj(out.reshape(B, S, self.n_heads * hd)),
                (k_buf, v_buf, pos + S))

    def _eager_cache_forward(self, x, cache, rope):
        """RoPE at positions ``P .. P + S - 1`` after the ``P`` cached
        ones, the new keys and values appended to the past ones (a copy
        of the whole past each call, as the reference's ``concat``), and
        offset-causal attention: query j sees keys up to ``P + j``. That
        covers the prefill (P = 0) and each decode step (S = 1), through
        the flash forward kernel on the card."""
        B, S = x.shape[0], x.shape[1]
        hd = self.head_dim
        q = self.q_proj(x).reshape(B, S, self.n_heads, hd)
        k = self.k_proj(x).reshape(B, S, self.n_kv, hd)
        v = self.v_proj(x).reshape(B, S, self.n_kv, hd)
        past_k, past_v = cache
        P = 0 if past_k is None else past_k.shape[1]
        cos_t, sin_t = rope
        if P + S > cos_t.shape[0]:
            cos_t, sin_t = _rope_table(P + S, hd, self.cfg.rope_theta, x)
        cos = cos_t[None, P:P + S, None, :]
        sin = sin_t[None, P:P + S, None, :]
        q, k = _rot_interleaved(q, cos, sin), _rot_interleaved(k, cos, sin)
        if P:
            k = torch.cat([past_k, k], dim=1)
            v = torch.cat([past_v, v], dim=1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(B, S, -1)), (k, v)

    def _cacheless_forward(self, x, rope, attention_mask, position_ids):
        B, S = x.shape[0], x.shape[1]
        hd = self.head_dim
        q = self.q_proj(x).reshape(B, S, self.n_heads, hd)
        k = self.k_proj(x).reshape(B, S, self.n_kv, hd)
        v = self.v_proj(x).reshape(B, S, self.n_kv, hd)
        cos_t, sin_t = rope
        if S > cos_t.shape[0]:  # the reference's table covers max(S, max_pos)
            cos_t, sin_t = _rope_table(S, hd, self.cfg.rope_theta, x)
        if cos_t.dtype != q.dtype:  # amp: the reference's table is q's dtype
            cos_t, sin_t = cos_t.to(q.dtype), sin_t.to(q.dtype)
        if position_ids is not None:
            q, k = _rotate_at(q, k, position_ids, cos_t, sin_t)
        else:
            cos, sin = cos_t[None, :S, None, :], sin_t[None, :S, None, :]
            q, k = _rot_interleaved(q, cos, sin), _rot_interleaved(k, cos,
                                                                    sin)
        seg = None if attention_mask is None else attention_mask.int()
        # GQA served by the kernel: k and v stay at n_kv heads
        out = F.flash_attention(q, k, v, causal=True, q_segment_ids=seg,
                                kv_segment_ids=seg)
        return self.o_proj(out.reshape(B, S, -1))


class LlamaMLP(Layer):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        mk = functools.partial(_make_linear, cfg, device=device, dtype=dtype)
        self.gate_proj = mk(cfg.hidden_size, cfg.intermediate_size, "col")
        self.up_proj = mk(cfg.hidden_size, cfg.intermediate_size, "col")
        self.down_proj = mk(cfg.intermediate_size, cfg.hidden_size, "row")

    def forward(self, x):
        # numerics tap seam: the gated activation is where Llama-family
        # 16-bit ranges blow up first
        act = numerics.tap("mlp_act",
                           F.silu(self.gate_proj(x)) * self.up_proj(x))
        return self.down_proj(act)


class LlamaDecoderLayer(Layer):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size,
                                       epsilon=cfg.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, **kw)

    def forward(self, x, cache, rope, attn_impl="rpa", attention_mask=None,
                position_ids=None, pos_offsets=None):
        h = self.self_attn(self.input_layernorm(x), cache, rope,
                           attn_impl, attention_mask, position_ids,
                           pos_offsets)
        new_cache = None
        if isinstance(h, tuple):  # a returned cache: (out, new cache)
            h, new_cache = h
        x = x + numerics.tap("attn", h)
        x = x + numerics.tap("mlp",
                             self.mlp(self.post_attention_layernorm(x)))
        x = numerics.tap("resid", x)
        return x if new_cache is None else (x, new_cache)


class LlamaModel(Layer):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        if cfg.tensor_parallel:
            from paddle_tpu_torch.distributed.fleet import \
                VocabParallelEmbedding
            self.embed_tokens = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size,
                weight_attr=I.Constant(0.0), **kw)
        else:
            self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                          weight_attr=I.Constant(0.0), **kw)
        self.layers = LayerList(
            [LlamaDecoderLayer(cfg, **kw)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        # RoPE table at max_position_embeddings, cast to the model dtype
        # once and kept on the device (not state: no bridge name)
        cos, sin = _rope_cache(cfg.max_position_embeddings,
                               cfg.hidden_size // cfg.num_attention_heads,
                               float(cfg.rope_theta))
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(
            device=device, dtype=dtype), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(
            device=device, dtype=dtype), persistent=False)

    def forward(self, input_ids, caches: Optional[List] = None,
                attention_mask=None, position_ids=None,
                attn_impl: str = "rpa", pos_offsets=None):
        """Cacheless (``caches=None``, training): ``input_ids`` [B, S] ->
        final-norm hidden [B, S, hidden]; ``attention_mask`` [B, S] (1/0
        padding or packed segment ids) and ``position_ids`` [B, S] as in
        :meth:`LlamaAttention.forward`.

        Serving: ``input_ids`` [1, T] token-packed ids and one
        :class:`~paddle_tpu_torch.ops.paged_attention.RaggedLayerCache`
        per layer -> ``(final-norm hidden [1, T, hidden], caches)``. The
        pools inside the caches are updated in place.

        Per-row paged: ``input_ids`` [B, S] (right-padded) and one
        :class:`~paddle_tpu_torch.ops.paged_attention.PagedLayerCache` per
        layer -> ``(final-norm hidden [B, S, hidden], caches)``, the pools
        updated in place.

        Eager generation: ``input_ids`` [B, S] and one ``(past_k,
        past_v)`` pair per layer (``(None, None)`` before the prompt) ->
        ``(final-norm hidden [B, S, hidden], the grown pairs)``.

        Compiled generation: one static ``(k_buf, v_buf, pos)`` triple per
        layer (:meth:`LlamaAttention._static_forward`), with
        ``attention_mask`` the ``[B, L]`` key liveness over the buffers
        and ``pos_offsets`` the ``[B]`` RoPE shift of a left-padded batch
        -> ``(final-norm hidden, the triples with pos + S)``.

        With ``cfg.recompute`` in training mode the cacheless path runs
        each decoder layer under ``distributed.fleet.utils.recompute``
        (reference :546-553): its activations are recomputed in the
        backward instead of kept.

        Every path taps the numerics seam under the reference's names
        (:475-568): ``embed``, per layer (scope ``layers.{i}``) ``attn``,
        ``mlp_act``, ``mlp`` and ``resid``, and ``final_norm``; inside a
        recompute region the taps are suppressed and the layer's output
        is tapped as ``resid``."""
        rope = (self.rope_cos, self.rope_sin)
        if caches is None:
            if pos_offsets is not None:
                raise NotImplementedError(
                    "pos_offsets is an argument of the static-cache path")
            x = numerics.tap("embed", self.embed_tokens(input_ids))
            if self.cfg.recompute and self.training:
                from paddle_tpu_torch.distributed.fleet.utils import \
                    recompute
                for i, layer in enumerate(self.layers):
                    with numerics.scope(f"layers.{i}"):
                        with numerics.suppress():
                            x = recompute(layer, x, None, rope,
                                          attention_mask=attention_mask,
                                          position_ids=position_ids)
                        x = numerics.tap("resid", x)
                return numerics.tap("final_norm", self.norm(x))
            for i, layer in enumerate(self.layers):
                with numerics.scope(f"layers.{i}"):
                    x = layer(x, None, rope, attention_mask=attention_mask,
                              position_ids=position_ids)
            return numerics.tap("final_norm", self.norm(x))
        x = numerics.tap("embed", self.embed_tokens(input_ids))
        x, caches = run_cached_layers(self, x, caches, attn_impl,
                                      attention_mask, position_ids,
                                      pos_offsets)
        return numerics.tap("final_norm", self.norm(x)), caches


class LlamaForCausalLM(Layer):
    """Llama causal LM. ``device=None`` is the CUDA card; pass
    ``device="cpu"`` to build on the CPU. Weights start from the
    reference's init recipe drawn from a ``torch.Generator`` seeded with
    ``seed`` (they cannot match the JAX package's draws; parity goes
    through the numpy bridge instead)."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")
        device = resolve_device(device)
        dtype = convert_dtype(dtype)
        self.cfg = cfg
        self._mp = None
        if cfg.tensor_parallel:
            self._mp = _mp_of(cfg)
        self.model = LlamaModel(cfg, device=device, dtype=dtype)
        self.lm_head = None if cfg.tie_word_embeddings else _make_linear(
            cfg, cfg.hidden_size, cfg.vocab_size, "col", device=device,
            dtype=dtype)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, generator):
        """Llama recipe init: every 2-D weight (embedding, projections)
        ~ N(0, initializer_range); norms stay at ones. A tensor-parallel
        block draws its full weight and keeps its part, so every rank's
        stream, and the weights, equal the one-device model's."""
        from paddle_tpu_torch.distributed.mesh import local_block
        for _, p in self.named_parameters():
            if p.dim() != 2:
                continue
            spec = getattr(p, "_sharding_spec", None)
            if spec is None or self._mp is None or self._mp.nranks == 1:
                p.normal_(0.0, self.cfg.initializer_range,
                          generator=generator)
                continue
            mesh = p._sharding_mesh
            shape = [s * (self._mp.nranks if e is not None else 1)
                     for s, e in zip(p.shape, spec)]
            full = torch.empty(shape, dtype=p.dtype, device=p.device)
            full.normal_(0.0, self.cfg.initializer_range,
                         generator=generator)
            p.copy_(local_block(full, spec, mesh))

    # vocab size from which the fused chunked CE pays for itself (below
    # it the [T, V] logits are small and callers keep them)
    _FUSED_CE_MIN_VOCAB = 32768

    def forward(self, input_ids, labels=None, attention_mask=None,
                position_ids=None):
        """The cacheless causal LM (reference :599-640). Without
        ``labels``: the logits. With them (``labels == input_ids``; the
        shift happens here, position t predicts t+1; -100 is ignored): a
        tied head with a vocab of at least 32768 returns ``(None, loss)``
        through the fused chunked CE, which never builds the logits;
        otherwise ``(logits, loss)``."""
        h = self.model(input_ids, attention_mask=attention_mask,
                       position_ids=position_ids)
        if labels is not None and labels.shape[1] < 2:
            raise ValueError(
                "causal-LM loss needs sequences of length >= 2 (the "
                "internal shift leaves nothing to predict for length 1)")
        if labels is not None:
            # the loss is a mean over these tokens: a data-parallel step
            # weights each rank by its share of them
            from paddle_tpu_torch.distributed.parallel import \
                note_loss_tokens
            note_loss_tokens((labels[:, 1:] != -100).sum())
        mp = self._mp
        if (labels is not None and self.lm_head is None
                and self.cfg.vocab_size >= self._FUSED_CE_MIN_VOCAB):
            # the reference's op "fused_causal_ce": on neither amp list
            h, w = cast_for("fused_causal_ce", h,
                                self.model.embed_tokens.weight)
            if mp is None or mp.nranks == 1:
                return None, causal_lm_loss(h, w, labels)
            from paddle_tpu_torch.distributed.fleet.mpu import copy_to_group
            return None, causal_lm_loss(
                copy_to_group(h, mp), w, labels, group=mp,
                vocab_start=self.model.embed_tokens._start)
        if mp is None or mp.nranks == 1:
            logits = numerics.tap("logits", self._logits(h))
            if labels is None:
                return logits
            loss = F.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]),
                labels[:, 1:].reshape(-1))
            return logits, loss
        from paddle_tpu_torch.distributed.fleet.mpu import (
            _GatherFromGroup, vocab_parallel_ce)
        local = self._local_logits(h)
        logits = numerics.tap("logits", _GatherFromGroup.apply(local, mp))
        if labels is None:
            return logits
        tgt = labels[:, 1:].reshape(-1)
        per_tok = vocab_parallel_ce(
            local[:, :-1].reshape(-1, local.shape[-1]), tgt, mp,
            mp.rank * local.shape[-1])
        valid = (tgt != -100).sum().clamp(min=1)
        return logits, per_tok.sum() / valid.to(per_tok.dtype)

    def _local_logits(self, h):
        """This rank's columns of the logits (all of them without tensor
        parallelism)."""
        if self.lm_head is not None:
            return self.lm_head(h)
        if self._mp is not None and self._mp.nranks > 1:
            from paddle_tpu_torch.distributed.fleet.mpu import copy_to_group
            h = copy_to_group(h, self._mp)
        # the reference's ops.matmul: a white-list op under amp
        h, w = cast_for("matmul", h, self.model.embed_tokens.weight)
        return torch.matmul(h, w.t())

    def _logits(self, h):
        local = self._local_logits(h)
        if self._mp is None or self._mp.nranks == 1:
            return local
        from paddle_tpu_torch.distributed.fleet.mpu import _GatherFromGroup
        return _GatherFromGroup.apply(local, self._mp)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id=None):
        """KV-cached autoregressive decoding (reference :642-659): the
        prompt ``input_ids`` [B, S] and up to ``max_new_tokens`` new
        tokens, ``[B, S + new]``. Greedy at ``temperature == 0``, else
        ``models.generation.sample_token`` with top-k / nucleus filtering
        from the default generator; the loop ends early once every row
        has emitted ``eos_token_id`` (see ``generation.generate_loop``).
        Given a Paddle ``Tensor`` it returns one."""
        from .generation import generate_loop
        (ids,), _, had = unwrap_args((input_ids,), None)
        ids = torch.as_tensor(ids).to(self.model.embed_tokens.weight.device)

        def prefill(tokens):
            caches = [(None, None)] * self.cfg.num_hidden_layers
            h, caches = self.model(tokens, caches=caches)
            return self._logits(h[:, -1:]), caches

        def decode(tok, caches):
            h, caches = self.model(tok, caches=caches)
            return self._logits(h), caches

        out = generate_loop(prefill, decode, ids, max_new_tokens,
                            temperature, top_k, top_p, eos_token_id)
        return wrap(out) if had else out

    def generate_compiled(self, input_ids, max_new_tokens: int = 32,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 1.0, eos_token_id=None,
                          prefill_chunk: int = 0, attention_mask=None):
        """Generation over static KV buffers with the decode step
        captured once per signature and replayed (reference :661; see
        ``generation.compiled_generate``). Greedy tokens equal
        ``generate``'s; ``attention_mask`` serves a left-padded batch of
        unequal prompts, each row equal to its solo run. Given a Paddle
        ``Tensor`` it returns one."""
        from .generation import compiled_generate
        (ids, mask), _, had = unwrap_args((input_ids, attention_mask),
                                          None)
        out = compiled_generate(self, ids, max_new_tokens, temperature,
                                top_k, top_p, eos_token_id,
                                prefill_chunk=prefill_chunk,
                                attention_mask=mask)
        return wrap(out) if had else out

    @staticmethod
    def flops_per_token(cfg: LlamaConfig) -> float:
        """Analytic forward FLOPs per token (2 per MAC) for MFU (reference
        :677): the projections and the head, without attention scores."""
        d, f, L = cfg.hidden_size, cfg.intermediate_size, \
            cfg.num_hidden_layers
        hd = d // cfg.num_attention_heads
        kv = cfg.num_key_value_heads * hd
        per_layer = 2 * d * (d + 2 * kv + d) + 2 * 3 * d * f
        return L * per_layer + 2 * d * cfg.vocab_size
