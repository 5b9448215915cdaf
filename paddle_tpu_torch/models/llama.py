"""Llama-3 family — port of ``paddle_tpu/models/llama.py``, serving and
training paths.

Ported: the config and its presets, the RoPE table and rotation, the
token-packed block-paged forward that the serving engine's unified step
runs (reference ``LlamaAttention._ragged_paged_forward``, ``:392``), the
cacheless forward that training runs (flash attention, with segment ids
from ``attention_mask`` and per-token ``position_ids``), the
RMSNorm/SwiGLU decoder around them, the logits head and the causal-LM
loss (the fused chunked CE for a tied vocab of at least 32768). The
static-cache and eager-generate paths, recompute, tensor parallelism and
the int8-KV branch are not ported yet.

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

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn import functional as F
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


class LlamaAttention(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.n_heads = cfg.num_attention_heads
        self.n_kv = cfg.num_key_value_heads
        mk = functools.partial(Linear, device=device, dtype=dtype,
                               **_ZERO_NO_BIAS)
        self.q_proj = mk(cfg.hidden_size, self.n_heads * self.head_dim)
        self.k_proj = mk(cfg.hidden_size, self.n_kv * self.head_dim)
        self.v_proj = mk(cfg.hidden_size, self.n_kv * self.head_dim)
        self.o_proj = mk(self.n_heads * self.head_dim, cfg.hidden_size)

    def forward(self, x, cache: Optional[pa.RaggedLayerCache], rope,
                attn_impl: str = "rpa", attention_mask=None,
                position_ids=None):
        """With a cache: token-packed block-paged attention. ``x`` [1, T,
        hidden] carries every scheduled sequence's new tokens back to
        back; RoPE at the cache's per-token positions; the new K/V go
        into the pools in place; the read path is the RPA kernel or the
        gather path.

        Without one (``cache=None``): causal flash attention over ``x``
        [B, S, hidden] (reference :243-266). ``attention_mask`` [B, S]
        (1 real / 0 pad, or a packer's segment ids) becomes the kernel's
        segment ids; ``position_ids`` [B, S] sets per-token RoPE
        positions."""
        if cache is None:
            return self._cacheless_forward(x, rope, attention_mask,
                                           position_ids)
        if attention_mask is not None or position_ids is not None:
            raise NotImplementedError(
                "the ragged paged path derives per-token positions and key "
                "liveness from the cache itself")
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
            scale=1.0 / math.sqrt(hd), attn_impl=attn_impl)
        return self.o_proj(out.reshape(1, T, -1))

    def _cacheless_forward(self, x, rope, attention_mask, position_ids):
        B, S = x.shape[0], x.shape[1]
        hd = self.head_dim
        q = self.q_proj(x).reshape(B, S, self.n_heads, hd)
        k = self.k_proj(x).reshape(B, S, self.n_kv, hd)
        v = self.v_proj(x).reshape(B, S, self.n_kv, hd)
        cos_t, sin_t = rope
        if S > cos_t.shape[0]:  # the reference's table covers max(S, max_pos)
            cos_t, sin_t = _rope_table(S, hd, self.cfg.rope_theta, x)
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


class LlamaMLP(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        mk = functools.partial(Linear, device=device, dtype=dtype,
                               **_ZERO_NO_BIAS)
        self.gate_proj = mk(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = mk(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = mk(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(torch.nn.Module):
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
                position_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), cache, rope,
                               attn_impl, attention_mask, position_ids)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      weight_attr=I.Constant(0.0), **kw)
        self.layers = torch.nn.ModuleList(
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
                attn_impl: str = "rpa"):
        """Cacheless (``caches=None``, training): ``input_ids`` [B, S] ->
        final-norm hidden [B, S, hidden]; ``attention_mask`` [B, S] (1/0
        padding or packed segment ids) and ``position_ids`` [B, S] as in
        :meth:`LlamaAttention.forward`.

        Serving: ``input_ids`` [1, T] token-packed ids and one
        :class:`~paddle_tpu_torch.ops.paged_attention.RaggedLayerCache`
        per layer -> ``(final-norm hidden [1, T, hidden], caches)``. The
        pools inside the caches are updated in place."""
        rope = (self.rope_cos, self.rope_sin)
        if caches is None:
            x = self.embed_tokens(input_ids)
            for layer in self.layers:
                x = layer(x, None, rope, attention_mask=attention_mask,
                          position_ids=position_ids)
            return self.norm(x)
        if attention_mask is not None or position_ids is not None:
            raise NotImplementedError(
                "attention_mask/position_ids are cacheless (training) "
                "arguments; the paged path derives both from its caches")
        if len(caches) != len(self.layers):
            raise ValueError(
                f"caches has {len(caches)} entries for "
                f"{len(self.layers)} layers")
        x = self.embed_tokens(input_ids)
        for layer, c in zip(self.layers, caches):
            x = layer(x, c, rope, attn_impl)
        return self.norm(x), caches


class LlamaForCausalLM(torch.nn.Module):
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
        if cfg.recompute or cfg.tensor_parallel:
            raise NotImplementedError(
                "recompute and tensor_parallel are not ported to "
                "paddle_tpu_torch yet")
        device = resolve_device(device)
        dtype = convert_dtype(dtype)
        self.cfg = cfg
        self.model = LlamaModel(cfg, device=device, dtype=dtype)
        self.lm_head = None if cfg.tie_word_embeddings else Linear(
            cfg.hidden_size, cfg.vocab_size, device=device, dtype=dtype,
            **_ZERO_NO_BIAS)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, generator):
        """Llama recipe init: every 2-D weight (embedding, projections)
        ~ N(0, initializer_range); norms stay at ones."""
        for _, p in self.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, self.cfg.initializer_range,
                          generator=generator)

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
        if (labels is not None and self.lm_head is None
                and self.cfg.vocab_size >= self._FUSED_CE_MIN_VOCAB):
            return None, causal_lm_loss(h, self.model.embed_tokens.weight,
                                        labels)
        logits = self._logits(h)
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            labels[:, 1:].reshape(-1))
        return logits, loss

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        return torch.matmul(h, self.model.embed_tokens.weight.t())

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
