"""Mixture-of-Experts decoder LMs — port of ``paddle_tpu/models/moe.py``
(DeepSeekMoE and Qwen2-MoE configurations).

The decoder reuses the port's Llama attention and MLP; only the FFN
differs: layers below ``first_k_dense_replace`` keep a dense SwiGLU MLP,
the others route through :class:`~paddle_tpu_torch.distributed.fleet.MoELayer`
(GShard gate, SiLU experts) beside ``num_shared_experts`` always-on
shared experts, one SwiGLU MLP of ``moe_intermediate_size *
num_shared_experts``.

Ported: the configuration and its presets, the cacheless forward, both
loss routes with the gate-balance aux loss folded in, ``aux_loss`` and
``clear_decode_side_effects``, the cached forward that serving and
decoding run (reference :188-206) over the four cache forms of the
Llama trunk (the per-row ``PagedLayerCache`` with its token mask among
them), eager ``generate`` and ``generate_compiled``.

Parallelism, as the reference's (:79-115, :156-161):
``tensor_parallel=True`` makes the attention, the dense MLP and the
shared experts the port's tensor-parallel Llama layers over the global
mesh's ``mp`` axis (the embedding and ``lm_head`` stay whole), and the
routed ``MoELayer`` picks up the global mesh's ``ep`` axis (expert
parallelism; see ``distributed/fleet/moe.py``). The init draws every
full weight and keeps this rank's block, so a parallel model equals the
one-device model of its seed. ``aux_loss()`` adds the layers' auxes,
each global under a row split. Parameter names and shapes equal the
reference's, so a numpy state dict moves between the packages unchanged
(``utils/bridge.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.core.tensor import unwrap_args, wrap
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.distributed.fleet.moe import MoELayer, _xavier_uniform_
from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.fused_ce import causal_lm_loss
from .llama import (_ZERO_NO_BIAS, LlamaAttention, LlamaConfig, LlamaMLP,
                    _mp_of, _rope_cache, run_cached_layers)
from paddle_tpu_torch.nn.containers import LayerList
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["MoeConfig", "MoeDecoderLayer", "MoeForCausalLM"]


@dataclass
class MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632       # shared-expert / dense FFN width
    moe_intermediate_size: int = 1408   # per routed expert
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 60
    num_experts_per_tok: int = 4
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1      # DeepSeekMoE: first layers stay dense
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    aux_loss_weight: float = 0.01
    tensor_parallel: bool = False

    @staticmethod
    def qwen2_moe_a14b(**kw) -> "MoeConfig":
        base = dict(hidden_size=3584, intermediate_size=18944,
                    moe_intermediate_size=2560, num_hidden_layers=28,
                    num_attention_heads=28, num_key_value_heads=4,
                    num_experts=64, num_experts_per_tok=8,
                    first_k_dense_replace=0)
        base.update(kw)
        return MoeConfig(**base)

    @staticmethod
    def deepseek_moe_16b(**kw) -> "MoeConfig":
        base = dict(vocab_size=102400, hidden_size=2048,
                    intermediate_size=10944, moe_intermediate_size=1408,
                    num_hidden_layers=28, num_attention_heads=16,
                    num_key_value_heads=16, num_experts=64,
                    num_experts_per_tok=6, num_shared_experts=2,
                    first_k_dense_replace=1)
        base.update(kw)
        return MoeConfig(**base)

    @staticmethod
    def tiny(**kw) -> "MoeConfig":
        base = dict(vocab_size=128, hidden_size=32,
                    intermediate_size=64, moe_intermediate_size=32,
                    num_hidden_layers=2, num_attention_heads=2,
                    num_key_value_heads=2, num_experts=4,
                    num_experts_per_tok=2, num_shared_experts=1,
                    first_k_dense_replace=1)
        base.update(kw)
        return MoeConfig(**base)

    def _attn_cfg(self) -> LlamaConfig:
        """The Llama config the attention and MLPs are built from; its
        ``max_position_embeddings`` (8192) sizes the RoPE table."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            rope_theta=self.rope_theta, rms_norm_eps=self.rms_norm_eps,
            tensor_parallel=self.tensor_parallel)


class MoeDecoderLayer(Layer):
    def __init__(self, cfg: MoeConfig, layer_idx: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        acfg = cfg._attn_cfg()
        self.input_layernorm = RMSNorm(cfg.hidden_size,
                                       epsilon=cfg.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(acfg, **kw)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        self.is_dense = layer_idx < cfg.first_k_dense_replace
        if self.is_dense:
            self.mlp = LlamaMLP(acfg, **kw)
        else:
            self.mlp = MoELayer(cfg.hidden_size, cfg.moe_intermediate_size,
                                cfg.num_experts, gate="gshard",
                                top_k=cfg.num_experts_per_tok,
                                activation="silu", **kw)
            if cfg.num_shared_experts > 0:
                shared_cfg = cfg._attn_cfg()
                shared_cfg.intermediate_size = (
                    cfg.moe_intermediate_size * cfg.num_shared_experts)
                self.shared_expert = LlamaMLP(shared_cfg, **kw)
            else:
                self.shared_expert = None

    def forward(self, x, cache, rope, attn_impl="rpa", attention_mask=None,
                pos_offsets=None):
        """The Llama attention with any of its cache forms (``cache=None``
        for the cacheless forward; a returned cache comes back as ``(out,
        cache)``), then the dense MLP or the routed experts beside the
        shared ones (reference :115-146).

        With a :class:`~paddle_tpu_torch.ops.paged_attention.RaggedLayerCache`
        the routed experts get ``token_mask = seq_ids < sentinel``, the
        sentinel being the all-null block-table row ``block_tables.shape[0]
        - 1`` that marks the step's budget padding (reference :137-141);
        with a :class:`~paddle_tpu_torch.ops.paged_attention.PagedLayerCache`
        ``token_mask[b, i] = i < new_lens[b]`` (reference :132-136). So
        padding claims no expert capacity."""
        h = self.self_attn(self.input_layernorm(x), cache, rope, attn_impl,
                           attention_mask, None, pos_offsets)
        new_cache = None
        if isinstance(h, tuple):  # a returned cache: (out, new cache)
            h, new_cache = h
        x = x + h
        h = self.post_attention_layernorm(x)
        if self.is_dense:
            out = x + self.mlp(h)
        else:
            mask = None
            if isinstance(cache, pa.PagedLayerCache):
                mask = torch.arange(x.shape[1], device=x.device)[None, :] \
                    < cache.new_lens.long()[:, None]
            elif isinstance(cache, pa.RaggedLayerCache):
                sentinel = cache.block_tables.shape[0] - 1
                mask = (cache.seq_ids < sentinel)[None, :]
            routed = self.mlp(h, token_mask=mask)
            if self.shared_expert is not None:
                routed = routed + self.shared_expert(h)
            out = x + routed
        return out if new_cache is None else (out, new_cache)


class MoeForCausalLM(Layer):
    """Decoder-only MoE LM; ``forward(ids, labels)`` returns ``(None,
    loss)`` with the gate-balance aux loss folded in, ``forward(ids)`` the
    logits. ``device=None`` is the CUDA card; pass ``device="cpu"`` to
    build on the CPU. Weights start from the reference's initializers
    (embedding N(0, 1), projections XavierUniform, experts uniform, norms
    ones) drawn from a ``torch.Generator`` seeded with ``seed``."""

    # vocab size from which the fused chunked CE pays for itself
    _FUSED_CE_MIN_VOCAB = 32768

    def __init__(self, cfg: MoeConfig, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")
        if cfg.tensor_parallel:
            _mp_of(cfg._attn_cfg())  # mp must divide the KV heads
        device = resolve_device(device)
        dtype = convert_dtype(dtype)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      weight_attr=I.Constant(0.0), **kw)
        self.layers = LayerList(
            [MoeDecoderLayer(cfg, i, **kw)
             for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, **kw,
                              **_ZERO_NO_BIAS)
        # the attention's RoPE table, built from _attn_cfg() (not state)
        acfg = cfg._attn_cfg()
        cos, sin = _rope_cache(acfg.max_position_embeddings,
                               cfg.hidden_size // cfg.num_attention_heads,
                               float(acfg.rope_theta))
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(**kw),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(**kw),
                             persistent=False)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, generator):
        """The reference's recipe; a tensor-parallel block draws its full
        weight (and its XavierUniform bound) and keeps its part."""
        from paddle_tpu_torch.distributed.mesh import axis_size, local_block
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "embed_tokens.weight":
                p.normal_(0.0, 1.0, generator=generator)
            elif p.dim() == 2 and leaf == "weight":
                spec = getattr(p, "_sharding_spec", None)
                if spec is None:
                    _xavier_uniform_(p, generator)
                    continue
                mesh = p._sharding_mesh
                full = p.new_empty([s * (1 if e is None else
                                         axis_size(mesh, e))
                                    for s, e in zip(p.shape, spec)])
                _xavier_uniform_(full, generator)
                p.copy_(local_block(full, spec, mesh))
            elif p.dim() == 1:
                p.fill_(1.0)  # RMSNorm scales
        for layer in self.layers:
            if isinstance(layer.mlp, MoELayer):
                layer.mlp.reset_experts(generator)

    def aux_loss(self):
        total = None
        for layer in self.layers:
            la = getattr(layer.mlp, "l_aux", None)
            if la is not None:
                total = la if total is None else total + la
        return total

    def clear_decode_side_effects(self):
        """Drop the per-layer gate state (``l_aux``) a forward left
        behind, so a later :meth:`aux_loss` does not read it."""
        for layer in self.layers:
            if hasattr(layer.mlp, "l_aux"):
                layer.mlp.l_aux = None

    def _with_aux(self, loss):
        aux = self.aux_loss()
        if aux is None:
            return loss
        return loss + aux * self.cfg.aux_loss_weight

    def forward(self, input_ids, labels=None, caches=None,
                attn_impl: str = "rpa"):
        """Cacheless (reference :208-245): without ``labels``, the logits.
        With them (``labels == input_ids``; the shift happens here; -100 is
        ignored): ``(None, loss)``, through the fused chunked CE on the
        untied head for a vocab of at least 32768, else cross entropy over
        the logits of positions ``:-1``.

        Cached (reference :188-206): one cache per layer, in any form the
        Llama trunk takes (``models.llama.run_cached_layers``): eager
        ``(past_k, past_v)`` pairs (``(None, None)`` before the prompt),
        static ``(k_buf, v_buf, pos)`` triples, per-row
        ``PagedLayerCache``s, or the serving step's ``RaggedLayerCache``s
        read through ``attn_impl``. Returns the
        final-norm hidden states and the caches, not logits: the caller
        projects only the positions it needs. As in the reference, the
        cached forward takes no ``attention_mask`` or ``pos_offsets``, so
        a ragged ``generate_compiled`` raises ``TypeError``."""
        rope = (self.rope_cos, self.rope_sin)
        x = self.embed_tokens(input_ids)
        if caches is not None:
            x, caches = run_cached_layers(self, x, caches, attn_impl)
            return self.norm(x), caches
        for layer in self.layers:
            x = layer(x, None, rope)
        h = self.norm(x)
        if labels is not None and labels.shape[1] < 2:
            raise ValueError(
                "causal-LM loss needs sequences of length >= 2")
        if labels is not None and \
                self.cfg.vocab_size >= self._FUSED_CE_MIN_VOCAB:
            # lm_head.weight is [d, V]; the fused CE takes [V, d]
            loss = causal_lm_loss(h, self.lm_head.weight.t(), labels)
            return None, self._with_aux(loss)
        if labels is None:
            return self.lm_head(h)
        logits = self.lm_head(h[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels[:, 1:].reshape(-1))
        return None, self._with_aux(loss)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id=None):
        """KV-cached decoding over the eager growing cache (reference
        :247-262, through ``generation.generate_loop``): the prompt
        ``[B, S]`` and up to ``max_new_tokens`` new tokens. As in the
        reference, the gates keep the last decode step's ``l_aux``, so
        :meth:`aux_loss` gives that step's loss. Given a Paddle
        ``Tensor`` it returns one."""
        from .generation import generate_loop
        (ids,), _, had = unwrap_args((input_ids,), None)
        ids = torch.as_tensor(ids).to(self.embed_tokens.weight.device)

        def prefill(tokens):
            caches = [(None, None)] * self.cfg.num_hidden_layers
            h, caches = self(tokens, caches=caches)
            return self.lm_head(h[:, -1:]), caches

        def decode(tok, caches):
            h, caches = self(tok, caches=caches)
            return self.lm_head(h), caches

        out = generate_loop(prefill, decode, ids, max_new_tokens,
                            temperature, top_k, top_p, eos_token_id)
        return wrap(out) if had else out

    def generate_compiled(self, input_ids, max_new_tokens: int = 32,
                          temperature: float = 0.0, top_k: int = 0,
                          top_p: float = 1.0, eos_token_id=None,
                          prefill_chunk: int = 0):
        """Generation over static KV buffers with the decode step
        captured once per signature and replayed (reference :265-280; see
        ``generation.compiled_generate``); greedy tokens equal
        :meth:`generate`'s. The gates' ``l_aux`` is cleared afterwards.
        Given a Paddle ``Tensor`` it returns one."""
        from .generation import compiled_generate
        (ids,), _, had = unwrap_args((input_ids,), None)
        try:
            out = compiled_generate(self, ids, max_new_tokens, temperature,
                                    top_k, top_p, eos_token_id,
                                    prefill_chunk=prefill_chunk)
        finally:
            self.clear_decode_side_effects()
        return wrap(out) if had else out
