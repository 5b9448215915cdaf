"""``paddle.incubate.nn``: the fused transformer layer set — port of
``paddle_tpu/incubate/nn/__init__.py`` (Paddle's
``incubate/nn/layer/fused_transformer.py``, ``fused_linear.py`` and
``fused_ec_moe.py``).

The layers keep the reference's parameter names and shapes (the packed
``qkv_weight [3, H, head_dim, E]`` among them), so a state dict moves
between the packages unchanged. Attention goes through
``F.scaled_dot_product_attention``: the flash-attention kernels (K1-K3)
on the card, their plain version on the CPU. ``FusedEcMoe`` routes
through ``distributed.fleet.MoELayer`` without a gate, and with the
caller's gate logits evaluates every expert and combines them by the
logits' softmax, in plain PyTorch as the reference leaves it to XLA.
Layers take ``device`` (``None`` is the card) and ``dtype``.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.distributed.fleet.moe import _ACTIVATIONS, MoELayer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.containers import LayerList
from paddle_tpu_torch.nn.layer.common import Dropout
from paddle_tpu_torch.nn.layer_base import Layer
from paddle_tpu_torch.param_attr import create_parameter

__all__ = ["FusedLinear", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedEcMoe", "memory_efficient_attention"]


class _Fused(Layer):
    """Parameters on the layer's device, in its dtype, by Paddle's
    ``create_parameter`` rules (Xavier-uniform weights, zero biases)."""

    def __init__(self, device, dtype):
        super().__init__()
        self._kw = dict(device=resolve_device(device),
                        dtype=convert_dtype(dtype))

    def _param(self, shape, attr=None, is_bias=False, ones=False):
        return create_parameter(
            shape, attr=attr, is_bias=is_bias,
            default_initializer=I.Constant(1.0) if ones else None,
            **self._kw)


class FusedLinear(_Fused):
    """``x @ W + b`` (reference ``FusedLinear``); ``transpose_weight``
    stores W as ``[out, in]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None, dtype="float32"):
        super().__init__(device, dtype)
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = self._param(shape, weight_attr)
        self.bias = None if bias_attr is False else self._param(
            [out_features], bias_attr, is_bias=True)

    def forward(self, x):
        w = self.weight.t() if self.transpose_weight else self.weight
        return F.linear(x, w, self.bias)


class FusedMultiHeadAttention(_Fused):
    """Pre- or post-LayerNorm, the packed QKV projection, attention, the
    output projection, dropout and the residual (reference
    ``FusedMultiHeadAttention``). ``attn_mask`` (additive float, or bool
    with True = attend) reaches the flash kernels' full-bias path."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 dtype="float32"):
        super().__init__(device, dtype)
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.qkv_weight = self._param(
            [3, num_heads, self.head_dim, embed_dim], qkv_weight_attr)
        self.qkv_bias = self._param([3, num_heads, self.head_dim],
                                    qkv_bias_attr, is_bias=True)
        self.linear_weight = self._param([embed_dim, embed_dim],
                                         linear_weight_attr)
        self.linear_bias = self._param([embed_dim], linear_bias_attr,
                                       is_bias=True)
        self.pre_ln_scale = self._param([embed_dim], pre_ln_scale_attr,
                                        ones=True)
        self.pre_ln_bias = self._param([embed_dim], pre_ln_bias_attr,
                                       is_bias=True)
        self.ln_scale = self._param([embed_dim], ln_scale_attr, ones=True)
        self.ln_bias = self._param([embed_dim], ln_bias_attr, is_bias=True)
        self._epsilon = epsilon
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        residual = x = query
        if self.normalize_before:
            x = F.layer_norm(x, [self.embed_dim], self.pre_ln_scale,
                             self.pre_ln_bias, self._epsilon)
        B, S = x.shape[0], x.shape[1]
        # x [B, S, E] @ W [3, H, hd, E]^T -> [B, S, 3, H, hd]
        w = self.qkv_weight.reshape(-1, self.embed_dim).t()
        qkv = (torch.matmul(x, w) + self.qkv_bias.reshape(-1)).reshape(
            B, S, 3, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, training=self.training)
        out = torch.matmul(out.reshape(B, S, self.embed_dim),
                           self.linear_weight) + self.linear_bias
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = F.layer_norm(out, [self.embed_dim], self.ln_scale,
                               self.ln_bias, self._epsilon)
        return out


class FusedFeedForward(_Fused):
    """Pre- or post-LayerNorm around ``linear2(act(linear1(x)))`` with
    dropout and the residual (reference ``FusedFeedForward``)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None, *,
                 device=None, dtype="float32"):
        super().__init__(device, dtype)
        self.d_model = d_model
        self.normalize_before = normalize_before
        self._epsilon = epsilon
        self._act = activation
        self.linear1_weight = self._param([d_model, dim_feedforward],
                                          linear1_weight_attr)
        self.linear1_bias = self._param([dim_feedforward],
                                        linear1_bias_attr, is_bias=True)
        self.linear2_weight = self._param([dim_feedforward, d_model],
                                          linear2_weight_attr)
        self.linear2_bias = self._param([d_model], linear2_bias_attr,
                                        is_bias=True)
        self.ln1_scale = self._param([d_model], ln1_scale_attr, ones=True)
        self.ln1_bias = self._param([d_model], ln1_bias_attr, is_bias=True)
        self.ln2_scale = self._param([d_model], ln2_scale_attr, ones=True)
        self.ln2_bias = self._param([d_model], ln2_bias_attr, is_bias=True)
        self.dropout = Dropout(dropout_rate)
        self.act_dropout = Dropout(
            dropout_rate if act_dropout_rate is None else act_dropout_rate)

    def forward(self, src, cache=None):
        residual = x = src
        if self.normalize_before:
            x = F.layer_norm(x, [self.d_model], self.ln1_scale,
                             self.ln1_bias, self._epsilon)
        h = torch.matmul(x, self.linear1_weight) + self.linear1_bias
        h = self.act_dropout(getattr(F, self._act)(h))
        h = torch.matmul(h, self.linear2_weight) + self.linear2_bias
        out = residual + self.dropout(h)
        if not self.normalize_before:
            out = F.layer_norm(out, [self.d_model], self.ln2_scale,
                               self.ln2_bias, self._epsilon)
        return out


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward`` (reference
    ``FusedTransformerEncoderLayer``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate if attn_dropout_rate is None
            else attn_dropout_rate, normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(Layer):
    """``num_layers`` encoder layers of one configuration (reference
    ``FusedMultiTransformer``, pre-LayerNorm and GELU by default)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu",
                 normalize_before=True, num_layers=1, nranks=1,
                 ring_id=-1, name=None, *, device=None, dtype="float32"):
        super().__init__()
        self.layers = LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=normalize_before, device=device,
                dtype=dtype)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x


class FusedEcMoe(Layer):
    """Expert-choice MoE (reference ``FusedEcMoe``) over
    ``distributed.fleet.MoELayer`` (GShard gate, top-2)."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type="gelu",
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        self._act_type = act_type
        self.moe = MoELayer(hidden_size, inter_size, num_experts,
                            gate="gshard", top_k=2, activation=act_type,
                            device=device, dtype=dtype)

    def forward(self, x, gate=None):
        """Without ``gate``, the layer's own top-2 gate routes with
        capacity. With ``gate`` (the caller's logits ``[..., E]``), every
        expert runs on every token and the outputs are combined by
        ``softmax(gate)``: the capacity-unlimited limit of expert-choice
        routing (reference :233-254)."""
        if gate is None:
            return self.moe(x)
        m = self.moe
        act = _ACTIVATIONS[self._act_type]
        h = act(torch.einsum("...d,edh->...eh", x, m.w1) + m.b1)
        y = torch.einsum("...eh,ehd->...ed", h, m.w2) + m.b2
        probs = torch.softmax(gate, dim=-1)
        return torch.einsum("...e,...ed->...d", probs, y)


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """Attention in ``[B, S, H, D]`` layout (reference :257-273): the
    flash-attention kernels, the memory-efficient path on the card.
    ``scale`` replaces ``1/sqrt(D)``: q is pre-scaled by ``scale *
    sqrt(D)``; ``attn_bias`` is an additive mask."""
    if scale is not None:
        query = query * (scale * math.sqrt(query.shape[-1]))
    if attn_bias is not None:
        return F.scaled_dot_product_attention(
            query, key, value, attn_mask=attn_bias, dropout_p=p,
            training=training)
    return F.flash_attention(query, key, value, dropout=p,
                             training=training)
