"""DiT, the diffusion transformer — port of ``paddle_tpu/models/dit.py``.

Patchify (a strided ``Conv2D``), N transformer blocks with adaLN-Zero
conditioning on (timestep, class), a final adaLN layer and unpatchify
to the noise prediction. The adaLN projections and the final linear
start at zero, so a fresh model outputs exactly 0 (reference :106-137).
Attention is ``MultiHeadAttention`` over the flash kernels: DiT-XL/2's
head_dim of 1152 / 16 = 72 runs on the card through the kernels'
zero-padded path (``ops/pallas/flash_attention.py``). Parameter names
and shapes equal the reference's (``pos_embed`` too), so a numpy state
dict crosses the bridge unchanged. Entry points take ``device``
(``None`` is the card) and ``dtype``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.param_attr import create_parameter
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["DiTConfig", "DiT", "DiTBlock", "FinalLayer", "TimestepEmbedder",
           "LabelEmbedder", "timestep_embedding"]


@dataclass
class DiTConfig:
    input_size: int = 32          # latent spatial size
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True

    @staticmethod
    def dit_xl_2(**kw) -> "DiTConfig":
        return DiTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "DiTConfig":
        base = dict(input_size=8, patch_size=2, in_channels=4,
                    hidden_size=32, depth=2, num_heads=2, num_classes=10)
        base.update(kw)
        return DiTConfig(**base)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding ``[B] -> [B, dim]`` in float32
    (reference :52-60)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scl):
    """``x * (1 + scale) + shift``; x ``[B, N, H]``, shift/scale
    ``[B, H]``."""
    return x * (1 + scl)[:, None] + shift[:, None]


def _zero():
    return I.Constant(0.0)


class TimestepEmbedder(Layer):
    def __init__(self, hidden_size, freq_dim=256, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(nn.Linear(freq_dim, hidden_size, **kw),
                                 nn.Silu(),
                                 nn.Linear(hidden_size, hidden_size, **kw))

    def forward(self, t):
        # the float32 embedding enters the MLP in the model's dtype
        emb = timestep_embedding(t, self.freq_dim)
        return self.mlp(emb.to(self.mlp[0].weight.dtype))


class LabelEmbedder(Layer):
    def __init__(self, num_classes, hidden_size, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        # +1 row: the null class of classifier-free guidance
        self.embedding_table = nn.Embedding(num_classes + 1, hidden_size,
                                            device=device, dtype=dtype)

    def forward(self, labels):
        return self.embedding_table(labels)


class DiTBlock(Layer):
    """Transformer block with adaLN-Zero conditioning: the modulation's
    projection starts at zero, so each block starts as the identity."""

    def __init__(self, hidden_size, num_heads, mlp_ratio, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.LayerNorm(hidden_size, weight_attr=False,
                                  bias_attr=False, **kw)
        self.attn = nn.MultiHeadAttention(hidden_size, num_heads, **kw)
        self.norm2 = nn.LayerNorm(hidden_size, weight_attr=False,
                                  bias_attr=False, **kw)
        mlp_dim = int(hidden_size * mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(hidden_size, mlp_dim, **kw),
                                 nn.GELU(),
                                 nn.Linear(mlp_dim, hidden_size, **kw))
        self.adaLN_modulation = nn.Sequential(
            nn.Silu(), nn.Linear(hidden_size, 6 * hidden_size,
                                 weight_attr=_zero(), bias_attr=_zero(),
                                 **kw))

    def forward(self, x, c):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            torch.chunk(self.adaLN_modulation(c), 6, dim=-1)
        h = _modulate(self.norm1(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None] * self.attn(h)
        h = _modulate(self.norm2(x), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None] * self.mlp(h)


class FinalLayer(Layer):
    def __init__(self, hidden_size, patch_size, out_channels, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm_final = nn.LayerNorm(hidden_size, weight_attr=False,
                                       bias_attr=False, **kw)
        self.linear = nn.Linear(hidden_size,
                                patch_size * patch_size * out_channels,
                                weight_attr=_zero(), bias_attr=_zero(), **kw)
        self.adaLN_modulation = nn.Sequential(
            nn.Silu(), nn.Linear(hidden_size, 2 * hidden_size,
                                 weight_attr=_zero(), bias_attr=_zero(),
                                 **kw))

    def forward(self, x, c):
        shift, scl = torch.chunk(self.adaLN_modulation(c), 2, dim=-1)
        return self.linear(_modulate(self.norm_final(x), shift, scl))


class DiT(Layer):
    def __init__(self, cfg: DiTConfig, device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.cfg = cfg
        self.out_channels = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        self.x_embedder = nn.Conv2D(cfg.in_channels, cfg.hidden_size,
                                    kernel_size=cfg.patch_size,
                                    stride=cfg.patch_size, **kw)
        self.t_embedder = TimestepEmbedder(cfg.hidden_size, **kw)
        self.y_embedder = LabelEmbedder(cfg.num_classes, cfg.hidden_size,
                                        **kw)
        n_patches = (cfg.input_size // cfg.patch_size) ** 2
        self.pos_embed = create_parameter(
            [1, n_patches, cfg.hidden_size],
            default_initializer=I.Normal(std=0.02), **kw)
        self.blocks = nn.LayerList([
            DiTBlock(cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio, **kw)
            for _ in range(cfg.depth)])
        self.final_layer = FinalLayer(cfg.hidden_size, cfg.patch_size,
                                      self.out_channels, **kw)

    def unpatchify(self, x):
        """``[B, N, p*p*C] -> [B, C, H, W]``."""
        c, p = self.out_channels, self.cfg.patch_size
        hw = self.cfg.input_size // p
        x = x.reshape(x.shape[0], hw, hw, p, p, c)
        x = x.permute(0, 5, 1, 3, 2, 4)  # [B, C, hw, p, hw, p]
        return x.reshape(x.shape[0], c, hw * p, hw * p)

    def forward(self, x, t, y):
        """x: ``[B, C, H, W]`` latents; t: ``[B]`` timesteps; y: ``[B]``
        class ids."""
        x = self.x_embedder(x)                       # [B, H, h', w']
        x = x.flatten(2).transpose(1, 2)             # [B, N, H]
        x = x + self.pos_embed
        c = self.t_embedder(t) + self.y_embedder(y)
        for block in self.blocks:
            x = block(x, c)
        return self.unpatchify(self.final_layer(x, c))
