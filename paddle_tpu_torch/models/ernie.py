"""ERNIE family — port of ``paddle_tpu/models/ernie.py``.

A BERT-shaped bidirectional encoder with ERNIE's task heads, built on
the port's ``TransformerEncoder``, so attention goes through the flash
kernels (non-causal, with the attention dropout in the kernels' position
hash). ``ErnieForPretraining`` decodes the masked-LM logits against the
tied ``word_embeddings.weight`` (reference :111-133). Parameter names and
shapes equal the reference's, so a numpy state dict crosses the bridge
unchanged. Weights start from the layers' Paddle defaults, drawn from
``core.generator``; entry points take ``device`` (``None`` is the card)
and ``dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForPretraining"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12

    @staticmethod
    def tiny(**kw) -> "ErnieConfig":
        base = dict(vocab_size=128, hidden_size=32,
                    num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64,
                    max_position_embeddings=64, type_vocab_size=2)
        base.update(kw)
        return ErnieConfig(**base)


def _kw(device, dtype):
    return dict(device=resolve_device(device), dtype=convert_dtype(dtype))


class ErnieEmbeddings(Layer):
    """Word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, cfg: ErnieConfig, *, device=None, dtype="float32"):
        super().__init__()
        kw = _kw(device, dtype)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps, **kw)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class ErnieModel(Layer):
    """Returns ``(sequence_output [B, S, H], pooled_output [B, H])``."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype="float32"):
        super().__init__()
        kw = _kw(device, dtype)
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, **kw)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0, normalize_before=False, **kw)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        x = self.encoder(x, src_mask=attention_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ErnieForSequenceClassification(Layer):
    def __init__(self, cfg: ErnieConfig, num_classes: int = 2,
                 dropout: float = None, device=None, dtype="float32"):
        super().__init__()
        kw = _kw(device, dtype)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, **kw)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob
                                  if dropout is None else dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return logits, F.cross_entropy(logits, labels)


class ErnieForPretraining(Layer):
    """Masked-LM and sentence-order heads (ERNIE's pretraining
    objective)."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype="float32"):
        super().__init__()
        kw = _kw(device, dtype)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, **kw)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                       **kw)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps, **kw)
        self.sop_classifier = nn.Linear(cfg.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, masked_lm_labels=None,
                sop_labels=None):
        """Without labels: ``(mlm_logits, sop_logits)``. With
        ``masked_lm_labels`` (-100 where nothing is masked): ``(mlm_logits,
        sop_logits, loss)``, the loss adding the sentence-order cross
        entropy when ``sop_labels`` is given."""
        seq, pooled = self.ernie(input_ids, token_type_ids)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        # decode against the tied word-embedding matrix
        w = self.ernie.embeddings.word_embeddings.weight
        mlm_logits = torch.matmul(h, w.t())
        sop_logits = self.sop_classifier(pooled)
        if masked_lm_labels is None:
            return mlm_logits, sop_logits
        loss = F.cross_entropy(mlm_logits.reshape(-1, mlm_logits.shape[-1]),
                               masked_lm_labels.reshape(-1),
                               ignore_index=-100)
        if sop_labels is not None:
            loss = loss + F.cross_entropy(sop_logits, sop_labels)
        return mlm_logits, sop_logits, loss
