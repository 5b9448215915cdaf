"""PP-OCRv4-style text recognition (port of ``paddle_tpu/models/ppocr.py``).

A light convolutional backbone (MobileNet-style depthwise-separable
blocks of ``Conv2D`` + ``BatchNorm2D`` + hardswish) takes the image's
height to 1 and its width to a quarter; ``Im2Seq`` turns the columns
into a sequence, a 2-layer bidirectional LSTM encodes it and a linear
CTC head scores each frame; the loss is CTC over the log-softmax. The
convolutions and batch norms run on cuDNN through PyTorch and the LSTM
on PyTorch's fused recurrence on the card (``nn.layer.rnn``), as the
reference leaves them to XLA: no Pallas kernel is on this path.
Modules take ``device`` (``None`` is the card) and ``dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

__all__ = ["PPOCRRecConfig", "PPOCRRecModel", "ConvBNLayer",
           "DepthwiseSeparable", "MobileNetBackbone", "Im2Seq",
           "SequenceEncoder", "CTCHead"]


@dataclass
class PPOCRRecConfig:
    in_channels: int = 3
    num_classes: int = 6625      # charset + blank
    hidden_size: int = 120
    img_height: int = 48
    widths: tuple = (32, 64, 128, 256)

    @staticmethod
    def tiny(**kw) -> "PPOCRRecConfig":
        base = dict(num_classes=16, hidden_size=32, img_height=16,
                    widths=(8, 16, 24, 32))
        base.update(kw)
        return PPOCRRecConfig(**base)


class ConvBNLayer(torch.nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, groups=1, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, kernel, stride=stride,
                              padding=kernel // 2, groups=groups,
                              bias_attr=False, device=device, dtype=dtype)
        self.bn = nn.BatchNorm2D(cout, device=device, dtype=dtype)

    def forward(self, x):
        return F.hardswish(self.bn(self.conv(x)))


class DepthwiseSeparable(torch.nn.Module):
    def __init__(self, cin, cout, stride, **kw):
        super().__init__()
        self.dw = ConvBNLayer(cin, cin, 3, stride=stride, groups=cin, **kw)
        self.pw = ConvBNLayer(cin, cout, 1, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetBackbone(torch.nn.Module):
    """Height down to 1 and width by 4 (stride (2, 1) in the last block
    keeps the sequence long), then a max pool over the remaining
    ``img_height // 8`` rows."""

    def __init__(self, cfg: PPOCRRecConfig, **kw):
        super().__init__()
        w = cfg.widths
        self.stem = ConvBNLayer(cfg.in_channels, w[0], 3, stride=2, **kw)
        self.block1 = DepthwiseSeparable(w[0], w[1], stride=1, **kw)
        self.block2 = DepthwiseSeparable(w[1], w[2], stride=2, **kw)
        self.block3 = DepthwiseSeparable(w[2], w[3], stride=(2, 1), **kw)
        self.pool_h = cfg.img_height // 8

    def forward(self, x):
        x = self.block3(self.block2(self.block1(self.stem(x))))
        return F.max_pool2d(x, kernel_size=[self.pool_h, 1])


class Im2Seq(torch.nn.Module):
    def forward(self, x):
        """[B, C, 1, W] -> [B, W, C]."""
        return x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)


class SequenceEncoder(torch.nn.Module):
    def __init__(self, cin, hidden, **kw):
        super().__init__()
        self.lstm = nn.LSTM(cin, hidden, num_layers=2, direction="bidirect",
                            **kw)

    def forward(self, x):
        out, _ = self.lstm(x)
        return out


class CTCHead(torch.nn.Module):
    def __init__(self, cin, num_classes, **kw):
        super().__init__()
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        return self.fc(x)


class PPOCRRecModel(torch.nn.Module):
    """``forward(images [B, C, H, W]) -> logits [B, W / 4, num_classes]``;
    ``loss(logits, labels, label_lengths)`` is the CTC objective over
    every frame, blank 0."""

    def __init__(self, cfg: PPOCRRecConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.backbone = MobileNetBackbone(cfg, **kw)
        self.neck = Im2Seq()
        self.encoder = SequenceEncoder(cfg.widths[-1], cfg.hidden_size, **kw)
        self.head = CTCHead(2 * cfg.hidden_size, cfg.num_classes, **kw)

    def forward(self, images):
        return self.head(self.encoder(self.neck(self.backbone(images))))

    def loss(self, logits, labels, label_lengths):
        B, T = logits.shape[0], logits.shape[1]
        log_probs = F.log_softmax(logits, axis=-1).transpose(0, 1)
        input_lengths = torch.full((B,), T, dtype=torch.int64,
                                   device=logits.device)
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=0)
