"""MobileNetV1 and V2 (port of ``paddle_tpu/vision/models/mobilenet.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch import nn

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin, cout, kernel=3, stride=1, groups=1,
                 activation=True, **kw):
        pad = (kernel - 1) // 2
        layers = [nn.Conv2D(cin, cout, kernel, stride=stride, padding=pad,
                            groups=groups, bias_attr=False, **kw),
                  nn.BatchNorm2D(cout, **kw)]
        if activation:
            layers.append(nn.ReLU6())
        super().__init__(*layers)


class DepthwiseSeparable(torch.nn.Module):
    def __init__(self, cin, cout, stride, **kw):
        super().__init__()
        self.dw = ConvBNReLU(cin, cin, 3, stride=stride, groups=cin, **kw)
        self.pw = ConvBNReLU(cin, cout, 1, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)

        def s(c):
            return max(int(c * scale), 8)
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        blocks = [ConvBNReLU(3, s(32), stride=2, **kw)]
        for cin, cout, stride in cfg:
            blocks.append(DepthwiseSeparable(s(cin), s(cout), stride, **kw))
        self.features = nn.Sequential(*blocks)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(s(1024), num_classes, **kw) \
            if num_classes > 0 else None

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(torch.nn.Module):
    def __init__(self, cin, cout, stride, expand_ratio, **kw):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(cin, hidden, 1, **kw))
        layers += [ConvBNReLU(hidden, hidden, 3, stride=stride,
                              groups=hidden, **kw),
                   ConvBNReLU(hidden, cout, 1, activation=False, **kw)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        cin = _make_divisible(32 * scale)
        last = _make_divisible(1280 * max(1.0, scale))
        blocks = [ConvBNReLU(3, cin, stride=2, **kw)]
        for t, c, n, s in cfg:
            cout = _make_divisible(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(cin, cout,
                                               s if i == 0 else 1, t, **kw))
                cin = cout
        blocks.append(ConvBNReLU(cin, last, 1, **kw))
        self.features = nn.Sequential(*blocks)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Sequential(
            nn.Dropout(0.2), nn.Linear(last, num_classes, **kw)) \
            if num_classes > 0 else None

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.classifier is not None:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require a network download, which this "
            "package does not make; load local weights with "
            "paddle_tpu_torch.utils.bridge.load_numpy_state")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require a network download, which this "
            "package does not make; load local weights with "
            "paddle_tpu_torch.utils.bridge.load_numpy_state")
    return MobileNetV2(scale=scale, **kwargs)
