"""VGG family (port of ``paddle_tpu/vision/models/vgg.py``): features,
a 7 x 7 adaptive average pool and the three-layer classifier."""
from __future__ import annotations

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm=False, **kw):
    layers = []
    cin = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2D(cin, v, kernel_size=3, padding=1, **kw))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, **kw))
            layers.append(nn.ReLU())
            cin = v
    return nn.Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes, **kw))
        else:
            self.classifier = None

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.classifier is not None:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require a network download, which this "
            "package does not make; load local weights with "
            "paddle_tpu_torch.utils.bridge.load_numpy_state")
    kw = {k: kwargs[k] for k in ("device", "dtype") if k in kwargs}
    return VGG(_make_features(_CFGS[cfg], batch_norm, **kw), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
