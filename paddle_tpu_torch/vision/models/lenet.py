"""LeNet (port of ``paddle_tpu/vision/models/lenet.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Flatten(), nn.Linear(400, 120, **kw),
                nn.Linear(120, 84, **kw), nn.Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x)
        return x
