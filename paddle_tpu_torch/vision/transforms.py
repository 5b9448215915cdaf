"""Vision transforms (port of ``paddle_tpu/vision/transforms.py``).

Host-side numpy transforms, as in the reference: the input pipeline runs
on host threads and the card sees the collated batch. The random ones
draw from numpy's global generator, as the reference's do.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform"]


def _chw(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[:, :, None]
    return img


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor:
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference to_tensor)."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        img = _chw(np.asarray(img))
        out = img.astype(np.float32)
        if img.dtype == np.uint8:
            out = out / 255.0
        if self.data_format == "CHW":
            out = out.transpose(2, 0, 1)
        return out


class Normalize:
    def __init__(self, mean, std, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize:
    """Bilinear resize on HWC arrays (reference default interpolation)."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = _chw(np.asarray(img))
        h, w, c = img.shape
        th, tw = self.size
        ys = (np.arange(th) + 0.5) * h / th - 0.5
        xs = (np.arange(tw) + 0.5) * w / tw - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        im = img.astype(np.float32)
        out = (im[y0][:, x0] * (1 - wy) * (1 - wx) +
               im[y0][:, x1] * (1 - wy) * wx +
               im[y1][:, x0] * wy * (1 - wx) +
               im[y1][:, x1] * wy * wx)
        return out.astype(img.dtype) if img.dtype == np.uint8 else out


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = _chw(np.asarray(img))
        h, w, _ = img.shape
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        img = _chw(np.asarray(img))
        if self.padding:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p), (0, 0)))
        h, w, _ = img.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        img = np.asarray(img)
        factor = 1 + np.random.uniform(-self.value, self.value)
        out = img.astype(np.float32) * factor
        if img.dtype == np.uint8:
            return np.clip(out, 0, 255).astype(np.uint8)
        return out
