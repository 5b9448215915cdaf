"""Vision datasets (port of ``paddle_tpu/vision/datasets``) on the port's
``io.Dataset``.

Nothing here downloads: a dataset whose files are missing raises and says
where to put them. MNIST and FashionMNIST read local idx (or idx.gz)
files, the CIFARs their local python tar archives, and ``FakeData``
makes deterministic images from its seed.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.io import Dataset

__all__ = ["MNIST", "FashionMNIST", "FakeData", "Cifar10", "Cifar100"]


class FakeData(Dataset):
    """Deterministic synthetic image classification data."""

    def __init__(self, num_samples=1000, image_shape=(3, 32, 32),
                 num_classes=10, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self._seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed + idx)
        img = rng.randn(*self.image_shape).astype(np.float32)
        label = np.int64(idx % self.num_classes)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class MNIST(Dataset):
    """MNIST from local idx/idx.gz files (reference file-format parity:
    ``python/paddle/vision/datasets/mnist.py``)."""

    _files = {
        "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }
    _cache_name = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None,
                 root=None):
        self.transform = transform
        if image_path is None or label_path is None:
            root = root or os.path.expanduser(
                f"~/.cache/paddle_tpu_torch/{self._cache_name}")
            img_name, lbl_name = self._files[mode]
            image_path = self._find(root, img_name)
            label_path = self._find(root, lbl_name)
            if image_path is None or label_path is None:
                raise FileNotFoundError(
                    f"MNIST files not found under {root}; this package "
                    "downloads nothing: place the "
                    "idx(.gz) files there or pass image_path/label_path "
                    "explicitly")
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)

    @staticmethod
    def _find(root, name):
        for cand in (os.path.join(root, name),
                     os.path.join(root, name + ".gz")):
            if os.path.exists(cand):
                return cand
        return None

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") \
            else open(path, "rb")

    @classmethod
    def _read_images(cls, path):
        with cls._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad idx3 magic {magic} in {path}")
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    @classmethod
    def _read_labels(cls, path):
        with cls._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad idx1 magic {magic} in {path}")
            return np.frombuffer(f.read(n), dtype=np.uint8)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])


class FashionMNIST(MNIST):
    """Same idx file format as MNIST but a distinct cache directory, so a
    default-root FashionMNIST() can never silently pick up MNIST digits."""
    _cache_name = "fashion-mnist"


class Cifar10(Dataset):
    """CIFAR-10 from the local ``cifar-10-python.tar.gz`` archive
    (reference file-format parity: ``python/paddle/vision/datasets/
    cifar.py`` — pickle batches of 10000x3072 uint8 rows)."""

    _mode_files = {"train": [f"data_batch_{i}" for i in range(1, 6)],
                   "test": ["test_batch"]}
    _label_key = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        import pickle
        import tarfile
        if mode not in self._mode_files:
            raise ValueError(
                f"mode must be one of {sorted(self._mode_files)}, "
                f"got '{mode}'")
        if data_file is None or not os.path.exists(data_file):
            raise FileNotFoundError(
                f"{type(self).__name__}: this package downloads nothing; "
                "pass data_file= pointing at the local "
                "cifar python tar archive")
        self.transform = transform
        images, labels = [], []
        wanted = self._mode_files[mode]
        with tarfile.open(data_file) as tf:
            for member in tf.getmembers():
                base = os.path.basename(member.name)
                if base in wanted:
                    d = pickle.loads(tf.extractfile(member).read(),
                                     encoding="bytes")
                    images.append(np.asarray(d[b"data"], np.uint8))
                    labels.extend(d[self._label_key])
        if not images:
            raise ValueError(
                f"no {mode} batches ({wanted}) found in {data_file}")
        self.data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.data[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    """CIFAR-100 (fine labels) from ``cifar-100-python.tar.gz``."""

    _mode_files = {"train": ["train"], "test": ["test"]}
    _label_key = b"fine_labels"
