"""Shared pieces of the tests of the port's Paddle API (``Tensor``, the
op library, autograd, ``nn.Layer``, ``generate`` and the examples): the
CPU device fixture and the two packages side by side."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as _device


@pytest.fixture(autouse=True)
def on_cpu():
    """Every entry point defaults to the card; these tests ask for the
    CPU with ``set_device`` and restore the process-wide choice after
    each test, so the tests that check the card default keep meaning."""
    prev = _device._chosen[0]
    ptt.set_device("cpu")
    yield
    _device._chosen[0] = prev


def both(x, stop_gradient=True):
    """The same numpy value as a JAX-package and a port ``Tensor``."""
    return (pt.to_tensor(x, stop_gradient=stop_gradient),
            ptt.to_tensor(x, stop_gradient=stop_gradient))


def rnd(rng, *shape, dtype=np.float32):
    return rng.rand(*shape).astype(dtype)
