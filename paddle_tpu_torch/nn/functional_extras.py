"""Functions of ``paddle_tpu/nn/functional_extras.py`` that the port
carries so far: ``max_pool2d_with_index`` and ``max_unpool2d``, which
``MaxUnPool2D`` needs. ``nn.functional`` re-exports them, as the
reference's does."""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn.functional import _ntuple

__all__ = ["max_pool2d_with_index", "max_unpool2d"]

_tf = torch.nn.functional


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0, name=None):
    """Reference ``functional_extras.py:259``: NCHW max pool (floor mode)
    returning ``(out, indices)``, each index the flat ``h * W + w``
    position of its window's maximum in the input's channel plane."""
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    return _tf.max_pool2d(x, ks, st, _ntuple(padding, 2),
                          return_indices=True)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Reference ``functional_extras.py:301``: scatter the pooled values
    back to the flat positions in ``indices``, zeros elsewhere; the output
    is ``(o - 1) * stride + kernel - 2 * padding`` a side unless
    ``output_size`` says otherwise."""
    if data_format != "NCHW":
        raise NotImplementedError("max_unpool2d supports NCHW only")
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    size = None if output_size is None else list(output_size)[-2:]
    return _tf.max_unpool2d(x, indices.long(), ks, st, _ntuple(padding, 2),
                            output_size=size)
