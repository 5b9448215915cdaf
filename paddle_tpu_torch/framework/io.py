"""``save``/``load`` — port of ``paddle_tpu/framework/io.py``.

The reference's pickle format: a nested object whose tensors are tagged
numpy payloads (``{"@tensor": array, "stop_gradient": …, "name": …}``),
written atomically (temp file and rename). A file written by either
package loads in the other. ``load`` of a directory dispatches to the
checkpoint reader (a manager root or one ``step_N`` directory).

bfloat16 (a deliberate divergence): the reference pickles a bfloat16
array as an ``ml_dtypes`` numpy array, which the port cannot write or
read without that package. ``save`` refuses a bfloat16 tensor and
``load`` a file that holds one, with ``NotImplementedError`` naming
``paddle_tpu_torch.checkpoint.CheckpointManager`` — whose raw shards
carry bfloat16 between the packages — instead of casting silently.

The port saves from one process; the reference's multi-process save
barrier is not ported.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["save", "load"]

_PROTOCOL_MIN, _PROTOCOL_MAX = 2, 4

_BF16_ROUTE = ("use paddle_tpu_torch.checkpoint.CheckpointManager, whose "
               "raw shards carry bfloat16 between the packages")


def _to_host(obj):
    """Tensor -> tagged numpy payload; containers walked recursively."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            raise NotImplementedError(
                "framework.io.save of a bfloat16 tensor: the pickle format "
                "holds numpy arrays, and numpy has no bfloat16 here; "
                + _BF16_ROUTE)
        return {"@tensor": obj.detach().cpu().numpy().copy(),
                "stop_gradient": not obj.requires_grad, "name": ""}
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_to_host(v) for v in obj])  # namedtuple
    if isinstance(obj, (list, tuple)):
        seq = [_to_host(v) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj  # numpy arrays and scalars pickle as themselves


def _from_host(obj, device):
    if isinstance(obj, dict):
        if "@tensor" in obj:
            return torch.from_numpy(np.array(obj["@tensor"],
                                             copy=True)).to(device)
        return {k: _from_host(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_from_host(v, device) for v in obj])
    if isinstance(obj, (list, tuple)):
        seq = [_from_host(v, device) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


class _Unpickler(pickle.Unpickler):
    """Refuses ``ml_dtypes`` (bfloat16 arrays) and the JAX package's own
    classes, which the port cannot rebuild."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "ml_dtypes":
            raise NotImplementedError(
                f"this file holds an ml_dtypes array ({name}), a bfloat16 "
                "tensor of the JAX package; " + _BF16_ROUTE)
        if root == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"this file names {module}.{name}, a class of the JAX "
                "package that the port does not read")
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """Pickle a nested object with tensors to ``path`` (atomic publish)."""
    if not (_PROTOCOL_MIN <= protocol <= _PROTOCOL_MAX):
        raise ValueError(
            f"pickle protocol must be in [{_PROTOCOL_MIN}, "
            f"{_PROTOCOL_MAX}], got {protocol}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_host(obj)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)
    os.replace(tmp, path)


def load(path: str, device=None, **configs) -> Any:
    """Read what :func:`save` wrote (or a checkpoint directory); tensors
    on ``device`` (``None``: the CUDA card, raising where there is
    none)."""
    if os.path.isdir(path):
        from paddle_tpu_torch.checkpoint import (is_checkpoint_dir,
                                                 load_state_dir)
        if is_checkpoint_dir(path):
            return load_state_dir(path, device=device)
        raise FileNotFoundError(
            f"{path!r} is a directory but not a checkpoint layout "
            f"(no committed step_N subdirectory or index.json)")
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path!r} does not exist")
    device = resolve_device(device)
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    return _from_host(payload, device)
