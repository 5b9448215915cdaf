"""ZeRO, group-sharded data parallelism — port of
``paddle_tpu/distributed/sharding.py``.

``group_sharded_parallel(model, optimizer, level)`` marks the optimizer
with the mesh axis that shards it (``sharding``); ``jit.TrainStep``
reads the mark as the reference's step does (:603-605) and keeps, on
each rank, 1/n of what the level shards, for every parameter whose dim 0
divides by n (others stay whole, as in the reference):

* ``os``: the optimizer state (moments, master weights) of this rank's
  rows of each parameter; the full gradient is all-reduced, each rank
  updates its rows, and the rows are all-gathered back into the
  parameter;
* ``os_g``: the same with the gradient reduce-scattered, so each rank
  holds only its rows of it;
* ``p_g_os``: the parameter itself is this rank's rows
  (``param.data`` is replaced; ``_sharding_spec`` records ``P(axis,
  None, ...)``); the step all-gathers it before the forward and
  reduce-scatters its gradient in the backward.

Parameters split by tensor parallelism (an ``_sharding_spec`` already)
are left to it, as in the reference (:61-66).
"""
from __future__ import annotations

import os

import torch

from .collective import P
from .mesh import axis_size, get_mesh, local_block

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = ("os", "os_g", "p_g_os")


def _shardable(shape, n) -> bool:
    return len(shape) > 0 and shape[0] % n == 0 and shape[0] >= n


def group_sharded_parallel(model, optimizer, level: str = "p_g_os",
                           scaler=None, group=None, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, mesh=None,
                           axis: str = "sharding"):
    """Reference :38-67. Returns ``(model, optimizer, scaler)``."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    mesh = mesh or get_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        raise RuntimeError(
            f"group_sharded_parallel needs a mesh with a {axis!r} axis")
    n = axis_size(mesh, axis)
    optimizer._shard_states_axis = axis
    optimizer._shard_states_mesh = mesh
    optimizer._shard_level = level
    if level == "p_g_os" and n > 1:
        with torch.no_grad():
            for p in model.parameters():
                if getattr(p, "_sharding_spec", None) is None and \
                        _shardable(p.shape, n):
                    spec = P(axis, *([None] * (p.dim() - 1)))
                    p.data = local_block(p.detach(), spec,
                                         mesh).contiguous()
                    p._sharding_spec = spec
                    p._sharding_mesh = mesh
    return model, optimizer, scaler


def save_group_sharded_model(model, output: str, optimizer=None):
    """Reference :70-76: the model's full state (sharded parameters
    gathered) into ``output/model.pdmodel``, and the optimizer's into
    ``model.pdopt`` when given. Every rank calls it; rank 0 writes."""
    from paddle_tpu_torch.framework.io import save
    from paddle_tpu_torch.utils.bridge import full_state_dict
    from .env import get_rank
    state = full_state_dict(model)
    if get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        save(state, os.path.join(output, "model.pdmodel"))
        if optimizer is not None:
            save(optimizer.state_dict(), os.path.join(output,
                                                      "model.pdopt"))
