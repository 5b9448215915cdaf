"""Device mesh and the global default mesh — port of
``paddle_tpu/distributed/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
processes of the job (one rank, one device), with the reference's axis
names: ``dp`` (data), ``pp`` (pipeline), ``sharding`` (ZeRO), ``mp``
(tensor) and ``sp`` (sequence). Rank ``r`` sits at the row-major
coordinate of ``r`` in the mesh's shape, and every axis has its process
group (``DeviceMesh.get_group``), which is where the collectives of a
:class:`~paddle_tpu_torch.distributed.collective.Group` naming that axis
run. The reference's mesh is over the devices one process drives; here
it is over processes, so a shape must multiply to the world size
(reference :42-44 raises alike).

Helpers that the rest of the package shares: :func:`mesh_shape`,
:func:`axis_size`, :func:`axis_index` (this rank's coordinate on an
axis or a tuple of axes, the first axis major) and
:func:`axes_group` (the process group of a tuple of axes), and for a
tensor split by a partition spec (one axis name, a tuple of them, or
None per dim), :func:`spec_axes` and :func:`local_block`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_mesh", "get_mesh", "set_mesh", "mesh_scope", "ProcessMesh",
           "DEFAULT_AXES", "mesh_shape", "axis_size", "axis_index",
           "axes_group", "spec_axes", "local_block"]

DEFAULT_AXES = ("dp", "pp", "sharding", "mp", "sp")

_state = {"mesh": None}
# (id(mesh), axes) -> process group of ranks varying only along ``axes``
_groups: dict = {}


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def init_mesh(shape: Optional[Dict[str, int]] = None, device_type=None):
    """Build the default mesh over the job's processes. ``shape`` maps
    axis name to size, e.g. ``{"dp": 2, "mp": 2}``, and must multiply to
    the world size; with no shape every rank goes on ``dp``. Needs the
    process group (``init_parallel_env``). ``device_type`` is the mesh's
    for ``torch.distributed.tensor`` (default ``cuda`` under NCCL, else
    ``cpu``)."""
    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs the process group: call "
                           "paddle.distributed.init_parallel_env() first")
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if shape is None:
        shape = {"dp": n}
    sizes = [int(s) for s in shape.values()]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} processes")
    mesh = init_device_mesh(device_type or _device_type(), tuple(sizes),
                            mesh_dim_names=tuple(shape.keys()))
    _state["mesh"] = mesh
    return mesh


def get_mesh():
    """The current default mesh (None until init_mesh/set_mesh)."""
    return _state["mesh"]


def set_mesh(mesh):
    _state["mesh"] = mesh
    return mesh


@contextlib.contextmanager
def mesh_scope(mesh):
    prev = _state["mesh"]
    _state["mesh"] = mesh
    try:
        yield mesh
    finally:
        _state["mesh"] = prev


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (an axis name or a tuple); an
    axis the mesh lacks counts 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    shape = mesh_shape(mesh)
    return int(np.prod([shape.get(a, 1) for a in axes]))


def axis_index(mesh, axes) -> int:
    """This rank's linear index along ``axes`` (the first axis major, as
    the reference's ``_linear_rank``); 0 along an axis the mesh lacks."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape = mesh_shape(mesh)
    idx = 0
    for a in axes:
        idx = idx * shape.get(a, 1) + coord.get(a, 0)
    return idx


def axes_group(mesh, axes):
    """The process group of the ranks that differ from this one only
    along ``axes``: the mesh's own group for one axis, the world for all
    of them, else a group made the first time (every rank makes its own
    set of such groups at the same call, as collectives are called). A
    group's ranks are in the mesh's order, so ``axes`` are taken in the
    mesh's order too."""
    axes = set((axes,) if isinstance(axes, str) else axes)
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes == names:
        return dist.group.WORLD
    key = (id(mesh), axes)
    if key not in _groups:
        ranks = mesh.mesh.cpu().numpy()
        keep = [names.index(a) for a in axes]
        other = [i for i in range(len(names)) if i not in keep]
        arr = np.transpose(ranks, other + keep).reshape(
            -1, int(np.prod([ranks.shape[i] for i in keep])))
        mine, _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in row] for row in arr])
        _groups[key] = mine
    return _groups[key]


def spec_axes(spec, mesh=None) -> tuple:
    """The mesh axes a partition spec splits over, in the mesh's order
    (those of ``mesh`` only, when one is given)."""
    axes = set()
    for e in spec or ():
        if e is not None:
            axes |= {e} if isinstance(e, str) else set(e)
    order = tuple(mesh.mesh_dim_names) if mesh is not None else \
        DEFAULT_AXES + tuple(sorted(axes - set(DEFAULT_AXES)))
    return tuple(a for a in order if a in axes)


def local_block(full, spec, mesh):
    """This rank's block of the global tensor ``full`` under ``spec``
    (a view)."""
    x = full
    for d, e in enumerate(spec or ()):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        n = axis_size(mesh, axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not "
                             f"divide by the {n} ranks of {axes}")
        c = x.shape[d] // n
        x = x.narrow(d, axis_index(mesh, spec_axes((e,), mesh)) * c, c)
    return x


class ProcessMesh:
    """Auto-parallel style mesh descriptor (reference :82-122): an N-D
    array of global ranks with dim names, convertible to a
    ``DeviceMesh``."""

    def __init__(self, mesh: Sequence, dim_names: Optional[List[str]] = None,
                 process_ids=None):
        if process_ids is not None:
            self._array = np.asarray(process_ids).reshape(list(mesh))
        else:
            self._array = np.asarray(mesh)
        self._dim_names = list(dim_names) if dim_names is not None else \
            [f"d{i}" for i in range(self._array.ndim)]

    @property
    def shape(self):
        return list(self._array.shape)

    @property
    def ndim(self):
        return self._array.ndim

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return [int(r) for r in self._array.flatten()]

    def get_dim_size(self, name):
        return self._array.shape[self._dim_names.index(name)]

    def to_device_mesh(self, device_type=None):
        """The ``DeviceMesh`` over these ranks (the reference's
        ``to_jax``); every rank of the world calls it."""
        from torch.distributed.device_mesh import DeviceMesh
        return DeviceMesh(device_type or _device_type(),
                          torch.as_tensor(self._array),
                          mesh_dim_names=tuple(self._dim_names))

    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and \
            np.array_equal(self._array, other._array) and \
            self._dim_names == other._dim_names

    def __hash__(self):
        return hash((self._array.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dims={self._dim_names})"
