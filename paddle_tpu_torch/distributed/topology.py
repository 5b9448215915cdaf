"""Hybrid-parallel topology — port of ``paddle_tpu/distributed/topology.py``.

``CommunicateTopology`` is the rank <-> coordinate arithmetic over the
axis order [data, pipe, sharding, model] (pure index math, as in the
reference). ``HybridCommunicateGroup`` makes the default mesh match the
topology (``dp``, ``pp``, ``sharding``, ``mp``) and hands out each axis's
:class:`~.collective.Group`, whose process group is the mesh's group of
that axis.
"""
from __future__ import annotations

from itertools import product
from typing import List, Sequence

import numpy as np

from .collective import Group
from .env import get_rank
from .mesh import get_mesh, init_mesh, mesh_shape

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe",
                                                            "sharding",
                                                            "model"),
                 dims: Sequence[int] = (1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(product(*[range(d) for d in self._dims]))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The rank groups that communicate along ``axis_name``."""
        axis = self._parallel_names.index(axis_name)
        other = [i for i in range(len(self._dims)) if i != axis]
        groups = []
        for other_coord in product(*[range(self._dims[i]) for i in other]):
            ranks = []
            for k in range(self._dims[axis]):
                coord = list(other_coord)
                coord.insert(axis, k)
                ranks.append(self._coord2rank[tuple(coord)])
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for name, v in kwargs.items():
            coord[self._parallel_names.index(name)] = v
        return self._coord2rank[tuple(coord)]


_AXIS_ALIAS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
               "model": "mp", "sep": "sp"}


class HybridCommunicateGroup:
    """Reference :92-147: the per-axis communicators of a topology, over
    a default mesh of its shape (built when the current one differs)."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.nranks = topology.world_size()
        self.global_rank = get_rank()
        names = topology.get_hybrid_group_names()
        self._axis_of = {n: _AXIS_ALIAS.get(n, n) for n in names}
        self._dp_degree = self._deg("data")
        self._pp_degree = self._deg("pipe")
        self._sharding_degree = self._deg("sharding")
        self._mp_degree = self._deg("model")
        mesh = get_mesh()
        shape = {self._axis_of[n]: topology.get_dim(n) for n in names}
        if mesh is None or mesh_shape(mesh) != shape:
            init_mesh(shape)

    def _deg(self, name):
        try:
            return self._topo.get_dim(name)
        except ValueError:
            return 1

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_data_parallel_group(self) -> Group:
        return Group(("dp",))

    def get_model_parallel_group(self) -> Group:
        return Group(("mp",))

    def get_pipe_parallel_group(self) -> Group:
        return Group(("pp",))

    def get_sharding_parallel_group(self) -> Group:
        return Group(("sharding",))

    def get_check_parallel_group(self) -> Group:
        return Group(tuple(get_mesh().mesh_dim_names))

    def topology(self) -> CommunicateTopology:
        return self._topo
