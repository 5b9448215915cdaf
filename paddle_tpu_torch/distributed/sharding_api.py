"""Tensor placements — port of ``paddle_tpu/distributed/sharding_api.py``.

``Shard``, ``Replicate`` and ``Partial`` are ``torch.distributed.tensor``'s
placements, under the same names: one placement per mesh axis, as in
Paddle's ``shard_tensor``. :func:`shard_tensor` places a global tensor
on the mesh as a ``DTensor`` (each rank keeps its block) and records the
equivalent partition spec in ``_sharding_spec``; :func:`reshard`
redistributes one (PyTorch emits the collectives, the reference's
Resharder's job). A spec (:class:`~.collective.P`, one mesh axis or None
per tensor dim) converts to placements and back.

Differences the ranks-as-processes model brings: a placed tensor is a new
``DTensor`` (a ``Parameter`` in, a ``Parameter`` out), where the
reference re-binds the parameter's storage in place, so callers keep the
returned object; and :func:`with_sharding_constraint`, an in-trace hint
to the reference's compiler, redistributes a ``DTensor`` and returns a
plain tensor unchanged. ``Partial`` is refused in ``placements``, as in
the reference (:50-64): a pending reduction is asked for with
``all_reduce``.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from paddle_tpu_torch.core.tensor import unwrap

from .collective import P
from .mesh import get_mesh

__all__ = ["Shard", "Replicate", "Partial", "shard_tensor", "reshard",
           "named_sharding", "spec_of", "with_sharding_constraint"]

_PLACEMENTS = ("Shard", "Replicate", "Partial")


def __getattr__(name):
    # torch.distributed.tensor takes about a second to import: it loads
    # when a placement is first asked for, not with the package
    if name in _PLACEMENTS:
        import torch.distributed.tensor as dt
        return getattr(dt, name)
    raise AttributeError(name)


def _dt():
    import torch.distributed.tensor as dt
    return dt


def _placements_to_spec(placements: Sequence, mesh, ndim: int) -> P:
    """``placements[i]`` describes mesh axis ``i`` (Paddle's convention):
    the per-tensor-dim spec."""
    dt = _dt()
    dim_axes: List[Optional[object]] = [None] * ndim
    for axis_idx, pl in enumerate(placements):
        if isinstance(pl, dt.Partial):
            raise NotImplementedError(
                "Partial placement cannot be annotated on a tensor here: "
                "compute the reduction explicitly (all_reduce) or use "
                "Replicate/Shard placements.")
        if isinstance(pl, dt.Shard):
            name = mesh.mesh_dim_names[axis_idx]
            cur = dim_axes[pl.dim]
            if cur is None:
                dim_axes[pl.dim] = name
            elif isinstance(cur, tuple):
                dim_axes[pl.dim] = cur + (name,)
            else:
                dim_axes[pl.dim] = (cur, name)
    return P(*dim_axes)


def _spec_to_placements(spec, mesh) -> list:
    """One placement per mesh axis: ``Shard(d)`` where dim ``d``'s entry
    names the axis, else ``Replicate()``."""
    dt = _dt()
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if e == name or (
            isinstance(e, tuple) and name in e)]
        out.append(dt.Shard(dims[0]) if dims else dt.Replicate())
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return _spec_to_placements(self.spec, self.mesh)


def named_sharding(spec, mesh=None) -> NamedSharding:
    return NamedSharding(mesh or get_mesh(), P(*spec))


def shard_tensor(x, mesh=None, placements=None, spec=None,
                 stop_gradient=None):
    """Place the global tensor ``x`` on the mesh (``placements``, one per
    mesh axis, or a ``spec``): a ``DTensor`` whose local part is this
    rank's block, a ``Parameter`` for a parameter."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError("no default mesh; call dist.init_mesh first")
    dt = _dt()
    t = unwrap(x.to_local() if isinstance(x, dt.DTensor) else x)
    if spec is None:
        spec = _placements_to_spec(placements or [], mesh, t.dim())
    else:
        spec = P(*spec)
    placed = dt.distribute_tensor(t.detach(), mesh,
                                  _spec_to_placements(spec, mesh))
    grad = x.requires_grad if stop_gradient is None else not stop_gradient
    out = torch.nn.Parameter(placed, requires_grad=grad) \
        if isinstance(x, torch.nn.Parameter) else placed.requires_grad_(grad)
    out._sharding_spec = spec
    return out


def reshard(x, mesh=None, placements=None, spec=None):
    """``x`` under new placements (a ``DTensor`` is redistributed)."""
    mesh = mesh or get_mesh()
    if isinstance(x, _dt().DTensor) and x.device_mesh is mesh:
        if spec is None:
            spec = _placements_to_spec(placements or [], mesh, x.dim())
        out = x.redistribute(mesh, _spec_to_placements(P(*spec), mesh))
        out._sharding_spec = P(*spec)
        return out
    return shard_tensor(x, mesh, placements, spec)


def spec_of(t) -> P:
    """The partition spec of a tensor (fully replicated if none)."""
    if "torch.distributed.tensor" in sys.modules and \
            isinstance(t, _dt().DTensor):
        return _placements_to_spec(t.placements, t.device_mesh, t.dim())
    s = getattr(t, "_sharding_spec", None)
    return s if s is not None else P()


def with_sharding_constraint(t, spec, mesh=None):
    """A ``DTensor`` redistributed to ``spec``; any other tensor as it
    is (its values are the constraint's result already)."""
    if "torch.distributed.tensor" in sys.modules and \
            isinstance(t, _dt().DTensor):
        return reshard(t, mesh or t.device_mesh, spec=spec)
    return t
