"""Restore: shard assembly, integrity checks and placement onto a mesh —
port of ``paddle_tpu/checkpoint/reshard.py``.

Assembly is independent of the mesh that wrote a step: the manifest
records each shard's global ``offset`` and ``shape``, so the reader
pastes the shards into the full logical tensor whatever the writing
topology was. Every shard and the pickled skeleton are crc32-checked
before use; a mismatch raises :class:`CheckpointIntegrityError`.
:func:`assemble_from` takes the shards' bytes from any transport (the
files here, the job's TCPStore in an elastic resize), so both paths run
one pasting loop.

A ``"tensor"`` (or the reference's ``"jax"``) leaf comes back as a torch
tensor on the requested device, read from the raw bytes in the
manifest's dtype (bfloat16 as ``torch.bfloat16``, never through numpy);
an ``"ndarray"`` leaf comes back as numpy on the host.

With ``mesh`` (the port's process mesh, a ``DeviceMesh``), every tensor
leaf is placed onto it by the reference's rule (:func:`_partition_spec`:
the largest dim that divides, over as many mesh axes as divide it, in
the mesh's order): a ``DTensor`` whose local part is this rank's block,
as ``distributed.shard_tensor`` returns. Every rank assembles the whole
tensor and keeps its block; no collective runs.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

from .layout import (IO_WORKERS, CheckpointError, CheckpointIntegrityError,
                     crc32_of, is_committed, loads_skeleton, read_index,
                     torch_dtype, unflatten_state)

__all__ = ["assemble_tensor", "assemble_from", "read_state",
           "place_on_mesh", "mesh_topology"]


def mesh_topology(mesh) -> dict:
    """Axis name -> size of a mesh (``{}`` for ``mesh=None``): what the
    save side records as the writing topology."""
    if mesh is None:
        return {}
    return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names,
                                           mesh.shape)}


def _partition_spec(shape, mesh):
    """The spec sharding the largest divisible dim across as many mesh
    axes as divide it (axes taken in the mesh's order); every dim None
    when nothing divides (replicated). Reference :106-131."""
    from paddle_tpu_torch.distributed.collective import P
    axes = list(mesh.mesh_dim_names)
    sizes = mesh_topology(mesh)
    best = None  # (covered ranks, -dim, axis subset)
    for dim, size in sorted(enumerate(shape), key=lambda t: -t[1]):
        covered, subset = 1, []
        for ax in axes:
            if size % (covered * sizes[ax]) == 0:
                covered *= sizes[ax]
                subset.append(ax)
        if subset and covered > 1:
            cand = (covered, -dim, subset)
            if best is None or cand[:2] > best[:2]:
                best = cand
    if best is None:
        return P()
    _, negdim, subset = best
    spec = [None] * len(shape)
    spec[-negdim] = tuple(subset) if len(subset) > 1 else subset[0]
    return P(*spec)


def place_on_mesh(arr, mesh, device=None):
    """Lay a full logical tensor (or numpy array) onto ``mesh``: a
    ``DTensor`` holding this rank's block under :func:`_partition_spec`,
    its local part on ``device`` (default: the mesh's device type)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from paddle_tpu_torch.distributed.mesh import local_block
    from paddle_tpu_torch.distributed.sharding_api import \
        _spec_to_placements
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"place_on_mesh takes the port's process mesh (a "
                        f"DeviceMesh), not {type(mesh).__name__}")
    full = torch.as_tensor(arr) if isinstance(arr, np.ndarray) else arr
    device = torch.device(mesh.device_type) if device is None else \
        resolve_device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"a tensor on {device} cannot be placed on a "
                         f"{mesh.device_type} mesh")
    spec = _partition_spec(tuple(full.shape), mesh)
    local = local_block(full, spec, mesh).contiguous().to(device)
    out = DTensor.from_local(local, mesh, _spec_to_placements(spec, mesh),
                             run_check=False, shape=full.shape,
                             stride=full.contiguous().stride())
    out._sharding_spec = spec
    return out


def _read_file(path: str, what: str) -> bytearray:
    """A file's bytes, read straight into a writable buffer."""
    if not os.path.isfile(path):
        raise CheckpointIntegrityError(f"missing {what}: {path!r}")
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view, pos = memoryview(buf), 0
        while pos < len(buf):
            n = f.readinto(view[pos:])
            if not n:
                break
            pos += n
    del view
    return buf if pos == len(buf) else buf[:pos]


def assemble_from(entry: dict, fetch, verify: bool = True):
    """Paste a tensor's shards into the full logical array on the host,
    each shard's raw C-order bytes from ``fetch(rec)`` (reference
    :47-83): a CPU torch tensor, or numpy for an ``"ndarray"`` leaf.
    ``verify`` crc32-checks each shard against the manifest."""
    if entry.get("kind") == "ndarray":
        try:
            dt = np.dtype(entry["dtype"])
        except TypeError as e:
            raise CheckpointError(
                f"numpy leaf of dtype {entry['dtype']!r}, which numpy "
                "cannot hold here") from e
        itemsize = dt.itemsize
    else:
        dt = torch_dtype(entry["dtype"])
        itemsize = torch.empty((), dtype=dt).element_size()

    def checked(rec):
        data = fetch(rec)
        what = rec.get("file") or f"offset {rec['offset']}"
        if verify and rec.get("crc32") is not None \
                and crc32_of(data) != rec["crc32"]:
            raise CheckpointIntegrityError(
                f"checksum mismatch on shard {what!r} "
                f"(owner rank {rec.get('owner', 0)})")
        expected = int(np.prod(rec["shape"])) * itemsize
        if len(data) != expected:
            raise CheckpointIntegrityError(
                f"shard {what!r} holds {len(data)} bytes, manifest "
                f"shape {rec['shape']} x {entry['dtype']} needs "
                f"{expected}")
        return data

    if isinstance(dt, np.dtype):
        full = np.empty(entry["shape"], dtype=dt)
        for rec in entry["shards"]:
            full[_slices(rec)] = np.frombuffer(
                checked(rec), dtype=dt).reshape(rec["shape"])
        return full
    shards = []
    for rec in entry["shards"]:
        data = checked(rec)  # torch.frombuffer wants a writable buffer
        shards.append((rec, data if isinstance(data, bytearray)
                       else bytearray(data)))
    if len(shards) == 1 and shards[0][1]:  # the whole tensor, no copy
        rec, data = shards[0]
        return torch.frombuffer(data, dtype=torch.uint8).view(dt).reshape(
            rec["shape"])
    full = torch.empty(entry["shape"], dtype=dt)
    for rec, data in shards:
        if data:
            full[_slices(rec)] = torch.frombuffer(
                data, dtype=torch.uint8).view(dt).reshape(rec["shape"])
    return full


def assemble_tensor(entry: dict, step_dir: str, verify: bool = True):
    """Paste a tensor's shards, read from ``step_dir``, into the full
    logical array on the host."""
    def fetch(rec):
        return _read_file(os.path.join(step_dir, rec["file"]),
                          f"shard (owner rank {rec.get('owner', 0)})")
    return assemble_from(entry, fetch, verify=verify)


def _slices(rec: dict):
    return tuple(slice(o, o + s) for o, s in zip(rec["offset"],
                                                 rec["shape"]))


def read_state(step_dir: str, verify: bool = True, mesh=None,
               registry=None, device=None):
    """One committed step directory back into a nested state tree, every
    ``"tensor"`` leaf on ``device`` (``None``: the CUDA card, raising
    where there is none), or, with ``mesh``, placed onto it
    (:func:`place_on_mesh`)."""
    from .writer import ckpt_metrics

    device = resolve_device(device)
    t0 = time.perf_counter()
    if not is_committed(step_dir):
        raise CheckpointError(
            f"{step_dir!r} is not a committed checkpoint step")
    doc = read_index(step_dir)
    aux = doc["aux"]
    skel_bytes = bytes(_read_file(os.path.join(step_dir, aux["file"]),
                                  "state skeleton"))
    if verify and aux.get("crc32") is not None and \
            crc32_of(skel_bytes) != aux["crc32"]:
        raise CheckpointIntegrityError(
            f"checksum mismatch on state skeleton in {step_dir!r}")
    skeleton = loads_skeleton(skel_bytes)

    def load(entry):
        full = assemble_tensor(entry, step_dir, verify=verify)
        if isinstance(full, torch.Tensor) and mesh is None:
            return full.nbytes, full.to(device)
        return full.nbytes, full

    arrays: Dict[str, object] = {}
    nbytes = len(skel_bytes)
    with ThreadPoolExecutor(IO_WORKERS) as pool:
        loaded = list(pool.map(load, doc["tensors"].values()))
    for key, (n, full) in zip(doc["tensors"], loaded):
        nbytes += n
        if isinstance(full, torch.Tensor) and mesh is not None:
            full = place_on_mesh(full, mesh, device)
        arrays[key] = full

    state = unflatten_state(skeleton, arrays)
    m = ckpt_metrics(registry)
    m["restore_seconds"].observe(time.perf_counter() - t0)
    m["bytes"].inc(nbytes, direction="read")
    return state
