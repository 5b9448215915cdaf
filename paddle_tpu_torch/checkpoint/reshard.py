"""Restore: shard assembly and integrity checks — port of
``paddle_tpu/checkpoint/reshard.py``.

Assembly is independent of the mesh that wrote a step: the manifest
records each shard's global ``offset`` and ``shape``, so the reader
pastes the shards into the full logical tensor whatever the writing
topology was. Every shard and the pickled skeleton are crc32-checked
before use; a mismatch raises :class:`CheckpointIntegrityError`.

A ``"tensor"`` (or the reference's ``"jax"``) leaf comes back as a torch
tensor on the requested device, read from the raw bytes in the
manifest's dtype (bfloat16 as ``torch.bfloat16``, never through numpy);
an ``"ndarray"`` leaf comes back as numpy on the host.

Not ported yet: ``place_on_mesh`` (placing onto a device mesh) raises
``NotImplementedError``; :func:`mesh_topology` knows one device only.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

from .layout import (CheckpointError, CheckpointIntegrityError, crc32_of,
                     is_committed, loads_skeleton, read_index,
                     torch_dtype, unflatten_state)

__all__ = ["assemble_tensor", "read_state", "place_on_mesh",
           "mesh_topology"]


def mesh_topology(mesh) -> dict:
    """Axis name -> size of the writing topology: ``{}`` for one device
    (``mesh=None``); a mesh is not ported yet."""
    if mesh is None:
        return {}
    raise NotImplementedError(
        "device meshes are not ported to paddle_tpu_torch yet")


def place_on_mesh(arr, mesh):
    raise NotImplementedError(
        "placing a restored tensor onto a device mesh is not ported to "
        "paddle_tpu_torch yet")


def _read_file(path: str, what: str) -> bytearray:
    if not os.path.isfile(path):
        raise CheckpointIntegrityError(f"missing {what}: {path!r}")
    with open(path, "rb") as f:
        return bytearray(f.read())


def _shard_bytes(rec: dict, step_dir: str, verify: bool, itemsize: int,
                 dtype_name: str) -> bytearray:
    """One shard's raw bytes, crc- and size-checked against the manifest."""
    what = rec.get("file") or f"offset {rec['offset']}"
    data = _read_file(os.path.join(step_dir, rec["file"]),
                      f"shard (owner rank {rec.get('owner', 0)})")
    if verify and rec.get("crc32") is not None \
            and crc32_of(data) != rec["crc32"]:
        raise CheckpointIntegrityError(
            f"checksum mismatch on shard {what!r} "
            f"(owner rank {rec.get('owner', 0)})")
    expected = int(np.prod(rec["shape"])) * itemsize
    if len(data) != expected:
        raise CheckpointIntegrityError(
            f"shard {what!r} holds {len(data)} bytes, manifest "
            f"shape {rec['shape']} x {dtype_name} needs {expected}")
    return data


def assemble_tensor(entry: dict, step_dir: str, verify: bool = True):
    """Paste a tensor's shards into the full logical array on the host: a
    CPU torch tensor, or numpy for an ``"ndarray"`` leaf."""
    if entry.get("kind") == "ndarray":
        try:
            dt = np.dtype(entry["dtype"])
        except TypeError as e:
            raise CheckpointError(
                f"numpy leaf of dtype {entry['dtype']!r}, which numpy "
                "cannot hold here") from e
        full = np.empty(entry["shape"], dtype=dt)
        for rec in entry["shards"]:
            data = _shard_bytes(rec, step_dir, verify, dt.itemsize,
                                entry["dtype"])
            full[_slices(rec)] = np.frombuffer(data, dtype=dt).reshape(
                rec["shape"])
        return full
    dt = torch_dtype(entry["dtype"])
    itemsize = torch.empty((), dtype=dt).element_size()
    shards = [(rec, _shard_bytes(rec, step_dir, verify, itemsize,
                                 entry["dtype"])) for rec in entry["shards"]]
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


def _slices(rec: dict):
    return tuple(slice(o, o + s) for o, s in zip(rec["offset"],
                                                 rec["shape"]))


def read_state(step_dir: str, verify: bool = True, mesh=None,
               registry=None, device=None):
    """One committed step directory back into a nested state tree, every
    ``"tensor"`` leaf on ``device`` (``None``: the CUDA card, raising
    where there is none)."""
    from .writer import ckpt_metrics

    if mesh is not None:
        place_on_mesh(None, mesh)
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

    arrays: Dict[str, object] = {}
    nbytes = len(skel_bytes)
    for key, entry in doc["tensors"].items():
        full = assemble_tensor(entry, step_dir, verify=verify)
        nbytes += full.nbytes
        if isinstance(full, torch.Tensor):
            full = full.to(device)
        arrays[key] = full

    state = unflatten_state(skeleton, arrays)
    m = ckpt_metrics(registry)
    m["restore_seconds"].observe(time.perf_counter() - t0)
    m["bytes"].inc(nbytes, direction="read")
    return state
