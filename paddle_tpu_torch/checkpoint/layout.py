"""Checkpoint on-disk layout — port of ``paddle_tpu/checkpoint/layout.py``.

The format is the reference's, unchanged, so a step directory written by
either package restores in the other::

    <root>/
      step_12.tmp/          # in-flight save — never loadable
      step_12/              # committed step
        COMMITTED           # commit marker (written before the rename)
        index.json          # name -> shape/dtype/grid/per-shard crc32
        aux.pkl             # pickled state skeleton (non-array leaves and
                            # _TensorRef placeholders; keeps namedtuples)
        t0000_s000.bin ...  # one raw C-order bytes file per shard

A step is committed iff its directory does not end in ``.tmp`` and holds
the ``COMMITTED`` marker.

Two places where the port must say exactly what the reference says:

* ``aux.pkl`` names the placeholder class by the reference's global,
  ``paddle_tpu.checkpoint.layout._TensorRef``, since the reference reads
  the skeleton with a bare ``pickle.loads``. :func:`dumps_skeleton`
  writes that global for the port's :class:`_TensorRef` without
  importing the JAX package (a pickler whose ``save_global`` emits the
  name itself), and :func:`loads_skeleton` reads with a restricted
  unpickler that maps that one global to the port's class and refuses
  any other ``paddle_tpu.*`` global with :class:`CheckpointError`.
* bfloat16 shards are raw 2-byte words, read and written as
  ``torch.bfloat16`` tensors; the manifest's ``"bfloat16"`` never goes
  through numpy (which has no bfloat16 of its own).
"""
from __future__ import annotations

import io
import itertools
import json
import os
import pickle
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FORMAT_VERSION", "INDEX_FILE", "COMMIT_MARKER", "AUX_FILE",
    "TMP_SUFFIX", "STEP_PREFIX", "CheckpointError",
    "CheckpointIntegrityError", "step_dir_name", "parse_step_dir",
    "is_committed", "list_committed_steps", "plan_grid", "iter_shards",
    "crc32_of", "flatten_state", "unflatten_state", "write_index",
    "read_index", "is_checkpoint_dir", "dumps_skeleton",
    "loads_skeleton", "torch_dtype", "dtype_name", "poll_until",
    "IO_WORKERS",
]

FORMAT_VERSION = 1
#: threads that read or write a step's shard files at once: the file
#: syscalls, zlib's crc32 and torch's copies all run without the GIL
IO_WORKERS = min(8, os.cpu_count() or 1)
INDEX_FILE = "index.json"
COMMIT_MARKER = "COMMITTED"
AUX_FILE = "aux.pkl"
TMP_SUFFIX = ".tmp"
STEP_PREFIX = "step_"

#: the global the reference pickles its placeholders under; a format tag
#: here, never imported
REF_GLOBAL = ("paddle_tpu.checkpoint.layout", "_TensorRef")

#: manifest dtype names <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CheckpointError(RuntimeError):
    """Malformed/unusable checkpoint directory."""


class CheckpointIntegrityError(CheckpointError):
    """Checksum mismatch or missing shard — the step is corrupt."""


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise CheckpointError(f"unknown dtype {name!r} in manifest")
    return _DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    if dtype not in _NAMES:
        raise CheckpointError(f"a tensor of dtype {dtype} cannot be "
                              f"checkpointed (want one of {sorted(_DTYPES)})")
    return _NAMES[dtype]


def step_dir_name(step: int) -> str:
    return f"{STEP_PREFIX}{int(step)}"


def parse_step_dir(name: str) -> Optional[int]:
    """``step_12`` -> 12; anything else (incl. ``step_12.tmp``) -> None."""
    if not name.startswith(STEP_PREFIX) or name.endswith(TMP_SUFFIX):
        return None
    try:
        return int(name[len(STEP_PREFIX):])
    except ValueError:
        return None


def is_committed(step_dir: str) -> bool:
    return (not step_dir.rstrip(os.sep).endswith(TMP_SUFFIX)
            and os.path.isfile(os.path.join(step_dir, COMMIT_MARKER))
            and os.path.isfile(os.path.join(step_dir, INDEX_FILE)))


def list_committed_steps(root: str) -> List[int]:
    """Ascending committed step numbers under ``root``."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        s = parse_step_dir(name)
        if s is not None and is_committed(os.path.join(root, name)):
            steps.append(s)
    return sorted(steps)


def is_checkpoint_dir(path: str) -> bool:
    """True for a manager root (has committed steps) or a single step dir."""
    if not os.path.isdir(path):
        return False
    return bool(list_committed_steps(path)) or \
        os.path.isfile(os.path.join(path, INDEX_FILE))


# ---------------------------- shard planning --------------------------------

def plan_grid(shape: Sequence[int], nshards: int) -> List[int]:
    """Parts per dim for ``nshards`` writers: the largest dim that divides
    evenly by the largest feasible part count; otherwise one shard."""
    grid = [1] * len(shape)
    if nshards <= 1 or not shape:
        return grid
    for parts in range(min(nshards, max(shape) if shape else 1), 1, -1):
        divisible = [(size, dim) for dim, size in enumerate(shape)
                     if size % parts == 0 and size >= parts]
        if divisible:
            _, dim = max(divisible)
            grid[dim] = parts
            return grid
    return grid


def iter_shards(shape: Sequence[int], grid: Sequence[int]):
    """Yield ``(flat_pos, offset, shard_shape, slices)`` for every shard
    of the grid, in row-major grid order."""
    shape = list(shape)
    grid = list(grid)
    steps = [s // g for s, g in zip(shape, grid)] or []
    for flat_pos, index in enumerate(itertools.product(
            *[range(g) for g in grid])):
        offset = [i * st for i, st in zip(index, steps)]
        shard_shape = list(steps)
        slices = tuple(slice(o, o + sh)
                       for o, sh in zip(offset, shard_shape))
        yield flat_pos, offset, shard_shape, slices


def poll_until(predicate: Callable[[], bool], what: str,
               timeout: float = 600.0, interval: float = 0.005):
    """The filesystem barrier of a save from several processes (commit
    markers, the ranks' shard records): poll ``predicate`` until true,
    raising ``TimeoutError`` naming ``what`` after ``timeout`` seconds
    (the reference's default; it reads
    ``PADDLE_TPU_CKPT_BARRIER_TIMEOUT``, the port no variable)."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"timed out after {timeout}s waiting for {what}; "
                f"no commit observed")
        time.sleep(interval)


def crc32_of(data) -> int:
    """crc32 of a bytes-like object (bytes, bytearray, numpy buffer)."""
    return zlib.crc32(data) & 0xFFFFFFFF


# ------------------------- state tree flattening ----------------------------

class _TensorRef:
    """Placeholder pickled into aux.pkl where an array leaf sat.

    ``kind``: ``"tensor"`` (restored as a torch tensor), ``"jax"`` (a bare
    jax array of the reference, restored as a torch tensor too) or
    ``"ndarray"`` (numpy, restored as numpy). ``stop_gradient`` and
    ``name`` are the reference's Tensor attributes, kept for it."""

    __slots__ = ("key", "kind", "stop_gradient", "name")

    def __init__(self, key: str, kind: str, stop_gradient: bool = True,
                 name: str = ""):
        self.key = key
        self.kind = kind
        self.stop_gradient = stop_gradient
        self.name = name

    def __getstate__(self):
        return (self.key, self.kind, self.stop_gradient, self.name)

    def __setstate__(self, st):
        self.key, self.kind, self.stop_gradient, self.name = st


def flatten_state(state) -> Tuple[object, Dict[str, tuple]]:
    """Split a nested state into (skeleton, leaves).

    The skeleton mirrors ``state``'s containers (dicts, lists, tuples,
    namedtuples) with every tensor or array leaf replaced by a
    :class:`_TensorRef`; ``leaves`` maps ref key -> (the live tensor or
    array, ref). Nothing is copied here: ``writer.snapshot`` takes the
    owned host copies."""
    leaves: Dict[str, tuple] = {}
    counter = itertools.count()

    def ref_for(value, kind, stop_gradient=True):
        key = f"t{next(counter):04d}"
        ref = _TensorRef(key, kind, stop_gradient, "")
        leaves[key] = (value, ref)
        return ref

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            return ref_for(obj, "tensor", not obj.requires_grad)
        if isinstance(obj, np.ndarray):
            return ref_for(obj, "ndarray")
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*[walk(v) for v in obj])
        if isinstance(obj, (list, tuple)):
            seq = [walk(v) for v in obj]
            return seq if isinstance(obj, list) else tuple(seq)
        return obj  # scalars, numpy scalars, strings: pickled as they are

    return walk(state), leaves


def unflatten_state(skeleton, arrays: Dict[str, object]):
    """Inverse of :func:`flatten_state`: the nested state from the
    skeleton and the assembled leaves (torch tensors, numpy arrays for
    ``"ndarray"`` refs), keyed by ref key."""

    def walk(obj):
        if isinstance(obj, _TensorRef):
            return arrays[obj.key]
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*[walk(v) for v in obj])
        if isinstance(obj, (list, tuple)):
            seq = [walk(v) for v in obj]
            return seq if isinstance(obj, list) else tuple(seq)
        return obj

    return walk(skeleton)


# ------------------------------ the skeleton --------------------------------

class _SkeletonPickler(pickle._Pickler):
    """The standard pickler with one change: the port's ``_TensorRef``
    class is written under the reference's global name, which the
    standard ``save_global`` would refuse (it imports the module to check
    the name). The pure-Python pickler is used for this hook; skeletons
    are small."""

    def save_global(self, obj, name=None):
        if obj is not _TensorRef:
            return super().save_global(obj, name)
        module, qualname = REF_GLOBAL
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + module.encode() + b"\n"
                       + qualname.encode() + b"\n")
        self.memoize(obj)


def dumps_skeleton(skeleton) -> bytes:
    buf = io.BytesIO()
    _SkeletonPickler(buf, protocol=4).dump(skeleton)
    return buf.getvalue()


class _SkeletonUnpickler(pickle.Unpickler):
    """Maps the reference's placeholder global to the port's class and
    refuses every other global of the JAX package."""

    def find_class(self, module, name):
        if (module, name) == REF_GLOBAL or \
                (module, name) == (__name__, "_TensorRef"):
            return _TensorRef
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            raise CheckpointError(
                f"checkpoint skeleton names {module}.{name}, a class of "
                "the JAX package that the port does not read")
        return super().find_class(module, name)


def loads_skeleton(data: bytes):
    return _SkeletonUnpickler(io.BytesIO(data)).load()


# ------------------------------- manifest -----------------------------------

def write_index(step_dir: str, doc: dict):
    """fsynced atomic write of the manifest into ``step_dir``."""
    path = os.path.join(step_dir, INDEX_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_index(step_dir: str) -> dict:
    path = os.path.join(step_dir, INDEX_FILE)
    if not os.path.isfile(path):
        raise CheckpointError(f"no {INDEX_FILE} in {step_dir!r}")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointIntegrityError(
            f"unreadable manifest in {step_dir!r}: {e}") from e
    if doc.get("format_version") != FORMAT_VERSION:
        raise CheckpointError(
            f"unsupported checkpoint format_version "
            f"{doc.get('format_version')!r} in {step_dir!r}")
    return doc
