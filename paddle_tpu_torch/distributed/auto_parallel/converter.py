"""Checkpoint resharding across parallel plans — port of
``paddle_tpu/distributed/auto_parallel/converter.py`` (numpy only, as
the reference is): :class:`Converter` merges per-rank shards saved under
the previous distributed attributes and slices them under the current
ones; :func:`pipeline_state_to_spmd` and :func:`spmd_state_to_pipeline`
move a pipeline trunk's state between ``PipelineLayer``'s per-layer keys
(``layers.{i}.{name}``) and ``SpmdPipelineLayer``'s stacked ``[v, S,
...]`` ones, so a run of either engine resumes in the other.

Dist-attr schema: ``{"process_shape": [..], "process_group": [ranks..],
"dims_mapping": [mesh-dim per tensor-dim, -1 = replicated]}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Converter", "pipeline_state_to_spmd", "spmd_state_to_pipeline",
           "uniform_chunk_bounds"]


def _rank_coord(rank_pos: int, process_shape: Sequence[int]) -> List[int]:
    coord = []
    rem = rank_pos
    for s in reversed(process_shape):
        coord.append(rem % s)
        rem //= s
    return list(reversed(coord))


def _shard_slices(full_shape, dims_mapping, process_shape, rank_pos):
    coord = _rank_coord(rank_pos, process_shape)
    slices = []
    for dim, size in enumerate(full_shape):
        m = dims_mapping[dim] if dim < len(dims_mapping) else -1
        if m == -1:
            slices.append(slice(None))
        else:
            parts = process_shape[m]
            if size % parts != 0:
                raise ValueError(
                    f"dim {dim} of size {size} not divisible by mesh dim "
                    f"{m} ({parts} parts)")
            step = size // parts
            start = coord[m] * step
            slices.append(slice(start, start + step))
    return tuple(slices)


class Converter:
    """``convert()`` turns per-rank shard lists saved under ``pre_strategy``
    into the shards required by ``cur_strategy`` (reference surface:
    converter.py Converter.__init__/convert)."""

    def __init__(self, tensors_dict: Dict[str, List[np.ndarray]],
                 pre_strategy: Dict[str, dict],
                 cur_strategy: Dict[str, dict]):
        if not tensors_dict:
            raise ValueError("tensors_dict is empty")
        if not pre_strategy:
            raise ValueError("pre_strategy is empty")
        if not cur_strategy:
            raise ValueError("cur_strategy is empty")
        self._tensors_dict = tensors_dict
        self._pre_strategy = pre_strategy
        self._cur_strategy = cur_strategy

    # -- merge: shards + old dist attr -> full tensor ------------------------
    @staticmethod
    def merge_with_dist_attr(shards: List[np.ndarray],
                             dist_attr: dict) -> np.ndarray:
        process_shape = dist_attr["process_shape"]
        group = dist_attr["process_group"]
        dims_mapping = dist_attr["dims_mapping"]
        if len(shards) != len(group):
            raise ValueError(
                f"{len(shards)} shards for a process group of {len(group)}")
        s0 = np.asarray(shards[0])
        full_shape = list(s0.shape)
        for dim, m in enumerate(dims_mapping):
            if m != -1:
                full_shape[dim] = s0.shape[dim] * process_shape[m]
        full = np.empty(full_shape, s0.dtype)
        for pos, shard in enumerate(shards):
            full[_shard_slices(full_shape, dims_mapping, process_shape,
                               pos)] = np.asarray(shard)
        return full

    # -- slice: full tensor + new dist attr -> this rank's shard -------------
    @staticmethod
    def slice_with_dist_attr(tensor: np.ndarray, dist_attr: dict,
                             rank: int) -> np.ndarray:
        process_shape = dist_attr["process_shape"]
        group = dist_attr["process_group"]
        dims_mapping = dist_attr["dims_mapping"]
        if rank not in group:
            raise ValueError(f"rank {rank} not in process group {group}")
        pos = group.index(rank)
        return np.ascontiguousarray(
            tensor[_shard_slices(tensor.shape, dims_mapping, process_shape,
                                 pos)])

    def convert(self, rank: int = 0,
                strict: bool = True) -> Dict[str, np.ndarray]:
        """Merge every tensor under pre_strategy and slice it for ``rank``
        under cur_strategy. With ``strict=False`` tensors missing from
        either strategy pass through unchanged (reference
        convert_with_prefix_match relaxation)."""
        out = {}
        for name, shards in self._tensors_dict.items():
            pre = self._pre_strategy.get(name)
            cur = self._cur_strategy.get(name)
            if pre is None or cur is None:
                if strict:
                    raise ValueError(
                        f"tensor '{name}' missing from "
                        f"{'pre' if pre is None else 'cur'}_strategy")
                out[name] = np.asarray(shards[0])
                continue
            full = self.merge_with_dist_attr(shards, pre)
            out[name] = self.slice_with_dist_attr(full, cur, rank)
        return out


# ===================== pipeline-layout conversion ============================
# The SPMD pipeline stores the trunk STACKED — one parameter per template
# name with leading [v, S] chunk axes (``fleet/spmd_pipeline.py``), keys
# mangled ``name.replace('.', '__')`` — while PipelineLayer (and a plain
# sequential trunk) keep per-layer entries ``layers.{i}.{param}``. Chunk
# c = r*S + s sits at stacked index [r, s] (the round-robin placement both
# engines share).


def _to_np(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def uniform_chunk_bounds(n_layers: int, num_chunks: int) -> List[int]:
    """The host engine's default 'uniform' segmentation boundaries."""
    base, rem = divmod(n_layers, num_chunks)
    bounds = [0]
    for c in range(num_chunks):
        bounds.append(bounds[-1] + base + (1 if c < rem else 0))
    return bounds


def pipeline_state_to_spmd(state: Dict, num_stages: int,
                           num_virtual_stages: int = 1,
                           bounds: Optional[Sequence[int]] = None,
                           prefix: str = "layers.",
                           block_is_container: bool = True) -> Dict:
    """Host-PipelineLayer / plain-trunk state_dict -> SpmdPipelineLayer
    state_dict.

    ``prefix`` strips the per-layer key prefix (``"layers."`` for the host
    engine's LayerList; ``""`` for a bare Sequential trunk). ``bounds`` are
    the chunk segmentation boundaries (default: uniform). With
    ``block_is_container`` the spmd block_factory wraps each chunk's
    layers in a container (child j of chunk c = trunk layer
    ``bounds[c]+j``); otherwise chunks are single bare layers."""
    S, v = num_stages, num_virtual_stages
    num_chunks = S * v
    sub: Dict[int, Dict[str, np.ndarray]] = {}
    for key, val in state.items():
        if prefix:
            if not key.startswith(prefix):
                raise ValueError(
                    f"key {key!r} lacks trunk prefix {prefix!r} — pass the "
                    "trunk sub-dict (embedding/head live outside the "
                    "pipelined region)")
            key = key[len(prefix):]
        idx_str, rest = key.split(".", 1)
        sub.setdefault(int(idx_str), {})[rest] = _to_np(val)
    n_layers = max(sub) + 1
    bounds = list(bounds) if bounds is not None else \
        uniform_chunk_bounds(n_layers, num_chunks)
    if len(bounds) != num_chunks + 1 or bounds[-1] != n_layers:
        raise ValueError(
            f"bounds {bounds} do not segment {n_layers} layers into "
            f"{num_chunks} chunks")
    if not block_is_container and \
            any(bounds[c + 1] - bounds[c] > 1 for c in range(num_chunks)):
        raise ValueError(
            "block_is_container=False requires exactly one trunk layer "
            "per chunk (multi-layer chunks need a container block)")
    stacked: Dict[str, List[np.ndarray]] = {}
    for c in range(num_chunks):
        for j, i in enumerate(range(bounds[c], bounds[c + 1])):
            # index holes are parameter-less trunk layers (ReLU, Tanh):
            # they occupy a segment slot but contribute no state
            for rest, arr in sub.get(i, {}).items():
                name = f"{j}.{rest}" if block_is_container else rest
                skey = name.replace(".", "__")
                stacked.setdefault(skey, [None] * num_chunks)[c] = arr
    out = {}
    for skey, chunks in stacked.items():
        missing = [c for c, a in enumerate(chunks) if a is None]
        if missing:
            raise ValueError(
                f"param {skey!r} missing from chunks {missing} — the "
                "spmd trunk must be homogeneous")
        arr = np.stack(chunks)          # [v*S, ...]
        out[skey] = arr.reshape((v, S) + arr.shape[1:])
    return out


def spmd_state_to_pipeline(state: Dict, num_stages: int,
                           num_virtual_stages: int = 1,
                           bounds: Optional[Sequence[int]] = None,
                           prefix: str = "layers.",
                           block_is_container: bool = True) -> Dict:
    """SpmdPipelineLayer state_dict -> host-PipelineLayer / plain-trunk
    state_dict (the inverse of :func:`pipeline_state_to_spmd`)."""
    S, v = num_stages, num_virtual_stages
    num_chunks = S * v
    out: Dict[str, np.ndarray] = {}
    per_chunk = None
    for skey, val in state.items():
        arr = _to_np(val)
        if arr.ndim < 2 or arr.shape[:2] != (v, S):
            raise ValueError(
                f"param {skey!r} shape {arr.shape} does not lead with "
                f"[v={v}, S={S}] — not an spmd-pipeline checkpoint")
        name = skey.replace("__", ".")
        if block_is_container:
            j_str, rest = name.split(".", 1)
            j = int(j_str)
        else:
            j, rest = 0, name
        flat = arr.reshape((num_chunks,) + arr.shape[2:])
        if per_chunk is None:
            per_chunk = {}
        for c in range(num_chunks):
            per_chunk.setdefault(c, {})[(j, rest)] = flat[c]
    if per_chunk is None:
        raise ValueError("empty spmd state")
    layers_per_chunk = 1 + max(j for d in per_chunk.values() for j, _ in d)
    n_layers = num_chunks * layers_per_chunk if bounds is None else \
        bounds[-1]
    bounds = list(bounds) if bounds is not None else \
        uniform_chunk_bounds(n_layers, num_chunks)
    for c in range(num_chunks):
        width = bounds[c + 1] - bounds[c]
        for (j, rest), arr in per_chunk[c].items():
            if j >= width:
                raise ValueError(
                    f"chunk {c} child {j} exceeds its segment width "
                    f"{width} under bounds {bounds}")
            out[f"{prefix}{bounds[c] + j}.{rest}"] = arr
    return out
