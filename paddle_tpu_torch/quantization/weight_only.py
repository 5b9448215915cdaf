"""Weight-only PTQ for serving — port of
``paddle_tpu/quantization/weight_only.py``: ``(values, scales)`` leaves.

The serving engine quantizes the projection weights of its model once,
at construction (``serving/engine.py``): each selected weight becomes a
:class:`QuantizedLeaf` holding int8 (or ``float8_e4m3fn``) values and f32
per-output-channel scales, its 16- or 32-bit storage is freed, and the
step dequantizes one projection at a time, right before its product.
The reference dequantizes the whole state inside its compiled step and
lets XLA fuse the multiply into each matmul; eagerly, a whole-state
dequantize would hold every weight twice at once, which is the memory
the quantization is there to save.

Calibration comes from the numerics observatory's per-tap range
sketches: a training checkpoint's ``"numerics"`` entry, or a one-batch
:func:`calibrate` pass. A layer whose activation absmax/p99 ratio
exceeds ``ratio`` (32.0, the reference's default of its
``PADDLE_TPU_QUANT_OUTLIER_RATIO``, which the port does not read: the
argument carries it) keeps its original dtype.

Modes (:data:`WEIGHT_MODES`): ``int8_wo`` — symmetric per-channel int8,
scale = absmax/127, rounded half to even and clipped to +-127 as the
reference's ``jnp.round``/``jnp.clip``; ``fp8_wo`` — ``float8_e4m3fn``
storage, scale = absmax/448.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

__all__ = ["QuantizedLeaf", "WEIGHT_MODES", "quantize_leaf",
           "default_target", "quantize_state", "quantized_bytes",
           "calibrate", "calibration_from_checkpoint", "sensitive_params",
           "shard_quantized", "quantization_metrics"]

#: mode -> (storage dtype name, max representable magnitude of the grid)
WEIGHT_MODES = {
    "int8_wo": ("int8", 127.0),
    "fp8_wo": ("float8_e4m3fn", 448.0),
}

#: the reference's default outlier ratio of the sensitivity gate
DEFAULT_OUTLIER_RATIO = 32.0

#: projection weights quantized by default (Llama-family); everything
#: else (norms, embeddings, adapters) keeps its dtype
_DEFAULT_TARGET_SUFFIXES = (
    "q_proj.weight", "k_proj.weight", "v_proj.weight", "o_proj.weight",
    "gate_proj.weight", "up_proj.weight", "down_proj.weight",
    "lm_head.weight",
)


class QuantizedLeaf:
    """A quantized weight in the place of a float one: ``q`` (int8 or
    float8_e4m3fn values, the weight's shape), ``scale`` (f32, one per
    channel along ``axis``) and ``orig_dtype``, the logical dtype that
    :meth:`dequantize` restores and that ``dtype`` reports."""

    __slots__ = ("q", "scale", "axis", "orig_dtype")

    def __init__(self, q, scale, axis: int, orig_dtype):
        self.q = q
        self.scale = scale
        self.axis = int(axis)
        self.orig_dtype = orig_dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.orig_dtype

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()

    def dequantize(self):
        """``values * scales`` in f32, back in ``orig_dtype``."""
        bshape = [1] * self.q.dim()
        bshape[self.axis] = -1
        w = self.q.float() * self.scale.reshape(bshape)
        return w.to(self.orig_dtype)


def quantize_leaf(arr, mode: str, axis: int = 1) -> QuantizedLeaf:
    """Symmetric per-channel quantization of one 2-D weight: the absmax
    grid along ``axis`` (the output-channel axis of an ``[in, out]``
    projection), computed in f32 on the weight's device."""
    name, bound = WEIGHT_MODES[mode]
    with torch.no_grad():
        f = arr.detach().float()
        others = tuple(i for i in range(f.dim()) if i != axis)
        absmax = f.abs().amax(dim=others)
        scale = torch.clamp(absmax, min=1e-12) / bound
        bshape = [1] * f.dim()
        bshape[axis] = -1
        g = f / scale.reshape(bshape)
        if name == "int8":
            q = torch.clamp(torch.round(g), -bound, bound).to(torch.int8)
        else:
            q = g.to(getattr(torch, name))
    return QuantizedLeaf(q, scale.float(), axis, arr.dtype)


# -- calibration --------------------------------------------------------------

def _tap_for_param(name: str) -> Optional[str]:
    """The numerics tap whose range sketch judges a parameter's layer
    (``layers.{i}.attn`` for the attention projections,
    ``layers.{i}.mlp_act`` for the MLP)."""
    m = re.search(r"layers\.(\d+)\.", name)
    if m is None:
        return None
    i = m.group(1)
    leaf = name.rsplit(".", 2)[-2] if name.endswith(".weight") else ""
    if leaf in ("q_proj", "k_proj", "v_proj", "o_proj"):
        return f"layers.{i}.attn"
    if leaf in ("gate_proj", "up_proj", "down_proj"):
        return f"layers.{i}.mlp_act"
    return None


def sensitive_params(names, calibration: Optional[dict],
                     ratio: float = DEFAULT_OUTLIER_RATIO) -> set:
    """Parameter names whose layer's calibration sketch shows
    outlier-heavy activations (absmax/p99 past ``ratio``): they stay
    unquantized. ``calibration`` is a ``{"version": 1, "taps": {...}}``
    summary; None gates nothing."""
    if not calibration:
        return set()
    taps = calibration.get("taps") or {}
    limit = float(ratio)
    out = set()
    for name in names:
        tap = _tap_for_param(name)
        sk = taps.get(tap) if tap else None
        if not sk:
            continue
        p99 = float(sk.get("p99") or 0.0)
        absmax = float(sk.get("absmax") or 0.0)
        if p99 > 0.0 and absmax / p99 > limit:
            out.add(name)
    return out


def calibrate(model, input_ids) -> dict:
    """One-batch calibration when no checkpoint carries a ``"numerics"``
    entry: one forward under the numerics collector, the tap abs-maxes
    shaped like the observatory's summary (one sample has no
    distribution, so p50 and p99 are the absmax)."""
    from paddle_tpu_torch.observability import numerics
    with torch.no_grad(), numerics.collect(True) as col:
        model(input_ids)
    taps = {}
    for name, st in col.taps.items():
        absmax = float(st[0])
        taps[name] = {"n": 1, "absmax": absmax, "p50": absmax,
                      "p99": absmax, "buckets": {}}
    return {"version": 1, "taps": taps}


def calibration_from_checkpoint(path: str,
                                step: Optional[int] = None
                                ) -> Optional[dict]:
    """The ``"numerics"`` entry a training run saved beside its weights,
    or None when the checkpoint has none (``FitResilience`` writes it
    while ``observability.numerics`` is armed, in either package). Read
    on the CPU: only the document is used."""
    if os.path.isdir(path):
        from paddle_tpu_torch.checkpoint import load_state_dir
        state = load_state_dir(path, step=step, device="cpu")
    else:
        from paddle_tpu_torch.framework.io import load
        state = load(path, device="cpu")
    if isinstance(state, dict):
        doc = state.get("numerics")
        if isinstance(doc, dict) and doc.get("taps"):
            return doc
    return None


# -- state-dict quantization --------------------------------------------------

def default_target(name: str, arr) -> bool:
    """The default quantization surface: 2-D projection weights.
    Embeddings (a gather), norms, biases and adapters stay."""
    if getattr(arr, "ndim", 0) != 2:
        return False
    return name.endswith(_DEFAULT_TARGET_SUFFIXES)


def quantize_state(state: Dict[str, object], mode: str, *,
                   calibration: Optional[dict] = None, targets=None,
                   axis: int = 1, quantize=None) -> Dict[str, object]:
    """A NEW dict whose selected leaves are :class:`QuantizedLeaf` (keys
    unchanged). ``targets`` overrides the default name/shape predicate;
    ``calibration`` applies the sensitivity gate; ``quantize(name,
    value)`` overrides how one selected leaf is quantized (the
    tensor-parallel serving engine quantizes the full weight of a block
    and keeps its part, :func:`shard_quantized`)."""
    if mode not in WEIGHT_MODES:
        raise ValueError(
            f"quantize mode {mode!r} (want one of "
            f"{sorted(WEIGHT_MODES)})")
    pred = targets or default_target
    if quantize is None:
        def quantize(k, v):
            return quantize_leaf(v, mode, axis=axis)
    picked = [k for k, v in state.items()
              if not isinstance(v, QuantizedLeaf) and pred(k, v)]
    skip = sensitive_params(picked, calibration)
    out = dict(state)
    for k in picked:
        if k in skip:
            continue
        out[k] = quantize(k, state[k])
    m = quantization_metrics()
    m["weight_leaves"].set(sum(
        1 for v in out.values() if isinstance(v, QuantizedLeaf)))
    m["skipped_leaves"].set(len(skip))
    m["weight_bytes"].set(quantized_bytes(out))
    return out


def quantized_bytes(state: Dict[str, object]) -> int:
    """Bytes of quantized weight storage (values + scales) in a state."""
    return sum(v.nbytes for v in state.values()
               if isinstance(v, QuantizedLeaf))


def shard_quantized(leaf: QuantizedLeaf, mesh, spec) -> QuantizedLeaf:
    """Tensor-parallel placement of a quantized leaf of a FULL weight
    (reference :282-295): this rank's block of the values under the
    weight's partition ``spec``, and of the 1-D scales under the spec's
    entry at the channel axis — split for a column-parallel weight, whole
    for a row-parallel one — so the dequantize needs no collective."""
    from paddle_tpu_torch.distributed.mesh import local_block
    parts = tuple(spec) if spec is not None else ()
    scale_part = parts[leaf.axis] if leaf.axis < len(parts) else None
    # copies: a block of dim 0 is a view that would keep the full storage
    q = local_block(leaf.q, parts, mesh).clone(
        memory_format=torch.contiguous_format)
    scale = local_block(leaf.scale, (scale_part,), mesh).clone()
    return QuantizedLeaf(q, scale, leaf.axis, leaf.orig_dtype)


# -- metrics ------------------------------------------------------------------

_quant_metrics_cache = None


def quantization_metrics(registry=None) -> dict:
    """The ``quantization_*`` metric families (the reference's names),
    created on first use."""
    global _quant_metrics_cache
    if registry is None and _quant_metrics_cache is not None:
        return _quant_metrics_cache
    from paddle_tpu_torch.observability import get_registry
    reg = registry if registry is not None else get_registry()
    d = {
        "weight_leaves": reg.gauge(
            "quantization_weight_leaves",
            "model state leaves stored as (values, scales) pairs"),
        "skipped_leaves": reg.gauge(
            "quantization_skipped_leaves",
            "target leaves left unquantized by the calibration "
            "sensitivity gate (activation absmax/p99 past the ratio)"),
        "weight_bytes": reg.gauge(
            "quantization_weight_bytes",
            "bytes of quantized weight storage, values + scales"),
        "kv_scale_bytes": reg.gauge(
            "quantization_kv_scale_bytes",
            "bytes of per-slot KV-cache dequantization scales"),
    }
    if registry is None:
        _quant_metrics_cache = d
    return d
