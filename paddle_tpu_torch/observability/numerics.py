"""Numerics observatory — port of ``paddle_tpu/observability/numerics.py``:
the tap seam, the calibration sketches and the observatory that holds
them.

* **The tap seam.** ``numerics.tap(name, x)`` sits at the model's seams
  (``models/llama.py``: ``embed``, per layer ``attn``, ``mlp_act``,
  ``mlp`` and ``resid``, ``final_norm``, ``logits``) and always returns
  ``x`` unchanged. When nothing collects it costs one module-attribute
  read. Inside :func:`collect` each tap records four f32 scalars of its
  value (abs-max, mean, rms, non-finite count), computed on the value's
  device without a host read, in call order; :func:`scope` prefixes the
  names (``layers.3.attn``) and :func:`suppress` silences taps inside a
  recompute region, whose caller taps the region's output instead.
* **Calibration.** :class:`NumericsObservatory` folds each sample's tap
  abs-maxes into per-tap log2-bucketed sketches (:class:`_Sketch`);
  :meth:`~NumericsObservatory.calibration_summary` is the ``{"version":
  1, "taps": {...}}`` document that weight-only quantization reads
  (``quantization/weight_only.py``), and ``load_summary`` merges one back.

What is not ported yet (ROADMAP §1 item 7): ``TrainStep``'s sampled
twin step, the NaN-provenance replay (``write_provenance``), the export
of the sketches by ``FitResilience`` and the serving engine's decode
drift gauges; so the reference's ``PADDLE_TPU_NUMERICS*`` switches, which
arm those, are not read either.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from .metrics import MetricsRegistry, get_registry

__all__ = ["tap", "scope", "suppress", "collect", "numerics_metrics",
           "NumericsObservatory", "get_observatory"]

# -- the tap seam ------------------------------------------------------------

#: the collector: None when nothing collects (the one attribute read on
#: the disarmed path), a list of (name, stats) inside :func:`collect`
_active: Optional[list] = None
#: name-scope stack (``layers.3`` ...) and the recompute suppression depth
_stack: List[str] = []
_suppress: int = 0


@torch.no_grad()
def _stats(x):
    """(absmax, mean, rms, nonfinite_count) of a tensor, in f32, as four
    0-d tensors on its device (no host read)."""
    f = x.detach().float()
    return (f.abs().max(), f.mean(), f.square().mean().sqrt(),
            (~torch.isfinite(f)).sum().to(torch.int32))


def tap(name: str, x):
    """Record tensor-health scalars of ``x`` while :func:`collect` is
    active; ALWAYS returns ``x`` unchanged."""
    col = _active
    if col is None or _suppress:
        return x
    full = ".".join(_stack + [name]) if _stack else name
    col.append((full, _stats(x)))
    return x


@contextmanager
def scope(name):
    """Prefix taps in the body with ``<name>.``. No-op when nothing
    collects."""
    if _active is None:
        yield
        return
    _stack.append(str(name))
    try:
        yield
    finally:
        _stack.pop()


@contextmanager
def suppress():
    """Silence taps in the body (a recompute region: its caller taps the
    region's output instead)."""
    global _suppress
    _suppress += 1
    try:
        yield
    finally:
        _suppress -= 1


class _Collection:
    """Handle returned by :func:`collect`; ``taps`` is a name -> stats
    dict (names deduplicated in call order: a second ``embed`` becomes
    ``embed#2``) after the block exits."""

    def __init__(self):
        self.taps: Dict[str, tuple] = {}


@contextmanager
def collect(enabled: bool = True):
    """Collect the taps of the body. ``enabled=False`` yields an empty
    collection without touching the seam."""
    col = _Collection()
    if not enabled:
        yield col
        return
    global _active
    prev, _active = _active, []
    try:
        yield col
    finally:
        raw, _active = _active, prev
        for name, st in raw:
            key, k = name, 1
            while key in col.taps:
                k += 1
                key = f"{name}#{k}"
            col.taps[key] = st


# -- metric families ---------------------------------------------------------

def numerics_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The ``numerics_*`` families (the reference's names): per-tap
    activation gauges, per-bucket gradient/update gauges, the sample
    counter, and the serving decode-path twins."""
    r = registry or get_registry()
    return {
        "samples": r.counter("numerics_samples_total",
                             "instrumented numerics samples taken"),
        "absmax": r.gauge("numerics_tap_absmax",
                          "per-tap activation abs-max (last sample)"),
        "rms": r.gauge("numerics_tap_rms",
                       "per-tap activation rms (last sample)"),
        "nonfinite": r.gauge("numerics_tap_nonfinite",
                             "per-tap non-finite element count"),
        "grad_norm": r.gauge("numerics_grad_norm",
                             "per-parameter-bucket gradient L2 norm"),
        "grad_nonfinite": r.gauge("numerics_grad_nonfinite",
                                  "per-bucket non-finite gradient count"),
        "update_ratio": r.gauge(
            "numerics_update_ratio",
            "per-bucket optimizer update-norm / param-norm ratio"),
        "decode_absmax": r.gauge(
            "numerics_decode_absmax",
            "per-tap decode-path activation abs-max (serving)"),
        "decode_drift": r.gauge(
            "numerics_decode_drift_ratio",
            "decode abs-max / training calibration abs-max"),
    }


# -- calibration sketch ------------------------------------------------------

class _Sketch:
    """Bounded-memory per-tap range sketch: running abs-max plus a
    log2-bucketed histogram of sampled abs-max values — mergeable, and
    good for the coarse percentiles (p50/p99) a calibration needs."""

    __slots__ = ("n", "absmax", "buckets")

    def __init__(self):
        self.n = 0
        self.absmax = 0.0
        self.buckets: Dict[int, int] = {}

    @staticmethod
    def _bucket(v: float) -> int:
        if not math.isfinite(v):
            return 1 << 20          # the "non-finite" bucket, sorts last
        if v <= 0.0:
            return -(1 << 20)       # zeros sort first
        return int(math.floor(math.log2(v)))

    def add(self, v: float):
        self.n += 1
        if math.isfinite(v) and v > self.absmax:
            self.absmax = v
        b = self._bucket(v)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def percentile(self, q: float) -> float:
        """Upper edge (2^(b+1)) of the bucket holding quantile ``q``."""
        if not self.n:
            return 0.0
        target = q * self.n
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= target:
                if b <= -(1 << 20):
                    return 0.0
                if b >= 1 << 20:
                    return float("inf")
                return float(2.0 ** (b + 1))
        return self.absmax

    def summary(self) -> dict:
        return {"n": self.n, "absmax": self.absmax,
                "p50": self.percentile(0.50), "p99": self.percentile(0.99),
                "buckets": {str(k): v for k, v in sorted(
                    self.buckets.items())}}

    def merge(self, doc: dict):
        self.n += int(doc.get("n", 0))
        self.absmax = max(self.absmax, float(doc.get("absmax", 0.0)))
        for k, v in (doc.get("buckets") or {}).items():
            k = int(k)
            self.buckets[k] = self.buckets.get(k, 0) + int(v)


# -- the observatory ---------------------------------------------------------

class NumericsObservatory:
    """Host-side accumulator behind the seam: keeps the last sample,
    folds each sample's tap abs-maxes into per-tap calibration sketches,
    and publishes the ``numerics_*`` gauges."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or get_registry()
        self._m = numerics_metrics(self.registry)
        self.last: Optional[dict] = None
        self.last_step: Optional[int] = None
        self.sketches: Dict[str, _Sketch] = {}

    def record_sample(self, step: int, sample: dict):
        """Fold one host-side sample in: ``{"taps": {name: (absmax, mean,
        rms, nonfinite)}, "grads": {bucket: (norm, nonfinite)},
        "updates": {bucket: (update_norm, param_norm)}}``."""
        self.last = sample
        self.last_step = int(step)
        m = self._m
        m["samples"].inc()
        for name, (absmax, _mean, rms, nonf) in sample["taps"].items():
            m["absmax"].set(absmax, tap=name)
            m["rms"].set(rms, tap=name)
            m["nonfinite"].set(nonf, tap=name)
            self.sketches.setdefault(name, _Sketch()).add(float(absmax))
        for name, (norm, nonf) in sample.get("grads", {}).items():
            m["grad_norm"].set(norm, bucket=name)
            m["grad_nonfinite"].set(nonf, bucket=name)
        for name, (unorm, pnorm) in sample.get("updates", {}).items():
            m["update_ratio"].set(unorm / pnorm if pnorm else 0.0,
                                  bucket=name)

    def calibration_summary(self) -> dict:
        """Per-tap range summaries accumulated over every sample so far
        (the ``"numerics"`` calibration document)."""
        return {"version": 1, "taps": {name: sk.summary() for name, sk
                                       in sorted(self.sketches.items())}}

    def load_summary(self, doc: dict):
        """Merge a previously exported summary into the sketches."""
        for name, s in (doc.get("taps") or {}).items():
            self.sketches.setdefault(name, _Sketch()).merge(s)


_observatory: Optional[NumericsObservatory] = None


def get_observatory() -> NumericsObservatory:
    global _observatory
    if _observatory is None:
        _observatory = NumericsObservatory()
    return _observatory
