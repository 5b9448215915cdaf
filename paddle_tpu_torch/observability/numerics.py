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

* **Sampling.** While :func:`armed`, ``TrainStep`` runs an instrumented
  twin of the step on the steps :func:`sample_this_step` picks (step 1
  and every :func:`every`-th): the forward under :func:`collect`, plus
  per-bucket gradient norms and non-finite counts and update/parameter
  norms. :func:`host_sample` brings the whole tree to the host in one
  copy; the observatory publishes the ``numerics_*`` gauges, a trace
  span and the calibration sketches. Unsampled steps run the very code
  of a never-instrumented step.
* **NaN provenance.** On a ``NaNGuard`` trip, :func:`write_provenance`
  replays the stashed last batch through ``TrainStep.numerics_probe_last``
  (forward and gradients only, the tripped step's random state, nothing
  updated) against the state just restored, and names the first
  non-finite tap or gradient bucket in execution order in
  ``nan_provenance_rank<r>_<pid>.json``.

The reference reads ``PADDLE_TPU_NUMERICS``, ``_NUMERICS_EVERY``,
``_NUMERICS_PROVENANCE``, ``PADDLE_TPU_TRACE_DIR`` and
``PADDLE_TRAINER_ID``; the port reads none: :func:`configure` sets the
first three (default off, 32, and following ``armed``), provenance files
go to ``observability.profile``'s trace directory (or ``out_dir``), and
the rank is ``fleet.rank()``. Not ported yet: the serving engine's
decode drift gauges (``record_decode``).
"""
from __future__ import annotations

import json
import math
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from .metrics import MetricsRegistry, get_registry

__all__ = ["tap", "scope", "suppress", "collect", "armed", "every",
           "configure", "sample_this_step", "provenance_enabled",
           "numerics_metrics", "NumericsObservatory", "get_observatory",
           "last_sample", "write_provenance", "reduce_stats",
           "host_sample"]

# -- switches ----------------------------------------------------------------

_config = {"armed": False, "every": 32, "provenance": None}


def configure(armed: Optional[bool] = None, every: Optional[int] = None,
              provenance: Optional[bool] = None):
    """Set the switches the reference reads from ``PADDLE_TPU_NUMERICS``
    (``armed``), ``_NUMERICS_EVERY`` (``every``: a positive period, else
    the default 32) and ``_NUMERICS_PROVENANCE`` (``provenance``: True
    or False forces the replay on or off, None follows ``armed``). An
    argument left None keeps its setting, except ``provenance``, which
    None resets to following ``armed``."""
    if armed is not None:
        _config["armed"] = bool(armed)
    if every is not None:
        n = int(every)
        _config["every"] = n if n > 0 else 32
    _config["provenance"] = None if provenance is None else bool(provenance)


def armed() -> bool:
    """Master switch: off, every seam is a no-op and no twin runs."""
    return _config["armed"]


def every() -> int:
    """Sampling period in steps (default 32)."""
    return _config["every"]


def sample_this_step(step: int) -> bool:
    """Should ``step`` (1-based) run the instrumented twin? Step 1 and
    every :func:`every`-th, while :func:`armed`."""
    if not armed():
        return False
    return step == 1 or step % every() == 0


def provenance_enabled() -> bool:
    """Is the NaN-provenance replay armed (the batch stashed every
    step)? Follows :func:`armed` unless ``configure(provenance=)``."""
    p = _config["provenance"]
    return armed() if p is None else p

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


def reduce_stats(st, axis=None):
    """One tap's stats reduced across a data-parallel group: the
    reference reduces over a ``shard_map`` axis; one process has nothing
    to reduce, so this returns ``st``."""
    return st


def host_sample(nums: dict, loss_val=None, tap_order=None) -> dict:
    """One instrumented step's device-side numerics tree (``{"taps",
    "grads", "updates", "grad_norm"}``, 0-d tensors) as host floats and
    ints, in one device-to-host copy. ``tap_order`` reorders the taps."""
    taps = nums.get("taps", {})
    if tap_order:
        taps = {n: taps[n] for n in tap_order if n in taps}
    grads, updates = nums.get("grads", {}), nums.get("updates", {})
    gn = nums.get("grad_norm")
    flat = [v for st in taps.values() for v in st] + \
        [v for st in grads.values() for v in st] + \
        [v for st in updates.values() for v in st]
    tail = [t for t in (gn, loss_val) if t is not None]
    vals = []
    if flat or tail:
        vals = torch.stack([torch.as_tensor(v).detach().reshape(())
                            .to(torch.float64) for v in flat + tail]) \
            .cpu().tolist()
    it = iter(vals)
    sample = {
        "taps": {n: (next(it), next(it), next(it), int(next(it)))
                 for n in taps},
        "grads": {n: (next(it), int(next(it))) for n in grads},
        "updates": {n: (next(it), next(it)) for n in updates},
    }
    sample["grad_norm"] = next(it) if gn is not None else None
    if loss_val is not None:
        sample["loss"] = next(it)
    return sample


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
        "updates": {bucket: (update_norm, param_norm)}, "grad_norm",
        "loss"}``."""
        t0 = time.perf_counter_ns()
        self.last = sample
        self.last_step = int(step)
        m = self._m
        m["samples"].inc()
        nonfinite_total = 0
        worst_absmax = 0.0
        for name, (absmax, _mean, rms, nonf) in sample["taps"].items():
            m["absmax"].set(absmax, tap=name)
            m["rms"].set(rms, tap=name)
            m["nonfinite"].set(nonf, tap=name)
            nonfinite_total += int(nonf)
            if math.isfinite(absmax):
                worst_absmax = max(worst_absmax, absmax)
            self.sketches.setdefault(name, _Sketch()).add(float(absmax))
        for name, (norm, nonf) in sample.get("grads", {}).items():
            m["grad_norm"].set(norm, bucket=name)
            m["grad_nonfinite"].set(nonf, bucket=name)
        for name, (unorm, pnorm) in sample.get("updates", {}).items():
            m["update_ratio"].set(unorm / pnorm if pnorm else 0.0,
                                  bucket=name)
        from . import trace
        if trace.active() is not None:
            trace.span("numerics", "sample", t0, time.perf_counter_ns(),
                       args={"step": int(step), "taps": len(sample["taps"]),
                             "nonfinite_total": nonfinite_total,
                             "worst_absmax": worst_absmax,
                             "grad_norm": sample.get("grad_norm")})

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


def last_sample() -> Optional[dict]:
    """The most recent sample with its step, or None (the flight
    recorder's postmortem appendix)."""
    obs = _observatory
    if obs is None or obs.last is None:
        return None
    return {"step": obs.last_step, **obs.last}


# -- NaN provenance ----------------------------------------------------------

def _first_nonfinite(sample: dict) -> Optional[dict]:
    """First non-finite site in execution order: the forward taps (their
    recorded order), then the loss, then the gradient buckets."""
    for name, (absmax, mean, _rms, nonf) in sample["taps"].items():
        if int(nonf) > 0 or not math.isfinite(float(absmax)) \
                or not math.isfinite(float(mean)):
            return {"kind": "tap", "name": name,
                    "nonfinite_count": int(nonf)}
    loss = sample.get("loss")
    if loss is not None and not math.isfinite(float(loss)):
        return {"kind": "loss", "name": "loss", "nonfinite_count": 1}
    for name, (norm, nonf) in sample.get("grads", {}).items():
        if int(nonf) > 0 or not math.isfinite(float(norm)):
            return {"kind": "grad_bucket", "name": name,
                    "nonfinite_count": int(nonf)}
    return None


def write_provenance(train_step, step: int, trip_kind: str,
                     out_dir: Optional[str] = None) -> Optional[str]:
    """The NaN guard's consumer: replay the stashed last batch through
    ``train_step.numerics_probe_last()`` (forward and gradients only,
    nothing updated) and write ``nan_provenance_rank<r>_<pid>.json``
    naming the first non-finite tap or bucket. Returns the path, or None
    without a stash. The caller restores the last commit first, so the
    replay runs on the state training resumes from; a replay that comes
    back finite is recorded as ``verdict: "finite_in_graph"`` (a
    host-side corruption, such as the chaos harness's loss seam)."""
    probe = getattr(train_step, "numerics_probe_last", None)
    if probe is None:
        return None
    sample = probe()
    if sample is None:
        return None
    from . import fleet, flight_recorder, profile
    first = _first_nonfinite(sample)
    rank = fleet.rank()
    doc = {
        "schema": "nan_provenance_v1",
        "step": int(step),
        "trip_kind": trip_kind,
        "rank": rank,
        "pid": os.getpid(),
        "unix_time": time.time(),
        "verdict": "nonfinite_in_graph" if first is not None
                   else "finite_in_graph",
        "first_nonfinite": first,
        "replay": {
            "loss": sample.get("loss"),
            "grad_norm": sample.get("grad_norm"),
            "taps": {n: {"absmax": float(s[0]), "mean": float(s[1]),
                         "rms": float(s[2]), "nonfinite": int(s[3])}
                     for n, s in sample["taps"].items()},
            "grad_buckets": {n: {"norm": float(s[0]),
                                 "nonfinite": int(s[1])}
                             for n, s in sample.get("grads", {}).items()},
        },
    }
    d = out_dir or profile.trace_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"nan_provenance_rank{rank}_{os.getpid()}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    now = time.time_ns()
    flight_recorder.record(
        flight_recorder.KIND_USER, "nan_provenance", now, now,
        aux=int(step), args={"step": int(step), "trip_kind": trip_kind,
                             "verdict": doc["verdict"],
                             "first_nonfinite": first, "path": path})
    return path
