"""Step telemetry — port of ``paddle_tpu/observability/step_timer.py``:
per-step time decomposition, throughput and MFU.

:class:`StepTimer` brackets each training step and splits its wall time
into data / compute / collective: the data time comes from the caller
(the hapi fit loop times its loader fetch), the collective time is the
step's delta of the comm tracer's ``comm_seconds_total``, and compute is
the rest. With a flop count per sample (``flops_per_sample``) and the
card's peak (:func:`peak_flops`) it gives MFU; samples/s and, with
``tokens_per_sample`` or ``tokens=``, tokens/s come with it. Each step
lands in the registry (``train_step_seconds`` and the ``train_*``
gauges), the goodput ledger, the flight recorder, the device-memory
gauges, the ``/healthz`` liveness stamp and, when tracing, a step span
with its data and compute phases.

The timer reads the host clock: a step is timed only if its result was
read back before :meth:`StepTimer.end_step` (``Model.train_batch``
returns the loss as a Python float, which waits for the card; a
``TrainStep`` user must do the same, or time only the launches).

:func:`peak_flops` is the card's dense bf16/f16 tensor-core peak, from
NVIDIA's data sheets, by ``torch.cuda.get_device_name``: a CPU gives
0.0 (MFU is not meaningful there, as in the reference), and a CUDA card
the table does not list raises and asks for ``peak=`` (the reference's
"conservative default for an unknown TPU" has no counterpart to guess).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

from . import fleet, flight_recorder, goodput, memory, trace
from .comm import comm_totals
from .metrics import MetricsRegistry, get_registry

__all__ = ["StepTimer", "peak_flops", "PEAK_FLOPS"]

#: dense bf16/f16 tensor-core peak FLOP/s by card name (lower-case
#: substring, first match wins): H100 SXM5 989.4 TFLOP/s, H100 NVL 835.5,
#: H100 PCIe 756.5
PEAK_FLOPS = (
    ("h100 nvl", 835.5e12),
    ("h100 pcie", 756.5e12),
    ("h100 sxm", 989.4e12),
    ("h100 80gb hbm3", 989.4e12),
)


def peak_flops(device=None) -> float:
    """Peak FLOP/s of ``device`` (a ``torch.device``, a device string or
    ``None`` for the port's default device); 0.0 on the CPU. Raises
    ``ValueError`` for a CUDA card :data:`PEAK_FLOPS` does not list."""
    import torch
    from paddle_tpu_torch.device import resolve_device
    dev = device if isinstance(device, torch.device) \
        else resolve_device(device)
    if dev.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(dev)
    for key, val in PEAK_FLOPS:
        if key in name.lower():
            return val
    raise ValueError(
        f"no peak FLOP/s known for {name!r}; pass peak= (FLOP/s) to "
        f"StepTimer, StepTelemetry or attribute_train_step")


class StepTimer:
    """Usage (what the hapi ``StepTelemetry`` callback does)::

        timer = StepTimer(flops_per_sample=6 * n_params)
        for batch in loader:                 # fit times this fetch
            timer.begin_step(data_time=fetch_seconds)
            loss = float(train_step(batch))  # read back: the step is done
            stats = timer.end_step(samples=batch_size)
        # stats: step_time_s, data_time_s, compute_time_s,
        #        collective_time_s, exposed_collective_time_s,
        #        samples_per_sec, [tokens_per_sec, mfu, comm_bytes,
        #        compile_s, ckpt_s, goodput_fraction]

    ``peak`` (FLOP/s) skips :func:`peak_flops`'s lookup on ``device``
    (None: the port's default device, which is the card unless
    ``set_device("cpu")``). :attr:`recent` keeps the last step times."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 flops_per_sample: Optional[float] = None,
                 tokens_per_sample: Optional[float] = None,
                 peak: Optional[float] = None, device=None):
        self.registry = registry or get_registry()
        self.flops_per_sample = flops_per_sample
        self.tokens_per_sample = tokens_per_sample
        self.peak = peak_flops(device) if peak is None else float(peak)
        r = self.registry
        self._h_step = r.histogram("train_step_seconds",
                                   "wall time per training step")
        self._g_sps = r.gauge("train_samples_per_sec",
                              "training throughput, samples")
        self._g_tps = r.gauge("train_tokens_per_sec",
                              "training throughput, tokens")
        self._g_mfu = r.gauge("train_mfu_ratio",
                              "model FLOPs utilization estimate (0..1)")
        self._g_data = r.gauge("train_step_data_seconds",
                               "data-loading share of the last step")
        self._g_compute = r.gauge("train_step_compute_seconds",
                                  "compute share of the last step")
        self._g_coll = r.gauge("train_step_collective_seconds",
                               "collective-comm share of the last step")
        self._g_exposed = r.gauge(
            "train_step_exposed_collective_seconds",
            "non-overlapped (exposed) collective share of the last step")
        self._c_steps = r.counter("train_steps_total", "steps completed")
        self._c_samples = r.counter("train_samples_total",
                                    "samples consumed")
        self._g_gnorm = r.gauge(
            "train_grad_norm",
            "global gradient L2 norm (clip path, per step)")
        self._t0 = None
        self._data_time = 0.0
        self._comm0 = None
        self._step_index = 0
        self.last = None
        #: the last 1024 step times (seconds), oldest first
        self.recent = deque(maxlen=1024)
        # the process goodput ledger is born here (the top of the fit
        # loop): its wall must run before step 1 is classified
        goodput.get_ledger()

    def begin_step(self, data_time: float = 0.0):
        self._data_time = float(data_time)
        # the comm counters live in the default registry whatever this
        # timer records into
        self._comm0 = comm_totals()
        self._t0 = time.perf_counter()

    def end_step(self, samples: Optional[int] = None,
                 tokens: Optional[int] = None,
                 grad_norm: Optional[float] = None) -> dict:
        if self._t0 is None:
            return {}
        if grad_norm is not None:
            self._g_gnorm.set(float(grad_norm))
        t1 = time.perf_counter()
        busy = t1 - self._t0
        comm1 = comm_totals()
        coll = max(comm1["comm_seconds_total"] -
                   self._comm0["comm_seconds_total"], 0.0)
        exposed = max(comm1["comm_exposed_seconds_total"] -
                      self._comm0["comm_exposed_seconds_total"], 0.0)
        comm_bytes = comm1["comm_bytes_total"] - \
            self._comm0["comm_bytes_total"]
        total = busy + self._data_time
        compute = max(busy - coll, 0.0)
        stats = {"step_time_s": total, "data_time_s": self._data_time,
                 "compute_time_s": compute, "collective_time_s": coll,
                 "exposed_collective_time_s": exposed}
        if comm_bytes:
            stats["comm_bytes"] = comm_bytes
        self._h_step.observe(total)
        self.recent.append(total)
        self._g_data.set(self._data_time)
        self._g_compute.set(compute)
        self._g_coll.set(coll)
        self._g_exposed.set(exposed)
        self._c_steps.inc()
        if samples is not None and total > 0:
            sps = samples / total
            stats["samples_per_sec"] = sps
            self._g_sps.set(sps)
            self._c_samples.inc(samples)
            if tokens is None and self.tokens_per_sample:
                tokens = samples * self.tokens_per_sample
            if self.flops_per_sample and self.peak:
                mfu = samples * self.flops_per_sample / total / self.peak
                stats["mfu"] = mfu
                self._g_mfu.set(mfu)
        if tokens is not None and total > 0:
            tps = tokens / total
            stats["tokens_per_sec"] = tps
            self._g_tps.set(tps)
        # goodput: every second of this step lands in a ledger bin; the
        # compile/ckpt shares ride along in the stats and the step span
        g = goodput.on_step(stats)
        stats["compile_s"] = g["compile_s"]
        stats["ckpt_s"] = g["ckpt_s"]
        stats["goodput_fraction"] = g["goodput_fraction"]
        flight_recorder.record(
            flight_recorder.KIND_STEP, "train_step",
            int((t1 - total) * 1e9), int(t1 * 1e9),
            aux=int(samples or 0), args=stats)
        # refresh the device-memory gauges into this timer's registry
        memory.publish(self.registry)
        self._step_index += 1
        fleet.note_step()
        fleet.publish_step(self._step_index, stats)
        if trace.active() is not None:
            s_ns, e_ns = int((t1 - total) * 1e9), int(t1 * 1e9)
            targs = {"step": self._step_index, **{
                k: round(v, 6) for k, v in stats.items()
                if isinstance(v, float)}}
            trace.span("step", "train_step", s_ns, e_ns, args=targs)
            d_ns = int(self._data_time * 1e9)
            if d_ns > 0:
                trace.span("phase", "data", s_ns, s_ns + d_ns,
                           args={"step": self._step_index})
            trace.span("phase", "compute", s_ns + d_ns, e_ns,
                       args={"step": self._step_index,
                             "collective_s": round(coll, 6),
                             "exposed_collective_s": round(exposed, 6)})
        self.last = stats
        self._t0 = None
        return stats
