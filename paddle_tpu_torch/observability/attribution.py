"""Phase-level train-step attribution — port of
``paddle_tpu/observability/attribution.py``: where do a step's
milliseconds go?

The full step's MFU sits below the layers' because the step pays for
more than the transformer stack: the vocab-projection loss head, the
optimizer update, exposed collective time and the data wait add wall
time and few or none of the flops the MFU convention counts. This module
measures that glue:

- **embedding_layers** — forward and backward of the backbone to its
  final hidden states (a proxy sum loss), split into ``forward_seconds``
  (the backbone's forward alone) and ``backward_seconds`` (the rest);
- **loss_head** — forward and backward with the real loss, less the
  backbone's (the vocab matmul and the cross-entropy);
- **optimizer** — the real ``jit.TrainStep`` (forward, backward, clip,
  update) less the gradient-only sub-step;
- **exposed_collective** — the delta of the comm tracer's
  ``comm_exposed_seconds_total`` over the timed full steps;
- **data** — given by the caller (``StepTimer``'s ``data_time_s``).

Each sub-step is run apart and timed with CUDA events on the card (with
``perf_counter`` and the result read back on the CPU), the best of
``reps`` windows of ``steps`` calls. Because the loss head and the
optimizer are differences of sub-steps timed alike, the phases sum to
the measured step by construction (:meth:`AttributionReport.check`).

**Flops.** The reference reads XLA's cost analysis of each program. The
port counts one forward of each sub-step with
``torch.utils.flop_counter.FlopCounterMode`` and takes three times it
(the forward plus a backward of twice its flops: ``bench.py``'s
convention). FlopCounterMode sees aten matmuls; the flash forward K1 is
the registered op ``paddle_tpu::flash_fwd``, for which this module
registers a formula: ``4 * B*Hq * Sq * Sk * head_dim`` (the unpadded
head_dim), halved when causal, so attention's flops are counted on the
card and on the CPU alike. (K2 and K3, launched inside the backward, are
covered by the factor of three.)

**State.** The real step updates the model. The reference runs on
functional copies; the port snapshots and restores instead: every
parameter and buffer, every optimizer state entry (the fused update's
flat buffers included: each entry's original tensor, a view of its
bucket's flat buffer, is put back and refilled in place, so a
``TrainStep`` planned before keeps its plan), the optimizer's step count
and state epoch, and the random state. After the call the model, the
optimizer and the flats are bit-identical to what they were.

Results land in the registry as ``attribution_phase_seconds`` /
``attribution_phase_mfu`` / ``attribution_step_seconds``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from .comm import comm_totals
from .metrics import get_registry
from .step_timer import peak_flops

__all__ = ["AttributionReport", "attribute_train_step",
           "attribution_metrics", "count_train_flops", "PHASES"]

#: canonical phase order (the table renders in this order)
PHASES = ("data", "embedding_layers", "loss_head", "optimizer",
          "exposed_collective")


def attribution_metrics(registry=None) -> dict:
    r = registry if registry is not None else get_registry()
    return {
        "phase_seconds": r.gauge(
            "attribution_phase_seconds",
            "per-step seconds attributed to each phase, by phase"),
        "phase_mfu": r.gauge(
            "attribution_phase_mfu",
            "MFU of each phase's own sub-step (0..1; only phases with "
            "counted FLOPs), by phase"),
        "step_seconds": r.gauge(
            "attribution_step_seconds",
            "measured full-step seconds the phase table decomposes"),
    }


class AttributionReport:
    """The phase table and the checks on it."""

    def __init__(self, phases: dict, step_time_s: float, peak: float,
                 total_flops: Optional[float], config: Optional[dict]):
        self.phases = phases          # name -> {seconds, flops, mfu}
        self.step_time_s = step_time_s
        self.peak = peak
        self.total_flops = total_flops
        self.config = config or {}
        self.mfu = (total_flops / step_time_s / peak
                    if total_flops and peak and step_time_s > 0 else None)

    @property
    def sum_seconds(self) -> float:
        return sum(p["seconds"] for p in self.phases.values())

    def check(self, tol: float = 0.05) -> bool:
        """Do the phases sum to the measured step time within ``tol``?"""
        if self.step_time_s <= 0:
            return False
        return abs(self.sum_seconds - self.step_time_s) \
            <= tol * self.step_time_s

    def glue_share(self) -> float:
        """Fraction of the step spent outside embedding+layers."""
        if self.step_time_s <= 0:
            return 0.0
        glue = self.step_time_s - \
            self.phases["embedding_layers"]["seconds"]
        return max(glue, 0.0) / self.step_time_s

    def to_json(self) -> dict:
        def phase_doc(p):
            doc = {
                "ms": round(p["seconds"] * 1e3, 3),
                "share_pct": round(p["seconds"] / self.step_time_s * 100,
                                   2) if self.step_time_s else None,
                "gflops": (round(p["flops"] / 1e9, 2)
                           if p.get("flops") else None),
                "mfu_pct": (round(p["mfu"] * 100, 2)
                            if p.get("mfu") is not None else None)}
            for k in ("forward_seconds", "backward_seconds"):
                if k in p:
                    doc[k.replace("_seconds", "_ms")] = round(p[k] * 1e3, 3)
            return doc
        return {
            "step_time_ms": round(self.step_time_s * 1e3, 3),
            "sum_of_phases_ms": round(self.sum_seconds * 1e3, 3),
            "residual_pct": round(
                (self.sum_seconds - self.step_time_s)
                / self.step_time_s * 100, 2) if self.step_time_s else None,
            "mfu_pct": (round(self.mfu * 100, 2)
                        if self.mfu is not None else None),
            "glue_share_pct": round(self.glue_share() * 100, 2),
            "phases": {name: phase_doc(p)
                       for name, p in self.phases.items()},
            "config": self.config,
        }

    def table(self) -> str:
        lines = [f"{'phase':<20}{'ms':>10}{'share%':>9}{'GFLOP':>12}"
                 f"{'MFU%':>8}"]
        for name in PHASES:
            p = self.phases.get(name)
            if p is None:
                continue
            ms = p["seconds"] * 1e3
            share = (p["seconds"] / self.step_time_s * 100
                     if self.step_time_s else 0.0)
            gf = f"{p['flops'] / 1e9:>12.2f}" if p.get("flops") \
                else f"{'-':>12}"
            mfu = f"{p['mfu'] * 100:>8.2f}" if p.get("mfu") is not None \
                else f"{'-':>8}"
            lines.append(f"{name:<20}{ms:>10.3f}{share:>9.2f}{gf}{mfu}")
            for k in ("forward_seconds", "backward_seconds"):
                if k in p:
                    lines.append(f"{'  ' + k.split('_')[0]:<20}"
                                 f"{p[k] * 1e3:>10.3f}")
        share = self.sum_seconds / self.step_time_s * 100 \
            if self.step_time_s else 0.0
        lines.append(f"{'sum(phases)':<20}{self.sum_seconds * 1e3:>10.3f}"
                     f"{share:>9.2f}")
        tail = f"{'step(measured)':<20}{self.step_time_s * 1e3:>10.3f}" \
               f"{100.0:>9.2f}"
        if self.mfu is not None:
            tail += f"{self.total_flops / 1e9:>12.2f}" \
                    f"{self.mfu * 100:>8.2f}"
        lines.append(tail)
        return "\n".join(lines)


# -- flops --------------------------------------------------------------------

_formulas = {"registered": False}


def _flash_fwd_flop(q_shape, k_shape, v_shape, *args, out_shape=None,
                    **kwargs) -> int:
    """K1's flops: QK^T and PV, 2 a multiply-add each, over the visible
    (query, key) pairs at the unpadded head_dim (causal: half)."""
    # the op's arguments after q, k, v: bias, q_seg, kv_seg, hq, hkv,
    # causal, sm_scale, bias_bb, bias_hb, dropout_p, seed, padded_from
    causal, padded_from = args[5], args[11]
    bh, sq, d = q_shape
    d = padded_from if padded_from > 0 else d
    flops = 4 * bh * sq * k_shape[1] * d
    return flops // 2 if causal else flops


def _register_flop_formulas():
    if _formulas["registered"]:
        return
    from torch.utils.flop_counter import register_flop_formula
    from paddle_tpu_torch.ops.pallas import flash_attention  # noqa: F401
    register_flop_formula(torch.ops.paddle_tpu.flash_fwd)(_flash_fwd_flop)
    _formulas["registered"] = True


def _forward_flops(fn: Callable) -> int:
    """FlopCounterMode's count of one forward of ``fn``, no graph kept."""
    from torch.utils.flop_counter import FlopCounterMode
    _register_flop_formulas()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn()
    return int(counter.get_total_flops())


def count_train_flops(fn: Callable) -> int:
    """Training flops of the forward ``fn``: three times its forward's
    (``bench.py``'s convention), attention included through K1's
    registered formula."""
    return 3 * _forward_flops(fn)


# -- timing -------------------------------------------------------------------

def _time_fn(fn: Callable, device: torch.device, steps: int, warmup: int,
             reps: int) -> float:
    """Mean seconds a call, the least over ``reps`` windows of ``steps``
    calls: CUDA events on the card, ``perf_counter`` on the CPU (the
    calls there are synchronous)."""
    for _ in range(warmup):
        fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    best = None
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / steps
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            dt = (time.perf_counter() - t0) / steps
        best = dt if best is None else min(best, dt)
    return best


# -- snapshot / restore -------------------------------------------------------

class _Snapshot:
    """Everything a real step changes: parameters, buffers, the
    optimizer's state entries (the tensors themselves, then their
    values), step count and state epoch, and the random state."""

    @torch.no_grad()
    def __init__(self, model, optimizer):
        from paddle_tpu_torch.core import generator
        self.params = [(p, p.detach().clone()) for p in model.parameters()]
        self.buffers = [(b, b.clone()) for b in model.buffers()]
        self.state = {}
        for key, d in optimizer._state.items():
            self.state[key] = (d, dict(d), {
                k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                for k, v in d.items()})
        self.opt = optimizer
        self.step_count = optimizer._step_count
        self.epoch = optimizer._state_epoch
        self.rng = generator.get_rng_state()

    @torch.no_grad()
    def restore(self):
        from paddle_tpu_torch.core import generator
        for p, v in self.params:
            p.copy_(v)
        for b, v in self.buffers:
            b.copy_(v)
        opt = self.opt
        for key in list(opt._state):
            if key not in self.state:
                del opt._state[key]
        for key, (d, entries, values) in self.state.items():
            d.clear()
            d.update(entries)
            for k, v in values.items():
                if isinstance(v, torch.Tensor):
                    entries[k].copy_(v)
            opt._state[key] = d
        opt._step_count = self.step_count
        opt._state_epoch = self.epoch
        generator.set_rng_state(self.rng)


def attribute_train_step(model, optimizer, batch, *,
                         loss_fn: Optional[Callable] = None,
                         hidden_fn: Optional[Callable] = None,
                         steps: int = 4, warmup: int = 1, reps: int = 3,
                         data_time_s: float = 0.0,
                         peak: Optional[float] = None,
                         registry=None,
                         config: Optional[dict] = None,
                         fused: Optional[bool] = None,
                         train_step=None) -> AttributionReport:
    """Measure the phase table for one (model, optimizer, batch).

    ``batch`` is what the step takes: ``[B, S]`` ids (a tensor or an
    array; the default ``loss_fn`` is ``model(x, labels=x)[1]``) or a
    dict of keyword tensors, a packed pipeline batch (the default is
    ``model(**batch)[1]``). ``hidden_fn(model, batch)`` runs the
    backbone to its final hidden states without the loss head (default:
    ``model.model`` / ``model.backbone`` on the ids, or on the dict less
    ``labels``). ``fused`` goes to the ``TrainStep`` built here;
    ``train_step`` runs an existing one instead (its fused plan is kept).
    ``peak`` defaults to :func:`~.step_timer.peak_flops` of the model's
    device. The model, optimizer and random state are restored after
    (see the module docstring)."""
    from paddle_tpu_torch.jit.train_step import TrainStep

    p0 = next(iter(model.parameters()))
    device = p0.device

    def to_dev(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return torch.as_tensor(v).to(device)

    kw = isinstance(batch, dict)
    x = {k: to_dev(v) for k, v in batch.items()} if kw else to_dev(batch)

    if loss_fn is None:
        def loss_fn(m, b):  # noqa: F811 — the documented default
            out = m(**b) if kw else m(b, labels=b)
            return out[1] if isinstance(out, (tuple, list)) else out
    if hidden_fn is None:
        backbone = getattr(model, "model", None) or \
            getattr(model, "backbone", None)
        if backbone is None:
            raise ValueError(
                "model has no .model/.backbone backbone attribute — pass "
                "hidden_fn=(model, batch) -> final hidden states")

        def hidden_fn(m, b):  # noqa: F811 — the documented default
            if kw:
                return backbone(**{k: v for k, v in b.items()
                                   if k != "labels"})
            return backbone(b)

    train = [p for p in optimizer._parameter_list if p.requires_grad]

    def hidden_fwd():
        h = hidden_fn(model, x)
        return h.float().sum()

    def hidden_grad():
        return torch.autograd.grad(hidden_fwd(), train, allow_unused=True)

    def loss_grad():
        return torch.autograd.grad(loss_fn(model, x), train,
                                   allow_unused=True)

    if train_step is None:
        # the step takes a dict batch as keyword arguments
        step_loss = (lambda m, **b: loss_fn(m, b)) if kw else loss_fn
        train_step = TrainStep(model, step_loss, optimizer, fused=fused)

    def full():
        return train_step(**x) if kw else train_step(x)

    snap = _Snapshot(model, optimizer)
    try:
        flops_hidden = count_train_flops(hidden_fwd)
        flops_full = count_train_flops(lambda: loss_fn(model, x))
        t_hidden_fwd = _time_fn(hidden_fwd, device, steps, warmup, reps)
        t_hidden = _time_fn(hidden_grad, device, steps, warmup, reps)
        t_grad = _time_fn(loss_grad, device, steps, warmup, reps)
        # the full step last, bracketed by the exposure counters so the
        # exposed-collective share covers exactly this window
        exp0 = comm_totals()["comm_exposed_seconds_total"]
        t_full = _time_fn(full, device, steps, warmup, reps)
        exposed_per_step = max(
            comm_totals()["comm_exposed_seconds_total"] - exp0, 0.0) / \
            max(reps * steps + warmup, 1)
    finally:
        snap.restore()

    t_loss_head = max(t_grad - t_hidden, 0.0)
    t_optimizer = max(t_full - t_grad, 0.0)
    # exposed collective time is inside the full step's wall: it carves
    # out of the backbone remainder, so the phases sum to the step
    t_layers = max(t_full - t_loss_head - t_optimizer - exposed_per_step,
                   0.0)
    if peak is None:
        peak = peak_flops(device)
    flops_loss_head = flops_full - flops_hidden

    def mfu_of(flops, seconds):
        if not flops or not peak or seconds <= 0:
            return None
        return flops / seconds / peak

    phases = {
        "data": {"seconds": float(data_time_s), "flops": None,
                 "mfu": None},
        "embedding_layers": {
            "seconds": t_layers, "flops": flops_hidden,
            "mfu": mfu_of(flops_hidden, t_hidden),
            "forward_seconds": t_hidden_fwd,
            "backward_seconds": max(t_hidden - t_hidden_fwd, 0.0)},
        "loss_head": {"seconds": t_loss_head, "flops": flops_loss_head,
                      "mfu": mfu_of(flops_loss_head, t_loss_head)},
        "optimizer": {"seconds": t_optimizer, "flops": None, "mfu": None},
        "exposed_collective": {"seconds": exposed_per_step, "flops": None,
                               "mfu": None},
    }
    step_time = t_full + float(data_time_s)
    report = AttributionReport(phases, step_time, peak, flops_full, config)

    m = attribution_metrics(registry)
    for name, p in phases.items():
        m["phase_seconds"].set(p["seconds"], phase=name)
        if p.get("mfu") is not None:
            m["phase_mfu"].set(p["mfu"], phase=name)
    m["step_seconds"].set(step_time)

    from . import trace
    if trace.active() is not None:
        trace.mark("phase", "attribution_report",
                   ts_ns=time.perf_counter_ns(), args=report.to_json())
    return report
