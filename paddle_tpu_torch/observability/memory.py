"""Device memory observability — port of
``paddle_tpu/observability/memory.py``: program accounting, the ledger,
the out-of-memory postmortem.

- :class:`MemoryReport` — byte accounting of one step. The reference
  reads XLA's ``compiled.memory_analysis()``; PyTorch has no compiled
  program to ask, so the port's fields keep the reference's names and
  are measured: ``argument_bytes`` are the registered owners' bytes
  (parameters and KV pools), ``output_bytes`` the step's result,
  ``alias_bytes`` what the step updates in place (the KV pools, counted
  on both sides), ``temp_bytes`` the step's ``max_memory_allocated``
  above what was allocated before it, and ``generated_code_bytes`` 0.
  ``ServingEngine.memory_report()`` builds one.
- :class:`MemoryLedger` — long-lived buffer owners (model parameters,
  KV pools) register named trees; ``snapshot()`` decomposes the card's
  bytes in use into named bytes and an unattributed residual, published
  as the ``hbm_bytes{owner=...}`` / ``hbm_bytes_in_use`` /
  ``hbm_peak_bytes`` / ``hbm_headroom`` gauges (polled per engine
  iteration by ``ServingEngine``). The allocator read goes through a
  swappable seam (:func:`set_memory_stats_fn`), so all of it is
  testable on the CPU, which reports nothing.
- **OOM postmortem** — a CUDA out-of-memory error is the port's
  "resource exhausted": :func:`handle_oom` dumps one postmortem JSON
  (the ledger's snapshot with the top owners, the failing step's memory
  report, the flight recorder's last events when it is on) before the
  error re-raises.

The reference reads ``PADDLE_TPU_HBM_HEADROOM_WARN`` and writes under
``PADDLE_TPU_TRACE_DIR``; the port reads no environment variable:
``MemoryLedger(headroom_warn=)`` (or :func:`set_headroom_warn`) and
:func:`handle_oom`'s ``out_dir`` (or :func:`set_postmortem_dir`; the
temporary directory by default) carry them.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import warnings
from typing import Callable, Dict, Optional

import torch

__all__ = ["MemoryReport", "MemoryLedger", "get_ledger", "memory_metrics",
           "tree_bytes", "register", "unregister", "snapshot", "publish",
           "set_memory_stats_fn", "set_headroom_warn", "set_postmortem_dir",
           "is_resource_exhausted", "handle_oom", "reset_peak"]


# ---------------------------------------------------------------------------
# step memory accounting
# ---------------------------------------------------------------------------

class MemoryReport:
    """Byte accounting of one step, under the reference's field names
    (module docstring says how each is measured)."""

    FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
              "alias_bytes", "generated_code_bytes")

    def __init__(self, argument_bytes: int = 0, output_bytes: int = 0,
                 temp_bytes: int = 0, alias_bytes: int = 0,
                 generated_code_bytes: int = 0, source: str = ""):
        self.argument_bytes = int(argument_bytes)
        self.output_bytes = int(output_bytes)
        self.temp_bytes = int(temp_bytes)
        self.alias_bytes = int(alias_bytes)
        self.generated_code_bytes = int(generated_code_bytes)
        self.source = source

    @property
    def total_bytes(self) -> int:
        """Peak bytes the step needs: arguments + outputs + temp + code,
        minus the bytes updated in place (counted on both sides)."""
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                + self.generated_code_bytes - self.alias_bytes)

    def to_json(self) -> dict:
        d = {f: getattr(self, f) for f in self.FIELDS}
        d["total_bytes"] = self.total_bytes
        if self.source:
            d["source"] = self.source
        return d

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)}" for f in self.FIELDS)
        return f"MemoryReport({inner}, total_bytes={self.total_bytes})"


def tree_bytes(tree) -> int:
    """Total buffer bytes over a nested dict/list/tuple of tensors (a
    tensor counts ``numel x element size``; anything else with an
    ``nbytes``, such as a numpy array or a quantized leaf, counts that),
    each leaf as often as the tree holds it, as the reference's."""
    total = 0
    stack = [tree]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, dict):
            stack.extend(leaf.values())
        elif isinstance(leaf, (list, tuple)):
            stack.extend(leaf)
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            n = getattr(leaf, "nbytes", None)
            if n is not None:
                total += int(n)
    return total


# ---------------------------------------------------------------------------
# device stats seam
# ---------------------------------------------------------------------------

def _default_memory_stats() -> dict:
    """The card's allocator statistics (``device.memory_stats``), or
    nothing where no card is in use: the read never initializes CUDA."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    from paddle_tpu_torch import device as _device
    return _device.memory_stats("cuda")


class MemoryLedger:
    """Named decomposition of device memory in use.

    Owners register a zero-arg callable returning the tree of buffers
    they hold, or a byte count (int), or a constant tree; ``None`` from
    the callable means the owner is gone and the entry drops itself.
    ``headroom_warn`` is the fraction below which one warning fires per
    run (the reference's ``PADDLE_TPU_HBM_HEADROOM_WARN``; None = off)."""

    def __init__(self, stats_fn: Optional[Callable[[], dict]] = None,
                 headroom_warn: Optional[float] = None):
        self._owners: Dict[str, Callable] = {}
        self._stats_fn = stats_fn or _default_memory_stats
        self._peak_seen = 0
        self._headroom_warned = False
        self.headroom_warn = headroom_warn

    # -- registration ------------------------------------------------------
    def register(self, owner: str, tree_or_fn) -> None:
        """Register (or replace) a named buffer owner; callables are
        re-evaluated at every snapshot."""
        fn = tree_or_fn if callable(tree_or_fn) else (lambda: tree_or_fn)
        self._owners[str(owner)] = fn

    def unregister(self, owner: str) -> None:
        self._owners.pop(str(owner), None)

    def owners(self):
        return sorted(self._owners)

    def set_memory_stats_fn(self, fn: Optional[Callable[[], dict]]):
        """Swap the allocator-stats source (the fake-backend seam);
        ``None`` restores the card's."""
        self._stats_fn = fn or _default_memory_stats

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """One decomposition: per-owner bytes, device totals, residual.
        The device totals are ``None`` where nothing reports (the CPU)."""
        named = {}
        for name, fn in list(self._owners.items()):
            try:
                tree = fn()
            except Exception:
                continue  # a broken owner must not kill telemetry
            if tree is None:  # owner died (weakref closure) — drop it
                self._owners.pop(name, None)
                continue
            if isinstance(tree, (int, float)):  # pre-priced byte count
                named[name] = int(tree)
            else:
                named[name] = tree_bytes(tree)
        try:
            stats = self._stats_fn() or {}
        except Exception:
            stats = {}
        in_use = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        peak = stats.get("peak_bytes_in_use")
        if in_use is not None:
            self._peak_seen = max(self._peak_seen, int(in_use))
        if peak is not None:
            self._peak_seen = max(self._peak_seen, int(peak))
        named_total = sum(named.values())
        snap = {
            "owners": dict(sorted(named.items(),
                                  key=lambda kv: -kv[1])),
            "named_bytes": named_total,
            "bytes_in_use": None if in_use is None else int(in_use),
            "peak_bytes_in_use": self._peak_seen or (
                None if peak is None else int(peak)),
            "bytes_limit": None if limit is None else int(limit),
            "unattributed_bytes": None if in_use is None
            else max(int(in_use) - named_total, 0),
            "headroom": None,
        }
        if in_use is not None and limit:
            snap["headroom"] = round(1.0 - int(in_use) / int(limit), 6)
            self._maybe_warn_headroom(snap)
        return snap

    def _maybe_warn_headroom(self, snap: dict):
        """Once-per-run near-OOM warning under ``headroom_warn``."""
        threshold = self.headroom_warn
        if self._headroom_warned or threshold is None:
            return
        if snap["headroom"] is None or snap["headroom"] >= threshold:
            return
        self._headroom_warned = True
        top = ", ".join(f"{k}={v}B"
                        for k, v in list(snap["owners"].items())[:4]) \
            or "no registered owners"
        warnings.warn(
            f"device memory headroom {snap['headroom']:.3f} below "
            f"headroom_warn={threshold} "
            f"(in_use={snap['bytes_in_use']}B of "
            f"limit={snap['bytes_limit']}B; top owners: {top})",
            RuntimeWarning, stacklevel=3)

    def reset_peak(self):
        """Start a fresh peak window: clears the host-observed peak and
        the allocator's own (where a card is in use)."""
        self._peak_seen = 0
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats()

    # -- gauges ------------------------------------------------------------
    def publish(self, registry=None) -> dict:
        """Snapshot + set the ``hbm_*`` gauges; returns the snapshot."""
        m = memory_metrics(registry)
        snap = self.snapshot()
        for name, nbytes in snap["owners"].items():
            m["bytes"].set(nbytes, owner=name)
        if snap["unattributed_bytes"] is not None:
            m["bytes"].set(snap["unattributed_bytes"],
                           owner="unattributed")
        if snap["bytes_in_use"] is not None:
            m["in_use"].set(snap["bytes_in_use"])
        if snap["peak_bytes_in_use"] is not None:
            m["peak"].set(snap["peak_bytes_in_use"])
        if snap["headroom"] is not None:
            m["headroom"].set(snap["headroom"])
        return snap


_memory_metrics_cache = None


def memory_metrics(registry=None) -> dict:
    """The ``hbm_*`` gauge families (created on first use)."""
    global _memory_metrics_cache
    if registry is None and _memory_metrics_cache is not None:
        return _memory_metrics_cache
    from .metrics import get_registry
    reg = registry if registry is not None else get_registry()
    d = {
        "bytes": reg.gauge(
            "hbm_bytes",
            "HBM bytes by registered owner (unattributed = residual)"),
        "in_use": reg.gauge(
            "hbm_bytes_in_use", "device allocator bytes currently held"),
        "peak": reg.gauge(
            "hbm_peak_bytes",
            "peak bytes held since process start / last reset_peak"),
        "headroom": reg.gauge(
            "hbm_headroom", "1 - bytes_in_use/bytes_limit (0..1)"),
    }
    if registry is None:
        _memory_metrics_cache = d
    return d


_default_ledger: Optional[MemoryLedger] = None


def get_ledger() -> MemoryLedger:
    """The process-wide default ledger."""
    global _default_ledger
    if _default_ledger is None:
        _default_ledger = MemoryLedger()
    return _default_ledger


def register(owner: str, tree_or_fn) -> None:
    get_ledger().register(owner, tree_or_fn)


def unregister(owner: str) -> None:
    get_ledger().unregister(owner)


def snapshot() -> dict:
    return get_ledger().snapshot()


def publish(registry=None) -> dict:
    """Default-ledger gauge refresh — the serving engine's per-step
    poll."""
    return get_ledger().publish(registry)


def reset_peak():
    get_ledger().reset_peak()


def set_memory_stats_fn(fn: Optional[Callable[[], dict]]):
    get_ledger().set_memory_stats_fn(fn)


def set_headroom_warn(fraction: Optional[float]):
    """The default ledger's near-OOM warning threshold (None = off)."""
    get_ledger().headroom_warn = fraction


# ---------------------------------------------------------------------------
# OOM postmortem
# ---------------------------------------------------------------------------

_postmortem = {"dir": None}


def set_postmortem_dir(path: Optional[str]):
    """Where :func:`handle_oom` writes (None = the temporary directory's
    ``paddle_tpu_torch_trace``)."""
    _postmortem["dir"] = path


def is_resource_exhausted(exc: BaseException) -> bool:
    """Did the card run out of memory? A ``torch.cuda.OutOfMemoryError``,
    or an error whose text says so (an allocation failure raised from a
    kernel's own launch, or the reference's ``RESOURCE_EXHAUSTED``)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in text or "Resource exhausted" in text
            or "Out of memory" in text or "out of memory" in text)


def handle_oom(exc: BaseException, source: str,
               report_fn: Optional[Callable] = None,
               out_dir: Optional[str] = None) -> Optional[str]:
    """If ``exc`` is an out-of-memory failure, dump ONE postmortem JSON
    and return its path (None otherwise); the caller re-raises. The path
    is pinned on the exception, so nested handlers never dump twice.
    ``report_fn`` — zero-arg, returning the failing step's
    :class:`MemoryReport` (or None); best-effort."""
    if not is_resource_exhausted(exc):
        return None
    existing = getattr(exc, "_pt_oom_postmortem", None)
    if existing is not None:
        return existing
    try:
        path = _dump_postmortem(exc, source, report_fn, out_dir)
    except Exception:
        return None  # postmortem failure must never mask the OOM
    try:
        exc._pt_oom_postmortem = path
    except Exception:
        pass  # exceptions with __slots__ just lose the dedup marker
    return path


#: how many of the flight recorder's last events a postmortem carries
POSTMORTEM_EVENT_TAIL = 64


def _flight_tail():
    """The flight recorder's last events ([] when it is off)."""
    from . import flight_recorder
    rec = flight_recorder.active()
    return [] if rec is None else rec.tail(POSTMORTEM_EVENT_TAIL)


def _dump_postmortem(exc, source, report_fn, out_dir) -> str:
    from . import fleet
    d = out_dir or _postmortem["dir"] or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_trace")
    os.makedirs(d, exist_ok=True)
    rank = fleet.rank()
    path = os.path.join(
        d, f"oom_postmortem_rank{rank}_{os.getpid()}_{source}.json")
    report = None
    if report_fn is not None:
        try:
            report = report_fn()
        except Exception:
            report = None
    doc = {
        "reason": "RESOURCE_EXHAUSTED",
        "source": source,
        "error": str(exc)[:4000],
        "unix_time": time.time(),
        "rank": rank,
        "pid": os.getpid(),
        "ledger": get_ledger().snapshot(),
        "memory_report": None if report is None else report.to_json(),
        # the flight recorder's last events, when it is on
        "flight_recorder_tail": _flight_tail(),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"[paddle_tpu_torch] OOM postmortem dumped to {path} ({source})",
          file=sys.stderr)
    return path
