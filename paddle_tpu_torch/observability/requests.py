"""Per-request serving observability — port of
``paddle_tpu/observability/requests.py``: ledger, traceparent, exemplar
log, ``/statusz``.

- :class:`RequestLedger` — one :class:`RequestRecord` per request, born
  at admission (``ServingEngine.submit``) and threaded through the
  scheduler and engine: queue wait, per-chunk prefill tokens,
  cached-vs-cold prefix tokens, decode tokens and inter-token-latency
  samples, peak KV blocks, and the KV **block-seconds integral** (blocks
  held x seconds held). The engine samples occupancy at step boundaries
  and the scheduler closes the integral right before it frees a
  sequence's blocks (preempt/finish), so the per-request integrals sum
  to the allocator's ``block_seconds_total`` up to step granularity.
- W3C ``traceparent`` helpers (:func:`parse_traceparent`,
  :func:`format_traceparent`, :func:`new_trace_id`): the HTTP server
  parses an incoming header (or mints a trace id), echoes one on every
  response, and the id rides ``Request.trace_id`` into every
  ``trace.span``/``mark`` of the request.
- Tail-sampled exemplar log: completed records land in a bounded ring
  (and, with ``log_dir``, a per-process JSONL file). Errors, preempted
  requests and the slowest tail are always kept; the rest are sampled
  at ``sample_rate`` (default 0.05).

The ledger is host-side accounting only: greedy streams are bit-equal
with it armed or not. The reference arms it unless
``PADDLE_TPU_REQUEST_LEDGER=0`` and reads ``PADDLE_TPU_REQUEST_LOG_DIR``
and ``_REQUEST_LOG_SAMPLE``; the port reads no environment variable:
the engine's ``request_ledger=`` (on by default) and :func:`maybe_arm`'s
and :class:`RequestLedger`'s arguments carry them.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["RequestRecord", "RequestLedger", "request_metrics",
           "parse_traceparent", "format_traceparent", "new_trace_id",
           "new_span_id", "maybe_arm", "disable", "active",
           "statusz_payload", "render_statusz_html"]

#: the active ledger — engine/scheduler hooks read this attribute (or a
#: cached reference to it) on the hot path; None = disarmed
_active: Optional["RequestLedger"] = None

# ---------------------------------------------------------------------------
# W3C traceparent (https://www.w3.org/TR/trace-context/)
# ---------------------------------------------------------------------------

def new_trace_id() -> str:
    """32 lowercase hex chars (16 random bytes, never all-zero)."""
    t = os.urandom(16).hex()
    return t if t != "0" * 32 else new_trace_id()


def new_span_id() -> str:
    """16 lowercase hex chars (8 random bytes, never all-zero)."""
    s = os.urandom(8).hex()
    return s if s != "0" * 16 else new_span_id()


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """Extract the trace id from a ``traceparent`` header, or None when
    the header is absent/malformed (caller generates a fresh id). Only
    version-00 four-field headers with non-zero trace/parent ids parse;
    anything else is treated as absent per the spec's restart rule."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, trace_id, parent_id, flags = parts
    if len(ver) != 2 or len(trace_id) != 32 or len(parent_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(parent_id, 16), int(ver, 16), int(flags, 16)
    except ValueError:
        return None
    if ver == "ff" or trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id


def format_traceparent(trace_id: str, span_id: Optional[str] = None,
                       sampled: bool = True) -> str:
    """Render a version-00 traceparent carrying ``trace_id`` with a
    fresh (or supplied) parent span id."""
    return "00-%s-%s-%s" % (trace_id, span_id or new_span_id(),
                            "01" if sampled else "00")


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------

_request_metrics_cache = None


def request_metrics(registry=None) -> dict:
    """The exemplar-log metric families (mirrors ``serving_metrics``)."""
    global _request_metrics_cache
    if registry is None and _request_metrics_cache is not None:
        return _request_metrics_cache
    from .metrics import get_registry
    reg = registry if registry is not None else get_registry()
    d = {
        "kept": reg.counter(
            "serving_request_log_kept_total",
            "completed requests kept by the tail sampler, by reason "
            "(error/preempted/slow_tail always; sampled at the "
            "configured rate)"),
        "dropped": reg.counter(
            "serving_request_log_dropped_total",
            "completed requests the tail sampler did not keep"),
    }
    if registry is None:
        _request_metrics_cache = d
    return d


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

@dataclass
class RequestRecord:
    """One request's full lifecycle, host-side. Token-count fields
    mirror the scheduler's lifetime accumulators exactly (pinned against
    the bit-identical greedy stream by tests): ``prefilled_tokens`` +
    ``cached_tokens`` cover the prompt (and any preemption recompute),
    ``decode_tokens`` equals the generated continuation."""

    req_id: int
    trace_id: Optional[str]
    arrival_s: float                  # perf_counter clock
    prompt_len: int
    max_new_tokens: int
    #: LoRA tenant slot the request decoded against (0 = base model)
    adapter_id: int = 0
    state: str = "queued"             # queued|running|done|failed
    queue_wait_s: Optional[float] = None
    prefill_chunks: int = 0
    prefilled_tokens: int = 0         # cold tokens actually prefilled
    cached_tokens: int = 0            # prefix-cache tokens reused
    compiles: int = 0                 # step compiles this request rode
    preemptions: int = 0
    decode_tokens: int = 0
    itl_samples_s: List[float] = field(default_factory=list)
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    peak_kv_blocks: int = 0
    kv_block_seconds: float = 0.0
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    # occupancy-integral internals (left-continuous sampling)
    _occ_blocks: int = 0
    _occ_t: Optional[float] = None

    def itl_percentile(self, q: float) -> Optional[float]:
        if not self.itl_samples_s:
            return None
        s = sorted(self.itl_samples_s)
        return s[min(int(round(q * (len(s) - 1))), len(s) - 1)]

    def to_dict(self) -> dict:
        r6 = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {
            "req_id": self.req_id,
            "trace_id": self.trace_id,
            "state": self.state,
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "adapter_id": self.adapter_id,
            "queue_wait_s": r6(self.queue_wait_s),
            "prefill_chunks": self.prefill_chunks,
            "prefilled_tokens": self.prefilled_tokens,
            "cached_tokens": self.cached_tokens,
            "compiles": self.compiles,
            "preemptions": self.preemptions,
            "decode_tokens": self.decode_tokens,
            "ttft_s": r6(self.ttft_s),
            "latency_s": r6(self.latency_s),
            "itl_p50_s": r6(self.itl_percentile(0.50)),
            "itl_p99_s": r6(self.itl_percentile(0.99)),
            "peak_kv_blocks": self.peak_kv_blocks,
            "kv_block_seconds": r6(self.kv_block_seconds),
            "finish_reason": self.finish_reason,
            "error": self.error,
        }


class RequestLedger:
    """In-flight record map + completed-exemplar ring (thread-safe).

    The engine calls the ``note_*`` hooks under its step lock; HTTP
    threads read snapshots concurrently, so every mutation is under the
    ledger lock (host-side dict work — never on-device)."""

    #: trailing completed-latency window backing the slow-tail keep rule
    _TAIL_WINDOW = 256
    #: slow-tail rule needs this many completions before it can fire
    _TAIL_MIN = 20
    _TAIL_Q = 0.95

    def __init__(self, log_dir: Optional[str] = None,
                 sample_rate: float = 0.05, ring_size: int = 256):
        self.log_dir = log_dir
        self.sample_rate = min(max(float(sample_rate), 0.0), 1.0)
        self._lock = threading.Lock()
        self._inflight: Dict[int, RequestRecord] = {}
        self._ring: deque = deque(maxlen=ring_size)
        self._recent_latency: deque = deque(maxlen=self._TAIL_WINDOW)
        self.completed_total = 0
        self.block_seconds_total = 0.0
        self.kept = {"error": 0, "preempted": 0, "slow_tail": 0,
                     "sampled": 0}
        self.dropped = 0
        self._f = None
        self._m = request_metrics()

    # -- lifecycle hooks (engine/scheduler side) ---------------------------
    def admit(self, req) -> RequestRecord:
        """Born at admission: called by ``ServingEngine.submit`` with the
        scheduler :class:`Request` right after it is queued."""
        rec = RequestRecord(
            req_id=req.req_id, trace_id=req.trace_id,
            arrival_s=req.arrival_time, prompt_len=len(req.prompt_tokens),
            max_new_tokens=req.max_new_tokens,
            adapter_id=getattr(req, "adapter_id", 0))
        with self._lock:
            self._inflight[req.req_id] = rec
        return rec

    def note_prefill(self, seq, tokens: int, compiles: int):
        rec = self._inflight.get(seq.req_id)
        if rec is None:
            return
        with self._lock:
            rec.state = "running"
            rec.prefill_chunks += 1
            rec.prefilled_tokens += int(tokens)
            rec.compiles += int(compiles)

    def note_token(self, seq, itl_s: Optional[float]):
        rec = self._inflight.get(seq.req_id)
        if rec is None:
            return
        with self._lock:
            rec.state = "running"
            rec.decode_tokens += 1
            if itl_s is not None:
                rec.itl_samples_s.append(float(itl_s))

    def note_occupancy_many(self, seqs):
        """Step-boundary sweep over the slotted sequences (reads the
        clock once here — host-side, outside any traced function)."""
        now = time.monotonic()
        for seq in seqs:
            self.note_occupancy(seq, now)

    def note_occupancy(self, seq, now: float):
        """Advance the block-seconds integral: the PREVIOUS holding
        level is billed for the elapsed interval, then the level is
        re-sampled (left-continuous — a block counts from the step that
        observed it held until the next observation). The scheduler
        calls this right before freeing blocks (preempt/finish) so the
        final interval is never lost."""
        rec = self._inflight.get(seq.req_id)
        if rec is None:
            return
        blocks = len(seq.block_ids) + (1 if seq.cow_src is not None else 0)
        with self._lock:
            if rec._occ_t is not None and rec._occ_blocks > 0:
                d = rec._occ_blocks * max(now - rec._occ_t, 0.0)
                rec.kv_block_seconds += d
                self.block_seconds_total += d
            rec._occ_t = now
            rec._occ_blocks = blocks
            if blocks > rec.peak_kv_blocks:
                rec.peak_kv_blocks = blocks

    def complete(self, seq) -> Optional[RequestRecord]:
        """Finalize from the scheduler Request's recorded timestamps
        (called by the engine's ``_finish`` after ``scheduler.finish``
        freed the blocks), feed the SLO monitor, then tail-sample into
        the exemplar ring/JSONL."""
        with self._lock:
            rec = self._inflight.pop(seq.req_id, None)
            if rec is None:
                return None
            failed = getattr(seq.state, "value", str(seq.state)) == "failed"
            rec.state = "failed" if failed else "done"
            if seq.slot_time is not None:
                rec.queue_wait_s = seq.slot_time - seq.arrival_time
            # the scheduler's lifetime accumulators are authoritative
            # for token exactness (they survive preemption recompute)
            rec.prefilled_tokens = seq.prefilled_tokens
            rec.cached_tokens = seq.cached_tokens_total
            rec.decode_tokens = len(seq.generated)
            rec.preemptions = seq.preemptions
            rec.ttft_s = seq.ttft()
            rec.latency_s = seq.latency()
            rec.finish_reason = seq.finish_reason
            rec.error = seq.error
            self.completed_total += 1
            reason = self._keep_reason(rec)
            if rec.latency_s is not None:
                self._recent_latency.append(rec.latency_s)
            if reason is not None:
                self.kept[reason] += 1
                d = rec.to_dict()
                d["kept"] = reason
                self._ring.append(d)
                self._write_jsonl(d)
            else:
                self.dropped += 1
        if reason is not None:
            self._m["kept"].inc(reason=reason)
        else:
            self._m["dropped"].inc()
        from . import slo as _slo
        mon = _slo._monitor
        if mon is not None:
            mon.observe(rec)
        return rec

    def _keep_reason(self, rec: RequestRecord) -> Optional[str]:
        """Tail-sampling policy (lock held): errors, preempted and the
        slowest tail ALWAYS keep; the rest sample at ``sample_rate``."""
        if rec.state == "failed" or rec.error is not None:
            return "error"
        if rec.preemptions > 0:
            return "preempted"
        if rec.latency_s is not None \
                and len(self._recent_latency) >= self._TAIL_MIN:
            s = sorted(self._recent_latency)
            p = s[min(int(round(self._TAIL_Q * (len(s) - 1))),
                      len(s) - 1)]
            # strict: under uniform latency everything ties at p95 and
            # a >= rule would keep 100% of traffic as "slow"
            if rec.latency_s > p:
                return "slow_tail"
        if self.sample_rate > 0.0 and random.random() < self.sample_rate:
            return "sampled"
        return None

    def _write_jsonl(self, d: dict):
        """Append one kept record (lock held). Best-effort: the exemplar
        log must never fail a step."""
        if self.log_dir is None:
            return
        try:
            if self._f is None:
                os.makedirs(self.log_dir, exist_ok=True)
                self._f = open(os.path.join(
                    self.log_dir, f"requests_{os.getpid()}.jsonl"),
                    "a", buffering=1)
            self._f.write(json.dumps(d, separators=(",", ":")) + "\n")
        except OSError:
            self.log_dir = None  # disk went away: stop trying

    # -- introspection -----------------------------------------------------
    def in_flight_count(self) -> int:
        return len(self._inflight)

    def exemplars(self) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._ring]

    def snapshot(self, top_k: int = 10) -> dict:
        now = time.perf_counter()
        with self._lock:
            live = sorted(self._inflight.values(),
                          key=lambda r: r.kv_block_seconds, reverse=True)
            top = []
            for rec in live[:max(int(top_k), 0)]:
                d = rec.to_dict()
                d["age_s"] = round(now - rec.arrival_s, 3)
                top.append(d)
            return {
                "enabled": True,
                "in_flight": len(self._inflight),
                "completed": self.completed_total,
                "kv_block_seconds_total": round(
                    self.block_seconds_total, 6),
                "log": {"dir": self.log_dir,
                        "sample_rate": self.sample_rate,
                        "ring": len(self._ring),
                        "kept": dict(self.kept),
                        "dropped": self.dropped},
                "top_in_flight": top,
            }

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


# ---------------------------------------------------------------------------
# arming
# ---------------------------------------------------------------------------

def maybe_arm(enabled: bool = True, log_dir: Optional[str] = None,
              sample_rate: float = 0.05) -> Optional[RequestLedger]:
    """The engine's construction-time gate: the process ledger (created
    on first use, with ``log_dir`` and ``sample_rate``), or None when
    ``enabled`` is false — the caller then holds None and its hooks are
    one attribute read, while an armed ledger keeps serving other
    engines."""
    global _active
    if not enabled:
        return None
    if _active is None:
        _active = RequestLedger(log_dir=log_dir, sample_rate=sample_rate)
    return _active


def active() -> Optional[RequestLedger]:
    return _active


def disable():
    """Tear down the process ledger: closes the JSONL file and drops
    in-flight records."""
    global _active
    led, _active = _active, None
    if led is not None:
        led.close()


# ---------------------------------------------------------------------------
# /statusz
# ---------------------------------------------------------------------------

def statusz_payload(engine_stats: Optional[dict] = None,
                    top_k: int = 10) -> dict:
    """The /statusz document: live SLO burn rates, the ledger's top-K
    in-flight requests by KV block-seconds, and (serving ``Server``
    only) the engine's scheduler-occupancy stats. Served by both HTTP
    front-ends: ``serving.server.Server`` and the metrics exporter."""
    from . import slo as _slo
    led = _active
    out = {
        "slo": _slo.snapshot(),
        "requests": (led.snapshot(top_k=top_k) if led is not None
                     else {"enabled": False}),
    }
    if engine_stats is not None:
        out["engine"] = engine_stats
    return out


def render_statusz_html(payload: dict) -> str:
    """Minimal human-readable /statusz (no deps, no JS): burn-rate
    table, scheduler occupancy, top-K in-flight by block-seconds."""
    def esc(v):
        return (str(v).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    parts = ["<!doctype html><html><head><title>statusz</title>",
             "<style>body{font-family:monospace;margin:2em}"
             "table{border-collapse:collapse}"
             "td,th{border:1px solid #999;padding:2px 8px;"
             "text-align:right}th{background:#eee}</style>",
             "</head><body><h1>/statusz</h1>"]
    slo = payload.get("slo") or {}
    parts.append("<h2>SLO burn rates</h2>")
    if not slo.get("enabled"):
        parts.append("<p>no SLO targets configured "
                     "(observability.slo.configure)</p>")
    else:
        parts.append("<table><tr><th>slo</th><th>target</th>"
                     "<th>burn (fast)</th><th>burn (slow)</th>"
                     "<th>alerting</th></tr>")
        for name, s in sorted((slo.get("slos") or {}).items()):
            burn = s.get("burn_rate") or {}
            parts.append(
                "<tr><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
                "<td>%s</td></tr>" % (
                    esc(name), esc(s.get("target")),
                    esc(burn.get("fast")), esc(burn.get("slow")),
                    "YES" if s.get("alerting") else "no"))
        parts.append("</table><p>windows: %s</p>"
                     % esc(slo.get("windows_s")))
    eng = payload.get("engine")
    if eng:
        parts.append("<h2>scheduler occupancy</h2><table>")
        for k in ("running", "waiting", "kv_blocks_in_use",
                  "kv_blocks_free", "kv_blocks_reclaimable",
                  "kv_headroom", "preemptions", "requests_in_flight",
                  "kv_block_seconds_total"):
            if k in eng:
                parts.append("<tr><th>%s</th><td>%s</td></tr>"
                             % (esc(k), esc(eng[k])))
        parts.append("</table>")
    reqs = payload.get("requests") or {}
    parts.append("<h2>top in-flight by KV block-seconds</h2>")
    if not reqs.get("enabled"):
        parts.append("<p>request ledger disarmed "
                     "(ServingEngine(request_ledger=False))</p>")
    else:
        parts.append(
            "<p>in flight: %s &middot; completed: %s &middot; "
            "pool cost: %s block-seconds</p>" % (
                esc(reqs.get("in_flight")), esc(reqs.get("completed")),
                esc(reqs.get("kv_block_seconds_total"))))
        parts.append("<table><tr><th>req</th><th>trace</th>"
                     "<th>state</th><th>age_s</th><th>blk-s</th>"
                     "<th>peak blocks</th><th>prefilled</th>"
                     "<th>cached</th><th>decoded</th>"
                     "<th>preempt</th></tr>")
        for r in reqs.get("top_in_flight") or []:
            parts.append(
                "<tr><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
                "<td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
                "<td>%s</td><td>%s</td></tr>" % tuple(
                    esc(r.get(k)) for k in (
                        "req_id", "trace_id", "state", "age_s",
                        "kv_block_seconds", "peak_kv_blocks",
                        "prefilled_tokens", "cached_tokens",
                        "decode_tokens", "preemptions")))
        parts.append("</table>")
    parts.append("</body></html>")
    return "".join(parts)
