"""Structured span tracing — port of ``paddle_tpu/observability/trace.py``:
per-rank trace files and the cross-rank merge.

Every process writes a line-oriented JSON trace file
(``trace_rank<r>_<pid>.jsonl``) whose first line is a header carrying
the rank and a **clock anchor** — a ``(perf_counter_ns, unix_ns)`` pair
sampled back to back — and whose other lines are spans and marks
timestamped on the local ``perf_counter_ns`` clock. Sources: the serving
engine (per-request span chains), the fleet router (``router_route``,
``router_handoff``), the HTTP server (``stream``), and anything else via
:func:`span` / :func:`mark`.

The merge aligns every file onto one clock with the anchors
(``aligned_ns = ts - anchor.perf_ns + anchor.unix_ns``) and writes one
chrome trace (a lane per file) plus a JSON summary with per-rank skew
and straggler stats, and on request the goodput rollup (a pure fold over
step spans) and the per-request rollup keyed by W3C trace id::

    python -m paddle_tpu_torch.observability.trace merge <dir> \
        [--out merged_trace.json] [--summary merge_summary.json] \
        [--goodput] [--requests]

The reference arms the writer from ``PADDLE_TPU_TRACE_SPANS`` and reads
the rank from ``PADDLE_TRAINER_ID``; the port reads no environment
variable: :func:`enable` takes the directory, and the rank defaults to
``observability.fleet``'s (0 unless configured). Disarmed, every
:func:`span` call is one module-attribute read.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["TraceWriter", "enable", "disable", "active", "span", "mark",
           "merge", "FORMAT_VERSION", "GOODPUT_BINS"]

FORMAT_VERSION = 1

#: the goodput ledger's bins (``paddle_tpu/observability/goodput.py``'s
#: ``BINS``), which the ``--goodput`` rollup folds step spans into
GOODPUT_BINS = ("productive", "compile", "checkpoint", "data_stall",
                "exposed_collective", "restart", "reshard",
                "rollback_discarded", "other_overhead")

#: the active writer — instrumentation reads this attribute on every
#: span, so it must stay a plain module global (no function call)
_active: Optional["TraceWriter"] = None


def _rank() -> int:
    from . import fleet
    return fleet.rank()

class TraceWriter:
    """Append-only per-rank trace file (thread-safe, line-buffered).

    Every line is one JSON object. The header pins the clock anchor the
    merge tool needs; events carry raw ``perf_counter_ns`` timestamps so
    recording never pays a clock conversion.
    """

    def __init__(self, path: str, rank: Optional[int] = None,
                 meta: Optional[dict] = None):
        self.path = path
        self.rank = _rank() if rank is None else int(rank)
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w", buffering=1)  # line-buffered: crash-safe
        header = {"type": "header", "version": FORMAT_VERSION,
                  "rank": self.rank, "pid": os.getpid(),
                  "clock": {"perf_ns": time.perf_counter_ns(),
                            "unix_ns": time.time_ns()}}
        if meta:
            header["meta"] = dict(meta)
        self._write(header)

    def _write(self, obj: dict):
        line = json.dumps(obj, separators=(",", ":"))
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")

    def span(self, cat: str, name: str, start_ns: int, end_ns: int,
             tid: int = 0, args: Optional[dict] = None):
        ev = {"type": "span", "cat": cat, "name": name,
              "ts": int(start_ns), "dur": max(int(end_ns - start_ns), 0),
              "tid": int(tid)}
        if args:
            ev["args"] = args
        self._write(ev)

    def mark(self, cat: str, name: str, ts_ns: Optional[int] = None,
             tid: int = 0, args: Optional[dict] = None):
        ev = {"type": "mark", "cat": cat, "name": name,
              "ts": int(time.perf_counter_ns() if ts_ns is None else ts_ns),
              "tid": int(tid)}
        if args:
            ev["args"] = args
        self._write(ev)

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()


def enable(trace_dir: str, rank: Optional[int] = None) -> TraceWriter:
    """Start the per-rank writer (idempotent). A second call while
    tracing is armed keeps the existing writer; if it asked for a
    different directory, that is almost certainly a bug (spans would
    land where the caller isn't looking), so it warns loudly."""
    global _active
    if _active is not None:
        want = os.path.abspath(trace_dir)
        have = os.path.dirname(os.path.abspath(_active.path))
        if want != have:
            import warnings
            warnings.warn(
                f"trace.enable({trace_dir!r}) ignored: tracing is "
                f"already writing to {have!r} — trace.disable() first "
                f"to redirect", RuntimeWarning, stacklevel=2)
        return _active
    r = _rank() if rank is None else int(rank)
    path = os.path.join(trace_dir, f"trace_rank{r}_{os.getpid()}.jsonl")
    _active = TraceWriter(path, rank=r)
    return _active


def disable():
    global _active
    if _active is None:
        return
    w, _active = _active, None
    w.close()


def active() -> Optional[TraceWriter]:
    return _active


def span(cat: str, name: str, start_ns: int, end_ns: int, tid: int = 0,
         args: Optional[dict] = None):
    """Record one span iff tracing is on (cheap no-op otherwise)."""
    w = _active
    if w is not None:
        w.span(cat, name, start_ns, end_ns, tid=tid, args=args)


def mark(cat: str, name: str, ts_ns: Optional[int] = None, tid: int = 0,
         args: Optional[dict] = None):
    w = _active
    if w is not None:
        w.mark(cat, name, ts_ns=ts_ns, tid=tid, args=args)


# ---------------------------------------------------------------------------
# merge: N per-rank files -> one aligned chrome trace + skew summary
# ---------------------------------------------------------------------------

def _load_rank_file(path: str):
    """(header, events) — skips torn trailing lines (a crashed writer's
    last line may be partial; everything before it is still good)."""
    header, events = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a crashed writer
            if obj.get("type") == "header":
                header = obj
            else:
                events.append(obj)
    if header is None:
        raise ValueError(f"{path}: no trace header line")
    return header, events


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(int(round(q * (len(s) - 1))), len(s) - 1)
    return s[idx]


def _goodput_rollup(ranks: List[dict], aligned: List[tuple]) -> dict:
    """Offline goodput reclassification (``merge --goodput``): replay the
    reference's live goodput ledger split from the step spans' embedded
    shares (``data_time_s`` / ``exposed_collective_time_s`` /
    ``compile_s`` / ``ckpt_s``, which the reference's StepTimer
    writes), so old trace dirs get goodput numbers retroactively.

    Per lane: each step span's wall splits into its bins; the gaps
    *between* consecutive step spans are ``other_overhead``. Per rank: a
    relaunch (second lane, new pid) makes the gap between the first
    lane's last event and the second's first event ``restart`` badput —
    unless the successor lane opens with an elastic ``resize`` marker
    (the launcher's planned-resize relaunch), in which case the gap is
    ``reshard``. In-place resizes ride as ``cat="elastic"`` spans whose
    wall bins as ``reshard`` directly.
    """
    bins = {b: 0.0 for b in GOODPUT_BINS}
    lanes: Dict[str, dict] = {}
    for ts, r, ev in aligned:
        lane = lanes.setdefault(
            r["label"], {"rank": r["rank"], "steps": [],
                         "first_ns": ts, "last_ns": ts,
                         "resized": False})
        end = ts + int(ev.get("dur", 0)) if ev.get("type") == "span" else ts
        lane["first_ns"] = min(lane["first_ns"], ts)
        lane["last_ns"] = max(lane["last_ns"], end)
        if ev.get("cat") == "step" and ev.get("type") == "span":
            lane["steps"].append((ts, end, ev.get("args") or {}))
        elif ev.get("cat") == "elastic":
            if str(ev.get("name", "")).startswith("resize"):
                lane["resized"] = True
            if ev.get("type") == "span":
                lane["steps"].append((ts, end, {"__elastic__": True}))
    steps = 0
    for lane in lanes.values():
        lane["steps"].sort()
        prev_end = None
        for ts, end, a in lane["steps"]:
            if a.get("__elastic__"):
                # an in-place resize span: its whole wall is reshard
                bins["reshard"] += (end - ts) / 1e9
                if prev_end is not None and ts > prev_end:
                    bins["other_overhead"] += (ts - prev_end) / 1e9
                prev_end = max(prev_end or end, end)
                continue
            dur = float(a.get("step_time_s", (end - ts) / 1e9))
            shares = {
                "data_stall": float(a.get("data_time_s", 0.0)),
                "exposed_collective": float(
                    a.get("exposed_collective_time_s", 0.0)),
                "compile": float(a.get("compile_s", 0.0)),
                "checkpoint": float(a.get("ckpt_s", 0.0)),
            }
            scale = min(dur / max(sum(shares.values()), 1e-12), 1.0)
            for b, v in shares.items():
                bins[b] += v * scale
            bins["productive"] += dur - min(sum(shares.values()), dur)
            if prev_end is not None and ts > prev_end:
                bins["other_overhead"] += (ts - prev_end) / 1e9
            prev_end = end
            steps += 1
    # relaunch gaps: lanes of the same rank, ordered by first event
    by_rank: Dict[int, List[dict]] = {}
    for lane in lanes.values():
        by_rank.setdefault(lane["rank"], []).append(lane)
    for group in by_rank.values():
        group.sort(key=lambda ln: ln["first_ns"])
        for prev, nxt in zip(group, group[1:]):
            gap = (nxt["first_ns"] - prev["last_ns"]) / 1e9
            if gap > 0:
                # a successor lane born from a planned resize marks
                # itself; its rebirth gap is elasticity, not a crash
                bins["reshard" if nxt["resized"] else "restart"] += gap
    wall = sum(bins.values())
    return {"bins": {b: round(v, 6) for b, v in bins.items()},
            "wall_s": round(wall, 6), "steps": steps,
            "lanes": sorted(lanes),
            "job_goodput_fraction": round(
                bins["productive"] / wall, 6) if wall > 0 else 0.0}


def _request_rollup(aligned: List[tuple]) -> dict:
    """``merge --requests``: stitch each request's serving spans across
    rank/pid lanes into one per-request summary, keyed by the W3C trace
    id every serving span carries (``args.trace`` — the id the HTTP
    server echoed to the client). A client holding a ``traceparent``
    from an error body looks its request up here; cross-process chains
    (router -> replica hops) fold into the same entry because
    the id survives the hop. Spans with no trace id fall back to a
    ``req:<id>`` key (pre-ledger writers)."""
    reqs: Dict[str, dict] = {}
    for ts, r, ev in aligned:
        if ev.get("cat") != "serving":
            continue
        a = ev.get("args") or {}
        key = a.get("trace") or (
            f"req:{a['req']}" if a.get("req") is not None else None)
        if key is None:
            continue
        end = ts + int(ev.get("dur", 0)) if ev.get("type") == "span" else ts
        q = reqs.setdefault(key, {
            "trace_id": a.get("trace"), "req_id": a.get("req"),
            "lanes": set(), "spans": 0, "first_ns": ts, "last_ns": end,
            "queue_wait_s": None, "prefill_chunks": 0,
            "prefill_tokens": 0, "compiles": 0, "preemptions": 0})
        q["lanes"].add(r["label"])
        q["spans"] += 1
        q["first_ns"] = min(q["first_ns"], ts)
        q["last_ns"] = max(q["last_ns"], end)
        name = ev.get("name")
        if name == "queue_wait":
            q["queue_wait_s"] = round((end - ts) / 1e9, 6)
        elif name == "prefill_chunk":
            q["prefill_chunks"] += 1
            q["prefill_tokens"] += int(a.get("tokens", 0))
            q["compiles"] += int(a.get("compiles", 0))
        elif name == "preempted":
            q["preemptions"] = max(q["preemptions"],
                                   int(a.get("preemptions", 0)))
        elif name == "request_done":
            # the authoritative completion record (ledger-enriched)
            for src, dst in (("finish_reason", "finish_reason"),
                             ("prompt_len", "prompt_len"),
                             ("generated", "generated"),
                             ("prefilled_tokens", "prefilled_tokens"),
                             ("cached_tokens", "cached_tokens"),
                             ("decode_tokens", "decode_tokens"),
                             ("kv_block_seconds", "kv_block_seconds"),
                             ("ttft_s", "ttft_s"),
                             ("latency_s", "latency_s"),
                             ("itl_p50_ms", "itl_p50_ms"),
                             ("itl_p99_ms", "itl_p99_ms")):
                if src in a:
                    q[dst] = a[src]
            q["preemptions"] = max(q["preemptions"],
                                   int(a.get("preemptions", 0)))
    out = {}
    for key, q in reqs.items():
        q["lanes"] = sorted(q["lanes"])
        q["wall_s"] = round((q["last_ns"] - q["first_ns"]) / 1e9, 6)
        del q["first_ns"], q["last_ns"]
        out[key] = q
    return {"requests": out, "count": len(out)}


def merge(trace_dir: str, out_trace: Optional[str] = None,
          out_summary: Optional[str] = None,
          pattern: str = "trace_rank*.jsonl",
          goodput: bool = False, requests: bool = False) -> dict:
    """Merge every per-rank trace file under ``trace_dir`` onto one
    clock. Writes a chrome trace (default ``merged_trace.json``) and a
    summary (default ``merge_summary.json``) into ``trace_dir`` and
    returns the summary dict.

    Alignment: each event's local ``perf_counter_ns`` timestamp is
    shifted by its rank's header anchor onto the unix-epoch clock, then
    the merged trace is re-zeroed at the earliest event. Skew/straggler
    stats come from the ``step`` spans (``args.step`` ids shared across
    ranks): per step, the spread between the first and last rank to
    finish, and which rank was last.
    """
    paths = sorted(_glob.glob(os.path.join(trace_dir, pattern)))
    if not paths:
        raise FileNotFoundError(
            f"no {pattern!r} files under {trace_dir!r}")
    ranks = []
    for p in paths:
        header, events = _load_rank_file(p)
        clock = header.get("clock", {})
        offset = int(clock.get("unix_ns", 0)) - int(clock.get("perf_ns", 0))
        ranks.append({"path": p, "rank": int(header.get("rank", 0)),
                      "offset": offset, "events": events,
                      "pid": header.get("pid")})

    # One lane per FILE, not per rank: a crash + relaunch leaves two
    # files for the same rank (the documented postmortem case), and
    # folding them together would silently clobber step end-times and
    # interleave two processes in one chrome lane. When a rank appears
    # once its lane label/pid stay the plain rank; duplicates get
    # "rank:pid" labels and unique synthetic chrome pids.
    rank_seen: Dict[int, int] = {}
    for r in ranks:
        rank_seen[r["rank"]] = rank_seen.get(r["rank"], 0) + 1
    next_pid = max((r["rank"] for r in ranks), default=0) + 1
    seen_labels: Dict[str, int] = {}
    for r in sorted(ranks, key=lambda x: (x["rank"], x["path"])):
        if rank_seen[r["rank"]] == 1:
            r["label"], r["chrome_pid"] = str(r["rank"]), r["rank"]
            r["lane_name"] = f"rank {r['rank']}"
        else:
            r["label"] = f"{r['rank']}:{r['pid']}"
            r["chrome_pid"], next_pid = next_pid, next_pid + 1
            r["lane_name"] = f"rank {r['rank']} (pid {r['pid']})"
        n = seen_labels.get(r["label"], 0)
        seen_labels[r["label"]] = n + 1
        if n:  # same rank AND same header pid: still one lane per file
            r["label"] = f"{r['label']}#{n}"

    # align every event onto the unix clock, then re-zero
    aligned = []
    for r in ranks:
        for ev in r["events"]:
            ts = int(ev.get("ts", 0)) + r["offset"]
            aligned.append((ts, r, ev))
    if not aligned:
        raise ValueError(f"trace files under {trace_dir!r} hold no events")
    aligned.sort(key=lambda t: t[0])
    t_zero = aligned[0][0]

    # -- chrome trace --------------------------------------------------------
    chrome: List[dict] = []
    for r in sorted(ranks, key=lambda r: (r["rank"], r["path"])):
        chrome.append({"ph": "M", "name": "process_name",
                       "pid": r["chrome_pid"],
                       "args": {"name": r["lane_name"]}})
    for ts, r, ev in aligned:
        d = {"name": ev.get("name", "?"), "cat": ev.get("cat", "user"),
             "pid": r["chrome_pid"], "tid": ev.get("tid", 0),
             "ts": (ts - t_zero) / 1000.0}  # chrome wants microseconds
        if ev.get("type") == "span":
            d["ph"] = "X"
            d["dur"] = int(ev.get("dur", 0)) / 1000.0
        else:
            d["ph"] = "i"
            d["s"] = "p"  # instant event, process-scoped
        if ev.get("args"):
            d["args"] = dict(ev["args"])
        chrome.append(d)

    # -- skew / straggler stats over shared step ids -------------------------
    # step end time per (step id, lane), aligned clock — lanes, not
    # ranks, so a relaunched rank's second file can't clobber the first
    step_ends: Dict[object, Dict[str, int]] = {}
    step_starts: Dict[object, Dict[str, int]] = {}
    lane_rank = {r["label"]: r["rank"] for r in ranks}
    for ts, r, ev in aligned:
        if ev.get("cat") != "step" or ev.get("type") != "span":
            continue
        sid = (ev.get("args") or {}).get("step")
        if sid is None:
            continue
        step_starts.setdefault(sid, {})[r["label"]] = ts
        step_ends.setdefault(sid, {})[r["label"]] = \
            ts + int(ev.get("dur", 0))
    spreads, start_spreads = [], []
    straggler_counts: Dict[str, int] = {}
    per_step = {}
    for sid, ends in sorted(step_ends.items(), key=lambda kv: str(kv[0])):
        if len(ends) < 2:
            continue
        last = max(ends, key=lambda k: ends[k])
        spread = max(ends.values()) - min(ends.values())
        spreads.append(spread)
        starts = step_starts.get(sid, {})
        if len(starts) >= 2:
            start_spreads.append(max(starts.values()) - min(starts.values()))
        straggler_counts[last] = straggler_counts.get(last, 0) + 1
        per_step[str(sid)] = {"end_spread_ns": spread,
                              "straggler_rank": lane_rank[last]}

    # -- comm rollup (bytes / exposure by axes, across ranks) ----------------
    comm: Dict[str, dict] = {}
    for ts, r, ev in aligned:
        if ev.get("cat") != "comm" or ev.get("type") != "span":
            continue
        a = ev.get("args") or {}
        key = str(a.get("axes", "world"))
        c = comm.setdefault(key, {"calls": 0, "bytes": 0, "seconds": 0.0,
                                  "exposed_seconds": 0.0,
                                  "overlapped_seconds": 0.0})
        c["calls"] += 1
        c["bytes"] += int(a.get("bytes", 0))
        c["seconds"] += int(ev.get("dur", 0)) / 1e9
        c["exposed_seconds"] += float(a.get("exposed_s", 0.0))
        c["overlapped_seconds"] += float(a.get("overlapped_s", 0.0))

    _ref_offset = min(ranks,
                      key=lambda x: (x["rank"], x["path"]))["offset"]
    summary = {
        "trace_dir": os.path.abspath(trace_dir),
        "ranks": sorted({r["rank"] for r in ranks}),
        "files": [os.path.basename(r["path"]) for r in ranks],
        "events": len(aligned),
        # offsets are relative to the LOWEST rank's (first) lane — file
        # order is lexicographic: trace_rank10_* sorts before
        # trace_rank2_*, so file order must not pick the reference
        "clock_offsets_ns": {r["label"]: r["offset"] - _ref_offset
                             for r in ranks},
        "steps_compared": len(spreads),
        "skew": {
            "step_end_spread_ns": {
                "mean": (sum(spreads) / len(spreads)) if spreads else 0.0,
                "max": max(spreads) if spreads else 0,
                "p50": _percentile([float(s) for s in spreads], 0.5),
            },
            "step_start_spread_ns_max": (max(start_spreads)
                                         if start_spreads else 0),
        },
        "straggler_counts": {str(k): v
                             for k, v in sorted(straggler_counts.items())},
        "per_step": per_step,
        "comm_by_axes": comm,
    }
    if goodput:
        summary["goodput"] = _goodput_rollup(ranks, aligned)
    if requests:
        summary["requests"] = _request_rollup(aligned)

    out_trace = out_trace or os.path.join(trace_dir, "merged_trace.json")
    out_summary = out_summary or os.path.join(trace_dir,
                                              "merge_summary.json")
    with open(out_trace, "w") as f:
        json.dump({"traceEvents": chrome, "displayTimeUnit": "ms"}, f)
    with open(out_summary, "w") as f:
        json.dump(summary, f, indent=1)
    summary["out_trace"] = out_trace
    summary["out_summary"] = out_summary
    return summary


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.trace",
        description="cross-rank trace tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge per-rank trace files onto "
                        "one clock; emit chrome trace + skew summary")
    mp.add_argument("trace_dir")
    mp.add_argument("--out", default=None, help="chrome trace output path")
    mp.add_argument("--summary", default=None, help="summary JSON path")
    mp.add_argument("--goodput", action="store_true",
                    help="reclassify merged step spans into the goodput "
                         "ledger bins (offline job_goodput_fraction)")
    mp.add_argument("--requests", action="store_true",
                    help="group serving spans by W3C trace id across "
                         "lanes; emit a per-request summary (ttft, itl "
                         "percentiles, preemptions, KV block-seconds)")
    args = ap.parse_args(argv)
    if args.cmd == "merge":
        s = merge(args.trace_dir, out_trace=args.out,
                  out_summary=args.summary, goodput=args.goodput,
                  requests=args.requests)
        keys = ["ranks", "events", "steps_compared", "skew",
                "straggler_counts", "out_trace", "out_summary"]
        if args.goodput:
            keys.append("goodput")
        if args.requests:
            keys.append("requests")
        print(json.dumps({k: s[k] for k in keys}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
