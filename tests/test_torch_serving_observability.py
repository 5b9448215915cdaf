"""The port's serving observability against ``paddle_tpu``'s: the
metrics exposition, ``traceparent``, the request ledger, the tail
sampler, SLO burn rates, ``trace merge --requests``, ``/statusz``, the
memory ledger and the profiler seams, and the HTTP server's shedding,
deadlines and trace echo.

Where both packages compute the same thing, the same inputs go through
both: identical registry operations give byte-equal Prometheus text
and equal JSON; identical traffic into the JAX engine and the port's
(the same bridged tiny Llama, f32, one module-scoped JAX engine) gives
ledger records equal in every field but the timings.
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.observability import memory as jmemory
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import requests as jrequests
from paddle_tpu.observability import slo as jslo
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.observability import fleet, memory, metrics, profile
from paddle_tpu_torch.observability import requests as obs_requests
from paddle_tpu_torch.observability import slo, trace
from paddle_tpu_torch.serving import Server, ServingEngine
from paddle_tpu_torch.serving.engine import serving_metrics

from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401

KW = dict(max_batch=3, max_blocks=12, block_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny(11)
    return jm, bridged(jm)


def _post(url, body, headers=None, timeout=60):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(url, timeout=30):
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---------------- exposition ------------------------------------------------
def _registry_ops(reg):
    c = reg.counter("ops_total", "requests by outcome")
    c.inc(outcome="ok")
    c.inc(2.5, outcome='quote " back \\ new\nline')
    reg.gauge("queue_depth", "").set(3)
    g = reg.gauge("hbm_bytes", "bytes by owner")
    g.set(1 << 40, owner="kv_cache")
    g.dec(7, owner="params")
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.0005, 0.02, 0.3, 7.0, 99.0):
        h.observe(v, kind="decode")
    h2 = reg.histogram("ttft_seconds", "ttft", buckets=(0.1, 1.0, 0.5))
    h2.observe(0.4)
    reg.counter("untouched_total", "no samples yet")


def _overflow_ops(reg):
    c = reg.counter("per_request_total", "a label that should not be one")
    for i in range(12):
        c.inc(req=str(i))


@pytest.mark.parametrize("ops", [_registry_ops, _overflow_ops,
                                 lambda reg: None])
def test_exposition_equals_the_reference(ops, monkeypatch):
    """The same operations on a fresh registry of each package give
    byte-equal Prometheus text and equal JSON (label escaping, histogram
    buckets, the overflow series, an empty registry)."""
    monkeypatch.setenv("PADDLE_TPU_METRICS_MAX_LABELSETS", "5")
    ref, port = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ops(ref)
        ops(port)
    assert port.prometheus_text() == ref.prometheus_text()
    assert port.to_json() == ref.to_json()
    assert json.dumps(port.to_json()) == json.dumps(ref.to_json())


def test_metrics_exporter_endpoints():
    reg = metrics.MetricsRegistry()
    _registry_ops(reg)
    exp = metrics.MetricsExporter(0, reg)
    try:
        base = f"http://127.0.0.1:{exp.port}"
        code, body = _get(base + "/metrics")
        assert code == 200 and body.decode() == reg.prometheus_text()
        code, body = _get(base + "/metrics.json")
        assert code == 200 and json.loads(body) == reg.to_json()
        code, body = _get(base + "/healthz")
        hz = json.loads(body)
        assert hz["status"] == "ok" and hz["rank"] == 0 \
            and hz["job_id"] == "local" and "last_step_age_seconds" in hz
        code, body = _get(base + "/statusz?format=json")
        assert code == 200 and set(json.loads(body)) == {"slo", "requests"}
        code, body = _get(base + "/fleetz")
        fz = json.loads(body)
        # the reference's single-process document: no aggregator, no
        # heartbeats, this process's goodput ledger
        assert code == 200 and fz["aggregator"] is False
        assert fz["ranks"] == {} and "local_goodput" in fz
        assert _get(base + "/nope")[0] == 404
    finally:
        exp.stop()


# ---------------- traceparent -----------------------------------------------
_TID = "4bf92f3577b34da6a3ce929d0e0e4736"


@pytest.mark.parametrize("header", [
    f"00-{_TID}-00f067aa0ba902b7-01", f"00-{_TID.upper()}-00F067AA0BA902B7-00",
    f"  00-{_TID}-00f067aa0ba902b7-01 ", None, "", "garbage",
    f"00-{_TID}-00f067aa0ba902b7-01-extra",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
    f"00-{_TID}-" + "0" * 16 + "-01", f"ff-{_TID}-00f067aa0ba902b7-01",
    "00-" + "g" * 32 + "-00f067aa0ba902b7-01",
    "00-" + "a" * 31 + "-00f067aa0ba902b7-01", 12345])
def test_traceparent_parse_equals_the_reference(header):
    assert obs_requests.parse_traceparent(header) == \
        jrequests.parse_traceparent(header)


def test_traceparent_format_round_trips():
    tid = obs_requests.new_trace_id()
    assert len(tid) == 32 and int(tid, 16) != 0
    for sampled in (True, False):
        hdr = obs_requests.format_traceparent(tid, sampled=sampled)
        assert obs_requests.parse_traceparent(hdr) == \
            jrequests.parse_traceparent(hdr) == tid
        assert hdr.endswith("-01" if sampled else "-00")
    assert obs_requests.format_traceparent(tid, "00f067aa0ba902b7") == \
        jrequests.format_traceparent(tid, "00f067aa0ba902b7")
    assert len(obs_requests.new_span_id()) == 16


# ---------------- the ledger over identical traffic -------------------------
_TIMINGS = ("queue_wait_s", "ttft_s", "latency_s", "itl_p50_s", "itl_p99_s",
            "kv_block_seconds", "req_id", "kept", "age_s")


def _traffic(engine, led):
    """Three rounds on one engine, every record kept: a tight-pool burst
    (preemption), a shared prefix served in turn (prefix-cache hits, one
    fully cached and aligned), and an eos stop. Returns {trace id:
    record}, the streams and the greedy results."""
    led.sample_rate = 1.0
    rng = np.random.RandomState(3)
    prefix = rng.randint(1, 256, 12).tolist()
    rounds = [
        [(rng.randint(1, 256, n).tolist(), 8, None) for n in (9, 12, 7)],
        [(prefix + rng.randint(1, 256, 3).tolist(), 4, None),
         (prefix + rng.randint(1, 256, 5).tolist(), 4, None),
         (list(prefix), 4, None)],
        None]
    streams, n = [], 0
    for r, reqs in enumerate(rounds):
        if r == 2:
            # the first shared-prefix prompt again, stopping at its
            # first token: an eos finish served from the cache
            reqs = [(rounds[1][0][0], 6, streams[3][0])]
        hs = []
        for prompt, new, eos in reqs:
            tid = f"{n + 1:032x}"
            n += 1
            hs.append(engine.submit(prompt, max_new_tokens=new,
                                    eos_token_id=eos, trace_id=tid))
            if r == 1:
                engine.run_until_idle()
        engine.run_until_idle()
        streams += [h.result(30)["token_ids"] for h in hs]
    recs = {d["trace_id"]: d for d in led.exemplars()
            if d["trace_id"] is not None and int(d["trace_id"], 16) <= n}
    return recs, streams


@pytest.fixture(scope="module")
def ledger_runs(models):
    jm, tm = models
    jled = jrequests.maybe_arm()
    pled = obs_requests.maybe_arm()
    jrate, prate = jled.sample_rate, pled.sample_rate
    try:
        jeng = JaxEngine(jm, attn_impl="gather", **KW)
        # compile the one unified step first: later records ride no
        # compile (the port compiles nothing)
        jeng.submit([1, 2, 3], max_new_tokens=1)
        jeng.run_until_idle()
        ref = _traffic(jeng, jled)
        peng = ServingEngine(tm, device="cpu", **KW)
        peng.submit([1, 2, 3], max_new_tokens=1)
        peng.run_until_idle()
        got = _traffic(peng, pled)
    finally:
        jled.sample_rate, pled.sample_rate = jrate, prate
    return ref, got, peng


def test_ledger_records_equal_the_reference(ledger_runs):
    (ref, ref_streams), (got, streams), _ = ledger_runs
    assert streams == ref_streams and len(got) == len(ref) == 7
    for tid, want in ref.items():
        have = got[tid]
        assert set(have) == set(want)
        assert {k: v for k, v in have.items() if k not in _TIMINGS} == \
            {k: v for k, v in want.items() if k not in _TIMINGS}, tid
    reasons = {d["finish_reason"] for d in got.values()}
    assert reasons == {"length", "eos"}
    assert any(d["preemptions"] for d in got.values())
    assert sum(d["cached_tokens"] for d in got.values()) >= 12 + 11


def test_ledger_prefilled_plus_cached_covers_the_prompt(ledger_runs):
    _, (got, streams), peng = ledger_runs
    for d in got.values():
        # every preempted request re-prefilled what it had generated
        # too; the rest cover exactly their prompt
        covered = d["prefilled_tokens"] + d["cached_tokens"]
        if d["preemptions"] == 0:
            assert covered == d["prompt_len"]
        else:
            assert covered > d["prompt_len"]
        assert d["state"] == "done" and d["decode_tokens"] >= 1
        assert d["peak_kv_blocks"] > 0 and d["kv_block_seconds"] > 0
        assert d["ttft_s"] > 0 and d["latency_s"] >= d["ttft_s"]
    st = peng.stats()
    assert st["requests_in_flight"] == 0
    assert st["kv_block_seconds_total"] >= 0.5 * sum(
        d["kv_block_seconds"] for d in got.values())
    assert obs_requests.active().in_flight_count() == 0


def test_streams_bit_equal_with_the_ledger_armed_and_disarmed(models):
    _, tm = models
    prompt = np.random.RandomState(9).randint(1, 256, 11).tolist()
    out = []
    for armed in (True, False):
        eng = ServingEngine(tm, device="cpu", request_ledger=armed, **KW)
        assert (eng._ledger is not None) is armed
        h = eng.submit(prompt, max_new_tokens=7)
        eng.run_until_idle()
        out.append(h.result(10)["token_ids"])
    assert out[0] == out[1]
    assert obs_requests.active() is not None  # still armed for the rest


# ---------------- tail sampler and burn rates -------------------------------
class _FakeReq:
    def __init__(self, rid):
        self.req_id = rid
        self.trace_id = f"{rid:032x}"
        self.arrival_time = 0.0
        self.prompt_tokens = [1, 2, 3]
        self.max_new_tokens = 4


class _FakeSeq:
    def __init__(self, rid, latency=0.1, failed=False, preemptions=0):
        self.req_id = rid
        self.state = "failed" if failed else "finished"
        self.arrival_time = 0.0
        self.slot_time = 0.01
        self.prefilled_tokens = 3
        self.cached_tokens_total = 0
        self.generated = [7, 8]
        self.preemptions = preemptions
        self.finish_reason = "error" if failed else "length"
        self.error = "boom" if failed else None
        self._latency = latency

    def ttft(self):
        return None if self.error else self._latency / 2

    def latency(self):
        return self._latency


def test_tail_sampler_keeps_what_the_reference_keeps(tmp_path):
    """The reference's own sequence: 30 ordinary requests at rate 0, a
    slow one, an error and a preempted one, through both ledgers."""
    leds = [jrequests.RequestLedger(log_dir=str(tmp_path / "ref"),
                                    sample_rate=0.0),
            obs_requests.RequestLedger(log_dir=str(tmp_path / "port"),
                                       sample_rate=0.0)]
    for led in leds:
        rid = iter(range(1000))

        def run(**kw):
            r = next(rid)
            led.admit(_FakeReq(r))
            led.complete(_FakeSeq(r, **kw))
        for _ in range(30):
            run(latency=0.1)
        run(latency=9.0)
        run(failed=True)
        run(preemptions=2)
        led.close()
    ref, port = leds
    assert port.dropped == ref.dropped == 30
    assert port.kept == ref.kept == {"error": 1, "preempted": 1,
                                     "slow_tail": 1, "sampled": 0}
    assert port.exemplars() == ref.exemplars()
    lines = {}
    for who in ("ref", "port"):
        (f,) = list((tmp_path / who).glob("requests_*.jsonl"))
        lines[who] = [json.loads(x) for x in f.read_text().splitlines()]
    assert lines["port"] == lines["ref"]
    assert [d["kept"] for d in lines["port"]] == \
        ["slow_tail", "error", "preempted"]


def _rec(mod, ttft_s, failed=False, itl=()):
    r = mod.RequestRecord(req_id=0, trace_id=None, arrival_s=0.0,
                          prompt_len=4, max_new_tokens=4)
    r.state = "failed" if failed else "done"
    r.ttft_s = ttft_s
    r.itl_samples_s = list(itl)
    return r


def test_burn_rates_equal_the_reference():
    """The reference's sustained breach, recovery and drain, through both
    monitors: the same burn rates, bad fractions and alerts at each
    reading."""
    snaps = []
    for mod, smod in ((jrequests, jslo), (obs_requests, slo)):
        mon = smod.configure({"ttft_p99": (0.5, 0.99),
                              "success": (0.999, 0.999)},
                             windows_s=(10.0, 100.0), alert_threshold=2.0)
        try:
            t0, out = 1000.0, []
            for i in range(10):
                mon.observe(_rec(mod, 5.0), now=t0 + i)
            out.append(mon.snapshot(now=t0 + 10.0))
            for i in range(40):
                mon.observe(_rec(mod, 0.01, failed=i == 3), now=t0 + 30 + i)
            out.append(mon.snapshot(now=t0 + 70.0))
            out.append(mon.snapshot(now=t0 + 500.0))
            m = smod.slo_metrics()
            out.append((m["alert"].value(slo="ttft_p99"),
                        m["bad_fraction"].value(slo="success",
                                                window="slow")))
        finally:
            smod.reset()
        snaps.append(out)
    assert snaps[1] == snaps[0]
    first = snaps[1][0]["slos"]["ttft_p99"]
    assert first["burn_rate"] == {"fast": 100.0, "slow": 100.0}
    assert first["alerting"] is True
    assert snaps[1][1]["slos"]["ttft_p99"]["alerting"] is False
    assert snaps[1][2]["slos"]["ttft_p99"]["events_in_window"] == 0


@pytest.mark.parametrize("name,rec", [
    ("ttft_p99", dict(ttft_s=0.9)), ("ttft_p99", dict(ttft_s=0.1)),
    ("ttft_p99", dict(ttft_s=None, failed=True)),
    ("ttft_p99", dict(ttft_s=None)),
    ("itl_p99", dict(ttft_s=0.1, itl=[0.01] * 9 + [0.2])),
    ("itl_p99", dict(ttft_s=0.1)), ("success", dict(ttft_s=None,
                                                     failed=True)),
    ("success", dict(ttft_s=0.1))])
def test_slo_verdicts_equal_the_reference(name, rec):
    targets = {"ttft_p99": (0.5, 0.99), "itl_p99": (0.05, 0.99),
               "success": (0.999, 0.999)}
    want = jslo.SloMonitor(targets)._verdict(name, _rec(jrequests, **rec))
    got = slo.SloMonitor(targets)._verdict(name, _rec(obs_requests, **rec))
    assert got == want


def test_slo_targets_take_the_reference_knobs_as_arguments():
    assert slo.slo_targets(ttft_p99_s=0.25, success=0.995) == \
        {"ttft_p99": (0.25, 0.99), "success": (0.995, 0.995)}
    assert slo.slo_targets(ttft_p99_s=0, itl_p99_s=-1, success=1.0) == {}


# ---------------- trace merge -----------------------------------------------
def test_trace_merge_requests_agrees_with_the_ledger(models, tmp_path):
    _, tm = models
    led = obs_requests.maybe_arm()
    rate, led.sample_rate = led.sample_rate, 1.0
    trace.enable(str(tmp_path))
    try:
        eng = ServingEngine(tm, device="cpu", **KW)
        rng = np.random.RandomState(12)
        prefix = rng.randint(1, 256, 8).tolist()
        tids = [f"{0xabc0 + i:032x}" for i in range(3)]
        hs = []
        for i, tid in enumerate(tids):
            hs.append(eng.submit(prefix + rng.randint(1, 256, 3 + i)
                                 .tolist(), max_new_tokens=4, trace_id=tid))
            eng.run_until_idle()
    finally:
        trace.disable()
        led.sample_rate = rate
    recs = {d["trace_id"]: d for d in led.exemplars()}
    out = tmp_path / "summary.json"
    from paddle_tpu_torch.observability.trace import _main
    assert _main(["merge", str(tmp_path), "--requests",
                  "--summary", str(out)]) == 0
    rollup = json.loads(out.read_text())["requests"]["requests"]
    for tid, h in zip(tids, hs):
        q, rec = rollup[tid], recs[tid]
        for k in ("prefilled_tokens", "cached_tokens", "decode_tokens",
                  "finish_reason", "prompt_len", "preemptions"):
            assert q[k] == rec[k], k
        assert q["prefill_tokens"] == rec["prefilled_tokens"]
        assert q["prefill_chunks"] == rec["prefill_chunks"]
        assert q["generated"] == len(h.result(1)["token_ids"]) == 4
        assert q["kv_block_seconds"] == pytest.approx(
            rec["kv_block_seconds"], abs=1e-5)
        assert q["queue_wait_s"] is not None and q["spans"] >= 4
    assert rollup[tids[1]]["cached_tokens"] == 8


# ---------------- the HTTP server -------------------------------------------
class _StuckHandle:
    req_id = 7

    def result(self, timeout=None):
        time.sleep(min(timeout or 0.0, 0.2))
        raise TimeoutError("never finishes")

    def wait(self, timeout=None):
        return False


class _StubEngine:
    def __init__(self, waiting=0):
        self.waiting = waiting

    def start(self):
        return self

    def shutdown(self, drain=True):
        pass

    def stats(self):
        return {"running": 0, "waiting": self.waiting}

    def submit(self, prompt_ids, **kw):
        h = _StuckHandle()
        h.trace_id = kw.get("trace_id")
        return h


def test_shed_503_with_retry_after_and_the_trace_echo():
    rej = serving_metrics()["rejections"]
    before = rej.value(reason="queue_full")
    tp = f"00-{_TID}-00f067aa0ba902b7-01"
    with Server(_StubEngine(waiting=9), max_queue_depth=2,
                retry_after_s=3) as srv:
        code, headers, body = _post(srv.url, {"prompt_ids": [1]},
                                    headers={"traceparent": tp})
        hz = json.loads(_get(srv.url + "/healthz")[1])
    assert code == 503 and headers["Retry-After"] == "3"
    assert json.loads(body)["trace_id"] == _TID
    assert obs_requests.parse_traceparent(headers["traceparent"]) == _TID
    assert rej.value(reason="queue_full") == before + 1
    assert hz["status"] == "degraded" and hz["max_queue_depth"] == 2


class _DoneHandle:
    req_id = 3
    trace_id = None

    def result(self, timeout=None):
        return {"token_ids": [1], "ttft_s": 0.1, "latency_s": 0.1}

    def wait(self, timeout=None):
        return True


class _SlowSubmitEngine(_StubEngine):
    """A submit that waits, as one does for the engine's lock while a
    step runs."""

    def submit(self, prompt_ids, **kw):
        time.sleep(0.5)
        return _DoneHandle()


def test_a_burst_during_one_step_is_shed_past_the_queue_depth():
    """Requests still being submitted count toward the queue depth: of 6
    arriving while the first submits wait, 2 pass at depth 2 and 4 get
    503 (the reference's check, on the queue alone, passes all 6)."""
    out = []
    with Server(_SlowSubmitEngine(), max_queue_depth=2) as srv:
        start = threading.Barrier(6)

        def fire():
            start.wait()
            out.append(_post(srv.url, {"prompt_ids": [1]})[0])
        threads = [threading.Thread(target=fire) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert srv._admitting == 0
    assert sorted(out) == [200, 200, 503, 503, 503, 503]


@pytest.mark.parametrize("deadline", [0, -1, "soon"])
def test_bad_deadline_is_400_with_the_trace_id(deadline):
    with Server(_StubEngine()) as srv:
        code, headers, body = _post(
            srv.url, {"prompt_ids": [1], "deadline_s": deadline})
    assert code == 400 and "deadline_s" in json.loads(body)["error"]
    assert obs_requests.parse_traceparent(headers["traceparent"]) == \
        json.loads(body)["trace_id"]


def test_deadline_504_aborts_the_request_in_the_engine(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **dict(KW, max_blocks=40))
    rej = serving_metrics()["rejections"]
    before = rej.value(reason="deadline")
    failed = serving_metrics()["requests"].value(outcome="failed")
    with Server(eng) as srv:
        code, headers, body = _post(srv.url, {
            "prompt_ids": list(range(1, 11)), "max_new_tokens": 110,
            "deadline_s": 0.02})
        res = json.loads(body)
        deadline = time.monotonic() + 30
        while eng.stats()["requests_in_flight"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        st = eng.stats()
    assert code == 504 and "timed out" in res["error"]
    assert len(res["trace_id"]) == 32 and res["request_id"] is not None
    assert "traceparent" in headers
    assert rej.value(reason="deadline") == before + 1
    assert serving_metrics()["requests"].value(outcome="failed") == \
        failed + 1
    # the abort gave the slot and every block back
    assert st["requests_in_flight"] == 0 and st["kv_blocks_in_use"] == 0
    eng.cache.allocator.assert_no_leaks()


def test_traceparent_echo_on_every_response(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **KW)
    tp = {"traceparent": f"00-{_TID}-00f067aa0ba902b7-01"}
    prompt = [5, 6, 7, 8, 9]
    with Server(eng) as srv:
        sync = _post(srv.url, {"prompt_ids": prompt, "max_new_tokens": 3},
                     headers=tp)
        stream = _post(srv.url, {"prompt_ids": prompt,
                                 "max_new_tokens": 3, "stream": True},
                       headers=tp)
        minted = _post(srv.url, {"prompt_ids": prompt, "max_new_tokens": 2})
        bad = _post(srv.url, {"prompt_ids": [999]}, headers=tp)
        missing = _post(srv.url, {"nope": 1}, headers=tp)
    for code, headers, body in (sync, stream, bad, missing):
        assert obs_requests.parse_traceparent(headers["traceparent"]) \
            == _TID
    assert sync[0] == 200 and json.loads(sync[2])["trace_id"] == _TID
    last = json.loads(stream[2].decode().strip().split("\n")[-1])
    assert stream[0] == 200 and last["done"] and last["trace_id"] == _TID
    assert bad[0] == 400 and json.loads(bad[2])["trace_id"] == _TID
    assert missing[0] == 400 and json.loads(missing[2])["trace_id"] == _TID
    tid = json.loads(minted[2])["trace_id"]
    assert obs_requests.parse_traceparent(minted[1]["traceparent"]) == tid


def _parse_prometheus(text):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


def test_metrics_statusz_healthz_and_fleetz_through_the_server(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **KW)
    fam = serving_metrics()
    acc0 = fam["requests"].value(outcome="accepted")
    gen0 = fam["tokens"].value(kind="generated")
    with Server(eng) as srv:
        for n in (4, 6):
            assert _post(srv.url, {"prompt_ids": list(range(1, 1 + n)),
                                   "max_new_tokens": 3})[0] == 200
        prom = _parse_prometheus(_get(srv.url + "/metrics")[1].decode())
        as_json = json.loads(_get(srv.url + "/metrics.json")[1])
        sz = json.loads(_get(srv.url + "/statusz?format=json")[1])
        html = _get(srv.url + "/statusz")[1].decode()
        hz = json.loads(_get(srv.url + "/healthz")[1])
        fz = _get(srv.url + "/fleetz")
    acc = prom['serving_requests_total{outcome="accepted"}']
    assert acc == fam["requests"].value(outcome="accepted") == acc0 + 2
    assert prom['serving_tokens_total{kind="generated"}'] == gen0 + 6
    assert "serving_ttft_seconds_count" in prom
    assert set(as_json) >= {"serving_requests_total", "serving_ttft_seconds",
                            "serving_kv_headroom", "hbm_bytes"}
    assert sz["requests"]["enabled"] and "slo" in sz
    assert sz["engine"]["requests_in_flight"] == 0
    assert "<h1>/statusz</h1>" in html and "KV block-seconds" in html
    assert hz["status"] == "ok" and hz["rank"] == 0
    assert hz["last_step_age_seconds"] is not None
    assert hz["kv_block_seconds_total"] > 0
    fleetz = json.loads(fz[1])
    assert fz[0] == 200 and fleetz["aggregator"] is False
    assert fleetz["rank"] == 0 and "local_goodput" in fleetz


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_statusz_payload_keys_equal_the_reference(models):
    """With an SLO armed and a request in flight in each package, the
    ``/statusz`` payloads carry the same keys (engine stats aside), and
    the in-flight rows the same fields."""
    jm, tm = models
    docs = []
    for eng_cls, req_mod, slo_mod, kw in (
            (JaxEngine, jrequests, jslo, {"attn_impl": "gather"}),
            (ServingEngine, obs_requests, slo, {"device": "cpu"})):
        slo_mod.configure({"ttft_p99": (0.5, 0.99)})
        try:
            model = jm if eng_cls is JaxEngine else tm
            eng = eng_cls(model, **KW, **kw)
            eng.submit([1, 2, 3, 4, 5], max_new_tokens=3)
            eng.step()
            doc = req_mod.statusz_payload(engine_stats={"running": 1})
            eng.run_until_idle()
            html = req_mod.render_statusz_html(doc)
        finally:
            slo_mod.reset()
        docs.append((doc, html))
    (ref, ref_html), (got, html) = docs
    assert _keys(got, 3) == _keys(ref, 3)
    assert set(got["requests"]["top_in_flight"][0]) == \
        set(ref["requests"]["top_in_flight"][0])
    assert "<h2>SLO burn rates</h2>" in html and "ttft_p99" in html
    assert html.count("<tr>") == ref_html.count("<tr>")


# ---------------- profiler seams --------------------------------------------
@pytest.fixture
def fake_trace(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(profile, "_start_trace",
                        lambda p: calls.append(("start", p)))
    monkeypatch.setattr(profile, "_stop_trace",
                        lambda: calls.append(("stop",)))
    profile.set_trace_dir(str(tmp_path))
    yield calls
    profile.stop_capture()
    profile.set_trace_dir(None)


def test_profile_endpoint_409_while_a_capture_is_live(fake_trace):
    with Server(_StubEngine()) as srv:
        def post(q):
            req = urllib.request.Request(srv.url + "/debug/profile" + q,
                                         data=b"", method="POST")
            try:
                r = urllib.request.urlopen(req, timeout=30)
                return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
        first = post("?seconds=0.3")
        busy = post("?seconds=1")
        banana = post("?seconds=banana")
        deadline = time.monotonic() + 10
        while profile.capture_active() and time.monotonic() < deadline:
            time.sleep(0.02)
        again = post("?seconds=500")
    assert first[0] == 200 and first[1]["status"] == "capturing"
    assert first[1]["seconds"] == 0.3 and \
        first[1]["trace_dir"].startswith(profile.trace_dir())
    assert busy[0] == 409 and "already running" in busy[1]["error"]
    assert banana[0] == 400
    assert again[0] == 200 and again[1]["seconds"] == \
        profile.MAX_CAPTURE_SECONDS
    assert [c[0] for c in fake_trace][:2] == ["start", "stop"]


def test_profile_bounds_and_step_window(fake_trace):
    for bad in (0, -1, float("nan"), "x"):
        with pytest.raises(ValueError):
            profile.bound_seconds(bad)
    assert profile.bound_seconds(1e9) == profile.MAX_CAPTURE_SECONDS
    win = profile.StepWindow(2, 3)
    for step in range(1, 6):
        win.on_step(step)
    win.close()
    assert [c[0] for c in fake_trace] == ["start", "stop"]
    assert win.capture_dir is not None and profile.capture_active() is None
    with pytest.raises(ValueError):
        profile.StepWindow(3, 2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_profile_capture_without_a_card_answers_500(tmp_path):
    """No hidden fallback: without a card the capture raises, and the
    server answers 500 instead of 200 with an empty trace."""
    profile.set_trace_dir(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            profile.start_capture()
        assert profile.capture_active() is None
        with Server(_StubEngine()) as srv:
            req = urllib.request.Request(srv.url + "/debug/profile",
                                         data=b"", method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 500
    finally:
        profile.set_trace_dir(None)


# ---------------- memory ----------------------------------------------------
def test_memory_ledger_through_the_stats_seam_equals_the_reference():
    owners = {"kv_cache": [np.zeros((4, 8), np.float32)] * 2,
              "params": {"w": np.ones((3, 5), np.float16)},
              "prefetch": 1000}
    stats = {"bytes_in_use": 10_000, "peak_bytes_in_use": 12_000,
             "bytes_limit": 40_000}
    snaps = []
    for mod in (jmemory, memory):
        led = mod.MemoryLedger(stats_fn=lambda: dict(stats))
        for name, tree in owners.items():
            led.register(name, tree)
        led.register("gone", lambda: None)
        snaps.append(led.snapshot())
        assert led.owners() == ["kv_cache", "params", "prefetch"]
    assert snaps[1] == snaps[0]
    assert snaps[1]["unattributed_bytes"] == 10_000 - (256 + 30 + 1000)
    assert snaps[1]["headroom"] == 0.75


def test_memory_gauges_and_the_headroom_warning():
    reg = metrics.MetricsRegistry()
    led = memory.MemoryLedger(
        stats_fn=lambda: {"bytes_in_use": 950, "bytes_limit": 1000},
        headroom_warn=0.1)
    led.register("kv_cache", torch.zeros(10, dtype=torch.float32))
    with pytest.warns(RuntimeWarning, match="headroom"):
        led.publish(reg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        snap = led.publish(reg)  # once per run
    m = memory.memory_metrics(reg)
    assert m["bytes"].value(owner="kv_cache") == 40
    assert m["bytes"].value(owner="unattributed") == 910
    assert m["headroom"].value() == pytest.approx(0.05)
    assert snap["owners"] == {"kv_cache": 40}


def test_oom_postmortem_once_with_the_ledger(tmp_path):
    led = memory.get_ledger()
    led.register("probe", torch.zeros(4))
    try:
        err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried ...")
        report = memory.MemoryReport(argument_bytes=10, temp_bytes=5,
                                     source="serving_step")
        path = memory.handle_oom(err, "serving_step", lambda: report,
                                 out_dir=str(tmp_path))
        assert memory.handle_oom(err, "serving_step",
                                 out_dir=str(tmp_path)) == path
        assert memory.handle_oom(ValueError("x"), "serving_step") is None
        assert memory.is_resource_exhausted(
            RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    finally:
        led.unregister("probe")
    doc = json.loads(open(path).read())
    assert os.path.basename(path).startswith("oom_postmortem_rank0_")
    assert doc["ledger"]["owners"]["probe"] == 16
    assert doc["memory_report"]["total_bytes"] == 15
    # the flight recorder is off: an empty tail, as the reference's
    assert doc["flight_recorder_tail"] == []
    assert doc["reason"] == "RESOURCE_EXHAUSTED"


def test_engine_registers_its_owners_and_reports_them(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **KW)
    params = sum(t.numel() * t.element_size() for t in
                 list(tm.parameters()) + list(tm.buffers()))
    pools = eng.cache.pool_bytes()
    owners = memory.snapshot()["owners"]
    assert owners["kv_cache"] == pools and owners["serving_params"] == params
    rep = eng.memory_report()
    assert rep.argument_bytes == params + pools
    assert rep.alias_bytes == pools and rep.temp_bytes == 0
    assert rep.output_bytes == 4 * KW["max_batch"] * tm.cfg.vocab_size
    assert rep.to_json()["source"] == "serving_step"


# ---------------- no environment knob ---------------------------------------
def test_the_reference_env_knobs_are_not_read(models, monkeypatch,
                                              tmp_path):
    """The reference reads ``PADDLE_TPU_REQUEST_LEDGER``,
    ``_REQUEST_LOG_DIR``, ``_REQUEST_LOG_SAMPLE``, ``PADDLE_TPU_SLO_*``,
    ``PADDLE_TPU_TRACE_SPANS``, ``_TRACE_DIR``,
    ``PADDLE_TPU_HBM_HEADROOM_WARN`` and ``PADDLE_TRAINER_ID``; the port
    reads none of them (arguments carry them)."""
    for k, v in (("PADDLE_TPU_REQUEST_LEDGER", "0"),
                 ("PADDLE_TPU_REQUEST_LOG_DIR", str(tmp_path / "log")),
                 ("PADDLE_TPU_REQUEST_LOG_SAMPLE", "1.0"),
                 ("PADDLE_TPU_SLO_TTFT_P99_S", "0.1"),
                 ("PADDLE_TPU_SLO_SUCCESS", "0.99"),
                 ("PADDLE_TPU_TRACE_SPANS", str(tmp_path / "spans")),
                 ("PADDLE_TPU_TRACE_DIR", str(tmp_path / "trace")),
                 ("PADDLE_TPU_HBM_HEADROOM_WARN", "0.99"),
                 ("PADDLE_TRAINER_ID", "3"),
                 ("PADDLE_TPU_JOB_ID", "job-x")):
        monkeypatch.setenv(k, v)
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **KW)
    assert eng._ledger is obs_requests.active() is not None
    assert slo.active() is None and trace.active() is None
    assert fleet.healthz_fields()["rank"] == 0
    assert fleet.job_id() == "local"
    assert memory.get_ledger().headroom_warn is None
    assert not profile.trace_dir().startswith(str(tmp_path))
    assert obs_requests.RequestLedger().log_dir is None
    assert obs_requests.RequestLedger().sample_rate == 0.05
    assert not (tmp_path / "log").exists()
    fleet.configure(rank=2, job_id="serve-1")
    try:
        assert fleet.healthz_fields()["rank"] == 2
        assert fleet.job_id() == "serve-1"
    finally:
        fleet.configure(rank=0, job_id="local")
