"""The port's training observability against ``paddle_tpu``'s:
``paddle.profiler`` (spans at op dispatch, ``PyLayer``, ``to_static`` and
``TrainStep``, the scheduler, the chrome export with its collective
lane, the native ring), the flight recorder, the comm tracer's exposure
accounting, the goodput ledger, ``StepTimer``, the phase attribution,
the ``VisualDL`` and ``StepTelemetry`` callbacks and ``/fleetz``.

Where the output is data and not a time, the same inputs go through
both packages and the results are equal: the scheduler's states, the
chrome export's structure, the goodput bins and ``StepTimer``'s stats
under one injected clock, the ``VisualDL`` records of the same fit on
bridged weights (rtol 1e-5, the fit tolerance of
``tests/test_torch_hapi.py``), the ``/fleetz`` document's keys. Timing
tests assert structure and counts only, never a ratio of times."""
import json
import os
import signal
import sys
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.profiler as jprofiler
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import goodput as jgoodput
from paddle_tpu.observability import step_timer as jstep_timer
from paddle_tpu_torch import profiler
from paddle_tpu_torch.observability import (comm, fleet, flight_recorder,
                                            goodput, memory, step_timer)
from paddle_tpu_torch.observability.metrics import (MetricsExporter,
                                                    MetricsRegistry)
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax


@pytest.fixture(autouse=True)
def _clean():
    """No recorder, ledger or pending compile seconds leak between tests."""
    flight_recorder.disable()
    goodput.reset_ledger()
    goodput._drain_pending_compile()
    yield
    flight_recorder.disable()
    goodput.reset_ledger()
    goodput._drain_pending_compile()
    jgoodput.reset_ledger()


def _ops():
    import paddle_tpu_torch as paddle
    a = torch.ones(4, 4)
    return paddle, a


# ---------------------------------------------------------------- profiler
def test_spans_at_op_dispatch_and_shapes():
    """RecordEvent spans, ops instrumented at dispatch (``record_shapes``
    attaches the operands' shapes, as the reference's), nothing recorded
    while disarmed."""
    paddle, a = _ops()
    assert profiler._armed is False and profiler.record_op("x") is None
    paddle.matmul(a, a)
    with profiler.Profiler() as prof:
        with profiler.RecordEvent("my_region"):
            paddle.add(paddle.matmul(a, a), a)
    names = [e.name for e in prof.events]
    assert {"my_region", "matmul", "add"} <= set(names)
    assert profiler._armed is False
    b = torch.ones(8, 2)
    with profiler.Profiler(record_shapes=True) as prof:
        paddle.matmul(torch.ones(4, 8), b)
    with jprofiler.Profiler(record_shapes=True) as jprof:
        pt.matmul(pt.to_tensor(np.ones((4, 8), np.float32)),
                  pt.to_tensor(np.ones((8, 2), np.float32)))
    ours = [e.args for e in prof.events if e.name == "matmul"]
    theirs = [e.args for e in jprof.events if e.name == "matmul"]
    assert ours == theirs == [{"input_shapes": [[4, 8], [8, 2]]}]


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, skip_first=1),
    dict(closed=1, ready=0, record=1, repeat=2, skip_first=2),
    dict(closed=0, ready=0, record=2)])
def test_scheduler_states_equal_the_reference(kw):
    ours, theirs = profiler.make_scheduler(**kw), \
        jprofiler.make_scheduler(**kw)
    assert [ours(i) for i in range(10)] == [theirs(i) for i in range(10)]
    for bad in (dict(record=0), dict(closed=-1)):
        with pytest.raises(ValueError):
            profiler.make_scheduler(**bad)


def test_timer_only_and_scheduled_recording():
    paddle, a = _ops()
    prof = profiler.Profiler(timer_only=True).start()
    assert profiler.record_op("x") is None
    paddle.matmul(a, a)
    prof.step()
    paddle.matmul(a, a)
    prof.step()
    prof.stop()
    assert prof.events == [] and prof.step_info()["steps"] == 3
    sched = profiler.make_scheduler(closed=1, ready=0, record=1)
    prof = profiler.Profiler(scheduler=sched).start()
    paddle.matmul(a, a)  # step 0: closed
    prof.step()
    paddle.matmul(a, a)  # step 1: record
    prof.stop()
    assert [e.name for e in prof.events].count("matmul") == 1


def test_chrome_export_structure_equals_the_reference(tmp_path, capsys):
    """The same spans (an op, a region, a tagged collective span) through
    both profilers export the same chrome events but for the times: the
    op and comm categories, the collectives lane, the cumulative-bytes
    counter; the callback writes a ``.trace.json``; ``summary`` counts
    calls; ``load_profiler_result`` round-trips."""
    paddle, a = _ops()
    with profiler.Profiler(on_trace_ready=profiler.export_chrome_tracing(
            str(tmp_path / "cb"))) as prof:
        paddle.matmul(a, a)
        with profiler.RecordEvent("region"):
            pass
        profiler._emit_event("comm::all_reduce", 100, 200, tid=1,
                             args={"bytes": 64, "axes": "dp"}, cat="comm")
    ja = pt.to_tensor(np.ones((4, 4), np.float32))
    with jprofiler.Profiler() as jprof:
        pt.matmul(ja, ja)
        with jprofiler.RecordEvent("region"):
            pass
        jprofiler._emit_event("comm::all_reduce", 100, 200, tid=1,
                              args={"bytes": 64, "axes": "dp"}, cat="comm")

    def shape(path):
        evs = profiler.load_profiler_result(path)["traceEvents"]
        return sorted((e["ph"], e["name"], e.get("cat"),
                       json.dumps(e.get("args"), sort_keys=True))
                      for e in evs)
    ours = shape(prof.export_chrome_tracing(str(tmp_path / "p"), "w0"))
    theirs = shape(jprof.export_chrome_tracing(str(tmp_path / "j"), "w0"))
    assert ours == theirs
    assert ("C", "comm_bytes", None, json.dumps({"bytes": 64})) in ours
    assert any(f.endswith(".trace.json")
               for f in os.listdir(tmp_path / "cb"))
    rows = dict(prof.summary())
    assert rows["matmul"][1] == 1 and "matmul" in capsys.readouterr().out


def test_device_targets_raise_where_they_cannot_capture():
    """``ProfilerTarget.TPU`` raises; a GPU capture that cannot start
    (no card here) raises, and leaves neither the profiler slot, the
    native ring nor the capture slot taken."""
    from paddle_tpu_torch.observability import profile
    with pytest.raises(ValueError, match="TPU"):
        profiler.Profiler(targets=[profiler.ProfilerTarget.TPU])
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                      profiler.ProfilerTarget.GPU])
    with pytest.raises(RuntimeError, match="CUDA"):
        prof.start()
    assert profiler._state["active"] is None and not profiler._armed
    assert profile.capture_active() is None
    with profiler.Profiler() as p2:  # the native ring is free again
        profiler.RecordEvent("again").__enter__().end()
    assert [e.name for e in p2.events] == ["again"]


def test_native_ring_builds_outside_the_references_build_dir():
    lib = profiler._NativeTracer.load()
    path = profiler._NativeTracer.library_path()
    assert os.path.exists(path) and hasattr(lib, "fr_start")
    assert os.path.dirname(path).endswith(os.path.join(
        "paddle_tpu_torch", "profiler", "_build"))


def test_spans_at_pylayer_to_static_and_train_step():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.autograd import PyLayer
    from paddle_tpu_torch.jit import TrainStep, to_static
    from paddle_tpu_torch.optimizer import SGD

    class Square(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return 2 * x * dy

    net = paddle.nn.Linear(4, 4, device="cpu")
    opt = SGD(learning_rate=0.1, parameters=net.parameters())
    step = TrainStep(net, lambda m, x: Square.apply(m(x)).mean(), opt)
    fn = to_static(net)
    with profiler.Profiler() as prof:
        step(torch.ones(2, 4))
        fn(torch.ones(2, 4))
    names = [e.name for e in prof.events]
    for want in ("TrainStep", "pylayer::Square", "grad::pylayer::Square"):
        assert want in names, names
    assert any(n.startswith("to_static:") for n in names)


# ------------------------------------------------------- flight recorder
def test_flight_recorder_rings_and_dump(tmp_path):
    """Both rings wrap keeping the last events; ops feed the recorder
    with no profiler; a dump holds the events, the rank from
    ``fleet.configure`` and the goodput appendix; disabling restores
    the hooks."""
    from paddle_tpu_torch.observability import profile
    paddle, a = _ops()
    for native in (False, True):
        rec = flight_recorder.enable(capacity=4, use_native=native)
        assert rec.native is native
        for i in range(10):
            rec.record(flight_recorder.KIND_COMM, f"e{i}", i, i + 1,
                       aux=i * 100)
        evs = rec.events()
        assert [e["name"] for e in evs] == ["e6", "e7", "e8", "e9"]
        assert evs[-1]["aux"] == 900 and evs[-1]["kind"] == "comm"
        flight_recorder.disable()
    hook_before = sys.excepthook
    rec = flight_recorder.enable(capacity=16)
    assert sys.excepthook is not hook_before and profiler._armed
    paddle.add(a, a)
    goodput.get_ledger().on_step({"step_time_s": 0.1})
    fleet.configure(rank=3, world_size=8)
    profile.set_trace_dir(str(tmp_path))
    try:
        try:
            raise ValueError("induced crash")
        except ValueError:
            sys.excepthook(*sys.exc_info())
    finally:
        fleet.configure(rank=0, world_size=1)
        profile.set_trace_dir(None)
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("flight_recorder_rank3_")]
    doc = json.load(open(tmp_path / dumps[0]))
    assert doc["rank"] == 3 and doc["world_size"] == 8
    assert doc["reason"] == "unhandled ValueError" and doc["native_ring"]
    assert any(e["name"] == "add" for e in doc["events"])
    assert doc["goodput"]["steps"] == 1
    flight_recorder.disable()
    assert sys.excepthook is hook_before and not profiler._armed


def test_signals_chain_with_the_preemption_listener(tmp_path):
    """SIGUSR1 with the recorder alone is a live snapshot; with a
    preemption listener installed after the recorder, the signal still
    dumps AND flags the listener; uninstalling leaves the recorder's."""
    from paddle_tpu_torch.observability import profile
    from paddle_tpu_torch.resilience import PreemptionListener
    profile.set_trace_dir(str(tmp_path))
    try:
        flight_recorder.enable(capacity=8, use_native=False)
        flight_recorder.record(flight_recorder.KIND_USER, "marker", 0, 1)
        lis = PreemptionListener(signals=(signal.SIGUSR1,),
                                 registry=MetricsRegistry()).install()
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0)
        assert lis.preempted and lis.reason == "SIGUSR1"
        lis.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is \
            flight_recorder._signal_handler
    finally:
        profile.set_trace_dir(None)
    doc = json.load(open(tmp_path / os.listdir(tmp_path)[0]))
    assert doc["reason"] == "SIGUSR1"
    assert [e["name"] for e in doc["events"]] == ["marker"]


def test_checkpoint_data_and_oom_events(tmp_path):
    """Checkpoint commits and restores, data-pipeline commits (the epoch
    in the name) and the OOM postmortem's tail."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.data import DataPipeline
    flight_recorder.enable(capacity=64, use_native=False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, {"w": torch.ones(2, 2)}, async_=False)
    mgr.restore(3, device="cpu")
    mgr.close()
    docs = [np.arange(1, 9, dtype=np.int32) for _ in range(8)]
    pipe = DataPipeline(docs, batch_size=2, seq_len=8, pack=True,
                        base_seed=1, shuffle=False, drop_last=True)
    n = sum(1 for _ in pipe)
    evs = flight_recorder.active().events()
    kinds = [(e["kind"], e["name"]) for e in evs]
    assert ("ckpt", "commit:step_3") in kinds
    assert ("ckpt", "restore:step_3") in kinds
    commit = next(e for e in evs if e["name"] == "commit:step_3")
    assert commit["aux"] == 3 and commit["args"]["bytes"] > 0
    data = [e for e in evs if e["kind"] == "data"]
    assert len(data) == n and data[-1]["name"] == \
        f"commit:step_{n}@epoch_{data[-1]['args']['epoch']}"
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried ...")
    path = memory.handle_oom(err, "train_step", out_dir=str(tmp_path))
    tail = json.load(open(path))["flight_recorder_tail"]
    assert tail and tail[-1]["name"] == data[-1]["name"]


# ---------------------------------------------------------------- comm
def test_exposure_accounting():
    """Inside a compute_scope a comm span counts overlapped, outside it
    exposed; a span half over compute splits; overlapping compute
    regions count once; StepTimer reports the exposed share; payload
    bytes of tensors."""
    t0 = comm.comm_totals()
    with comm.compute_scope():
        with comm.comm_scope("all_reduce", ["dp"], nbytes=64):
            time.sleep(0.01)
    with comm.comm_scope("all_gather", ["mp"], nbytes=32):
        time.sleep(0.01)
    t1 = comm.comm_totals()
    d = {k: t1[k] - t0[k] for k in t0}
    assert d["comm_calls_total"] == 2 and d["comm_bytes_total"] == 96
    assert d["comm_overlapped_seconds_total"] >= 0.009
    assert d["comm_exposed_seconds_total"] >= 0.009
    tr = comm._ComputeTracker()
    tr._closed.append((0, 50))
    tr._closed.append((10, 50))
    assert tr.overlap_ns(0, 100) == 50
    tr._closed.append((60, 70))
    assert tr.overlap_ns(0, 100) == 60
    timer = step_timer.StepTimer(registry=MetricsRegistry(), peak=0)
    timer.begin_step()
    with comm.comm_scope("all_reduce", ["dp"], nbytes=8):
        time.sleep(0.005)
    stats = timer.end_step(samples=1)
    assert stats["exposed_collective_time_s"] >= 0.004
    assert stats["comm_bytes"] == 8
    t = torch.zeros(3, 5)
    assert comm.payload_bytes(t) == 60 and comm.payload_bytes([t, t]) == 120
    assert comm.payload_bytes(torch.zeros(3, dtype=torch.bfloat16)) == 6
    assert comm.payload_bytes(None) == 0


# ---------------------------------------------------------------- goodput
class _Clock:
    """One injected clock for both packages: ``perf_counter`` and
    ``time`` read the same settable now."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def time(self):
        return self.now + 1.7e9


def _run_ledgers(scenario, monkeypatch):
    clock_j, clock_t = _Clock(), _Clock()
    monkeypatch.setattr(jgoodput, "time", types.SimpleNamespace(
        perf_counter=clock_j.perf_counter, time=clock_j.time))
    out = []
    for mod, clock, kw in ((jgoodput, clock_j, {}),
                           (goodput, clock_t, dict(
                               clock=clock_t.perf_counter,
                               wall_clock=clock_t.time))):
        mod._drain_pending_compile()
        led = mod.GoodputLedger(
            registry=(jgoodput_registry() if mod is jgoodput
                      else MetricsRegistry()),
            down_at=(clock.time() - 2.0 if scenario == "restart"
                     else None), **kw)
        clock.now += 1.0
        if scenario == "steps":
            mod.record_compile(0.03)
            led.on_step({"step_time_s": 0.2, "data_time_s": 0.05,
                         "exposed_collective_time_s": 0.02})
        elif scenario == "capped":
            led.on_step({"step_time_s": 0.1, "data_time_s": 0.4})
        elif scenario == "rollback":
            for _ in range(3):
                led.on_step({"step_time_s": 0.2})
            assert led.discard_recent_steps(2) == pytest.approx(0.4)
        snap = led.snapshot()
        out.append({k: v for k, v in snap.items()
                    if k not in ("pid", "start_unix")})
    return out


def jgoodput_registry():
    from paddle_tpu.observability.metrics import MetricsRegistry as JReg
    return JReg()


@pytest.mark.parametrize("scenario", ["steps", "capped", "rollback",
                                      "restart"])
def test_goodput_bins_equal_the_reference_under_one_clock(scenario,
                                                          monkeypatch):
    theirs, ours = _run_ledgers(scenario, monkeypatch)
    assert ours == theirs
    assert set(ours["bins"]) == set(goodput.BINS)
    assert sum(ours["bins"].values()) == pytest.approx(ours["wall_s"],
                                                       rel=1e-4)


def test_goodput_snapshot_file_and_compile_stamps(tmp_path):
    goodput.configure(snapshot_dir=str(tmp_path))
    try:
        led = goodput.GoodputLedger(registry=MetricsRegistry())
        before = goodput.stamped_compile_seconds()
        goodput.record_compile(0.5)
        led.on_step({"step_time_s": 1.0})
    finally:
        goodput.configure(snapshot_dir=None)
    assert goodput.stamped_compile_seconds() - before == pytest.approx(0.5)
    doc = json.loads((tmp_path / f"goodput_rank0_{os.getpid()}.json")
                     .read_text())
    assert doc["steps"] == 1 and doc["bins"]["compile"] == 0.5
    assert not list(tmp_path.glob("*.tmp"))


def test_a_train_steps_first_step_lands_in_the_compile_bin():
    """The first call of a TrainStep stamps its wall into the compile
    bin (less what was stamped inside it); the second stamps nothing."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD
    net = paddle.nn.Linear(4, 4, device="cpu")
    step = TrainStep(net, lambda m, x: m(x).mean(),
                     SGD(learning_rate=0.1, parameters=net.parameters()))
    s0 = goodput.stamped_compile_seconds()
    step(torch.ones(2, 4))
    s1 = goodput.stamped_compile_seconds()
    step(torch.ones(2, 4))
    assert s1 > s0 and goodput.stamped_compile_seconds() == s1


# ---------------------------------------------------------------- step timer
def test_step_timer_stats_equal_the_reference_under_one_clock(monkeypatch):
    """The same step sequence under one injected clock: the stats dicts
    (split, rates, MFU, goodput shares) are equal, and the registry holds
    the step."""
    stats = []
    for mod, gmod in ((jstep_timer, jgoodput), (step_timer, goodput)):
        clock = _Clock()
        fake = types.SimpleNamespace(perf_counter=clock.perf_counter,
                                     time=clock.time)
        monkeypatch.setattr(mod, "time", fake)
        gmod.reset_ledger()
        if gmod is jgoodput:
            monkeypatch.setattr(jgoodput, "time", fake)
        else:
            goodput._ledger = goodput.GoodputLedger(
                clock=clock.perf_counter, wall_clock=clock.time)
        reg = jgoodput_registry() if mod is jstep_timer \
            else MetricsRegistry()
        timer = mod.StepTimer(registry=reg, flops_per_sample=1e6,
                              tokens_per_sample=128, peak=1e9)
        rows = []
        for data in (0.25, 0.0, 0.1):
            clock.now += 0.5
            timer.begin_step(data_time=data)
            clock.now += 0.75
            rows.append(timer.end_step(samples=10))
        stats.append((rows, reg))
    (theirs, _), (ours, reg) = stats
    assert ours == theirs
    assert ours[0]["mfu"] == pytest.approx(10 * 1e6 / 1.0 / 1e9)
    assert reg.counter("train_steps_total").value() == 3
    assert reg.get("train_step_seconds").stats()["count"] == 3


def test_peak_flops_by_card(monkeypatch):
    assert step_timer.peak_flops("cpu") == 0.0
    cuda = torch.device("cuda")
    for name, want in (("NVIDIA H100 80GB HBM3", 989.4e12),
                       ("NVIDIA H100 PCIe", 756.5e12),
                       ("NVIDIA H100 NVL", 835.5e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, n=name: n)
        assert step_timer.peak_flops(cuda) == want
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="peak="):
        step_timer.peak_flops(cuda)


# -------------------------------------------------------- hapi callbacks
def _mlp_pair():
    """The same MLP in both packages (the port's bridged), each under
    SGD and an MSE loss, and four seeded batches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import SGD
    pt.seed(0)
    jnet = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                            pt.nn.Linear(16, 1))
    jmodel = pt.hapi.Model(jnet)
    jmodel.prepare(pt.optimizer.SGD(learning_rate=0.01,
                                    parameters=jmodel.parameters()),
                   pt.nn.MSELoss())
    tnet = paddle.nn.Sequential(paddle.nn.Linear(8, 16, device="cpu"),
                                paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 1, device="cpu"))
    load_numpy_state(tnet, state_dict_from_jax(jnet))
    tmodel = Model(tnet).prepare(
        SGD(learning_rate=0.01, parameters=tnet.parameters()),
        paddle.nn.MSELoss())
    rng = np.random.RandomState(0)
    data = [(rng.randn(4, 8).astype(np.float32),
             rng.randn(4, 1).astype(np.float32)) for _ in range(4)]
    return jmodel, tmodel, data


def _records(d):
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        return [json.loads(line) for line in f]


def test_visualdl_records_equal_the_reference(tmp_path):
    from paddle_tpu_torch.hapi import VisualDL
    jmodel, tmodel, data = _mlp_pair()
    jmodel.fit(data, epochs=2, verbose=0, shuffle=False,
               callbacks=[pt.callbacks.VisualDL(str(tmp_path / "j"))])
    tmodel.fit(data, epochs=2, verbose=0, shuffle=False,
               callbacks=[VisualDL(str(tmp_path / "t"))])
    theirs, ours = _records(tmp_path / "j"), _records(tmp_path / "t")
    assert len(ours) == 8
    assert [(r["step"], r["epoch"], r["tag"]) for r in ours] == \
        [(r["step"], r["epoch"], r["tag"]) for r in theirs]
    np.testing.assert_allclose([r["value"] for r in ours],
                               [r["value"] for r in theirs], rtol=1e-5)


def test_step_telemetry_through_fit():
    """StepTelemetry on a CPU fit: a scrape with the step families, the
    stats in the logs VisualDL and other callbacks see, MFU from the
    network's flops hint, ``train_mfu_ratio`` equal to flops / step /
    peak, and the goodput fraction."""
    from paddle_tpu_torch.hapi import Callback, StepTelemetry
    _, tmodel, data = _mlp_pair()
    seen = []

    class Capture(Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(dict(logs))

    tmodel.network.flops_per_sample = 500.0
    reg = MetricsRegistry()
    tel = StepTelemetry(registry=reg, peak=1e12)
    exp = MetricsExporter(0, reg)
    try:
        tmodel.fit(data, epochs=1, verbose=0, callbacks=[tel, Capture()])
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/metrics", timeout=30
        ).read().decode()
    finally:
        exp.stop()
    assert "train_step_seconds" in text and "train_steps_total 4.0" in text
    st = tel.last_stats
    assert st["step_time_s"] >= st["data_time_s"]
    assert reg.get("train_mfu_ratio").value() == pytest.approx(
        4 * 500.0 / st["step_time_s"] / 1e12)
    assert len(seen) == 4 and all(
        {"loss", "step_time_s", "samples_per_sec", "mfu",
         "goodput_fraction"} <= set(r) for r in seen)
    assert 0.0 < seen[-1]["goodput_fraction"] <= 1.0


def test_fleetz_is_the_references_single_process_document():
    """``fleetz_snapshot`` carries the reference's keys; its
    ``local_goodput`` is None before a step and the ledger after."""
    assert fleet.fleetz_snapshot()["local_goodput"] is None
    jfleet.disable()
    assert set(fleet.fleetz_snapshot()) == set(jfleet.fleetz_snapshot())
    goodput.get_ledger().on_step({"step_time_s": 0.1})
    doc = fleet.fleetz_snapshot()
    assert doc["aggregator"] is False and doc["world"] == 1
    assert doc["local_goodput"]["steps"] == 1
    assert fleet.recent_heartbeats() == []


# ---------------------------------------------------------------- attribution
ATTR_CFG = dict(vocab_size=2048, hidden_size=64, intermediate_size=128,
                num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64,
                tie_word_embeddings=True)


@pytest.fixture(scope="module")
def attribution_pair():
    """The reference's attribution report and the port's, on the same
    weights and batch (the reference test's geometry)."""
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu.observability.attribution import \
        attribute_train_step as jattribute
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability.attribution import \
        attribute_train_step
    from paddle_tpu_torch.optimizer import AdamW
    pt.seed(0)
    jm = JLlama(JCfg(**ATTR_CFG))
    x = np.random.RandomState(0).randint(0, 2048, (2, 32)).astype(np.int64)
    jrep = jattribute(jm, pt.optimizer.AdamW(learning_rate=1e-4,
                                             parameters=jm.parameters()),
                      x, steps=1, warmup=1, reps=1, data_time_s=0.003)
    tm = LlamaForCausalLM(LlamaConfig(**ATTR_CFG), device="cpu")
    load_numpy_state(tm, state_dict_from_jax(jm))
    opt = AdamW(learning_rate=1e-4, parameters=tm.parameters())
    reg = MetricsRegistry()
    rep = attribute_train_step(tm, opt, x, steps=1, warmup=1, reps=1,
                               data_time_s=0.003, registry=reg)
    return jrep, rep, reg


def test_attribution_table_against_the_reference(attribution_pair):
    """The same phases; they sum to the measured step (the reference's
    5%, by construction); the data phase passes through; the loss head's
    flops are exactly 6*T*d*V in the port (the reference's XLA count is
    held to it at the reference test's rel 0.5) and the total is the
    port's layers + head; the table, JSON and gauges."""
    jrep, rep, reg = attribution_pair
    assert set(rep.phases) == set(jrep.phases)
    assert rep.check(0.05) and rep.phases["data"]["seconds"] == 0.003
    head = 6 * 2 * 32 * 64 * 2048
    assert rep.phases["loss_head"]["flops"] == head
    assert jrep.phases["loss_head"]["flops"] == pytest.approx(head, rel=0.5)
    assert rep.total_flops == rep.phases["embedding_layers"]["flops"] + head
    emb = rep.phases["embedding_layers"]
    assert emb["forward_seconds"] > 0 and emb["backward_seconds"] >= 0
    assert "loss_head" in rep.table() and "step(measured)" in rep.table()
    doc = rep.to_json()
    json.dumps(doc)
    assert set(doc) == set(jrep.to_json())
    assert reg.get("attribution_phase_seconds").value(
        phase="loss_head") == rep.phases["loss_head"]["seconds"]
    assert reg.get("attribution_step_seconds").value() > 0


def test_attention_flops_counted_by_the_bench_formula():
    """The training flop count of a tiny Llama (K1 reached through the
    registered op ``paddle_tpu::flash_fwd``, whose formula this counts)
    equals ``bench.py``'s analytic count, attention at its causal half;
    without the registered formula it would drop attention."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability.attribution import \
        count_train_flops
    cfg = LlamaConfig.tiny()
    m = LlamaForCausalLM(cfg, device="cpu", seed=1)
    B, S = 2, 16
    x = torch.randint(0, cfg.vocab_size, (B, S))
    d, ffn, V, L = (cfg.hidden_size, cfg.intermediate_size,
                    cfg.vocab_size, cfg.num_hidden_layers)
    d_kv = cfg.num_key_value_heads * (d // cfg.num_attention_heads)
    per_tok = L * (4 * d * d + 4 * d * d_kv + 6 * d * ffn) + 2 * d * V
    attn = L * 2 * B * S * S * d
    assert count_train_flops(lambda: m(x, labels=x)[1]) == \
        3 * (B * S * per_tok + attn)


@pytest.mark.parametrize("fused", [True, False])
def test_attribution_leaves_model_optimizer_and_flats_as_found(fused):
    """After a fused TrainStep planned its flat buckets, an attribution
    (its own step fused or looped) leaves every parameter, every
    optimizer state entry (the same tensors: views of the same flats),
    the step count and the random state bit-identical, and the next
    step of the first TrainStep equals a twin's that never saw it."""
    from paddle_tpu_torch.core import generator
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.observability.attribution import \
        attribute_train_step
    from paddle_tpu_torch.optimizer import AdamW
    x = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                      .manual_seed(0))
    runs = []
    for attribute in (True, False):
        m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=2)
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(m, lambda mm, t: mm(t, labels=t)[1], opt)
        step(x)
        if attribute:
            flats = step._plan[2]
            params = {n: p.detach().clone() for n, p in m.named_parameters()}
            state = {k: (d, dict(d), {kk: v.clone() for kk, v in d.items()})
                     for k, d in opt._state.items()}
            rng, count = generator.get_rng_state(), opt._step_count
            attribute_train_step(m, opt, x, steps=1, warmup=1, reps=1,
                                 peak=1e12, fused=fused,
                                 registry=MetricsRegistry())
            for n, p in m.named_parameters():
                assert torch.equal(p, params[n]), n
            assert set(opt._state) == set(state)
            for k, (d, entries, values) in state.items():
                assert opt._state[k] is d
                for kk, v in d.items():
                    assert v is entries[kk] and torch.equal(v, values[kk])
            assert opt._step_count == count
            assert generator.get_rng_state()[1].keys() == rng[1].keys()
            assert all(torch.equal(a, rng[1][k])
                       for k, a in generator.get_rng_state()[1].items())
            assert step._fused_plan(list(step._params))[1] is flats
        runs.append((float(step(x)), {n: p.detach().clone()
                                      for n, p in m.named_parameters()}))
    (la, pa), (lb, pb) = runs
    assert la == lb and all(torch.equal(pa[n], pb[n]) for n in pa)
