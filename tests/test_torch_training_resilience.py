"""The port's training resilience and numerics against ``paddle_tpu``'s:
the hang watchdog (log, dump and kill), the chaos harness's seams and a
killed fit resumed to the uninterrupted losses, ``TrainStep``'s sampled
twin step and the NaN-provenance replay (over the same bridged weights
and batch as the JAX package's, at ``tests/test_torch_numerics.py``'s
tolerances), the calibration sketches committed under ``"numerics"`` in
every save, the fit loop's profiler window and its one capture slot, and
the reference's environment knobs left unread."""
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.observability import numerics as jnum
from paddle_tpu_torch.data import DataPipeline
from paddle_tpu_torch.hapi import Callback
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import (flight_recorder, goodput,
                                            numerics, profile)
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import (RESUMABLE_EXIT_CODE, FitResilience,
                                         Watchdog, WatchdogExpired, chaos)

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import bridged, jax_tiny
from test_torch_hapi import PIPE, _docs
from test_torch_numerics import STAT_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_chaos_worker.py")
REF_VARS = ("PADDLE_TPU_NUMERICS", "PADDLE_TPU_NUMERICS_EVERY",
            "PADDLE_TPU_NUMERICS_PROVENANCE", "PADDLE_TPU_TRACE_DIR")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Numerics, chaos, the trace directory and the reference's numerics
    variables never leak between tests."""
    for k in REF_VARS:
        monkeypatch.delenv(k, raising=False)
    yield
    numerics.configure(armed=False, every=32, provenance=None)
    numerics._observatory = None
    jnum._observatory = None
    chaos.configure()
    profile.set_trace_dir(None)
    profile.set_fit_window()
    flight_recorder.disable()
    goodput.reset_ledger()


# ---------------------------------------------------------------- watchdog
def test_watchdog_log_dump_and_disarm(tmp_path):
    """``log`` warns and counts; a deadline disarmed in time never fires;
    ``dump`` names the span, the rank and the step, with the flight
    recorder's events."""
    reg = MetricsRegistry()
    wd = Watchdog(action="log", registry=reg)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tok = wd.arm("stuck_phase", 0.05, step=7)
        time.sleep(0.25)
        wd.disarm(tok)
        with wd.watch("fast", 5.0):
            pass
    wd.stop()
    assert [e["name"] for e in wd.expired] == ["stuck_phase"]
    assert reg.get("resilience_watchdog_expired_total").value(
        span="stuck_phase") == 1
    assert wd.last_dump is None
    assert any(issubclass(x.category, WatchdogExpired) for x in w)
    rec = flight_recorder.enable(capacity=16, use_native=False)
    rec.record(flight_recorder.KIND_STEP, "train_step", 0, 1)
    wd = Watchdog(action="dump", registry=MetricsRegistry(),
                  trace_dir=str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with wd.watch("train_step", 0.05, step=42):
            time.sleep(0.25)
    wd.stop()
    doc = json.load(open(wd.last_dump))
    assert doc["stuck_span"]["name"] == "train_step"
    assert doc["stuck_span"]["context"]["step"] == 42
    assert doc["rank"] == 0 and "pid" in doc
    assert [e["name"] for e in doc["events"]] == ["train_step"]


def test_collective_hang_trips_the_collective_deadline(tmp_path):
    """A chaos-hung collective span trips the collective deadline while
    it hangs; the dump names the span."""
    chaos.configure(hang_collective="barrier:0.4")
    from paddle_tpu_torch.observability import comm
    wd = Watchdog(action="dump", registry=MetricsRegistry(),
                  trace_dir=str(tmp_path)).watch_collectives(0.05)
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with comm.comm_scope("barrier", []):
            pass
    hung = time.monotonic() - t0
    time.sleep(0.1)
    wd.stop()
    assert comm._collective_watchdog is None
    assert hung >= 0.4
    assert wd.expired[0]["name"] == "collective:barrier@world"
    assert wd.expired[0]["elapsed_s"] < hung + 0.05
    doc = json.load(open(wd.last_dump))
    assert doc["stuck_span"]["name"] == "collective:barrier@world"


def test_fit_resilience_arms_the_step_deadline():
    """``FitResilience(step_timeout=)`` arms each step: a slow step
    expires with its global step in the context, the others do not."""
    from test_torch_hapi import port_fit_model
    tm, model, _ = port_fit_model(jax_tiny(37))

    class Slow(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if step == 2:
                time.sleep(2.6)

    # the first call of the flash op in a process takes ~2 s
    # (PyTorch's custom-op machinery): paid before the deadlines
    model.fit(DataPipeline(_docs(), **PIPE), num_iters=1, verbose=0)
    fr = FitResilience(step_timeout=2.0, watchdog_action="log",
                       preemption=False, registry=MetricsRegistry())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.fit(DataPipeline(_docs(), **PIPE), num_iters=3, verbose=0,
                  callbacks=[fr, Slow()])
    assert [(e["name"], e["context"]["step"]) for e in
            fr.watchdog.expired] == [("train_step", 2)]


def _worker(*args, timeout=240):
    return subprocess.run(
        [sys.executable, WORKER, *map(str, args)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO, os.path.join(REPO, "tests")])),
        capture_output=True, text=True, timeout=timeout)


def _losses(out):
    return {int(l.split()[1]): float(l.split()[2])
            for l in out.splitlines() if l.startswith("step ")}


def test_watchdog_kill_exits_resumable_with_a_dump(tmp_path):
    p = _worker("hang", tmp_path, "cpu")
    assert p.returncode == RESUMABLE_EXIT_CODE, p.stdout + p.stderr
    (name,) = [f for f in os.listdir(tmp_path / "trace")
               if f.startswith("watchdog_")]
    doc = json.load(open(tmp_path / "trace" / name))
    assert doc["action"] == "kill"
    assert doc["stuck_span"]["name"] == "train_step"
    assert doc["stuck_span"]["context"]["step"] == 2
    kinds = {e["kind"] for e in doc["events"]}
    assert {"data", "op"} <= kinds
    assert "TrainStep" in {e["name"] for e in doc["events"]}


def test_chaos_kill_and_resume_equals_the_uninterrupted_fit(tmp_path):
    """SIGKILL after fit step 3 (one save at step 2 committed), a
    relaunch resumes from the commit and continues to step 6: every
    step's loss equals the uninterrupted fit's at rtol 1e-5."""
    whole = _worker("run", tmp_path / "a", "cpu", 6)
    assert whole.returncode == 0, whole.stderr
    killed = _worker("run", tmp_path / "b", "cpu", 6, 3)
    assert killed.returncode == -9, killed.stderr
    resumed = _worker("run", tmp_path / "b", "cpu", 6, 3)
    assert resumed.returncode == 0, resumed.stderr
    want, a, b = _losses(whole.stdout), _losses(killed.stdout), \
        _losses(resumed.stdout)
    assert sorted(want) == list(range(1, 7)) and sorted(a) == [1, 2, 3]
    assert min(b) <= 4 and max(b) == 6
    got = {**a, **b}
    np.testing.assert_allclose([got[s] for s in range(1, 7)],
                               [want[s] for s in range(1, 7)], rtol=1e-5)
    assert os.listdir(tmp_path / "b" / "marks") == ["chaos_kill_step3"]


def test_chaos_seams():
    """Poison NaN-fills floating leaves only (numpy and torch); an all-int
    batch escalates to the loss, once; the mark directory fires an event
    once a job; with nothing configured the seams are the identity."""
    chaos.configure(poison_batch=[2])
    x, ids = np.ones((2, 3), np.float32), torch.ones(2, dtype=torch.int32)
    px, pids = chaos.poison_batch(2, (x, ids))
    assert np.isnan(px).all() and pids is ids
    assert torch.isnan(chaos.poison_batch(2, torch.ones(2))).all()
    assert not np.isnan(chaos.poison_batch(3, x)).any()
    batch = {"input_ids": np.ones((2, 4), np.int32)}
    out = chaos.poison_batch(2, batch)
    assert (out["input_ids"] == 1).all()
    assert math.isnan(chaos.corrupt_loss(2, 1.0))
    assert chaos.corrupt_loss(2, 1.0) == 1.0
    chaos.configure()
    assert not chaos.enabled() and chaos.corrupt_loss(5, 1.25) == 1.25


def test_chaos_mark_dir_fires_once(tmp_path):
    chaos.configure(corrupt_loss=[5], mark_dir=str(tmp_path))
    assert math.isnan(chaos.corrupt_loss(5, 1.0))
    assert chaos.corrupt_loss(5, 1.0) == 1.0


def test_a_poisoned_packed_batch_trips_the_guard_once(tmp_path):
    """The chaos harness in ``Model.fit``: a packed (all-int) batch
    poisoned at step 3 corrupts that step's loss, the NaN guard rolls
    back to step 2's commit once, and the goodput ledger moves one
    step's seconds to ``rollback_discarded``."""
    from test_torch_hapi import port_fit_model
    from paddle_tpu_torch.hapi import StepTelemetry
    tm, model, _ = port_fit_model(jax_tiny(38))
    chaos.configure(poison_batch=[3])
    fr = FitResilience(checkpoint_dir=str(tmp_path), save_every_steps=2,
                       nan_guard=True, preemption=False,
                       registry=MetricsRegistry())
    losses = []

    class Rec(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.fit(DataPipeline(_docs(), **PIPE), num_iters=4, verbose=0,
                  callbacks=[StepTelemetry(registry=MetricsRegistry(),
                                           peak=0), fr, Rec()])
    assert [math.isnan(v) for v in losses] == [False, False, True, False]
    assert fr.nan_guard.rollbacks == 1
    bins = goodput.snapshot()["bins"]
    assert bins["rollback_discarded"] > 0


# ---------------------------------------------------------------- numerics
def _lm_pair(seed):
    """The reference's TrainStep on a tiny Llama and the port's on its
    bridged twin (AdamW, clip 1.0), and one batch."""
    jm = jax_tiny(seed)
    jm.train()
    jstep = pt.jit.TrainStep(jm, lambda m, t: m(t, labels=t)[1],
                             pt.optimizer.AdamW(
                                 learning_rate=1e-3,
                                 parameters=jm.parameters(),
                                 grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
    tm = bridged(jm)
    tstep = TrainStep(tm, lambda m, t: m(t, labels=t)[1],
                      AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                            grad_clip=ClipGradByGlobalNorm(1.0)))
    ids = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int64)
    return jm, jstep, tm, tstep, ids


def _assert_same_sample(got, want):
    assert list(got["taps"]) == list(want["taps"])
    for part in ("taps", "grads", "updates"):
        assert list(got.get(part, {})) == list(want.get(part, {})), part
        for name, st in want.get(part, {}).items():
            np.testing.assert_allclose(got[part][name], st, err_msg=name,
                                       **STAT_TOL)
    for k in ("grad_norm", "loss"):
        np.testing.assert_allclose(got[k], want[k], **STAT_TOL)


def test_sampled_twin_step_equals_the_reference(monkeypatch):
    """Armed every step, the same weights and batch: the port's sample
    (taps in execution order, bucket gradient norms, update/parameter
    norms, global norm, loss) equals the reference's; the observatory's
    gauges and ``last_sample`` carry it."""
    jm, jstep, tm, tstep, ids = _lm_pair(5)
    monkeypatch.setenv("PADDLE_TPU_NUMERICS", "1")
    monkeypatch.setenv("PADDLE_TPU_NUMERICS_EVERY", "1")
    numerics.configure(armed=True, every=1)
    for _ in range(2):
        jstep(pt.to_tensor(ids))
        tstep(torch.from_numpy(ids))
    got, want = tstep.last_numerics, jstep.last_numerics
    _assert_same_sample(got, want)
    assert list(got["taps"])[0] == "embed" and len(got["taps"]) == 11
    last = numerics.last_sample()
    assert last["step"] == 2 and last["loss"] == got["loss"]
    obs = numerics.get_observatory()
    assert obs._m["absmax"].value(tap="embed") == got["taps"]["embed"][0]


def test_sampling_cadence_and_unsampled_steps_are_untouched(monkeypatch):
    """Step 1 and every ``every``-th are sampled; the trajectory of an
    armed run (sampled and unsampled steps), a disarmed run and a run
    whose taps are bare identities are bit-identical."""
    numerics.configure(armed=True, every=3)
    assert [i for i in range(1, 13) if numerics.sample_this_step(i)] == \
        [1, 3, 6, 9, 12]
    numerics.configure(every=-3)
    assert numerics.every() == 32
    numerics.configure(armed=False)
    assert not numerics.sample_this_step(1)

    def run(armed, identity=False):
        from contextlib import contextmanager
        from paddle_tpu_torch.models.llama import (LlamaConfig,
                                                   LlamaForCausalLM)
        numerics.configure(armed=armed, every=2)
        with monkeypatch.context() as mp:
            if identity:
                @contextmanager
                def null(*a, **k):
                    yield
                mp.setattr(numerics, "tap", lambda name, x: x)
                mp.setattr(numerics, "scope", null)
                mp.setattr(numerics, "suppress", null)
            m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=4)
            step = TrainStep(m, lambda mm, t: mm(t, labels=t)[1],
                             AdamW(learning_rate=1e-3,
                                   parameters=m.parameters(),
                                   grad_clip=ClipGradByGlobalNorm(1.0)))
            x = torch.from_numpy(np.random.RandomState(0).randint(
                0, 256, (2, 16)))
            losses = [float(step(x)) for _ in range(3)]
        return losses, [p.detach().clone() for p in m.parameters()], step
    la, pa, sa = run(True)
    lb, pb, _ = run(False)
    lc, pc, sc = run(False, identity=True)
    assert la == lb == lc
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(pa, pb, pc))
    assert sa.last_numerics is not None and sc.last_numerics is None


def _poison(w):
    with torch.no_grad():
        w[0, 0] = float("nan")


def test_provenance_names_the_first_nonfinite_tap_as_the_reference(
        tmp_path, monkeypatch):
    """After one step, layer 1's down_proj poisoned in both packages:
    the replay names ``layers.1.mlp`` as the reference's does, with the
    same taps finite upstream; the probe leaves weights, optimizer state
    and the random state untouched."""
    from paddle_tpu_torch.core import generator
    jm, jstep, tm, tstep, ids = _lm_pair(7)
    monkeypatch.setenv("PADDLE_TPU_NUMERICS_PROVENANCE", "1")
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path / "j"))
    numerics.configure(provenance=True)
    jstep(pt.to_tensor(ids))
    tstep(torch.from_numpy(ids))
    w = jm.model.layers[1].mlp.down_proj.weight
    arr = w.numpy().copy()
    arr[0, 0] = np.nan
    w.set_value(pt.to_tensor(arr))
    _poison(tm.model.layers[1].mlp.down_proj.weight)
    state0 = {k: v.clone() for k, v in tm.state_dict().items()}
    rng0 = generator.get_rng_state()
    jdoc = json.load(open(jnum.write_provenance(jstep, 1, "loss_nan")))
    path = numerics.write_provenance(tstep, 1, "loss_nan",
                                     out_dir=str(tmp_path / "t"))
    doc = json.load(open(path))
    assert os.path.basename(path).startswith("nan_provenance_rank0_")
    for k in ("schema", "verdict", "first_nonfinite", "trip_kind", "step"):
        assert doc[k] == jdoc[k], k
    assert doc["first_nonfinite"]["name"] == "layers.1.mlp"
    assert list(doc["replay"]["taps"]) == list(jdoc["replay"]["taps"])
    for name, t in jdoc["replay"]["taps"].items():
        assert doc["replay"]["taps"][name]["nonfinite"] == t["nonfinite"]
    for k, v in tm.state_dict().items():
        assert torch.equal(v, state0[k]) or (torch.isnan(v).any() and
                                             torch.equal(v.isnan(),
                                                         state0[k].isnan()))
    assert generator.get_rng_state()[0] == rng0[0]


def test_fit_provenance_and_calibration_checkpoint(tmp_path):
    """Armed every step with provenance: each save commits
    ``calibration_summary()`` under ``"numerics"`` (which
    ``calibration_from_checkpoint`` reads and ``restore`` merges back);
    a host-side loss corruption at step 3 rolls back and its provenance
    replays finite (``verdict: "finite_in_graph"``)."""
    from paddle_tpu_torch.checkpoint import load_state_dir
    from paddle_tpu_torch.quantization.weight_only import \
        calibration_from_checkpoint
    from test_torch_hapi import port_fit_model
    numerics.configure(armed=True, every=1)
    profile.set_trace_dir(str(tmp_path / "trace"))
    tm, model, _ = port_fit_model(jax_tiny(39))
    chaos.configure(corrupt_loss=[3])
    fr = FitResilience(checkpoint_dir=str(tmp_path / "ck"),
                       save_every_steps=2, nan_guard=True, preemption=False,
                       keep_last_k=None, registry=MetricsRegistry())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.fit(DataPipeline(_docs(), **PIPE), num_iters=4, verbose=0,
                  callbacks=[fr])
    assert fr.nan_guard.rollbacks == 1
    (name,) = [f for f in os.listdir(tmp_path / "trace")
               if f.startswith("nan_provenance_")]
    doc = json.load(open(tmp_path / "trace" / name))
    assert doc["verdict"] == "finite_in_graph"
    assert doc["first_nonfinite"] is None and doc["step"] == 3
    summary = numerics.get_observatory().calibration_summary()
    saved = load_state_dir(str(tmp_path / "ck"), step=4,
                           device="cpu")["numerics"]
    assert saved == summary and summary["taps"]["embed"]["n"] == 4
    assert calibration_from_checkpoint(str(tmp_path / "ck")) == summary
    numerics._observatory = None
    tm2, model2, _ = port_fit_model(jax_tiny(39))
    FitResilience(checkpoint_dir=str(tmp_path / "ck"),
                  preemption=False).restore(model2)
    assert numerics.get_observatory().calibration_summary() == summary


# -------------------------------------------------------- the fit window
class _Seams:
    """``observability.profile``'s start/stop seams, recorded."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(profile, "_start_trace",
                            lambda path: self.calls.append("start"))
        monkeypatch.setattr(profile, "_stop_trace",
                            lambda: self.calls.append("stop"))


def test_fit_window_opens_closes_and_shares_one_slot(tmp_path, monkeypatch):
    """``set_fit_window(2, 3)``: the capture opens entering step 2 and
    closes entering step 4; a fit that dies inside the window releases
    the slot in its ``finally``; while ``paddle.profiler``'s GPU capture
    holds the slot the window is skipped with a warning, and while the
    window holds it a GPU Profiler gets ``CaptureBusy``."""
    from paddle_tpu_torch import profiler
    from test_torch_hapi import port_fit_model
    seams = _Seams(monkeypatch)
    profile.set_trace_dir(str(tmp_path))
    tm, model, _ = port_fit_model(jax_tiny(40))
    seen = []

    class Where(Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append((step, profile.capture_active() is not None))

    profile.set_fit_window(2, 3)
    model.fit(DataPipeline(_docs(), **PIPE), num_iters=4, verbose=0,
              callbacks=[Where()])
    assert seen == [(1, False), (2, True), (3, True), (4, False)]
    assert seams.calls == ["start", "stop"]

    class Die(Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 2:
                with pytest.raises(profile.CaptureBusy):
                    profiler.Profiler(
                        targets=[profiler.ProfilerTarget.GPU]).start()
                raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        model.fit(DataPipeline(_docs(), **PIPE), num_iters=4, verbose=0,
                  callbacks=[Die()])
    assert profile.capture_active() is None
    assert seams.calls[-2:] == ["start", "stop"]
    with profiler.Profiler(targets=[profiler.ProfilerTarget.GPU]) as prof:
        with pytest.warns(RuntimeWarning, match="skipped"):
            model.fit(DataPipeline(_docs(), **PIPE), num_iters=2,
                      verbose=0)
    assert len(prof.device_trace_dirs) == 1
    assert seams.calls[-2:] == ["start", "stop"]


def test_the_reference_env_knobs_are_not_read(tmp_path, monkeypatch):
    """The reference reads the knobs below; the port reads none of them
    (``configure`` functions and arguments carry them): a fit under all
    of them samples no numerics, runs no chaos, opens no window and
    writes no goodput file, and importing arms no flight recorder."""
    knobs = {"PADDLE_TPU_PROFILE_AT_STEP": "1:2",
             "PADDLE_TPU_CHAOS_KILL_AT_STEP": "1",
             "PADDLE_TPU_CHAOS_HANG_COLLECTIVE": "barrier:60",
             "PADDLE_TPU_CHAOS_POISON_BATCH": "1",
             "PADDLE_TPU_CHAOS_CORRUPT_LOSS": "1,2",
             "PADDLE_TPU_CHAOS_MARK_DIR": str(tmp_path / "marks"),
             "PADDLE_TPU_NUMERICS": "1",
             "PADDLE_TPU_NUMERICS_EVERY": "1",
             "PADDLE_TPU_NUMERICS_PROVENANCE": "1",
             "PADDLE_TPU_GOODPUT_DIR": str(tmp_path / "goodput"),
             "PADDLE_TPU_GOODPUT_DOWN_AT": repr(time.time() - 100),
             "PADDLE_TPU_GOODPUT_RESIZE_AT": repr(time.time() - 100),
             "PADDLE_TPU_FLIGHT_RECORDER": "1",
             "PADDLE_TPU_TRACE_DIR": str(tmp_path / "trace"),
             "PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "8"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    import importlib
    import paddle_tpu_torch.observability as obs
    importlib.reload(obs)
    assert flight_recorder.active() is None
    assert not numerics.armed() and not numerics.provenance_enabled()
    assert not chaos.enabled() and profile.fit_window() is None
    assert not profile.trace_dir().startswith(str(tmp_path))
    from paddle_tpu_torch.hapi import StepTelemetry
    from test_torch_hapi import port_fit_model
    tm, model, _ = port_fit_model(jax_tiny(41))
    losses = []

    class Rec(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    model.fit(DataPipeline(_docs(), **PIPE), num_iters=2, verbose=0,
              callbacks=[StepTelemetry(registry=MetricsRegistry(), peak=0),
                         Rec()])
    assert all(math.isfinite(v) for v in losses) and len(losses) == 2
    assert model._train_step.last_numerics is None
    assert model._train_step._last_batch is None
    assert profile.capture_active() is None
    snap = goodput.snapshot()
    assert snap["bins"]["restart"] == 0 and snap["bins"]["reshard"] == 0
    for d in ("marks", "goodput", "trace"):
        assert not (tmp_path / d).exists()
    assert flight_recorder._rank_topology()["rank"] == 0
    assert flight_recorder._rank_topology()["world_size"] == 1
