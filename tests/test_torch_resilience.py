"""The port's ``FitResilience`` on a tiny Llama over the packed
pipeline: a fit stopped by a preemption at a step boundary and resumed
from its checkpoint by a fresh model, optimizer and pipeline equals the
uninterrupted fit (losses, parameters, AdamW moments and the batches in
order); a checkpoint written by the port's ``FitResilience`` and resumed
by the JAX package's, and the other way round, continues to the same
losses at rtol 1e-5; the NaN guard rolls a poisoned step back; and
SIGUSR1 gives one blocking final save and exit code 79."""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.data import DataPipeline as JPipe
from paddle_tpu.resilience import FitResilience as JFit
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.data import DataPipeline
from paddle_tpu_torch.hapi import Callback
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.resilience import RESUMABLE_EXIT_CODE, FitResilience

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_tiny
from test_torch_hapi import (PIPE, _docs, assert_same_training_state,
                             jax_fit_model, port_fit_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, CUT, SEED = 6, 3, 36


def _digest(batch):
    h = hashlib.sha256()
    for k in sorted(batch):
        v = batch[k]
        h.update(np.ascontiguousarray(
            v.numpy() if isinstance(v, torch.Tensor) else np.asarray(
                getattr(v, "data", v))).tobytes())
    return h.hexdigest()[:16]


def _recorder(base):
    class Rec(base):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    return Rec()


def _tracked(pipe, seen):
    class Tracked:
        def __iter__(self):
            for b in pipe:
                seen.append(_digest(b))
                yield b
    return Tracked()


def _stop_at(base, fr, at):
    class Stop(base):
        def on_train_batch_end(self, step, logs=None):
            if fr.global_step == at:
                fr.listener.request("test")
    return Stop()


def port_run(ckpt, steps, stop_at=None, jm=None):
    """A fresh port model (the bridged twin of ``jax_tiny(SEED)``),
    optimizer and pipeline; restores from ``ckpt`` when it holds a
    commit, then fits to ``steps`` global steps or until ``stop_at``."""
    jm = jm or jax_tiny(SEED)
    tm, model, opt = port_fit_model(jm)
    pipe = DataPipeline(_docs(), **PIPE)
    fr = FitResilience(checkpoint_dir=ckpt, save_every_steps=2,
                       keep_last_k=2, pipeline=pipe,
                       registry=MetricsRegistry())
    start = fr.restore(model) or 0
    rec, seen = _recorder(Callback), []
    # the stop request lands before fr polls its listener at that step
    cbs = [rec] + ([] if stop_at is None else
                   [_stop_at(Callback, fr, stop_at)]) + [fr]
    model.fit(_tracked(pipe, seen), epochs=3, verbose=0,
              num_iters=steps - start, callbacks=cbs)
    return dict(losses=rec.losses, seen=seen, fr=fr, net=tm, opt=opt,
                start=start)


def jax_run(ckpt, steps, stop_at=None):
    jm, model, opt = jax_fit_model(SEED)
    pipe = JPipe(_docs(), **PIPE)
    fr = JFit(checkpoint_dir=ckpt, save_every_steps=2, keep_last_k=2,
              pipeline=pipe)
    start = fr.restore(model) or 0
    rec, seen = _recorder(pt.callbacks.Callback), []
    # the stop request lands before fr polls its listener at that step
    cbs = [rec] + ([] if stop_at is None else
                   [_stop_at(pt.callbacks.Callback, fr, stop_at)]) + [fr]
    model.fit(_tracked(pipe, seen), epochs=3, verbose=0,
              num_iters=steps - start, callbacks=cbs)
    return dict(losses=rec.losses, seen=seen, fr=fr, net=jm, opt=opt,
                start=start)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return port_run(str(tmp_path_factory.mktemp("ref")), STEPS)


def test_interrupted_and_restored_fit_equals_the_uninterrupted(
        uninterrupted, tmp_path):
    ref = uninterrupted
    first = port_run(str(tmp_path), STEPS, stop_at=CUT)
    assert first["fr"].preempted and first["fr"].exit_code == 79
    assert first["fr"].final_step == CUT and len(first["losses"]) == CUT
    state = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert set(state) == {"model", "optimizer", "data"}
    assert state["data"]["step"] == CUT
    second = port_run(str(tmp_path), STEPS)
    assert second["start"] == CUT and not second["fr"].preempted
    assert first["seen"] + second["seen"] == ref["seen"]
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               ref["losses"], rtol=1e-5)
    for (n, a), b in zip(ref["net"].named_parameters(),
                         second["net"].parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    rs, ss = ref["opt"].state_dict(), second["opt"].state_dict()
    assert sorted(rs) == sorted(ss) and ss["@step_count"] == STEPS
    for k in rs:
        if k != "@step_count":
            np.testing.assert_allclose(ss[k].numpy(), rs[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_checkpoint_resumes_in_the_other_package(uninterrupted, tmp_path,
                                                   writer):
    """The first ``CUT`` steps in one package, preempted; the rest
    resumed by the other package's FitResilience from that checkpoint."""
    first_run, second_run = (port_run, jax_run) if writer == "port" \
        else (jax_run, port_run)
    first = first_run(str(tmp_path), STEPS, stop_at=CUT)
    second = second_run(str(tmp_path), STEPS)
    assert first["fr"].preempted and second["start"] == CUT
    assert first["seen"] + second["seen"] == uninterrupted["seen"]
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               uninterrupted["losses"], rtol=1e-5)
    if writer == "port":
        assert_same_training_state(second["net"], second["opt"],
                                   uninterrupted["net"],
                                   uninterrupted["opt"])


def test_the_nan_guard_rolls_back(tmp_path):
    reg = MetricsRegistry()
    tm, model, opt = port_fit_model(jax_tiny(SEED))
    pipe = DataPipeline(_docs(), **PIPE)
    mgr = CheckpointManager(str(tmp_path), async_=False, registry=reg)
    fr = FitResilience(manager=mgr, save_every_steps=1, nan_guard=True,
                       preemption=False, registry=reg)
    w = tm.model.layers[0].mlp.down_proj.weight

    class Poison(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if step == 3:
                with torch.no_grad():
                    w[0, 0] = float("nan")

    rec = _recorder(Callback)
    with pytest.warns(RuntimeWarning, match="rolled back to committed "
                                            "step 2"):
        model.fit(pipe, num_iters=5, verbose=0,
                  callbacks=[Poison(), rec, fr])
    assert [t["kind"] for t in fr.nan_guard.trips] == ["loss_nan"]
    assert np.isnan(rec.losses[2]) and np.isfinite(rec.losses[3:]).all()
    assert all(torch.isfinite(p).all() for p in tm.parameters())
    assert reg.get("resilience_rollbacks_total").total() == 1
    assert reg.get("resilience_nonfinite_total").value(kind="loss_nan") == 1


def test_sigusr1_gives_one_final_save_and_exit_79(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "tests", "torch_resilience_worker.py"), str(tmp_path), "3"],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == RESUMABLE_EXIT_CODE, r.stderr
    assert [ln.split()[1] for ln in r.stdout.splitlines()] == \
        ["1", "2", "3"]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3]  # save_every_steps=100: only the final
    assert mgr.metadata(3) == {"global_step": 3, "preempted": True,
                               "reason": "SIGUSR1"}
    assert mgr.restore(device="cpu")["data"]["step"] == 3


def test_unported_options_raise():
    """Every option is ported now: the watchdog's
    (tests/test_torch_training_resilience.py), ``elastic=`` and the store
    consensus (tests/test_torch_elastic.py, test_torch_job_lifecycle.py).
    What is left to raise: the store consensus asked for outside a job
    with a store, which raises at the first poll rather than stopping on
    this rank alone; and ``complete_resize`` without a resize boundary."""
    for kw in ({"step_timeout": 10.0}, {"collective_timeout": 1.0}):
        assert FitResilience(**kw).watchdog is None  # armed at fit begin
    fr = FitResilience(elastic=True)
    assert fr.elastic_listener is None and not fr.resized  # at fit begin
    with pytest.raises(RuntimeError, match="resize boundary"):
        fr.complete_resize()
    from paddle_tpu_torch.resilience import PreemptionListener
    lst = PreemptionListener(use_store=True)
    with pytest.raises(RuntimeError, match="no job store"):
        lst.should_stop(step=1)
    assert PreemptionListener().should_stop(step=1) is False
