"""A launched port job's lifecycle on the CPU, held against the JAX
package: ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2 --max_restarts 1`` runs ``tests/torch_launch_worker.py``
(the tiny Llama at dp 2 over gloo, ``Model.fit`` under
``FitResilience``, a synchronous save every step). The chaos harness
SIGKILLs rank 1 after step 2; the launcher relaunches, and the job
resumes from step 2. SIGUSR1 reaches rank 0 as step 4 begins; both ranks
stop at the consensus step with one commit and exit 79; the launcher
relaunches without spending its crash budget, and the job finishes step
6. The losses of every step equal the JAX package's GSPMD dp step on the
same global batches (``test_llama_dp2_matches_the_reference``'s oracle),
and each relaunched rank restored exactly the committed step."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.checkpoint as jckpt
import torch_dist_worker as W
from paddle_tpu_torch.checkpoint import CheckpointManager
from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_distributed import jax_llama_losses, jax_mesh
from torch_launch_worker import state_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
TOL = dict(rtol=1e-4, atol=1e-5)


def launch_worker(out, mode, *opts, nproc=2, max_restarts=1, timeout=240):
    """Run the worker under the port's launcher; (exit code, per-attempt
    records {(rank, epoch): record})."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(nproc), "--max_restarts",
         str(max_restarts), os.path.join(REPO, "tests",
                                         "torch_launch_worker.py"),
         mode, str(out), *opts],
        env=env, capture_output=True, text=True, timeout=timeout)
    recs = {}
    for name in os.listdir(out):
        if name.startswith("rank") and name.endswith(".json"):
            rec = json.loads((out / name).read_text())
            recs[(rec["rank"], int(rec["epoch"]))] = rec
    return r, recs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("lifecycle")
    r, recs = launch_worker(out, "lifecycle", f"steps={STEPS}",
                            "kill_rank=1", "kill_step=2", "preempt_rank=0",
                            "preempt_step=4")
    assert r.returncode == 0, r.stderr[-4000:]
    return out, recs


@pytest.fixture(scope="module")
def reference_losses():
    batches = W.llama_batches(W.TINY["vocab_size"], n=STEPS)
    losses, _ = jax_llama_losses(W.TINY, batches, mesh=jax_mesh({"dp": 2}),
                                 bucketed=False)
    return losses


def test_a_killed_rank_relaunches_and_resumes_to_the_references_losses(
        job, reference_losses):
    out, recs = job
    # attempt 0 died after step 2's commit; 1 resumed from it
    assert sorted(recs) == [(r, e) for r in (0, 1) for e in range(3)]
    for r in (0, 1):
        assert sorted(recs[(r, 0)]["losses"]) == ["1", "2"]
        assert recs[(r, 1)]["restored"] == 2
    for r in (0, 1):
        merged = {}
        for e in range(3):
            merged.update({int(k): v for k, v in
                           recs[(r, e)]["losses"].items()})
        assert sorted(merged) == list(range(1, STEPS + 1))
        np.testing.assert_allclose([merged[s] for s in sorted(merged)],
                                   reference_losses, **TOL)


def test_relaunched_ranks_restore_the_committed_step(job):
    """Each relaunched rank's restored state (read and applied) digests
    to the committed step's, recomputed here from the files."""
    out, recs = job
    mgr = CheckpointManager(str(out / "ckpt"))
    assert mgr.all_steps()[-1] == STEPS
    for (r, e), rec in recs.items():
        if e == 0:
            assert rec["restored"] is None
            continue
        want = state_digest(mgr.restore(rec["restored"], device="cpu"))
        assert rec["digest"] == rec["live_digest"] == want, (r, e)


def test_relaunches_bin_their_gap_as_restart(job):
    """The launcher stamps each relaunch with the previous attempt's end
    (``PADDLE_TPU_GOODPUT_DOWN_AT``); the ledger, which takes it from the
    launched job, charges the gap to ``restart``, and nothing to
    ``reshard``."""
    _, recs = job
    for (r, e), rec in recs.items():
        bins = rec["goodput"]
        assert bins["reshard"] == 0
        assert (bins["restart"] > 0) == (e > 0), (r, e, bins)


def test_sigusr1_on_one_rank_commits_once_on_both_and_exits_79(job):
    """Rank 0 took the signal; both ranks stopped at the same consensus
    step (one past rank 0's), which rank 0 committed once with the
    preemption's metadata, and both resumed from it."""
    out, recs = job
    stop = [max(int(k) for k in recs[(r, 1)]["losses"]) for r in (0, 1)]
    assert stop[0] == stop[1] == 5
    assert recs[(0, 1)]["ended"] == recs[(1, 1)]["ended"] == "preempted"
    assert recs[(0, 2)]["restored"] == recs[(1, 2)]["restored"] == 5
    meta = CheckpointManager(str(out / "ckpt")).metadata(5)
    assert meta == {"global_step": 5, "preempted": True,
                    "reason": "SIGUSR1"}
    # a step the two ranks wrote restores in the JAX package as well
    jstate = jckpt.CheckpointManager(str(out / "ckpt")).restore(5)
    pstate = CheckpointManager(str(out / "ckpt")).restore(5, device="cpu")
    for k, v in pstate["model"].items():
        np.testing.assert_array_equal(np.asarray(jstate["model"][k]),
                                      v.numpy())
