"""The port's launcher (``paddle_tpu_torch.distributed.launch``) held
against the JAX package's (``paddle_tpu.distributed.launch``): the
children's environment, the crash budget, preemption resumes (79),
in-place and coordinated resizes (83), scale-in and scale-out, two
launchers on one store (also under an elastic range),
``ElasticManager``'s dead-rank detection and ``parse_np``. The trainers
are the stdlib script ``PROTO`` below: it imports neither torch nor jax,
dumps its ``PADDLE_*`` environment to ``RUN/e<epoch>.r<rank>.json`` and
acts as ``RUN/plan.json`` says."""
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu.resilience.elastic import \
    ElasticResizeListener as JaxListener
from paddle_tpu_torch.distributed import launch as L
from paddle_tpu_torch.distributed.tcp_store import TCPStore, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROTO = r'''
import json, os, sys, time
run = sys.argv[1]
env = {k: v for k, v in os.environ.items() if k.startswith("PADDLE")}
rank, epoch = env["PADDLE_TRAINER_ID"], env["PADDLE_RESTART_EPOCH"]
with open(os.path.join(run, f"e{epoch}.r{rank}.json"), "w") as f:
    json.dump(env, f)
plan = json.load(open(os.path.join(run, "plan.json")))
act = plan.get(f"{epoch}/{rank}", plan.get(epoch, plan.get("*", 0)))
act = act if isinstance(act, dict) else {"exit": act}
if "barrier" in act:  # every rank of the epoch has started
    world = int(env["PADDLE_TRAINERS_NUM"])
    open(os.path.join(run, f"reg.{epoch}.{rank}"), "w").close()
    deadline = time.time() + 60
    while not all(os.path.exists(os.path.join(run, f"reg.{epoch}.{r}"))
                  for r in range(world)):
        assert time.time() < deadline, "barrier timed out"
        time.sleep(0.02)
if "wait" in act:
    while not os.path.exists(os.path.join(run, act["wait"])):
        time.sleep(0.02)
time.sleep(act.get("sleep", 0))
sys.exit(act.get("exit", 0))
'''


@pytest.fixture
def run(tmp_path):
    (tmp_path / "proto.py").write_text(PROTO)
    return tmp_path


def plan(run, **acts):
    """``acts``: ``e<epoch>``, ``e<epoch>_r<rank>`` or ``any`` -> an exit
    code or an action dict."""
    keys = {}
    for k, v in acts.items():
        if k == "any":
            keys["*"] = v
        else:
            keys[k[1:].replace("_r", "/")] = v
    (run / "plan.json").write_text(json.dumps(keys))


def dumps(run):
    """{(epoch, rank): env} of every trainer that started."""
    out = {}
    for name in os.listdir(run):
        if name.startswith("e") and name.endswith(".json"):
            e, r = name[1:-5].split(".r")
            out[(int(e), int(r))] = json.loads((run / name).read_text())
    return out


def port_launch(run, **kw):
    return L.launch(str(run / "proto.py"), [str(run)], **kw)


def in_thread(fn):
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("rc", fn()))
    t.start()
    return t, res


def wait_for(pred, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_child_environment_equals_the_references(tmp_path):
    """Both launchers, from the command line, on one plan: rank 1 crashes
    in epoch 0 and the relaunch finishes. Every trainer's PADDLE_*
    environment is the reference's, variable for variable, but for the
    store's address and the goodput stamp's time."""
    got = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        run = tmp_path / pkg
        run.mkdir()
        (run / "proto.py").write_text(PROTO)
        plan(run, e0_r1=3)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.distributed.launch",
             "--nproc_per_node", "2", "--max_restarts", "1",
             str(run / "proto.py"), str(run)],
            env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        got[pkg] = dumps(run)
    ref, port = got["paddle_tpu"], got["paddle_tpu_torch"]
    assert sorted(ref) == sorted(port) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    varies = {"PADDLE_MASTER", "PADDLE_STORE_PORT",
              "PADDLE_TPU_GOODPUT_DOWN_AT"}
    for key in ref:
        assert set(ref[key]) == set(port[key]), key
        for var in set(ref[key]) - varies:
            assert ref[key][var] == port[key][var], (key, var)
        assert port[key]["PADDLE_MASTER"] == \
            f"127.0.0.1:{port[key]['PADDLE_STORE_PORT']}"
    for key in ((1, 0), (1, 1)):
        down = float(port[key]["PADDLE_TPU_GOODPUT_DOWN_AT"])
        assert 0 < time.time() - down < 120
    assert "PADDLE_TPU_GOODPUT_DOWN_AT" not in port[(0, 0)]


@pytest.mark.parametrize("max_restarts", [0, 1])
def test_max_restarts(run, max_restarts):
    """A trainer that always crashes: 1 + max_restarts attempts, then the
    launcher exits with the trainer's code."""
    plan(run, any=3)
    assert port_launch(run, nproc_per_node=2,
                       max_restarts=max_restarts) == 3
    assert sorted({e for e, _ in dumps(run)}) == list(
        range(max_restarts + 1))


def test_preemption_relaunches_without_the_crash_budget(run):
    """Exit 79 relaunches without spending max_restarts: a resume, then a
    crash (the one restart), then a clean finish."""
    plan(run, e0=79, e1_r1=3)
    assert port_launch(run, nproc_per_node=2, max_restarts=1) == 0
    assert sorted({e for e, _ in dumps(run)}) == [0, 1, 2]


def test_max_resumes_exhausted_exits_79(run):
    plan(run, any=79)
    assert port_launch(run, nproc_per_node=2, max_resumes=1) == 79
    assert sorted({e for e, _ in dumps(run)}) == [0, 1]


def test_the_tuning_knobs_are_not_read(run, monkeypatch):
    """Divergence: PADDLE_TPU_MAX_RESUMES and PADDLE_TPU_MAX_RESIZES are
    the arguments max_resumes and max_resizes (default 8, the reference's
    default); a budget of 0 in the environment changes nothing."""
    monkeypatch.setenv("PADDLE_TPU_MAX_RESUMES", "0")
    monkeypatch.setenv("PADDLE_TPU_MAX_RESIZES", "0")
    plan(run, e0=79)
    assert port_launch(run, nproc_per_node=2) == 0
    assert jlaunch._max_resumes(None) == 0  # the reference reads it


def test_in_place_resize(run):
    """Rank 1 departs (83) while rank 0 runs on: the launcher retires the
    lane and the job ends with rank 0, in one epoch."""
    plan(run, e0_r1=83, e0_r0={"sleep": 1.0})
    assert port_launch(run, nproc_per_node=2, max_restarts=0) == 0
    assert sorted(dumps(run)) == [(0, 0), (0, 1)]


def _reference_verdict(store, new_world):
    """The reference's listener publishes the resize verdict for epoch 0
    (its ``PADDLE_RESTART_EPOCH``, unset here) on ``store``."""
    lst = JaxListener(store=store)
    lst.request(new_world, "test")
    assert lst.should_resize(step=None)


def test_coordinated_resize(run):
    """Every rank exits 83 after the reference's listener published a
    resize to world 1: the launcher relaunches one rank under a new
    epoch, with the goodput stamp of a resize."""
    plan(run, e0={"wait": "go", "exit": 83})
    t, res = in_thread(lambda: port_launch(run, nproc_per_node=2))
    wait_for(lambda: len(dumps(run)) == 2, "epoch 0")
    port = int(dumps(run)[(0, 0)]["PADDLE_STORE_PORT"])
    _reference_verdict(TCPStore("127.0.0.1", port), 1)
    (run / "go").touch()
    t.join(60)
    assert not t.is_alive() and res["rc"] == 0
    got = dumps(run)
    assert sorted(got) == [(0, 0), (0, 1), (1, 0)]
    assert got[(1, 0)]["PADDLE_TRAINERS_NUM"] == "1"
    assert "PADDLE_TPU_GOODPUT_RESIZE_AT" in got[(1, 0)]
    assert "PADDLE_TPU_GOODPUT_DOWN_AT" not in got[(1, 0)]


class MemStore:
    def __init__(self):
        self.d = {}

    def set(self, key, value):
        self.d[key] = value if isinstance(value, bytes) else \
            str(value).encode()

    def get(self, key):
        return self.d.get(key)

    def add(self, key, n):
        cur = int(self.d.get(key, b"0")) + int(n)
        self.d[key] = str(cur).encode()
        return cur


@pytest.mark.parametrize("gen", [0, 1])
def test_resize_target_world_reads_the_references_keys(gen):
    """``_resize_target_world`` finds the agreed world in keys the
    reference's listener wrote, in the current generation or (after the
    survivors bumped it) the one before; both launchers read the same."""
    store = MemStore()
    assert L._resize_target_world(store, 0) is None
    _reference_verdict(store, 3)
    if gen:
        store.set("__elastic/0/gen", b"1")
    assert L._resize_target_world(store, 0) == \
        jlaunch._resize_target_world(store, 0) == 3
    assert L._resize_target_world(store, 1) is None


def test_np_range_scales_in_and_out(run):
    """``np_range=(1, 2)``: a crashed rank scales the job in to the
    survivor (no crash budget spent), and a bump of ``__scale_out`` scales
    it back out to 2; each change is a new epoch with re-ranked trainers."""
    plan(run, e0_r1=3, any={"wait": "finish"})
    t, res = in_thread(lambda: port_launch(run, np_range=(1, 2),
                                           max_restarts=0))
    wait_for(lambda: (1, 0) in dumps(run), "the scale-in")
    got = dumps(run)
    assert got[(1, 0)]["PADDLE_TRAINERS_NUM"] == "1"
    assert "PADDLE_TPU_GOODPUT_RESIZE_AT" in got[(1, 0)]
    port = int(got[(0, 0)]["PADDLE_STORE_PORT"])
    TCPStore("127.0.0.1", port).add("__scale_out", 1)
    wait_for(lambda: {(2, 0), (2, 1)} <= set(dumps(run)), "the scale-out")
    assert dumps(run)[(2, 1)]["PADDLE_TRAINERS_NUM"] == "2"
    (run / "finish").touch()
    t.join(60)
    assert not t.is_alive() and res["rc"] == 0


def test_two_launchers_share_one_store(run):
    """The reference's tests/test_tcp_store.py:225 pattern: two launchers
    (one a node) on one store; node 1's second trainer fails in epoch 0,
    the shared epoch counter restarts both nodes, and all four trainers
    meet again in epoch 1."""
    plan(run, e0_r3={"barrier": 1, "exit": 1}, any={"barrier": 1})
    addr = f"127.0.0.1:{free_port()}"
    results = {}

    def node(nr):
        results[nr] = port_launch(run, nproc_per_node=2, master=addr,
                                  node_rank=nr, nnodes=2, max_restarts=2)
    threads = [threading.Thread(target=node, args=(nr,)) for nr in (1, 0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert results == {0: 0, 1: 0}
    got = dumps(run)
    assert {(1, r) for r in range(4)} <= set(got)
    assert {got[(1, r)]["PADDLE_NODE_RANK"] for r in range(4)} == {"0", "1"}


def test_multinode_elastic_membership(run):
    """``np_range`` across launchers (``_elastic_multinode``): each node
    joins the epoch, the lowest joiner publishes the member list, and the
    members start one trainer each, re-ranked contiguously; a clean
    finish on both ends the job on both."""
    plan(run, any={"barrier": 1})
    addr = f"127.0.0.1:{free_port()}"
    results = {}

    def node(nr):
        results[nr] = port_launch(run, np_range=(1, 2), master=addr,
                                  node_rank=nr, nnodes=2)
    threads = [threading.Thread(target=node, args=(nr,)) for nr in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert results == {0: 0, 1: 0}
    got = dumps(run)
    assert sorted(got) == [(0, 0), (0, 1)]
    for r in (0, 1):
        assert got[(0, r)]["PADDLE_TRAINERS_NUM"] == "2"
        assert got[(0, r)]["PADDLE_LOCAL_RANK"] == "0"
        assert got[(0, r)]["PADDLE_NODE_RANK"] == str(r)


def test_elastic_manager_finds_dead_ranks():
    """Each rank beats ``__hb/<rank>``; one that stops beating is dead
    after ``heartbeat_timeout``."""
    master = TCPStore(is_master=True)
    try:
        mgrs = [L.ElasticManager(TCPStore("127.0.0.1", master.port), r, 2,
                                 heartbeat_interval=0.05,
                                 heartbeat_timeout=0.5).start()
                for r in range(2)]
        assert mgrs[0].dead_ranks() == [] and mgrs[0].all_alive()
        mgrs[1].stop()
        wait_for(lambda: mgrs[0].dead_ranks() == [1], "rank 1 dead", 10)
        assert not mgrs[1].all_alive()
        mgrs[0].stop()
    finally:
        master.close()


@pytest.mark.parametrize("arg", [None, "1", "4", "1:4", "2:2", "0:2", "3:2",
                                 "0", "x", "1:y"])
def test_parse_np(arg):
    def outcome(fn):
        try:
            return fn(arg)
        except ValueError as e:
            return type(e)
    assert outcome(L.parse_np) == outcome(jlaunch.parse_np)


@pytest.mark.parametrize("stamp", ["PADDLE_TPU_GOODPUT_DOWN_AT",
                                   "PADDLE_TPU_GOODPUT_RESIZE_AT"])
def test_the_goodput_ledger_takes_the_launchers_stamps(stamp, monkeypatch):
    """``env.init_parallel_env`` reads the launcher's stamp with the rest
    of its protocol (``_read_launch_env``), and the process ledger takes
    it from the launched job: the gap is ``restart`` after a crash and
    ``reshard`` after a resize, as the reference's ledger bins it from
    the environment. Without a launched job the stamp is not read."""
    from paddle_tpu.observability import goodput as jgoodput
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.observability import goodput
    for k, v in {"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2",
                 "PADDLE_MASTER": "127.0.0.1:9", "PADDLE_STORE_PORT": "9",
                 "PADDLE_RESTART_EPOCH": "3",
                 stamp: repr(time.time() - 50)}.items():
        monkeypatch.setenv(k, v)
    want = "restart" if stamp.endswith("DOWN_AT") else "reshard"
    goodput.reset_ledger()
    try:
        assert goodput.get_ledger().snapshot()["bins"][want] == 0
        goodput.reset_ledger()
        monkeypatch.setitem(env._state, "job", env._read_launch_env())
        assert env.job_namespace() == "3"
        mine = goodput.get_ledger().snapshot()["bins"]
        theirs = jgoodput.GoodputLedger().snapshot()["bins"]
        for bins in (mine, theirs):
            assert 50 <= bins[want] < 60
            assert bins["restart" if want == "reshard" else "reshard"] == 0
    finally:
        goodput.reset_ledger()
