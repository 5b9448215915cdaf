"""Live elastic resharding (``paddle_tpu_torch.resilience.elastic``) and
the fleet heartbeat bus held against the JAX package: the in-memory
exchange over a store (``publish_state``/``collect_state``/
``exchange_reshard``, the pattern of the reference's
``tests/test_elastic.py:36``) is bit-equal to the reference's and crosses
between the packages; the resize listener's consensus; ``perform_resize``
2 -> 1 over two gloo processes under the port's launcher (rank 1 departs
with 83, rank 0 continues in place to the reference's losses and sees
rank 1 ``departed``); ``FitResilience(elastic=True)`` stopping at the
boundary; and the aggregator's ``poll_once``/``rollup(now=)`` on the same
heartbeats."""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.observability.fleet as jfleet
import paddle_tpu.resilience.elastic as jel
import torch_dist_worker as W
from paddle_tpu.observability.metrics import MetricsRegistry as JRegistry
from paddle_tpu.resilience import FitResilience as JFit
from paddle_tpu_torch.data import DataPipeline
from paddle_tpu_torch.hapi import Callback
from paddle_tpu_torch.observability import fleet
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.resilience import FitResilience
from paddle_tpu_torch.resilience import elastic as el
from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_distributed import jax_llama_losses
from test_torch_hapi import PIPE, _docs, jax_fit_model, port_fit_model
from test_torch_job_lifecycle import launch_worker


class MemStore:
    """A dict as the job's store (set/get/add/wait), as the reference's
    tests use one."""

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

    def wait(self, key, timeout=None):
        return self.d[key]


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "m": rng.randn(4, 6).astype(np.float32),
            "meta": np.arange(5, dtype=np.int32)}


def port_state(a):
    return {"model": {"w": torch.from_numpy(a["w"]),
                      "b": torch.from_numpy(a["b"])},
            "optimizer": {"m": torch.from_numpy(a["m"]).to(torch.bfloat16),
                          "@step_count": 3, "lr": 0.1},
            "meta": a["meta"].copy()}


def jax_state(a):
    return {"model": {"w": pt.to_tensor(a["w"]), "b": pt.to_tensor(a["b"])},
            "optimizer": {"m": pt.to_tensor(a["m"]).astype("bfloat16"),
                          "@step_count": 3, "lr": 0.1},
            "meta": a["meta"].copy()}


def raw(v):
    """A leaf's bytes and shape, whichever package made it."""
    if isinstance(v, torch.Tensor):
        v = v.contiguous()
        return v.reshape(-1).view(torch.uint8).numpy().tobytes(), \
            tuple(v.shape)
    a = np.asarray(getattr(v, "data", v))
    return a.tobytes(), a.shape


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_same_state(got[k], want[k])
        elif isinstance(want[k], (int, float)):
            assert got[k] == want[k]
        else:
            assert raw(got[k]) == raw(want[k]), k


@pytest.mark.parametrize("world,new_world", [(3, 2), (2, 1), (1, 3)])
def test_exchange_is_bit_equal_to_the_references(world, new_world):
    """Every old rank publishes its shards of one state; the collected
    states, the stores' keys, shard bytes, manifests and skeletons are the
    reference's, and each package collects what the other published."""
    a = _arrays(world)
    stores, got = {}, {}
    for pkg, mod, mk in (("port", el, port_state), ("jax", jel, jax_state)):
        store = stores[pkg] = MemStore()
        prefix = mod.elastic_prefix(0)
        kw = {"device": "cpu"} if pkg == "port" else {}
        for r in range(1, world):  # the peers have published already
            mod.publish_state(store, prefix, mk(a), world, r)
        outs = [mod.exchange_reshard(store, prefix, mk(a), world, r,
                                     new_world, **kw) for r in range(world)]
        assert [o is None for o in outs] == [r >= new_world
                                             for r in range(world)]
        got[pkg] = [o for o in outs if o is not None]
    assert stores["port"].d.keys() == stores["jax"].d.keys()
    for k, v in stores["port"].d.items():
        w = stores["jax"].d[k]
        if k.endswith("/manifest"):
            import pickle
            assert pickle.loads(v) == pickle.loads(w)
        else:
            assert v == w, k
    assert len(got["port"]) == min(world, new_world)
    for p in got["port"]:
        assert_same_state(p, got["jax"][0])
        assert_same_state(p, port_state(a))
    crossed = el.collect_state(stores["jax"], el.elastic_prefix(0),
                               device="cpu")
    assert_same_state(crossed, port_state(a))
    back = jel.collect_state(stores["port"], jel.elastic_prefix(0))
    assert_same_state(back, got["jax"][0])


def test_a_corrupt_shard_is_refused():
    store = MemStore()
    el.publish_state(store, "p", port_state(_arrays()), 1, 0)
    key = next(k for k in store.d if "/t/" in k)
    store.d[key] = bytes(len(store.d[key]))
    from paddle_tpu_torch.checkpoint.layout import CheckpointIntegrityError
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        el.collect_state(store, "p", device="cpu")


def _consensus(mod, tmp_path):
    """Two listeners on one store: rank 0 asks for world 1 during step 3;
    the steps at which each says True, the verdict, the generation
    isolation and the notice file."""
    store = MemStore()
    a, b = mod.ElasticResizeListener(store), mod.ElasticResizeListener(store)
    seen = []
    for step in range(2, 6):
        if step == 3:
            a.request(1, "test")
        seen.append((step, a.should_resize(step), b.should_resize(step)))
    out = dict(seen=seen, target=(a.target_world, b.target_world),
               boundary=(a.boundary_step, b.boundary_step),
               reason=b.reason, stop=store.get("__elastic/0/g0/stop"))
    store.set("__elastic/0/gen", b"1")  # the survivors' next generation
    fresh = mod.ElasticResizeListener(store)
    out["fresh"] = (fresh.should_resize(9), fresh.generation)
    note = tmp_path / f"{mod.__name__}.resize"
    note.write_text("3\n")
    filed = mod.ElasticResizeListener(notice_file=str(note))
    out["file"] = (filed.should_resize(7), filed.target_world,
                   filed.boundary_step, filed.reason)
    return out


def test_listener_consensus_equals_the_references(tmp_path):
    port = _consensus(el, tmp_path)
    assert port == _consensus(jel, tmp_path)
    assert port["seen"] == [(2, False, False), (3, False, False),
                            (4, True, True), (5, True, True)]
    assert port["target"] == (1, 1) and port["boundary"] == (4, 4)
    assert port["fresh"] == (False, 1)
    assert port["file"] == (True, 3, 7, "notice_file")


def test_perform_resize_over_gloo_processes(tmp_path):
    """Two ranks under the launcher; rank 0 asks for world 1 at step 3,
    both stop at step 4, rank 1 publishes its shards and departs with 83,
    rank 0 assembles the state, joins a world of one and fits steps 5-6:
    every loss equals the reference's uninterrupted GSPMD dp run (one
    mean over the global batch), and rank 0's aggregator shows rank 1
    departed, never missing. No epoch follows: the resize was in place."""
    r, recs = launch_worker(tmp_path, "elastic", "steps=6", "resize_step=3",
                            max_restarts=0)
    assert r.returncode == 0, r.stderr[-4000:]
    assert sorted(recs) == [(0, 0), (1, 0)]
    r0, r1 = recs[(0, 0)], recs[(1, 0)]
    assert r0["boundary"] == r1["boundary"] == 4
    assert r1["ended"] == "resized" and sorted(r1["losses"]) == \
        ["1", "2", "3", "4"]
    assert r0["new_world"] == r0["world_after"] == 1
    import jax
    from test_torch_distributed import jax_mesh
    want, _ = jax_llama_losses(W.TINY, W.llama_batches(
        W.TINY["vocab_size"], n=6), mesh=jax_mesh({"dp": 2}),
        bucketed=False)
    assert len(jax.devices()) >= 2
    got = [r0["losses"][str(s)] for s in range(1, 7)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert r0["goodput"]["reshard"] > 0 and r0["goodput"]["restart"] == 0
    lanes = r0["fleetz"]["ranks"]
    assert r0["fleetz"]["aggregator"] is True
    assert lanes["1"]["status"] == "departed" and lanes["1"]["departed"]
    assert lanes["0"]["status"] == "live"


def test_fit_resilience_stops_at_the_resize_boundary():
    """``FitResilience(elastic=True)`` with no store: a notice during
    step 2 stops ``fit`` at step 2's boundary with no checkpoint, as the
    reference's does, on the same losses."""
    from paddle_tpu.data import DataPipeline as JPipe
    from paddle_tpu.hapi import Callback as JCallback
    jm, jmodel, _ = jax_fit_model(7)
    runs = {"jax": (jmodel, JFit, JPipe, JCallback),
            "port": (port_fit_model(jm)[1], FitResilience, DataPipeline,
                     Callback)}
    out = {}
    for pkg, (model, Fit, Pipe, Base) in runs.items():
        fr = Fit(elastic=True, preemption=False)
        losses = []

        class Ask(Base):
            def on_train_batch_begin(self, step, logs=None):
                if step == 2:
                    fr.elastic_listener.request(3, "test")

            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"])
        model.fit(Pipe(_docs(), **PIPE), num_iters=6, verbose=0,
                  callbacks=[fr, Ask()])
        out[pkg] = (losses, fr.resized, fr.resize_target,
                    fr.resize_boundary_step, fr.preempted)
    assert out["port"][1:] == out["jax"][1:] == (True, 3, 2, False)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
    assert len(out["port"][0]) == 2


def _heartbeats(t0):
    """Three ranks' heartbeats over four folds: rank 2 slows down (a
    straggler after three new slow steps), rank 1 departs at fold 2, and
    at fold 3 rank 0's lane is stale."""
    folds = []
    for i in range(4):
        now = t0 + 10.0 * i
        recs = {0: dict(step=i + 1, t=now if i < 3 else t0, step_time_s=1.0),
                2: dict(step=i + 1, t=now, step_time_s=1.0 if i == 0
                        else 5.0)}
        recs[1] = dict(step=2, t=t0 + 10, departed=True, reason="resize") \
            if i >= 2 else dict(step=i + 1, t=now, step_time_s=1.1)
        for r, rec in recs.items():
            rec.update(rank=r, pid=100 + r)
            if "step_time_s" in rec:
                rec["goodput"] = {"bins": {"productive": 2.0 + r,
                                           "checkpoint": 0.5},
                                  "wall_s": 4.0, "fraction": 0.5}
        folds.append((now + (20.0 if i == 3 else 1.0), recs))
    return folds


def test_fleet_aggregator_equals_the_references():
    """``poll_once`` and ``rollup(now=)`` fold the same heartbeats into
    the same document (liveness, departed and missing lanes, stragglers,
    the fleet goodput)."""
    docs = {}
    for name, mod, reg in (("port", fleet, MetricsRegistry),
                           ("jax", jfleet, JRegistry)):
        store = MemStore()
        agg = mod.FleetAggregator(store=store, world=3, interval=1.0,
                                  stale_s=15.0, k=1.5, m=2,
                                  registry=reg())
        docs[name] = []
        for now, recs in _heartbeats(1000.0):
            for r, rec in recs.items():
                store.set(f"__fleet/0/hb/{r}", json.dumps(rec))
            docs[name].append(agg.poll_once(now=now))
        docs[name].append(agg.rollup(now=now + 5))
    assert docs["port"] == docs["jax"]
    last = docs["port"][-2]
    assert last["ranks"]["1"]["status"] == "departed"
    assert last["ranks"]["0"]["status"] == "missing"
    assert last["stragglers"] == [2]


def test_publisher_and_depart_records(monkeypatch):
    """A publisher's heartbeat and a departure carry the reference's
    fields; the module seams are no-ops while the bus is off. Both
    packages start without a process goodput ledger (an earlier test in
    the same process may have left one, which adds a ``goodput`` field)."""
    import paddle_tpu.observability.goodput as jgoodput
    from paddle_tpu_torch.observability import goodput
    monkeypatch.setattr(jgoodput, "_ledger", None)
    monkeypatch.setattr(goodput, "_ledger", None)
    fleet.disable()
    fleet.publish_step(1, {})
    assert fleet.recent_heartbeats() == []
    store = MemStore()
    try:
        pub = fleet.enable(store=store, rank=1, start_aggregator=False)
        fleet.publish_step(4, {"step_time_s": 0.25})
        fleet.depart(5)
        jpub = jfleet.HeartbeatPublisher(store=MemStore(), rank=1)
        jpub.publish(4, {"step_time_s": 0.25})
        jpub.depart(5)
        for mine, ref in zip(pub.recent, jpub.recent):
            assert set(mine) == set(ref)
        rec = json.loads(store.get("__fleet/0/hb/1"))
        assert rec["departed"] and rec["step"] == 5
        assert fleet.recent_heartbeats()[0]["step_time_s"] == 0.25
    finally:
        fleet.disable()
    assert fleet.maybe_enable() is None  # no launched job here
    assert fleet.maybe_enable(False) is None
    assert os.environ.get("PADDLE_TPU_FLEET") is None
