"""The port's serving fleet (``serving/fleet``) against ``paddle_tpu``'s.

The same bridged tiny Llama (f32) serves through both packages' fleets:
one ``prefill`` and one ``decode`` replica behind a ``FleetRouter``
(one module-scoped JAX fleet, gather read path). Disaggregated greedy
streams must equal the JAX fleet's and one port engine's; the decode
replica must admit the handed-off blocks as cached tokens. Placement
scores and prompt digests are compared on the same inputs; failover, an
int8-KV replica handing blocks to an f32 one, two engines sharing one
model from two threads, and ``RouterServer``'s endpoints run on the
port alone.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import FleetRouter as JaxRouter
from paddle_tpu.serving import build_fleet as jax_build_fleet
from paddle_tpu.serving.fleet import router as jrouter
from paddle_tpu.serving.fleet.replica import Replica as JaxReplica
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxCache
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import requests as obs_requests
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.serving import (FleetRouter, Replica, RouterServer,
                                      ServingEngine, build_fleet)
from paddle_tpu_torch.serving.engine import serving_metrics
from paddle_tpu_torch.serving.fleet import router as prouter
from paddle_tpu_torch.serving.fleet import router_metrics
from paddle_tpu_torch.serving.kv_cache import PagedKVCache

from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401

KW = dict(max_batch=3, max_blocks=48, block_size=4, prefill_chunk=4)
THRESHOLD = 12


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny(5)
    return jm, bridged(jm)


@pytest.fixture
def ledger():
    """The process ledger keeping every record while a test runs."""
    led = obs_requests.maybe_arm()
    rate, led.sample_rate = led.sample_rate, 1.0
    yield led
    led.sample_rate = rate


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, 256, n).tolist() for n in (17, 6, 30, 12)]


def _solo(tm, prompts, new_tokens=6):
    eng = ServingEngine(tm, device="cpu", **KW)
    hs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    eng.run_until_idle()
    return [h.result(10)["token_ids"] for h in hs]


def _port_fleet(tm, roles=("prefill", "decode"), **kw):
    reps = build_fleet(lambda: tm, len(roles), roles=list(roles),
                       device="cpu", **dict(KW, **kw))
    return reps, FleetRouter(reps, prefill_threshold=THRESHOLD)


def _serve(router, prompts, new_tokens=6, trace_ids=None):
    router.start()
    try:
        hs = [router.submit(p, max_new_tokens=new_tokens,
                            trace_id=None if trace_ids is None
                            else trace_ids[i])
              for i, p in enumerate(prompts)]
        return hs, [h.result(60)["token_ids"] for h in hs]
    finally:
        router.shutdown(drain=True)


@pytest.fixture(scope="module")
def jax_fleet_streams(models):
    """The JAX fleet's streams of ``_prompts()``, served in turn."""
    jm, _ = models
    reps = jax_build_fleet(lambda: jm, 2, roles=["prefill", "decode"],
                           attn_impl="gather", **KW)
    router = JaxRouter(reps, affinity=True, disagg=True,
                       prefill_threshold=THRESHOLD)
    router.start()
    try:
        out = [router.submit(p, max_new_tokens=6).result(timeout=300)
               ["token_ids"] for p in _prompts()]
        decisions = dict(router.decisions)
    finally:
        router.shutdown(drain=True)
    return out, decisions


# ---------------- digests and placement -------------------------------------
@pytest.mark.parametrize("n,bs", [(0, 4), (3, 4), (4, 4), (17, 4), (64, 16),
                                  (70, 16)])
def test_prompt_digests_equal_the_reference(n, bs):
    tokens = np.random.RandomState(n).randint(0, 50000, n).tolist()
    assert prouter.prompt_digests(tokens, bs) == \
        jrouter.prompt_digests(tokens, bs)


class _Cache:
    block_size = 4


class _FakeEngine:
    def __init__(self, sketch, in_flight, headroom):
        self.cache = _Cache()
        self._st = {"requests_in_flight": in_flight,
                    "kv_headroom": headroom, "waiting": in_flight,
                    "prefix_cache": {"sketch": sketch}}

    def stats(self):
        return dict(self._st)


_PROMPT = list(range(100, 120))


def _sk(k):
    return [d[:8].hex() for d in jrouter.prompt_digests(_PROMPT, 4)[:k]]


@pytest.mark.parametrize("replicas,affinity", [
    ([(_sk(2), 5, 0.9), (_sk(4), 9, 0.1)], True),       # longest match
    ([(_sk(3), 1, 0.5), (_sk(3), 0, 0.9)], True),       # tie: first
    ([([], 3, 0.2), (["00" * 8], 1, 0.2)], True),       # no match: load
    ([([], 2, 0.2), ([], 2, 0.7)], True),               # then headroom
    ([(_sk(4), 9, 0.1), ([], 0, 0.9)], False),          # affinity off
    ([(_sk(1)[1:] + _sk(4)[2:], 0, 0.9), (_sk(1), 4, 0.1)], True),
])
def test_placement_equals_the_reference(replicas, affinity):
    """The same sketches and loads give the same placement decision:
    the longest leading digest run wins, else the fewest in-flight
    requests, then the most KV headroom."""
    picks = []
    for rep_cls, router_cls in ((JaxReplica, JaxRouter),
                                (Replica, FleetRouter)):
        reps = [rep_cls(_FakeEngine(*r), f"r{i}", role="mixed")
                for i, r in enumerate(replicas)]
        router = router_cls(reps, affinity=affinity, disagg=True,
                            prefill_threshold=64)
        rep, decision = router._place_serving(_PROMPT)
        picks.append((rep.name, decision))
    assert picks[1] == picks[0]


def test_affinity_routes_to_the_replica_holding_the_prefix(models):
    _, tm = models
    prompt = _prompts()[2]
    reps, router = _port_fleet(tm, roles=("mixed", "mixed"))
    router.start()
    try:
        warm = reps[1].engine
        warm.submit(prompt, max_new_tokens=2).result(60)
        # the warm replica is busier, yet holds the prefix
        busy = warm.submit(_prompts()[0], max_new_tokens=40)
        res = router.submit(prompt[:24] + [7, 8], max_new_tokens=3)
        res.result(60)
        assert res._attempt_replica is reps[1]
        assert router.decisions["affinity"] == 1
        busy.result(60)
    finally:
        router.shutdown(drain=True)
    reps2, off = _port_fleet(tm, roles=("mixed", "mixed"))
    off.affinity = False
    off.start()
    try:
        reps2[1].engine.submit(prompt, max_new_tokens=2).result(60)
        busy = reps2[1].engine.submit(_prompts()[0], max_new_tokens=40)
        h = off.submit(prompt[:24] + [7, 8], max_new_tokens=3)
        h.result(60)
        assert h._attempt_replica is reps2[0]
        assert off.decisions == {"affinity": 0, "least_loaded": 1,
                                 "disagg_prefill": 0, "failover": 0}
        busy.result(60)
    finally:
        off.shutdown(drain=True)


# ---------------- disaggregation --------------------------------------------
def test_disaggregated_streams_equal_the_jax_fleet_and_one_engine(
        models, jax_fleet_streams):
    _, tm = models
    want, jdecisions = jax_fleet_streams
    assert _solo(tm, _prompts()) == want
    reps, router = _port_fleet(tm)
    m = router_metrics()
    handoffs0 = m["kv_handoffs"].value()
    router.start()
    try:
        got = [router.submit(p, max_new_tokens=6).result(60)["token_ids"]
               for p in _prompts()]
        decisions = dict(router.decisions)
    finally:
        router.shutdown(drain=True)
    assert got == want
    assert decisions == jdecisions and decisions["disagg_prefill"] == 3
    assert m["kv_handoffs"].value() - handoffs0 == 3
    for r in reps:
        r.engine.cache.allocator.assert_no_leaks()


def test_the_decode_replica_admits_the_handoff_as_cached_tokens(
        models, ledger):
    _, tm = models
    reps, router = _port_fleet(tm)
    tids = [f"{0xd15a0 + i:032x}" for i in range(4)]
    blocks0 = router_metrics()["kv_handoff_blocks"].value()
    _serve(router, _prompts(), trace_ids=tids)
    recs = {}
    for d in ledger.exemplars():
        recs.setdefault(d["trace_id"], []).append(d)
    bs = KW["block_size"]
    for tid, p in zip(tids, _prompts()):
        # the decode-side attempt is the last record of the trace id
        dec = recs[tid][-1]
        assert dec["prefilled_tokens"] + dec["cached_tokens"] == len(p)
        if len(p) >= THRESHOLD:
            pre = recs[tid][0]
            assert pre["max_new_tokens"] == 1 and \
                pre["prefilled_tokens"] == len(p)
            full = (len(p) // bs) * bs
            assert dec["cached_tokens"] == min(full, len(p) - 1)
            assert dec["prefilled_tokens"] < bs
        else:
            assert len(recs[tid]) == 1 and dec["cached_tokens"] == 0
    assert router_metrics()["kv_handoff_blocks"].value() - blocks0 == \
        sum(len(p) // bs for p in _prompts() if len(p) >= THRESHOLD)


def test_export_claims_and_releases_each_block(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **KW)
    prompt = _prompts()[0]
    h = eng.submit(prompt, max_new_tokens=1)
    eng.run_until_idle()
    h.result(1)
    digs = prouter.prompt_digests(prompt, KW["block_size"])
    alloc = eng.cache.allocator
    parked = alloc.num_reclaimable()
    recs = eng.export_kv_blocks(digs + [b"\x00" * 16] + digs)
    assert [d for d, _, _ in recs] == digs  # stops at the first miss
    assert alloc.num_reclaimable() == parked and alloc.blocks_in_use() == 0
    pc = eng.cache.prefix_cache
    for d, k, v in recs:
        b = pc.lookup(d)
        assert alloc.is_cached(b) and alloc.refcount(b) == 0
        assert torch.equal(k, torch.stack([p[b] for p in
                                           eng.cache.k_pools]))
        assert k.dtype == torch.float32 and k.device.type == "cpu"
    assert len(pc) == len(digs) and len(pc.sketch()) == len(digs)
    # importing what is already resident adopts nothing new
    assert eng.import_kv_blocks(recs) == len(recs)
    alloc.assert_no_leaks()


# ---------------- int8 KV ----------------------------------------------------
def _filled(cache_cls, rng_seed, **kw):
    rng = np.random.RandomState(rng_seed)
    c = cache_cls(2, 6, 4, 2, 8, 6, prefix_cache=True, kv_dtype="int8", **kw)
    vals = [rng.randint(-127, 128, (7, 4, 2, 8)).astype(np.int8)
            for _ in range(4)]
    scales = [rng.uniform(1e-3, 0.1, (7, 4, 2)).astype(np.float32)
              for _ in range(4)]
    return c, vals, scales


def test_int8_block_export_and_import_equal_the_reference():
    """An int8 pool's export dequantizes with its scales into the compute
    dtype, and an import re-quantizes per (token, kv head), as the
    reference's: the same pool contents give the same rows and the same
    re-quantized values and scales."""
    ref, vals, scales = _filled(JaxCache, 0, dtype=jnp.float32)
    ref.k_pools = tuple(jnp.asarray(v) for v in vals[:2])
    ref.v_pools = tuple(jnp.asarray(v) for v in vals[2:])
    ref.k_scales = tuple(jnp.asarray(s) for s in scales[:2])
    ref.v_scales = tuple(jnp.asarray(s) for s in scales[2:])
    port, _, _ = _filled(PagedKVCache, 0, dtype=torch.float32, device="cpu")
    for dst, src in ((port.k_pools, vals[:2]), (port.v_pools, vals[2:]),
                     (port.k_scales, scales[:2]),
                     (port.v_scales, scales[2:])):
        for t, a in zip(dst, src):
            t.copy_(torch.from_numpy(a))
    for b in (1, 5):
        jk, jv = ref.export_block(b)
        pk, pv = port.export_block(b)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        rows = np.random.RandomState(b).randn(2, 4, 2, 8).astype(np.float32)
        ref.import_block(b, rows, 2 * rows)
        port.import_block(b, torch.from_numpy(rows), 2 * rows)
        for i in range(2):
            np.testing.assert_array_equal(port.k_pools[i][b].numpy(),
                                          np.asarray(ref.k_pools[i][b]))
            np.testing.assert_array_equal(port.v_scales[i][b].numpy(),
                                          np.asarray(ref.v_scales[i][b]))


def test_an_int8_kv_replica_hands_blocks_to_an_f32_one(models, ledger):
    _, tm = models
    with pytest.warns(RuntimeWarning, match="gather"):
        pre = Replica(ServingEngine(tm, device="cpu", kv_dtype="int8",
                                    **KW), "pre8", role="prefill")
    dec = Replica(ServingEngine(tm, device="cpu", **KW), "dec32",
                  role="decode")
    router = FleetRouter([pre, dec], prefill_threshold=THRESHOLD)
    prompt = _prompts()[2]
    digs = prouter.prompt_digests(prompt, KW["block_size"])
    tid = "8" * 32
    hs, streams = _serve(router, [prompt], trace_ids=[tid])
    assert len(streams[0]) == 6
    rec = [d for d in ledger.exemplars() if d["trace_id"] == tid][-1]
    assert rec["cached_tokens"] == 28 and rec["prefilled_tokens"] == 2
    # the f32 pools hold the int8 pools' dequantized rows exactly
    for d in digs:
        k8, v8 = pre.engine.cache.export_block(
            pre.engine.cache.prefix_cache.lookup(d))
        b = dec.engine.cache.prefix_cache.lookup(d)
        assert torch.equal(torch.stack([p[b] for p in
                                        dec.engine.cache.k_pools]), k8)
        assert torch.equal(torch.stack([p[b] for p in
                                        dec.engine.cache.v_pools]), v8)


# ---------------- failover ---------------------------------------------------
def test_a_mid_stream_kill_fails_over_token_for_token(models, ledger):
    """Kill the replica serving a stream after 3 tokens: the survivor
    finishes it token for token, nothing streamed twice, and — holding
    the prompt's prefix — recomputes only the tail."""
    _, tm = models
    reps, router = _port_fleet(tm, roles=("mixed", "mixed"))
    prompt = _prompts()[2]
    want = _solo(tm, [prompt], 16)[0]
    router.start()
    try:
        got, seen3, killed = [], threading.Event(), threading.Event()

        def on_tok(_h, t):
            got.append(t)
            if len(got) >= 3:
                seen3.set()
                if not killed.is_set():
                    # hold the victim's step (the callback runs inside
                    # it) until the plug is pulled
                    killed.wait(5)

        tid = "f1ee7000" * 4
        h = router.submit(prompt, max_new_tokens=16, on_token=on_tok,
                          trace_id=tid)
        assert seen3.wait(60)
        victim = h._attempt_replica
        survivor = reps[1] if victim is reps[0] else reps[0]
        survivor.engine.submit(prompt, max_new_tokens=2).result(60)
        killer = threading.Thread(target=victim.kill)
        killer.start()
        time.sleep(0.05)
        killed.set()
        killer.join(30)
        res = h.result(60)
    finally:
        router.shutdown(drain=True)
    assert res["token_ids"] == got == want
    assert res["failovers"] == 1 and router.decisions["failover"] == 1
    assert router.stats()["replicas_dead"] == 1
    rec = [d for d in ledger.exemplars()
           if d["trace_id"] == tid and d["error"] is None][-1]
    assert rec["cached_tokens"] >= 28
    assert rec["cached_tokens"] + rec["prefilled_tokens"] == \
        rec["prompt_len"] and rec["prefilled_tokens"] < rec["prompt_len"]


# ---------------- one model, two engines ------------------------------------
def test_two_engines_share_one_model_from_two_threads(models):
    _, tm = models
    prompts = _prompts()
    want = _solo(tm, prompts, 8)
    engines = [ServingEngine(tm, device="cpu", **KW) for _ in range(2)]
    for e in engines:
        e.start()
    try:
        hs = [engines[i % 2].submit(p, max_new_tokens=8)
              for i, p in enumerate(prompts + prompts)]
        got = [h.result(60)["token_ids"] for h in hs]
    finally:
        for e in engines:
            e.shutdown()
    assert got == want + want


def _module_state(model):
    """Every non-parameter attribute of every submodule: what a forward
    could leave behind on the model."""
    out = {}
    for name, mod in model.named_modules():
        for k, v in vars(mod).items():
            if k.startswith("_") or isinstance(v, (torch.nn.Module,)):
                continue
            out[(name, k)] = v if isinstance(v, (int, float, str, bool,
                                                 type(None))) else id(v)
    return out


def test_the_llama_forward_keeps_no_per_call_state_the_moe_does(models):
    """Why a fleet on one card may share a Llama but builds one MoE model
    per replica: a served step leaves every Llama submodule's attributes
    as they were, while the MoE gates keep the step's ``l_aux``."""
    from paddle_tpu_torch.models.moe import MoeConfig, MoeForCausalLM
    _, tm = models
    before = _module_state(tm)
    eng = ServingEngine(tm, device="cpu", **KW)
    eng.submit(_prompts()[0], max_new_tokens=3)
    eng.run_until_idle()
    assert _module_state(tm) == before
    torch.manual_seed(0)
    moe = MoeForCausalLM(MoeConfig.tiny(), device="cpu")
    moe.eval()
    meng = ServingEngine(moe, device="cpu", **KW)
    meng.submit([t % moe.cfg.vocab_size for t in _prompts()[0]],
                max_new_tokens=1)
    orig = meng._clear_model_side_effects
    kept = []
    meng._clear_model_side_effects = lambda: kept.append(moe.aux_loss())
    meng.run_until_idle()
    meng._clear_model_side_effects = orig
    assert any(a is not None for a in kept)


# ---------------- the router's HTTP server ----------------------------------
def test_router_server_endpoints_shed_and_one_trace_chain(models, tmp_path):
    _, tm = models
    reps, router = _port_fleet(tm, roles=("prefill", "decode", "mixed"))
    trace.enable(str(tmp_path))
    tid = "ab" * 16
    prompt = _prompts()[0]
    srv = RouterServer(router, max_queue_depth=4).start()
    try:
        def post(body, tp_tid=tid):
            req = urllib.request.Request(
                srv.url + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": f"00-{tp_tid}-b7ad6b7169203331-01"})
            try:
                r = urllib.request.urlopen(req, timeout=60)
                return r.status, dict(r.headers), r.read()
            except urllib.error.HTTPError as e:
                return e.code, dict(e.headers), e.read()

        code, headers, body = post({"prompt_ids": prompt,
                                    "max_new_tokens": 5})
        res = json.loads(body)
        scode, _, sbody = post({"prompt_ids": prompt[:6],
                                "max_new_tokens": 4, "stream": True},
                               tp_tid="cd" * 16)
        fz = json.loads(urllib.request.urlopen(srv.url + "/fleetz",
                                               timeout=30).read())
        sz = json.loads(urllib.request.urlopen(
            srv.url + "/statusz?format=json", timeout=30).read())
        hz = json.loads(urllib.request.urlopen(srv.url + "/healthz",
                                               timeout=30).read())
        srv.max_queue_depth = 0
        rej = serving_metrics()["rejections"]
        before = rej.value(reason="fleet_saturated")
        shed = post({"prompt_ids": prompt, "max_new_tokens": 2},
                    tp_tid="ef" * 16)
        srv.max_queue_depth = 4
    finally:
        srv.close(drain=True)
        trace.disable()
    assert code == 200 and res["trace_id"] == tid
    assert res["token_ids"] == _solo(tm, [prompt], 5)[0]
    assert tid in headers["traceparent"]
    last = json.loads(sbody.decode().strip().split("\n")[-1])
    assert scode == 200 and last["done"] and last["trace_id"] == "cd" * 16
    assert fz["replicas"] == 3 and len(fz["per_replica"]) == 3
    assert fz["routing"]["disagg_prefill"] == 1
    assert "fleet" in sz and "slo" in sz and hz["replicas_live"] == 3
    assert shed[0] == 503 and shed[1]["Retry-After"]
    assert "ef" * 16 in shed[1]["traceparent"]
    assert "fleet" in json.loads(shed[2])["error"]
    assert rej.value(reason="fleet_saturated") == before + 1
    summary = trace.merge(str(tmp_path), requests=True)
    chain = summary["requests"]["requests"][tid]
    # router spans + the prefill replica's chain + the decode replica's
    assert chain["spans"] >= 8 and chain["cached_tokens"] == 16
    with open(tmp_path / "merged_trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if (e.get("args") or {}).get("trace") == tid]
    assert {"router_route", "router_handoff", "prefill_chunk",
            "request_done", "queue_wait", "decode"} <= set(names)
    assert names.count("request_done") == 2


def test_the_reference_router_knobs_are_not_read(models, monkeypatch):
    """The reference reads ``PADDLE_TPU_ROUTER_AFFINITY``,
    ``_ROUTER_DISAGG``, ``_ROUTER_PREFILL_THRESHOLD`` and
    ``PADDLE_TPU_FLEET_REPLICAS``; the port reads none: the reference's
    defaults are its arguments' defaults."""
    for k, v in (("PADDLE_TPU_ROUTER_AFFINITY", "0"),
                 ("PADDLE_TPU_ROUTER_DISAGG", "0"),
                 ("PADDLE_TPU_ROUTER_PREFILL_THRESHOLD", "3"),
                 ("PADDLE_TPU_FLEET_REPLICAS", "5")):
        monkeypatch.setenv(k, v)
    _, tm = models
    reps = build_fleet(lambda: tm, device="cpu", **KW)
    router = FleetRouter(reps)
    assert len(reps) == 2 and [r.role for r in reps] == ["mixed"] * 2
    assert (router.affinity, router.disagg, router.prefill_threshold) == \
        (True, True, 64)
    with pytest.raises(ValueError, match="role"):
        Replica(reps[0].engine, "x", role="both")
    with pytest.raises(ValueError, match="duplicate"):
        FleetRouter([reps[0], reps[0]])
