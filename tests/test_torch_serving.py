"""The port's ``ServingEngine`` and HTTP ``Server`` against ``paddle_tpu``.

The same bridged tiny Llama is served by the JAX engine (gather read
path) and by the port's engine on the CPU (the RPA wrapper's plain
version, and the gather path); their greedy token streams must be
identical across a multi-chunk prefill, a shared-prefix pair with the
prefix cache on and off, and a pool tight enough to force
preemption-by-recompute. Every engine ends with no leaked KV block.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.serving import Server, ServingEngine

from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny(11)
    return jm, bridged(jm)


def _serve(engine, prompts, max_new_tokens, sequential=False):
    """Greedy streams of ``prompts``; ``sequential`` finishes each
    request before the next is submitted (so later ones can hit the
    prefix cache)."""
    handles = []
    for p in prompts:
        handles.append(engine.submit(p, max_new_tokens=max_new_tokens))
        if sequential:
            engine.run_until_idle()
    engine.run_until_idle()
    out = [h.result(30)["token_ids"] for h in handles]
    engine.cache.allocator.assert_no_leaks()
    return out


def test_multi_chunk_prefill_matches_jax(models):
    jm, tm = models
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 256, 23), rng.randint(1, 256, 3)]
    kw = dict(max_batch=2, max_blocks=24, block_size=4, prefill_chunk=4)
    ref = _serve(JaxEngine(jm, attn_impl="gather", **kw), prompts, 6)
    for impl in (None, "gather"):
        eng = ServingEngine(tm, device="cpu", attn_impl=impl, **kw)
        assert _serve(eng, prompts, 6) == ref
        # 23 tokens in chunks of 4 rode several steps, each one step of
        # the one model
        assert eng.stats()["steps"] > 23 // 4
        assert eng.stats()["rpa_launches"] == 0  # CPU: no kernel launch


def test_shared_prefix_pair_matches_jax_cache_on_and_off(models):
    jm, tm = models
    rng = np.random.RandomState(2)
    prefix = rng.randint(1, 256, 12).tolist()
    prompts = [prefix + rng.randint(1, 256, 3).tolist(),
               prefix + rng.randint(1, 256, 5).tolist(),
               list(prefix)]  # fully cached, aligned: copy-on-write
    kw = dict(max_batch=2, max_blocks=24, block_size=4, prefill_chunk=8)
    ref = _serve(JaxEngine(jm, attn_impl="gather", prefix_cache=False,
                           **kw), prompts, 5, sequential=True)
    for cache_on in (True, False):
        eng = ServingEngine(tm, device="cpu", prefix_cache=cache_on, **kw)
        assert _serve(eng, prompts, 5, sequential=True) == ref
        pc = eng.stats()["prefix_cache"]
        if cache_on:
            assert pc["hits"] >= 2 and pc["hit_tokens"] >= 12 + 11
        else:
            assert pc is None


def test_tight_pool_preemption_matches_jax(models):
    """3 slots x 9-token budgets over 10 blocks of 4: the pool cannot
    hold every admitted sequence, so preemption-by-recompute runs."""
    jm, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, n) for n in (9, 12, 7)]
    kw = dict(max_batch=3, max_blocks=10, block_size=4, prefill_chunk=4)
    jeng = JaxEngine(jm, attn_impl="gather", **kw)
    jhandles = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    jeng.run_until_idle()
    ref = [h.result(30)["token_ids"] for h in jhandles]
    jreqs = [h._req for h in jhandles]
    assert jeng.scheduler.num_preemptions >= 1
    for impl in (None, "gather"):
        eng = ServingEngine(tm, device="cpu", attn_impl=impl, **kw)
        handles = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        assert [h.result(30)["token_ids"] for h in handles] == ref
        eng.cache.allocator.assert_no_leaks()
        assert eng.scheduler.num_preemptions == \
            jeng.scheduler.num_preemptions
        # recompute only the uncached tail: per-request prefill
        # accounting equal to the reference engine's
        for h, jr in zip(handles, jreqs):
            r = h._req
            assert (r.preemptions, r.prefilled_tokens,
                    r.admitted_pending_total, r.cached_tokens_total) == \
                (jr.preemptions, jr.prefilled_tokens,
                 jr.admitted_pending_total, jr.cached_tokens_total)
            assert r.prefilled_tokens <= \
                r.admitted_pending_total - r.cached_tokens_total


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def test_server_round_trip(models):
    _, tm = models
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, n).tolist() for n in (6, 10, 3)]
    kw = dict(max_batch=2, max_blocks=24, block_size=4, prefill_chunk=4)
    want = _serve(ServingEngine(tm, device="cpu", **kw), prompts, 5)

    eng = ServingEngine(tm, device="cpu", **kw)
    results = [None] * len(prompts)
    with Server(eng) as srv:
        def fire(i):
            status, raw = _post(srv.url + "/generate", {
                "prompt_ids": prompts[i], "max_new_tokens": 5,
                "stream": i == 1})
            results[i] = (status, raw)

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url + "/generate", {"prompt_ids": "not a list"})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/nope", timeout=30)
        assert e.value.code == 404
    for i, (status, raw) in enumerate(results):
        assert status == 200
        if i == 1:
            lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
            streamed = [x["token"] for x in lines if "token" in x]
            assert lines[-1]["done"] and streamed == want[i]
            assert lines[-1]["token_ids"] == want[i]
        else:
            body = json.loads(raw)
            assert body["token_ids"] == want[i]
            assert body["finish_reason"] == "length" and body["ttft_ms"] > 0
    assert health["status"] == "ok" and health["device"] == "cpu"
    assert health["kv_blocks_in_use"] == 0 and health["running"] == 0
    eng.cache.allocator.assert_no_leaks()


def _shared_prefix_decode(engine):
    """Three decode rows of up to 27 tokens in one q tile, sharing a
    24-token prefix (6 pages of 4) through the prefix cache: a tile's
    work list then holds 3 x 7 = 21 pages of a 10-block pool."""
    rng = np.random.RandomState(5)
    prefix = rng.randint(1, 256, 24).tolist()
    first = engine.submit(prefix + [7], max_new_tokens=4)
    while first._req.num_cached < 24:
        engine.step()
    handles = [first] + [engine.submit(prefix + [t], max_new_tokens=3)
                         for t in (11, 13)]
    engine.run_until_idle()
    out = [h.result(30)["token_ids"] for h in handles]
    engine.cache.allocator.assert_no_leaks()
    return out


def test_shared_pages_fit_the_work_list_bound(models, monkeypatch):
    """The bound on a tile's RPA work list counts the pages of every
    sequence in the tile, shared or not. The old bound, capped at the
    pool's block count, raised on this mix; the new one runs it, and the
    streams equal the gather path's."""
    from paddle_tpu_torch.serving import engine as engine_mod
    _, tm = models
    kw = dict(max_batch=3, max_blocks=10, block_size=4, prefill_chunk=8,
              device="cpu")
    want = _shared_prefix_decode(ServingEngine(tm, attn_impl="gather",
                                               **kw))
    longest = []

    def recording(*a, **k):
        ssq, sbk = build(*a, **k)
        longest.append(int((ssq < k["max_seqs"]).sum(axis=1).max()))
        return ssq, sbk
    build = engine_mod.build_step_maps
    monkeypatch.setattr(engine_mod, "build_step_maps", recording)
    eng = ServingEngine(tm, **kw)
    assert eng._max_steps == 3 * 10
    assert _shared_prefix_decode(eng) == want
    assert eng.stats()["prefix_cache"]["hits"] >= 2
    assert max(longest) == 21  # more pages than the pool holds

    def capped_at_pool(tile_q, max_blocks_per_seq, max_batch):
        return max(1, min(tile_q * max_blocks_per_seq, kw["max_blocks"]))
    monkeypatch.setattr(engine_mod, "rpa_max_steps", capped_at_pool)
    with pytest.raises(ValueError, match="kv steps > max_steps 10"):
        _shared_prefix_decode(ServingEngine(tm, **kw))


# -------------------- sampling and prompt ids at the edges ------------------
def _surviving(monkeypatch, logits, top_k, top_p):
    """The tokens each row may draw after top-k and nucleus filtering, in
    the reference (the logits it hands ``jax.random.categorical``) and in
    the port (the probabilities it hands ``torch.multinomial``)."""
    import jax
    import jax.numpy as jnp
    import torch
    from paddle_tpu.models import generation as jgen
    from paddle_tpu_torch.models import generation as tgen
    seen = {}

    def jax_draw(key, sl):
        seen["jax"] = np.isfinite(np.asarray(sl))
        return jnp.argmax(sl, -1)

    def torch_draw(probs, n, generator=None):
        seen["port"] = probs.numpy() > 0
        return torch.argmax(probs, -1, keepdim=True)
    monkeypatch.setattr(jax.random, "categorical", jax_draw)
    monkeypatch.setattr(torch, "multinomial", torch_draw)
    jgen.sample_token(jnp.asarray(logits), 1.0, top_k, top_p,
                      key=jax.random.PRNGKey(0))
    tgen.sample_token(torch.from_numpy(logits), 1.0, top_k, top_p,
                      generator=torch.Generator().manual_seed(0))
    return seen["jax"], seen["port"]


@pytest.mark.parametrize("top_k,top_p", [
    (101, 1.0), (0, 0.9999999), (0, 0.99999999), (101, 0.99999999),
    (5, 0.9)])
def test_sampling_filters_as_the_reference(monkeypatch, top_k, top_p):
    """A top_k above V (101 on V = 100) and a top_p that the f32
    cumulative sum may never reach leave the logits unfiltered, as the
    reference's clamped indexing does; the port raised on both. Over
    many seeded rows the tokens that may be drawn are the reference's,
    up to the f32 rounding of the two frameworks' cumulative sums near
    top_p: the tokens where they part carry under 1e-6 of a row's
    probability."""
    logits = 4 * np.random.RandomState(7).randn(256, 100).astype(np.float32)
    want, got = _surviving(monkeypatch, logits, top_k, top_p)
    p = np.exp(logits.astype(np.float64))
    p /= p.sum(axis=1, keepdims=True)
    assert (p * (got != want)).sum(axis=1).max() < 1e-6
    assert (got == want).mean() > 0.95
    if top_k == 101 and top_p == 1.0:
        assert got.all() and want.all()


def test_out_of_vocabulary_prompt_ids_are_refused(models):
    """An id < 0 or >= vocab_size is refused at submit, before it reaches
    the embedding lookup (a device-side assert on the card, which ends
    every request; the reference's lookup gives NaN rows instead), and
    the engine serves the next request."""
    _, tm = models
    kw = dict(max_batch=2, max_blocks=24, block_size=4, prefill_chunk=4)
    eng = ServingEngine(tm, device="cpu", **kw)
    vocab = tm.cfg.vocab_size
    for ids in ([1, vocab], [-1, 5], [vocab + 7]):
        with pytest.raises(ValueError, match="prompt ids"):
            eng.submit(ids, max_new_tokens=2)
    assert _serve(eng, [[1, vocab - 1, 3]], 2) == \
        _serve(ServingEngine(tm, device="cpu", **kw), [[1, vocab - 1, 3]], 2)
    with Server(ServingEngine(tm, device="cpu", **kw)) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url + "/generate", {"prompt_ids": [5, vocab],
                                          "max_new_tokens": 2})
        assert e.value.code == 400 and b"prompt ids" in e.value.read()
        status, raw = _post(srv.url + "/generate", {"prompt_ids": [5, 6],
                                                    "max_new_tokens": 2})
        assert status == 200 and len(json.loads(raw)["token_ids"]) == 2


def test_paged_kv_cache_runs_on_the_card_unless_asked(monkeypatch):
    """``PagedKVCache`` resolves its device as every entry point does:
    with no card the default (``cuda``) raises instead of building its
    pools on the CPU, and ``device="cpu"`` builds them there."""
    import torch

    from paddle_tpu_torch.serving.kv_cache import PagedKVCache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(num_layers=1, num_blocks=4, block_size=4,
                     num_kv_heads=2, head_dim=8)
    cache = PagedKVCache(num_layers=2, num_blocks=4, block_size=4,
                         num_kv_heads=2, head_dim=8, device="cpu")
    assert [p.device.type for p in cache.k_pools + cache.v_pools] == \
        ["cpu"] * 4
    assert cache.k_pools[0].shape == (5, 4, 2, 8)
