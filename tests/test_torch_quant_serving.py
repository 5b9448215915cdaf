"""Quantized serving on the port against ``paddle_tpu``
(``tests/test_quant_serving.py``'s cases, with the JAX engine as the
oracle): the ``int8_wo`` engine and the int8-KV engine give the JAX
engine's greedy streams exactly, on weights moved through the bridge;
both ``load_weights`` dtype guards hold; int8 KV serves twice the batch
inside the f32 engine's pool bytes (counted from the cache's own
tensors); and the copy-on-write block copy carries the scale pools, so a
prefix hit on an int8 cache still answers as the JAX engine does.
"""
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.framework import save
from paddle_tpu_torch.quantization.weight_only import QuantizedLeaf
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.utils.bridge import numpy_state

from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401

KW = dict(max_batch=4, max_blocks=32, block_size=4, prefill_chunk=4)


def _tiny(seed):
    """The reference test's ``_tiny``: vocab 128, hidden 64, 2 layers,
    4/2 heads, tied embeddings."""
    return jax_tiny(seed, vocab_size=128, tie_word_embeddings=True)


def _streams(engine, prompts, n):
    handles = [engine.submit(list(p), max_new_tokens=n) for p in prompts]
    engine.run_until_idle()
    out = [h.result(30)["token_ids"] for h in handles]
    engine.cache.allocator.assert_no_leaks()
    return out


def _jax_engine(jm, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # int8 KV: rpa -> gather warning
        return JaxEngine(jm, **kw)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 128, n)) for n in lens]


def test_int8_weight_engine_streams_equal_jax():
    """``quantize="int8_wo"``: the port's engine (RPA and gather read
    paths) gives the JAX int8 engine's greedy streams; the projections
    hold int8 values and no weight parameter, the tied embedding stays."""
    jm = _tiny(1)
    prompts = _prompts(0, (12, 5, 9))
    ref = _streams(_jax_engine(jm, quantize="int8_wo", **KW), prompts, 8)
    for impl in ("rpa", "gather"):
        tm = bridged(jm)
        eng = ServingEngine(tm, device="cpu", quantize="int8_wo",
                            attn_impl=impl, **KW)
        assert _streams(eng, prompts, 8) == ref, impl
        st = eng.stats()
        assert st["weight_dtype"] == "int8" and st["quantize"] == "int8_wo"
        names = {n for n, _ in tm.named_parameters()}
        assert "model.layers.0.self_attn.q_proj.weight" not in names
        assert "model.embed_tokens.weight" in names
        leaf = eng._qleaves["model.layers.1.mlp.down_proj.weight"]
        assert leaf.q.dtype == torch.int8 and leaf.dtype == torch.float32


def test_int8_kv_engine_streams_equal_jax():
    """``kv_dtype="int8"``: int8 pools with f32 scale pools, read through
    the gather path (pinned with the reference's warning); greedy streams
    equal the JAX int8-KV engine's, across a multi-chunk prefill."""
    jm = _tiny(2)
    prompts = _prompts(1, (10, 13, 3))
    ref = _streams(_jax_engine(jm, kv_dtype="int8", **KW), prompts, 6)
    with pytest.warns(RuntimeWarning, match="gather"):
        eng = ServingEngine(bridged(jm), device="cpu", kv_dtype="int8",
                            **KW)
    assert eng.attn_impl == "gather"
    assert eng.stats()["kv_dtype"] == "int8"
    assert eng.cache.k_pools[0].dtype == torch.int8
    assert eng.cache.k_scales[0].shape == (33, 4, 2)
    assert _streams(eng, prompts, 6) == ref


def test_int8_kv_copy_block_carries_the_scales():
    """The prefix cache's copy-on-write on an int8 cache: a fully cached,
    block-aligned prompt copies its last matched block into a private
    one, and the scales must come with the values, or the copy
    dequantizes to garbage only after a prefix hit. The free blocks'
    scale rows are filled with garbage before the hit (a correct engine
    never reads a free block); the hit's stream equals the JAX int8-KV
    engine's (which copies both), and the copied block's scales equal
    its source's."""
    jm = jax_tiny(3)
    rng = np.random.RandomState(3)
    prefix = list(rng.randint(1, 128, 12))
    prompts = [prefix + list(rng.randint(1, 128, 3)), list(prefix)]
    kw = dict(KW, prefill_chunk=8)
    ref_engine = _jax_engine(jm, kv_dtype="int8", **kw)
    ref = [_streams(ref_engine, [p], 5)[0] for p in prompts]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServingEngine(bridged(jm), device="cpu", kv_dtype="int8",
                            **kw)
    copies = []
    copy_block = eng.cache.copy_block

    def record(src, dst):
        copy_block(src, dst)
        copies.append((src, dst))
    eng.cache.copy_block = record
    got = [_streams(eng, [prompts[0]], 5)[0]]
    free = torch.tensor(eng.cache.allocator._free, dtype=torch.long)
    for pool in eng.cache.k_scales + eng.cache.v_scales:
        pool[free] = 1e3
    got.append(_streams(eng, [prompts[1]], 5)[0])
    assert got == ref
    assert eng.stats()["prefix_cache"]["hits"] >= 1 and len(copies) == 1
    src, dst = copies[0]
    for pools in (eng.cache.k_scales, eng.cache.v_scales):
        assert all(torch.equal(p[dst], p[src]) for p in pools)
        assert 0 < float(pools[0][src].abs().max()) < 1e3


def _save_state(state, path):
    save({k: torch.from_numpy(v) for k, v in state.items()}, str(path))
    return str(path)


def test_load_weights_dtype_guard(tmp_path):
    """A floating mismatch is cast loudly (a ``RuntimeWarning`` naming the
    leaf) and the engine keeps serving the JAX engine's stream; an
    integer leaf is refused with a ``ValueError`` naming it."""
    jm = _tiny(4)
    tm = bridged(jm)
    eng = ServingEngine(tm, device="cpu", max_batch=2, max_blocks=16,
                        block_size=4, prefill_chunk=4)
    sd = numpy_state(tm)
    victim = next(k for k in sd if k.endswith("q_proj.weight"))
    p64 = _save_state(dict(sd, **{victim: sd[victim].astype(np.float64)}),
                      tmp_path / "cast.pdparams")
    with pytest.warns(RuntimeWarning, match=victim):
        eng.load_weights(p64)
    prompt = [3, 5, 7, 11]
    ref = _streams(_jax_engine(jm, max_batch=2, max_blocks=16,
                               block_size=4, prefill_chunk=4), [prompt], 4)
    assert _streams(eng, [prompt], 4) == ref
    pbad = _save_state(dict(sd, **{victim: np.zeros(sd[victim].shape,
                                                    np.int32)}),
                       tmp_path / "refuse.pdparams")
    with pytest.raises(ValueError, match=victim):
        eng.load_weights(pbad)


def test_load_weights_dtype_guard_quantized_logical(tmp_path):
    """The guard reads a quantized leaf's LOGICAL dtype: an f32 checkpoint
    loads into an int8 engine and is quantized again (weights doubled:
    the scales double, the int8 values stay), and a float64 leaf is cast
    loudly with its name;
    after reloading the original weights the engine serves the JAX int8
    engine's stream."""
    jm = _tiny(5)
    tm = bridged(jm)
    sd = numpy_state(tm)
    eng = ServingEngine(tm, device="cpu", max_batch=2, max_blocks=16,
                        block_size=4, prefill_chunk=4, quantize="int8_wo")
    key = "model.layers.0.mlp.up_proj.weight"
    before = eng._qleaves[key].q.clone()
    before_scale = eng._qleaves[key].scale.clone()
    scaled = _save_state({k: v * 2 if k == key else v
                          for k, v in sd.items()}, tmp_path / "ok.pdparams")
    eng.load_weights(scaled)
    leaf = eng._qleaves[key]
    assert isinstance(leaf, QuantizedLeaf) and leaf.q.dtype == torch.int8
    assert torch.equal(leaf.q, before)  # the grid scales with the weight
    assert torch.equal(leaf.scale, 2 * before_scale)
    assert tm.get_submodule("model.layers.0.mlp.up_proj")._wq is leaf
    bad = _save_state(dict(sd, **{key: sd[key].astype(np.float64)}),
                      tmp_path / "bad.pdparams")
    with pytest.warns(RuntimeWarning, match=key):
        eng.load_weights(bad)
    prompt = [9, 2, 6, 4, 1]
    ref = _streams(_jax_engine(jm, max_batch=2, max_blocks=16,
                               block_size=4, prefill_chunk=4,
                               quantize="int8_wo"), [prompt], 4)
    assert _streams(eng, [prompt], 4) == ref


def test_int8_kv_doubles_max_batch_within_pool_bytes():
    """int8 KV (values + scale pools) at twice the batch and twice the
    blocks fits inside the f32 engine's pool bytes, counted from each
    cache's own tensors, and serves that doubled batch with the JAX
    int8-KV engine's streams."""
    jm = _tiny(6)
    base_kw = dict(max_batch=2, max_blocks=16, block_size=4,
                   prefill_chunk=4)
    base = ServingEngine(bridged(jm), device="cpu", **base_kw)
    base_bytes = base.cache.pool_bytes()
    assert base_bytes == sum(p.numel() * 4 for p in
                             base.cache.k_pools + base.cache.v_pools)
    dbl_kw = dict(base_kw, max_batch=4, max_blocks=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dbl = ServingEngine(bridged(jm), device="cpu", kv_dtype="int8",
                            **dbl_kw)
    assert dbl.cache.pool_bytes() <= base_bytes, \
        (dbl.cache.pool_bytes(), base_bytes)
    prompts = _prompts(2, (6, 6, 6, 6))
    ref = _streams(_jax_engine(jm, kv_dtype="int8", **dbl_kw), prompts, 3)
    assert _streams(dbl, prompts, 3) == ref


def test_the_reference_env_knobs_are_not_read(monkeypatch):
    """The reference reads ``PADDLE_TPU_QUANT_WEIGHTS``,
    ``PADDLE_TPU_QUANT_KV``, ``PADDLE_TPU_LORA_SLOTS`` and
    ``PADDLE_TPU_QUANT_OUTLIER_RATIO``; the port reads none of them (the
    arguments carry them, as ``PADDLE_TPU_PREFIX_CACHE``'s did)."""
    from paddle_tpu_torch import tuning
    from paddle_tpu_torch.quantization.weight_only import sensitive_params
    for k, v in (("PADDLE_TPU_QUANT_WEIGHTS", "int8_wo"),
                 ("PADDLE_TPU_QUANT_KV", "int8"),
                 ("PADDLE_TPU_LORA_SLOTS", "3"),
                 ("PADDLE_TPU_QUANT_OUTLIER_RATIO", "1.0")):
        monkeypatch.setenv(k, v)
    tm = bridged(_tiny(7))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = ServingEngine(tm, device="cpu", **KW)
    assert eng.quantize is None and eng.kv_dtype is None
    assert eng.attn_impl == "rpa" and eng.cache.k_pools[0].dtype == \
        torch.float32
    tuning.apply_lora(tm, tuning.LoRAConfig(rank=2))
    assert tm._lora_slots == 0 and tm.model.layers[0].self_attn.q_proj \
        .lora_A.dim() == 2
    cal = {"taps": {"layers.0.attn": {"absmax": 8.0, "p99": 1.0}}}
    assert sensitive_params(["model.layers.0.self_attn.q_proj.weight"],
                            cal) == set()
