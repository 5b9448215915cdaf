"""The port's kernel autotuner (``ops/pallas/autotune.py``) and its two
hooks, ``rpa_tile_q`` (the serving engine's q tile) and
``fused_ce._auto_chunks``, on the CPU: with ``FLAGS_use_autotune`` off
every hook returns its default, sweeps nothing and reads no cache; for
CPU tensors the hooks return their defaults with the flag on; a sweep
keeps the least time, the default on a tie, and serves the cached winner
afterwards, counting hits and misses; ``PADDLE_AUTOTUNE_CACHE`` is not
read (the cache file is an argument); and with the flag off every
engine's geometry is what it was before the autotuner: ``step_tokens``
the budget rounded up to ``DEFAULT_TILE_Q``. The sweep itself times
kernels on the card (``tests/test_torch_kernels.py``)."""
import json

import pytest
import torch

from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.models import MoeConfig, MoeForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.ops.pallas import autotune as at
from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import ServingEngine

from test_torch_bridge import one_torch_thread  # noqa: F401

KW = dict(max_batch=4, max_blocks=32, block_size=4, prefill_chunk=4)


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test starts with the flag off and an empty cache, and leaves
    them so."""
    at.AutoTuneCache.instance().clear()
    yield
    set_flags({"FLAGS_use_autotune": False})
    at.AutoTuneCache.instance().clear()


def _timed(built):
    """A ``build`` whose runner is the candidate itself, so the patched
    ``measure_ms`` reads its time from the table; ``built`` records each
    build."""
    def build(c):
        built.append(c)
        return c
    return build


@pytest.fixture
def fake_clock(monkeypatch):
    """``measure_ms`` reads a candidate's time from a table instead of
    the card."""
    table = {}
    monkeypatch.setattr(at, "measure_ms", lambda fn: table[fn])
    return table


def test_flag_off_returns_the_default_and_sweeps_nothing(fake_clock):
    assert get_flags("FLAGS_use_autotune") == {"FLAGS_use_autotune": False}
    built = []
    fake_clock.update({8: 1.0, 16: 0.5})
    got = at.autotune("op", (1,), [8, 16], _timed(built), 8)
    assert got == 8 and built == []
    assert at.AutoTuneCache.instance().stats()["misses"] == 0
    assert rpa.rpa_tile_q(12, 4, 2, 64, 16, 8, 64) == rpa.DEFAULT_TILE_Q
    assert fused_ce._auto_chunks(16, 64, 8, torch.float32, "cuda") == 8


def test_sweep_keeps_the_least_time_the_default_on_a_tie_and_counts(
        fake_clock):
    set_flags({"FLAGS_use_autotune": True})
    cache = at.AutoTuneCache.instance()
    built = []
    fake_clock.update({8: 2.0, 16: 1.0, 32: 1.5})
    assert at.autotune("op", (1,), [8, 16, 32],
                       _timed(built), 8) == 16
    assert built == [8, 16, 32]
    # a second call with the same signature is a hit: nothing is built
    assert at.autotune("op", (1,), [8, 16, 32],
                       _timed(built), 8) == 16
    assert built == [8, 16, 32]
    assert cache.stats() == {"size": 1, "hits": 1, "misses": 1,
                             "hit_rate": 0.5}
    # a tie keeps the default, whichever order the candidates come in
    fake_clock.update({8: 1.0, 16: 1.0, 32: 1.0})
    assert at.autotune("op", (2,), [32, 16, 8],
                       _timed(built), 8) == 8
    assert at.autotune("op", (3,), [16, 32], _timed(built),
                       8) == 16


def test_cpu_tensors_take_the_defaults_with_the_flag_on(monkeypatch):
    set_flags({"FLAGS_use_autotune": True})
    monkeypatch.setattr(at, "autotune",
                        lambda *a, **k: pytest.fail("swept on the CPU"))
    assert rpa.rpa_tile_q(12, 4, 2, 64, 16, 8, 64, device="cpu") == 8
    assert fused_ce._auto_chunks(16, 64, 8, torch.float32, "cpu") == 8
    for model in (LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"),
                  MoeForCausalLM(MoeConfig.tiny(), device="cpu")):
        eng = ServingEngine(model, device="cpu", **KW)
        assert eng._tile_q == rpa.DEFAULT_TILE_Q
    h = torch.randn(6, 8, requires_grad=True)
    w = torch.randn(64, 8, requires_grad=True)
    fused_ce.matmul_cross_entropy(h, w, torch.arange(6)).sum().backward()


def test_rpa_tile_q_sweeps_the_tiles_the_kernel_takes(monkeypatch):
    """On the card the hook hands the autotuner the reference's
    signature and the candidates of ``(8, 16, 32)`` whose rows, tile x
    GQA group, fit the kernel's 128."""
    set_flags({"FLAGS_use_autotune": True})
    seen = []

    def fake(op, sig, cands, build, default):
        seen.append((op, sig, list(cands), default))
        return cands[-1]
    monkeypatch.setattr(at, "autotune", fake)
    assert rpa.rpa_tile_q(520, 32, 8, 128, 16, 512, 2048,
                          dtype="bfloat16") == 32
    assert rpa.rpa_tile_q(520, 16, 16, 128, 16, 512, 2048,
                          dtype="bfloat16", device="cuda", default=16) == 32
    assert rpa.rpa_tile_q(520, 32, 2, 128, 16, 512, 2048) == 8
    assert seen[0] == ("ragged_paged_attention",
                       (520, 32, 8, 128, 16, 512, 2048, "bfloat16"),
                       [8, 16, 32], 8)
    assert seen[1][2:] == ([8, 16, 32], 16)
    assert seen[2][2] == [8]  # group 16: 8 x 16 = 128 rows


def test_auto_chunks_sweeps_the_counts_that_divide_v(monkeypatch):
    set_flags({"FLAGS_use_autotune": True})
    seen = []

    def fake(op, sig, cands, build, default):
        seen.append((op, sig, cands, default))
        return default
    monkeypatch.setattr(at, "autotune", fake)
    fused_ce._auto_chunks(4096, 1000, 64, torch.bfloat16, "cuda")
    assert seen == [("fused_ce_chunks", (4096, 1000, 64, "torch.bfloat16"),
                     [4, 8], 8)]


def test_the_reference_env_knob_is_not_read(fake_clock, tmp_path,
                                            monkeypatch):
    """A winner in a file named by ``PADDLE_AUTOTUNE_CACHE`` is neither
    read nor written: the sweep runs and picks by time. ``save`` and
    ``load`` carry the winners through a file the caller names, in the
    reference's layout."""
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({json.dumps(["op", 1]): 32}))
    monkeypatch.setenv("PADDLE_AUTOTUNE_CACHE", str(path))
    at.AutoTuneCache._instance = None  # a fresh process's cache
    set_flags({"FLAGS_use_autotune": True})
    built = []
    fake_clock.update({8: 2.0, 16: 1.0, 32: 3.0})
    assert at.autotune("op", (1,), [8, 16, 32],
                       _timed(built), 8) == 16
    assert json.loads(path.read_text()) == {json.dumps(["op", 1]): 32}
    cache = at.AutoTuneCache.instance()
    out = tmp_path / "mine.json"
    cache.save(str(out))
    fresh = at.AutoTuneCache()
    fresh.load(str(out))
    assert fresh.lookup(("op", 1)) == 16
    fresh.load(str(path))  # an entry already held stays
    assert fresh.lookup(("op", 1)) == 16


@pytest.mark.parametrize("family", ["llama", "moe"])
@pytest.mark.parametrize("mb,chunk", [(4, 4), (8, 512), (3, 7)])
def test_flag_off_keeps_every_engine_geometry(family, mb, chunk):
    """``step_tokens`` is the budget rounded up to ``DEFAULT_TILE_Q`` and
    the tile is the default, on the RPA and the gather path."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu") \
        if family == "llama" else MoeForCausalLM(MoeConfig.tiny(),
                                                 device="cpu")
    for impl in ("rpa", "gather"):
        eng = ServingEngine(model, device="cpu", attn_impl=impl,
                            **dict(KW, max_batch=mb, prefill_chunk=chunk))
        assert eng._tile_q == rpa.DEFAULT_TILE_Q == 8
        assert eng.step_tokens == -(-(mb + chunk) // 8) * 8
