"""The port's numerics tap seam and calibration sketches against
``paddle_tpu/observability/numerics.py``: a tap is the identity and does
nothing while nothing collects; inside ``collect`` the bridged Llama
taps the reference's names in the reference's order (a second forward
deduplicated as ``#2``, recompute regions suppressed and tapped at their
output) with the reference's statistics; the sketches accumulate, merge
and round-trip through ``calibration_summary``/``load_summary``, and
``record_sample`` feeds them."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.observability import numerics as jnum
from paddle_tpu_torch.observability import numerics
from paddle_tpu_torch.observability.metrics import MetricsRegistry

from test_torch_bridge import bridged, jax_tiny, one_torch_thread  # noqa: F401

# the statistics are f32 reductions of the same activations, which the two
# frameworks compute with sums in other orders
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _collect_jax(jm, ids, calls=1):
    with jnum.collect(True) as col:
        for _ in range(calls):
            jm(pt.to_tensor(ids))
    return {k: tuple(float(np.asarray(s)) for s in v)
            for k, v in col.taps.items()}


def _collect_port(tm, ids, calls=1):
    with torch.no_grad(), numerics.collect(True) as col:
        for _ in range(calls):
            tm(torch.from_numpy(ids))
    return {k: tuple(float(s) for s in v) for k, v in col.taps.items()}


def _assert_same_taps(got, want):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **STAT_TOL)


def test_a_tap_is_the_identity_and_idle_when_nothing_collects(
        monkeypatch):
    """Disarmed, ``tap`` hands back the very object and computes nothing
    (``_stats`` is never reached), ``scope`` pushes no name, and the
    model's output is the one a collected run gives."""
    def boom(x):
        raise AssertionError("a tap computed statistics while disarmed")
    monkeypatch.setattr(numerics, "_stats", boom)
    t = torch.randn(3)
    assert numerics._active is None and numerics.tap("x", t) is t
    with numerics.scope("layers.0"):
        assert numerics._stack == []
    tm = bridged(jax_tiny(1))
    ids = np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.int32)
    with torch.no_grad():
        plain = tm(torch.from_numpy(ids))
    monkeypatch.undo()
    with torch.no_grad(), numerics.collect(True) as col:
        tapped = tm(torch.from_numpy(ids))
    assert col.taps and torch.equal(plain, tapped)
    with numerics.collect(False) as off:
        assert numerics._active is None
        numerics.tap("x", t)
    assert off.taps == {}


@pytest.mark.parametrize("calls", [1, 2])
def test_collect_gives_the_reference_taps(calls):
    """The cacheless forward of the bridged Llama: ``embed``, per layer
    ``attn``, ``mlp_act``, ``mlp`` and ``resid`` under ``layers.{i}``,
    ``final_norm`` and ``logits``, in the reference's order; a second
    forward inside the same collection is named ``...#2``. Each tap's
    (absmax, mean, rms, non-finite count) equals the reference's."""
    jm = jax_tiny(2)
    tm = bridged(jm)
    ids = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(np.int32)
    want = _collect_jax(jm, ids, calls)
    got = _collect_port(tm, ids, calls)
    _assert_same_taps(got, want)
    assert list(got)[:6] == ["embed", "layers.0.attn", "layers.0.mlp_act",
                             "layers.0.mlp", "layers.0.resid",
                             "layers.1.attn"]
    if calls == 2:
        assert "layers.1.mlp_act#2" in got and "logits#2" in got


def test_recompute_regions_are_suppressed_and_tapped_at_their_output():
    """With ``cfg.recompute`` in training mode each decoder layer runs
    under recompute: its inner taps are suppressed and its output is
    tapped as ``layers.{i}.resid``, as in the reference."""
    jm = jax_tiny(3, recompute=True)
    jm.train()
    tm = bridged(jm)
    tm.train()
    ids = np.random.RandomState(2).randint(0, 256, (2, 8)).astype(np.int32)
    with jnum.collect(True) as jcol:
        jm(pt.to_tensor(ids))
    with numerics.collect(True) as col:
        tm(torch.from_numpy(ids))
    assert list(col.taps) == list(jcol.taps) == [
        "embed", "layers.0.resid", "layers.1.resid", "final_norm",
        "logits"]
    assert numerics._suppress == 0 and numerics._stack == []


def test_serving_path_taps_the_same_seams():
    """The engine's paged path goes through the same seams (the names of
    one step equal the cacheless forward's up to the logits head, which
    the engine computes itself)."""
    from paddle_tpu_torch.serving import ServingEngine
    tm = bridged(jax_tiny(4))
    eng = ServingEngine(tm, device="cpu", max_batch=2, max_blocks=8,
                        block_size=4, prefill_chunk=4)
    eng.submit([1, 2, 3], max_new_tokens=1)
    with numerics.collect(True) as col:
        eng.step()
    ids = np.ones((1, 3), np.int32)
    assert list(col.taps) == list(_collect_port(tm, ids))[:-1]


def test_sketch_accumulates_and_merges():
    """The reference's sketch case (``tests/test_numerics.py:303``), and
    the same numbers from the reference's own sketch."""
    for mod in (numerics, jnum):
        sk = mod._Sketch()
        for v in (0.5, 1.5, 3.0, 100.0):
            sk.add(v)
        s = sk.summary()
        assert s["n"] == 4 and s["absmax"] == 100.0
        assert s["p99"] >= 100.0  # the bucket's upper edge covers the max
        other = mod._Sketch()
        other.merge(s)
        other.add(200.0)
        assert other.absmax == 200.0 and other.summary()["n"] == 5
    ours, ref = numerics._Sketch(), jnum._Sketch()
    for v in (0.0, 1e-3, 0.7, 2.0, 2.5, 9.0, float("inf")):
        ours.add(v)
        ref.add(v)
    assert ours.summary() == ref.summary()


def test_observatory_summary_round_trips():
    """``record_sample`` folds each tap's abs-max into its sketch and sets
    the gauges; ``calibration_summary`` is the reference's document, and
    ``load_summary`` of it into a fresh observatory gives it back."""
    samples = [{"taps": {"embed": (1.5, 0.1, 0.7, 0),
                         "layers.0.attn": (40.0, 0.0, 2.0, 0)}},
               {"taps": {"embed": (3.0, 0.2, 0.9, 0),
                         "layers.0.attn": (0.25, 0.0, 0.1, 1)}}]
    obs = numerics.NumericsObservatory(MetricsRegistry())
    ref = jnum.NumericsObservatory(pt.observability.MetricsRegistry())
    for step, sample in enumerate(samples, 1):
        obs.record_sample(step, sample)
        ref.record_sample(step, dict(sample, grads={}, updates={}))
    doc = obs.calibration_summary()
    assert doc == ref.calibration_summary()
    assert doc["taps"]["layers.0.attn"]["absmax"] == 40.0
    assert obs._m["absmax"].value(tap="embed") == 3.0
    assert obs._m["nonfinite"].value(tap="layers.0.attn") == 1
    fresh = numerics.NumericsObservatory(MetricsRegistry())
    fresh.load_summary(doc)
    assert fresh.calibration_summary() == doc
    assert numerics.get_observatory() is numerics.get_observatory()
