"""The port's sequence parallelism against ``paddle_tpu``'s, on the CPU.

Gloo worlds of 2 and 4 ranks (``tests/torch_pp_worker.py``, suite
``sp``, started once for the file) run ``ring_attention`` (the composite
and the kernel path, whose kernels compute their plain versions on CPU
tensors), ``ulysses_attention`` and ``scatter_sequence`` /
``gather_sequence`` on a mesh ``{"sp": n}``, each rank on its own
sequence shard. The JAX package's ``fleet.ring_attention`` and
``ulysses_attention`` on 2 or 4 of the conftest's devices are the
oracle, at its own tests' tolerances (tests/test_sequence_parallel.py:
forward rtol 2e-4 / atol 2e-5, q/k/v gradients rtol 1e-3 / atol 1e-5).

Pinned divergences (ROADMAP §3): ``scatter_sequence`` returns this
rank's shard and ``gather_sequence`` all-gathers (the reference
annotates one global array); a GQA k/v raises ``ValueError`` (the
reference's ring fails in a reshape).
"""
import functools

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet

import torch_dist_worker as W
import torch_pp_worker as PW
from test_torch_bridge import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds():
    started = {n: W.Ranks("sp", n, script=PW.__file__) for n in WORLDS}
    yield started
    for w in started.values():
        w.close()


def port(worlds, n, case):
    return [r[case] for r in worlds[n].results()]


def _jax_mesh(n):
    return jdist.init_mesh({"sp": n}, devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def jax_attention(kind, key, n):
    """The JAX package's global output and q/k/v gradients of the mean:
    ``kind`` "ring" (``key`` = (use_flash, causal)) or "ulysses"
    (``key`` = causal), on ``n`` devices."""
    _jax_mesh(n)
    if kind == "ring":
        use_flash, causal = key
        arrs = PW.qkv(PW.RING_SHAPE[use_flash],
                      PW.ring_seed(use_flash, causal))
    else:
        causal = key
        arrs = PW.qkv(PW.ULYSSES_SHAPE, 20 + int(causal))
    q, k, v = (pt.to_tensor(a, stop_gradient=False) for a in arrs)
    if kind == "ring":
        o = jfleet.ring_attention(q, k, v, causal=causal,
                                  use_flash=use_flash)
    else:
        o = jfleet.ulysses_attention(q, k, v, causal=causal)
    o.mean().backward()
    return {name: np.asarray(t.numpy()) for name, t in
            (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}


def _check_shards(got, want, n):
    """Each rank's shards against its block of the global arrays."""
    for r, res in enumerate(got):
        for name, tol in (("o", FWD_TOL), ("dq", GRAD_TOL),
                          ("dk", GRAD_TOL), ("dv", GRAD_TOL)):
            np.testing.assert_allclose(
                res[name], np.split(want[name], n, axis=1)[r], **tol,
                err_msg=f"rank {r} {name}")


# the composite's oracle runs on 4 devices, the kernel path's on 2 (each
# compile of the reference's ring costs 5-11 s here; the global result
# does not depend on the ring's size)
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["composite", "kernel_path"])
def test_ring_attention_matches_the_reference(worlds, n, causal, use_flash):
    want = jax_attention("ring", (use_flash, causal), 2 if use_flash else 4)
    got = [res[(use_flash, causal)] for res in port(worlds, n, "ring")]
    _check_shards(got, want, n)


@pytest.mark.parametrize("n", WORLDS)
def test_auto_rule_takes_the_composite_on_cpu(worlds, n):
    """``use_flash=None`` follows the reference's rule: the kernel path
    only for CUDA tensors, so CPU shards take the composite."""
    assert all(res["auto_is_composite"] for res in port(worlds, n, "ring"))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_the_reference(worlds, n, causal):
    want = jax_attention("ulysses", causal, n)
    got = [res[causal] for res in port(worlds, n, "ulysses")]
    for r, res in enumerate(got):
        for name in ("o", "dq", "dk", "dv"):
            np.testing.assert_allclose(
                res[name], np.split(want[name], n, axis=1)[r], atol=2e-5,
                err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("n", WORLDS)
def test_scatter_gather_round_trip(worlds, n):
    """Divergence: the shard is this rank's block (the reference
    annotates the global array); the round trip is exact, as the
    reference's (tests/test_sequence_parallel.py:69), and the gradient
    of the gathered sum is the reference's, ones: the gather's backward
    keeps this rank's block of a gradient every rank holds alike."""
    x = np.random.RandomState(0).randn(2, 16, 8).astype(np.float32)
    _jax_mesh(n)
    jx = pt.to_tensor(x, stop_gradient=False)
    jg = jfleet.gather_sequence(jfleet.scatter_sequence(jx))
    np.testing.assert_array_equal(jg.numpy(), x)
    jg.sum().backward()
    want_grad = np.asarray(jx.grad.numpy())
    for r, res in enumerate(port(worlds, n, "scatter_gather")):
        np.testing.assert_array_equal(res["gathered"], x)
        np.testing.assert_array_equal(res["shard"],
                                      np.split(x, n, axis=1)[r])
        np.testing.assert_array_equal(res["grad"], want_grad)


@pytest.mark.parametrize("n", WORLDS)
def test_refusals(worlds, n):
    """No ``sp`` axis raises as the reference's (RuntimeError); a k/v
    with fewer heads raises ValueError on both paths (the reference's
    ring has no GQA); a sequence that does not divide by the ring, shards
    of unequal length, and heads that do not divide for Ulysses raise."""
    jdist.init_mesh({"dp": n}, devices=jax.devices()[:n])
    q = pt.to_tensor(np.zeros((1, 4, 4, 8), np.float32))
    with pytest.raises(RuntimeError):
        jfleet.ring_attention(q, q, q)
    for res in port(worlds, n, "sp_refusals"):
        assert res["no_axis"][0] == "RuntimeError"
        assert res["no_axis_ulysses"][0] == "RuntimeError"
        for key in ("gqa", "gqa_flash"):
            assert res[key][0] == "ValueError" and "GQA" in res[key][1]
        assert res["indivisible"][0] == "ValueError"
        assert res["uneven_shards"][0] == "ValueError"
        assert res["ulysses_heads"][0] == "ValueError"
