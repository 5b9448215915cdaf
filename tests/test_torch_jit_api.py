"""``paddle.jit``'s ``to_static`` and functional trio of the port
(``jit/api.py``, ``jit/functional.py``) held against the JAX package:
``tests/test_jit.py``'s ``TestFunctionalCall`` and ``TestToStatic``
(:22-97) one for one, on twin layers with the same weights, plus the
reference's guard against a mistyped name (:221). On the CPU a
``StaticFunction`` runs eagerly under the reference's cache; its CUDA
graphs are held against eager calls on the card
(``tests/test_torch_kernels.py``)."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import on_cpu  # noqa: F401


def _mlp(pkg, seed=0):
    pkg.seed(seed)
    nn = pkg.nn
    return nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))


def _twins(seed=0):
    """The reference's ``_mlp`` and the port's, with its weights."""
    j = _mlp(pt, seed)
    t = _mlp(ptt, seed)
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})
    return j, t


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class TestFunctionalCall:
    def test_matches_direct_and_is_pure(self):
        j, t = _twins()
        x = _x(4, 8)
        direct = t(ptt.to_tensor(x)).numpy()
        np.testing.assert_allclose(direct, j(pt.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)
        params = dict(t.state_dict())
        out = ptt.jit.functional_call(t, params, ptt.to_tensor(x))
        assert type(out) is ptt.Tensor
        np.testing.assert_allclose(out.numpy(), direct, rtol=1e-6)
        # other weights give another output; the storage is untouched
        zeroed = {k: np.zeros(tuple(v.shape), np.float32)
                  for k, v in params.items()}
        out0 = ptt.jit.functional_call(t, zeroed, ptt.to_tensor(x))
        ref0 = pt.jit.functional_call(
            j, {k: np.zeros(tuple(v.shape), np.float32)
                for k, v in j.state_dict().items()}, pt.to_tensor(x))
        np.testing.assert_allclose(out0.numpy(), ref0.numpy())
        assert not np.allclose(out0.numpy(), direct)
        np.testing.assert_allclose(t(ptt.to_tensor(x)).numpy(), direct,
                                   rtol=1e-6)

    def test_functional_state_splits_as_the_reference(self):
        j, t = _twins()
        t[0].weight.stop_gradient = True
        j[0].weight.stop_gradient = True
        got = [sorted(d) for d in ptt.jit.functional_state(t)]
        want = [sorted(d) for d in pt.jit.functional_state(j)]
        assert got == want

    def test_swap_state_typo_does_not_corrupt(self):
        _, t = _twins()
        before = t[0].weight.numpy().copy()
        with pytest.raises(KeyError):
            ptt.jit.functional_call(
                t, {"0.weight": np.zeros((8, 32), np.float32),
                    "bogus": np.zeros(3, np.float32)},
                ptt.to_tensor(np.zeros((2, 8), np.float32)))
        with pytest.raises(KeyError):
            with ptt.jit.swap_state(t, {"0.weight": np.zeros((8, 32)),
                                        "bogus": np.zeros(3)}):
                pass
        np.testing.assert_allclose(t[0].weight.numpy(), before)

    def test_swap_state_collects_buffers_and_restores(self):
        bn = ptt.nn.BatchNorm1D(6)
        bn.train()
        mean = bn._mean
        vals = {"_mean": np.full(6, 3.0, np.float32)}
        x = ptt.to_tensor(_x(16, 6))
        with ptt.jit.swap_state(bn, vals) as out:
            bn(x)
        assert bn._mean is mean and float(mean.abs().sum()) == 0.0
        assert not np.allclose(out["_mean"].numpy(), 3.0)


class TestToStatic:
    def test_layer_parity(self):
        j, t = _twins()
        x = _x(4, 8)
        ref = pt.jit.to_static(j)(pt.to_tensor(x)).numpy()
        out = ptt.jit.to_static(t)(ptt.to_tensor(x))
        assert type(out) is ptt.Tensor and not out.requires_grad
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)

    def test_sees_param_updates_without_retrace(self):
        _, t = _twins()
        x = ptt.to_tensor(_x(4, 8))
        sm = ptt.jit.to_static(t)
        out1 = sm(x).numpy()
        n_compiled = len(sm.code_cache)
        t[0].weight.set_value(t[0].weight.numpy() * 2.0)
        out2 = sm(x).numpy()
        assert not np.allclose(out1, out2)
        assert len(sm.code_cache) == n_compiled  # no retrace

    def test_cache_per_shape(self):
        j, t = _twins()
        sj, st = pt.jit.to_static(j), ptt.jit.to_static(t)
        for n in (2, 2, 5):
            sj(pt.to_tensor(np.zeros((n, 8), np.float32)))
            st(ptt.to_tensor(np.zeros((n, 8), np.float32)))
            assert len(st.code_cache) == len(sj.code_cache)
        assert len(st.code_cache) == 2
        t.eval()  # training is part of the key
        st(ptt.to_tensor(np.zeros((2, 8), np.float32)))
        assert len(st.code_cache) == 3

    def test_plain_function(self):
        @ptt.jit.to_static
        def f(a, b):
            return ptt.matmul(a, b) + 1.0
        a, b = _x(3, 4), _x(4, 2, seed=1)
        np.testing.assert_allclose(
            f(ptt.to_tensor(a), ptt.to_tensor(b)).numpy(), a @ b + 1.0,
            rtol=1e-5)
        assert len(f.code_cache) == 1

    def test_batchnorm_buffers_update_under_jit(self):
        j = pt.nn.Sequential(pt.nn.Linear(4, 6), pt.nn.BatchNorm1D(6))
        t = ptt.nn.Sequential(ptt.nn.Linear(4, 6), ptt.nn.BatchNorm1D(6))
        t.set_state_dict({k: np.asarray(v.numpy())
                          for k, v in j.state_dict().items()})
        j.train()
        t.train()
        x = _x(16, 4) * 3 + 2
        before = t[1]._mean.numpy().copy()
        pt.jit.to_static(j)(pt.to_tensor(x))
        ptt.jit.to_static(t)(ptt.to_tensor(x))
        after = t[1]._mean.numpy()
        assert not np.allclose(before, after)
        assert np.isfinite(after).all()
        np.testing.assert_allclose(after, j[1]._mean.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(t[1]._variance.numpy(),
                                   j[1]._variance.numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_dropout_varies_across_calls(self):
        m = ptt.nn.Dropout(0.5)
        m.train()
        sm = ptt.jit.to_static(m)
        x = ptt.to_tensor(np.ones((32, 32), np.float32))
        y1 = sm(x).numpy()
        y2 = sm(x).numpy()
        assert (y1 == 0).any()
        assert not np.array_equal(y1, y2)

    def test_markers_are_the_identity(self):
        def f(a):
            return a
        assert ptt.jit.not_to_static(f) is f
        assert ptt.jit.not_to_static()(f) is f
        assert ptt.jit.ignore_module([np]) is None
        assert ptt.jit.to_static()(f).code_cache == {}
