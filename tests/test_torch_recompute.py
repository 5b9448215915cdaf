"""``distributed.fleet.utils.recompute`` of the port held against the JAX
package: the seven cases of ``tests/test_recompute.py`` on twin layers
(outputs and every gradient against the reference's recompute on the
same weights), dropout under recompute equal to the path that keeps its
activations, and ``LlamaConfig(recompute=True)`` equal in loss and every
gradient to the reference's."""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed.fleet.utils import recompute as ref_recompute
from paddle_tpu.distributed.fleet.utils import \
    recompute_sequential as ref_sequential
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.utils import (recompute,
                                                      recompute_sequential)
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models import llama as ptl
from test_torch_bridge import (jax_value_and_grads, load_into_jax,
                               undrawn_jax_init)
from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import on_cpu  # noqa: F401


def _twins(seed=0):
    """The reference test's ``_mlp`` in both packages, same weights."""
    pt.seed(seed)
    j = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.GELU(),
                         pt.nn.Linear(16, 8), pt.nn.GELU())
    t = ptt.nn.Sequential(ptt.nn.Linear(8, 16), ptt.nn.GELU(),
                          ptt.nn.Linear(16, 8), ptt.nn.GELU())
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})
    return j, t


def _grads(model):
    return {n: np.asarray(p.grad.numpy()) for n, p in
            model.named_parameters()}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check(t_out, j_out, tm, jm):
    np.testing.assert_allclose(t_out.numpy(), j_out.numpy(), rtol=1e-5,
                               atol=1e-6)
    got, want = _grads(tm), _grads(jm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_recompute_layer_grad_parity():
    x = _x(4, 8)
    j, t = _twins()
    jo = ref_recompute(j, pt.to_tensor(x))
    pt.ops.sum(jo).backward()
    to = recompute(t, ptt.to_tensor(x))
    assert type(to) is ptt.Tensor
    ptt.sum(to).backward()
    _check(to, jo, t, j)
    # and the same as the path that keeps its activations
    _, plain = _twins()
    ptt.sum(plain(ptt.to_tensor(x))).backward()
    for k, g in _grads(plain).items():
        np.testing.assert_allclose(_grads(t)[k], g, rtol=1e-6, atol=1e-7)


def test_recompute_bound_method():
    x = _x(2, 8, seed=1)
    j, t = _twins(1)
    pt.ops.sum(ref_recompute(j.forward, pt.to_tensor(x))).backward()
    to = recompute(t.forward, ptt.to_tensor(x))
    ptt.sum(to).backward()
    for _, p in t.named_parameters():
        assert p.grad is not None
    _check(to, j(pt.to_tensor(x)), t, j)


def test_recompute_plain_function_input_grad():
    x = ptt.to_tensor(np.array([1.0, 2.0, 3.0], np.float32),
                      stop_gradient=False)
    y = recompute(lambda v: ptt.sum(ptt.multiply(v, v)), x)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * x.numpy(), rtol=1e-6)


def test_recompute_sequential_segments():
    x = _x(3, 8, seed=2)
    j, t = _twins(2)
    jo = ref_sequential({"segments": 2}, list(j), pt.to_tensor(x))
    pt.ops.sum(jo).backward()
    to = recompute_sequential({"segments": 2}, list(t), ptt.to_tensor(x))
    ptt.sum(to).backward()
    _check(to, jo, t, j)


def test_recompute_with_dropout_is_consistent():
    """The re-run draws the first run's dropout mask: the gradients equal
    those of the same step without recompute from the same seed (the
    reference's test asks for finite gradients; its XLA remat reuses the
    traced random values, which is this equality)."""
    x = _x(4, 8, seed=3)

    def run(use_recompute):
        ptt.seed(7)
        m = ptt.nn.Sequential(ptt.nn.Linear(8, 8), ptt.nn.Dropout(0.5),
                              ptt.nn.Linear(8, 4))
        out = recompute(m, ptt.to_tensor(x)) if use_recompute \
            else m(ptt.to_tensor(x))
        ptt.sum(out).backward()
        return out.numpy(), _grads(m)
    out_r, g_r = run(True)
    out_p, g_p = run(False)
    np.testing.assert_array_equal(out_r, out_p)
    for k in g_p:
        assert np.all(np.isfinite(g_r[k]))
        np.testing.assert_allclose(g_r[k], g_p[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_recompute_closure_over_layer_gets_grads():
    j, t = _twins(9)
    x = _x(2, 8, seed=9)
    pt.ops.sum(ref_recompute(lambda v: j(v), pt.to_tensor(x))).backward()
    to = recompute(lambda v: t(v), ptt.to_tensor(x))
    ptt.sum(to).backward()
    for n, p in t.named_parameters():
        assert p.grad is not None, n
        assert float(np.abs(p.grad.numpy()).sum()) > 0, n
    _check(to, j(pt.to_tensor(x)), t, j)


def test_recompute_partial_and_container_closures():
    x = ptt.to_tensor(_x(2, 8, seed=11))

    def run(layer, v):
        return layer(v)

    _, t = _twins(11)
    ptt.sum(recompute(functools.partial(run, t), x)).backward()
    for n, p in t.named_parameters():
        assert p.grad is not None, n
    _, t2 = _twins(12)
    layers = [t2]
    ptt.sum(recompute(lambda v: layers[0](v), x)).backward()
    for n, p in t2.named_parameters():
        assert p.grad is not None, n


def test_fleet_exports_recompute_and_the_strategy():
    assert fleet.recompute is recompute
    strategy = fleet.DistributedStrategy()
    assert strategy.recompute is False and strategy.recompute_configs == {}
    strategy.recompute = True
    assert strategy.recompute


@pytest.mark.parametrize("tied", [False, True])
def test_llama_recompute_matches_the_reference(tied):
    """``LlamaConfig(recompute=True)`` in training mode: the loss and
    every gradient equal the reference's recompute path on the same
    weights (the layers' tolerance; its gradients through
    ``jax_value_and_grads``, as its ``TrainStep`` takes them), and the
    port's own path without recompute."""
    cfg = ptl.LlamaConfig.tiny(tie_word_embeddings=tied, recompute=True)
    tm = ptl.LlamaForCausalLM(cfg, device="cpu", seed=4)
    with undrawn_jax_init():
        jm = JaxLlama(JaxLlamaConfig.tiny(tie_word_embeddings=tied,
                                          recompute=True))
    load_into_jax(jm, tm)
    jm.train()
    tm.train()
    ids = np.random.RandomState(4).randint(1, 256, (2, 9))
    jl, _, want, _ = jax_value_and_grads(
        jm, lambda m, x: (m(x, labels=x)[1], None), ids)
    _, tl = tm(torch.as_tensor(ids), labels=torch.as_tensor(ids))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    plain = ptl.LlamaForCausalLM(
        ptl.LlamaConfig.tiny(tie_word_embeddings=tied), device="cpu", seed=4)
    plain.train()
    _, pl = plain(torch.as_tensor(ids), labels=torch.as_tensor(ids))
    pl.backward()
    assert float(pl.detach()) == float(tl.detach())
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              plain.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
