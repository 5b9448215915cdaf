"""PP-OCRv4 recognition (``paddle_tpu_torch.models.ppocr``) and CTC
against the JAX package, on the CPU in float32: ``PPOCRRecConfig.tiny()``'s
logits, CTC loss and every gradient (the case of ``tests/test_models.py``'s
``test_ppocr_forward_and_ctc``), two ``TrainStep`` steps with the batch
norms' running statistics after them, and ``ctc_loss`` with per-sample
input lengths in every reduction.

Weights and running statistics cross through numpy (the port's seeded
ones into a reference model built without drawing its own,
``undrawn_jax_init``); inputs come from a numpy seed. The reference's
gradients come from ``jax.value_and_grad`` over its functional state
under one jit, as its ``TrainStep`` computes them
(``jax_value_and_grads``). Tolerances: rtol 1e-4, atol 1e-5 for the model (the
reference's ``tests/test_layers.py``), rtol 1e-4, atol 1e-4 for CTC (its
``tests/test_advice_fixes.py``).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.ppocr import PPOCRRecConfig as JaxConfig
from paddle_tpu.models.ppocr import PPOCRRecModel as JaxModel
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.ppocr import PPOCRRecConfig, PPOCRRecModel
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.bridge import load_numpy_state, numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import (jax_value_and_grads, load_into_jax,
                               state_dict_from_jax, undrawn_jax_init)

TOL = dict(rtol=1e-4, atol=1e-5)
CTC_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _pair(seed):
    """The port's model drawn from ``seed`` and the reference's with its
    weights and running statistics."""
    ptt.seed(seed)
    tm = PPOCRRecModel(PPOCRRecConfig.tiny(), device="cpu")
    with undrawn_jax_init():
        jm = JaxModel(JaxConfig.tiny())
    load_into_jax(jm, tm)
    return jm, tm


def _loss_and_logits(m, x, y, n):
    logits = m(x)
    return m.loss(logits, y, n), logits


def _batch(cfg, B=2, W=64, L=5):
    imgs = np.random.RandomState(4).randn(
        B, cfg.in_channels, cfg.img_height, W).astype(np.float32)
    labels = np.random.RandomState(5).randint(
        1, cfg.num_classes, (B, L)).astype(np.int64)
    return imgs, labels, np.array([5, 3], np.int64)


def test_tiny_forward_loss_and_every_gradient_match_jax():
    jm, tm = _pair(6)
    imgs, labels, lens = _batch(tm.cfg)
    jloss, jl, ref, ref_buf = jax_value_and_grads(
        jm, _loss_and_logits, imgs, labels, lens)
    tl = tm(torch.from_numpy(imgs))
    assert tuple(tl.shape) == (2, 16, tm.cfg.num_classes)
    tloss = tm.loss(tl, torch.from_numpy(labels), torch.from_numpy(lens))
    tloss.backward()
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tloss), _np(jloss), **TOL)
    ours = {n: _np(p.grad) for n, p in tm.named_parameters()}
    assert sorted(ours) == sorted(ref)
    for n in ref:
        np.testing.assert_allclose(ours[n], ref[n], err_msg=n, **TOL)
    # the training forward moved every running statistic as the
    # reference's did
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(_np(b), ref_buf[n], err_msg=n, **TOL)


def test_train_steps_and_running_stats_match_jax():
    """Two ``TrainStep`` steps (AdamW, clip 1.0) in each package: the
    losses, then every parameter and running statistic."""
    jm, tm = _pair(7)
    imgs, labels, lens = _batch(tm.cfg)
    jstep = JaxTrainStep(
        jm, lambda m, x, y, n: m.loss(m(x), y, n),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                   grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
    tstep = TrainStep(
        tm, lambda m, x, y, n: m.loss(m(x), y, n),
        AdamW(learning_rate=1e-3, parameters=tm.parameters(),
              grad_clip=tnn.ClipGradByGlobalNorm(1.0)))
    jb = [pt.to_tensor(a) for a in (imgs, labels, lens)]
    tb = [torch.from_numpy(a) for a in (imgs, labels, lens)]
    for _ in range(2):
        np.testing.assert_allclose(float(tstep(*tb)),
                                   float(_np(jstep(*jb))), rtol=1e-5)
    ref = state_dict_from_jax(jm)
    ours = numpy_state(tm)
    assert sorted(ours) == sorted(ref)
    assert sum(n.endswith(("._mean", "._variance")) for n in ours) == 14
    for n in ref:
        np.testing.assert_allclose(ours[n], ref[n], err_msg=n, **TOL)


def _ctc_case(T=12, B=3, C=6, L=4, seed=3):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, B, C)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(1, C, size=(B, L)).astype(np.int64)
    return (log_probs.astype(np.float32), labels,
            np.array([12, 7, 9], np.int64), np.array([4, 2, 3], np.int64))


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_ctc_loss_per_sample_lengths_in_every_reduction(reduction):
    """Each sample's own input length is honoured; ``mean`` is the plain
    batch mean (not PyTorch's per-label-length one); the gradient of the
    log-probabilities too."""
    lp, labels, in_len, lbl_len = _ctc_case()
    jlp = pt.to_tensor(lp, stop_gradient=False)
    jloss = JF.ctc_loss(jlp, pt.to_tensor(labels), pt.to_tensor(in_len),
                        pt.to_tensor(lbl_len), blank=0, reduction=reduction)
    tlp = torch.from_numpy(lp).requires_grad_(True)
    tloss = tnn.CTCLoss(blank=0, reduction=reduction)(
        tlp, torch.from_numpy(labels), torch.from_numpy(in_len),
        torch.from_numpy(lbl_len))
    np.testing.assert_allclose(_np(tloss), _np(jloss), **CTC_TOL)
    cot = np.asarray(np.random.RandomState(1).randn(*tloss.shape),
                     np.float32)
    (jloss * pt.to_tensor(cot)).sum().backward()
    (tloss * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(tlp.grad), _np(jlp.grad), **CTC_TOL)
    if reduction == "none":  # frames past a sample's length get no grad
        assert float(tlp.grad[7:, 1].abs().max()) == 0.0


def test_ctc_loss_computes_in_float32_and_pins_infeasible_alignments():
    """A bfloat16 input is computed in float32 and the loss cast back; a
    sample whose labels cannot fit its frames (three labels, two frames)
    gets an infinite loss, where the reference floors its sums at -1e30
    and gives a loss near 1e30 (a recorded divergence)."""
    lp, labels, in_len, lbl_len = _ctc_case()
    args = [torch.from_numpy(a) for a in (labels, in_len, lbl_len)]
    out = F.ctc_loss(torch.from_numpy(lp).to(torch.bfloat16), *args,
                     reduction="none")
    want = F.ctc_loss(torch.from_numpy(lp).to(torch.bfloat16).float(),
                      *args, reduction="none")
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out.float()),
                                  _np(want.to(torch.bfloat16).float()))
    short = torch.tensor([12, 2, 9])
    loss = F.ctc_loss(torch.from_numpy(lp), args[0], short, args[2],
                      reduction="none")
    assert math.isinf(float(loss[1])) and bool(torch.isfinite(loss[[0, 2]]).all())
    ref = JF.ctc_loss(pt.to_tensor(lp), pt.to_tensor(labels),
                      pt.to_tensor(np.array([12, 2, 9])),
                      pt.to_tensor(lbl_len), reduction="none")
    assert float(_np(ref)[1]) > 1e29
    with pytest.raises(NotImplementedError, match="norm_by_times"):
        tnn.CTCLoss()(torch.from_numpy(lp), *args, norm_by_times=True)
