"""The cross-entropy options of the port (``nn.functional.cross_entropy``:
``weight``, ``soft_label``, ``label_smoothing`` hard and soft,
``use_softmax=False``, another class axis), ``softmax_with_cross_entropy``
and ``square_error_cost``, held against the JAX package's on the same
numpy inputs, on the CPU in float32: the loss and the gradient of
``sum(loss * cot)`` in the logits, at the layers' tolerance (rtol 1e-4,
atol 1e-5; ``tests/test_layers.py``) and twice that for gradients.

The reference gathers hard labels along a class axis other than the last
into a wrong shape (its ``take_along_axis`` on ``safe[..., None]``
broadcasts, and the call raises); the port moves the axis last first,
so that case is held against the reference on the moved inputs."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F

from test_torch_bridge import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _both(jfn, tfn, x, *rest):
    """``fn(x, *rest)`` in both packages: outputs and the gradients in
    ``x`` of ``sum(out * cot)``."""
    jx = pt.to_tensor(x, stop_gradient=False)
    jout = jfn(jx, *[pt.to_tensor(r) for r in rest])
    cot = np.random.RandomState(9).uniform(
        0.5, 1.5, np.shape(_np(jout))).astype(np.float32)
    (jout * pt.to_tensor(cot)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tfn(tx, *[torch.from_numpy(r) for r in rest])
    (tout * torch.from_numpy(cot)).sum().backward()
    return (_np(tout), _np(jout)), (_np(tx.grad), _np(jx.grad))


def _assert_pair(outs, grads):
    (t, j), (tg, jg) = outs, grads
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, **FWD)
    np.testing.assert_allclose(tg, jg, **GRAD)


def _hard(rng, n=12, c=7, ignore=True):
    logits = rng.randn(n, c).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int64)
    if ignore:
        labels[[1, 6]] = -100
    return logits, labels


def _soft(rng, n=12, c=7):
    logits = rng.randn(n, c).astype(np.float32)
    target = rng.uniform(0, 1, (n, c)).astype(np.float32)
    return logits, target / target.sum(-1, keepdims=True)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.15])
def test_weighted_hard_labels(reduction, smoothing):
    """Class weights: each row scaled by its label's weight; ``mean``
    divides by the valid rows' weight sum in f32; ignored rows zero."""
    rng = np.random.RandomState(0)
    logits, labels = _hard(rng)
    w = rng.uniform(0.5, 2.0, 7).astype(np.float32)

    def run(mod):
        return lambda x, lbl, wt: mod.cross_entropy(
            x, lbl, weight=wt, reduction=reduction,
            label_smoothing=smoothing)
    _assert_pair(*_both(run(JF), run(F), logits, labels, w))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_label_smoothing_hard(reduction):
    rng = np.random.RandomState(1)
    logits, labels = _hard(rng)

    def run(mod):
        return lambda x, lbl: mod.cross_entropy(
            x, lbl, reduction=reduction, label_smoothing=0.2)
    _assert_pair(*_both(run(JF), run(F), logits, labels))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_soft_labels(reduction, smoothing):
    rng = np.random.RandomState(2)
    logits, target = _soft(rng)

    def run(mod):
        return lambda x, t: mod.cross_entropy(
            x, t, soft_label=True, reduction=reduction,
            label_smoothing=smoothing)
    _assert_pair(*_both(run(JF), run(F), logits, target))


@pytest.mark.parametrize("soft", [False, True])
def test_use_softmax_false_takes_probabilities(soft):
    """``use_softmax=False``: the input is a probability, logged as
    ``log(max(p, 1e-30))``; one exact zero shows the floor."""
    rng = np.random.RandomState(3)
    logits, lbl = _soft(rng) if soft else _hard(rng)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0] = 0.0

    def run(mod):
        return lambda p, t: mod.cross_entropy(
            p, t, soft_label=soft, use_softmax=False, reduction="none")
    _assert_pair(*_both(run(JF), run(F), probs.astype(np.float32), lbl))


def test_soft_labels_over_another_axis():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 5, 4).astype(np.float32)
    target = rng.uniform(0, 1, (3, 5, 4)).astype(np.float32)
    target /= target.sum(1, keepdims=True)

    def run(mod):
        return lambda x, t: mod.cross_entropy(
            x, t, soft_label=True, axis=1, reduction="none",
            label_smoothing=0.1)
    _assert_pair(*_both(run(JF), run(F), logits, target))


@pytest.mark.parametrize("label_rank", [2, 3])
def test_hard_labels_over_another_axis(label_rank):
    """Class axis 1 of ``[N, C, L]`` (labels ``[N, L]`` or ``[N, 1, L]``)
    equals the reference over the class axis moved last."""
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 5, 4).astype(np.float32)
    labels = rng.randint(0, 5, (3, 4)).astype(np.int64)
    labels[0, 1] = -100
    moved = np.ascontiguousarray(np.moveaxis(logits, 1, -1))
    jx = pt.to_tensor(moved, stop_gradient=False)
    ref = JF.cross_entropy(jx, pt.to_tensor(labels), reduction="none",
                           label_smoothing=0.1)
    ref.sum().backward()
    lbl = labels if label_rank == 2 else labels[:, None, :]
    tx = torch.from_numpy(logits).requires_grad_()
    ours = F.cross_entropy(tx, torch.from_numpy(lbl), axis=1,
                           reduction="none", label_smoothing=0.1)
    ours.sum().backward()
    np.testing.assert_allclose(_np(ours), _np(ref), **FWD)
    np.testing.assert_allclose(np.moveaxis(_np(tx.grad), 1, -1),
                               _np(jx.grad), **GRAD)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy(soft):
    """The unreduced loss, and the softmax beside it."""
    rng = np.random.RandomState(6)
    logits, lbl = _soft(rng) if soft else _hard(rng)

    def run(mod):
        return lambda x, t: mod.softmax_with_cross_entropy(
            x, t, soft_label=soft)
    _assert_pair(*_both(run(JF), run(F), logits, lbl))
    jl, jsm = JF.softmax_with_cross_entropy(
        pt.to_tensor(logits), pt.to_tensor(lbl), soft_label=soft,
        return_softmax=True)
    tl, tsm = F.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(lbl), soft_label=soft,
        return_softmax=True)
    np.testing.assert_allclose(_np(tl), _np(jl), **FWD)
    np.testing.assert_allclose(_np(tsm), _np(jsm), **FWD)


def test_square_error_cost():
    rng = np.random.RandomState(7)
    a, b = rng.randn(4, 3).astype(np.float32), \
        rng.randn(4, 3).astype(np.float32)
    _assert_pair(*_both(JF.square_error_cost, F.square_error_cost, a, b))


def test_cross_entropy_loss_layer_passes_the_options():
    rng = np.random.RandomState(8)
    logits, labels = _hard(rng)
    w = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    jl = jnn.CrossEntropyLoss(weight=pt.to_tensor(w), label_smoothing=0.1)
    tl = tnn.CrossEntropyLoss(weight=torch.from_numpy(w),
                              label_smoothing=0.1)
    _assert_pair(*_both(jl, tl, logits, labels))


def test_weight_with_soft_labels_is_refused():
    """The reference takes a class weight with soft labels and never
    reads it; the port refuses it (PR 11's rule for ignored options)."""
    rng = np.random.RandomState(9)
    logits, target = _soft(rng)
    with pytest.raises(NotImplementedError, match="ignores weight"):
        F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(target),
                        weight=torch.ones(7), soft_label=True)
