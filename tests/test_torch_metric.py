"""The port's metrics (``paddle_tpu_torch.metric``) against the JAX
package's on the same arrays, and an ERNIE classifier through the port's
``hapi.Model`` (``prepare(AdamW, CrossEntropyLoss(), Accuracy())``, then
``fit`` and ``evaluate``) against the reference's ``Model`` on bridged
weights, on the CPU.

Metrics count on the host in both packages, so they agree exactly (Auc
to 1e-12: the port writes out the trapezoid sum). The fit's per-step
losses and the evaluation loss agree at rtol 1e-5 (float32, the step
tolerance of ``tests/test_torch_train.py``), the accuracy exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import metric as jmetric
from paddle_tpu.models import ernie as je
from paddle_tpu_torch import metric
from paddle_tpu_torch.hapi import Callback, Model
from paddle_tpu_torch.models import ernie as te
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax


def _feed(m, pred, label, torch_side):
    """``compute`` then ``update``, as ``hapi.Model.eval_batch`` does."""
    if torch_side:
        pred, label = torch.from_numpy(pred), torch.from_numpy(label)
    else:
        pred, label = pt.to_tensor(pred), pt.to_tensor(label)
    res = m.compute(pred, label)
    if not isinstance(res, tuple):
        res = (res,)
    return m.update(*res)


@pytest.mark.parametrize("topk,label_shape", [
    ((1,), "flat"), ((1, 3), "column"), ((2,), "one_hot")])
def test_accuracy_matches_jax(topk, label_shape):
    rng = np.random.RandomState(len(topk))
    ours, ref = metric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    for _ in range(3):
        pred = rng.randn(16, 5).astype(np.float32)
        label = rng.randint(0, 5, 16).astype(np.int64)
        if label_shape == "column":
            label = label[:, None]
        elif label_shape == "one_hot":
            label = np.eye(5, dtype=np.float32)[label]
        np.testing.assert_array_equal(_feed(ours, pred, label, True),
                                      _feed(ref, pred, label, False))
    assert ours.accumulate() == ref.accumulate()
    assert ours.name() == ref.name()
    ours.reset()
    assert ours.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])


def test_accuracy_reads_bfloat16_predictions():
    pred = torch.tensor([[0.1, 0.9], [0.8, 0.2]], dtype=torch.bfloat16)
    m = metric.Accuracy()
    m.update(m.compute(pred, torch.tensor([1, 1])))
    assert m.accumulate() == 0.5


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(name):
    rng = np.random.RandomState(3)
    ours, ref = getattr(metric, name)(), getattr(jmetric, name)()
    for _ in range(4):
        preds = rng.rand(32).astype(np.float32)
        if name == "Auc":
            preds = np.stack([1 - preds, preds], 1)
        labels = (rng.rand(32) < 0.4).astype(np.int64)
        ours.update(torch.from_numpy(preds), torch.from_numpy(labels))
        ref.update(pt.to_tensor(preds), pt.to_tensor(labels))
    np.testing.assert_allclose(ours.accumulate(), ref.accumulate(),
                               rtol=0, atol=1e-12)
    assert 0.0 < ours.accumulate() < 1.0
    assert ours.name() == ref.name()
    ours.reset()
    assert ours.accumulate() == 0.0


class _Losses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class _JLosses(pt.callbacks.Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def test_ernie_classifier_fit_and_evaluate_match_jax():
    """Three fit steps of a tiny ERNIE classifier (dropout 0) and an
    evaluation over 4 batches with ``Accuracy``, in both packages."""
    pt.seed(4)
    kw = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jnet = je.ErnieForSequenceClassification(je.ErnieConfig.tiny(**kw),
                                             num_classes=3)
    tnet = te.ErnieForSequenceClassification(te.ErnieConfig.tiny(**kw),
                                             num_classes=3, device="cpu")
    load_numpy_state(tnet, state_dict_from_jax(jnet))
    rng = np.random.RandomState(5)

    def batches(n):
        return [(rng.randint(0, 128, (4, 10)).astype(np.int32),
                 rng.randint(0, 3, 4).astype(np.int32)) for _ in range(n)]
    train, evald = batches(3), batches(4)

    jmodel = pt.hapi.Model(jnet).prepare(
        pt.optimizer.AdamW(learning_rate=1e-3, parameters=jnet.parameters()),
        pt.nn.CrossEntropyLoss(), jmetric.Accuracy())
    tmodel = Model(tnet).prepare(
        AdamW(learning_rate=1e-3, parameters=tnet.parameters()),
        CrossEntropyLoss(), metric.Accuracy())
    jl, tl = _JLosses(), _Losses()
    jmodel.fit(train, epochs=1, verbose=0, callbacks=[jl])
    tmodel.fit(train, epochs=1, verbose=0, callbacks=[tl])
    assert len(tl.losses) == 3 and all(np.isfinite(tl.losses))
    np.testing.assert_allclose(tl.losses, jl.losses, rtol=1e-5)
    jlogs = jmodel.evaluate(evald, verbose=0)
    tlogs = tmodel.evaluate(evald, verbose=0)
    assert sorted(tlogs) == sorted(jlogs) == ["acc", "loss"]
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    assert tlogs["acc"] == jlogs["acc"] and 0.0 <= tlogs["acc"] <= 1.0
