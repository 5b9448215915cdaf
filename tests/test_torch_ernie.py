"""The port's ERNIE (``paddle_tpu_torch.models.ernie``) against the JAX
package's on bridged weights, on the CPU: ``ErnieModel``,
``ErnieForSequenceClassification`` and ``ErnieForPretraining``, forward
and every gradient, and three AdamW ``TrainStep`` steps; dropout is 0
there, because the masks differ between the packages by contract. Then
the port's own dropout: after ``paddle_tpu_torch.seed(n)`` a tiny ERNIE
step with dropout repeats exactly, and another seed changes it.

Tolerances, float32 on both sides: outputs rtol 1e-4 / atol 1e-5 and
gradients rtol 2e-4 / atol 2e-5 (the reference has no ERNIE parity
test: these are the layer tests' and their double for a backward), the
three step losses rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import ernie as je
import paddle_tpu_torch as ptt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import ernie as te
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _pair(kind, seed, **kw):
    """A JAX model and its port twin on bridged weights (tiny config)."""
    pt.seed(seed)
    jcfg = je.ErnieConfig.tiny(**NO_DROPOUT, **kw)
    tcfg = te.ErnieConfig.tiny(**NO_DROPOUT, **kw)
    jm = getattr(je, kind)(jcfg)
    tm = getattr(te, kind)(tcfg, device="cpu")
    jm.train()
    load_numpy_state(tm, state_dict_from_jax(jm))
    return jm, tm


def _batch(seed=0, B=2, S=12, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    tt = rng.randint(0, 2, (B, S)).astype(np.int32)
    mlm = np.where(rng.rand(B, S) < 0.3, rng.randint(0, vocab, (B, S)),
                   -100).astype(np.int32)
    sop = rng.randint(0, 2, B).astype(np.int32)
    return ids, tt, mlm, sop


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters()}


def _assert_grads(tm, jm):
    jg, tg = _grads(jm), _grads(tm)
    assert sorted(jg) == sorted(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD)


def test_parameter_names_and_shapes_equal_the_reference():
    jm, tm = _pair("ErnieForPretraining", 1)
    jshapes = {n: tuple(a.shape) for n, a in state_dict_from_jax(jm).items()}
    assert [n for n, _ in tm.named_parameters()] == list(jshapes)
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == jshapes


def test_ernie_model_matches_jax():
    """Sequence and pooled outputs with token types and a key-padding
    mask, and every gradient of a seeded projection of both."""
    jm, tm = _pair("ErnieModel", 2)
    ids, tt, _, _ = _batch(1)
    mask = np.ones((2, 1, 1, 12), bool)
    mask[1, ..., 9:] = False
    rng = np.random.RandomState(3)
    cs, cp = rng.randn(2, 12, 32).astype(np.float32), \
        rng.randn(2, 32).astype(np.float32)
    jseq, jpool = jm(pt.to_tensor(ids), pt.to_tensor(tt),
                     attention_mask=pt.to_tensor(mask))
    ((jseq * pt.to_tensor(cs)).sum() + (jpool * pt.to_tensor(cp)).sum()
     ).backward()
    seq, pool = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                   attention_mask=torch.from_numpy(mask))
    ((seq * torch.from_numpy(cs)).sum() + (pool * torch.from_numpy(cp)).sum()
     ).backward()
    np.testing.assert_allclose(_np(seq), _np(jseq), **FWD)
    np.testing.assert_allclose(_np(pool), _np(jpool), **FWD)
    _assert_grads(tm, jm)


def test_sequence_classification_matches_jax():
    jm, tm = _pair("ErnieForSequenceClassification", 4)
    ids, tt, _, _ = _batch(5)
    labels = np.array([1, 0], np.int32)
    jlogits, jloss = jm(pt.to_tensor(ids), pt.to_tensor(tt),
                        labels=pt.to_tensor(labels))
    jloss.backward()
    logits, loss = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                      labels=torch.from_numpy(labels))
    loss.backward()
    assert tuple(logits.shape) == (2, 2)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **FWD)
    np.testing.assert_allclose(float(loss.detach()), float(_np(jloss)),
                               **FWD)
    _assert_grads(tm, jm)
    no_labels = tm(torch.from_numpy(ids))
    assert tuple(no_labels.shape) == (2, 2)


def test_pretraining_heads_and_loss_match_jax():
    """MLM logits against the tied word embeddings, the SOP logits, and
    the summed loss with every gradient (the tied table's from both of
    its uses)."""
    jm, tm = _pair("ErnieForPretraining", 6)
    ids, tt, mlm, sop = _batch(7)
    jmlm, jsop, jloss = jm(pt.to_tensor(ids), pt.to_tensor(tt),
                           masked_lm_labels=pt.to_tensor(mlm),
                           sop_labels=pt.to_tensor(sop))
    jloss.backward()
    tmlm, tsop, loss = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                          masked_lm_labels=torch.from_numpy(mlm),
                          sop_labels=torch.from_numpy(sop))
    loss.backward()
    assert tuple(tmlm.shape) == (2, 12, 128) and tuple(tsop.shape) == (2, 2)
    np.testing.assert_allclose(_np(tmlm), _np(jmlm), **FWD)
    np.testing.assert_allclose(_np(tsop), _np(jsop), **FWD)
    np.testing.assert_allclose(float(loss.detach()), float(_np(jloss)),
                               **FWD)
    _assert_grads(tm, jm)
    outs = tm(torch.from_numpy(ids))
    assert len(outs) == 2


def _loss_fn(m, ids, tt, mlm, sop):
    return m(ids, tt, masked_lm_labels=mlm, sop_labels=sop)[2]


def test_three_adamw_train_steps_match_jax():
    """AdamW (lr 1e-3, f32) with a global-norm clip of 1.0 through
    ``TrainStep`` in both packages: each step's loss at rtol 1e-5, and
    the parameters after the third at the gradient tolerance."""
    jm, tm = _pair("ErnieForPretraining", 8)
    batch = _batch(9)
    jopt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters(),
                              grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    jstep = pt.jit.TrainStep(jm, _loss_fn, jopt)
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, _loss_fn, topt)
    losses = []
    for _ in range(3):
        jl = float(_np(jstep(*[pt.to_tensor(a) for a in batch])))
        ours = float(tstep(*[torch.from_numpy(a) for a in batch]))
        np.testing.assert_allclose(ours, jl, rtol=1e-5)
        losses.append(ours)
    assert losses[-1] < losses[0]
    jstate = state_dict_from_jax(jm)
    for n, p in tm.named_parameters():
        if n.endswith("k_proj.bias"):
            # its gradient is 0 in exact arithmetic (a key bias adds the
            # same q.b to every score of a row, which softmax cancels), so
            # Adam normalises each package's rounding noise: both stay
            # within the 3 steps' reach of their zero start
            for got in (_np(p), jstate[n]):
                assert np.abs(got).max() <= 3 * 1e-3 * (1 + 1e-5), n
            continue
        np.testing.assert_allclose(_np(p), jstate[n], err_msg=n, **GRAD)


def _dropout_run(seed):
    """Two TrainStep steps of a tiny ERNIE with hidden and attention
    dropout 0.1, from fixed weights, after ``paddle_tpu_torch.seed``."""
    ptt.seed(0)
    cfg = te.ErnieConfig.tiny()
    assert cfg.hidden_dropout_prob == cfg.attention_probs_dropout_prob == 0.1
    tm = te.ErnieForPretraining(cfg, device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    step = TrainStep(tm, _loss_fn, opt)
    ptt.seed(seed)
    batch = [torch.from_numpy(a) for a in _batch(10)]
    return [float(step(*batch)) for _ in range(2)]


def test_dropout_steps_repeat_under_the_same_seed():
    assert _dropout_run(11) == _dropout_run(11)


def test_dropout_steps_differ_under_another_seed():
    assert _dropout_run(11) != _dropout_run(12)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    for kind in ("ErnieModel", "ErnieForSequenceClassification",
                 "ErnieForPretraining"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(te, kind)(te.ErnieConfig.tiny())
