"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``): each is one
function of :mod:`paddle_tpu_torch.nn.functional` with its options
fixed, ``SoftMarginLoss`` the reference's own ``log1p(exp(-y x))``."""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["PoissonNLLLoss", "GaussianNLLLoss", "MultiLabelSoftMarginLoss",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "CTCLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "HingeEmbeddingLoss", "SoftMarginLoss",
           "LogLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction
        self._soft_label = soft_label
        self._axis = axis
        self._use_softmax = use_softmax
        self._label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self._weight,
            ignore_index=self._ignore_index, reduction=self._reduction,
            soft_label=self._soft_label, axis=self._axis,
            use_softmax=self._use_softmax,
            label_smoothing=self._label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction
        self._pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self._weight, self._reduction, self._pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class CTCLoss(Layer):
    """``F.ctc_loss`` with a fixed ``blank`` and reduction.
    ``norm_by_times=True`` raises: the reference accepts it and computes
    nothing of it."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank = blank
        self._reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        if norm_by_times:
            raise NotImplementedError(
                "CTCLoss(norm_by_times=True) is not ported")
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self._margin,
                                       self._reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self._args)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self._margin,
                                      self._reduction)


class SoftMarginLoss(Layer):
    """``log1p(exp(-label * input))``, reduced (reference :170-183)."""

    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F._reduce(torch.log1p(torch.exp(-label * input)),
                         self._reduction)


class LogLoss(Layer):
    def __init__(self, epsilon=1e-4, name=None):
        super().__init__()
        self._epsilon = epsilon

    def forward(self, input, label):
        return F.log_loss(input, label, self._epsilon)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self._args)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, *self._args)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self._weight,
                                              self._reduction)
