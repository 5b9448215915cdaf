"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``): the losses
that are one function of :mod:`paddle_tpu_torch.nn.functional` plus
Paddle's reduction. The margin, triplet, Poisson and Gaussian losses
are not ported yet."""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss", "CTCLoss"]


class CrossEntropyLoss(torch.nn.Module):
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


class MSELoss(torch.nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(torch.nn.Module):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(torch.nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(torch.nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(torch.nn.Module):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction
        self._pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self._weight, self._reduction, self._pos_weight)


class SmoothL1Loss(torch.nn.Module):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class KLDivLoss(torch.nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class CTCLoss(torch.nn.Module):
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
