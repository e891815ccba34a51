"""Losses of the port (counterpart of ``incubator_mxnet_tpu/gluon/loss.py``):
``SoftmaxCrossEntropyLoss`` so far.  A loss returns one value per sample,
the batch axis kept and every other axis averaged."""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(nn.Module):
    """Base class (reference loss.py:Loss): a scalar ``weight`` and the
    ``batch_axis`` the per-sample losses keep."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        if weight is not None and not isinstance(weight, (int, float)):
            raise MXNetError(f"loss weight must be a number, got {weight!r}")
        self._weight = weight
        self._batch_axis = batch_axis

    def _finish(self, loss, sample_weight):
        """Apply ``sample_weight`` then ``weight`` and average every axis
        but the batch axis (reference ``_apply_weighting`` and
        ``F.mean(loss, axis=batch_axis, exclude=True)``)."""
        if sample_weight is not None:
            loss = loss * sample_weight
        if self._weight is not None:
            loss = loss * self._weight
        axis = self._batch_axis % loss.dim()
        rest = tuple(i for i in range(loss.dim()) if i != axis)
        return loss.mean(rest) if rest else loss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy in log space (reference loss.py:
    SoftmaxCELoss): ``-log_softmax(pred)[label]`` along ``axis`` with
    ``sparse_label`` (integer class labels, given as any numeric dtype
    and clipped into range, as the reference's ``pick`` does), else
    ``-sum(log_softmax(pred) * label)``; ``from_logits`` takes ``pred``
    as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        axis = self._axis % pred.dim()
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[axis] - 1)
            loss = -torch.gather(pred, axis, idx.unsqueeze(axis))
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(axis, keepdim=True)
        return self._finish(loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
