"""Optimizers of the port (counterpart of ``incubator_mxnet_tpu/optimizer.py``
and the update ops of ``ops/optimizer_ops.py``): ``SGD`` with momentum so
far, in fp32.

The update order is the reference's ``sgd_mom_update`` exactly::

    g = clip(rescale_grad * grad)          (clip only when clip_gradient > 0)
    mom = momentum * mom - lr * (g + wd * w)
    w = w + mom

and without momentum ``w = w - lr * (g + wd * w)`` (``sgd_update``).  The
port updates the weight and the momentum in place.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["SGD", "sgd_mom_update", "sgd_update"]


def _rescale(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """One SGD-with-momentum step of ``weight`` and ``mom``, in place."""
    g = _rescale(grad, rescale_grad, clip_gradient).to(weight.dtype)
    mom.copy_(momentum * mom - lr * (g + wd * weight))
    weight.add_(mom)


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """One plain SGD step of ``weight``, in place."""
    g = _rescale(grad, rescale_grad, clip_gradient).to(weight.dtype)
    weight.copy_(weight - lr * (g + wd * weight))


class SGD:
    """SGD with momentum (reference optimizer.py:SGD).  ``learning_rate``,
    ``momentum``, ``wd``, ``rescale_grad`` and ``clip_gradient`` as in the
    reference; a parameter's ``lr_mult`` / ``wd_mult`` attributes, when
    set, scale its lr and wd.  Not ported yet, and raising
    ``MXNetError``: ``lr_scheduler`` and ``multi_precision`` (bf16
    weights with fp32 masters)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=None, lr_scheduler=None,
                 multi_precision=False, lazy_update=True):
        if lr_scheduler is not None:
            raise MXNetError("SGD(lr_scheduler=...) is not ported yet")
        if multi_precision:
            raise MXNetError("SGD(multi_precision=True) is not ported yet: "
                             "the port trains in fp32")
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.wd = float(wd)
        self.rescale_grad = float(rescale_grad)
        self.clip_gradient = clip_gradient
        self.lazy_update = lazy_update

    def create_state(self, weight):
        """The momentum buffer of ``weight`` (zeros), or None without
        momentum."""
        return torch.zeros_like(weight) if self.momentum else None

    def update(self, weight, grad, state):
        """One step of ``weight`` (an ``nn.Parameter`` or tensor) from
        ``grad``, in place, with its ``lr_mult`` / ``wd_mult``."""
        lr = self.learning_rate * getattr(weight, "lr_mult", 1.0)
        wd = self.wd * getattr(weight, "wd_mult", 1.0)
        kw = dict(rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient)
        if state is None:
            sgd_update(weight, grad, lr, wd, **kw)
        else:
            sgd_mom_update(weight, grad, state, lr, self.momentum, wd, **kw)
