"""Optimizers of the port (counterpart of ``incubator_mxnet_tpu/optimizer.py``
and the update ops of ``ops/optimizer_ops.py``): ``SGD`` with momentum so
far, with fp32 master weights for bf16 / fp16 ones (``multi_precision``).

The update order is the reference's ``sgd_mom_update`` exactly::

    g = clip(rescale_grad * grad)          (clip only when clip_gradient > 0)
    mom = momentum * mom - lr * (g + wd * w)
    w = w + mom

and without momentum ``w = w - lr * (g + wd * w)`` (``sgd_update``).  The
multi-precision forms (``mp_sgd_mom_update``, ``mp_sgd_update``) run the
same steps on the fp32 master ``w32`` with the fp32 gradient, then round
the weight from it.  The port updates the weight, the momentum and the
master in place.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["SGD", "mp_sgd_mom_update", "mp_sgd_update", "sgd_mom_update",
           "sgd_update"]

_HALF = (torch.float16, torch.bfloat16)


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


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=None):
    """One SGD-with-momentum step of the fp32 master ``weight32`` and
    ``mom`` from the fp32 gradient, then ``weight`` rounded from the
    master; all three in place."""
    g = _rescale(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight32))
    weight32.add_(mom)
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=None):
    """One plain SGD step of the fp32 master ``weight32`` from the fp32
    gradient, then ``weight`` rounded from it; both in place."""
    g = _rescale(grad, rescale_grad, clip_gradient)
    weight32.copy_(weight32 - lr * (g + wd * weight32))
    weight.copy_(weight32)


class SGD:
    """SGD with momentum (reference optimizer.py:SGD).  ``learning_rate``,
    ``momentum``, ``wd``, ``rescale_grad`` and ``clip_gradient`` as in the
    reference; a parameter's ``lr_mult`` / ``wd_mult`` attributes, when
    set, scale its lr and wd.  ``multi_precision=True`` gives a bf16 or
    fp16 weight an fp32 master in its state, ``(momentum or None,
    master)`` as the reference's ``create_state_multi_precision`` does,
    and updates it by ``mp_sgd_mom_update`` / ``mp_sgd_update``.  Not
    ported yet, and raising ``MXNetError``: ``lr_scheduler``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=None, lr_scheduler=None,
                 multi_precision=False, lazy_update=True):
        if lr_scheduler is not None:
            raise MXNetError("SGD(lr_scheduler=...) is not ported yet")
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.wd = float(wd)
        self.rescale_grad = float(rescale_grad)
        self.clip_gradient = clip_gradient
        self.multi_precision = bool(multi_precision)
        self.lazy_update = lazy_update

    def _mixed(self, weight):
        return self.multi_precision and weight.dtype in _HALF

    def create_state(self, weight):
        """The momentum buffer of ``weight`` (zeros), or None without
        momentum; for a bf16 / fp16 weight under ``multi_precision``,
        ``(that buffer in fp32, the fp32 master copy of weight)``."""
        if self._mixed(weight):
            w32 = weight.detach().float()
            return (torch.zeros_like(w32) if self.momentum else None, w32)
        return torch.zeros_like(weight) if self.momentum else None

    def update(self, weight, grad, state):
        """One step of ``weight`` (an ``nn.Parameter`` or tensor) from
        ``grad``, in place, with its ``lr_mult`` / ``wd_mult``."""
        lr = self.learning_rate * getattr(weight, "lr_mult", 1.0)
        wd = self.wd * getattr(weight, "wd_mult", 1.0)
        kw = dict(rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient)
        if self._mixed(weight):
            mom, w32 = state
            if mom is None:
                mp_sgd_update(weight, grad, w32, lr, wd, **kw)
            else:
                mp_sgd_mom_update(weight, grad, mom, w32, lr, self.momentum,
                                  wd, **kw)
        elif state is None:
            sgd_update(weight, grad, lr, wd, **kw)
        else:
            sgd_mom_update(weight, grad, state, lr, self.momentum, wd, **kw)
