"""Optimizer update operators of the imperative path (counterpart of part
of ``incubator_mxnet_tpu/ops/optimizer_ops.py``; reference
src/operator/optimizer_op.cc).

Ported so far: ``sgd_update`` (``optimizer_ops.py:30``),
``sgd_mom_update`` (``:37``), ``mp_sgd_update`` (``:45``) and
``mp_sgd_mom_update`` (``:53``), over the port's ``optimizer``
functions of the same names: the arithmetic is written once, there.
As in the JAX package an op returns the updated tensors (weight first,
then the momentum and the fp32 master where it has them) and does not
touch its inputs; ``nd.sgd_update(w, g, lr=..., out=w)`` writes the
result back in place.  The other update rules are ROADMAP A8.
"""
from __future__ import annotations

from .. import optimizer
from .registry import register_op

__all__ = []


@register_op("sgd_update", differentiable=False)
def _sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=False):
    w = weight.clone()
    optimizer.sgd_update(w, grad, lr, wd, rescale_grad, clip_gradient)
    return w


@register_op("sgd_mom_update", num_outputs=2, differentiable=False)
def _sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False):
    w, m = weight.clone(), mom.clone()
    optimizer.sgd_mom_update(w, grad, m, lr, momentum, wd, rescale_grad,
                             clip_gradient)
    return w, m


@register_op("mp_sgd_update", num_outputs=2, differentiable=False)
def _mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=False):
    w, w32 = weight.clone(), weight32.clone()
    optimizer.mp_sgd_update(w, grad, w32, lr, wd, rescale_grad,
                            clip_gradient)
    return w, w32


@register_op("mp_sgd_mom_update", num_outputs=3, differentiable=False)
def _mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=False):
    w, m, w32 = weight.clone(), mom.clone(), weight32.clone()
    optimizer.mp_sgd_mom_update(w, grad, m, w32, lr, momentum, wd,
                                rescale_grad, clip_gradient)
    return w, m, w32
