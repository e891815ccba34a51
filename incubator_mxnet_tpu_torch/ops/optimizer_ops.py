"""Optimizer update operators of the imperative path (counterpart of part
of ``incubator_mxnet_tpu/ops/optimizer_ops.py``; reference
src/operator/optimizer_op.cc).

All thirteen of the JAX file's update ops: ``sgd_update``
(``optimizer_ops.py:30``), ``sgd_mom_update`` (``:37``),
``mp_sgd_update`` (``:45``), ``mp_sgd_mom_update`` (``:53``),
``adam_update`` (``:63``), ``rmsprop_update`` (``:75``),
``rmspropalex_update`` (``:88``), ``ftrl_update`` (``:104``),
``signsgd_update`` (``:117``), ``signum_update`` (``:124``),
``adagrad_update`` (``:133``), ``adadelta_update`` (``:142``) and
``ftml_update`` (``:153``), over the port's ``optimizer`` functions of
the same names: the arithmetic is written once, there.  As in the JAX
package an op returns the updated tensors (the weight first, then its
states in input order) and does not touch its inputs;
``nd.adam_update(w, g, m, v, lr=..., out=[w, m, v])`` writes the
results back in place.
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


def _run(fn, inputs, *args, **kwargs):
    """``fn`` (an in-place update) on copies of ``inputs`` but the
    gradient (the second); returns the copies."""
    outs = [t.clone() for t in inputs[:1] + inputs[2:]]
    fn(outs[0], inputs[1], *outs[1:], *args, **kwargs)
    return outs[0] if len(outs) == 1 else tuple(outs)


@register_op("adam_update", num_outputs=3, differentiable=False)
def _adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=False):
    return _run(optimizer.adam_update, [weight, grad, mean, var], lr, beta1,
                beta2, epsilon, wd, rescale_grad, clip_gradient)


@register_op("rmsprop_update", num_outputs=2, differentiable=False)
def _rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    return _run(optimizer.rmsprop_update, [weight, grad, n], lr, gamma1,
                epsilon, wd, rescale_grad, clip_gradient, clip_weights)


@register_op("rmspropalex_update", num_outputs=4, differentiable=False)
def _rmspropalex_update(weight, grad, n, g_state, delta, *, lr, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    return _run(optimizer.rmspropalex_update, [weight, grad, n, g_state,
                                               delta], lr, gamma1, gamma2,
                epsilon, wd, rescale_grad, clip_gradient, clip_weights)


@register_op("ftrl_update", num_outputs=3, differentiable=False)
def _ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    return _run(optimizer.ftrl_update, [weight, grad, z, n], lr, lamda1, beta,
                wd, rescale_grad, clip_gradient)


@register_op("signsgd_update", differentiable=False)
def _signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    return _run(optimizer.signsgd_update, [weight, grad], lr, wd,
                rescale_grad, clip_gradient)


@register_op("signum_update", num_outputs=2, differentiable=False)
def _signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    return _run(optimizer.signum_update, [weight, grad, mom], lr, momentum,
                wd, rescale_grad, clip_gradient, wd_lh)


@register_op("adagrad_update", num_outputs=2, differentiable=False)
def _adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    return _run(optimizer.adagrad_update, [weight, grad, history], lr,
                epsilon, wd, rescale_grad, clip_gradient)


@register_op("adadelta_update", num_outputs=3, differentiable=False)
def _adadelta_update(weight, grad, acc_g, acc_delta, *, rho=0.9, epsilon=1e-5,
                     wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    return _run(optimizer.adadelta_update, [weight, grad, acc_g, acc_delta],
                rho, epsilon, wd, rescale_grad, clip_gradient)


@register_op("ftml_update", num_outputs=4, differentiable=False)
def _ftml_update(weight, grad, d, v, z, *, lr, t, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    return _run(optimizer.ftml_update, [weight, grad, d, v, z], lr, t, beta1,
                beta2, epsilon, wd, rescale_grad, clip_grad)
