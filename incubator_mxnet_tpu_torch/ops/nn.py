"""Neural-network operators of the imperative path (counterpart of part
of ``incubator_mxnet_tpu/ops/nn.py``; reference src/operator/nn/).

Ported so far: ``FullyConnected`` (``nn.py:38``), ``Activation``
(``:209``), ``softmax`` (``:248``), ``log_softmax`` (``:254``) and
``softmax_cross_entropy`` (``:733``) as registered ops, and the fused
BatchNorm + ReLU (``_FusedBatchNormRelu``, ``:535``) as
``fused_batch_norm_relu``, which ``gluon.nn.BNReLU`` calls.  The rest of
the file (convolution, pooling, BatchNorm as an op, the output layers)
is ROADMAP A8.  ``FullyConnected`` is a plain product
(``torch.matmul``), as the JAX package left it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused_conv import bn_stats
from .registry import register_op

__all__ = ["fused_batch_norm_relu"]


@register_op("FullyConnected", aliases=("fully_connected",))
def _fully_connected(data, weight, bias=None, *, num_hidden=None,
                     no_bias=False, flatten=True):
    """Y = X W^T + b (reference src/operator/nn/fully_connected-inl.h)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": lambda x: x / (torch.abs(x) + 1),
    # extension beyond the reference; jax.nn.gelu's default is the tanh
    # approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


@register_op("Activation", aliases=("activation",))
def _activation(data, *, act_type):
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown act_type {act_type}")
    return _ACTIVATIONS[act_type](data)


def _float(x):
    """An integer array as float32, as JAX promotes it."""
    return x if x.is_floating_point() else x.to(torch.float32)


@register_op("softmax")
def _softmax(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else _float(data)
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def _log_softmax(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else _float(data)
    return torch.log_softmax(x, dim=axis)


@register_op("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """Scalar cross entropy of softmax(data) against integer labels,
    shape (1,): -sum over the batch of log(max(softmax(x)[i, label_i],
    1e-8)) (reference loss_binary_op-inl.h:51)."""
    if data.ndim != 2 or label.ndim != 1:
        raise ValueError("softmax_cross_entropy expects 2D data and 1D "
                         "label")
    p = torch.softmax(data, dim=-1)
    picked = torch.gather(p, 1, label.long()[:, None])[:, 0]
    return -torch.sum(torch.log(torch.clamp(picked, min=1e-8))).reshape(1)


class _FusedBatchNormRelu(torch.autograd.Function):
    """BatchNorm + ReLU with the JAX package's bandwidth-lean backward
    (``ops/nn.py`` ``_bn_relu_core``).  The forward normalises to
    ``xhat = (x - mean) * inv`` in x's dtype and saves only ``xhat``
    and the per-channel ``inv``, ``g`` and ``beta``; the backward
    recomputes the ReLU mask as ``g*xhat + beta > 0`` and writes dx from
    ``xhat`` and dy alone, so it reads one full tensor fewer than
    autograd of BatchNorm then ReLU (which saves x and the ReLU output).
    The reductions of the backward run in fp32, as the reference's."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mmean, mvar, eps, fix_gamma,
                train_stats):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train_stats:
            mean32, var32 = bn_stats(x)
        else:
            mean32, var32 = mmean.float(), mvar.float()
        inv = torch.rsqrt(var32 + eps).to(x.dtype)
        mean = mean32.to(x.dtype)
        g = torch.ones_like(gamma) if fix_gamma else gamma
        xhat = (x - mean.view(shape)).mul_(inv.view(shape))
        y = (xhat * g.view(shape)).add_(beta.view(shape)).relu_()
        ctx.set_materialize_grads(False)
        ctx.cfg = (eps, fix_gamma, train_stats)
        ctx.save_for_backward(xhat, inv, g, beta)
        return y, mean, var32.to(x.dtype)

    @staticmethod
    def backward(ctx, dy, ct_mean, ct_var):
        xhat, inv, g, beta = ctx.saved_tensors
        eps, fix_gamma, train_stats = ctx.cfg
        shape = (1, -1) + (1,) * (xhat.dim() - 2)
        red = (0,) + tuple(range(2, xhat.dim()))
        if dy is None:
            dy = torch.zeros_like(xhat)
        mask = (xhat * g.view(shape)).add_(beta.view(shape)) > 0
        dz = torch.where(mask, dy, 0)
        dz32, xhat32 = dz.float(), xhat.float()
        sum_dz = dz32.sum(red)
        sum_dzxh = (dz32 * xhat32).sum(red)
        dbeta = sum_dz.to(beta.dtype)
        dgamma = torch.zeros_like(g) if fix_gamma else sum_dzxh.to(g.dtype)
        if not train_stats:
            # the (mean, var) outputs pass the moving statistics through
            dx = (dz * g.view(shape) * inv.view(shape)).to(xhat.dtype)
            return dx, dgamma, dbeta, ct_mean, ct_var, None, None, None
        m = xhat.numel() // xhat.shape[1]
        inv32 = inv.float().view(shape)
        dx32 = torch.addcmul(dz32 - (sum_dz / m).view(shape), xhat32,
                             (sum_dzxh / m).view(shape), value=-1.0)
        dx32 = dx32 * (g.float().view(shape) * inv32)
        # cotangents on the (mean, var) outputs: mean = sum(x)/m gives
        # ct_mean/m; var = E[x^2] - mean^2 (clamped at 0) gives
        # ct_var * 2(x - mean)/m where the clamp was not active, and
        # x - mean = xhat / inv
        if ct_mean is not None:
            dx32 = dx32 + ct_mean.float().view(shape) / m
        if ct_var is not None:
            var_pos = (inv32 * inv32 * eps < 1.0).float()
            dx32 = dx32 + ct_var.float().view(shape) * var_pos * 2.0 * \
                xhat32 / (inv32 * m)
        return (dx32.to(xhat.dtype), dgamma, dbeta, None, None, None, None,
                None)


def fused_batch_norm_relu(x, gamma, beta, mmean, mvar, eps=1e-5,
                          fix_gamma=False, train_stats=True):
    """``relu(BatchNorm(x))`` as one op, the JAX package's
    ``_FusedBatchNormRelu``: returns ``(y, mean, var)``, the statistics
    in x's dtype, the batch's (``bn_stats``, the single-pass fp32
    formula that ``BatchNorm`` uses) with ``train_stats``, else the
    moving ones passed through.  The channel axis is dim 1, as in the
    port's NCHW-indexed tensors (channels-last or not).  The forward
    is ``relu((x - mean) * rsqrt(var + eps) * gamma + beta)`` in x's
    dtype (gamma taken as 1 when ``fix_gamma``); the backward is the
    reference's lean one (``_FusedBatchNormRelu`` above), plain PyTorch
    as the reference's is XLA: no hand-written kernel.  The moving
    statistics are not updated here (the caller does that, as the JAX
    front end does)."""
    return _FusedBatchNormRelu.apply(x, gamma, beta, mmean, mvar,
                                     float(eps), bool(fix_gamma),
                                     bool(train_stats))
