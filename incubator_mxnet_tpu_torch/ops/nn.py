"""Neural-network operators of the imperative path (counterpart of part
of ``incubator_mxnet_tpu/ops/nn.py``; reference src/operator/nn/).

Ported so far: ``FullyConnected`` (``nn.py:38``), ``Activation``
(``:209``), ``softmax`` (``:248``), ``log_softmax`` (``:254``) and
``softmax_cross_entropy`` (``:733``).  The rest of the file
(convolution, pooling, BatchNorm as an op, the output layers) is
ROADMAP A8.  ``FullyConnected`` is a plain product (``torch.matmul``),
as the JAX package left it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = []


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


@register_op("softmax")
def _softmax(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def _log_softmax(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else data
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
