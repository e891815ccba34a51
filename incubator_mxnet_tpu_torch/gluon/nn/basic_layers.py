"""Basic layers of the port: ``Dense``, ``LayerNorm``, ``Embedding``
(counterparts of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``
``Dense``/``LayerNorm``/``Embedding`` and the ``FullyConnected``,
``LayerNorm`` and ``Embedding`` ops).  Plain ``nn.Module``s with explicit
``device``/``dtype``; parameters are allocated uninitialised and filled
by the owner's ``initialize`` or a loaded ``state_dict``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError

__all__ = ["Dense", "LayerNorm", "Embedding"]


class Dense(nn.Module):
    """Fully-connected layer ``act(x W^T + b)``.  The weight is
    ``(units, in_units)`` as in MXNet, which is ``F.linear``'s layout;
    ``activation`` is None or ``"relu"``."""

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        if activation not in (None, "relu"):
            raise MXNetError(f"Dense activation must be None or 'relu', "
                             f"got {activation!r}")
        self._relu = activation == "relu"
        self.weight = nn.Parameter(torch.empty((units, in_units),
                                               device=device, dtype=dtype))
        if use_bias:
            self.bias = nn.Parameter(torch.empty((units,), device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        out = F.linear(x, self.weight, self.bias)
        return torch.relu(out) if self._relu else out


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis: biased variance, ``eps``
    inside the rsqrt, then ``* gamma + beta`` (the MXNet op's
    definition, which ``F.layer_norm`` computes)."""

    def __init__(self, in_channels, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._eps = epsilon
        self.gamma = nn.Parameter(torch.empty((in_channels,), device=device,
                                              dtype=dtype))
        self.beta = nn.Parameter(torch.empty((in_channels,), device=device,
                                             dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.gamma.shape, self.gamma, self.beta,
                            self._eps)


class Embedding(nn.Module):
    """Index -> dense vector lookup, weight ``(input_dim, output_dim)``.
    Indices must lie in ``[0, input_dim)``: on CUDA an index out of range
    is a device-side assert (the JAX op fills NaN instead), so callers
    validate indices that come from outside."""

    def __init__(self, input_dim, output_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((input_dim, output_dim),
                                               device=device, dtype=dtype))

    def forward(self, x):
        return F.embedding(x.long(), self.weight)
