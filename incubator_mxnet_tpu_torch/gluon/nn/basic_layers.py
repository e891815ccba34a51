"""Basic layers of the port: ``Dense``, ``LayerNorm``, ``Embedding``,
``BatchNorm`` and ``Flatten`` (counterparts of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py`` and the
``FullyConnected``, ``LayerNorm``, ``Embedding`` and ``BatchNorm`` ops).
Plain ``nn.Module``s with explicit ``device``/``dtype``; ``device=None``
means ``cuda:0`` (``context.resolve_device``: it raises without a GPU).
Parameters are allocated uninitialised and filled by the owner's
``initialize`` or a loaded ``state_dict``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops.fused_conv import bn_affine, bn_stats

__all__ = ["Dense", "LayerNorm", "Embedding", "BatchNorm", "Flatten"]


class Dense(nn.Module):
    """Fully-connected layer ``act(x W^T + b)``.  The weight is
    ``(units, in_units)`` as in MXNet, which is ``F.linear``'s layout;
    ``activation`` is None or ``"relu"``."""

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
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
        device = resolve_device(device)
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
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty((input_dim, output_dim),
                                               device=device, dtype=dtype))

    def forward(self, x):
        return F.embedding(x.long(), self.weight)


class BatchNorm(nn.Module):
    """Batch normalisation over dim 1, the channel axis of the port's
    NCHW-indexed tensors (channels-last or not), as ``x*a + b`` with the
    fp32 ``(a, b)`` of ``ops.fused_conv.bn_affine``.

    * Eval: the running statistics, ``(x - running_mean) *
      rsqrt(running_var + eps) * gamma + beta``.
    * Train: the batch statistics of ``ops.fused_conv.bn_stats`` (the
      JAX package's single-pass fp32 ``_bn_stats``, biased variance),
      then ``update_running`` moves the running statistics towards them.

    ``scale=False`` fixes gamma at 1 (the reference's ``fix_gamma``).
    ``gamma``/``beta`` are parameters, ``running_mean``/``running_var``
    buffers, under the reference's names."""

    def __init__(self, in_channels, epsilon=1e-5, momentum=0.9, scale=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if in_channels < 1:
            raise MXNetError(f"BatchNorm needs in_channels >= 1 (the port "
                             f"does not infer shapes), got {in_channels}")
        self.eps = float(epsilon)
        self.momentum = float(momentum)
        self.fix_gamma = not scale
        self.gamma = nn.Parameter(torch.empty((in_channels,), device=device,
                                              dtype=dtype))
        self.beta = nn.Parameter(torch.empty((in_channels,), device=device,
                                             dtype=dtype))
        self.register_buffer("running_mean", torch.empty(
            (in_channels,), device=device, dtype=dtype))
        self.register_buffer("running_var", torch.empty(
            (in_channels,), device=device, dtype=dtype))

    @torch.no_grad()
    def update_running(self, mean, var):
        """Move the running statistics towards a batch's: ``running =
        momentum * running + (1 - momentum) * batch`` for the mean and the
        biased variance, in place (the JAX frontend's moving-stat update,
        ``ndarray.py``; ``F.batch_norm`` would use the unbiased
        variance, with momentum counted the other way)."""
        m = self.momentum
        for run, batch in ((self.running_mean, mean),
                           (self.running_var, var)):
            run.copy_(m * run + (1 - m) * batch.detach().to(run.dtype))

    def forward(self, x):
        if not self.training:
            a, b = bn_affine(self.gamma, self.beta, self.running_mean,
                             self.running_var, self.eps, self.fix_gamma)
        else:
            mean, var = bn_stats(x)
            a, b = bn_affine(self.gamma, self.beta, mean, var, self.eps,
                             self.fix_gamma)
            self.update_running(mean, var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return torch.addcmul(b.view(shape), x, a.view(shape))


class Flatten(nn.Module):
    """``(N, ...) -> (N, prod(...))``."""

    def forward(self, x):
        return torch.flatten(x, 1)
