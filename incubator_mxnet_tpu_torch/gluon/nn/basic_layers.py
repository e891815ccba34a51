"""Basic layers of the port: ``Dense``, ``LayerNorm``, ``Embedding``,
``BatchNorm``, ``BNReLU`` and ``Flatten`` (counterparts of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py`` and the
``FullyConnected``, ``LayerNorm``, ``Embedding``, ``BatchNorm`` and
``_FusedBatchNormRelu`` ops).
Plain ``nn.Module``s with explicit ``device``/``dtype``; ``device=None``
means ``cuda:0`` (``context.resolve_device``: it raises without a GPU).
Parameters are allocated uninitialised and filled by the owner's
``initialize`` or a loaded ``state_dict``."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops.fused_conv import bn_affine, bn_stats
from ...ops.nn import fused_batch_norm_relu

__all__ = ["Dense", "LayerNorm", "Embedding", "BatchNorm", "BNReLU",
           "Flatten"]


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


@functools.lru_cache(maxsize=None)
def _rounded(value, dtype):
    """The Python float ``value`` rounded to ``dtype``."""
    return torch.tensor(value, dtype=dtype).item()


class BatchNorm(nn.Module):
    """Batch normalisation over dim 1, the channel axis of the port's
    NCHW-indexed tensors (channels-last or not).

    * Eval: the running statistics, ``(x - running_mean) *
      rsqrt(running_var + eps) * gamma + beta``.
    * Train: the batch statistics of ``ops.fused_conv.bn_stats`` (the
      JAX package's single-pass fp32 ``_bn_stats``, biased variance),
      then ``update_running`` moves the running statistics towards them.

    An fp32 x is normalised as ``x*a + b`` with the fp32 ``(a, b)`` of
    ``ops.fused_conv.bn_affine`` (one pass); any other dtype (bf16 under
    ``TrainStep(bf16_compute=True)``) by the JAX op's own formula in
    that dtype: the statistics rounded to it, then ``(x - mean) * inv *
    gamma + beta``.

    ``scale=False`` fixes gamma at 1 (the reference's ``fix_gamma``) and
    ``center=False`` keeps beta at the value it holds (0 as the model zoo
    initialises it): neither then requires a gradient, so no step
    updates or decays it (the JAX layer's ``grad_req="null"``).
    ``gamma``/``beta`` are parameters either way, ``running_mean``/
    ``running_var`` buffers, under the reference's names."""

    def __init__(self, in_channels, epsilon=1e-5, momentum=0.9, scale=True,
                 center=True, device=None, dtype=torch.float32):
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
        self.gamma.requires_grad_(bool(scale))
        self.beta.requires_grad_(bool(center))
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
        variance, with momentum counted the other way).  In the buffers'
        dtype: for bf16 buffers (``TrainStep(bf16_compute=True)``) the
        two factors are rounded to bf16 first, as JAX rounds a Python
        scalar to the dtype of the array it multiplies."""
        dtype = self.running_mean.dtype
        m, rest = (_rounded(v, dtype)
                   for v in (self.momentum, 1 - self.momentum))
        for run, batch in ((self.running_mean, mean),
                           (self.running_var, var)):
            run.copy_(m * run + rest * batch.detach().to(dtype))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = bn_stats(x)
            self.update_running(mean, var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if x.dtype == torch.float32:
            a, b = bn_affine(self.gamma, self.beta, mean, var, self.eps,
                             self.fix_gamma)
            return torch.addcmul(b.view(shape), x, a.view(shape))
        # four passes, each rounded to x's dtype as the JAX op rounds
        # them: one addcmul in x's dtype is one bf16 step off at the
        # largest output in eval, the fp32 affine rounded once two steps
        # off in train (test_torch_train.py's
        # test_batchnorm_bf16_matches_jax, 2^-8 of max)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        g = torch.ones_like(self.gamma) if self.fix_gamma else self.gamma
        # rsqrt rounded once, as XLA's: torch's bf16 rsqrt on the CPU
        # rounds the sqrt first
        inv = torch.rsqrt((var + self.eps).float()).to(x.dtype)
        return (x - mean.view(shape)) * inv.view(shape) * g.view(shape) + \
            self.beta.view(shape)


class BNReLU(BatchNorm):
    """BatchNorm + ReLU as one op (reference ``basic_layers.py:BNReLU``):
    ``ops.nn.fused_batch_norm_relu``, whose backward saves only the
    normalised tensor and reads one full tensor fewer than autograd of
    ``BatchNorm`` then ``Activation("relu")``.  The same parameters and
    buffers under the same names as ``BatchNorm``, so ``state_dict``s
    interchange with that pair; in train mode ``update_running`` moves
    the running statistics towards the batch's."""

    def forward(self, x):
        y, mean, var = fused_batch_norm_relu(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            self.eps, self.fix_gamma, self.training)
        if self.training:
            self.update_running(mean, var)
        return y


class Flatten(nn.Module):
    """``(N, ...) -> (N, prod(...))``."""

    def forward(self, x):
        return torch.flatten(x, 1)
