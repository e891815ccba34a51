"""The tensor-level layers of the port: plain ``torch.nn.Module``s over
``torch.Tensor``s, which the model zoo, the decoder, ``TrainStep``,
``EvalStep``, ``BlockPredictor`` and the generation engine build on.

This is one of the two families of ``gluon.nn`` layers.  The public
``gluon.nn`` classes are the Gluon blocks of the JAX package
(``Block``/``HybridBlock`` with ``Parameter``s, ``NDArray`` in and out,
``hybrid_forward`` over the ``nd`` ops, the JAX constructors); the
classes here keep the port's own signatures, numerics and
``state_dict`` keys, with ``torch.nn.Parameter`` attributes that the
zoo and ``convert`` read as tensors.  The two cannot be one class: a
Gluon ``Parameter`` answers ``p.data()`` as a call, while torch itself
uses a ``torch.nn.Parameter``'s ``.data`` attribute.

* ``Dense``, ``LayerNorm``, ``Embedding``, ``BatchNorm``, ``BNReLU``,
  ``Flatten`` (the ``FullyConnected``, ``LayerNorm``, ``Embedding``,
  ``BatchNorm`` and ``_FusedBatchNormRelu`` ops): explicit
  ``device``/``dtype``, ``device=None`` meaning ``cuda:0``
  (``context.resolve_device``: it raises without a GPU).  Parameters
  are allocated uninitialised and filled by the owner's ``initialize``
  or a loaded ``state_dict``.
* ``Activation`` (``"relu"`` only; any other raises at construction).
* ``Conv2D``, ``MaxPool2D``, ``GlobalAvgPool2D``, ``FusedBNReLUConv2D``
  and ``FusedBottleneckChain``.  Tensors are NCHW-indexed;
  ``layout="NHWC"`` keeps them channels-last in memory
  (``torch.channels_last``), the port's counterpart of the JAX NHWC
  layout: every layer preserves that format, and ``Conv2D`` stores its
  OIHW weight channels-last too, so cuDNN runs the plain convolutions
  without converting and the fused 3x3 kernel reads the weight's
  storage as OHWI.  The weight's shape, and so the ``state_dict``, stays
  OIHW.  Unlike the JAX layers these need ``in_channels``.
* ``Loss`` and ``SoftmaxCrossEntropyLoss`` over tensors, the loss
  ``TrainStep`` takes: one value per sample, the batch axis kept and
  every other axis averaged.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops.fused_chain import chain_supported, fused_bottleneck_chain
from ...ops.fused_conv import (bn_affine, bn_stats, fused_bn_relu_conv,
                               supported)
from ...ops.nn import fused_batch_norm_relu

__all__ = ["Activation", "BatchNorm", "BNReLU", "Conv2D", "Dense",
           "Embedding", "Flatten", "FusedBNReLUConv2D",
           "FusedBottleneckChain", "GlobalAvgPool2D", "LayerNorm", "Loss",
           "MaxPool2D", "SoftmaxCELoss", "SoftmaxCrossEntropyLoss"]



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



class Activation(nn.Module):
    """``act_type(x)`` elementwise; ``"relu"`` only so far."""

    def __init__(self, act_type):
        super().__init__()
        if act_type != "relu":
            raise MXNetError(f"Activation({act_type!r}) is not ported yet: "
                             "only 'relu'")
        self.act_type = act_type

    def forward(self, x):
        return torch.relu(x)


LAYOUTS = ("NCHW", "NHWC")


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v),) * 2


def _check_layout(layout):
    if layout not in LAYOUTS:
        raise MXNetError(f"layout must be one of {LAYOUTS}, got {layout!r}")


class Conv2D(nn.Module):
    """2-D convolution through cuDNN (``F.conv2d``), as the JAX package
    leaves it to XLA: weight ``(channels, in_channels // groups, kh,
    kw)``, bias ``(channels,)`` when ``use_bias``."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 groups=1, layout="NCHW", in_channels=0, use_bias=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        _check_layout(layout)
        if in_channels < 1:
            raise MXNetError(f"Conv2D needs in_channels >= 1 (the port does "
                             f"not infer shapes), got {in_channels}")
        if in_channels % groups or channels % groups:
            raise MXNetError(f"Conv2D channels {in_channels} -> {channels} "
                             f"do not divide into {groups} groups")
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(strides)
        self.padding = _pair(padding)
        self.groups = groups
        self.layout = layout
        fmt = torch.channels_last if layout == "NHWC" \
            else torch.contiguous_format
        self.weight = nn.Parameter(torch.empty(
            (channels, in_channels // groups) + self.kernel_size,
            device=device, dtype=dtype, memory_format=fmt))
        if use_bias:
            self.bias = nn.Parameter(torch.empty((channels,), device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        groups=self.groups)


class MaxPool2D(nn.Module):
    """Max pooling with ``-inf`` padding (``pooling_convention="valid"``;
    the reference's ``ceil_mode`` is not ported yet)."""

    def __init__(self, pool_size=2, strides=None, padding=0):
        super().__init__()
        self.pool_size = _pair(pool_size)
        self.stride = _pair(strides) if strides is not None \
            else self.pool_size
        self.padding = _pair(padding)

    def forward(self, x):
        return F.max_pool2d(x, self.pool_size, self.stride, self.padding)


class GlobalAvgPool2D(nn.Module):
    """Mean over H and W, keeping them as size 1: ``(N, C, 1, 1)``."""

    def forward(self, x):
        return x.mean(dim=(2, 3), keepdim=True)


class FusedBNReLUConv2D(nn.Module):
    """BatchNorm -> ReLU -> Conv2D as one op.

    Its children ``bn`` (``BatchNorm``) and ``conv`` (``Conv2D``) hold
    the parameters, so the layer's names are those of the unfused
    sequence.  Inside the kernels' envelope (``ops.fused_conv.
    supported``: ``layout="NHWC"``, fp32 or bf16, stride 1, ungrouped,
    1x1 pad 0 or 3x3 pad 1) and with ``fuse=True`` it runs
    ``ops.fused_conv.fused_bn_relu_conv``, which on the card is one
    kernel launch in the dtype of the tensors it is given (a layer built
    in fp32 and run over bf16 copies of its parameters, as
    ``TrainStep(bf16_compute=True)`` runs it, launches the bf16 form);
    else it runs the plain composition BN, ReLU, ``F.conv2d``.  The
    choice is made here, from the configuration, and read from
    ``self.fused``.
    ``bn_relu=True`` makes ``bn`` a ``BNReLU`` (the same names), and the
    plain composition then runs BN and ReLU as that one op: the model
    zoo's ``fuse_bn_relu`` for a boundary that is not fused into the
    conv.  In train mode the BN takes the batch's statistics and moves
    its running ones towards them (``BatchNorm.update_running``)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 groups=1, layout="NCHW", in_channels=0, use_bias=False,
                 epsilon=1e-5, momentum=0.9, fuse=True, bn_relu=False,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        norm = BNReLU if bn_relu else BatchNorm
        self.bn = norm(in_channels, epsilon=epsilon, momentum=momentum,
                       device=device, dtype=dtype)
        self.conv = Conv2D(channels, kernel_size, strides, padding,
                           groups=groups, layout=layout,
                           in_channels=in_channels, use_bias=use_bias,
                           device=device, dtype=dtype)
        conv = self.conv
        self.fused = bool(fuse) and supported(
            conv.kernel_size, conv.stride, conv.padding, groups, layout,
            dtype)

    def forward(self, x):
        bn, conv = self.bn, self.conv
        if not self.fused:
            return conv(bn(x) if isinstance(bn, BNReLU) else
                        torch.relu(bn(x)))
        out, mean, var = fused_bn_relu_conv(
            x, bn.gamma, bn.beta, bn.running_mean, bn.running_var,
            conv.weight, conv.bias, kernel=conv.kernel_size, eps=bn.eps,
            fix_gamma=bn.fix_gamma, train_stats=self.training,
            output_mean_var=True)
        if self.training:
            bn.update_running(mean, var)
        return out


class FusedBottleneckChain(nn.Module):
    """[BN -> ReLU -> Conv3x3 -> BN -> ReLU -> Conv1x1] as one op: the
    bottleneck interior of the JAX package's ``FusedBottleneckChain``,
    run by ``ops.fused_chain.fused_bottleneck_chain`` (on the card two
    kernel launches in train mode, one in eval).

    Its parameters live on the two ``FusedBNReLUConv2D`` layers it is
    given, ``first`` (BN1 and the 3x3 conv2: stride 1, pad 1,
    ungrouped) and ``second`` (BN2 and the 1x1 conv3 with bias), which
    the caller registers: the chain holds them without registering them
    again, so a chain model has exactly the parameter names (and
    ``state_dict``) of its ``fuse_block=True`` twin and checkpoints
    interchange.  Inside the kernels' envelope (``ops.fused_chain.
    chain_supported``) ``self.fused`` is True; else the chain runs the
    two layers one after the other (their own forms).  ``train()`` and
    ``eval()`` reach the two layers too.  In train mode both BNs move
    their running statistics towards the batch's."""

    def __init__(self, first, second):
        super().__init__()
        c2, c3 = first.conv, second.conv
        if (c2.kernel_size, c2.stride, c2.padding, c2.groups) != \
                ((3, 3), (1, 1), (1, 1), 1) or c2.bias is not None or \
                (c3.kernel_size, c3.stride, c3.padding, c3.groups) != \
                ((1, 1), (1, 1), (0, 0), 1) or c3.bias is None or \
                c3.weight.shape[1] != c2.weight.shape[0]:
            raise MXNetError(
                "FusedBottleneckChain needs a 3x3 stride-1 pad-1 conv "
                "without bias, then a 1x1 conv with bias over its output")
        self._layers = (first, second)   # a tuple: not registered again
        self.fused = c2.layout == c3.layout and chain_supported(
            c2.weight.shape[0], c2.layout, c2.weight.dtype)

    def train(self, mode=True):
        """Set the mode of the chain and of its two layers."""
        super().train(mode)
        for layer in self._layers:
            layer.train(mode)
        return self

    def forward(self, x):
        first, second = self._layers
        if not self.fused:
            return second(first(x))
        bn1, bn2 = first.bn, second.bn
        out, mean1, var1, mean2, var2 = fused_bottleneck_chain(
            x, bn1.gamma, bn1.beta, bn1.running_mean, bn1.running_var,
            first.conv.weight, bn2.gamma, bn2.beta, bn2.running_mean,
            bn2.running_var, second.conv.weight, second.conv.bias,
            eps=bn1.eps, fix_gamma=bn1.fix_gamma, train_stats=self.training)
        if self.training:
            bn1.update_running(mean1, var1)
            bn2.update_running(mean2, var2)
        return out



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
