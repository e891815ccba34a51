"""Convolution and pooling layers of the port (counterparts of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py`` ``Conv2D``,
``MaxPool2D``, ``GlobalAvgPool2D``, ``FusedBNReLUConv2D`` and
``FusedBottleneckChain``).

Tensors are NCHW-indexed.  ``layout="NHWC"`` keeps them channels-last
in memory (``torch.channels_last``), the port's counterpart of the JAX
package's NHWC layout: every layer here preserves that format, and
``Conv2D`` stores its OIHW weight channels-last too, so cuDNN runs the
plain convolutions without converting and the fused 3x3 kernel reads
the weight's storage as OHWI.  The weight's shape, and so the
``state_dict``, stays OIHW.  Unlike the JAX layers, which infer input
channels at their first forward, these need ``in_channels``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops.fused_chain import chain_supported, fused_bottleneck_chain
from ...ops.fused_conv import fused_bn_relu_conv, supported
from .basic_layers import BatchNorm, BNReLU

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D", "FusedBNReLUConv2D",
           "FusedBottleneckChain"]

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
