"""MobileNet v1 of the port (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``; reference
python/mxnet/gluon/model_zoo/vision/mobilenet.py).  The depthwise 3x3
convolutions are grouped ``Conv2D``s (``groups`` = channels)."""
from __future__ import annotations

from ...block import HybridBlock
from ._common import gluon_bn_relu as add_bn_relu
from ...nn import (HybridSequential, Conv2D, Dense, BatchNorm, Activation,
                   GlobalAvgPool2D, Flatten)

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "get_mobilenet"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              fuse_bn_relu=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False))
    add_bn_relu(out, fuse_bn_relu, scale=True)


def _add_conv_dw(out, dw_channels, channels, stride, fuse_bn_relu=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, fuse_bn_relu=fuse_bn_relu)
    _add_conv(out, channels, fuse_bn_relu=fuse_bn_relu)


class MobileNet(HybridBlock):
    """(reference mobilenet.py:MobileNet)."""

    def __init__(self, multiplier=1.0, classes=1000, fuse_bn_relu=False,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, fuse_bn_relu=fuse_bn_relu)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 +
                               [512] * 6 + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6 +
                            [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dwc, c, s,
                                 fuse_bn_relu=fuse_bn_relu)
                self.features.add(GlobalAvgPool2D())
                self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_mobilenet(multiplier, pretrained=False, ctx=None, **kwargs):
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        raise IOError("pretrained weights unavailable offline")
    return net


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)
