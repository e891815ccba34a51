"""Inception-BN (GoogLeNet v2) of the port (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/inception_bn.py``;
reference example/image-classification/symbols/inception-bn.py, after
Ioffe & Szegedy 2015): the module channel plan, double-3x3 towers and
avg/max pool projections, written with ``contrib.nn.HybridConcurrent``
for 224x224 inputs."""
from __future__ import annotations

from ...block import HybridBlock
from ._common import gluon_bn_relu as add_bn_relu
from ...contrib.nn import HybridConcurrent
from ...nn import (HybridSequential, Conv2D, Dense, MaxPool2D, AvgPool2D,
                   GlobalAvgPool2D, Flatten)

__all__ = ["InceptionBN", "inception_bn"]


def _conv_bn_relu(channels, kernel, stride=1, pad=0, fuse_bn_relu=False):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, kernel, stride, pad, use_bias=False))
    add_bn_relu(out, fuse_bn_relu, epsilon=1e-10 + 1e-5)
    return out


def _Concurrent():
    return HybridConcurrent(axis=1)


def _branch(pool, *convs, fuse_bn_relu=False):
    """Optional leading pool, then a chain of (channels, kernel, stride,
    pad) conv-bn-relu units."""
    out = HybridSequential(prefix="")
    if pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=1, padding=1))
    elif pool == "max2":
        out.add(MaxPool2D(pool_size=3, strides=2, padding=1))
    for c, k, s, p in convs:
        out.add(_conv_bn_relu(c, k, s, p, fuse_bn_relu=fuse_bn_relu))
    return out


def _module_a(n1, n3r, n3, nd3r, nd3, pool, proj, fuse_bn_relu=False):
    """Stride-1 module: 1x1 | 1x1-3x3 | 1x1-3x3-3x3 | pool-1x1proj."""
    out = _Concurrent()
    f = fuse_bn_relu
    with out.name_scope():
        out.add(_branch(None, (n1, 1, 1, 0), fuse_bn_relu=f))
        out.add(_branch(None, (n3r, 1, 1, 0), (n3, 3, 1, 1),
                        fuse_bn_relu=f))
        out.add(_branch(None, (nd3r, 1, 1, 0), (nd3, 3, 1, 1),
                        (nd3, 3, 1, 1), fuse_bn_relu=f))
        out.add(_branch(pool, (proj, 1, 1, 0), fuse_bn_relu=f))
    return out


def _module_b(n3r, n3, nd3r, nd3, fuse_bn_relu=False):
    """Stride-2 reduction: 1x1-3x3/2 | 1x1-3x3-3x3/2 | maxpool/2."""
    out = _Concurrent()
    f = fuse_bn_relu
    with out.name_scope():
        out.add(_branch(None, (n3r, 1, 1, 0), (n3, 3, 2, 1),
                        fuse_bn_relu=f))
        out.add(_branch(None, (nd3r, 1, 1, 0), (nd3, 3, 1, 1),
                        (nd3, 3, 2, 1), fuse_bn_relu=f))
        out.add(_branch("max2", fuse_bn_relu=f))
    return out


class InceptionBN(HybridBlock):
    """Inception with Batch Normalization for 224x224 inputs."""

    def __init__(self, classes=1000, fuse_bn_relu=False, **kwargs):
        super().__init__(**kwargs)
        f = fuse_bn_relu
        with self.name_scope():
            net = self.features = HybridSequential(prefix="")
            net.add(_conv_bn_relu(64, 7, 2, 3, fuse_bn_relu=f))
            net.add(MaxPool2D(pool_size=3, strides=2))
            net.add(_conv_bn_relu(64, 1, fuse_bn_relu=f))
            net.add(_conv_bn_relu(192, 3, 1, 1, fuse_bn_relu=f))
            net.add(MaxPool2D(pool_size=3, strides=2))
            net.add(_module_a(64, 64, 64, 64, 96, "avg", 32, f))
            net.add(_module_a(64, 64, 96, 64, 96, "avg", 64, f))
            net.add(_module_b(128, 160, 64, 96, f))
            net.add(_module_a(224, 64, 96, 96, 128, "avg", 128, f))
            net.add(_module_a(192, 96, 128, 96, 128, "avg", 128, f))
            net.add(_module_a(160, 128, 160, 128, 160, "avg", 128, f))
            net.add(_module_a(96, 128, 192, 160, 192, "avg", 128, f))
            net.add(_module_b(128, 192, 192, 256, f))
            net.add(_module_a(352, 192, 320, 160, 224, "avg", 128, f))
            net.add(_module_a(352, 192, 320, 192, 224, "max", 128, f))
            net.add(GlobalAvgPool2D())
            net.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_bn(**kwargs):
    return InceptionBN(**kwargs)
