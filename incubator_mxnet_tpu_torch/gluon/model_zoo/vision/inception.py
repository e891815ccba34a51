"""Inception V3 of the port (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/inception.py``; reference
python/mxnet/gluon/model_zoo/vision/inception.py).  It takes 299x299
images; its ``AvgPool2D(3, 1, 1)`` branches count the padding, as
MXNet's do."""
from __future__ import annotations

from ...block import HybridBlock
from ._common import gluon_bn_relu as add_bn_relu
from ...nn import (HybridSequential, Conv2D, Dense, BatchNorm, Activation,
                   MaxPool2D, AvgPool2D, GlobalAvgPool2D, Flatten, Dropout)

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(fuse_bn_relu=False, **kwargs):
    out = HybridSequential(prefix="")
    out.add(Conv2D(use_bias=False, **kwargs))
    add_bn_relu(out, fuse_bn_relu, epsilon=0.001)
    return out


def _make_branch(use_pool, *conv_settings, fuse_bn_relu=False):
    out = HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(fuse_bn_relu=fuse_bn_relu, **kwargs))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches concatenated on channels (reference
    gluon/contrib HybridConcurrent used by inception)."""

    def __init__(self, axis=1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


def _make_A(pool_features, prefix, fuse_bn_relu=False):
    out = _Concurrent(prefix=prefix)
    f = fuse_bn_relu
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None), fuse_bn_relu=f))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2),
                             fuse_bn_relu=f))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1), fuse_bn_relu=f))
        out.add(_make_branch("avg", (pool_features, 1, None, None),
                             fuse_bn_relu=f))
    return out


def _make_B(prefix, fuse_bn_relu=False):
    out = _Concurrent(prefix=prefix)
    f = fuse_bn_relu
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None), fuse_bn_relu=f))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None), fuse_bn_relu=f))
        out.add(_make_branch("max", fuse_bn_relu=f))
    return out


def _make_C(channels_7x7, prefix, fuse_bn_relu=False):
    out = _Concurrent(prefix=prefix)
    f = fuse_bn_relu
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), fuse_bn_relu=f))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)), fuse_bn_relu=f))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3)), fuse_bn_relu=f))
        out.add(_make_branch("avg", (192, 1, None, None), fuse_bn_relu=f))
    return out


def _make_D(prefix, fuse_bn_relu=False):
    out = _Concurrent(prefix=prefix)
    f = fuse_bn_relu
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None),
                             fuse_bn_relu=f))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None), fuse_bn_relu=f))
        out.add(_make_branch("max", fuse_bn_relu=f))
    return out


class _InceptionE(HybridBlock):
    def __init__(self, prefix=None, params=None, fuse_bn_relu=False):
        super().__init__(prefix=prefix, params=params)
        f = fuse_bn_relu
        with self.name_scope():
            self.branch1 = _make_branch(None, (320, 1, None, None),
                                        fuse_bn_relu=f)
            self.branch2_stem = _make_basic_conv(channels=384, kernel_size=1,
                                                 fuse_bn_relu=f)
            self.branch2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                              padding=(0, 1), fuse_bn_relu=f)
            self.branch2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                              padding=(1, 0), fuse_bn_relu=f)
            self.branch3_stem = _make_branch(None, (448, 1, None, None),
                                             (384, 3, None, 1),
                                             fuse_bn_relu=f)
            self.branch3_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                              padding=(0, 1), fuse_bn_relu=f)
            self.branch3_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                              padding=(1, 0), fuse_bn_relu=f)
            self.branch4 = _make_branch("avg", (192, 1, None, None),
                                        fuse_bn_relu=f)

    def hybrid_forward(self, F, x):
        o1 = self.branch1(x)
        s2 = self.branch2_stem(x)
        o2 = F.Concat(self.branch2_a(s2), self.branch2_b(s2), dim=1)
        s3 = self.branch3_stem(x)
        o3 = F.Concat(self.branch3_a(s3), self.branch3_b(s3), dim=1)
        o4 = self.branch4(x)
        return F.Concat(o1, o2, o3, o4, dim=1)


class Inception3(HybridBlock):
    """(reference inception.py:Inception3)."""

    def __init__(self, classes=1000, fuse_bn_relu=False, **kwargs):
        super().__init__(**kwargs)
        f = fuse_bn_relu
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2, fuse_bn_relu=f))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               fuse_bn_relu=f))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1, fuse_bn_relu=f))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1,
                                               fuse_bn_relu=f))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3,
                                               fuse_bn_relu=f))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_", fuse_bn_relu=f))
            self.features.add(_make_A(64, "A2_", fuse_bn_relu=f))
            self.features.add(_make_A(64, "A3_", fuse_bn_relu=f))
            self.features.add(_make_B("B_", fuse_bn_relu=f))
            self.features.add(_make_C(128, "C1_", fuse_bn_relu=f))
            self.features.add(_make_C(160, "C2_", fuse_bn_relu=f))
            self.features.add(_make_C(160, "C3_", fuse_bn_relu=f))
            self.features.add(_make_C(192, "C4_", fuse_bn_relu=f))
            self.features.add(_make_D("D_", fuse_bn_relu=f))
            self.features.add(_InceptionE(prefix="E1_", fuse_bn_relu=f))
            self.features.add(_InceptionE(prefix="E2_", fuse_bn_relu=f))
            self.features.add(AvgPool2D(pool_size=8))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, ctx=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        raise IOError("pretrained weights unavailable offline")
    return net
