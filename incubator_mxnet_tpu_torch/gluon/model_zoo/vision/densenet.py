"""DenseNet 121/161/169/201 of the port (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/densenet.py``; reference
python/mxnet/gluon/model_zoo/vision/densenet.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dense, MaxPool2D, AvgPool2D,
                   GlobalAvgPool2D, Flatten, Dropout)
from ._common import gluon_bn_relu as _add_bn_relu

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseLayer(HybridBlock):
    """BN-relu-conv1-BN-relu-conv3 with concat growth
    (reference densenet.py:_make_dense_layer)."""

    def __init__(self, growth_rate, bn_size, dropout, fuse_bn_relu=False,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = HybridSequential(prefix="")
        _add_bn_relu(self.body, fuse_bn_relu)
        self.body.add(Conv2D(bn_size * growth_rate, kernel_size=1,
                             use_bias=False))
        _add_bn_relu(self.body, fuse_bn_relu)
        self.body.add(Conv2D(growth_rate, kernel_size=3, padding=1,
                             use_bias=False))
        if dropout:
            self.body.add(Dropout(dropout))

    def hybrid_forward(self, F, x):
        out = self.body(x)
        return F.Concat(x, out, dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout, stage_index,
                      fuse_bn_relu=False):
    out = HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout,
                                fuse_bn_relu=fuse_bn_relu))
    return out


def _make_transition(num_output_features, fuse_bn_relu=False):
    out = HybridSequential(prefix="")
    _add_bn_relu(out, fuse_bn_relu)
    out.add(Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """(reference densenet.py:DenseNet)."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, fuse_bn_relu=False,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, kernel_size=7,
                                     strides=2, padding=3, use_bias=False))
            _add_bn_relu(self.features, fuse_bn_relu)
            self.features.add(MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1,
                    fuse_bn_relu=fuse_bn_relu))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(
                        num_features // 2, fuse_bn_relu=fuse_bn_relu))
                    num_features = num_features // 2
            _add_bn_relu(self.features, fuse_bn_relu)
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


# (init_features, growth_rate, block_config) — reference densenet.py:densenet_spec
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=None, **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config, **kwargs)
    if pretrained:
        raise IOError("pretrained weights unavailable offline")
    return net


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
