"""Shared construction helpers of the port's vision zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/_common.py``)."""
from __future__ import annotations

from torch import nn

from ... import nn as gluon_nn
from ...nn._modules import Activation, BatchNorm, BNReLU

__all__ = ["add_bn_relu", "gluon_bn_relu"]


def add_bn_relu(layers, fuse, channels, **bn_kwargs):
    """Append BatchNorm + ReLU over ``channels`` to the list ``layers``:
    as one ``BNReLU`` (the lean backward) when ``fuse``, else as
    ``BatchNorm`` then ``Activation("relu")``.  The one switch the zoo's
    ``fuse_bn_relu`` goes through for a BN + ReLU pair of a sequence
    (the reference's ``add_bn_relu``).  Both forms take two slots, the
    fused one an ``nn.Identity`` where the ReLU was, so every later
    layer keeps its index and a fused net has the ``state_dict`` keys
    of its unfused twin.  ``bn_kwargs`` go to the norm layer either
    way."""
    if fuse:
        layers += [BNReLU(channels, **bn_kwargs), nn.Identity()]
    else:
        layers += [BatchNorm(channels, **bn_kwargs), Activation("relu")]
    return layers


def gluon_bn_relu(seq, fuse, **bn_kwargs):
    """The same switch for the Gluon zoo models (VGG, DenseNet,
    Inception, MobileNet): append to the ``HybridSequential`` ``seq``
    one ``gluon.nn.BNReLU`` when ``fuse``, else ``BatchNorm`` then
    ``Activation("relu")``, as the JAX package's ``add_bn_relu`` does."""
    if fuse:
        seq.add(gluon_nn.BNReLU(**bn_kwargs))
    else:
        seq.add(gluon_nn.BatchNorm(**bn_kwargs))
        seq.add(gluon_nn.Activation("relu"))
