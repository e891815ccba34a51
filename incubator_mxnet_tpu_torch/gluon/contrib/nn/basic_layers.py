"""Contrib basic layers of the port (counterpart of
``incubator_mxnet_tpu/gluon/contrib/nn/basic_layers.py``; reference
gluon/contrib/nn/basic_layers.py): ``Concurrent``, ``HybridConcurrent``
and ``Identity``.  The branches run one after another on the same
input and their outputs are joined by ``Concat`` along ``axis``."""
from __future__ import annotations

from .... import ndarray as nd_mod
from ...block import HybridBlock
from ...nn.basic_layers import HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class Concurrent(Sequential):
    """Run the children on the same input, concatenate their outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd_mod.Concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The hybridizable ``Concurrent``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """The identity block: a ``Concurrent``'s skip branch."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x
