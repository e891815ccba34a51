"""Generated symbolic op namespace ``mx.sym.*`` (counterpart of
``incubator_mxnet_tpu/symbol/op.py``; reference
python/mxnet/symbol/op.py generated wrappers): one composing wrapper
per op of the port's registry, and ``zeros``/``ones``."""
from __future__ import annotations

import sys

from ..ops import find_op, list_ops
from .symbol import _make_sym_op

_module = sys.modules[__name__]

for _name in list_ops():
    if not hasattr(_module, _name):
        setattr(_module, _name, _make_sym_op(_name))


def __getattr__(name):
    if find_op(name) is None:
        raise AttributeError(name)
    w = _make_sym_op(name)
    setattr(_module, name, w)
    return w


def zeros(shape, dtype=None, **kwargs):
    """mx.sym.zeros (reference symbol.py:zeros -> _internal._zeros)."""
    if shape is None:
        raise ValueError("mx.sym.zeros requires a shape")
    return _make_sym_op("_zeros")(shape=shape, dtype=dtype or "float32",
                                  **kwargs)


def ones(shape, dtype=None, **kwargs):
    """mx.sym.ones (reference symbol.py:ones -> _internal._ones)."""
    if shape is None:
        raise ValueError("mx.sym.ones requires a shape")
    return _make_sym_op("_ones")(shape=shape, dtype=dtype or "float32",
                                 **kwargs)
