"""``mx.sym.contrib`` (counterpart of
``incubator_mxnet_tpu/symbol/contrib.py``): the registry's
``_contrib_<name>`` ops by ``<name>`` (``ops/contrib.py``)."""
from __future__ import annotations

import sys

from ..ops import find_op, list_ops
from .symbol import _make_sym_op

_module = sys.modules[__name__]
_PREFIX = "_contrib_"

for _name in list_ops():
    if _name.startswith(_PREFIX):
        setattr(_module, _name[len(_PREFIX):], _make_sym_op(_name))


def __getattr__(name):
    if find_op(_PREFIX + name) is None:
        raise AttributeError(name)
    w = _make_sym_op(_PREFIX + name)
    setattr(_module, name, w)
    return w
