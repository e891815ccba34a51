"""Symbolic API of the port (counterpart of
``incubator_mxnet_tpu/symbol/``; reference python/mxnet/symbol/):
``Symbol``, ``var``, ``Group``, ``load``/``load_json``, one generated
``mx.sym.<op>`` per registered op, the ``contrib``, ``linalg``,
``random`` and ``sparse`` namespaces, and the graph passes."""
import sys as _sys

from .symbol import Symbol, var, Variable, Group, load, load_json
from .op import *          # noqa: F401,F403
from . import op
from . import contrib
from . import linalg
from . import random
from . import sparse
from . import passes
from .passes import Graph, apply_pass, apply_passes, register_pass
from .symbol import _create
from ..ops import find_op as _find_op
from .symbol import _make_sym_op as _mk

_module = _sys.modules[__name__]


def __getattr__(name):
    if _find_op(name) is None:
        raise AttributeError(name)
    w = _mk(name)
    setattr(_module, name, w)
    return w
