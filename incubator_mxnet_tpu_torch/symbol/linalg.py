"""``mx.sym.linalg`` (counterpart of
``incubator_mxnet_tpu/symbol/linalg.py``): the registry's
``linalg_<name>`` ops by ``<name>``.  The linalg ops are ROADMAP A8, so
until then every name raises AttributeError."""
from __future__ import annotations

import sys

from ..ops import find_op
from .symbol import _make_sym_op

_module = sys.modules[__name__]

__all__ = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
           "syevd", "gelqf", "sumlogdiag"]


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    if find_op("linalg_" + name) is None:
        raise AttributeError(f"no linalg op '{name}' (ROADMAP A8)")
    w = _make_sym_op("linalg_" + name)
    setattr(_module, name, w)
    return w
