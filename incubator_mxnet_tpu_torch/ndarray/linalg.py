"""``mx.nd.linalg`` of the port (counterpart of
``incubator_mxnet_tpu/ndarray/linalg.py``; reference
python/mxnet/ndarray/linalg.py): the ``linalg_<name>`` ops by
``<name>`` (``mx.nd.linalg.gemm2(a, b)``)."""
from __future__ import annotations

import sys

from ..ops import find_op
from .op import _make_wrapper

_module = sys.modules[__name__]

__all__ = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
           "syevd", "gelqf", "sumlogdiag"]


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    if find_op("linalg_" + name) is None:
        raise AttributeError(f"no linalg op '{name}'")
    w = _make_wrapper("linalg_" + name)
    w.__name__ = name
    setattr(_module, name, w)
    return w
