"""``mx.sym.sparse`` (counterpart of
``incubator_mxnet_tpu/symbol/sparse.py``): the names of the reference's
sparse symbol namespace.  Sparse storage is ROADMAP A8 in the port, on
the symbolic side as on the ``nd`` side, so each raises MXNetError."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["dot", "zeros_like", "cast_storage", "retain", "square_sum"]


def _not_ported(name):
    def fn(*args, **kwargs):
        raise MXNetError(f"mx.sym.sparse.{name} needs sparse storage, "
                         "which is not ported yet (ROADMAP A8)")
    fn.__name__ = name
    return fn


dot = _not_ported("dot")
zeros_like = _not_ported("zeros_like")
cast_storage = _not_ported("cast_storage")
retain = _not_ported("retain")
square_sum = _not_ported("square_sum")
