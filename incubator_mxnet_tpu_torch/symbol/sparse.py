"""``mx.sym.sparse`` (counterpart of
``incubator_mxnet_tpu/symbol/sparse.py``; reference
python/mxnet/symbol/sparse.py).  Symbolic graphs are dense, as in the
JAX package: each name composes the dense ops of the same meaning, and
real sparse storage lives on the eager side (``nd.sparse``).  The
storage-type pass (``passes.py``, ``InferStorageType``) still reports
what a sparse input would dispatch to."""
from __future__ import annotations

from ..base import MXNetError
from .symbol import _make_sym_op

__all__ = ["dot", "zeros_like", "cast_storage", "retain", "square_sum"]


def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    """csr x dense in the reference; the dense ``dot`` here."""
    return _make_sym_op("dot")(lhs, rhs, transpose_a=transpose_a,
                               transpose_b=transpose_b, **kwargs)


def zeros_like(data, **kwargs):
    return _make_sym_op("zeros_like")(data, **kwargs)


def cast_storage(data, stype=None, **kwargs):
    """The identity on the dense graph (``stype`` is checked)."""
    if stype not in (None, "default", "row_sparse", "csr"):
        raise MXNetError(f"unknown stype {stype}")
    return _make_sym_op("identity")(data, **kwargs)


def retain(data, indices, num_rows=None, **kwargs):
    """The rows of ``data`` listed in ``indices`` kept, the others
    zeroed (sparse_retain on the dense graph); ``num_rows`` is the
    static row count of ``data``."""
    if num_rows is None:
        raise MXNetError(
            "symbolic sparse.retain needs num_rows= (static row count); "
            "or use nd.sparse RowSparseNDArray.retain on the eager path")
    onehot = _make_sym_op("one_hot")(indices, depth=num_rows, **kwargs)
    mask = _make_sym_op("max")(onehot, axis=0)
    mask = _make_sym_op("expand_dims")(mask, axis=1)
    return _make_sym_op("broadcast_mul")(data, mask)


def square_sum(data, axis=None, keepdims=False, **kwargs):
    sq = _make_sym_op("square")(data)
    return _make_sym_op("sum")(sq, axis=axis, keepdims=keepdims, **kwargs)
