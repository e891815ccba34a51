"""The NDArray package of the port (counterpart of
``incubator_mxnet_tpu/ndarray/``; reference python/mxnet/ndarray/):
``NDArray``, the creation functions, the generated op wrappers at
package level, ``nd.random``, ``nd.contrib`` (the ``_contrib_`` ops),
``nd.linalg``, ``nd.image`` (the ``_image_`` ops), ``nd.sparse`` (the
row_sparse and csr arrays) with the storage functions ``cast_storage``,
``sparse_retain`` and ``square_sum``, and ``nd.save`` / ``nd.load``."""
import sys as _sys

from . import _internal, op, random  # noqa: F401
from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      imperative_invoke, invoke, moveaxis, ones, waitall,
                      zeros)
from .op import *  # noqa: F401,F403 — generated op wrappers
from .op import _populate as _populate_ops
from .utils import load, save

_populate_ops(_sys.modules[__name__])

from . import contrib, image, linalg, sparse  # noqa: E402,F401
from .sparse import (BaseSparseNDArray, CSRNDArray,  # noqa: E402
                     RowSparseNDArray)


def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` (reference
    src/operator/tensor/cast_storage.cc)."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    return sparse._from_dense(arr, stype)


def sparse_retain(arr, indices):
    """Only the given rows of a sparse array kept (reference
    src/operator/tensor/sparse_retain.cc)."""
    return arr.retain(indices)


def square_sum(arr, axis=None, keepdims=False):
    """``sum(arr ** 2)``; a row_sparse array over ``axis=1`` without
    densifying (reference src/operator/tensor/square_sum.cc, the norm
    of row_sparse AdaGrad)."""
    import torch
    if isinstance(arr, BaseSparseNDArray):
        vals = arr._data
        if axis is None:
            return NDArray(vals.square().sum(), arr.context)
        if isinstance(arr, RowSparseNDArray) and axis in (1, -1):
            out = torch.zeros(arr.shape[0], dtype=vals.dtype,
                              device=vals.device)
            out[arr._indices] = vals.square().reshape(
                vals.shape[0], -1).sum(1)
            return NDArray(out[:, None] if keepdims else out, arr.context)
        return square_sum(arr.todense(), axis=axis, keepdims=keepdims)
    d = arr if isinstance(arr, NDArray) else array(arr)
    dims = tuple(range(d.ndim)) if axis is None else axis
    return NDArray(d._data.square().sum(dim=dims, keepdim=keepdims),
                   d.context)

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "invoke", "imperative_invoke",
           "waitall", "save", "load", "op", "random", "contrib", "linalg",
           "image", "sparse", "BaseSparseNDArray", "CSRNDArray",
           "RowSparseNDArray", "cast_storage", "sparse_retain",
           "square_sum"]
