"""Sparse NDArrays of the port: ``row_sparse`` and ``csr`` storage
(counterpart of ``incubator_mxnet_tpu/ndarray/sparse.py``; reference
python/mxnet/ndarray/sparse.py, include/mxnet/ndarray.h:61-66).

* ``RowSparseNDArray``: ``indices`` (K,) sorted and unique, ``data``
  (K, *row_shape): only those rows are stored, every other row is zero.
  The gradient format of wide embeddings and the lazy optimizer
  updates.
* ``CSRNDArray``: 2-D, ``indptr`` (R + 1,), ``indices`` (nnz,) column
  ids and ``data`` (nnz,) values.

The JAX package keeps the components as host numpy arrays; here they are
torch tensors on the array's context, so a CSR batch on the card stays
there and ``dot`` runs there.  ``dot`` (csr x dense and csr^T x dense)
keeps the sparse side compressed: the row of each stored value comes
from ``indptr`` by ``repeat_interleave`` with ``output_size=nnz`` (no
sync), and the products reach the output by ``index_add_`` (float
atomics on the card: the order of the sums is not fixed).  Anything
else densifies, the reference's "fallback" dispatch.  Building a sparse
array from a dense one (``from_dense``, ``cast_storage``, ``tostype``)
finds the nonzeros with one ``nonzero``, a sync on the card.

As in the JAX package, sparse arrays are not NDArray subclasses:
``reshape`` and ``+=`` raise, ``asnumpy`` densifies, and nothing is
recorded by autograd.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import current_context
from .ndarray import NDArray, invoke
from .ndarray import array as _dense_array
from .ndarray import zeros as _dense_zeros

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "add", "array", "csr_matrix", "dot", "empty",
           "row_sparse_array", "zeros"]


def _tensor(x, device, dtype=None):
    """``x`` (numpy, list, tensor or NDArray) as a tensor on
    ``device``."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        t = torch.as_tensor(np.ascontiguousarray(np.asarray(x)))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device, copy=True)


def _values_dtype(data, dtype):
    """The values' torch dtype: ``dtype`` if given, else the source's
    (float64 numpy data becomes float32, as ``nd.array`` makes it)."""
    if dtype is not None:
        return torch_dtype(dtype)
    if isinstance(data, NDArray):
        return data._data.dtype
    if isinstance(data, torch.Tensor):
        return data.dtype
    arr = np.asarray(data)
    return torch.float32 if arr.dtype == np.float64 else \
        torch_dtype(arr.dtype)


def _ids(row_ids, device):
    """Row ids (an NDArray, tensor, numpy array or list) as int64 on
    ``device``."""
    return _tensor(row_ids, device, torch.int64)


class BaseSparseNDArray:
    """The common surface of the sparse arrays (reference
    sparse.py:BaseSparseNDArray)."""

    stype = None

    def __init__(self, shape, dtype, ctx):
        self._shape = tuple(int(s) for s in shape)
        self._ctx = ctx if ctx is not None else current_context()
        self._tdtype = dtype

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return numpy_dtype(self._tdtype)

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def size(self):
        return int(np.prod(self._shape))

    def __len__(self):
        return self._shape[0]

    def __repr__(self):
        return f"\n<{type(self).__name__} {self._shape} @{self._ctx}>"

    def __iadd__(self, other):
        raise NotImplementedError(f"{type(self).__name__} unsupported +=")

    def reshape(self, *shape):
        raise NotImplementedError(
            f"reshape is not supported for {type(self).__name__}")

    @property
    def _device(self):
        return self._ctx.torch_device()

    def astype(self, dtype):
        return self.tostype(self.stype, dtype=dtype)

    def asnumpy(self):
        return self.todense().asnumpy()

    def todense(self) -> NDArray:
        raise NotImplementedError

    def tostype(self, stype, dtype=None):
        """This array in storage ``stype`` (reference cast_storage)."""
        dense = self.todense()
        if dtype is not None:
            dense = dense.astype(dtype)
        if stype == "default":
            return dense
        if stype == self.stype and dtype is None:
            return self
        return _from_dense(dense, stype)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._write(self.todense()._data.to(other._data.device))
            return other
        raise TypeError(f"copyto does not support {type(other)}")

    def wait_to_read(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)


class CSRNDArray(BaseSparseNDArray):
    """A 2-D compressed sparse row array (reference sparse.py:260)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, dtype=None, ctx=None):
        tdtype = _values_dtype(data, dtype)
        super().__init__(shape, tdtype, ctx)
        if len(self._shape) != 2:
            raise MXNetError("CSRNDArray requires a 2-D shape")
        dev = self._device
        self._data = _tensor(data, dev, tdtype).reshape(-1)
        self._indices = _tensor(indices, dev, torch.int64).reshape(-1)
        self._indptr = _tensor(indptr, dev, torch.int64).reshape(-1)
        if tuple(self._indptr.shape) != (self._shape[0] + 1,):
            raise MXNetError(
                f"indptr length {tuple(self._indptr.shape)} != rows+1"
                f" ({self._shape[0] + 1})")

    @property
    def data(self) -> NDArray:
        """The stored values (reference CSRNDArray.data)."""
        return NDArray(self._data.clone(), self._ctx)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices.clone(), self._ctx)

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._indptr.clone(), self._ctx)

    @property
    def nnz(self):
        return int(self._data.shape[0])

    def as_in_context(self, ctx):
        """This array with its components on ``ctx``."""
        return CSRNDArray(self._data, self._indices, self._indptr,
                          self._shape, ctx=ctx)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self[key:key + 1]
        if not isinstance(key, slice):
            raise ValueError(f"unsupported CSR index {key}")
        if key.step not in (None, 1):
            raise ValueError("CSRNDArray only supports step=1 slices")
        start, stop, _ = key.indices(self._shape[0])
        s, e = (int(v) for v in self._indptr[[start, stop]].tolist())
        return CSRNDArray(self._data[s:e], self._indices[s:e],
                          self._indptr[start:stop + 1] - s,
                          (stop - start, self._shape[1]), ctx=self._ctx)

    def _rows(self):
        """The row of each stored value, from ``indptr`` (no sync)."""
        counts = self._indptr[1:] - self._indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self._shape[0], device=self._indptr.device),
            counts, output_size=self.nnz)

    def todense(self):
        dense = torch.zeros(self._shape, dtype=self._tdtype,
                            device=self._data.device)
        dense[self._rows(), self._indices] = self._data
        return NDArray(dense, self._ctx)

    @staticmethod
    def from_dense(arr):
        """The CSR form of a 2-D NDArray (or numpy array / tensor)."""
        ctx = arr.context if isinstance(arr, NDArray) else None
        a = _tensor(arr, (ctx or current_context()).torch_device())
        if a.dim() != 2:
            raise MXNetError("csr requires 2-D input")
        mask = a != 0
        indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                        device=a.device),
                            mask.sum(1).cumsum(0)])
        nz = torch.nonzero(mask)
        return CSRNDArray(a[mask], nz[:, 1], indptr, a.shape,
                          dtype=a.dtype, ctx=ctx)

    @torch.no_grad()
    def dot(self, dense):
        """csr x dense -> dense: each stored value times its column's row
        of ``dense``, summed into its row."""
        d = dense._data if isinstance(dense, NDArray) else \
            _tensor(dense, self._device)
        contrib = self._data[:, None].to(d.dtype) * d[self._indices]
        out = torch.zeros((self._shape[0],) + tuple(d.shape[1:]),
                          dtype=d.dtype, device=d.device)
        out.index_add_(0, self._rows(), contrib)
        return NDArray(out, self._ctx)

    def retain(self, row_ids):
        """Only the listed rows kept (reference sparse_retain)."""
        keep = torch.zeros(self._shape[0], dtype=torch.bool,
                           device=self._data.device)
        keep[_ids(row_ids, keep.device)] = True
        dense = self.todense()._data * keep[:, None]
        return CSRNDArray.from_dense(NDArray(dense, self._ctx))


class RowSparseNDArray(BaseSparseNDArray):
    """An array of which only the rows in ``indices`` are stored
    (reference sparse.py:530); the rows are kept sorted."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, dtype=None, ctx=None):
        tdtype = _values_dtype(data, dtype)
        super().__init__(shape, tdtype, ctx)
        dev = self._device
        values = _tensor(data, dev, tdtype)
        idx = _tensor(indices, dev, torch.int64).reshape(-1)
        if values.shape[0] != idx.shape[0]:
            raise MXNetError("data/indices row count mismatch")
        order = torch.argsort(idx)
        self._indices = idx[order]
        self._data = values[order].reshape((idx.shape[0],) +
                                           self._shape[1:])

    @property
    def data(self) -> NDArray:
        return NDArray(self._data.clone(), self._ctx)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices.clone(), self._ctx)

    @property
    def num_stored(self):
        return int(self._indices.shape[0])

    def as_in_context(self, ctx):
        return RowSparseNDArray(self._data, self._indices, self._shape,
                                ctx=ctx)

    def __getitem__(self, key):
        if key == slice(None):
            return self
        raise ValueError("RowSparseNDArray only supports [:]")

    def todense(self):
        dense = torch.zeros(self._shape, dtype=self._tdtype,
                            device=self._data.device)
        dense[self._indices] = self._data
        return NDArray(dense, self._ctx)

    @staticmethod
    def from_dense(arr):
        """The row_sparse form of an NDArray (or numpy array / tensor):
        the rows with any nonzero element."""
        ctx = arr.context if isinstance(arr, NDArray) else None
        a = _tensor(arr, (ctx or current_context()).torch_device())
        return _row_sparse_of(a, ctx)

    def _update_rows(self, row_ids, values):
        """Replace the stored rows by ``values`` at ``row_ids`` (made
        sorted and unique), the kvstore ``row_sparse_pull`` protocol."""
        ids = torch.unique(_ids(row_ids, self._device))
        vals = _tensor(values, self._device, self._tdtype)
        vals = vals.reshape((-1,) + self._shape[1:])[:ids.shape[0]]
        self._indices, self._data = ids, vals

    def retain(self, row_ids):
        """The stored rows that are also in ``row_ids`` (reference
        sparse_retain)."""
        mask = torch.isin(self._indices, _ids(row_ids, self._device))
        return RowSparseNDArray(self._data[mask], self._indices[mask],
                                self._shape, self._tdtype, self._ctx)


def _row_sparse_of(t, ctx):
    """The row_sparse array of the dense tensor ``t`` on ``ctx``: its
    rows with any nonzero element (one ``nonzero``, a sync on the
    card)."""
    nz = torch.nonzero((t != 0).reshape(t.shape[0], -1).any(1))[:, 0]
    return RowSparseNDArray(t[nz], nz, t.shape, t.dtype, ctx)


def _from_dense(arr, stype):
    if stype == "csr":
        return CSRNDArray.from_dense(arr)
    if stype == "row_sparse":
        return RowSparseNDArray.from_dense(arr)
    raise MXNetError(f"unknown stype {stype}")


def _dense_np(arg, dtype):
    if isinstance(arg, (NDArray, torch.Tensor)):
        return arg if dtype is None else \
            (arg.astype(dtype) if isinstance(arg, NDArray)
             else arg.to(torch_dtype(dtype)))
    arr = np.asarray(arg)
    return arr.astype(dtype) if dtype else arr


# ------------------------------------------------------------ constructors
def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or a dense array
    (reference sparse.py:csr_matrix)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indices, indptr, shape, dtype=dtype,
                          ctx=ctx)
    if isinstance(arg1, CSRNDArray):
        return arg1
    dense = _dense_np(arg1, dtype)
    if ctx is not None and not isinstance(dense, NDArray):
        dense = _dense_array(dense, ctx=ctx, dtype=dense.dtype)
    return CSRNDArray.from_dense(dense)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or a dense array
    (reference sparse.py:row_sparse_array)."""
    if isinstance(arg1, tuple) and len(arg1) == 2 and \
            not np.isscalar(arg1[0]):
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape, dtype=dtype, ctx=ctx)
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    dense = _dense_np(arg1, dtype)
    if ctx is not None and not isinstance(dense, NDArray):
        dense = _dense_array(dense, ctx=ctx, dtype=dense.dtype)
    return RowSparseNDArray.from_dense(dense)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of storage ``stype`` (reference
    sparse.py:zeros)."""
    shape = tuple(shape)
    if stype == "csr":
        return CSRNDArray(np.zeros((0,), dtype), np.zeros((0,), np.int64),
                          np.zeros(shape[0] + 1, np.int64), shape,
                          dtype=dtype, ctx=ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(np.zeros((0,) + shape[1:], dtype),
                                np.zeros((0,), np.int64), shape,
                                dtype=dtype, ctx=ctx)
    if stype == "default":
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    raise MXNetError(f"unknown stype {stype}")


def empty(stype, shape, ctx=None, dtype="float32"):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


@torch.no_grad()
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (reference mx.nd.sparse.dot): csr x dense and
    csr^T x dense keep the csr side compressed; anything else
    densifies."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) and \
            not transpose_b:
        if not transpose_a:
            return lhs.dot(rhs)
        d = rhs._data
        contrib = lhs._data[:, None].to(d.dtype) * d[lhs._rows()]
        out = torch.zeros((lhs.shape[1],) + tuple(d.shape[1:]),
                          dtype=d.dtype, device=d.device)
        out.index_add_(0, lhs._indices, contrib)
        return NDArray(out, rhs.context)
    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return invoke("dot", [a, b], {"transpose_a": transpose_a,
                                  "transpose_b": transpose_b})


def add(lhs, rhs):
    """Elementwise add; row_sparse + row_sparse stays row_sparse over the
    union of the rows (reference elemwise_add's sparse kernel)."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        both = torch.cat([lhs._indices, rhs._indices])
        idx, inverse = torch.unique(both, sorted=True, return_inverse=True)
        data = torch.zeros((idx.shape[0],) + lhs.shape[1:],
                           dtype=lhs._tdtype, device=lhs._data.device)
        k = lhs.num_stored
        data.index_add_(0, inverse[:k], lhs._data)
        data.index_add_(0, inverse[k:], rhs._data.to(lhs._tdtype))
        return RowSparseNDArray(data, idx, lhs.shape, lhs._tdtype,
                                lhs.context)
    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return a + b


def array(source_array, ctx=None, dtype=None):
    """``nd.sparse.array``: a sparse array stays itself, a scipy sparse
    matrix becomes a CSRNDArray, anything else a dense NDArray
    (reference sparse.py:array)."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array
    import scipy.sparse as sps
    if sps.issparse(source_array):
        csr = source_array.tocsr()
        return CSRNDArray(csr.data, csr.indices, csr.indptr, csr.shape,
                          dtype=dtype, ctx=ctx)
    return _dense_array(source_array, ctx=ctx, dtype=dtype)
