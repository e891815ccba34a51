"""MXNet's binary NDArray format (``.params``), the port's own copy of
``incubator_mxnet_tpu/ndarray/mxnet_format.py``.

The reference serializes NDArray lists with its dmlc-stream format
(src/ndarray/ndarray.cc:1466-1692): file magic 0x112, a vector of
per-array records (V2 magic 0xF993fac9 with storage type, V1 magic
0xF993fac8, or legacy records whose first word is the ndim), then the
name vector.  The reader takes dense records of every version and the
V2 row_sparse and csr records (JAX ``mxnet_format.py:79-150``), which
load as the port's ``RowSparseNDArray`` / ``CSRNDArray``; the writer
emits dense V2 records, which every reference version since 0.12 loads
and which the JAX package's ``nd.load`` reads.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

__all__ = ["is_reference_blob", "load_bytes", "load", "save"]

_LIST_MAGIC = 0x112                  # kMXAPINDArrayListMagic
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9

# mshadow type_flag -> numpy dtype (mshadow/base.h TypeFlag)
_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16,
               3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_FLAG_FOR = {np.dtype(v).name: k for k, v in _TYPE_FLAGS.items()}

# storage types (include/mxnet/ndarray.h NDArrayStorageType) and their
# count of auxiliary arrays
_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_NUM_AUX = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.data):
            raise MXNetError("reference .params blob truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def shape(self):
        """nnvm TShape::Save: uint32 ndim + int64 dims."""
        ndim = self.u32()
        return tuple(struct.unpack(f"<{ndim}q", self.read(8 * ndim)))

    def legacy_shape(self, ndim):
        """pre-V1 records: the first word IS the ndim, dims are uint32."""
        return tuple(struct.unpack(f"<{ndim}I", self.read(4 * ndim)))

    def raw_array(self, shape, type_flag):
        dt = _TYPE_FLAGS.get(type_flag)
        if dt is None:
            raise MXNetError(f"unknown reference dtype flag {type_flag}")
        count = int(np.prod(shape)) if shape else 1
        buf = self.read(count * np.dtype(dt).itemsize)
        return np.frombuffer(buf, dtype=dt).reshape(shape).copy()


def _read_one(r):
    """One NDArray record -> a numpy array, None for a none
    placeholder, or ``(stype, shape, values, aux)`` for a sparse one
    (aux: row_sparse ``[indices]``, csr ``[indptr, indices]``)."""
    magic = r.u32()
    if magic == _V2_MAGIC:
        stype = r.i32()
        nad = _NUM_AUX.get(stype)
        if nad is None:
            raise MXNetError(f"unknown storage type {stype} in .params")
        if nad:
            sshape = r.shape()   # storage shape of the values
        shape = r.shape()
        if not shape:
            return None
        r.i32()                  # dev_type
        r.i32()                  # dev_id
        type_flag = r.i32()
        if not nad:
            return r.raw_array(shape, type_flag)
        aux_types = [r.i32() for _ in range(nad)]
        aux_shapes = [r.shape() for _ in range(nad)]
        values = r.raw_array(sshape, type_flag)
        aux = [r.raw_array(s, t) for t, s in zip(aux_types, aux_shapes)]
        return ("row_sparse" if stype == _STYPE_ROW_SPARSE else "csr",
                shape, values, aux)
    if magic == _V1_MAGIC:
        shape = r.shape()
    else:
        shape = r.legacy_shape(magic)
    if not shape:
        return None
    r.i32()                      # dev_type
    r.i32()                      # dev_id
    return r.raw_array(shape, r.i32())


def _to_ndarray(item):
    from . import sparse
    from .ndarray import array
    if item is None:
        return None
    if isinstance(item, tuple):
        kind, shape, values, aux = item
        if kind == "row_sparse":
            return sparse.row_sparse_array((values, aux[0]), shape=shape,
                                           dtype=values.dtype)
        return sparse.csr_matrix((values, aux[1], aux[0]), shape=shape,
                                 dtype=values.dtype)
    return array(item, dtype=item.dtype)


def is_reference_blob(head):
    """True if ``head`` (the first >= 8 bytes) starts a .params file."""
    return len(head) >= 8 and \
        struct.unpack("<Q", head[:8])[0] == _LIST_MAGIC


def load_bytes(data):
    """Parse a .params blob -> (list of records, list of names): numpy
    arrays, or ``(stype, shape, values, aux)`` for sparse ones; names is
    [] when the file stored an unnamed list."""
    r = _Reader(data)
    if r.u64() != _LIST_MAGIC:
        raise MXNetError("not a reference .params file (bad magic)")
    r.u64()                      # reserved
    n = r.u64()
    arrays = [_read_one(r) for _ in range(n)]
    n_names = r.u64()
    names = [r.read(r.u64()).decode() for _ in range(n_names)]
    return arrays, names


def load(fname_or_bytes):
    """.params -> list[NDArray] or {name: NDArray}, on the current
    context, each in the dtype the file stored (sparse records as
    sparse arrays)."""
    if isinstance(fname_or_bytes, (bytes, bytearray)):
        data = bytes(fname_or_bytes)
    else:
        with open(fname_or_bytes, "rb") as f:
            data = f.read()
    arrays, names = load_bytes(data)
    nds = [_to_ndarray(a) for a in arrays]
    if not names:
        return nds
    if len(names) != len(nds):
        raise MXNetError(".params name/array count mismatch")
    return dict(zip(names, nds))


def save(fname, data):
    """Write NDArrays (a {name: NDArray} dict or a list) in the
    reference binary format, dense V2 records."""
    from .ndarray import NDArray
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    out = bytearray()
    out += struct.pack("<QQ", _LIST_MAGIC, 0)
    out += struct.pack("<Q", len(arrays))
    for a in arrays:
        arr = np.ascontiguousarray(a.asnumpy())
        flag = _FLAG_FOR.get(arr.dtype.name)
        if flag is None:
            raise MXNetError(
                f"dtype {arr.dtype} has no reference type flag; cast first")
        out += struct.pack("<I", _V2_MAGIC)
        out += struct.pack("<i", _STYPE_DEFAULT)
        out += struct.pack("<I", arr.ndim)
        out += struct.pack(f"<{arr.ndim}q", *arr.shape)
        out += struct.pack("<ii", 1, 0)       # Context: cpu(0)
        out += struct.pack("<i", flag)
        out += arr.tobytes()
    out += struct.pack("<Q", len(names))
    for n in names:
        b = n.encode()
        out += struct.pack("<Q", len(b))
        out += b
    with open(fname, "wb") as f:
        f.write(bytes(out))
