"""``nd.save`` / ``nd.load`` (counterpart of
``incubator_mxnet_tpu/ndarray/utils.py``; reference
python/mxnet/ndarray/utils.py).

``save`` writes MXNet's binary ``.params`` format (``mxnet_format``),
which the JAX package's ``nd.load`` and the reference both read.
``load`` reads that format and the JAX package's own ``.npz``
container (what its ``nd.save`` writes), so arrays cross between the
two packages in either direction bit for bit.  Arrays load on the
current context, each in the dtype its file stored.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from . import mxnet_format

__all__ = ["save", "load"]

# the JAX package's key prefix for an unnamed list in its .npz files
_LIST_KEY = "__mx_tpu_list__"


def save(fname, data):
    """Save an NDArray, a list of them or a str -> NDArray dict
    (python/mxnet/ndarray/utils.py:save)."""
    from .ndarray import NDArray
    if not isinstance(data, (NDArray, list, tuple, dict)):
        raise MXNetError("save expects NDArray, list, or dict")
    mxnet_format.save(fname, data)


def load(fname):
    """Load a list or dict of NDArrays, as they were saved."""
    from .ndarray import array
    with open(fname, "rb") as f:
        head = f.read(8)
    if mxnet_format.is_reference_blob(head):
        return mxnet_format.load(fname)
    with np.load(fname, allow_pickle=False) as data:
        items = {k: data[k] for k in data.keys()}
    keys = list(items)
    if keys and all(k.startswith(_LIST_KEY) for k in keys):
        keys.sort(key=lambda k: int(k[len(_LIST_KEY):]))
        return [array(items[k], dtype=items[k].dtype) for k in keys]
    return {k: array(v, dtype=v.dtype) for k, v in items.items()}
