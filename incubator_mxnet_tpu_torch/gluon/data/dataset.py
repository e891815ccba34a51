"""Datasets of the port (counterpart of ``incubator_mxnet_tpu/gluon/data/
dataset.py``; reference python/mxnet/gluon/data/dataset.py)."""
from __future__ import annotations

import os

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__ (reference dataset.py:Dataset).
    """

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """Return a dataset with `fn(*sample)` applied to each sample
        (reference dataset.py:Dataset.transform)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Apply `fn` to only the first element of each sample (the data,
        leaving labels alone — reference dataset.py:transform_first)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Wrap any indexable (list, array) as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    """Picklable transform-first wrapper (reference dataset.py)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of N equal-length arrays; samples are tuples (reference
    dataset.py:ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; array[0] has length" \
                f" {self._length} while array[{i}] has {len(data)}."
            if isinstance(data, NDArray) and len(data.shape) == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file; samples are raw bytes
    (reference dataset.py:RecordFileDataset)."""

    def __init__(self, filename):
        from ... import recordio
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
