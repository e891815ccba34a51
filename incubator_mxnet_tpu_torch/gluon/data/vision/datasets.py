"""Vision datasets of the port (counterpart of ``incubator_mxnet_tpu/gluon/
data/vision/datasets.py``; reference python/mxnet/gluon/data/vision/
datasets.py).

Nothing is downloaded: each dataset reads the standard files from
``root`` (MNIST / Fashion-MNIST idx files, plain or gzipped; the CIFAR
binary batches), or an im2rec ``.rec`` with its ``.idx``, or an image
folder.  Samples are host NDArrays.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from ..dataset import Dataset, ArrayDataset, RecordFileDataset
from ....ndarray import ndarray as _nd
from ....context import cpu

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _host(a):
    """A host NDArray holding a copy of ``a`` (float64 becomes float32,
    the JAX package's rule)."""
    return _nd.array(a, ctx=cpu())


def _open_maybe_gzip(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _read_idx(path):
    with _open_maybe_gzip(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


class _DownloadedDataset(Dataset):
    """Base for file-backed datasets (reference datasets.py layout)."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        # nothing is created or fetched: a missing root raises IOError
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx files in `root` (train-images-idx3-ubyte[.gz] etc.);
    samples are (HxWx1 uint8 NDArray, int32 label) like the reference."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        img_f, lbl_f = self._train_files if self._train else self._test_files
        img_path = os.path.join(self._root, img_f)
        lbl_path = os.path.join(self._root, lbl_f)
        for p in (img_path, lbl_path):
            if not (os.path.exists(p) or os.path.exists(p + ".gz")):
                raise IOError(
                    f"{p}[.gz] not found; this environment has no network"
                    " egress — place the standard MNIST idx files under"
                    f" {self._root}")
        images = _read_idx(img_path)
        labels = _read_idx(lbl_path)
        self._data = _host(images[..., None])  # N,H,W,1 uint8
        self._label = labels.astype(np.int32)


class FashionMNIST(MNIST):
    """Same idx format, different root."""

    def __init__(self,
                 root=os.path.join("~", ".mxnet", "datasets", "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the binary batches in `root`
    (data_batch_{1..5}.bin / test_batch.bin)."""

    _num_label_bytes = 1
    _train_names = [f"data_batch_{i}.bin" for i in range(1, 6)]
    _test_names = ["test_batch.bin"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)
        rec = raw.reshape(-1, 3072 + self._num_label_bytes)
        return rec[:, self._num_label_bytes:].reshape(-1, 3, 32, 32) \
            .transpose(0, 2, 3, 1), rec[:, self._num_label_bytes - 1]

    def _get_data(self):
        names = self._train_names if self._train else self._test_names
        paths = [os.path.join(self._root, n) for n in names]
        # also accept the cifar-10-batches-bin subdir layout
        if not os.path.exists(paths[0]):
            sub = os.path.join(self._root, "cifar-10-batches-bin")
            if os.path.isdir(sub):
                paths = [os.path.join(sub, n) for n in names]
        for p in paths:
            if not os.path.exists(p):
                raise IOError(
                    f"{p} not found; no network egress — place the CIFAR"
                    f" binary batches under {self._root}")
        data, label = zip(*(self._read_batch(p) for p in paths))
        self._data = _host(np.concatenate(data))
        self._label = np.concatenate(label).astype(np.int32)


class CIFAR100(CIFAR10):
    """CIFAR-100 binary format (coarse+fine label bytes)."""

    _num_label_bytes = 2
    _train_names = ["train.bin"]
    _test_names = ["test.bin"]

    def __init__(self,
                 root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)
        rec = raw.reshape(-1, 3072 + 2)
        label = rec[:, 1] if self._fine else rec[:, 0]
        return rec[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), label


class ImageRecordDataset(RecordFileDataset):
    """Dataset of (image, label) from a .rec packed with im2rec
    (reference datasets.py:ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio, image
        record = super().__getitem__(idx)
        header, img_bytes = recordio.unpack(record)
        img = image.imdecode(img_bytes, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """root/category/image.jpg layout (reference
    datasets.py:ImageFolderDataset). Labels are assigned by sorted folder
    name; `synsets` lists them."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = {".jpg", ".jpeg", ".png", ".bmp"}
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                warnings.warn(f"Ignoring {path}, which is not a directory.",
                              stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() not in self._exts:
                    warnings.warn(
                        f"Ignoring {filename} of type"
                        f" {os.path.splitext(filename)[1]}")
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image
        img = image.imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
