"""Data iterators of the port (counterpart of ``incubator_mxnet_tpu/io.py``;
reference python/mxnet/io.py and src/io/).

* ``DataDesc`` / ``DataBatch`` / ``DataIter`` (``device_prefetch()``
  wraps an iterator in ``pipeline_io.DevicePrefetchIter``);
* ``NDArrayIter`` with shuffle and pad / discard / roll_over;
* ``CSVIter``, ``MNISTIter`` (raw idx files), ``LibSVMIter`` (libsvm
  text into ``CSRNDArray`` batches);
* ``ImageRecordIter``, the RecordIO image reader of the ResNet path:
  a producer thread decodes each batch on a pool of
  ``preprocess_threads`` threads (OpenCV, or PIL with
  ``decoder="python"``), crop and mirror per image into one uint8 batch
  buffer, then casts and normalises the whole batch; a bounded queue of
  ``prefetch_buffer`` batches lets decode run ahead of the consumer;
* ``ResizeIter`` and ``PrefetchingIter``.

Every iterator emits **host** NDArrays (``ctx=mx.cpu()``): the port's
default context is ``gpu(0)``, and the copy to the card belongs to the
consumer or to ``DevicePrefetchIter``, which stages it on a side CUDA
stream from pinned memory (a ``LibSVMIter`` batch by
``CSRNDArray.as_in_context``).
The telemetry and tracing hooks of the JAX iterators are not ported
(ROADMAP A9).
"""
from __future__ import annotations

import os
import struct
import threading
import queue as _queue
from collections import namedtuple

import numpy as np
import torch

from . import telemetry
from .base import MXNetError
from .context import cpu
from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "MNISTIter", "ImageRecordIter", "PrefetchingIter",
           "ResizeIter"]


def _host(a):
    """A host NDArray holding a copy of ``a`` (the JAX package's dtype
    rule: float64 becomes float32)."""
    return _nd.array(a, ctx=cpu())


def _host_own(a):
    """A host NDArray over the freshly made numpy array ``a`` itself
    (no copy; ``a`` must not be written afterwards)."""
    return NDArray(torch.from_numpy(a), cpu())


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape/dtype/layout of one input (reference io.py:DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        """Index of the 'N' axis in a layout string (0 if layout is None)."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(n, s, type_dict[n]) for n, s in shapes]
        return [DataDesc(n, s) for n, s in shapes]


class DataBatch:
    """One mini-batch (reference io.py:DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return f"{self.__class__.__name__}: data shapes: {data_shapes} " \
               f"label shapes: {label_shapes}"


class DataIter:
    """Iterator base (reference io.py:DataIter). Subclasses implement
    reset/next (or iter_next+getdata+getlabel+getpad+getindex)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        batch = self.next()
        if telemetry.enabled:
            telemetry.counter("io.batch.count").inc()
        return batch

    def iter_next(self):
        return False

    def getdata(self):
        return None

    def getlabel(self):
        return None

    def getindex(self):
        return None

    def getpad(self):
        return None

    def device_prefetch(self, sharding=None, device=None, depth=None):
        """Wrap this iterator in a ``pipeline_io.DevicePrefetchIter``:
        a background thread stages the next ``depth``
        (``MXNET_DEVICE_PREFETCH``) batches on ``device`` (``None``:
        ``cuda:0``), so the host-to-device copy overlaps decode and
        compute, and the steps take the staged batch as it is.
        ``sharding`` raises until ROADMAP A6."""
        from .pipeline_io import DevicePrefetchIter
        return DevicePrefetchIter(self, sharding=sharding, device=device,
                                  depth=depth)


def _as_numpy(v, dtype=None):
    if isinstance(v, NDArray):
        v = v.asnumpy()
    v = np.asarray(v)
    if dtype is not None and v.dtype != dtype:
        v = v.astype(dtype)
    return v


def _init_data(data, allow_empty, default_name):
    """Normalize {list|dict|array} into [(name, np.ndarray)] (reference
    io.py:_init_data)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("data cannot be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError(
            "Input must be NDArray, numpy.ndarray, a list of them or dict "
            "with them as values")
    return [(k, _as_numpy(v)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle and last-batch handling
    (reference io.py:NDArrayIter)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise ValueError(
                    f"size mismatch: {k} has {v.shape[0]} records, expected"
                    f" {self.num_data}")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError(f"invalid last_batch_handle {last_batch_handle}")
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = np.arange(self.num_data)
        self.cursor = -batch_size
        self._cache_remainder = None  # roll_over leftover from last epoch
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            # keep epochs aligned by starting offset by last epoch's
            # remainder (reference io.py NDArrayIter.reset roll_over rule)
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def hard_reset(self):
        """Ignore roll_over; restart from a clean epoch boundary."""
        if self.shuffle:
            np.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        out = []
        start = max(self.cursor, 0)
        for _, v in arrays:
            end = start + self.batch_size
            if end <= self.num_data:
                out.append(_host(v[self.idx[start:end]]))
            else:  # pad by wrapping to the head (reference pad semantics)
                head = v[self.idx[start:]]
                wrap = v[self.idx[:end - self.num_data]]
                out.append(_host(np.concatenate([head, wrap])))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        start = max(self.cursor, 0)
        end = min(start + self.batch_size, self.num_data)
        ix = self.idx[start:end]
        if len(ix) < self.batch_size:
            ix = np.concatenate([ix, self.idx[:self.batch_size - len(ix)]])
        return ix


class CSVIter(DataIter):
    """Dense CSV reader (reference src/io/iter_csv.cc). Loads the file once,
    then behaves like NDArrayIter with round_batch (pad) semantics."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0],) + tuple(label_shape),
                             dtype=dtype)
        self._iter = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()

    def iter_next(self):
        return self._iter.iter_next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getpad(self):
        return self._iter.getpad()

    def getindex(self):
        return self._iter.getindex()


class LibSVMIter(DataIter):
    """libsvm reader emitting ``CSRNDArray`` batches (reference
    src/io/iter_libsvm.cc + iter_sparse_batchloader.h; JAX
    ``io.py:326``): each line ``label idx:value ...``; ``label_libsvm``
    names a file whose lines' first fields are the labels instead.  With
    ``round_batch`` the last batch wraps around to the first rows and
    reports them in ``pad``; without it a short last batch is dropped."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        self._data_shape = tuple(data_shape)
        indptr, indices, values, labels = [0], [], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    indices.append(int(i))
                    values.append(float(v))
                indptr.append(len(indices))
        self._indptr = np.asarray(indptr, np.int64)
        self._indices = np.asarray(indices, np.int64)
        self._values = np.asarray(values, dtype)
        if label_libsvm is not None:
            with open(label_libsvm) as f:
                labels = [float(ln.split()[0]) for ln in f if ln.strip()]
        self._labels = np.asarray(labels, dtype)
        self._num = len(self._labels)
        self._dim = int(np.prod(self._data_shape))
        self._round = round_batch
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._dim))]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size,))]

    def reset(self):
        self._cursor = 0

    def _csr_rows(self, rows):
        from .ndarray.sparse import CSRNDArray
        starts = self._indptr[rows]
        counts = self._indptr[rows + 1] - starts
        indptr = np.concatenate([[0], counts.cumsum()])
        # the stored values of the rows, in order: each row's run of
        # positions in the file's arrays
        take = np.repeat(starts - indptr[:-1], counts) + \
            np.arange(indptr[-1])
        return CSRNDArray(self._values[take], self._indices[take],
                          indptr.astype(np.int64), (len(rows), self._dim),
                          ctx=cpu())

    def next(self):
        if self._cursor >= self._num:
            raise StopIteration
        end = self._cursor + self.batch_size
        rows = np.arange(self._cursor, min(end, self._num))
        pad = 0
        if len(rows) < self.batch_size:
            if not self._round:
                raise StopIteration
            pad = self.batch_size - len(rows)
            rows = np.concatenate([rows, np.arange(pad)])
        self._cursor = end
        return DataBatch(data=[self._csr_rows(rows)],
                         label=[_host(self._labels[rows])], pad=pad)


def _read_idx_file(path):
    """Read an MNIST idx-format file (src/io/iter_mnist.cc format)."""
    with open(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype_code = (magic >> 8) & 0xFF
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=dtypes[dtype_code])
        return data.reshape(shape)


class MNISTIter(DataIter):
    """Raw MNIST idx reader (reference src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=False, input_shape=None, **kwargs):
        super().__init__(batch_size)
        img = _read_idx_file(image).astype(np.float32) / 255.0
        lbl = _read_idx_file(label).astype(np.float32)
        if flat:
            img = img.reshape(img.shape[0], -1)
        elif input_shape is not None:
            img = img.reshape((img.shape[0],) + tuple(input_shape))
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        if shuffle:
            rs = np.random.RandomState(seed)
            order = rs.permutation(img.shape[0])
            img, lbl = img[order], lbl[order]
        self._iter = NDArrayIter(img, lbl, batch_size=batch_size,
                                 last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class ImageRecordIter(DataIter):
    """RecordIO image iterator — the ResNet/ImageNet input path
    (reference src/io/iter_image_recordio_2.cc:ImageRecordIOParser2).

    Pipeline: .rec (indexed, or scanned once for its offsets) ->
    thread-pool decode + crop + mirror into a preallocated uint8 batch ->
    one whole-batch cast and normalisation -> bounded queue of host
    batches (decode runs ahead of the consumer).

    Supported params mirror the reference's ImageRecordIter arguments:
    path_imgrec, path_imgidx, data_shape (C,H,W), batch_size, shuffle,
    rand_crop, rand_mirror, resize (short side), mean_r/g/b, std_r/g/b,
    scale, label_width, preprocess_threads, prefetch_buffer,
    part_index/num_parts (sharded reading for dist training), round_batch,
    seed.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, resize=-1, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 label_width=1, preprocess_threads=4, prefetch_buffer=4,
                 part_index=0, num_parts=1, round_batch=True, seed=0,
                 dtype="float32", layout="NCHW", decoder="cv2",
                 data_name="data", label_name="softmax_label", **kwargs):
        """``dtype='uint8'`` (a reference ImageRecordIter parameter) with
        ``layout='NHWC'`` emits the decoded RGB pixels with no host float
        pass: the cast and normalisation then run on the device, after
        the copy (a quarter of the bytes of float32).  The float32 NCHW
        default keeps the reference's output contract.

        ``decoder``: 'cv2' (default) or 'python' — PIL's decode and
        bilinear resize, with the same output contract, for a host
        without OpenCV."""
        super().__init__(batch_size)
        from . import recordio as rio
        self._data_shape = tuple(data_shape)
        assert len(self._data_shape) == 3, "data_shape must be (C,H,W)"
        if dtype not in ("float32", "uint8"):
            raise MXNetError(f"ImageRecordIter dtype must be float32 or "
                             f"uint8, got {dtype!r}")
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError(f"ImageRecordIter layout must be NCHW or "
                             f"NHWC, got {layout!r}")
        if decoder not in ("cv2", "python"):
            raise MXNetError(f"ImageRecordIter decoder must be cv2 or "
                             f"python, got {decoder!r}")
        self._decoder = decoder
        if decoder == "cv2":
            # decode parallelism comes from this iterator's own thread
            # pool; OpenCV's internal pool stays out of its way
            import cv2
            cv2.setNumThreads(0)
        self._dtype = dtype
        self._layout = layout
        if dtype == "uint8" and (
                np.array([mean_r, mean_g, mean_b]).any()
                or [std_r, std_g, std_b] != [1.0, 1.0, 1.0]
                or scale != 1.0):
            raise MXNetError(
                "dtype='uint8' emits raw pixels; apply mean/std/scale on "
                "the device after the copy instead")
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self._std = np.array([std_r, std_g, std_b], np.float32)
        self._scale = scale
        self._label_width = label_width
        self._threads = max(1, int(preprocess_threads))
        self._prefetch = max(1, int(prefetch_buffer))
        self._shuffle = shuffle
        self._rs = np.random.RandomState(seed)
        self._data_name = data_name
        self._label_name = label_name

        if path_imgidx and os.path.exists(path_imgidx):
            self._rec = rio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            keys = list(self._rec.keys)
        else:
            # build an in-memory offset index with one sequential scan
            self._rec = rio.MXRecordIO(path_imgrec, "r")
            offsets = []
            while True:
                pos = self._rec.tell()
                if self._rec.read() is None:
                    break
                offsets.append(pos)
            self._offsets = offsets
            keys = list(range(len(offsets)))
        self._keys_all = keys
        # dist-training shard (reference part_index/num_parts); a
        # DevicePrefetchIter(sharding=) reads them to take each batch as
        # the rank's slice as it is
        self.num_parts, self.part_index = int(num_parts), int(part_index)
        part = len(keys) // num_parts
        self._keys = keys[part_index * part:
                          (part_index + 1) * part] if num_parts > 1 else keys
        if not self._keys:
            raise MXNetError(f"no records in {path_imgrec}")
        self._round_batch = round_batch
        self._pool = None
        self._queue = None
        self._producer = None
        self._epoch_order = None
        self._stop = threading.Event()
        self.reset()

    # -------------------------------------------------------------- internals
    def _read_record(self, key):
        if hasattr(self, "_offsets"):
            # sequential file with in-memory offsets: thread-unsafe seek, so
            # guard with a lock held only for the (cheap) file read
            with self._io_lock:
                self._rec._seek(self._offsets[key])
                return self._rec.read()
        with self._io_lock:
            return self._rec.read_idx(key)

    def _imdecode(self, img_bytes):
        """JPEG bytes -> BGR HWC uint8 (cv2's contract, both decoders)."""
        if self._decoder == "cv2":
            import cv2
            return cv2.imdecode(np.frombuffer(img_bytes, np.uint8),
                                cv2.IMREAD_COLOR)
        from io import BytesIO
        from PIL import Image
        rgb = np.asarray(Image.open(BytesIO(img_bytes)).convert("RGB"))
        return rgb[:, :, ::-1]

    def _imresize(self, img, tw, th):
        """Resize BGR HWC to (tw, th); bilinear on both decode paths."""
        if self._decoder == "cv2":
            import cv2
            return cv2.resize(img, (tw, th))
        from PIL import Image
        rgb = Image.fromarray(np.ascontiguousarray(img[:, :, ::-1]))
        return np.asarray(rgb.resize((tw, th), Image.BILINEAR))[:, :, ::-1]

    def _decode_one(self, raw, out_u8, slot):
        """Per-image work is decode and crop only, landing uint8 HWC (BGR)
        pixels in the preallocated batch buffer; every float op runs
        batch-at-a-time in `_finalize_batch` (the reference's shape:
        src/io/iter_image_recordio_2.cc:138-171 decodes and augments
        straight into the batch buffer)."""
        from . import recordio as rio
        header, img_bytes = rio.unpack(raw)
        img = self._imdecode(img_bytes)  # BGR HWC
        c, h, w = self._data_shape
        if self._resize > 0:
            ih, iw = img.shape[:2]
            short = min(ih, iw)
            s = self._resize / short
            img = self._imresize(img, max(w, int(iw * s)),
                                 max(h, int(ih * s)))
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = self._imresize(img, max(w, iw), max(h, ih))
            ih, iw = img.shape[:2]
        if self._rand_crop and (ih > h or iw > w):
            y = self._rs.randint(0, ih - h + 1)
            x = self._rs.randint(0, iw - w + 1)
        else:  # center crop
            y, x = (ih - h) // 2, (iw - w) // 2
        img = img[y:y + h, x:x + w]
        if self._rand_mirror and self._rs.rand() < 0.5:
            img = img[:, ::-1]
        if self._dtype == "uint8":
            # emit RGB directly (C-speed, runs inside the decode thread);
            # the f32 path folds BGR->RGB into the batch cast instead
            if self._decoder == "cv2":
                import cv2
                cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_BGR2RGB,
                             dst=out_u8[slot])
            else:
                out_u8[slot] = img[:, :, ::-1]
        else:
            out_u8[slot] = img  # uint8 copy (handles the mirror view)
        label = header.label
        if isinstance(label, np.ndarray):
            return label[:self._label_width]
        return np.array([label], np.float32)[:self._label_width]

    def _finalize_batch(self, u8_bgr, data):
        """uint8 BGR HWC batch -> normalized float32 NCHW batch in THREE
        whole-batch C passes (or one, when normalization is identity):
        (1) a single strided copyto fusing the uint8->f32 cast, the
        BGR->RGB flip, and the HWC->CHW layout; (2)/(3) in-place
        per-channel-plane subtract/multiply, skipped when mean=0 and
        std=scale=1.  The affine is (x - mean) * (scale / std), the JAX
        package's association."""
        if self._layout == "NHWC":
            hwc, channel_axis = data, 3
        else:
            hwc, channel_axis = data.transpose(0, 2, 3, 1), 1
        np.copyto(hwc[..., ::-1], u8_bgr, casting="unsafe")
        self._normalize_inplace(data, channel_axis)

    def _normalize_inplace(self, data, channel_axis):
        k = self._scale / self._std
        sh = [1, 1, 1, 1]
        sh[channel_axis] = 3
        if self._mean.any():
            data -= self._mean.reshape(sh)
        if not np.all(k == 1.0):
            data *= k.reshape(sh).astype(np.float32)

    def _produce(self, order):
        try:
            self._produce_impl(order)
        except Exception as e:  # surface worker failures to the consumer
            self._error = e
        finally:
            self._queue.put(None)

    def _produce_impl(self, order):
        bs = self.batch_size
        n = len(order)
        i = 0
        while i < n and not self._stop.is_set():
            batch_keys = order[i:i + bs]
            pad = 0
            if len(batch_keys) < bs:
                if not self._round_batch:
                    break
                pad = bs - len(batch_keys)
                batch_keys = np.concatenate([batch_keys, order[:pad]])
            c, h, w = self._data_shape
            u8_hwc = np.empty((bs, h, w, c), np.uint8)
            labels = np.empty((bs, self._label_width), np.float32)

            def work(j, key):
                raw = self._read_record(int(key))
                labels[j] = self._decode_one(raw, u8_hwc, j)

            if self._threads > 1:
                futs = [self._pool.submit(work, j, key)
                        for j, key in enumerate(batch_keys)]
                for f in futs:
                    f.result()
            else:
                for j, key in enumerate(batch_keys):
                    work(j, key)
            if self._dtype == "uint8":
                # u8_hwc already holds RGB; zero host float passes
                data = u8_hwc if self._layout == "NHWC" \
                    else u8_hwc.transpose(0, 3, 1, 2).copy()
            else:
                shape = (bs, h, w, c) if self._layout == "NHWC" \
                    else (bs,) + self._data_shape
                data = np.empty(shape, np.float32)
                self._finalize_batch(u8_hwc, data)
            lab = labels[:, 0] if self._label_width == 1 else labels
            self._queue.put(DataBatch(
                data=[_host_own(np.ascontiguousarray(data))],
                label=[_host_own(np.ascontiguousarray(lab))], pad=pad,
                index=np.asarray(batch_keys)))
            i += bs

    # ---------------------------------------------------------------- public
    @property
    def provide_data(self):
        c, h, w = self._data_shape
        shape = (self.batch_size, h, w, c) if self._layout == "NHWC" \
            else (self.batch_size,) + self._data_shape
        return [DataDesc(self._data_name, shape,
                         dtype=np.uint8 if self._dtype == "uint8"
                         else np.float32,
                         layout=self._layout)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        import concurrent.futures
        self._drain()
        self._io_lock = threading.Lock()
        order = np.asarray(self._keys)
        if self._shuffle:
            order = self._rs.permutation(order)
        if self._pool is None and self._threads > 1:
            self._pool = concurrent.futures.ThreadPoolExecutor(self._threads)
        self._queue = _queue.Queue(maxsize=self._prefetch)
        self._stop.clear()
        self._producer = threading.Thread(
            target=self._produce, args=(order,), daemon=True)
        self._producer.start()
        self._exhausted = False
        self._error = None

    def _drain(self):
        if self._producer is not None and self._producer.is_alive():
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._producer.join(timeout=5)
        self._producer = None

    def next(self):
        if self._exhausted:
            raise StopIteration
        # a stall: the consumer found no decoded batch waiting, so the
        # decode pipeline is behind the device
        if telemetry.enabled and self._queue.empty():
            telemetry.counter("io.prefetch_stall.count").inc()
        batch = self._queue.get()
        if batch is None:
            self._exhausted = True
            if getattr(self, "_error", None) is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        batch.provide_data = self.provide_data
        batch.provide_label = self.provide_label
        return batch

    def close(self):
        self._drain()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self._rec.close()


class ResizeIter(DataIter):
    """Resize an iterator to `size` batches per epoch (reference
    io.py:ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators (reference
    io.py:PrefetchingIter; dmlc ThreadedIter equivalent). Overlaps host-side
    batch assembly with device compute."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.n_iter = len(iters)
        self._queues = [_queue.Queue(maxsize=2) for _ in iters]
        self._threads = []
        self._started = False
        self.current_batch = [None] * self.n_iter

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum((i.provide_data for i in self.iters), [])
        return sum(([DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)), [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum((i.provide_label for i in self.iters), [])
        return sum(([DataDesc(r.get(l.name, l.name), l.shape, l.dtype)
                     for l in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)), [])

    def _start(self):
        def run(it, q):
            while True:
                try:
                    q.put(it.next())
                except StopIteration:
                    q.put(None)
                    return

        self._threads = [
            threading.Thread(target=run, args=(it, q), daemon=True)
            for it, q in zip(self.iters, self._queues)]
        for t in self._threads:
            t.start()
        self._started = True

    def reset(self):
        # drain any pending batches then restart threads
        for t, q in zip(self._threads, self._queues):
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except _queue.Empty:
                    pass
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
        for it in self.iters:
            it.reset()
        self._start()

    def iter_next(self):
        if not self._started:
            self._start()
        if telemetry.enabled and any(q.empty() for q in self._queues):
            telemetry.counter("io.prefetch_stall.count").inc()
        batches = [q.get() for q in self._queues]
        if any(b is None for b in batches):
            return False
        self.current_batch = batches
        return True

    def next(self):
        if self.iter_next():
            if self.n_iter == 1:
                return self.current_batch[0]
            return DataBatch(
                data=sum((b.data for b in self.current_batch), []),
                label=sum((b.label for b in self.current_batch), []),
                pad=max(b.pad or 0 for b in self.current_batch),
                index=self.current_batch[0].index)
        raise StopIteration

    def getdata(self):
        return sum((b.data for b in self.current_batch), [])

    def getlabel(self):
        return sum((b.label for b in self.current_batch), [])

    def getindex(self):
        return self.current_batch[0].index

    def getpad(self):
        return self.current_batch[0].pad
