"""KVStore of the port (counterpart of ``incubator_mxnet_tpu/kvstore.py``;
reference python/mxnet/kvstore.py): the parameter synchronization API
``init`` / ``push`` / ``pull`` / ``row_sparse_pull`` / ``set_optimizer``
/ ``rank`` / ``num_workers`` / ``barrier``.

* ``"local"``, ``"device"``, ``"nccl"`` and ``"local_allreduce_*"`` are
  the single-process store: the values pushed for a key (one per
  device) are summed, and the updater, when one is set, runs on the sum
  (``KVStoreLocal::Push``); without one the stored value becomes the
  sum.  With gradient compression each source is quantized with its own
  residual before the sum.
* ``"tpu"`` is the mesh store (``parallel.kvstore_tpu``); ``"dist_*"``
  the cross-process store over ``torch.distributed``
  (``parallel.dist.KVStoreDist``).
"""
from __future__ import annotations

from . import optimizer as opt
from . import telemetry
from .base import MXNetError
from .ndarray.ndarray import NDArray, invoke

__all__ = ["KVStore", "create"]


def _group(keys, vals):
    """Group a possibly-flat ``(keys, list-of-values)`` call into per-key
    lists (reference kvstore.py:_ctype_key_value flattening)."""
    if not isinstance(keys, (list, tuple)):
        if isinstance(vals, NDArray):
            return [keys], [[vals]], True
        return [keys], [list(vals)], True
    grouped = [[v] if isinstance(v, NDArray) else list(v) for v in vals]
    return list(keys), grouped, False


class KVStore:
    """Single-process key-value store (reference
    src/kvstore/kvstore_local.h:51)."""

    def __init__(self, name="local"):
        self.type = name
        self._data = {}
        self._updater = None
        self._gc = None  # GradientCompression codec (None: off)

    # ---------------------------------------------------------------- basics
    def init(self, key, value):
        keys, values, _ = _group(key, value)
        for k, vs in zip(keys, values):
            k = str(k)
            if k in self._data:
                raise MXNetError(f"key {k} already initialized")
            self._data[k] = vs[0].copy()

    def _stored(self, k):
        if k not in self._data:
            raise MXNetError(f"key {k} has not been initialized")
        return self._data[k]

    def push(self, key, value, priority=0):
        keys, values, _ = _group(key, value)
        for k, vs in zip(keys, values):
            k = str(k)
            stored = self._stored(k)
            arrays = [v._data for v in vs]
            if self._gc is not None:
                # each source quantized with its own residual (reference
                # comm.h ReduceCompressed)
                arrays = [self._gc.roundtrip((k, i), a)
                          for i, a in enumerate(arrays)]
            acc = arrays[0]
            for a in arrays[1:]:
                acc = acc + a
            merged = NDArray(acc, vs[0]._ctx) if (
                len(arrays) > 1 or self._gc is not None) else vs[0]
            self._apply(k, merged, stored)

    def _apply(self, k, merged, stored):
        """The updater on the merged push, or (without one) the stored
        value replaced by it (kvstore_local.h PushImpl).  Every store's
        push of a key ends here, so it counts ``kvstore.push.count``."""
        if telemetry.enabled:
            telemetry.counter("kvstore.push.count").inc()
        if self._updater is not None:
            self._updater(self._str_or_int(k), merged, stored)
        else:
            stored._write(merged._data.to(stored._data.device,
                                          stored._data.dtype))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull requires out=")
        keys, outs, _ = _group(key, out)
        for k, os_ in zip(keys, outs):
            src = self._stored(str(k))._data
            if telemetry.enabled:
                telemetry.counter("kvstore.pull.count").inc()
            for o in os_:
                o._write(src.to(o._data.device, o._data.dtype))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows in ``row_ids`` (reference
        kvstore.py:row_sparse_pull): a ``RowSparseNDArray`` out takes
        them as its stored rows, a dense out the gathered rows."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        keys, outs, _ = _group(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        elif not isinstance(row_ids, list):
            row_ids = [row_ids]
        for k, os_, rids in zip(keys, outs, row_ids):
            src = self._stored(str(k))
            gathered = invoke("take", [src, rids], {"axis": 0,
                                                   "mode": "clip"})
            for o in os_:
                if getattr(o, "stype", "default") == "row_sparse":
                    o._update_rows(rids, gathered._data)
                else:
                    o._write(gathered._data.to(o._data.device))

    # ------------------------------------------------------------- optimizer
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on every push (reference kvstore.py:435)."""
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    set_updater = _set_updater

    def set_gradient_compression(self, compression_params):
        """Compress pushes (reference gradient_compression.h: 2-bit with
        an error-feedback residual; ``"fp8"`` the JAX package's
        variant)."""
        from .parallel import compression
        self._gc = compression.create(compression_params)

    # --------------------------------------------------------------- cluster
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("save_optimizer_states needs an optimizer on "
                             "the store (set_optimizer)")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("load_optimizer_states needs an optimizer on "
                             "the store (set_optimizer)")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    @staticmethod
    def _str_or_int(k):
        try:
            return int(k)
        except ValueError:
            return k


def create(name="local"):
    """A store by type name (reference src/kvstore/kvstore.cc:40-72)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device", "nccl"):
        return KVStore(name)
    if name == "tpu":
        from .parallel.kvstore_tpu import KVStoreTPU
        return KVStoreTPU()
    if name.startswith("dist"):
        from .parallel.dist import KVStoreDist
        return KVStoreDist(name)
    raise MXNetError(f"unknown kvstore type {name}")
