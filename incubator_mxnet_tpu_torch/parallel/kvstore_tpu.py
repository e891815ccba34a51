"""kvstore ``"tpu"`` of the port, the mesh store (counterpart of
``incubator_mxnet_tpu/parallel/kvstore_tpu.py``).  The name is the JAX
package's, kept because JAX code passes it; on the port it is the store
of a ``DeviceMesh`` over the ranks of a ``torch.distributed`` world.

Under GSPMD a JAX gradient is already the global batch's, so the JAX
store's push never reduces.  The port's ranks each hold their own
gradient, so on a mesh whose ``dp`` group has a process group:

* ``init`` takes the group's first rank's value (a broadcast);
* ``push`` sums the values of each key on this rank, as the
  single-process store does, then takes the **mean** over the ``dp``
  group (one flat ``all_reduce`` per dtype for all the keys of the
  call), then runs the updater on it, the same on every rank;
* ``allreduce(arrays)`` averages a list of gradients in place the same
  way (``gluon.Trainer.allreduce_grads`` calls it).

Without a mesh, a ``dp`` axis or a process group it is the
single-process store; made with no mesh in a world of more than one
rank it raises, since each rank would keep its own gradient.
"""
from __future__ import annotations

from ..base import MXNetError
from ..kvstore import KVStore, _group
from ..ndarray.ndarray import NDArray
from ..ops.collective import all_reduce_flat
from .dist import coalesced, world
from .mesh import current_mesh

__all__ = ["KVStoreTPU"]


class KVStoreTPU(KVStore):
    """Mesh-aware kvstore (type ``"tpu"``); ``mesh`` defaults to the
    current one (``with mesh:``)."""

    def __init__(self, mesh=None):
        super().__init__("tpu")
        self._mesh = mesh if mesh is not None else current_mesh()
        size = world()[0]
        if self._mesh is None and size > 1:
            # without a mesh each rank would keep its own gradient
            raise MXNetError(
                f"kvstore 'tpu' in a world of {size} ranks needs a mesh: "
                "create it under `with parallel.make_mesh(dp=...)` (a "
                "gluon.Trainer creates its store at the first step) or "
                "pass KVStoreTPU(mesh)")

    @property
    def mesh(self):
        return self._mesh

    def _dp(self):
        """The ``dp`` process group and its size (None, 1 without)."""
        group = None if self._mesh is None else self._mesh.group("dp")
        return group, 1 if group is None else self._mesh.axis_size("dp")

    def init(self, key, value):
        super().init(key, value)
        group, _ = self._dp()
        if group is not None:
            keys, _, _ = _group(key, value)
            coalesced("broadcast", [self._data[str(k)]._data for k in keys],
                      group)

    def push(self, key, value, priority=0):
        group, size = self._dp()
        if group is None:
            return super().push(key, value, priority)
        keys, values, _ = _group(key, value)
        merged = []
        for k, vs in zip(keys, values):
            arrays = [v._data for v in vs]
            if self._gc is not None:
                arrays = [self._gc.roundtrip((str(k), i), a)
                          for i, a in enumerate(arrays)]
            acc = arrays[0]
            for a in arrays[1:]:
                acc = acc + a
            merged.append(acc)
        means = all_reduce_flat(merged, group, divide=size)
        for k, vs, m in zip(keys, values, means):
            k = str(k)
            self._apply(k, NDArray(m, vs[0]._ctx), self._stored(k))

    def allreduce(self, arrays):
        """Average the NDArrays ``arrays`` over the mesh's ``dp`` group,
        in place (nothing to do without a mesh, a ``dp`` axis or a
        process group)."""
        group, size = self._dp()
        if group is not None:
            coalesced("all_reduce", [a._data for a in arrays], group,
                      divide=size)

    @property
    def num_workers(self):
        return self._mesh.axis_size("dp") if self._mesh is not None else 1
