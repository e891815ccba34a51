"""The cross-process backend of the port (counterpart of
``incubator_mxnet_tpu/parallel/dist.py``): kvstore ``"dist_sync"``,
``"dist_device_sync"`` and ``"dist_async"`` over ``torch.distributed``.

* ``init_process_group`` reads the launcher's environment
  (``tools/launch.py``: ``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID``,
  ``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``) and starts the world on a
  ``TCPStore`` hosted by rank 0.  With one process it does nothing.
  ``backend=None`` is ``"nccl"`` when CUDA is available, else
  ``"gloo"``; ``"gloo"`` may be asked for on CUDA tensors (it carries
  ``all_reduce`` and ``broadcast`` of them, which is all the port's data
  parallelism uses).  NCCL cannot put two ranks on one card: such a
  world raises ``MXNetError`` naming the fix, and the backend is never
  switched behind the caller's back.
* ``KVStoreDist.push`` sums the values of a key on this rank, then takes
  the **mean** over the ranks (the JAX package's rule; ps-lite sums),
  then runs the updater, when one is set, on the merged gradient on
  every rank; ``pull`` copies the stored value out.  ``init`` takes rank
  0's value (a broadcast), as ps-lite's servers keep worker 0's.
* A compressed push (``set_gradient_compression``) quantizes on this
  rank (the residual stays here) and ships only the wire form: the
  ranks' wires are gathered by one ``all_reduce`` (sum) of a zeroed
  ``(world, nbytes)`` uint8 buffer in which each rank fills its own row
  (exact, and gloo has no ``all_gather`` of CUDA tensors), then each
  row is decompressed and the mean taken.  ``wire_bytes_pushed`` counts
  the bytes this rank pushed in a world of more than one: the values'
  bytes, or the wire's.  The gather's buffer is ``world`` times the
  wire, so what the all-reduce moves grows with the world: for n
  values ``world * n / 4`` bytes in 2-bit and ``world * n`` in fp8,
  against ``4 * n`` for an uncompressed push (less below 16 and 4 ranks).
* Liveness rides the ``TCPStore``: each rank posts a timestamp from a
  daemon thread (``MXNET_KVSTORE_HEARTBEAT_INTERVAL`` seconds, default
  5; its own store client), and ``last_heartbeats`` /
  ``live_workers`` / ``get_num_dead_node`` read them without a
  collective, so they answer while a dead rank would hang one.
"""
from __future__ import annotations

import datetime
import os
import socket
import threading
import time

import torch

from ..base import MXNetError, get_env
from ..context import resolve_device
from ..kvstore import KVStore, _group
from ..ndarray.ndarray import NDArray
from ..ops.collective import all_reduce_flat, gather_rows

__all__ = ["KVStoreDist", "init_process_group"]

_store = None           # the world's TCPStore (this rank's client)
_address = None         # (host, port) of the store, for more clients
_heartbeat_thread = None
_TIMEOUT = datetime.timedelta(seconds=300)


def _dist():
    import torch.distributed as dist
    return dist


def _initialized():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world():
    """``(size, rank)`` of this process's ``torch.distributed`` world;
    ``(1, 0)`` without one."""
    if _initialized():
        dist = _dist()
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def barrier():
    """Every rank waits for all (nothing without a process group)."""
    if _initialized():
        _dist().barrier()


def _check_one_rank_per_card(store, rank, world):
    """Raise on every rank when two NCCL ranks would share a card."""
    dev = resolve_device(None)
    props = torch.cuda.get_device_properties(dev)
    card = f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"
    store.set(f"mxnet/card/{rank}", card)
    cards = [store.get(f"mxnet/card/{r}").decode() for r in range(world)]
    for r in range(world):
        if cards.index(cards[r]) != r:
            raise MXNetError(
                f"backend 'nccl' cannot run two ranks on one card (ranks "
                f"{cards.index(cards[r])} and {r} share {cards[r]}): give "
                "each rank its own card, or pass backend='gloo' to "
                "init_process_group")


def init_process_group(coordinator=None, num_processes=None, process_id=None,
                       backend=None):
    """Start the ``torch.distributed`` world from the ``DMLC_*``
    environment (idempotent; nothing with one process)."""
    global _store, _address
    if _initialized():
        return
    num = num_processes if num_processes is not None else \
        get_env("DMLC_NUM_WORKER", 1, int)
    if num <= 1:
        return
    rank = process_id if process_id is not None else \
        get_env("DMLC_WORKER_ID", 0, int)
    host = coordinator or os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    port = get_env("DMLC_PS_ROOT_PORT", 8000, int)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise MXNetError(f"backend {backend!r}: 'nccl' or 'gloo'")
    dist = _dist()
    store = dist.TCPStore(host, port, world_size=num, is_master=rank == 0,
                          timeout=_TIMEOUT)
    if backend == "nccl":
        _check_one_rank_per_card(store, rank, num)
        torch.cuda.set_device(resolve_device(None))
    dist.init_process_group(backend, store=store, rank=rank, world_size=num,
                            timeout=_TIMEOUT)
    _store, _address = store, (host, port)


def coalesced(op, tensors, group=None, divide=1):
    """``op`` ("all_reduce" SUM, then divided by ``divide``; or
    "broadcast" from the group's first rank) over ``tensors`` in place:
    one collective per dtype on the flat concatenation."""
    if op == "all_reduce":
        with torch.no_grad():
            for t, r in zip(tensors, all_reduce_flat(tensors, group,
                                                     divide)):
                t.copy_(r)
        return
    dist = _dist()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, group=group,
                       src=dist.get_global_rank(group, 0)
                       if group is not None else 0)
        with torch.no_grad():
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))


class KVStoreDist(KVStore):
    """Cross-process store: each push is reduced over the ranks (the
    parameter server's aggregate step, kvstore_dist_server.h:187), and
    the updater runs on the merged gradient on every rank alike."""

    def __init__(self, name="dist_sync"):
        init_process_group()
        super().__init__(name)
        self._world, self._rank = world()
        #: bytes this rank put on the wire in its pushes
        self.wire_bytes_pushed = 0
        if self._world > 1:
            self.heartbeat()
            self._start_heartbeat_thread()

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._world

    def init(self, key, value):
        super().init(key, value)
        if self._world > 1:
            keys, _, _ = _group(key, value)
            coalesced("broadcast", [self._data[str(k)]._data for k in keys])

    def _allreduce_mean(self, t):
        """The mean of ``t`` over the ranks (a SUM ``all_reduce``, then
        divided by the world size)."""
        if self._world <= 1:
            return t
        self.wire_bytes_pushed += t.numel() * t.element_size()
        out = t.detach().clone()
        dist = _dist()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out / self._world

    def _compressed_mean(self, key, grad):
        """Quantize ``grad`` (the residual stays on this rank), gather
        every rank's wire as bytes (``gather_rows``: one SUM
        ``all_reduce`` of a zeroed ``(world, nbytes)`` uint8 buffer),
        decompress each row, mean."""
        gc = self._gc
        wire = gc.compress(key, grad)
        if self._world <= 1:
            return gc.decompress(wire, grad.shape, grad.dtype)
        raw = wire.view(torch.uint8)
        self.wire_bytes_pushed += raw.numel()
        codes = gather_rows(raw, None, self._world, self._rank)
        if wire.dtype != torch.uint8:
            codes = codes.view(wire.dtype)
        parts = [gc.decompress(c, grad.shape, grad.dtype) for c in codes]
        return torch.stack(parts).mean(0)

    def push(self, key, value, priority=0):
        keys, values, _ = _group(key, value)
        for k, vs in zip(keys, values):
            k = str(k)
            stored = self._stored(k)
            merged = vs[0]._data
            for v in vs[1:]:
                merged = merged + v._data
            if self._gc is not None:
                merged = self._compressed_mean(k, merged)
            else:
                merged = self._allreduce_mean(merged)
            self._apply(k, NDArray(merged, vs[0]._ctx), stored)

    def barrier(self):
        """Every rank waits for all (reference kvstore Barrier)."""
        barrier()

    # -- liveness over the store --------------------------------------------
    @staticmethod
    def _key(rank):
        return f"mxnet/health/r{rank}"

    def heartbeat(self, store=None):
        """Post this rank's liveness timestamp."""
        store = store or _store
        if store is not None:
            store.set(self._key(self._rank), repr(time.time()))

    def _start_heartbeat_thread(self):
        global _heartbeat_thread
        if _heartbeat_thread is not None or _address is None:
            return
        interval = get_env("MXNET_KVSTORE_HEARTBEAT_INTERVAL", 5.0, float)
        if interval <= 0:
            return
        host, port = _address
        # a client of its own: the store's clients are not shared across
        # threads
        client = _dist().TCPStore(host, port, is_master=False,
                                  timeout=_TIMEOUT)

        def beat():
            while True:
                time.sleep(interval)
                try:
                    self.heartbeat(client)
                except Exception:       # the store is gone: job ending
                    return

        _heartbeat_thread = threading.Thread(
            target=beat, name="kvstore-heartbeat", daemon=True)
        _heartbeat_thread.start()

    def last_heartbeats(self):
        """rank -> seconds since that rank's last heartbeat (inf for a
        rank that never posted one)."""
        now = time.time()
        ages = {}
        for r in range(self._world):
            if r == self._rank:
                ages[r] = 0.0
                continue
            key = self._key(r)
            if _store is not None and _store.check([key]):
                ages[r] = now - float(_store.get(key).decode())
            else:
                ages[r] = float("inf")
        return ages

    def live_workers(self, timeout=60.0):
        """Ranks whose heartbeat is fresher than ``timeout`` seconds."""
        return sorted(r for r, age in self.last_heartbeats().items()
                      if age <= timeout)

    def get_num_dead_node(self, node_id=-1, timeout=60.0):
        """Ranks with no heartbeat in ``timeout`` seconds (reference
        include/mxnet/kvstore.h:338; ``node_id`` kept for the API)."""
        if self._world <= 1:
            return 0
        return self._world - len(self.live_workers(timeout))
