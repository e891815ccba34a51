"""The pipelined training loop of the port (counterpart of
``incubator_mxnet_tpu/pipeline_io.py``): batches staged on the card
ahead of the step, and loss readback deferred behind it.

* ``DevicePrefetchIter`` wraps any ``DataIter``.  A producer thread
  pulls the next host batch, copies it into a pinned host buffer, and
  from there to the card with ``non_blocking=True`` on a side CUDA
  stream, recording a CUDA event after the copy.  Each batch geometry
  has a ring of ``depth + 1`` pinned buffers, allocated once (pinning is
  slow); a buffer is written again only after the event of its last copy
  has completed.  ``next()`` makes the consumer's current stream wait on
  the batch's event and marks each tensor as used on that stream
  (``record_stream``), so the caching allocator cannot hand the memory
  out again before the step is done with it.  The queue is bounded at
  ``depth`` (``MXNET_DEVICE_PREFETCH``, default 2), so the producer runs
  at most ``depth + 1`` batches ahead.  Emitted NDArrays carry a
  ``PrefetchStamp``: ``parallel.TrainStep`` / ``EvalStep`` take such a
  batch as it is, with no copy and no placement check, and count the call
  in ``resident_fastpath``.  With ``depth=0`` the wrapper passes the
  source's batches through: no thread, no stamps.  On the CPU
  (``device="cpu"``) the same threaded stage runs without pinning or
  streams, each batch copied.
* ``MetricDrain`` defers the host readback of step results by ``depth``
  (``MXNET_METRIC_DRAIN_DEPTH``, default 1) pushes.  A CUDA stream runs
  in order, so a plain ``.cpu()`` of step *i*'s loss issued after step
  *i+1* was queued would wait for step *i+1* as well; ``push`` instead
  starts a ``non_blocking`` copy into pinned memory at once and records
  an event, and a matured entry waits only on its own event.  Depth 0 is
  eager readback.

* ``DevicePrefetchIter(sharding=mesh.sharding("dp"))`` stages this
  rank's slice of each global batch on the mesh's card, stamped with
  the sharding, so a ``TrainStep`` / ``EvalStep`` with that sharding
  (``step.sharding``) takes it as it is.  A source that reads only the
  rank's part (``ImageRecordIter(num_parts=dp, part_index=rank,
  batch_size=B/dp)``, cut before anything is decoded) gives that slice
  itself; any other source gives the global batch, and the slice is cut
  on the host (``Sharding.local``) before the copy.

Not ported, and absent: the telemetry, tracing, goodput and
fault-injection hooks (A9), and the persistent compile cache of the JAX
module (``CompileCache``, ``compile_cache``, ``set_cache_dir``,
``load_executable``, ``store_executable``, ``runtime_versions_suffix``,
``versioned_jax_cache_dir``), which caches XLA executables; the port's
counterpart is a ledger of CUDA-graph programs (A9,
``compiled_program.py``).
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np
import torch

from . import telemetry
from .base import MXNetError, get_env, numpy_dtype
from .context import context_of, resolve_device
from .io import DataBatch, DataIter
from .ndarray.ndarray import NDArray

__all__ = ["DevicePrefetchIter", "PrefetchStamp", "MetricDrain",
           "match_stamp", "enabled", "prefetch_depth"]


def prefetch_depth():
    """MXNET_DEVICE_PREFETCH: how many batches DevicePrefetchIter stages
    on the device ahead of the consumer (default 2: double buffered).
    0 turns the prefetcher into a passthrough."""
    return max(0, get_env("MXNET_DEVICE_PREFETCH", 2, int))


def _default_enabled():
    return prefetch_depth() > 0


#: module-level flag the steps read: with MXNET_DEVICE_PREFETCH=0 they
#: do not look for stamps at all
enabled = _default_enabled()


def _reset():
    """Test hook: re-read MXNET_DEVICE_PREFETCH."""
    global enabled
    enabled = _default_enabled()


# ========================================================= device prefetch
class PrefetchStamp:
    """Identity tag a DevicePrefetchIter sticks on every NDArray it
    emits: one stamp per (source iterator, batch geometry).  A step that
    finds every input stamped takes the tensors as they are, already on
    ``device``."""

    __slots__ = ("source", "signature", "device", "sharding")

    def __init__(self, source, signature, device, sharding=None):
        self.source = source          # id of the emitting iterator
        self.signature = signature    # ((shape, dtype), ...) whole batch
        self.device = device          # torch.device the arrays sit on
        self.sharding = sharding      # parallel.mesh.Sharding, or None


def match_stamp(batch):
    """(stamp, signature) when every element of ``batch`` is an NDArray
    carrying the SAME PrefetchStamp (identity), else (None, None).  The
    signature is re-derived per array so a partial feed (e.g. EvalStep
    taking data without the label) still matches."""
    stamp = None
    sig = []
    for b in batch:
        tag = getattr(b, "_pipeline_stamp", None) \
            if isinstance(b, NDArray) else None
        if tag is None:
            return None, None
        s, entry = tag
        if stamp is None:
            stamp = s
        elif s is not stamp:
            return None, None
        sig.append(entry)
    return stamp, tuple(sig)


def _host_tensor(x):
    """The host tensor of one batch element (NDArray, tensor or
    array-like)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


class _Slot:
    """One pinned staging buffer set of a geometry's ring, with the event
    of the last copy out of it (None before the first)."""

    __slots__ = ("pinned", "event")

    def __init__(self, tensors):
        self.pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       for t in tensors]
        self.event = None


class _Ring:
    __slots__ = ("slots", "next")

    def __init__(self, tensors, size):
        self.slots = [_Slot(tensors) for _ in range(size)]
        self.next = 0

    def take(self):
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        return slot


class DevicePrefetchIter(DataIter):
    """Wrap any DataIter and stage its batches on ``device`` (``None``:
    ``cuda:0``, raising without a GPU; ``"cpu"`` for the threaded stage
    alone) ahead of the consumer; the module docstring gives the CUDA
    design.

    The queue is bounded at ``depth`` (``MXNET_DEVICE_PREFETCH``,
    default 2) so device memory for staged batches stays bounded;
    ``close()``/``reset()`` drain cleanly; a producer error is raised on
    the consumer's ``next()``.  With depth 0 the wrapper is a
    passthrough: no thread, no staging, no stamps.  ``hits`` and
    ``stalls`` count the ``next()`` calls that found a staged batch
    waiting and those that had to wait for one.  ``sharding`` (a
    ``parallel.mesh.Sharding``, e.g. ``mesh.sharding("dp")``) stages this
    rank's slice of each batch on the mesh's card (``device`` defaults
    to it): a source with ``num_parts`` > 1 (the record iterators' own
    split) must read the sharding's part of dim 0 and gives the slice
    as it is; any other source's batch is cut.
    """

    def __init__(self, data_iter, sharding=None, device=None, depth=None):
        from .parallel.mesh import Sharding
        if sharding is not None and not isinstance(sharding, Sharding):
            raise MXNetError(
                f"DevicePrefetchIter(sharding=...) takes a parallel.mesh."
                f"Sharding (mesh.sharding('dp')), got "
                f"{type(sharding).__name__}")
        self._sharding = sharding
        #: the source reads this rank's part already: stage it uncut
        self._source_cut = False
        if sharding is not None and getattr(data_iter, "num_parts", 1) > 1:
            part = (data_iter.num_parts, data_iter.part_index)
            if part != sharding.parts(0):
                raise MXNetError(
                    f"the source reads part {part[1]} of {part[0]}, the "
                    f"sharding {sharding} takes part {sharding.parts(0)[1]} "
                    f"of {sharding.parts(0)[0]} of the batch")
            self._source_cut = True
        if device is None and sharding is not None:
            device = sharding.device
        super().__init__(getattr(data_iter, "batch_size", 0))
        self._iter = data_iter
        self._depth = prefetch_depth() if depth is None else max(0, int(depth))
        self._stamp = None
        self._queue = None
        self._producer = None
        self._stop = threading.Event()
        self._error = None
        self._exhausted = False
        self._closed = False
        self.hits = self.stalls = 0
        if self._depth == 0:
            self.device = None
            return
        self.device = resolve_device(device)
        self._ctx = context_of(self.device)
        self._cuda = self.device.type == "cuda"
        self._rings = {}
        self._stream = torch.cuda.Stream(device=self.device) \
            if self._cuda else None
        self._start()

    # ------------------------------------------------------------ plumbing
    @property
    def passthrough(self):
        """True when depth 0 turned this wrapper into a no-op."""
        return self._depth == 0

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def _copy(self, host, sig):
        """Host tensors -> (device tensors, event of their copy)."""
        if not self._cuda:
            return [t.clone() for t in host], None
        ring = self._rings.get(sig)
        if ring is None:
            ring = self._rings[sig] = _Ring(host, self._depth + 1)
        slot = ring.take()
        if slot.event is not None:
            slot.event.synchronize()    # its last copy has left the buffer
        for pinned, t in zip(slot.pinned, host):
            pinned.copy_(t)
        with torch.cuda.stream(self._stream):
            dev = [p.to(self.device, non_blocking=True) for p in slot.pinned]
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        return dev, event

    def _place(self, batch):
        """Host batch -> (device-resident, stamped batch, copy event)."""
        data = [_host_tensor(d) for d in (batch.data or [])]
        label = [_host_tensor(lb) for lb in (batch.label or [])]
        if self._sharding is not None and not self._source_cut:
            data = [self._sharding.local(t).contiguous() for t in data]
            label = [self._sharding.local(t).contiguous() for t in label]
        host = data + label
        if telemetry.enabled:
            telemetry.counter("io.h2d_prefetch.bytes").inc(
                sum(t.nbytes for t in host))
        sig = tuple((tuple(t.shape), numpy_dtype(t.dtype).name)
                    for t in host)
        dev, event = self._copy(host, sig)
        stamp = self._stamp
        if stamp is None or stamp.signature != sig:
            # one stamp per source geometry; a geometry change (the last
            # ragged batch, bucketing) mints a fresh stamp
            stamp = self._stamp = PrefetchStamp(id(self), sig, self.device,
                                                self._sharding)
        out = []
        for t, entry in zip(dev, sig):
            nd = NDArray(t, self._ctx)
            nd._pipeline_stamp = (stamp, entry)
            out.append(nd)
        placed = DataBatch(data=out[:len(data)], label=out[len(data):],
                           pad=batch.pad, index=batch.index,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)
        return placed, event

    def _start(self):
        # each producer generation gets its OWN queue and stop Event
        # (captured as _produce args, never reread from self): a zombie
        # producer that outlived _drain's join timeout, blocked in
        # next(self._iter), still sees ITS generation's stop as set, so
        # it can neither resume pulling alongside the new producer nor
        # put stale batches into the new epoch's queue
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._error = None
        self._exhausted = False
        self._producer = threading.Thread(
            target=self._produce, args=(self._stop, self._queue),
            name="mxnet-device-prefetch", daemon=True)
        self._producer.start()

    def _produce(self, stop, out_queue):
        try:
            if self._cuda:
                # the current CUDA device is per-thread state
                torch.cuda.set_device(self.device)
            while not stop.is_set():
                try:
                    batch = next(self._iter)
                except StopIteration:
                    break
                if stop.is_set():
                    # drained while blocked in next(): drop the batch
                    # without touching the (new generation's) stamp
                    break
                placed = self._place(batch)
                # bounded put that still honours close()/reset() draining
                while not stop.is_set():
                    try:
                        out_queue.put(placed, timeout=0.05)
                        break
                    except _queue.Full:
                        continue
        except Exception as e:      # raised again on the consumer's next()
            if not stop.is_set():
                self._error = e
        finally:
            # the end-of-stream sentinel MUST land even when the queue
            # is momentarily full (a slow consumer would otherwise
            # drain the staged batches and block on get() forever);
            # only a close()/reset() drain (stop set) may skip it
            while not stop.is_set():
                try:
                    out_queue.put(None, timeout=0.05)
                    break
                except _queue.Full:
                    continue

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

    # -------------------------------------------------------------- public
    def next(self):
        if self._depth == 0:
            return next(self._iter)
        if self._closed:
            raise MXNetError("DevicePrefetchIter is closed")
        if self._exhausted:
            raise StopIteration
        stalled = self._queue.empty()
        item = self._queue.get()
        if item is None:
            # end-of-stream sentinel: not a consumer wait, so it counts
            # toward neither hits nor stalls
            self._exhausted = True
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        if stalled:
            self.stalls += 1
        else:
            self.hits += 1
        if telemetry.enabled:
            telemetry.counter("io.h2d_prefetch.stall" if stalled
                              else "io.h2d_prefetch.hit").inc()
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for nd in batch.data + batch.label:
                nd._data.record_stream(stream)
        return batch

    def reset(self):
        if self._depth == 0:
            self._iter.reset()
            return
        self._drain()
        self._iter.reset()
        self._start()

    def close(self):
        """Stop the producer and drain staged batches; idempotent."""
        if self._depth > 0:
            self._drain()
            self._closed = True
        if hasattr(self._iter, "close"):
            self._iter.close()


# ====================================================== deferred readback
class _Pending:
    """A value whose host copy is under way: the host tensors (pinned on
    the card's side) and the event that marks the copies done."""

    __slots__ = ("host", "event", "kind")

    def __init__(self, value):
        tensors = value if isinstance(value, (list, tuple)) else [value]
        self.kind = type(value) if isinstance(value, (list, tuple)) \
            else None
        self.event = None
        self.host = []
        for v in tensors:
            t = v._data if isinstance(v, NDArray) else v
            t = t.detach()
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                self.host.append(buf)
                if self.event is None:
                    self.event = torch.cuda.Event()
            else:
                self.host.append(t.clone())
        if self.event is not None:
            self.event.record()

    def result(self):
        if self.event is not None:
            self.event.synchronize()
        out = [_numpy(t) for t in self.host]
        return self.kind(out) if self.kind is not None else out[0]


def _numpy(t):
    # bf16, which numpy lacks, widens to fp32 (exact)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _is_device_value(v):
    if isinstance(v, (NDArray, torch.Tensor)):
        return True
    return isinstance(v, (list, tuple)) and bool(v) and \
        all(isinstance(x, (NDArray, torch.Tensor)) for x in v)


class MetricDrain:
    """Deferred host readback: a bounded FIFO of not-yet-read step
    results.

    ``push(value)`` enqueues a device value (an NDArray or tensor, a
    list or tuple of them, or a zero-argument callable such as a
    deferred metric update) and returns the results of the entries
    older than ``depth``, oldest first: numpy arrays (a list or tuple
    for a list or tuple), or what a callable returns, called then.  A
    tensor's copy to pinned host memory starts at ``push``; its result
    waits only on that copy.  ``flush()`` returns everything still
    pending (end of epoch or loop).

    ``depth`` defaults to ``MXNET_METRIC_DRAIN_DEPTH`` (1).  Depth 0 is
    eager readback: push returns its own value's result."""

    def __init__(self, depth=None):
        if depth is None:
            depth = get_env("MXNET_METRIC_DRAIN_DEPTH", 1, int)
        self.depth = max(0, int(depth))
        self._pending = []

    @staticmethod
    def _materialize(v):
        if isinstance(v, _Pending):
            return v.result()
        if isinstance(v, (NDArray, torch.Tensor)):
            return _numpy((v._data if isinstance(v, NDArray) else v)
                          .detach().cpu())
        if callable(v):
            return v()
        if isinstance(v, (list, tuple)):
            return type(v)(MetricDrain._materialize(x) for x in v)
        return v

    def push(self, value):
        """Enqueue ``value``; return the list of matured (host) results
        this push released — empty until the drain is ``depth`` deep."""
        self._pending.append(_Pending(value) if _is_device_value(value)
                             else value)
        out = []
        while len(self._pending) > self.depth:
            out.append(self._materialize(self._pending.pop(0)))
        return out

    def flush(self):
        """Materialize everything still pending, oldest first."""
        out = [self._materialize(v) for v in self._pending]
        self._pending = []
        return out

    def __len__(self):
        return len(self._pending)
