"""DataLoader of the port (counterpart of ``incubator_mxnet_tpu/gluon/
data/dataloader.py``; reference python/mxnet/gluon/data/dataloader.py).

Workers are threads, as in the JAX package: the decode and augment work
(cv2, PIL, numpy) releases the GIL for its native parts, so
``num_workers=N`` threads assemble batches into a bounded queue and the
batches come out in sampler order.  ``default_batchify_fn`` stacks the
samples into **host** NDArrays (``ctx=mx.cpu()``); the copy to the card
is the consumer's (or ``pipeline_io.DevicePrefetchIter``'s).
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np

from ...ndarray import ndarray as _nd
from ...context import cpu
from ...ndarray.ndarray import NDArray
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _host(a):
    """A host NDArray holding a copy of ``a`` (float64 becomes float32,
    the JAX package's rule)."""
    return _nd.array(a, ctx=cpu())


def default_batchify_fn(data):
    """Stack samples into a host batch (reference
    dataloader.py:default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        import numpy as onp
        return _host(onp.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn([d[i] for d in data])
                     for i in range(len(data[0])))
    data = np.asarray(data)
    return _host(data)


class DataLoader:
    """Iterate a Dataset in mini-batches (reference dataloader.py:DataLoader).

    Parameters mirror the reference: dataset, batch_size, shuffle, sampler,
    last_batch ('keep'/'discard'/'rollover'), batch_sampler, batchify_fn,
    num_workers (0 = load in the calling thread).
    """

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, prefetch=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is"
                    " specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be"
                " specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, int(num_workers))
        self._prefetch = prefetch if prefetch is not None \
            else 2 * max(1, self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _load(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load(indices)
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        """N worker threads pull batch-index lists from a task queue and push
        assembled batches; order is preserved by sequence numbers."""
        tasks = list(self._batch_sampler)
        out_q = _queue.Queue(maxsize=self._prefetch)
        task_q = _queue.Queue()
        for seq, indices in enumerate(tasks):
            task_q.put((seq, indices))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    seq, indices = task_q.get_nowait()
                except _queue.Empty:
                    return
                try:
                    out_q.put((seq, self._load(indices), None))
                except Exception as exc:  # propagate to consumer
                    out_q.put((seq, None, exc))
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            buffered = {}
            for want in range(len(tasks)):
                while want not in buffered:
                    seq, batch, exc = out_q.get()
                    if exc is not None:
                        raise exc
                    buffered[seq] = batch
                yield buffered.pop(want)
        finally:
            stop.set()
            try:
                while True:
                    task_q.get_nowait()
            except _queue.Empty:
                pass
            # a worker blocked on a full out_q (the consumer stopped
            # early) finishes its put and then sees stop
            while any(t.is_alive() for t in threads):
                try:
                    out_q.get(timeout=0.01)
                except _queue.Empty:
                    pass
