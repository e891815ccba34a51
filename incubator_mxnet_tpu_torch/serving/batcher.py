"""Dynamic batcher of the port (``incubator_mxnet_tpu/serving/
batcher.py``): the bounded queue between ``ModelServer.submit()`` and
the forward, and the serving-layer exceptions.

Requests (one example or a small batch each) wait in a bounded FIFO;
the server's worker pulls a coalesced batch when the queue holds
``max_batch`` examples or ``linger_us`` has passed since the pull began.
A multi-example request is never split across batches.  Admission
control happens at submit: a full queue fast-rejects
(``full_policy="reject"``) or blocks the caller as backpressure
(``"block"``) until a pop frees space, its deadline passes
(DeadlineExceededError) or ``close()`` wakes it (ServerClosedError).
Deadlines are enforced
at pop: an expired request fails with ``DeadlineExceededError`` and
never takes a batch slot, nor does one whose future the caller
cancelled; a popped request's future is running and can no longer be
cancelled.  The telemetry, tracing and request-journal
hooks of the JAX batcher are not ported yet; the batcher counts what it
accepts, rejects and expires instead (``accepted``, ``rejected``,
``expired``).
"""
from __future__ import annotations

import collections
import threading
import time

from .. import telemetry
from ..base import MXNetError

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "ServerClosedError", "WorkerCrashedError", "Request",
           "DynamicBatcher"]


class ServingError(MXNetError):
    """Base class of serving-layer failures."""


class QueueFullError(ServingError):
    """Admission control fast-rejected the request (queue at depth)."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before it completed."""


class ServerClosedError(ServingError):
    """submit() after close(), or pending work cancelled by close."""


class WorkerCrashedError(ServingError):
    """The server's background worker thread died from an unexpected
    exception: every pending future failed with this, and new submits
    are refused — the server must be recreated."""


class Request:
    """One queued unit of work: per-input host arrays (leading dim =
    ``n`` examples), the future the caller holds, and an optional
    absolute deadline (``time.perf_counter()`` seconds).  ``unbatch``
    marks a bare example whose result is returned without the batch
    dim."""

    __slots__ = ("arrays", "n", "future", "deadline", "unbatch", "t_submit")

    def __init__(self, arrays, n, future, deadline=None, unbatch=False):
        self.arrays = arrays
        self.n = int(n)
        self.future = future
        self.deadline = deadline
        self.unbatch = unbatch
        self.t_submit = time.perf_counter()

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.perf_counter()) > self.deadline


class DynamicBatcher:
    """Bounded request queue and coalescing policy.  ``submit()`` is
    safe from any number of threads; ``next_batch()`` is for the one
    worker thread."""

    def __init__(self, config):
        self._cfg = config
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._examples = 0          # examples queued
        self._closed = False
        self.accepted = 0           # requests queued
        self.rejected = 0           # refused at submit (full or closed)
        self.expired = 0            # deadline passed before a batch

    def __len__(self):
        with self._cond:
            return len(self._queue)

    @property
    def closed(self):
        """True once ``close()`` (or a worker crash) stopped admission."""
        return self._closed

    def _refuse(self, exc):
        self.rejected += 1
        if telemetry.enabled:
            telemetry.counter("serving.reject.count").inc()
        raise exc

    def _note_expired(self):
        self.expired += 1
        if telemetry.enabled:
            telemetry.counter("serving.expire.count").inc()

    def _note_depth(self):
        # a level set under the lock: toggling telemetry between a
        # push and its pop cannot unbalance it
        if telemetry.enabled:
            telemetry.gauge("serving.queue.depth").set(len(self._queue))

    def submit(self, req):
        """Enqueue a Request, honouring admission control.  Raises
        ServerClosedError / QueueFullError, or with ``full_policy=
        "block"`` DeadlineExceededError when the deadline passes while
        waiting for space."""
        cfg = self._cfg
        with self._cond:
            if self._closed:
                self._refuse(ServerClosedError("server is closed"))
            if len(self._queue) >= cfg.queue_depth:
                if cfg.full_policy == "reject":
                    self._refuse(QueueFullError(
                        f"serving queue full ({cfg.queue_depth} requests); "
                        "raise MXNET_SERVING_QUEUE_DEPTH, add capacity, or "
                        "use full_policy='block' for backpressure"))
                while len(self._queue) >= cfg.queue_depth \
                        and not self._closed:
                    timeout = None
                    if req.deadline is not None:
                        timeout = req.deadline - time.perf_counter()
                        if timeout <= 0:
                            self._note_expired()
                            raise DeadlineExceededError(
                                "deadline expired while blocked on queue "
                                "space (backpressure)")
                    self._cond.wait(timeout)
                if self._closed:
                    self._refuse(ServerClosedError("server is closed"))
            self._queue.append(req)
            self._examples += req.n
            self.accepted += 1
            if telemetry.enabled:
                telemetry.counter("serving.request.count").inc()
                self._note_depth()
            self._cond.notify_all()

    def next_batch(self):
        """Block until work is queued, linger for coalescing, pop one
        batch: a list of Requests whose examples sum to <= max_batch
        (empty when everything popped had expired), or None once the
        batcher is closed and drained."""
        cfg = self._cfg
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None
            if self._examples < cfg.max_batch and cfg.linger_us \
                    and not self._closed:
                deadline = time.perf_counter() + cfg.linger_us / 1e6
                while self._examples < cfg.max_batch and not self._closed:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            batch, total = [], 0
            now = time.perf_counter()
            while self._queue:
                req = self._queue[0]
                if total and total + req.n > cfg.max_batch:
                    break                       # keep the request whole
                self._queue.popleft()
                self._examples -= req.n
                if not req.future.set_running_or_notify_cancel():
                    continue                    # the caller cancelled it
                if req.expired(now):
                    self._note_expired()
                    req.future.set_exception(DeadlineExceededError(
                        f"request expired after "
                        f"{(now - req.t_submit) * 1e3:.1f} ms in queue"))
                    continue
                if telemetry.enabled:
                    telemetry.histogram("serving.queue_wait.us").observe(
                        (now - req.t_submit) * 1e6)
                batch.append(req)
                total += req.n
            self._note_depth()
            self._cond.notify_all()             # space freed for producers
            return batch

    def close(self):
        """Stop admitting and wake every waiter; queued work stays for
        next_batch() to drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def cancel_pending(self):
        """Fail every queued request with ServerClosedError (the
        ``close(drain=False)`` path)."""
        self.fail_pending(ServerClosedError(
            "server closed before the request was executed"))

    def fail_pending(self, exc, close=False):
        """Fail every queued request with a fresh copy of ``exc``;
        ``close=True`` also stops admission (worker-crash containment:
        a dead worker must not leave futures blocking forever)."""
        with self._cond:
            if close:
                self._closed = True
            while self._queue:
                req = self._queue.popleft()
                self._examples -= req.n
                if telemetry.enabled:
                    telemetry.counter("serving.reject.count").inc()
                if not req.future.done():
                    req.future.set_exception(type(exc)(*exc.args))
            self._note_depth()
            self._cond.notify_all()
