"""ModelServer of the port (``incubator_mxnet_tpu/serving/server.py``):
request-level online inference over one predictor.

Callers ``submit()`` single examples (or ``submit_batch()`` small
batches) from any thread and get a ``concurrent.futures.Future``; a
background worker coalesces them in a ``DynamicBatcher``, pads each
batch up to a bucket size on the host (numpy), runs the predictor — a
``BlockPredictor`` or any callable, which copies the batch to its device
— and delivers each request's slice of the output as host numpy arrays.

``input_dtypes`` declares each input's dtype beside ``input_shapes``
(float32 by default); ``queue_depth()`` reads the queue; with
``ServingConfig(watchdog_s=s)`` a watchdog thread logs every thread's
stack and counts a stall (``serving.watchdog.stall``) when the worker
makes no progress for ``s`` seconds while requests are queued.
``stats()`` is the ``serving.*`` slice of ``telemetry.report(as_dict=
True)``, as in the JAX server (the registry is process-wide, so every
server of the process adds to it).
A worker that dies outside its per-batch handler fails every queued
future with WorkerCrashedError and refuses new submits.

Two backends: a ``BlockPredictor`` or any callable (``_BlockRunner``),
and a symbol ``predict.Predictor`` (``_SymbolRunner``: one
``Predictor.reshape`` per batch bucket, made at the bucket's first
batch, its input specs read from the bound executor).

What differs from the JAX server: the ``CompiledPredictor`` backend
waits for a later slice of ROADMAP A7; the autotune consult, fleet
shedding, the tracing, request-journal and fault-injection hooks, and
the watchdog's flight-recorder dump (``diagnostics.dump_state``) wait
for A9.  Outputs in bf16
(``BlockPredictor(bf16_compute=True)``) leave the server widened to
float32, which is exact: numpy has no bf16 (the JAX server hands back
``ml_dtypes`` bf16 arrays).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import sys
import threading
import time
import traceback

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..context import resolve_device
from .batcher import (DynamicBatcher, Request, ServerClosedError,
                      WorkerCrashedError)
from .config import ServingConfig

__all__ = ["ModelServer"]

_logger = logging.getLogger(__name__)

#: the serving.* metrics of the JAX schema: the batcher's admission and
#: queue, the worker's batches, errors, heartbeat and latencies
_SERVING_METRICS = (
    ("counter", "serving.request.count"), ("counter", "serving.reject.count"),
    ("counter", "serving.expire.count"), ("gauge", "serving.queue.depth"),
    ("histogram", "serving.queue_wait.us"),
    ("counter", "serving.batch.count"), ("counter", "serving.error.count"),
    ("counter", "serving.worker_crash.count"),
    ("histogram", "serving.batch_fill.ratio"),
    ("histogram", "serving.exec.us"), ("histogram", "serving.e2e.us"),
    ("gauge", "serving.worker.heartbeat"),
    ("counter", "serving.watchdog.stall"))


def _to_numpy(out):
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.float()              # numpy has no bf16; exact
        return out.cpu().numpy()
    return np.asarray(out)


def _thread_stacks():
    """Every thread's current stack, as text (the watchdog's evidence)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        parts.append(f"--- thread {names.get(ident, '?')} ({ident})\n"
                     + "".join(traceback.format_stack(frame)))
    return "\n".join(parts)


class _BlockRunner:
    """Drives a BlockPredictor or any callable on a list of host arrays,
    returning a list of host arrays."""

    def __init__(self, pred):
        self._pred = pred

    def run(self, arrays):
        out = self._pred(*arrays)
        if isinstance(out, (list, tuple)):
            return [_to_numpy(o) for o in out]
        return [_to_numpy(out)]


class _SymbolRunner:
    """Drives a symbol-level Predictor: one re-bound predictor per
    bucket (``Predictor.reshape``, one executor built per bucket, the
    MXPredReshape cost model)."""

    def __init__(self, pred):
        self._base = pred
        self._names = list(pred._input_names)
        ex = pred._executor
        self.specs = [(tuple(ex.arg_dict[n].shape[1:]),
                       np.dtype(ex.arg_dict[n].dtype))
                      for n in self._names]
        base_batch = int(ex.arg_dict[self._names[0]].shape[0])
        self.by_bucket = {base_batch: pred}

    def run(self, arrays):
        bucket = arrays[0].shape[0]
        p = self.by_bucket.get(bucket)
        if p is None:
            p = self._base.reshape(
                {n: (bucket,) + shape
                 for n, (shape, _) in zip(self._names, self.specs)})
            self.by_bucket[bucket] = p
        outs = p.forward(**dict(zip(self._names, arrays)))
        return [_to_numpy(o._data) for o in outs]


class ModelServer:
    """Thread-safe dynamic-batching server over one predictor.

    Usage::

        server = ModelServer(BlockPredictor(net), max_batch=32,
                             input_shapes=[(224, 224, 3)])
        # or ModelServer(predict.load_checkpoint_predictor(prefix, 1,
        #                {"data": (32, 3, 224, 224)}), max_batch=32)
        server.warmup()                    # every bucket once
        fut = server.submit(x)             # one example, no batch dim
        y = fut.result()                   # numpy output for x
        server.close()                     # drain + join

    ``input_shapes`` are the per-example shapes (no batch dim) of the
    model's inputs and ``input_dtypes`` their dtypes (default float32),
    for validation and ``warmup``; a symbol ``Predictor`` declares its
    own, and otherwise the first request defines the contract.  ``device`` (``None``:
    ``cuda:0``, raising without a GPU) is where the predictor runs; a
    predictor that names its own ``device`` must agree.
    Futures resolve to numpy arrays (a list when the model has several
    outputs) or raise QueueFullError / DeadlineExceededError /
    ServerClosedError / WorkerCrashedError / the backend's failure.
    """

    def __init__(self, predictor, config=None, input_shapes=None,
                 input_dtypes=None, device=None, **knobs):
        if config is None:
            config = ServingConfig(**knobs)
        elif knobs:
            raise MXNetError(f"pass either config= or knob kwargs, not both "
                             f"(got {sorted(knobs)})")
        from ..predict import Predictor
        if isinstance(predictor, Predictor):
            self._runner = _SymbolRunner(predictor)
        elif callable(predictor):
            self._runner = _BlockRunner(predictor)
        else:
            raise MXNetError(
                f"unsupported predictor type {type(predictor).__name__}: "
                "expected a Predictor, a BlockPredictor or a callable (the "
                "compiled predictor backend is not ported yet)")
        self.device = resolve_device(device)
        own = getattr(predictor, "device", None)
        if own is not None and torch.device(own) != self.device:
            raise MXNetError(f"ModelServer on {self.device}, but its "
                             f"predictor runs on {own}")
        self._cfg = config
        self._specs = getattr(self._runner, "specs", None)
        if input_shapes is not None:
            shapes = list(input_shapes.values()) \
                if isinstance(input_shapes, dict) else list(input_shapes)
            if input_dtypes is None:
                input_dtypes = ["float32"] * len(shapes)
            self._specs = [(tuple(s), np.dtype(d))
                           for s, d in zip(shapes, input_dtypes)]
        self._batcher = DynamicBatcher(config)
        if telemetry.enabled:
            # the serving.* schema exists from the first server on,
            # zeros included, as the JAX server registers it
            for kind, name in _SERVING_METRICS:
                getattr(telemetry, kind)(name)
        # serialises predictor execution between the worker and warmup()
        self._exec_lock = threading.Lock()
        self._closed = False
        #: the exception that killed the worker (None while healthy)
        self._worker_exc = None
        # written by the worker thread only
        self._counts = {"batches": 0, "examples": 0, "padded": 0,
                        "errors": 0}
        self._exec_s = 0.0
        #: monotone worker progress counter the watchdog compares
        self._hb = 0
        self._stalls = 0
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="mxnet-serving-worker",
                                        daemon=True)
        self._worker.start()
        self._watchdog = None
        if config.watchdog_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, args=(float(config.watchdog_s),),
                name="mxnet-serving-watchdog", daemon=True)
            self._watchdog.start()

    def queue_depth(self):
        """Requests currently queued."""
        return len(self._batcher)

    # ------------------------------------------------------------- submit
    def submit(self, *inputs, timeout_ms=None):
        """Queue ONE example (inputs without batch dim, one positional
        arg per model input).  Returns a Future of the example's
        output."""
        arrays = self._prep(inputs, add_batch_dim=True)
        return self._enqueue(arrays, 1, unbatch=True, timeout_ms=timeout_ms)

    def submit_batch(self, *inputs, timeout_ms=None):
        """Queue a small already-batched request (leading dim = example
        count, kept whole).  Returns a Future of outputs with the same
        leading dim."""
        arrays = self._prep(inputs, add_batch_dim=False)
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise MXNetError(f"submit_batch: leading dims differ "
                             f"{[a.shape[0] for a in arrays]}")
        if n < 1:
            raise MXNetError("submit_batch: empty batch")
        if n > self._cfg.max_batch:
            raise MXNetError(
                f"submit_batch: {n} examples exceeds max_batch "
                f"{self._cfg.max_batch}; split the request or raise "
                "MXNET_SERVING_MAX_BATCH")
        return self._enqueue(arrays, n, unbatch=False, timeout_ms=timeout_ms)

    def _prep(self, inputs, add_batch_dim):
        if not inputs:
            raise MXNetError("submit: at least one input is required")
        if self._specs is not None and len(inputs) != len(self._specs):
            raise MXNetError(f"submit: model takes {len(self._specs)} "
                             f"inputs, got {len(inputs)}")
        arrays = []
        for i, x in enumerate(inputs):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            a = np.asarray(x)
            if self._specs is not None:
                shape, dtype = self._specs[i]
                a = np.ascontiguousarray(a, dtype)
                expect = shape if add_batch_dim else a.shape[:1] + shape
                if tuple(a.shape) != tuple(expect):
                    raise MXNetError(
                        f"submit: input {i} has shape {a.shape}, expected "
                        f"{'per-example ' if add_batch_dim else ''}"
                        f"{tuple(expect)}")
            arrays.append(a[None] if add_batch_dim else a)
        if self._specs is None:
            # no declared shapes: the first request defines the contract
            self._specs = [(tuple(a.shape[1:]), a.dtype) for a in arrays]
        return arrays

    def _enqueue(self, arrays, n, unbatch, timeout_ms):
        if timeout_ms is None:
            timeout_ms = self._cfg.timeout_ms
        deadline = time.perf_counter() + timeout_ms / 1e3 \
            if timeout_ms is not None else None
        if self._worker_exc is not None:
            raise WorkerCrashedError(
                f"serving worker crashed ({self._worker_exc!r}); the server "
                "is dead — recreate it")
        if self._closed:
            raise ServerClosedError("server is closed")
        fut = concurrent.futures.Future()
        self._batcher.submit(Request(arrays, n, fut, deadline=deadline,
                                     unbatch=unbatch))
        return fut

    # ------------------------------------------------------------- worker
    def _scope(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _worker_loop(self):
        try:
            with self._scope():
                while True:
                    batch = self._batcher.next_batch()
                    self._beat()              # progress heartbeat
                    if batch is None:
                        return                # closed and drained
                    if batch:                 # else: all had expired
                        self._run_batch(batch)
                    self._beat()
        except Exception as e:
            # containment: a worker dying outside the per-batch handler
            # must not leave queued futures blocking forever
            self._worker_exc = e
            if telemetry.enabled:
                telemetry.counter("serving.worker_crash.count").inc()
            _logger.exception("serving worker died: failing %d pending "
                              "request(s), refusing new submits",
                              len(self._batcher))
            self._batcher.fail_pending(WorkerCrashedError(
                f"serving worker crashed before this request ran ({e!r}); "
                "the server is dead — recreate it"), close=True)

    def _beat(self):
        self._hb += 1
        if telemetry.enabled:
            telemetry.gauge("serving.worker.heartbeat").set(self._hb)

    def _run_batch(self, reqs):
        """Assemble, pad, run and scatter one batch.  A failure fails
        this batch's futures and leaves the loop running."""
        try:
            total = sum(r.n for r in reqs)
            bucket = self._cfg.bucket_for(total)
            cols = []
            for i in range(len(reqs[0].arrays)):
                parts = [r.arrays[i] for r in reqs]
                a = parts[0] if len(parts) == 1 else np.concatenate(parts)
                if a.shape[0] < bucket:       # pad up to the bucket
                    a = np.concatenate([a, np.zeros(
                        (bucket - a.shape[0],) + a.shape[1:], a.dtype)])
                cols.append(a)
            t0 = time.perf_counter()
            with self._exec_lock:
                outs = self._runner.run(cols)
            self._exec_s += time.perf_counter() - t0
        except Exception as e:
            self._counts["errors"] += 1
            if telemetry.enabled:
                telemetry.counter("serving.error.count").inc()
            _logger.exception("serving batch of %d request(s) failed",
                              len(reqs))
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        t1 = time.perf_counter()
        self._counts["batches"] += 1
        self._counts["examples"] += total
        self._counts["padded"] += bucket
        tel = telemetry.enabled
        if tel:
            telemetry.counter("serving.batch.count").inc()
            telemetry.histogram("serving.batch_fill.ratio").observe(
                total / bucket)
            telemetry.histogram("serving.exec.us").observe((t1 - t0) * 1e6)
        off = 0
        for r in reqs:
            sliced = [o[off:off + r.n] for o in outs]
            off += r.n
            if r.unbatch:
                sliced = [o[0] for o in sliced]
            if tel:
                telemetry.histogram("serving.e2e.us").observe(
                    (t1 - r.t_submit) * 1e6)
            r.future.set_result(sliced[0] if len(sliced) == 1 else sliced)

    # ----------------------------------------------------------- watchdog
    def _watchdog_loop(self, wd_s):
        """Stall detector: when the worker's heartbeat does not advance
        for ``wd_s`` seconds while requests are queued, log every
        thread's stack and count a stall (once per stalled period)."""
        poll = max(0.02, min(wd_s / 4.0, 1.0))
        last_hb = self._hb
        last_progress = time.perf_counter()
        while not self._closed:
            time.sleep(poll)
            hb = self._hb
            now = time.perf_counter()
            if hb != last_hb or len(self._batcher) == 0:
                last_hb = hb
                last_progress = now
                continue
            if now - last_progress >= wd_s:
                self._stalls += 1
                if telemetry.enabled:
                    telemetry.counter("serving.watchdog.stall").inc()
                _logger.error(
                    "serving worker made no progress for %.2fs with %d "
                    "queued request(s); thread stacks:\n%s",
                    now - last_progress, len(self._batcher),
                    _thread_stacks())
                last_progress = now    # re-arm: one report per period

    # ------------------------------------------------------------ control
    def warmup(self):
        """Run zeros through the predictor at every bucket size, so the
        first real traffic pays no first-use cost (kernel builds, cuDNN
        algorithm choice, allocator growth).  Needs the per-example
        input shapes: pass ``input_shapes=`` or submit once first."""
        if self._specs is None:
            raise MXNetError(
                "warmup(): input shapes unknown — pass input_shapes= "
                "(per-example, no batch dim) at construction, or submit "
                "a first request")
        for b in self._cfg.buckets:
            cols = [np.zeros((b,) + shape, dtype)
                    for shape, dtype in self._specs]
            with self._exec_lock, self._scope():
                self._runner.run(cols)

    def stats(self):
        """The ``serving.*`` slice of ``telemetry.report(as_dict=True)``
        (JAX ``ModelServer.stats``)."""
        snap = telemetry.report(as_dict=True)
        return {k: v for k, v in snap.items() if k.startswith("serving.")}

    def _counters(self):
        """This server's own counts: requests, batches, examples, padded
        (bucket slots run), errors, rejected, expired, ``mean_fill``
        (examples / padded slots), ``exec_s`` (host seconds in the
        predictor, including the copies to and from the device) and
        ``watchdog_stalls``."""
        out = dict(self._counts)
        out["watchdog_stalls"] = self._stalls
        out["requests"] = self._batcher.accepted
        out["rejected"] = self._batcher.rejected
        out["expired"] = self._batcher.expired
        out["mean_fill"] = out["examples"] / out["padded"] \
            if out["padded"] else 0.0
        out["exec_s"] = self._exec_s
        return out

    def close(self, drain=True):
        """Stop accepting work and join the worker.  ``drain=True``
        (default) lets queued requests run; ``drain=False`` fails them
        with ServerClosedError."""
        if self._closed:
            return
        self._closed = True
        if not drain:
            self._batcher.cancel_pending()
        self._batcher.close()
        self._worker.join()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(drain=exc_type is None)
        return False
