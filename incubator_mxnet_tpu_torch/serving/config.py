"""Serving configuration of the port (``incubator_mxnet_tpu/serving/
config.py``): the knobs of ``ModelServer`` and ``DynamicBatcher``, each
readable from the environment.

* ``MXNET_SERVING_MAX_BATCH``   — largest coalesced batch (default 32).
* ``MXNET_SERVING_LINGER_US``   — how long a non-full batch waits for
  more requests before dispatching (default 2000 µs; 0 dispatches what
  is queued at once).
* ``MXNET_SERVING_QUEUE_DEPTH`` — queued requests before submits are
  rejected, or block, per ``full_policy`` (default 256).
* ``MXNET_SERVING_WATCHDOG_S`` — worker stall watchdog: when > 0 and the
  worker makes no progress for this many seconds while requests are
  queued, the server logs every thread's stack and counts a stall in
  ``stats()["watchdog_stalls"]`` (default 0: off).

Every coalesced batch is padded up to one of a fixed, sorted set of
bucket sizes (default the power-of-two chain 1, 2, 4, ... max_batch), so
the forward sees ``len(buckets)`` shapes whatever the traffic.  The
autotune consult of the JAX package is not ported (ROADMAP A9).
"""
from __future__ import annotations

from ..base import MXNetError, get_env

__all__ = ["ServingConfig", "pow2_buckets"]


def pow2_buckets(max_batch):
    """Powers of two below ``max_batch``, then ``max_batch``."""
    if max_batch < 1:
        raise MXNetError(f"max_batch must be >= 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return out


class ServingConfig:
    """Validated knobs, in the JAX package's order: ``max_batch``,
    ``linger_us``, ``queue_depth`` (environment defaults above),
    ``buckets`` (sorted, deduplicated, the largest equal to
    ``max_batch``; default ``pow2_buckets``), ``full_policy``
    (``"reject"``: a full queue fast-rejects with QueueFullError;
    ``"block"``: the submitting thread waits for space or its
    deadline), ``timeout_ms``, the default per-request deadline (None:
    none), and ``watchdog_s`` (environment default above; 0 disables
    the watchdog)."""

    def __init__(self, max_batch=None, linger_us=None, queue_depth=None,
                 buckets=None, full_policy="reject", timeout_ms=None,
                 watchdog_s=None):
        self.max_batch = int(max_batch if max_batch is not None
                             else get_env("MXNET_SERVING_MAX_BATCH", 32, int))
        self.linger_us = int(linger_us if linger_us is not None
                             else get_env("MXNET_SERVING_LINGER_US", 2000,
                                          int))
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else get_env("MXNET_SERVING_QUEUE_DEPTH", 256, int))
        if self.max_batch < 1:
            raise MXNetError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.linger_us < 0:
            raise MXNetError(f"linger_us must be >= 0, got {self.linger_us}")
        if self.queue_depth < 1:
            raise MXNetError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        self.watchdog_s = float(
            watchdog_s if watchdog_s is not None
            else get_env("MXNET_SERVING_WATCHDOG_S", 0.0, float))
        if self.watchdog_s < 0:
            raise MXNetError(
                f"watchdog_s must be >= 0, got {self.watchdog_s}")
        if full_policy not in ("reject", "block"):
            raise MXNetError(
                f"full_policy must be 'reject' or 'block', got "
                f"{full_policy!r}")
        self.full_policy = full_policy
        self.timeout_ms = timeout_ms
        if buckets is None:
            buckets = pow2_buckets(self.max_batch)
        buckets = sorted({int(b) for b in buckets})
        if not buckets or buckets[0] < 1:
            raise MXNetError(f"buckets must be positive ints, got {buckets}")
        if buckets[-1] != self.max_batch:
            raise MXNetError(
                f"largest bucket ({buckets[-1]}) must equal max_batch "
                f"({self.max_batch}) so every coalesced batch fits a bucket")
        self.buckets = buckets

    def bucket_for(self, n):
        """Smallest bucket >= n."""
        for b in self.buckets:
            if b >= n:
                return b
        raise MXNetError(
            f"batch of {n} examples exceeds max_batch {self.max_batch}")

    def __repr__(self):
        return (f"ServingConfig(max_batch={self.max_batch}, "
                f"linger_us={self.linger_us}, "
                f"queue_depth={self.queue_depth}, buckets={self.buckets}, "
                f"full_policy={self.full_policy!r}, "
                f"timeout_ms={self.timeout_ms}, "
                f"watchdog_s={self.watchdog_s})")
