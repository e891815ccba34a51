"""Serving-layer exceptions (the port's copy of the classes in
``incubator_mxnet_tpu/serving/batcher.py``; the dynamic batcher itself
comes with the ModelServer slice)."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "ServerClosedError", "WorkerCrashedError"]


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
