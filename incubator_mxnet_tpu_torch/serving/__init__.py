"""Serving of the port: the continuous-batching generation engine."""
from .batcher import (DeadlineExceededError, QueueFullError,
                      ServerClosedError, ServingError, WorkerCrashedError)
from .generation import GenerationConfig, GenerationEngine, GenerationFuture

__all__ = ["GenerationConfig", "GenerationEngine", "GenerationFuture",
           "ServingError", "QueueFullError", "DeadlineExceededError",
           "ServerClosedError", "WorkerCrashedError"]
