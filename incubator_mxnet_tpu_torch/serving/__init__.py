"""Serving of the port: the dynamic-batching ModelServer and the
continuous-batching generation engine."""
from .batcher import (DeadlineExceededError, DynamicBatcher, QueueFullError,
                      Request, ServerClosedError, ServingError,
                      WorkerCrashedError)
from .config import ServingConfig, pow2_buckets
from .generation import GenerationConfig, GenerationEngine, GenerationFuture
from .server import ModelServer

__all__ = ["ModelServer", "ServingConfig", "pow2_buckets", "DynamicBatcher",
           "Request", "GenerationConfig", "GenerationEngine",
           "GenerationFuture", "ServingError", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError",
           "WorkerCrashedError"]
