"""Contrib neural-network layers of the port (counterpart of
``incubator_mxnet_tpu/gluon/contrib/nn/``; reference gluon/contrib/nn/)."""
from .basic_layers import Concurrent, HybridConcurrent, Identity

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]
