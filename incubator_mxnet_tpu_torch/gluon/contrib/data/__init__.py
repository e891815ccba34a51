"""Contrib data helpers of the port (counterpart of
``incubator_mxnet_tpu/gluon/contrib/data``)."""
from .sampler import IntervalSampler
from . import text

__all__ = ["IntervalSampler", "text"]
