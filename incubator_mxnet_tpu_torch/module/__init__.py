"""Module API of the port — the symbolic training front end (counterpart
of ``incubator_mxnet_tpu/module/``; reference python/mxnet/module/)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule"]
