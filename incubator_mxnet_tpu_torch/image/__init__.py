"""mx.image of the port: host-side image loading and augmentation
(counterpart of ``incubator_mxnet_tpu/image``)."""
from .image import *  # noqa: F401,F403
