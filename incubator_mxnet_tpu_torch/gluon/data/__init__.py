"""gluon.data of the port: Dataset / Sampler / DataLoader and the vision
datasets and transforms (counterpart of ``incubator_mxnet_tpu/gluon/
data``)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
