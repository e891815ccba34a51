"""``mx.nd.image`` of the port (counterpart of
``incubator_mxnet_tpu/ndarray/image.py``; reference
python/mxnet/ndarray/image.py): the registry's ``_image_<name>`` ops by
``<name>`` (``mx.nd.image.to_tensor``, ``random_color_jitter`` ...)."""
from __future__ import annotations

import sys

from ..ops import find_op, list_ops
from .op import _make_wrapper

_module = sys.modules[__name__]
_PREFIX = "_image_"

for _name in list_ops():
    if _name.startswith(_PREFIX):
        setattr(_module, _name[len(_PREFIX):], _make_wrapper(_name))


def __getattr__(name):
    if find_op(_PREFIX + name) is None:
        raise AttributeError(name)
    w = _make_wrapper(_PREFIX + name)
    setattr(_module, name, w)
    return w
