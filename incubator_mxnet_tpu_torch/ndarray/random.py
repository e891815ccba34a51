"""``mx.nd.random`` — the eager sampling namespace (counterpart of
``incubator_mxnet_tpu/ndarray/random.py``; reference
python/mxnet/ndarray/random.py): ``mx.nd.random.uniform(...)``
dispatches to the registry op ``random_uniform`` (then ``sample_*``,
then the bare name).  The port's wrappers take ``ctx=``."""
from __future__ import annotations

import sys

from ..ops import find_op
from .op import _make_wrapper

_module = sys.modules[__name__]

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "randint", "shuffle"]


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    for candidate in ("random_" + name, "sample_" + name, name):
        if find_op(candidate) is not None:
            w = _make_wrapper(candidate)
            w.__name__ = name
            setattr(_module, name, w)
            return w
    raise AttributeError(f"no random op '{name}'")
