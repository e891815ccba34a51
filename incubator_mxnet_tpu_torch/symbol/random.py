"""``mx.sym.random`` (counterpart of
``incubator_mxnet_tpu/symbol/random.py``): sampling symbols by the
registry's ``random_<name>``, ``sample_<name>`` or ``<name>`` op.  A
bound executor draws from its device's generator (``random.generator``),
so it is reproducible under ``mx.random.seed``."""
from __future__ import annotations

import sys

from ..ops import find_op
from .symbol import _make_sym_op

_module = sys.modules[__name__]

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "randint"]


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    for candidate in ("random_" + name, "sample_" + name, name):
        if find_op(candidate) is not None:
            w = _make_sym_op(candidate)
            setattr(_module, name, w)
            return w
    raise AttributeError(f"no random op '{name}'")
