"""The NDArray package of the port (counterpart of
``incubator_mxnet_tpu/ndarray/``; reference python/mxnet/ndarray/):
``NDArray``, the creation functions, the generated op wrappers at
package level, ``nd.random``, ``nd.contrib`` (the ``_contrib_`` ops),
``nd.linalg`` and ``nd.save`` / ``nd.load``.  Sparse and image are not
ported yet (ROADMAP A8)."""
import sys as _sys

from . import _internal, op, random  # noqa: F401
from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      imperative_invoke, invoke, moveaxis, ones, waitall,
                      zeros)
from .op import *  # noqa: F401,F403 — generated op wrappers
from .op import _populate as _populate_ops
from .utils import load, save

_populate_ops(_sys.modules[__name__])

from . import contrib, linalg  # noqa: E402 (after the op wrappers)

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "invoke", "imperative_invoke",
           "waitall", "save", "load", "op", "random", "contrib", "linalg"]
