"""Foundation utilities of the PyTorch port: the framework error and the
typed environment lookup (counterparts of ``incubator_mxnet_tpu/base.py``
``MXNetError`` and ``get_env``, kept as the port's own copies)."""
from __future__ import annotations

import os

__all__ = ["MXNetError", "get_env"]


class MXNetError(RuntimeError):
    """Error raised by the framework (name kept for API parity with the
    reference's python/mxnet/base.py:MXNetError)."""


def get_env(name, default, typ=None):
    """Typed env-var lookup — role of dmlc::GetEnv."""
    val = os.environ.get(name)
    if val is None:
        return default
    if typ is None:
        typ = type(default)
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    return typ(val)
