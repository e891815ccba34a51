"""Foundation utilities of the PyTorch port: the framework error, the
default real type, the typed environment lookup and the name registries
(counterparts of ``incubator_mxnet_tpu/base.py`` ``MXNetError``,
``mx_real_t``, ``get_env`` and ``registry``, kept as the port's own
copies), and the numpy <-> torch dtype map of the imperative front
end."""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["MXNetError", "mx_real_t", "get_env", "registry",
           "torch_dtype", "numpy_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (name kept for API parity with the
    reference's python/mxnet/base.py:MXNetError)."""


mx_real_t = np.float32

_TORCH_OF = {"float32": torch.float32, "float64": torch.float64,
             "float16": torch.float16, "uint8": torch.uint8,
             "uint32": torch.uint32, "int8": torch.int8,
             "int16": torch.int16, "int32": torch.int32,
             "int64": torch.int64, "bool": torch.bool}
_NUMPY_OF = {v: np.dtype(k) for k, v in _TORCH_OF.items()}


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype, its name or a torch dtype
    (``"bfloat16"``, which numpy lacks, by its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    name = np.dtype(dtype).name
    if name not in _TORCH_OF:
        raise MXNetError(f"dtype {name} is not supported by the port")
    return _TORCH_OF[name]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype."""
    if dtype not in _NUMPY_OF:
        raise MXNetError(f"torch dtype {dtype} has no numpy counterpart "
                         "in the port")
    return _NUMPY_OF[dtype]


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


class _Registry:
    """Name -> object registry with aliases (the role of dmlc::Registry):
    one place where a subsystem (operators, optimizers, initializers,
    metrics) registers named entries.  Lookups fall back to a
    case-insensitive match."""

    def __init__(self, kind):
        self.kind = kind
        self._map = {}

    def register(self, name, obj=None, aliases=()):
        if obj is None:             # decorator form
            def _dec(o):
                self.register(name, o, aliases)
                return o
            return _dec
        if name in self._map and self._map[name] is not obj:
            raise ValueError(f"{self.kind} '{name}' already registered")
        self._map[name] = obj
        for a in aliases:
            self._map[a] = obj
        return obj

    def find(self, name):
        obj = self._map.get(name)
        if obj is None:
            low = name.lower()
            for k, v in self._map.items():
                if k.lower() == low:
                    return v
        return obj

    def get(self, name):
        obj = self.find(name)
        if obj is None:
            raise MXNetError(f"unknown {self.kind}: '{name}'. known: "
                             f"{sorted(set(self._map))[:50]}")
        return obj

    def names(self):
        return sorted(self._map)


_registries = {}


def registry(kind) -> _Registry:
    """Get-or-create the registry for ``kind`` (e.g. 'op')."""
    if kind not in _registries:
        _registries[kind] = _Registry(kind)
    return _registries[kind]
