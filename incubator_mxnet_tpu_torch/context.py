"""Device contexts and device resolution of the port.

Everything the port builds runs on the card unless the caller asks for
the CPU.  ``resolve_device(None)`` is ``cuda:0`` (once a process group
is up, the rank's own card) and raises when no CUDA device is present,
so nothing silently falls back to the CPU;
``"cpu"`` (or a CPU ``torch.device``) is honoured only when passed
explicitly — the CPU tests do that, and on the CPU every kernel wrapper
takes its plain PyTorch version.

``Context`` is the imperative front end's device (counterpart of
``incubator_mxnet_tpu/context.py``, reference python/mxnet/context.py):
``(device_type, device_id)``, usable as a ``with`` scope that sets the
default device for array creation.  Where it differs from the JAX
package: the default context is ``gpu(0)`` (the JAX stack starts at
``cpu(0)``), so without a GPU the first array created outside a
``with mx.cpu():`` scope raises ``MXNetError``; ``gpu(i)`` and
``tpu(i)`` both map to ``cuda:i`` (``tpu`` kept for source
compatibility) and an index out of range raises, with no fall-back to
host devices.  ``Context.torch_device()`` takes the place of
``jax_device()``.
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "tpu", "current_context",
           "num_devices", "num_gpus", "num_tpus", "rank_card",
           "resolve_device"]


def rank_card():
    """The card index of this process: 0, or once a ``torch.
    distributed`` process group is up, ``(LOCAL_RANK or DMLC_WORKER_ID)
    % device_count()``, so the ranks of one host take its cards in turn
    (two ranks on a one-card host share ``cuda:0``)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    rank = os.environ.get("LOCAL_RANK", os.environ.get("DMLC_WORKER_ID", 0))
    return int(rank) % max(torch.cuda.device_count(), 1)


def resolve_device(device=None):
    """``None`` -> ``cuda:0`` (in a process group, this rank's card:
    ``rank_card``); a string or ``torch.device`` as given.  Raises
    MXNetError for a CUDA device this process cannot see."""
    dev = torch.device("cuda", rank_card()) if device is None \
        else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested (the default when device=None) "
                "but no CUDA device is available; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise MXNetError(
                f"device cuda:{index} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev} (cuda or cpu)")
    return dev


class Context:
    """A device context: (device_type, device_id).  Validated lazily, at
    the first ``torch_device()``, as in the JAX package."""

    device_types = ("cpu", "gpu", "tpu", "cpu_pinned")
    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self.device_types:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def torch_device(self):
        """The ``torch.device`` of this context: ``cpu`` for cpu(i),
        ``cuda:i`` for gpu(i) and tpu(i), ``cpu`` for cpu_pinned(i) too.
        Raises MXNetError when that CUDA device does not exist."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"context {self} (gpu(0) is the default) needs a CUDA "
                "device and none is available; pass ctx=mx.cpu() or work "
                "under `with mx.cpu():` to run on the CPU")
        return resolve_device(torch.device("cuda", self.device_id))

    # -- default-context scope ---------------------------------------------
    def __enter__(self):
        _ctx_stack().append(self)
        return self

    def __exit__(self, *exc):
        _ctx_stack().pop()


def _ctx_stack():
    if not hasattr(Context._default, "stack"):
        Context._default.stack = [Context("gpu", 0)]
    return Context._default.stack


def current_context() -> Context:
    """The active default context (python/mxnet/context.py:
    current_context): ``gpu(0)`` outside any ``with`` scope."""
    return _ctx_stack()[-1]


def context_of(device):
    """The Context of a ``torch.device`` (cpu -> cpu(0), cuda:i ->
    gpu(i))."""
    device = torch.device(device)
    if device.type == "cpu":
        return Context("cpu", 0)
    return Context("gpu", 0 if device.index is None else device.index)


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """Host memory for transfers (the reference's page-locked context);
    its arrays live on the CPU, as ``cpu(i)``'s do."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Source-compatibility name: on the port it is the i-th CUDA card,
    as ``gpu(i)``."""
    return Context("tpu", device_id)


def num_gpus():
    """Count of CUDA devices this process sees; 0 without CUDA
    (reference context.py:num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus():
    """Count of the accelerator chips this process sees: on the port the
    CUDA cards, as ``num_gpus``."""
    return num_gpus()


def num_devices(platform=None):
    """Devices of ``platform``: ``"cpu"`` gives 1 (the host); otherwise
    the CUDA cards, or 1 (the host) when there are none, as the JAX
    package counts its host devices when it has no accelerator."""
    if platform == "cpu":
        return 1
    return num_gpus() or 1
