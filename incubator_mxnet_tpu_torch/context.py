"""Device resolution for the port's entry points.

Everything the port builds runs on the card unless the caller asks for
the CPU: ``None`` resolves to ``cuda:0`` and raises when no CUDA device
is present, so nothing silently falls back to the CPU.  ``"cpu"`` (or a
CPU ``torch.device``) is honoured only when passed explicitly — the CPU
tests do that, and on the CPU every kernel wrapper takes its plain
PyTorch version."""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` -> ``cuda:0``; a string or ``torch.device`` as given.
    Raises MXNetError for a CUDA device this process cannot see."""
    dev = torch.device("cuda", 0) if device is None \
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
