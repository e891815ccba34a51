"""Activation layer of the port (counterpart of
``incubator_mxnet_tpu/gluon/nn/activations.py`` ``Activation`` and the
``Activation`` op).  Only ``act_type="relu"`` is ported yet; any other
raises at construction."""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError

__all__ = ["Activation"]


class Activation(nn.Module):
    """``act_type(x)`` elementwise; ``"relu"`` only so far."""

    def __init__(self, act_type):
        super().__init__()
        if act_type != "relu":
            raise MXNetError(f"Activation({act_type!r}) is not ported yet: "
                             "only 'relu'")
        self.act_type = act_type

    def forward(self, x):
        return torch.relu(x)
