"""Weight transfer from the JAX package's parameter names to the port.

``params_from_numpy`` takes ``{jax_param_name: np.ndarray}`` — what
``TransformerDecoder.collect_params()`` of the JAX package gives, each
value turned into numpy by the caller — and returns the port's
``state_dict`` of ``gluon.decoder.TransformerDecoder``.  The port never
sees a JAX object.  The JAX names are structural
(``<prefix>pos``, ``<prefix>embedding0_weight``,
``<prefix>sequential0_decoderlayer<i>_<layer><n>_<param>``,
``<prefix>layernorm0_*``, ``<prefix>dense0_*``), so the mapping is by
position within that structure, whatever the model's prefix.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["params_from_numpy"]

# child blocks of a JAX DecoderLayer in creation order -> port names
_LAYER_CHILDREN = {"layernorm0": "ln1", "dense0": "qkv", "dense1": "proj",
                   "layernorm1": "ln2", "dense2": "fc1", "dense3": "fc2"}
_TOP = {"embedding0_weight": "embed.weight", "layernorm0_gamma":
        "ln_f.gamma", "layernorm0_beta": "ln_f.beta",
        "dense0_weight": "head.weight", "dense0_bias": "head.bias"}
_LAYER_RE = re.compile(r"sequential\d+_decoderlayer(\d+)_([a-z]+\d+)_"
                       r"(weight|bias|gamma|beta)$")


def params_from_numpy(named_arrays):
    """``{jax_param_name: np.ndarray}`` -> the port's ``state_dict``
    (CPU float tensors; ``load_state_dict`` moves them to the module's
    device).  Raises MXNetError on a name it cannot place."""
    pos = [n for n in named_arrays if n.endswith("pos")]
    if len(pos) != 1:
        raise MXNetError(f"expected one position table '<prefix>pos', "
                         f"found {pos}")
    prefix = pos[0][:-len("pos")]
    layers = sorted({int(m.group(1)) for n in named_arrays
                     if (m := _LAYER_RE.search(n))})
    index = {j: i for i, j in enumerate(layers)}   # JAX counter -> depth
    out = {}
    for name, arr in named_arrays.items():
        if not name.startswith(prefix):
            raise MXNetError(f"parameter {name!r} lacks the prefix "
                             f"{prefix!r}")
        rest = name[len(prefix):]
        m = _LAYER_RE.fullmatch(rest)
        if rest == "pos":
            key = "pos"
        elif m and m.group(2) in _LAYER_CHILDREN:
            key = (f"layers.{index[int(m.group(1))]}."
                   f"{_LAYER_CHILDREN[m.group(2)]}.{m.group(3)}")
        elif rest in _TOP:
            key = _TOP[rest]
        else:
            raise MXNetError(f"cannot place JAX parameter {name!r}")
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out
