"""Gradient compression of the port (counterpart of
``incubator_mxnet_tpu/parallel/compression.py``): 2-bit quantization
with an error-feedback residual, and an fp8 variant.

Each element of ``residual + grad`` maps to {-threshold, 0, +threshold}
(codes 2, 0, 1), four codes packed into a byte with the first element
in the low bits (the JAX package's bit order); the quantization error
stays in the key's residual and is added to its next gradient.  The fp8
variant sends ``torch.float8_e4m3fn`` and keeps the cast's error as the
residual.  ``KVStoreDist``'s compressed push ships only this wire form.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype

__all__ = ["GradientCompression", "create"]

# float8_e4m3fn's largest finite value plus half its step: larger
# magnitudes round to NaN (the format has no infinity)
_FP8_LIMIT = 464.0


class GradientCompression:
    """Stateful per-key codec with error-feedback residuals.

    ``compress(key, grad)`` -> wire tensor (uint8 codes or fp8), updating
    the key's residual; ``decompress(wire, shape, dtype)`` -> the dense
    gradient."""

    def __init__(self, type="2bit", threshold=0.5):
        if type not in ("2bit", "fp8"):
            raise MXNetError(f"unknown compression type {type!r}")
        if threshold <= 0:
            raise MXNetError("threshold must be positive "
                             "(reference CHECK_GT in SetParams)")
        self.type = type
        self.threshold = float(threshold)
        self._residuals = {}

    def _levels(self, codes, dtype):
        t = self.threshold
        return torch.where(codes == 1, t, torch.where(codes == 2, -t, 0.0)
                           ).to(dtype)

    def compress(self, key, grad):
        """Quantize ``grad`` (a tensor) with error feedback; returns the
        wire tensor."""
        r = self._residuals.get(key)
        r = grad if r is None else r + grad
        if self.type == "fp8":
            # past the largest finite value's rounding range (448 and its
            # half step) the cast gives NaN, as XLA's does; torch's own
            # cast would saturate at 448
            wire = torch.where(r.abs() > _FP8_LIMIT, float("nan"), r).to(
                torch.float8_e4m3fn)
            self._residuals[key] = r - wire.to(r.dtype)
            return wire
        t = self.threshold
        codes = torch.where(r >= t, 1, torch.where(r <= -t, 2, 0)).to(
            torch.uint8)
        self._residuals[key] = r - self._levels(codes, r.dtype)
        flat = codes.reshape(-1)
        pad = (-flat.numel()) % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        quads = flat.view(-1, 4)
        return (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) |
                (quads[:, 3] << 6))

    def decompress(self, wire, shape, dtype=torch.float32):
        dtype = torch_dtype(dtype)
        if self.type == "fp8":
            return wire.to(dtype).reshape(shape)
        n = int(np.prod(shape))
        codes = torch.stack([(wire >> s) & 3 for s in (0, 2, 4, 6)], 1)
        return self._levels(codes.reshape(-1)[:n], dtype).reshape(shape)

    def roundtrip(self, key, grad):
        """compress + decompress: what the other ranks receive of
        ``grad``."""
        return self.decompress(self.compress(key, grad), grad.shape,
                               grad.dtype)


def create(params):
    """Build from a ``compression_params`` dict (``{'type': '2bit',
    'threshold': x}``, the reference's ``set_gradient_compression``
    argument); None or type ``'none'`` is no compression."""
    if params is None:
        return None
    if isinstance(params, GradientCompression):
        return params
    p = dict(params)
    ctype = p.pop("type", "2bit")
    if ctype in ("none", None):
        return None
    return GradientCompression(type=ctype, **p)
