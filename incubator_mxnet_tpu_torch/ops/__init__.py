"""Operators of the port that hold hand-written kernels."""
from .fused_conv import (bn_affine, fused_bn_relu_conv, sbr_conv3x3,
                         sbr_matmul, supported)

__all__ = ["bn_affine", "fused_bn_relu_conv", "sbr_conv3x3", "sbr_matmul",
           "supported"]
