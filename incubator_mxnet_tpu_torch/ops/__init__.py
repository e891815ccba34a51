"""Operators of the port that hold hand-written kernels."""
from .fused_chain import (chain_emit, chain_stats, chain_supported,
                          fused_bottleneck_chain)
from .fused_conv import (bn_affine, bn_stats, fused_bn_relu_conv,
                         sbr_conv3x3, sbr_matmul, supported)

__all__ = ["bn_affine", "bn_stats", "chain_emit", "chain_stats",
           "chain_supported", "fused_bn_relu_conv", "fused_bottleneck_chain",
           "sbr_conv3x3", "sbr_matmul", "supported"]
