"""Operators of the port: the op registry that the imperative front end
(``ndarray``) dispatches through, and the operators that hold
hand-written kernels.  Importing this package registers every op."""
from . import elemwise       # noqa: F401
from . import image_ops      # noqa: F401
from . import indexing       # noqa: F401
from . import linalg         # noqa: F401
from . import matrix         # noqa: F401
from . import nn             # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import random         # noqa: F401
from . import reduce         # noqa: F401
from . import rnn            # noqa: F401
from . import spatial        # noqa: F401
from . import contrib        # noqa: F401 (aliases matrix's khatri_rao)
from .fused_chain import (chain_emit, chain_stats, chain_supported,
                          fused_bottleneck_chain)
from .fused_conv import (bn_affine, bn_stats, fused_bn_relu_conv,
                         sbr_conv3x3, sbr_matmul, supported)
from .nn import fused_batch_norm_relu
from .registry import (Operator, alias_op, find_op, get_op, list_ops,
                       normalize_attrs, register_op)

__all__ = ["Operator", "alias_op", "bn_affine", "bn_stats", "chain_emit",
           "chain_stats", "chain_supported", "find_op",
           "fused_batch_norm_relu", "fused_bn_relu_conv",
           "fused_bottleneck_chain", "get_op", "list_ops", "normalize_attrs",
           "register_op", "sbr_conv3x3", "sbr_matmul", "supported"]
