"""Linear-algebra operators of the port (counterpart of
``incubator_mxnet_tpu/ops/linalg.py``; reference
src/operator/tensor/la_op.cc): ``gemm``, ``gemm2``, ``potrf``,
``potri``, ``trmm``, ``trsm``, ``sumlogdiag``, ``syrk``, ``gelqf`` and
``syevd``, each under its ``_linalg_`` and ``linalg_`` names, on the
trailing two axes with any batch in front.  Plain ``torch.matmul`` and
``torch.linalg`` (cuBLAS / cuSOLVER on the card), with torch autograd's
gradients; the JAX ops compute the same outside any Pallas kernel.

As in the JAX package, ``trmm`` multiplies by the whole of A (its
``lower`` is not applied), and ``trsm`` reads only the triangle that
``lower`` and ``transpose`` name.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = []


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


@register_op("_linalg_gemm", aliases=("linalg_gemm",))
def _gemm(A, B, C, *, transpose_a=False, transpose_b=False, alpha=1.0,
          beta=1.0, axis=-2):
    """alpha * op(A) op(B) + beta * C."""
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register_op("_linalg_gemm2", aliases=("linalg_gemm2",))
def _gemm2(A, B, *, transpose_a=False, transpose_b=False, alpha=1.0,
           axis=-2):
    """alpha * op(A) op(B)."""
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register_op("_linalg_potrf", aliases=("linalg_potrf",))
def _potrf(A):
    """The lower Cholesky factor L of A = L L^T."""
    return torch.linalg.cholesky(A)


@register_op("_linalg_potri", aliases=("linalg_potri",))
def _potri(A):
    """inv(L L^T) from the Cholesky factor L: inv(L)^T inv(L)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    inv_l = torch.linalg.solve_triangular(A, eye.expand(A.shape),
                                          upper=False)
    return torch.matmul(inv_l.transpose(-1, -2), inv_l)


@register_op("_linalg_trmm", aliases=("linalg_trmm",))
def _trmm(A, B, *, transpose=False, rightside=False, lower=True, alpha=1.0):
    """alpha * op(A) B, or alpha * B op(A) with ``rightside``."""
    a = _t(A, transpose)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register_op("_linalg_trsm", aliases=("linalg_trsm",))
def _trsm(A, B, *, transpose=False, rightside=False, lower=True, alpha=1.0):
    """X with op(A) X = alpha B, or X op(A) = alpha B with
    ``rightside``; op(A) is lower triangular when exactly one of
    ``lower`` and not ``transpose`` holds."""
    op_lower = lower != transpose
    return torch.linalg.solve_triangular(_t(A, transpose), alpha * B,
                                         upper=not op_lower,
                                         left=not rightside)


@register_op("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def _sumlogdiag(A):
    """The sum of the logs of A's diagonal."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register_op("_linalg_syrk", aliases=("linalg_syrk",))
def _syrk(A, *, transpose=False, alpha=1.0):
    """alpha * op(A) op(A)^T."""
    a = _t(A, transpose)
    return alpha * torch.matmul(a, a.transpose(-1, -2))


@register_op("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def _gelqf(A):
    """LQ decomposition A = L Q through the QR of A^T; returns (Q, L), the
    reference's order (la_op.cc: "Q, L = gelqf(A)")."""
    q, r = torch.linalg.qr(A.transpose(-1, -2))
    return q.transpose(-1, -2), r.transpose(-1, -2)


@register_op("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def _syevd(A):
    """Eigen-decomposition of a symmetric A: (U, w) with the
    eigenvectors as U's rows, eigenvalues ascending."""
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w
