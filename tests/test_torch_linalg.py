"""The port's linalg ops (``ops/linalg.py``, ``mx.nd.linalg``,
``mx.sym.linalg``) held to the JAX package's on the CPU, forward and
gradient, on batched (2, n, n) inputs drawn from a fixed seed: SPD
matrices for ``potrf``, their Cholesky factors for ``potri`` /
``sumlogdiag``, well-conditioned triangles for ``trsm``.

Tolerances: 1e-5 of the reference's max for outputs and gradients
(LAPACK and BLAS in other orders), 1e-4 for ``potri``'s gradient (two
triangular solves).  ``syevd``'s eigenvectors are each defined up to
sign, so its rows are compared after fixing the sign of each row's
largest entry, and its gradient through ``sum(w * head)`` only.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

RS = np.random.RandomState(0)
N = 4
A = RS.randn(2, N, N).astype(np.float32)
B = RS.randn(2, N, N).astype(np.float32)
C = RS.randn(2, N, N).astype(np.float32)
SPD = (A @ A.transpose(0, 2, 1) + N * np.eye(N)).astype(np.float32)
CHOL = np.linalg.cholesky(SPD.astype(np.float64)).astype(np.float32)
TRI = (np.tril(A) + 3 * np.eye(N)).astype(np.float32)
WIDE = RS.randn(2, 3, 5).astype(np.float32)


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert got.shape == want.shape, what
    assert err <= tol, f"{what}: {err:.3g} of max > {tol}"


def _run(m, name, arrays, attrs, out_idx):
    xs = [m.nd.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with m.autograd.record():
        out = getattr(m.nd.linalg, name)(*xs, **attrs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        o = outs[out_idx]
        head = np.random.RandomState(1).randn(*o.shape).astype(np.float32)
        loss = (o * m.nd.array(head)).sum()
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def both(name, arrays, attrs=None, out_idx=0):
    attrs = attrs or {}
    want = _run(jmx, name, arrays, attrs, out_idx)
    with tmx.cpu():
        got = _run(tmx, name, arrays, attrs, out_idx)
    return got, want


CASES = [
    ("gemm", [A, B, C], dict(alpha=0.5, beta=2.0)),
    ("gemm", [A, B, C], dict(transpose_a=True, transpose_b=True)),
    ("gemm2", [A, B], dict(alpha=1.5)),
    ("gemm2", [A, WIDE], dict(transpose_a=True)),
    ("potrf", [SPD], {}),
    ("trmm", [TRI, B], dict(alpha=2.0)),
    ("trmm", [TRI, B], dict(transpose=True, rightside=True)),
    ("trsm", [TRI, B], dict(alpha=0.5)),
    ("trsm", [TRI, B], dict(transpose=True)),
    ("trsm", [TRI, B], dict(rightside=True)),
    ("trsm", [TRI, B], dict(rightside=True, transpose=True, alpha=3.0)),
    ("trsm", [TRI.transpose(0, 2, 1).copy(), B], dict(lower=False)),
    ("sumlogdiag", [CHOL], {}),
    ("syrk", [WIDE], dict(alpha=0.7)),
    ("syrk", [WIDE], dict(transpose=True)),
]


@pytest.mark.parametrize("name,arrays,attrs", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_linalg_op_and_gradients(name, arrays, attrs):
    if name == "gemm2" and attrs.get("transpose_a"):
        arrays = [arrays[0][:, :3, :], arrays[1]]
    (got, gg), (want, wg) = both(name, arrays, attrs)
    _close(got[0], want[0], 1e-5, name)
    for i, (g, w) in enumerate(zip(gg, wg)):
        _close(g, w, 1e-5, f"{name} grad {i}")


def test_potri_and_gradient():
    (got, gg), (want, wg) = both("potri", [CHOL])
    _close(got[0], want[0], 1e-5, "potri")
    _close(gg[0], wg[0], 1e-4, "potri grad")
    np.testing.assert_allclose(got[0], np.linalg.inv(SPD), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("out_idx", [0, 1])
def test_gelqf_and_gradient(out_idx):
    (got, gg), (want, wg) = both("gelqf", [WIDE], out_idx=out_idx)
    q, l = got
    _close(q, want[0], 1e-5, "Q")
    _close(l, want[1], 1e-5, "L")
    _close(l @ q, WIDE, 1e-5, "L Q = A")
    _close(gg[0], wg[0], 1e-4, "gelqf grad")


def _fix_signs(u):
    idx = np.abs(u).argmax(-1)
    sign = np.sign(np.take_along_axis(u, idx[..., None], -1))
    return u * sign


def test_syevd_and_gradient():
    (got, gg), (want, wg) = both("syevd", [SPD], out_idx=1)
    u, w = got
    _close(w, want[1], 1e-5, "eigenvalues")
    _close(_fix_signs(u), _fix_signs(want[0]), 1e-4, "eigenvectors")
    recon = np.einsum("bki,bk,bkj->bij", u, w, u)
    _close(recon, SPD, 1e-5, "U^T diag(w) U = A")
    _close(gg[0], wg[0], 1e-4, "syevd grad")


def test_linalg_namespaces():
    names = ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
             "syevd", "gelqf", "sumlogdiag")
    for n in names:
        assert callable(getattr(tmx.nd.linalg, n)), n
        assert callable(getattr(tmx.sym.linalg, n)), n
        assert tmx.ops.find_op("_linalg_" + n) is tmx.ops.find_op(
            "linalg_" + n)
    with pytest.raises(AttributeError):
        tmx.nd.linalg.nope


def test_sym_linalg_binds_and_runs():
    a, b = tmx.sym.Variable("a"), tmx.sym.Variable("b")
    out = tmx.sym.linalg.gemm2(a, b, transpose_b=True, alpha=2.0)
    with tmx.cpu():
        ex = out.bind(tmx.cpu(), {"a": tmx.nd.array(A[0]),
                                  "b": tmx.nd.array(B[0])})
        res = ex.forward()[0].asnumpy()
    _close(res, 2.0 * A[0] @ B[0].T, 1e-6, "sym gemm2")
