"""The port's last indexing, random and legacy nn ops held to the JAX
package's on the CPU: ``gather_nd`` / ``scatter_nd`` /
``_scatter_nd_add`` / ``_backward_gather_nd``, ``batch_take``,
``where_index``, the ``choose/fill_element_0index`` pairs, the samplers
of ``ops/random.py`` (gamma, exponential, poisson, the negative
binomials, multinomial with ``get_prob``, shuffle and the per-parameter
``_sample_*`` family), ``IdentityAttachKLSparseReg`` and
``CrossDeviceCopy``; and the registries, which now hold the same 388
names.

Tolerances: gathers, scatters and the legacy indexing ops exactly
(they move values); gradients of the scatters that add, and the KL
gradient, 1e-6 of the reference's max.  The random bits differ from
JAX's, so a sampler is held to its distribution: the mean and the
variance of 200,000 draws within 5 standard errors of the exact ones
(and of the JAX op's own draws, which checks the parameter mapping), a
scipy Kolmogorov-Smirnov test at p > 1e-4 for the continuous ones, the
shapes and dtypes of the JAX op, and the same draws under the same
seed.
"""
import numpy as np
import pytest
import scipy.stats

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

N = 200_000


def _arr(m, a):
    return m.nd.array(a, dtype=a.dtype)


def _run(m, name, arrays, attrs, grad_idx=(), head_seed=3):
    """``m.nd.<name>(*arrays, **attrs)``; with ``grad_idx`` the gradient
    of ``sum(out * head)`` for those inputs.  Numpy results."""
    xs = [_arr(m, a) for a in arrays]
    for i in grad_idx:
        xs[i].attach_grad()
    with m.autograd.record():
        out = getattr(m.nd, name)(*xs, **attrs)
        head = np.random.RandomState(head_seed).randn(
            *out.shape).astype(np.float32)
        loss = (out * m.nd.array(head)).sum()
    if grad_idx:
        loss.backward()
    return out.asnumpy(), [xs[i].grad.asnumpy() for i in grad_idx]


def both(name, arrays, attrs=None, grad_idx=()):
    attrs = attrs or {}
    want = _run(jmx, name, arrays, attrs, grad_idx)
    with tmx.cpu():
        got = _run(tmx, name, arrays, attrs, grad_idx)
    return got, want


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


# ------------------------------------------------------------- registries
def test_registries_hold_the_same_388_names():
    names = set(tmx.ops.list_ops())
    assert names == set(jmx.ops.registry.list_ops())
    assert len(names) == 388


# ---------------------------------------------------------------- N-d index
def _nd_index(seed):
    """A (2, 3, 4) index into a (5, 6, 7) array, with a negative index and
    ones out of range on both sides (JAX clamps a gather's)."""
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.randint(0, 5, (3, 4)), rs.randint(0, 6, (3, 4))])
    idx[0, 0, 0], idx[1, 0, 1] = -1, -6
    idx[0, 1, 2], idx[1, 2, 3] = 9, -20
    return idx.astype(np.float32)


def test_gather_nd_forward_and_gradient():
    data = np.random.RandomState(0).randn(5, 6, 7).astype(np.float32)
    (got, gg), (want, wg) = both("gather_nd", [data, _nd_index(1)],
                                 grad_idx=(0,))
    np.testing.assert_array_equal(got, want)
    _close(gg[0], wg[0], 1e-6, "gather_nd grad")


@pytest.mark.parametrize("name", ["_scatter_nd_add", "_backward_gather_nd"])
def test_scatter_nd_add_forward_and_gradient(name):
    rs = np.random.RandomState(2)
    idx = _nd_index(3)
    idx[:, 1, 1] = idx[:, 0, 3]          # repeated targets sum
    data = rs.randn(3, 4, 7).astype(np.float32)
    (got, gg), (want, wg) = both(name, [data, idx], {"shape": (5, 6, 7)},
                                 grad_idx=(0,))
    _close(got, want, 1e-6, name)
    np.testing.assert_array_equal(gg[0], wg[0])


def test_scatter_nd_keeps_the_last_of_repeated_indices():
    """``.at[].set`` on the JAX package's CPU backend keeps the last value
    written to an offset; the port does so on any device, and the earlier
    duplicates get no gradient.  Out-of-range targets are dropped."""
    idx = np.array([[1, 3, 1, 1, -1, 7, -9],
                    [0, 2, 0, 0, 2, 0, 0]], np.float32)
    data = np.arange(1, 8, dtype=np.float32)
    (got, gg), (want, wg) = both("scatter_nd", [data, idx],
                                 {"shape": (4, 3)}, grad_idx=(0,))
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] == 4.0 and got[3, 2] == 5.0 and got.sum() == 4 + 5
    np.testing.assert_array_equal(gg[0], wg[0])
    head = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    np.testing.assert_array_equal(gg[0], [0, 0, 0, head[1, 0], head[3, 2],
                                          0, 0])


def test_scatter_nd_random_forward_and_gradient():
    rs = np.random.RandomState(4)
    idx = _nd_index(5)
    data = rs.randn(3, 4, 7).astype(np.float32)
    (got, gg), (want, wg) = both("scatter_nd", [data, idx],
                                 {"shape": (5, 6, 7)}, grad_idx=(0,))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gg[0], wg[0])


@pytest.mark.parametrize("name", ["batch_take", "choose_element_0index",
                                  "_choose_element_0index"])
def test_batch_take_forward_and_gradient(name):
    rs = np.random.RandomState(6)
    a = rs.randn(6, 5).astype(np.float32)
    idx = np.array([0, 4, -1, 7, 2, -8], np.float32)
    (got, gg), (want, wg) = both(name, [a, idx], grad_idx=(0,))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gg[0], wg[0])


@pytest.mark.parametrize("name", ["fill_element_0index",
                                  "_fill_element_0index"])
def test_fill_element_0index_forward_and_gradient(name):
    rs = np.random.RandomState(7)
    lhs = rs.randn(5, 4).astype(np.float32)
    mhs = rs.randn(5).astype(np.float32)
    rhs = np.array([0, 3, -1, 9, 1], np.float32)
    (got, gg), (want, wg) = both(name, [lhs, mhs, rhs], grad_idx=(0, 1))
    np.testing.assert_array_equal(got, want)
    for a, b in zip(gg, wg):
        np.testing.assert_array_equal(a, b)


def test_where_index():
    x = np.random.RandomState(8).randn(4, 5, 3).astype(np.float32)
    x[x < 0.3] = 0
    want = jmx.nd.where_index(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        got = tmx.nd.where_index(tmx.nd.array(x))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.asnumpy(), want)


# ----------------------------------------------------------------- legacy nn
def test_identity_attach_kl_sparse_reg():
    x = np.random.RandomState(9).rand(16, 6).astype(np.float32) * 0.4
    x[:, 2] = 0.0                          # a mean below the clip
    attrs = dict(sparseness_target=0.05, penalty=0.01, momentum=0.5)
    (got, gg), (want, wg) = both("IdentityAttachKLSparseReg", [x], attrs,
                                 grad_idx=(0,))
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, want)
    _close(gg[0], wg[0], 1e-6, "KL gradient")


@pytest.mark.parametrize("name", ["CrossDeviceCopy", "_CrossDeviceCopy"])
def test_cross_device_copy_is_the_identity(name):
    x = np.random.RandomState(10).randn(3, 4).astype(np.float32)
    (got, gg), (want, wg) = both(name, [x], grad_idx=(0,))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gg[0], wg[0])


# ------------------------------------------------------------------ samplers
def _draw(m, name, seed, inputs=(), **attrs):
    m.random.seed(seed)
    arrays = [_arr(m, a) for a in inputs]
    out = getattr(m.nd, name)(*arrays, **attrs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in outs]


def _port(name, seed, inputs=(), **attrs):
    with tmx.cpu():
        return _draw(tmx, name, seed, inputs, **attrs)


def _moments_ok(x, mean, var, what):
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    se_mean = np.sqrt(var / n)
    # the variance of the sample variance: (m4 - var^2) / n
    m4 = ((x - x.mean()) ** 4).mean()
    se_var = np.sqrt(max(m4 - var ** 2, 1e-30) / n)
    assert abs(x.mean() - mean) < 5 * se_mean, (what, x.mean(), mean)
    assert abs(x.var() - var) < 5 * se_var, (what, x.var(), var)


# name, attrs, exact (mean, var), scipy distribution for the KS test
_K, _P = 3, 0.4
_MU, _ALPHA = 2.0, 0.5
_SCALARS = [
    ("_random_gamma", dict(alpha=2.5, beta=0.7), (1.75, 2.5 * 0.49),
     scipy.stats.gamma(2.5, scale=0.7)),
    ("random_gamma", dict(alpha=0.6, beta=2.0), (1.2, 2.4),
     scipy.stats.gamma(0.6, scale=2.0)),
    ("_random_exponential", dict(lam=4.0), (0.25, 1 / 16),
     scipy.stats.expon(scale=0.25)),
    ("random_exponential", dict(lam=0.5), (2.0, 4.0),
     scipy.stats.expon(scale=2.0)),
    ("_random_poisson", dict(lam=3.5), (3.5, 3.5), None),
    ("random_poisson", dict(lam=0.3), (0.3, 0.3), None),
    ("_random_negative_binomial", dict(k=_K, p=_P),
     (_K * (1 - _P) / _P, _K * (1 - _P) / _P ** 2), None),
    ("random_negative_binomial", dict(k=1, p=0.8), (0.25, 0.25 / 0.8),
     None),
    ("_random_generalized_negative_binomial", dict(mu=_MU, alpha=_ALPHA),
     (_MU, _MU + _ALPHA * _MU ** 2), None),
    ("random_generalized_negative_binomial", dict(mu=0.5, alpha=2.0),
     (0.5, 0.5 + 2.0 * 0.25), None),
]


@pytest.mark.parametrize("name,attrs,moments,dist", _SCALARS,
                         ids=[s[0] for s in _SCALARS])
def test_scalar_sampler(name, attrs, moments, dist):
    got = _port(name, 5, shape=(N,), **attrs)[0]
    want = _draw(jmx, name, 5, shape=(N,), **attrs)[0]
    assert got.shape == want.shape == (N,) and got.dtype == want.dtype
    _moments_ok(got, *moments, what=name)
    _moments_ok(want, *moments, what="jax " + name)
    if dist is not None:
        assert scipy.stats.kstest(got, dist.cdf).pvalue > 1e-4
    else:
        assert (got == np.round(got)).all() and got.min() >= 0
    np.testing.assert_array_equal(_port(name, 5, shape=(N,), **attrs)[0],
                                  got)
    assert not np.array_equal(_port(name, 6, shape=(N,), **attrs)[0], got)


def test_scalar_sampler_shapes_and_dtypes():
    for name, attrs, _, _ in _SCALARS[::2]:
        got = _port(name, 1, shape=(2, 3), dtype="float16", **attrs)[0]
        want = _draw(jmx, name, 1, shape=(2, 3), dtype="float16", **attrs)[0]
        assert got.shape == want.shape and got.dtype == want.dtype, name


_PARAMS = np.array([[0.5, 1.5, 3.0], [2.0, 0.7, 1.2]], np.float32)
_PER_PARAM = [
    ("_sample_uniform", [_PARAMS, _PARAMS + 1.0],
     lambda a, b: ((a + b) / 2, 1.0 / 12), "uniform"),
    ("_sample_normal", [_PARAMS, _PARAMS[::-1].copy()],
     lambda mu, sd: (mu, sd ** 2), "norm"),
    ("_sample_gamma", [_PARAMS, _PARAMS[::-1].copy()],
     lambda a, b: (a * b, a * b * b), "gamma"),
    ("_sample_exponential", [_PARAMS],
     lambda lam: (1 / lam, 1 / lam ** 2), "expon"),
    ("_sample_poisson", [_PARAMS], lambda lam: (lam, lam), None),
]


@pytest.mark.parametrize("name,params,moments,kind", _PER_PARAM,
                         ids=[p[0] for p in _PER_PARAM])
def test_per_parameter_sampler(name, params, moments, kind):
    """One set of draws per parameter entry: out shape ``param.shape +
    shape``, each slice with its own entry's distribution."""
    n = 40_000
    got = _port(name, 7, params, shape=(n,))[0]
    want = _draw(jmx, name, 7, params, shape=(n,))[0]
    assert got.shape == want.shape == _PARAMS.shape + (n,)
    assert got.dtype == want.dtype
    for i in np.ndindex(_PARAMS.shape):
        p = [q[i] for q in params]
        mean, var = moments(*[float(v) for v in p])
        _moments_ok(got[i], mean, var, (name, i))
        if kind == "uniform":
            dist = scipy.stats.uniform(p[0], p[1] - p[0])
        elif kind == "norm":
            dist = scipy.stats.norm(p[0], p[1])
        elif kind == "gamma":
            dist = scipy.stats.gamma(p[0], scale=p[1])
        elif kind == "expon":
            dist = scipy.stats.expon(scale=1 / p[0])
        else:
            continue
        assert scipy.stats.kstest(got[i], dist.cdf).pvalue > 1e-4, (name, i)
    np.testing.assert_array_equal(_port(name, 7, params, shape=(n,))[0], got)


@pytest.mark.parametrize("name", ["_sample_multinomial",
                                  "sample_multinomial"])
def test_sample_multinomial(name):
    """Frequencies within 5 standard errors of the (unnormalised)
    probabilities, a zero-probability class never drawn, ``get_prob`` the
    log-probability of the port's own draws, and the JAX op's shapes
    for 1-D and 2-D data."""
    probs = np.array([[0.2, 0.0, 0.5, 0.3], [1.0, 2.0, 3.0, 4.0]],
                     np.float32)
    n = 50_000
    draws, logp = _port(name, 3, [probs], shape=(n,), get_prob=True)
    jd, jl = _draw(jmx, name, 3, [probs], shape=(n,), get_prob=True)
    assert draws.shape == jd.shape == (2, n) and draws.dtype == jd.dtype
    assert logp.shape == jl.shape and logp.dtype == jl.dtype
    for row in range(2):
        p = probs[row] / probs[row].sum()
        freq = np.bincount(draws[row], minlength=4) / n
        assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n)).all()
        np.testing.assert_allclose(logp[row], np.log(p[draws[row]]),
                                   rtol=1e-6)
    assert (draws[0] != 1).all()
    for shape in [(), (3, 2)]:
        got = _port(name, 4, [probs[1]], shape=shape)[0]
        want = _draw(jmx, name, 4, [probs[1]], shape=shape)[0]
        assert got.shape == want.shape and got.dtype == want.dtype
    got = _port(name, 4, [probs], dtype="float32")[0]
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_array_equal(
        _port(name, 3, [probs], shape=(n,), get_prob=True)[0], draws)


@pytest.mark.parametrize("name", ["_shuffle", "shuffle"])
def test_shuffle_permutes_axis_0(name):
    x = np.arange(200, dtype=np.float32).reshape(50, 4)
    got = _port(name, 2, [x])[0]
    assert got.shape == x.shape
    assert not np.array_equal(got, x)
    np.testing.assert_array_equal(np.sort(got[:, 0]), x[:, 0])
    np.testing.assert_array_equal(got - got[:, :1], x - x[:, :1])
    np.testing.assert_array_equal(_port(name, 2, [x])[0], got)


def test_random_namespaces_match_jax():
    assert tmx.nd.random.__all__ == jmx.nd.random.__all__
    assert tmx.sym.random.__all__ == jmx.sym.random.__all__
    with tmx.cpu():
        tmx.random.seed(3)
        g = tmx.nd.random.gamma(alpha=2.0, shape=(1000,))
        p = tmx.nd.random.multinomial(tmx.nd.array([[0.5, 0.5]]),
                                      shape=(4,))
        s = tmx.sym.random.poisson(lam=2.0, shape=(5000,))
        vals = s.simple_bind(tmx.cpu()).forward()[0].asnumpy()
    assert g.shape == (1000,) and (g.asnumpy() > 0).all()
    assert p.shape == (1, 4)
    assert vals.shape == (5000,) and abs(vals.mean() - 2.0) < 0.1
