"""The port's ``mx.random`` / ``mx.nd.random``: one ``torch.Generator``
per device, seeded by ``mx.random.seed``.  Its bits differ from the JAX
package's keys, so the two are compared by distribution: moments and
ranges of 200000 draws each, to a stated sampling tolerance.  Within
the port, the same seed gives the same numbers."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import random as trandom

N = 200_000
# two independent sample means differ by at most 6 standard errors of
# their difference, sqrt(2 var / N) (a false alarm about once in 5e8)
Z = 6.0


@pytest.fixture(autouse=True)
def _reset_seed():
    yield
    tmx.random.seed(0)


def _draws(mx, kind, seed, **kw):
    mx.random.seed(seed)
    fn = getattr(mx.nd.random, kind)
    if mx is tmx:
        with tmx.cpu():
            return fn(**kw).asnumpy()
    return fn(**kw).asnumpy()


@pytest.mark.parametrize("kind, kw", [
    ("uniform", dict(low=-1.0, high=3.0, shape=(50, 7))),
    ("normal", dict(loc=2.0, scale=0.5, shape=(1000,))),
    ("randint", dict(low=-3, high=7, shape=(4, 5))),
], ids=["uniform", "normal", "randint"])
def test_same_seed_same_numbers_other_seed_other_numbers(kind, kw):
    a = _draws(tmx, kind, 42, **kw)
    b = _draws(tmx, kind, 42, **kw)
    c = _draws(tmx, kind, 43, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == kw["shape"]


def test_draws_advance_and_per_device_seed():
    with tmx.cpu():
        tmx.random.seed(5)
        first = tmx.random.uniform(shape=(8,)).asnumpy()
        second = tmx.random.uniform(shape=(8,)).asnumpy()
        assert not np.array_equal(first, second)
        tmx.random.seed(5, ctx=tmx.cpu())
        np.testing.assert_array_equal(
            tmx.random.uniform(shape=(8,)).asnumpy(), first)
        np.testing.assert_array_equal(
            tmx.nd.random.uniform(shape=(8,), ctx=tmx.cpu()).asnumpy(),
            second)
        r = tmx.random.randn(3, 4, loc=1.0)
        assert r.shape == (3, 4) and r.dtype == np.float32
    assert trandom.generator("cpu") is trandom.generator("cpu")


@pytest.mark.parametrize("kind, kw, mean, var", [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16.0 / 12.0),
    ("normal", dict(loc=2.0, scale=3.0), 2.0, 9.0),
    ("randint", dict(low=-3, high=7), 1.5, (10 ** 2 - 1) / 12.0),
], ids=["uniform", "normal", "randint"])
def test_moments_and_ranges_match_jax(kind, kw, mean, var):
    got = _draws(tmx, kind, 1, shape=(N,), **kw)
    want = _draws(jmx, kind, 1, shape=(N,), **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    se = np.sqrt(2 * var / N)
    assert abs(got.mean() - want.mean()) < Z * se
    assert abs(got.mean() - mean) < Z * np.sqrt(var / N)
    # the variance's standard error is about sqrt(2/N) var (normal) or
    # less (uniform and discrete): 6 of those
    assert abs(got.var() - want.var()) < Z * np.sqrt(2 * 2.0 / N) * var
    if kind == "uniform":
        assert got.min() >= kw["low"] and got.max() < kw["high"]
        assert want.min() >= kw["low"] and want.max() < kw["high"]
    if kind == "randint":
        assert set(np.unique(got)) == set(range(kw["low"], kw["high"]))
        assert set(np.unique(want)) == set(range(kw["low"], kw["high"]))
