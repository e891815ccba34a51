"""Random state and the ``mx.random`` API (counterpart of
``incubator_mxnet_tpu/random.py``; reference python/mxnet/random.py
over per-device generators, src/common/random_generator.h).

One explicit ``torch.Generator`` per device, made at first use from the
current seed; ``seed(s)`` reseeds them all (``ctx="all"``) or the one
of ``ctx``.  Sampling ops get their device's generator from
``ndarray.invoke``.  The bits differ from the JAX package's keys;
within the port the same seed gives the same numbers.

``named_sample`` (the initializers' draws) makes the JAX package's
draw for the current seed and the parameter's name, Threefry-2x32 in
numpy (the JAX package folds the name's CRC-32 into its key): a
parameter's initial values do not depend on the order in which
parameters are created, and they equal the JAX package's.
"""
from __future__ import annotations

import binascii
import contextlib
import threading

import torch

from .context import Context

__all__ = ["seed", "generator", "named_sample", "uniform", "normal", "randn",
           "randint", "poisson", "exponential", "gamma", "negative_binomial",
           "generalized_negative_binomial", "multinomial", "shuffle"]

_DEFAULT_SEED = 0
_lock = threading.Lock()
_seed = [_DEFAULT_SEED]
_generators = {}


def _device(device):
    """``device`` with its index made explicit (cuda -> cuda:<current>)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def generator(device):
    """The generator of ``device`` (a ``torch.device``), made at first
    use from the current seed."""
    device = _device(device)
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed[0])
            _generators[device] = gen
        return gen


def seed(seed_state, ctx="all"):
    """Seed the generators (python/mxnet/random.py:seed): every device's
    with ``ctx="all"``, else only the generator of context ``ctx``."""
    s = int(seed_state)
    if isinstance(ctx, str) and ctx == "all":
        with _lock:
            _seed[0] = s
            for gen in _generators.values():
                gen.manual_seed(s)
        return
    generator(Context(ctx).torch_device()).manual_seed(s)


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of the counters
    ``(x0, x1)`` under the key ``(k0, k1)``: the bits behind the JAX
    package's ``jax.random`` (its default ``threefry2x32``).  The words
    are held in int64 tensors (torch has no uint32 arithmetic), masked
    to 32 bits after each sum."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def _jax_key(seed_state, data):
    """``fold_in(PRNGKey(seed_state), data)`` of the JAX package, as two
    32-bit words."""
    s = int(seed_state) & 0xFFFFFFFFFFFFFFFF
    y0, y1 = _threefry2x32(s >> 32, s & _M32, torch.zeros(1, dtype=torch.int64),
                           torch.tensor([data], dtype=torch.int64))
    return int(y0), int(y1)


_sample_device = threading.local()


@contextlib.contextmanager
def sampling_on(device):
    """Make ``named_sample``'s bits on ``device`` when its caller gives
    none (``gluon.Parameter`` draws a host array for a card: the bits of
    a large table are made where it will live)."""
    old = getattr(_sample_device, "device", None)
    _sample_device.device = device
    try:
        yield
    finally:
        _sample_device.device = old


def named_sample(name, kind, shape=(), device=None, **kw):
    """A float32 tensor of ``shape`` on ``device`` (the CPU by default)
    for parameter ``name``: ``kind="uniform"`` on ``[low, high)``,
    ``"normal"`` with ``loc`` and ``scale``.  The draw is the JAX
    package's for the same seed and name: its key folds the name's
    CRC-32 into ``PRNGKey(seed)``, and the bits are Threefry's (counters:
    the flat index), so the port's initial weights equal the JAX
    package's (uniform ones to an ulp, normal ones through ``erfinv``
    to a few).  The bits are made on ``device``: a large table is drawn
    on the card where it lives."""
    key = _jax_key(_seed[0], binascii.crc32(str(name).encode()) & 0x7FFFFFFF)
    shape = tuple(int(d) for d in shape)
    if device is None:
        device = getattr(_sample_device, "device", None)
    n = 1
    for d in shape:
        n *= d
    counts = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    del counts, y0, y1, bits

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=u.device)

    if kind == "uniform":
        lo, hi = f32(kw.get("low", 0.0)), f32(kw.get("high", 1.0))
        out = torch.maximum(lo, u * (hi - lo) + lo)
    elif kind == "normal":
        lo = torch.nextafter(f32(-1.0), f32(1.0))
        v = torch.maximum(lo, u * (f32(1.0) - lo) + lo)
        z = torch.special.erfinv(v) * f32(2.0).sqrt()
        out = f32(kw.get("scale", 1.0)) * z + f32(kw.get("loc", 0.0))
    else:
        raise ValueError(f"unknown sample kind {kind}")
    return out.reshape(shape)


def _sample(opname, ctx, **kwargs):
    from .ndarray import op as ndop
    return getattr(ndop, opname)(ctx=ctx, **kwargs)


def uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
            out=None):
    return _sample("_random_uniform", ctx, low=low, high=high, shape=shape,
                   dtype=dtype, out=out)


def normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
           out=None):
    return _sample("_random_normal", ctx, loc=loc, scale=scale, shape=shape,
                   dtype=dtype, out=out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape, dtype, ctx)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    return _sample("_random_randint", ctx, low=low, high=high, shape=shape,
                   dtype=dtype, out=out)


def poisson(lam=1.0, shape=(), dtype="float32", ctx=None, out=None):
    return _sample("_random_poisson", ctx, lam=lam, shape=shape,
                   dtype=dtype, out=out)


def exponential(scale=1.0, shape=(), dtype="float32", ctx=None, out=None):
    return _sample("_random_exponential", ctx, lam=1.0 / scale, shape=shape,
                   dtype=dtype, out=out)


def gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
          out=None):
    return _sample("_random_gamma", ctx, alpha=alpha, beta=beta,
                   shape=shape, dtype=dtype, out=out)


def negative_binomial(k=1, p=1.0, shape=(), dtype="float32", ctx=None,
                      out=None):
    return _sample("_random_negative_binomial", ctx, k=k, p=p, shape=shape,
                   dtype=dtype, out=out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                  dtype="float32", ctx=None, out=None):
    return _sample("_random_generalized_negative_binomial", ctx, mu=mu,
                   alpha=alpha, shape=shape, dtype=dtype, out=out)


def multinomial(data, shape=(), get_prob=False, dtype="int32", out=None):
    """Draws from the categorical rows of ``data`` (``_sample_multinomial``;
    with ``get_prob`` also the log-probability of each draw)."""
    from .ndarray import op as ndop
    return ndop._sample_multinomial(data, shape=shape, get_prob=get_prob,
                                    dtype=dtype, out=out)


def shuffle(data, out=None):
    """``data`` with its first axis randomly permuted (``_shuffle``)."""
    from .ndarray import op as ndop
    return ndop._shuffle(data, out=out)
