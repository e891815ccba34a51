"""Random state and the ``mx.random`` API (counterpart of
``incubator_mxnet_tpu/random.py``; reference python/mxnet/random.py
over per-device generators, src/common/random_generator.h).

One explicit ``torch.Generator`` per device, made at first use from the
current seed; ``seed(s)`` reseeds them all (``ctx="all"``) or the one
of ``ctx``.  Sampling ops get their device's generator from
``ndarray.invoke``.  The bits differ from the JAX package's keys;
within the port the same seed gives the same numbers.

``named_sample`` (the initializers' draws) uses a CPU generator of its
own per parameter name, seeded from the current seed and the name's
CRC-32: a parameter's initial values do not depend on the order in
which parameters are created, as the JAX package folds the name into
its key.
"""
from __future__ import annotations

import binascii
import threading

import torch

from .context import Context

__all__ = ["seed", "generator", "named_sample", "uniform", "normal", "randn",
           "randint"]

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


def named_sample(name, kind, shape=(), **kw):
    """A float32 numpy sample of ``shape`` for parameter ``name``:
    ``kind="uniform"`` on ``[low, high)``, ``"normal"`` with ``loc`` and
    ``scale``, from a generator seeded by the current seed and the
    name's CRC-32."""
    gen = torch.Generator().manual_seed(
        (_seed[0] << 32) ^ (binascii.crc32(str(name).encode()) & 0x7FFFFFFF))
    out = torch.empty(tuple(shape), dtype=torch.float32)
    if kind == "uniform":
        out.uniform_(kw.get("low", 0.0), kw.get("high", 1.0), generator=gen)
    elif kind == "normal":
        out.normal_(kw.get("loc", 0.0), kw.get("scale", 1.0), generator=gen)
    else:
        raise ValueError(f"unknown sample kind {kind}")
    return out.numpy()


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
