"""Random sampling operators of the imperative path (counterpart of part
of ``incubator_mxnet_tpu/ops/random.py``; reference
src/operator/random/sample_op.cc).

Ported so far: ``_random_uniform`` (``random.py:29``),
``_random_normal`` (``:35``) and ``_random_randint`` (``:78``); the
other distributions are ROADMAP A8.  Each op takes the
``torch.Generator`` of its device as its first argument
(``needs_rng``), drawn from ``random.generator``: the reference's
per-device stateful generator, where the JAX package threads
counter-based keys.  The bits differ from JAX's; within the port the
same seed gives the same numbers.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register_op

__all__ = []


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


@register_op("_random_uniform", aliases=("uniform", "random_uniform"),
             needs_rng=True, differentiable=False)
def _uniform(gen, *, low=0.0, high=1.0, shape=None, dtype="float32"):
    u = torch.rand(_shape(shape), generator=gen, device=gen.device,
                   dtype=torch_dtype(dtype))
    return u * (high - low) + low


@register_op("_random_normal", aliases=("normal", "random_normal"),
             needs_rng=True, differentiable=False)
def _normal(gen, *, loc=0.0, scale=1.0, shape=None, dtype="float32"):
    z = torch.randn(_shape(shape), generator=gen, device=gen.device,
                    dtype=torch_dtype(dtype))
    return loc + scale * z


@register_op("_random_randint", aliases=("random_randint",), needs_rng=True,
             differentiable=False)
def _randint(gen, *, low, high, shape=None, dtype="int32"):
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=gen.device, dtype=torch_dtype(dtype))
