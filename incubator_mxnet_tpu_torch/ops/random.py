"""Random sampling operators of the imperative path (counterpart of part
of ``incubator_mxnet_tpu/ops/random.py``; reference
src/operator/random/sample_op.cc).

Every op of the JAX file: ``_random_uniform`` / ``_random_normal``
(``random.py:29-38``), gamma, exponential, poisson, the negative
binomial and the generalized negative binomial (``:41-75``, with JAX's
parameter mapping: a gamma draw times ``(1 - p) / p`` is the rate of a
Poisson draw), ``_random_randint``, ``_sample_multinomial`` with
``get_prob`` (``:84``), ``_shuffle`` (``:109``) and the per-parameter
``_sample_*`` family (``:116-159``: one set of draws per parameter
entry, shaped ``param.shape + shape``).  Each op takes the
``torch.Generator`` of its device as its first argument
(``needs_rng``), drawn from ``random.generator``: the reference's
per-device stateful generator, where the JAX package threads
counter-based keys.  Every draw (``torch.rand``, ``_standard_gamma``,
``poisson``, ``exponential_``, ``multinomial``, ``randperm``) is given
that generator.  The bits differ from JAX's; within the port the same
seed gives the same numbers.
"""
from __future__ import annotations

import numpy as np
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


def _gamma_draw(gen, alpha, shape, dtype):
    """Standard gamma draws of ``shape`` in ``dtype`` (drawn in
    float32) with shape parameter ``alpha`` (a number or a tensor that
    broadcasts to ``shape``)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=gen.device)
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=gen).to(dtype)


def _poisson_draw(gen, lam, dtype):
    return torch.poisson(lam.float(), generator=gen).to(dtype)


@register_op("_random_gamma", aliases=("random_gamma",), needs_rng=True,
             differentiable=False)
def _gamma(gen, *, alpha=1.0, beta=1.0, shape=None, dtype="float32"):
    return _gamma_draw(gen, alpha, _shape(shape), torch_dtype(dtype)) * beta


@register_op("_random_exponential", aliases=("random_exponential",),
             needs_rng=True, differentiable=False)
def _exponential(gen, *, lam=1.0, shape=None, dtype="float32"):
    e = torch.empty(_shape(shape), device=gen.device).exponential_(
        1.0, generator=gen)
    return (e / lam).to(torch_dtype(dtype))


@register_op("_random_poisson", aliases=("random_poisson",), needs_rng=True,
             differentiable=False)
def _poisson(gen, *, lam=1.0, shape=None, dtype="float32"):
    rate = torch.full(_shape(shape), float(lam), device=gen.device)
    return _poisson_draw(gen, rate, torch_dtype(dtype))


@register_op("_random_negative_binomial",
             aliases=("random_negative_binomial",), needs_rng=True,
             differentiable=False)
def _neg_binomial(gen, *, k=1, p=1.0, shape=None, dtype="float32"):
    lam = _gamma_draw(gen, k, _shape(shape), torch.float32) * ((1 - p) / p)
    return _poisson_draw(gen, lam, torch_dtype(dtype))


@register_op("_random_generalized_negative_binomial",
             aliases=("random_generalized_negative_binomial",),
             needs_rng=True, differentiable=False)
def _gen_neg_binomial(gen, *, mu=1.0, alpha=1.0, shape=None,
                      dtype="float32"):
    r = 1.0 / alpha
    p = r / (r + mu)
    lam = _gamma_draw(gen, r, _shape(shape), torch.float32) * ((1 - p) / p)
    return _poisson_draw(gen, lam, torch_dtype(dtype))


@register_op("_sample_multinomial", aliases=("sample_multinomial",),
             needs_rng=True, differentiable=False, num_outputs=None)
def _multinomial(gen, data, *, shape=None, get_prob=False, dtype="int32"):
    """Categorical draws from the (unnormalised) probabilities ``data``
    over its last axis: ``shape`` draws for a 1-D ``data``, ``(batch,
    *shape)`` for a 2-D one (reference sample_multinomial_op.cc); with
    ``get_prob`` also the log-probability of each draw."""
    out_shape = _shape(shape)
    n = int(np.prod(out_shape)) if out_shape else 1
    probs = torch.clamp(data.float(), min=1e-37)
    flat = torch.multinomial(probs, n, replacement=True, generator=gen)
    lead = data.shape[:-1]
    draws = flat.reshape(lead + out_shape)
    samples = draws.to(torch_dtype(dtype))
    if not get_prob:
        return samples
    logp = torch.log_softmax(torch.log(probs), dim=-1)
    lp = torch.gather(logp, -1, flat).reshape(lead + out_shape)
    return samples, lp.to(data.dtype)


@register_op("_shuffle", aliases=("shuffle",), needs_rng=True,
             differentiable=False)
def _shuffle(gen, data):
    """A random permutation of ``data`` along axis 0."""
    perm = torch.randperm(data.shape[0], generator=gen, device=gen.device)
    return data[perm]


def _per_param(param, shape):
    """``param`` reshaped to broadcast against draws of ``param.shape +
    shape``, and that shape."""
    s = _shape(shape)
    return param.reshape(param.shape + (1,) * len(s)), param.shape + s


@register_op("_sample_uniform", needs_rng=True, differentiable=False)
def _sample_uniform(gen, low, high, *, shape=None, dtype="float32"):
    lo, out_shape = _per_param(low, shape)
    hi, _ = _per_param(high, shape)
    u = torch.rand(out_shape, generator=gen, device=gen.device,
                   dtype=torch_dtype(dtype))
    return lo + u * (hi - lo)


@register_op("_sample_normal", needs_rng=True, differentiable=False)
def _sample_normal(gen, mu, sigma, *, shape=None, dtype="float32"):
    m, out_shape = _per_param(mu, shape)
    sd, _ = _per_param(sigma, shape)
    z = torch.randn(out_shape, generator=gen, device=gen.device,
                    dtype=torch_dtype(dtype))
    return m + z * sd


@register_op("_sample_gamma", needs_rng=True, differentiable=False)
def _sample_gamma(gen, alpha, beta, *, shape=None, dtype="float32"):
    a, out_shape = _per_param(alpha, shape)
    b, _ = _per_param(beta, shape)
    return _gamma_draw(gen, a.to(torch_dtype(dtype)), out_shape,
                       torch_dtype(dtype)) * b


@register_op("_sample_exponential", needs_rng=True, differentiable=False)
def _sample_exponential(gen, lam, *, shape=None, dtype="float32"):
    rate, out_shape = _per_param(lam, shape)
    e = torch.empty(out_shape, device=gen.device).exponential_(
        1.0, generator=gen)
    return (e / rate).to(torch_dtype(dtype))


@register_op("_sample_poisson", needs_rng=True, differentiable=False)
def _sample_poisson(gen, lam, *, shape=None, dtype="float32"):
    rate, out_shape = _per_param(lam, shape)
    return _poisson_draw(gen, rate.expand(out_shape), torch_dtype(dtype))
