"""Reduction and broadcast-shape operators (counterpart of
``incubator_mxnet_tpu/ops/reduce.py``; reference
src/operator/tensor/broadcast_reduce_op_*.cc).

MXNet axis semantics: ``axis`` may be None (all), an int or a tuple,
with ``keepdims`` and ``exclude``.  Output dtypes are the JAX
package's: sum and prod widen bool, int8 and int16 to int32 and uint8
to uint32 and keep any other integer dtype, mean of an integer array is
float32, argmax/argmin return float32 indices, cumsum keeps an integer
dtype (bool gives int32).  ``axis=()`` reduces nothing but keeps these
rules (and nansum's NaN rule), as the JAX ops do.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .elemwise import _unbool, abs_
from .registry import register_op

__all__ = []


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


_WIDENED = {torch.bool: torch.int32, torch.int8: torch.int32,
            torch.int16: torch.int32, torch.uint8: torch.uint32}


def _int_result(x):
    """The dtype of an integer sum or product, widened as JAX widens it
    (torch accumulates in int64; the cast wraps as an int32 sum does)."""
    return _WIDENED.get(x.dtype, x.dtype)


def _sum(x, ax, keepdims):
    out = torch.sum(x, dim=ax, keepdim=keepdims) if ax else x
    return out if x.is_floating_point() else out.to(_int_result(x))


def _mean(x, ax, keepdims):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=ax, keepdim=keepdims) if ax else x


def _prod(x, ax, keepdims):
    out = x
    for a in sorted(ax, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdims)
    return out if x.is_floating_point() else out.to(_int_result(x))


def _nansum(x, ax, keepdims):
    if not x.is_floating_point():
        return _sum(x, ax, keepdims)
    if not ax:
        return torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.nansum(x, dim=ax, keepdim=keepdims)


def _nanprod(x, ax, keepdims):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), ax,
                 keepdims)


def _max(x, ax, keepdims):
    return torch.amax(x, dim=ax, keepdim=keepdims) if ax else x


def _min(x, ax, keepdims):
    return torch.amin(x, dim=ax, keepdim=keepdims) if ax else x


def _reduce(f):
    """The registry op over ``f(x, axes, keepdims)``.  An empty axis
    tuple reaches ``f`` too, which then reduces nothing but keeps its
    dtype and NaN rules (torch would read ``dim=()`` as every axis)."""
    def op(x, *, axis=None, keepdims=False, exclude=False):
        return f(x, _norm_axis(axis, x.ndim, exclude), bool(keepdims))
    return op


register_op("sum", _reduce(_sum), aliases=("sum_axis",))
register_op("mean", _reduce(_mean))
register_op("prod", _reduce(_prod))
register_op("nansum", _reduce(_nansum))
register_op("nanprod", _reduce(_nanprod))
register_op("max", _reduce(_max), aliases=("max_axis",))
register_op("min", _reduce(_min), aliases=("min_axis",))


@register_op("norm")
def _norm(x, *, ord=2, axis=None, keepdims=False):
    ax = tuple(range(x.ndim)) if axis is None else \
        (axis if isinstance(axis, tuple) else (axis,))
    if not ax:      # torch reads dim=() as every axis; JAX sums none
        if ord == 1:
            return _sum(abs_(x), ax, keepdims)
        # XLA folds sqrt(x * x) to |x| for a float (1e30 stays finite);
        # an integer square wraps first, as in JAX
        return abs_(x) if x.is_floating_point() else \
            torch.sqrt(torch.square(x))
    if ord == 1:
        return _sum(abs_(x), ax, keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=keepdims))


def _arg(f):
    def op(x, *, axis=None, keepdims=False):
        x = _unbool(x, torch.uint8)      # torch's argmax refuses bool
        if axis is None:
            out = f(x.reshape(-1), dim=0)
        else:
            out = f(x, dim=axis, keepdim=bool(keepdims))
        return out.to(torch.float32)
    return op


register_op("argmax", _arg(torch.argmax), differentiable=False)
register_op("argmin", _arg(torch.argmin), differentiable=False)


@register_op("argmax_channel", differentiable=False)
def _argmax_channel(x):
    return torch.argmax(_unbool(x, torch.uint8), dim=-1).to(torch.float32)


@register_op("broadcast_to")
def _broadcast_to(x, *, shape):
    tgt = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return x.expand(tgt)


@register_op("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(x, *, axis, size):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.expand(tuple(tgt))


@register_op("broadcast_like")
def _broadcast_like(x, like):
    return x.expand(like.shape)


@register_op("cumsum")
def _cumsum(x, *, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if dtype is not None:
        return torch.cumsum(x, dim=axis, dtype=torch_dtype(dtype))
    # JAX keeps an integer dtype (int8 wraps) and sums bool as int32
    out = torch.cumsum(x, dim=axis)
    return out.to(torch.int32 if x.dtype == torch.bool else x.dtype)
