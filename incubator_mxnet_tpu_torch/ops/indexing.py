"""Indexing, ordering and init operators of the imperative path
(counterpart of part of ``incubator_mxnet_tpu/ops/indexing.py``;
reference src/operator/tensor/indexing_op.cc, ordering_op.cc,
init_op.cc).

Ported so far: ``Embedding`` (``indexing.py:19``), ``pick``
(``:36``), ``take``, ``one_hot``,
the ordering ops ``topk`` / ``sort`` / ``argsort`` and the init ops
(``_zeros``, ``_ones``, ``_full``, ``_eye``, ``_arange``,
``zeros_like``, ``ones_like``).  gather/scatter_nd and the legacy
indexing ops are ROADMAP A8.  Indices out of range are clipped
(``mode="clip"``, the reference's default) or wrapped
(``mode="wrap"``); ``one_hot`` gives an all-``off_value`` row for an
index outside ``[0, depth)``, as ``jax.nn.one_hot`` does.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register_op

__all__ = []


def _index(indices, n, mode):
    idx = indices.long()
    if mode == "wrap":
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)


@register_op("Embedding")
def _embedding(data, weight, *, input_dim=None, output_dim=None, dtype=None,
               sparse_grad=False):
    """Rows of ``weight`` at the indices ``data``, as the JAX op's
    ``jnp.take`` gives them: a negative index counts from the end, one
    outside ``[-input_dim, input_dim)`` gives a row of NaN (the gather
    itself reads a clamped index, so no device assert)."""
    idx = data.long()
    n = weight.shape[0]
    valid = ((idx >= -n) & (idx < n)).unsqueeze(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    rows = weight[idx.clamp(0, n - 1)]
    return torch.where(valid, rows, torch.full_like(rows, float("nan")))


@register_op("take")
def _take(a, indices, *, axis=0, mode="clip"):
    axis = axis % a.ndim
    idx = _index(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + indices.shape + a.shape[axis + 1:])


@register_op("pick")
def _pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    axis = -1 if axis is None else axis % data.ndim
    idx = _index(index, data.shape[axis], mode).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register_op("one_hot", differentiable=False)
def _one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
             dtype="float32"):
    classes = torch.arange(depth, device=indices.device)
    oh = (indices.long().unsqueeze(-1) == classes).to(torch_dtype(dtype))
    return oh * on_value + (1.0 - oh) * off_value


# ---------------------------------------------------------------- ordering
@register_op("topk", differentiable=False, num_outputs=None)
def _topk(x, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    ax = axis % x.ndim if axis is not None else x.ndim - 1
    # a stable sort breaks ties by the lower index, as jax.lax.top_k
    # does (torch.topk leaves their order open)
    vals, idx = torch.sort(x, dim=ax, descending=not is_ascend, stable=True)
    vals, idx = vals.narrow(ax, 0, k), idx.narrow(ax, 0, k)
    idx = idx.to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    if ret_typ == "mask":
        mask = torch.zeros_like(x)
        return mask.scatter(ax, idx.long(), 1)
    return idx


@register_op("sort")
def _sort(x, *, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else out.flip(axis)


@register_op("argsort", differentiable=False)
def _argsort(x, *, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = out.flip(axis)
    return out.to(torch_dtype(dtype))


# ---------------------------------------------------------------- init ops
def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@register_op("_zeros", differentiable=False)
def _zeros(*, shape, dtype="float32", device=None):
    return torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                       device=device)


@register_op("_ones", differentiable=False)
def _ones(*, shape, dtype="float32", device=None):
    return torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                      device=device)


@register_op("_full", differentiable=False)
def _full(*, shape, value, dtype="float32", device=None):
    return torch.full(_shape(shape), value, dtype=torch_dtype(dtype),
                      device=device)


@register_op("_eye", differentiable=False)
def _eye(*, N, M=0, k=0, dtype="float32", device=None):
    rows = torch.arange(N, device=device)[:, None]
    cols = torch.arange(M if M else N, device=device)[None, :]
    return (cols - rows == k).to(torch_dtype(dtype))


@register_op("_arange", differentiable=False)
def _arange(*, start=0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=device)
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register_op("zeros_like", differentiable=False)
def _zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like", differentiable=False)
def _ones_like(x):
    return torch.ones_like(x)
