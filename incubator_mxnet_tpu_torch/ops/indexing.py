"""Indexing, ordering and init operators of the imperative path
(counterpart of part of ``incubator_mxnet_tpu/ops/indexing.py``;
reference src/operator/tensor/indexing_op.cc, ordering_op.cc,
init_op.cc).

Every op of the JAX file: ``Embedding`` (``indexing.py:19``),
``take``, ``batch_take``, ``pick``, ``one_hot``, ``gather_nd``,
``scatter_nd``, ``_scatter_nd_add`` and ``_backward_gather_nd``
(``:51-67``), ``where_index`` (``:70``), the ordering ops ``topk`` /
``sort`` / ``argsort``, the init ops (``_zeros``, ``_ones``, ``_full``,
``_eye``, ``_arange``, ``zeros_like``, ``ones_like``) and the legacy
``choose_element_0index`` / ``fill_element_0index`` pairs.  Indices out
of range are clipped (``mode="clip"``, the reference's default) or
wrapped (``mode="wrap"``); ``one_hot`` gives an all-``off_value`` row
for an index outside ``[0, depth)``, as ``jax.nn.one_hot`` does.

The N-d indexing ops follow JAX's indexing rules: a negative index
counts from the end; a gather clamps an index that is still out of
range, a scatter drops it.  ``scatter_nd`` with a repeated index keeps
the last of its values, as ``.at[].set`` gives it on the JAX package's
CPU backend, and the losers get no gradient; the port writes the
losers into a spare slot that it then drops, so the result does not
depend on the order in which the card's threads write.
"""
from __future__ import annotations

import numpy as np
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


@register_op("batch_take",
             aliases=("choose_element_0index", "_choose_element_0index"))
def _batch_take(a, indices):
    """``out[i] = a[i, indices[i]]`` (legacy ``choose_element_0index``
    is the same op)."""
    rows = torch.arange(a.shape[0], device=a.device)
    return _gather(a, [(rows, torch.ones_like(rows, dtype=torch.bool)),
                       _jax_gather_index(indices, a.shape[1])])


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


# ------------------------------------------------------------- N-d index
def _jax_gather_index(indices, n):
    """JAX's gather rule: a negative index counts from the end, then the
    index is clamped into ``[0, n)``; also the mask of the indices that
    were in range, the only ones whose rows get a gradient (JAX's
    scatter-add transpose drops the others)."""
    idx = indices.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def _gather(data, index):
    """``data[index]`` for a tuple of ``(clamped, inside)`` pairs over
    the leading axes: a clamped index reads its row but passes no
    gradient back."""
    out = data[tuple(i for i, _ in index)]
    inside = index[0][1]
    for _, m in index[1:]:
        inside = inside & m
    if not out.requires_grad:
        return out
    inside = inside.reshape(inside.shape + (1,) * (out.dim() - inside.dim()))
    return torch.where(inside, out, out.detach())


def _flat_target(indices, shape):
    """Row-major offsets into ``shape[:M]`` of the ``M``-row index
    ``indices`` (JAX's scatter rule: negative indices count from the end)
    and the mask of those inside the array; the rest are dropped."""
    idx = indices.long()
    m = idx.shape[0]
    flat = torch.zeros(idx.shape[1:], dtype=torch.long, device=idx.device)
    inside = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for k in range(m):
        n = int(shape[k])
        i = torch.where(idx[k] < 0, idx[k] + n, idx[k])
        inside &= (i >= 0) & (i < n)
        flat = flat * n + i.clamp(0, n - 1)
    return flat, inside


@register_op("gather_nd")
def _gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``: out has shape
    ``indices.shape[1:] + data.shape[M:]``."""
    m = indices.shape[0]
    return _gather(data, [_jax_gather_index(indices[k], data.shape[k])
                          for k in range(m)])


def _scatter(data, indices, shape, add):
    shape = tuple(int(s) for s in shape)
    m = indices.shape[0]
    flat, inside = _flat_target(indices, shape)
    flat, inside = flat.reshape(-1), inside.reshape(-1)
    rows = data.reshape((flat.shape[0],) + shape[m:])
    total = int(np.prod(shape[:m]))
    if not add:
        # the last write to an offset wins: an earlier duplicate goes to
        # the spare slot ``total`` with the out-of-range ones
        pos = torch.arange(flat.shape[0], device=flat.device)
        last = torch.full((total,), -1, dtype=torch.long,
                          device=flat.device)
        last = last.scatter_reduce(0, flat, torch.where(inside, pos, -1),
                                   "amax")
        inside = inside & (last[flat] == pos)
    target = torch.where(inside, flat, total)
    out = torch.zeros((total + 1,) + shape[m:], dtype=data.dtype,
                      device=data.device)
    out = out.index_put((target,), rows, accumulate=add)
    return out[:total].reshape(shape)


@register_op("scatter_nd")
def _scatter_nd(data, indices, *, shape):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (JAX
    ``.at[].set``: the last of repeated indices wins)."""
    return _scatter(data, indices, shape, add=False)


@register_op("_scatter_nd_add")
def _scatter_nd_add(data, indices, *, shape):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (repeated
    indices sum; the gradient of ``gather_nd``)."""
    return _scatter(data, indices, shape, add=True)


register_op("_backward_gather_nd",
            lambda d, i, *, shape: _scatter(d, i, shape, add=True))


@register_op("where_index", differentiable=False)
def _where_index(x):
    """The ``(N, ndim)`` float32 indices of the nonzero entries of
    ``x`` (argwhere).  The shape depends on the values: one
    ``nonzero``, with its sync on the card (the JAX op runs on the host,
    ``nojit``)."""
    return torch.nonzero(x).to(torch.float32)


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


# --------------------------------------------------------- legacy indexing
@register_op("fill_element_0index", aliases=("_fill_element_0index",))
def _fill_element_0index(lhs, mhs, rhs):
    """``lhs`` with ``out[i, rhs[i]] = mhs[i]`` (the JAX op's
    ``.at[rows, rhs].set``: a negative column counts from the end, one
    out of range is dropped)."""
    n = lhs.shape[1]
    col = rhs.long()
    col = torch.where(col < 0, col + n, col)
    hit = torch.arange(n, device=lhs.device) == col[:, None]
    return torch.where(hit, mhs.to(lhs.dtype)[:, None], lhs)
