"""Shape-manipulation and matrix operators (counterpart of
``incubator_mxnet_tpu/ops/matrix.py``; reference
src/operator/tensor/matrix_op.cc, dot.cc, concat.cc, slice_channel.cc).

Several of these return torch views of their input; ``ndarray.invoke``
copies any output that shares storage with an input, so an NDArray
never aliases another, as no JAX array does.  ``dot`` and
``batch_dot`` are plain products (``torch.tensordot`` /
``torch.matmul``), as the JAX package left them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op

__all__ = []


def _negative_steps(key):
    keys = key if isinstance(key, tuple) else (key,)
    neg = [d for d, k in enumerate(keys) if isinstance(k, slice)
           and k.step is not None and k.step < 0]
    if neg and not all(isinstance(k, (slice, int)) for k in keys):
        raise ValueError("negative-step slices combine only with other "
                         "slices and integers")
    return keys, neg


def _numpy_ints(key, device):
    """The key with numpy's rule for integers beside index arrays: an
    integer then counts as an advanced index (torch applies it first, as
    a basic one), so ``a[1, :, idx]`` puts idx's dimension first, as
    numpy and the JAX package do.  Each such integer becomes a
    one-element index tensor, which broadcasts with the arrays as the
    integer does."""
    if not isinstance(key, tuple) or not any(
            isinstance(k, int) and not isinstance(k, bool) for k in key):
        return key
    if not any(isinstance(k, torch.Tensor) and k.ndim > 0 or
               isinstance(k, (list, np.ndarray)) for k in key):
        return key
    return tuple(torch.tensor([k], device=device)
                 if isinstance(k, int) and not isinstance(k, bool) else k
                 for k in key)


def read_key(x, key):
    """``(x', key')`` with ``x'[key'] == x[key]`` and only positive
    steps (torch slicing takes no negative ones): a negative-step slice
    flips its dim and slices it forwards."""
    keys, neg = _negative_steps(key)
    if not neg:
        return x, _numpy_ints(key, x.device)
    out = list(keys)
    for d in neg:
        n = x.shape[d]
        start, stop, step = keys[d].indices(n)
        x = x.flip(d)
        start, stop = n - 1 - start, n - 1 - stop
        out[d] = slice(start, max(stop, start), -step)
    return x, tuple(out)


def write_key(x, key):
    """A key that names the same elements of ``x`` as ``key`` for an
    in-place write: its one negative-step slice becomes an index tensor
    of the positions it names."""
    keys, neg = _negative_steps(key)
    if not neg:
        return _numpy_ints(key, x.device)
    if len(neg) > 1:
        raise ValueError("a write takes at most one negative-step slice")
    d = neg[0]
    out = list(keys)
    out[d] = torch.arange(*keys[d].indices(x.shape[d]), device=x.device)
    return tuple(out)


def _reshape_shape(src, shape, reverse):
    """MXNet reshape codes 0 (keep), -1 (infer), -2 (copy the rest), -3
    (merge two), -4 (split one in two) — matrix_op-inl.h:
    InferReshapeShape."""
    src = list(src)
    if reverse:
        src = src[::-1]
        shape = tuple(shape)[::-1]
    out = []
    i = 0
    spec = list(shape)
    j = 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = spec[j + 1], spec[j + 2]
            cur = src[i]
            if a == -1:
                a = cur // b
            if b == -1:
                b = cur // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


@register_op("Reshape", aliases=("reshape",))
def _reshape(x, *, shape=None, reverse=False):
    if shape is None:
        return x
    return x.reshape(_reshape_shape(x.shape, shape, reverse))


@register_op("Flatten", aliases=("flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register_op("transpose")
def _transpose(x, *, axes=None):
    axes = tuple(axes) if axes else tuple(reversed(range(x.ndim)))
    return x.permute(axes)


@register_op("expand_dims")
def _expand_dims(x, *, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    ndim = x.ndim + len(axes)
    for a in sorted(a % ndim for a in axes):
        x = x.unsqueeze(a)
    return x


@register_op("squeeze")
def _squeeze(x, *, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register_op("SwapAxis", aliases=("swapaxes", "SwapAxes"))
def _swapaxes(x, *, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


@register_op("slice")
def _slice(x, *, begin, end, step=None):
    step = step or (None,) * len(begin)
    t, k = read_key(x, tuple(slice(b, e, s)
                             for b, e, s in zip(begin, end, step)))
    return t[k]


@register_op("slice_axis")
def _slice_axis(x, *, axis, begin, end):
    axis = axis % x.ndim
    end = end if end is not None else x.shape[axis]
    return x[(slice(None),) * axis + (slice(begin, end),)]


@register_op("slice_like")
def _slice_like(x, like, *, axes=()):
    axes = axes or tuple(range(min(x.ndim, like.ndim)))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a % x.ndim] = slice(0, like.shape[a % x.ndim])
    return x[tuple(idx)]


@register_op("Crop", aliases=("crop",))
def _crop(x, *, h_w=None, offset=(0, 0), center_crop=False, shape=None):
    th, tw = h_w if h_w else shape[-2:]
    H, W = x.shape[-2], x.shape[-1]
    if center_crop:
        oh, ow = (H - th) // 2, (W - tw) // 2
    else:
        oh, ow = offset
    return x[..., oh:oh + th, ow:ow + tw]


@register_op("tile")
def _tile(x, *, reps):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


@register_op("repeat")
def _repeat(x, *, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op("reverse", aliases=("flip",))
def _reverse(x, *, axis):
    return x.flip((axis,) if isinstance(axis, int) else tuple(axis))


@register_op("diag")
def _diag(x, *, k=0):
    return torch.diag(x, k) if x.ndim <= 2 else \
        torch.diagonal(x, offset=k, dim1=0, dim2=1)


@register_op("Concat", aliases=("concat",))
def _concat(*args, dim=1):
    return torch.cat(args, dim=dim)


@register_op("stack")
def _stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register_op("SliceChannel", aliases=("split",), num_outputs=None)
def _split(x, *, num_outputs, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[axis]} by {num_outputs}")
    parts = torch.tensor_split(x, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register_op("space_to_depth")
def _space_to_depth(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register_op("depth_to_space")
def _depth_to_space(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


# ------------------------------------------------------------------- dot
def _t(a):
    return a.permute(tuple(reversed(range(a.ndim))))


@register_op("dot")
def _dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """MXNet dot: contract a's last axis with b's first (dot-inl.h)."""
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    if a.ndim <= 2 and b.ndim <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


@register_op("batch_dot")
def _batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register_op("khatri_rao")
def _khatri_rao(*args):
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            -1, out.shape[-1])
    return out


@register_op("shape_array", differentiable=False)
def _shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register_op("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register_op("reshape_like")
def _reshape_like(lhs, rhs):
    """lhs reshaped to rhs's shape; rhs contributes only its shape, so
    its gradient is zero (reference elemwise_unary_op_basic.cc:312)."""
    return lhs.reshape(rhs.shape)
