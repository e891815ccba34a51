"""Spatial warping and region operators of the imperative path
(counterpart of ``incubator_mxnet_tpu/ops/spatial.py``; reference
src/operator/grid_generator.cc, bilinear_sampler.cc,
spatial_transformer.cc, roi_pooling.cc, correlation.cc).

Every op of the JAX file, with its lower-case alias: ``GridGenerator``
(``spatial.py:42``, affine and warp), ``BilinearSampler`` (``:98``),
``SpatialTransformer`` (``:105``), ``ROIPooling`` (``:117``) and
``Correlation`` (``:171``).  They are plain XLA in the JAX package, so
here they are PyTorch compositions:

* ``BilinearSampler`` is ``F.grid_sample(align_corners=True,
  padding_mode="zeros")``: the same four-corner blend, with a corner
  outside the map contributing 0, as the JAX gather does.
* ``ROIPooling`` takes the max of each bin without the JAX op's
  ``(R, C, ph, pw, H, W)`` masked tensor (15 G elements at Fast R-CNN's
  head): a masked max over the rows of each bin row, then over the
  columns of each bin, on a few rois at a time.  Its backward is JAX's
  rule for ``jnp.max`` over the bin's whole window, which splits the
  gradient evenly among tied maxima; the two-stage max would split it
  otherwise, so ``_ROIPool`` writes that rule out.  Bin edges divide
  the roi's extent truly, as the reference does (the JAX op multiplies
  by the reciprocal, which moves an edge that falls on an integer).
* ``Correlation`` rolls the second padded map by each displacement, as
  the JAX op does with ``jnp.roll``, and reduces over the channels
  before the next shift (``_CorrelationSum`` keeps only the two maps for
  its backward).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = []


# --------------------------------------------------------- GridGenerator
def _affine_grid(theta, h, w):
    """theta (B, 6) -> the normalised sampling grid (B, 2, h, w)."""
    b = theta.shape[0]
    ys = torch.linspace(-1.0, 1.0, h, dtype=theta.dtype,
                        device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=theta.dtype,
                        device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])       # (3, h*w)
    out = torch.matmul(theta.reshape(b, 2, 3), base)           # (B, 2, h*w)
    return out.reshape(b, 2, h, w)


@register_op("GridGenerator", aliases=("grid_generator",))
def _grid_generator(data, *, transform_type="affine", target_shape=None):
    """affine: ``data`` (B, 6) and ``target_shape`` (H, W); warp:
    ``data`` (B, 2, H, W), a flow in pixels added to the identity grid.
    Both give a (B, 2, H, W) grid in [-1, 1]."""
    if transform_type == "affine":
        h, w = target_shape
        return _affine_grid(data, int(h), int(w))
    _, _, h, w = data.shape
    ys = torch.arange(h, dtype=data.dtype, device=data.device)
    xs = torch.arange(w, dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    # true divisions (0-d tensor divisors): the card divides by a Python
    # scalar as a product with its reciprocal, which would move a sample
    # point by an ulp from the CPU's, and across a pixel edge the
    # sampler's gradient jumps
    x_n = 2.0 * (data[:, 0] + gx) / _scalar(max(w - 1, 1), data) - 1.0
    y_n = 2.0 * (data[:, 1] + gy) / _scalar(max(h - 1, 1), data) - 1.0
    return torch.stack([x_n, y_n], dim=1)


def _scalar(v, like):
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


# -------------------------------------------------------- BilinearSampler
def _bilinear_sample(data, grid):
    """Sample ``data`` (B, C, H, W) at ``grid`` (B, 2, Ho, Wo), x then y
    in [-1, 1]; zero outside the map."""
    return F.grid_sample(data, grid.permute(0, 2, 3, 1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


@register_op("BilinearSampler", aliases=("bilinear_sampler",))
def _bilinear_sampler(data, grid):
    return _bilinear_sample(data, grid)


# ------------------------------------------------------ SpatialTransformer
@register_op("SpatialTransformer", aliases=("spatial_transformer",))
def _spatial_transformer(data, loc, *, target_shape=None,
                         transform_type="affine", sampler_type="bilinear"):
    """The affine grid of ``loc`` (B, 6) at ``target_shape``, then the
    bilinear sampler."""
    h, w = target_shape if target_shape else data.shape[2:]
    grid = _affine_grid(loc.reshape(loc.shape[0], 6), int(h), int(w))
    return _bilinear_sample(data, grid)


# ------------------------------------------------------------- ROIPooling
# feature elements of the rois pooled at a time (C * H * W each): bounds
# the masked (rois, C, H, W) temporaries to ~256 MB in fp32
_ROI_CHUNK_ELEMS = 1 << 26


def _roi_bins(rois, pooled, spatial_scale, h, w, dtype):
    """Each roi's bin windows as masks: rows (R, ph, H) and columns (R,
    pw, W) (reference roi_pooling.cc's bin rule, with the JAX op's
    at-least-one-row/column widening)."""
    ph, pw = pooled
    dev = rois.device
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    # a true division (0-d tensor divisor): the card divides by a Python
    # scalar as a product with its reciprocal, which moves a bin edge
    # that falls on an integer across it (floor / ceil)
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / _scalar(pw, x1)
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / _scalar(ph, y1)

    def masks(start, size, n, extent):
        i = torch.arange(n, dtype=dtype, device=dev)
        lo = torch.floor(start[:, None] + i * size[:, None])
        hi = torch.ceil(start[:, None] + (i + 1) * size[:, None])
        hi = torch.maximum(hi, lo + 1)
        pos = torch.arange(extent, dtype=dtype, device=dev)
        return (pos >= lo[..., None]) & (pos < hi[..., None])

    return masks(y1, bin_h, ph, h), masks(x1, bin_w, pw, w)


def _row_max(feats, my):
    """(r, C, ph, W): the max over each bin row's rows, -inf where the
    bin row has none."""
    neg = torch.tensor(float("-inf"), dtype=feats.dtype,
                       device=feats.device)
    return torch.stack([
        torch.where(my[:, p, None, :, None], feats, neg).amax(2)
        for p in range(my.shape[1])], 2)


def _col_max(rowmax, mx):
    """(r, C, ph, pw): the max over each bin's columns of ``rowmax``."""
    neg = torch.tensor(float("-inf"), dtype=rowmax.dtype,
                       device=rowmax.device)
    return torch.stack([
        torch.where(mx[:, None, None, q, :], rowmax, neg).amax(-1)
        for q in range(mx.shape[1])], -1)


def _roi_chunks(data, rois):
    r = rois.shape[0]
    per = max(1, _ROI_CHUNK_ELEMS // max(1, data[0].numel()))
    return [(r0, min(r, r0 + per)) for r0 in range(0, r, per)]


class _ROIPool(torch.autograd.Function):
    """ROI max pooling whose gradient is JAX's rule for ``jnp.max`` over
    each bin's (H, W) window: ``g / k`` to each of the ``k`` positions
    of the window that equal its max.  Such a position is a column
    whose row-stage max equals the bin's max, at a row where the data
    equals that column's row-stage max, so both counts come from the
    two stages without the window tensor."""

    @staticmethod
    def forward(ctx, data, rois, pooled, spatial_scale):
        _, _, h, w = data.shape
        my, mx = _roi_bins(rois, pooled, spatial_scale, h, w, data.dtype)
        bidx = rois[:, 0].long()
        outs = []
        for r0, r1 in _roi_chunks(data, rois):
            feats = data.index_select(0, bidx[r0:r1])
            outs.append(_col_max(_row_max(feats, my[r0:r1]), mx[r0:r1]))
        out = torch.cat(outs) if outs else data.new_zeros(
            (0, data.shape[1]) + tuple(pooled))
        ctx.save_for_backward(data, rois, out)
        ctx.geometry = (my, mx)
        return torch.where(torch.isinf(out), torch.zeros_like(out), out)

    @staticmethod
    def backward(ctx, g):
        data, rois, out = ctx.saved_tensors
        my, mx = ctx.geometry
        bidx = rois[:, 0].long()
        empty = torch.isinf(out)
        grad = torch.zeros_like(data)
        for r0, r1 in _roi_chunks(data, rois):
            feats = data.index_select(0, bidx[r0:r1])
            myc, mxc = my[r0:r1], mx[r0:r1]
            rowmax = _row_max(feats, myc)                    # (r,C,ph,W)
            o = out[r0:r1]
            # rows attaining each column's row-stage max, per bin row
            row_hit = [myc[:, p, None, :, None] &
                       (feats == rowmax[:, :, p, None, :])
                       for p in range(myc.shape[1])]          # (r,C,H,W)
            row_count = torch.stack([hit.sum(2) for hit in row_hit], 2)
            # columns whose row-stage max is the bin's max: (r,C,ph,pw,W)
            col_hit = mxc[:, None, None] & \
                (rowmax[:, :, :, None, :] == o[..., None])
            count = (col_hit * row_count[:, :, :, None, :]).sum(-1)
            share = torch.where(empty[r0:r1], torch.zeros_like(o),
                                g[r0:r1] / count.clamp(min=1))
            per_col = (col_hit * share[..., None]).sum(3)      # (r,C,ph,W)
            gf = sum(hit * per_col[:, :, p, None, :]
                     for p, hit in enumerate(row_hit))
            grad.index_add_(0, bidx[r0:r1], gf)
        return grad, None, None, None


@register_op("ROIPooling", aliases=("roi_pooling",))
def _roi_pooling(data, rois, *, pooled_size, spatial_scale=1.0):
    """Max pooling over regions of interest: ``data`` (B, C, H, W),
    ``rois`` (R, 5) rows ``[batch_idx, x1, y1, x2, y2]`` in image
    coordinates; out (R, C, ph, pw), 0 for a bin with no pixel of the
    map."""
    pooled = (pooled_size, pooled_size) if isinstance(pooled_size, int) \
        else tuple(int(p) for p in pooled_size)
    return _ROIPool.apply(data, rois.to(data.dtype), pooled,
                          float(spatial_scale))


# ------------------------------------------------------------ Correlation
class _CorrelationSum(torch.autograd.Function):
    """(B, D, Hp, Wp): for each displacement ``(dy, dx)``, the channel
    sum of ``p1 * roll(p2, (-dy, -dx))`` (or ``|p1 - roll(...)|``),
    over ``norm``.  Its backward rolls again instead of keeping the D
    shifted maps."""

    @staticmethod
    def forward(ctx, p1, p2, shifts, multiply, norm):
        ctx.cfg = (shifts, multiply, norm)
        ctx.save_for_backward(p1, p2)
        outs = []
        for dy, dx in shifts:
            s = torch.roll(p2, shifts=(-dy, -dx), dims=(2, 3))
            outs.append((p1 * s).sum(1) if multiply
                        else (p1 - s).abs().sum(1))
        return torch.stack(outs, 1) / norm

    @staticmethod
    def backward(ctx, g):
        p1, p2 = ctx.saved_tensors
        shifts, multiply, norm = ctx.cfg
        g = g / norm
        d1 = torch.zeros_like(p1)
        d2 = torch.zeros_like(p2)
        for k, (dy, dx) in enumerate(shifts):
            gk = g[:, k, None]
            s = torch.roll(p2, shifts=(-dy, -dx), dims=(2, 3))
            if multiply:
                d1 += gk * s
                d2 += torch.roll(gk * p1, shifts=(dy, dx), dims=(2, 3))
            else:
                t = gk * torch.sign(p1 - s)
                d1 += t
                d2 -= torch.roll(t, shifts=(dy, dx), dims=(2, 3))
        return d1, d2, None, None, None


@register_op("Correlation", aliases=("correlation",))
def _correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                 stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """The FlowNet cost volume: ``(2 * (d // stride2) + 1) ** 2`` output
    channels, one per displacement, each the channel sum (box-summed
    over ``kernel_size`` with SAME padding) normalised by
    ``kernel_size ** 2 * C``; cropped by ``pad_size``, then strided by
    ``stride1``."""
    _, c, h, w = data1.shape
    d, k, pad = int(max_displacement), int(kernel_size), int(pad_size)
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    shifts = [(dy, dx) for dy in range(-d, d + 1, stride2)
              for dx in range(-d, d + 1, stride2)]
    out = _CorrelationSum.apply(p1, p2, shifts, bool(is_multiply),
                                float(k * k * c))
    if k > 1:
        # the channel sum commutes with the per-channel box filter
        lo = (k - 1) // 2
        n, dd, hp, wp = out.shape
        box = F.pad(out.reshape(n * dd, 1, hp, wp),
                    (lo, k - 1 - lo, lo, k - 1 - lo))
        ones = torch.ones((1, 1, k, k), dtype=out.dtype, device=out.device)
        out = F.conv2d(box, ones).reshape(n, dd, hp, wp)
    if pad:
        out = out[:, :, pad:pad + h, pad:pad + w]
    if stride1 > 1:
        out = out[:, :, ::stride1, ::stride1]
    return out
