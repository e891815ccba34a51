"""Neural-network operators of the imperative path (counterpart of
``incubator_mxnet_tpu/ops/nn.py``; reference src/operator/nn/).

Registered here: ``FullyConnected`` (``nn.py:38``), ``Convolution``
(``:79``), ``Deconvolution`` (``:116``), ``Pooling`` (``:151``),
``Activation`` (``:209``), ``LeakyReLU`` (``:226``), ``softmax``
(``:248``), ``log_softmax`` (``:254``), ``softmin`` (``:260``),
``SoftmaxActivation`` (``:266``), ``BatchNorm`` (``:408``),
``_FusedBatchNormRelu`` (``:535``, over ``fused_batch_norm_relu``, which
``gluon.nn.BNReLU`` also calls), ``InstanceNorm`` (``:550``),
``LayerNorm`` (``:559``), ``L2Normalization`` (``:570``), ``LRN``
(``:586``), ``Dropout`` (``:596``), ``Pad`` (``:609``), ``UpSampling``
(``:621``), ``SequenceMask`` / ``SequenceLast`` / ``SequenceReverse``
(``:645-690``), ``softmax_cross_entropy`` (``:733``) and the output layers
(``:283-400``: ``SoftmaxOutput`` with its aliases ``Softmax`` and
``softmax_output``, ``LinearRegressionOutput``,
``LogisticRegressionOutput``, ``MAERegressionOutput``, ``SVMOutput``),
each a ``torch.autograd.Function`` whose backward is the JAX op's custom
gradient, which ignores the head gradient; and the legacy ops
``IdentityAttachKLSparseReg`` (``:691-721``, the identity with JAX's
KL-sparsity gradient) and ``_CrossDeviceCopy`` / ``CrossDeviceCopy``
(``:724``, the identity).

Each op is plain PyTorch (``F.conv*d``, ``F.*pool*d``, elementwise
arithmetic), as the JAX package leaves them to XLA, and its gradient is
torch autograd's.  Layouts follow the JAX ops: ``layout=None`` or
``NC*`` puts the channels on axis 1, ``N*C`` on the last axis, with the
weight in the reference's ``(O, I, *kernel)`` layout either way; a
channels-last input is convolved as a permuted view.  The BatchNorm-like
ops return ``(out, mean, var)`` and do not touch the moving statistics:
``ndarray.invoke`` folds them, as the JAX front end does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .collective import all_reduce_flat, dp_group
from .fused_conv import bn_stats
from .reduce import _int_result
from .registry import register_op

__all__ = ["channels_last", "convolution", "fused_batch_norm_relu"]


@register_op("FullyConnected", aliases=("fully_connected",))
def _fully_connected(data, weight, bias=None, *, num_hidden=None,
                     no_bias=False, flatten=True):
    """Y = X W^T + b (reference src/operator/nn/fully_connected-inl.h)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": lambda x: F.softplus(_float(x)),
    "softsign": lambda x: x / (torch.abs(x) + 1),
    # extension beyond the reference; jax.nn.gelu's default is the tanh
    # approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


@register_op("Activation", aliases=("activation",))
def _activation(data, *, act_type):
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown act_type {act_type}")
    return _ACTIVATIONS[act_type](data)


def _float(x, dtype=torch.float32):
    """An integer array as float32 (or ``dtype``), as JAX promotes it."""
    return x if x.is_floating_point() else x.to(dtype)


@register_op("softmax")
def _softmax(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else _float(data)
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def _log_softmax(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else _float(data)
    return torch.log_softmax(x, dim=axis)


@register_op("softmin")
def _softmin(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else _float(data)
    return torch.softmax(-x, dim=axis)


@register_op("SoftmaxActivation")
def _softmax_activation(data, *, mode="instance"):
    """Softmax over the channels (axis 1, ``mode="channel"``) or over all
    of an instance's values."""
    data = _float(data)
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@register_op("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """Scalar cross entropy of softmax(data) against integer labels,
    shape (1,): -sum over the batch of log(max(softmax(x)[i, label_i],
    1e-8)) (reference loss_binary_op-inl.h:51)."""
    if data.ndim != 2 or label.ndim != 1:
        raise ValueError("softmax_cross_entropy expects 2D data and 1D "
                         "label")
    p = torch.softmax(data, dim=-1)
    picked = torch.gather(p, 1, label.long()[:, None])[:, 0]
    return -torch.sum(torch.log(torch.clamp(picked, min=1e-8))).reshape(1)


class _FusedBatchNormRelu(torch.autograd.Function):
    """BatchNorm + ReLU with the JAX package's bandwidth-lean backward
    (``ops/nn.py`` ``_bn_relu_core``).  The forward normalises to
    ``xhat = (x - mean) * inv`` in x's dtype and saves only ``xhat``
    and the per-channel ``inv``, ``g`` and ``beta``; the backward
    recomputes the ReLU mask as ``g*xhat + beta > 0`` and writes dx from
    ``xhat`` and dy alone, so it reads one full tensor fewer than
    autograd of BatchNorm then ReLU (which saves x and the ReLU output).
    The reductions of the backward run in fp32, as the reference's.
    Inside a data-parallel mesh step (``ops.collective.dp_sync``) the
    statistics are the global batch's, and the backward sums its two
    per-channel reductions and their count over the ``dp`` group too."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mmean, mvar, eps, fix_gamma,
                train_stats):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train_stats:
            mean32, var32 = bn_stats(x)
        else:
            mean32, var32 = mmean.float(), mvar.float()
        inv = torch.rsqrt(var32 + eps).to(x.dtype)
        mean = mean32.to(x.dtype)
        g = torch.ones_like(gamma) if fix_gamma else gamma
        xhat = (x - mean.view(shape)).mul_(inv.view(shape))
        y = (xhat * g.view(shape)).add_(beta.view(shape)).relu_()
        ctx.set_materialize_grads(False)
        ctx.cfg = (eps, fix_gamma, train_stats)
        ctx.group = dp_group() if train_stats else None
        ctx.save_for_backward(xhat, inv, g, beta)
        return y, mean, var32.to(x.dtype)

    @staticmethod
    def backward(ctx, dy, ct_mean, ct_var):
        xhat, inv, g, beta = ctx.saved_tensors
        eps, fix_gamma, train_stats = ctx.cfg
        shape = (1, -1) + (1,) * (xhat.dim() - 2)
        red = (0,) + tuple(range(2, xhat.dim()))
        if dy is None:
            dy = torch.zeros_like(xhat)
        mask = (xhat * g.view(shape)).add_(beta.view(shape)) > 0
        dz = torch.where(mask, dy, 0)
        dz32, xhat32 = dz.float(), xhat.float()
        sum_dz = dz32.sum(red)
        sum_dzxh = (dz32 * xhat32).sum(red)
        dbeta = sum_dz.to(beta.dtype)
        dgamma = torch.zeros_like(g) if fix_gamma else sum_dzxh.to(g.dtype)
        if not train_stats:
            # the (mean, var) outputs pass the moving statistics through
            dx = (dz * g.view(shape) * inv.view(shape)).to(xhat.dtype)
            return dx, dgamma, dbeta, ct_mean, ct_var, None, None, None
        m = xhat.numel() // xhat.shape[1]
        if ctx.group is not None:
            # the statistics were the global batch's: so are the sums
            # that carry the gradient through them, and their count
            sums = [sum_dz, sum_dzxh] + [
                c.float() for c in (ct_mean, ct_var) if c is not None]
            sums.append(torch.full((1,), m, dtype=torch.float32,
                                   device=sum_dz.device))
            sums = all_reduce_flat(sums, ctx.group)
            sum_dz, sum_dzxh, m = sums[0], sums[1], sums[-1]
            if ct_mean is not None:
                ct_mean = sums[2]
            if ct_var is not None:
                ct_var = sums[-2]
        inv32 = inv.float().view(shape)
        dx32 = torch.addcmul(dz32 - (sum_dz / m).view(shape), xhat32,
                             (sum_dzxh / m).view(shape), value=-1.0)
        dx32 = dx32 * (g.float().view(shape) * inv32)
        # cotangents on the (mean, var) outputs: mean = sum(x)/m gives
        # ct_mean/m; var = E[x^2] - mean^2 (clamped at 0) gives
        # ct_var * 2(x - mean)/m where the clamp was not active, and
        # x - mean = xhat / inv
        if ct_mean is not None:
            dx32 = dx32 + ct_mean.float().view(shape) / m
        if ct_var is not None:
            var_pos = (inv32 * inv32 * eps < 1.0).float()
            dx32 = dx32 + ct_var.float().view(shape) * var_pos * 2.0 * \
                xhat32 / (inv32 * m)
        return (dx32.to(xhat.dtype), dgamma, dbeta, None, None, None, None,
                None)


def fused_batch_norm_relu(x, gamma, beta, mmean, mvar, eps=1e-5,
                          fix_gamma=False, train_stats=True):
    """``relu(BatchNorm(x))`` as one op, the JAX package's
    ``_FusedBatchNormRelu``: returns ``(y, mean, var)``, the statistics
    in x's dtype, the batch's (``bn_stats``, the single-pass fp32
    formula that ``BatchNorm`` uses) with ``train_stats``, else the
    moving ones passed through.  The channel axis is dim 1, as in the
    port's NCHW-indexed tensors (channels-last or not).  The forward
    is ``relu((x - mean) * rsqrt(var + eps) * gamma + beta)`` in x's
    dtype (gamma taken as 1 when ``fix_gamma``); the backward is the
    reference's lean one (``_FusedBatchNormRelu`` above), plain PyTorch
    as the reference's is XLA: no hand-written kernel.  The moving
    statistics are not updated here (the caller does that, as the JAX
    front end does)."""
    return _FusedBatchNormRelu.apply(x, gamma, beta, mmean, mvar,
                                     float(eps), bool(fix_gamma),
                                     bool(train_stats))


@register_op("_FusedBatchNormRelu", num_outputs=3)
def _fused_batch_norm_relu_op(data, gamma, beta, moving_mean, moving_var, *,
                              eps=1e-3, momentum=0.9, fix_gamma=True,
                              use_global_stats=False, output_mean_var=False,
                              axis=1, cudnn_off=False, is_train=True):
    """``relu(BatchNorm(data))`` as one op: ``(out, mean, var)`` as
    ``BatchNorm`` returns them, by ``fused_batch_norm_relu`` with the
    channel axis moved to dim 1 (a view)."""
    ax = axis % data.ndim
    y, mean, var = fused_batch_norm_relu(
        data.movedim(ax, 1), gamma, beta, moving_mean, moving_var, eps,
        fix_gamma, bool(is_train) and not use_global_stats)
    return y.movedim(1, ax), mean, var


# ------------------------------------------------------------- layouts
def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def channels_last(layout):
    """True for a channels-last layout (``NWC``, ``NHWC``, ``NDHWC``)."""
    return layout is not None and layout[-1] == "C"


def _first(x, layout):
    """``x`` with its channels on axis 1: a permuted view of
    channels-last data."""
    return x.movedim(-1, 1) if channels_last(layout) else x


def _back(x, layout):
    """The inverse of ``_first``."""
    return x.movedim(1, -1) if channels_last(layout) else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


# ------------------------------------------------------------- Convolution
@register_op("Convolution", aliases=("convolution", "Convolution_v1"))
def convolution(data, weight, bias=None, *, kernel, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None, workspace=1024, cudnn_tune=None,
                cudnn_off=False):
    """N-D convolution (reference src/operator/nn/convolution-inl.h):
    weight ``(O, I/groups, *kernel)`` in every layout, symmetric
    ``pad``, ``F.conv{1,2,3}d``."""
    n = len(kernel)
    pad = _tup(pad, n) if pad is not None else (0,) * n
    out = _CONV[n](_first(data, layout), weight,
                   None if no_bias else bias, _tup(stride, n), pad,
                   _tup(dilate, n), num_group)
    return _back(out, layout)


@register_op("Deconvolution", aliases=("deconvolution",))
def _deconvolution(data, weight, bias=None, *, kernel, stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_filter=None, num_group=1, no_bias=True, layout=None,
                   workspace=1024, cudnn_tune=None, cudnn_off=False):
    """Transposed convolution (reference src/operator/nn/
    deconvolution-inl.h): weight ``(I, O/groups, *kernel)``, output
    ``(in - 1) * stride - 2 * pad + dilate * (kernel - 1) + 1 + adj``;
    ``target_shape`` is ignored, as in the JAX op."""
    n = len(kernel)
    pad = _tup(pad, n) if pad is not None else (0,) * n
    adj = _tup(adj, n) if adj is not None else (0,) * n
    out = _DECONV[n](_first(data, layout), weight,
                     None if no_bias else bias, _tup(stride, n), pad, adj,
                     num_group, _tup(dilate, n))
    return _back(out, layout)


# ------------------------------------------------------------- Pooling
def _sum_pool(x, kernel, stride):
    """Window sums (average pooling with divisor 1)."""
    if x.ndim == 3:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register_op("Pooling", aliases=("pooling", "Pooling_v1"))
def _pooling(data, *, kernel=(), pool_type="max", global_pool=False,
             stride=None, pad=None, pooling_convention="valid",
             count_include_pad=True, cudnn_off=False, layout=None):
    """Max / avg / sum pooling (reference src/operator/nn/pooling-inl.h).
    The padding is explicit, as the JAX op's ``reduce_window`` has it:
    ``-inf`` for max and zeros for avg/sum, and with
    ``pooling_convention="full"`` extra padding on the high side so that
    ``ceil((x + 2p - k) / s) + 1`` windows fit; ``avg`` divides by the
    kernel size, or by the count of real elements without
    ``count_include_pad``."""
    x = _first(data, layout)
    n = x.ndim - 2
    spatial = tuple(range(2, x.ndim))
    if global_pool:
        if pool_type == "max":
            out = torch.amax(x, dim=spatial, keepdim=True)
        elif pool_type == "sum":
            out = x.sum(spatial, keepdim=True).to(_int_result(x))
        else:
            out = _float(x).mean(spatial, keepdim=True)
        return _back(out, layout)
    kernel, stride = _tup(kernel, n), _tup(stride, n)
    pad = _tup(pad, n) if pad is not None else (0,) * n
    widths = []
    for i in reversed(range(n)):
        extra = 0
        if pooling_convention == "full":
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra = (stride[i] - rem) % stride[i] if rem else 0
        widths += [pad[i], pad[i] + extra]
    if pool_type == "max":
        fill = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = _MAXPOOL[n](F.pad(x, widths, value=fill), kernel, stride)
        return _back(out, layout)
    # torch pools no integers: their window sums run in float64 (exact
    # below 2**53) and come back to x's dtype, as the JAX op's int sums
    summed = _sum_pool(F.pad(_float(x, torch.float64), widths), kernel,
                       stride).to(x.dtype)
    if pool_type == "sum":
        out = summed
    elif count_include_pad:
        out = _float(summed) / float(np.prod(kernel))
    else:
        out = _float(summed) / _float(_sum_pool(
            F.pad(torch.ones_like(_float(x)), widths), kernel, stride))
    return _back(out, layout)


# ------------------------------------------------------------- LeakyReLU
_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register_op("LeakyReLU")
def _leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """leaky / prelu / elu / selu (reference src/operator/
    leaky_relu-inl.h); rrelu takes its eval-time slope, the mean of its
    bounds, as in the JAX op."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if data.ndim > 2 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(data > 0, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "rrelu":
        s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise ValueError(f"unknown act_type {act_type}")


# ------------------------------------------------------------- normalization
def _rsqrt(x):
    """rsqrt rounded once to x's dtype, as XLA's (torch's bf16 rsqrt on
    the CPU rounds the sqrt first)."""
    return torch.rsqrt(x.float()).to(x.dtype)


@register_op("BatchNorm", aliases=("batch_norm", "BatchNorm_v1"),
             num_outputs=3)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                is_train=True):
    """``(out, mean, var)``: the batch's statistics (``bn_stats``, fp32,
    then in data's dtype) in training, else the moving ones, and
    ``(data - mean) * rsqrt(var + eps) * gamma + beta`` in data's dtype
    (gamma taken as 1 with ``fix_gamma``), the JAX op's formula.  The
    front end folds the moving statistics."""
    ax = axis % data.ndim
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    if use_global_stats or not is_train:
        mean, var = moving_mean, moving_var
    else:
        mean32, var32 = bn_stats(data.movedim(ax, 1))
        mean, var = mean32.to(data.dtype), var32.to(data.dtype)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = _rsqrt(var + eps)
    out = (data - mean.reshape(shape)) * inv.reshape(shape) * \
        g.reshape(shape) + beta.reshape(shape)
    return out, mean, var


@register_op("InstanceNorm")
def _instance_norm(data, gamma, beta, *, eps=1e-3):
    red = tuple(range(2, data.ndim))
    mean = data.mean(red, keepdim=True)
    var = data.var(red, unbiased=False, keepdim=True)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * _rsqrt(var + eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


@register_op("LayerNorm")
def _layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5,
                output_mean_var=False):
    ax = axis % data.ndim
    mean = data.mean(ax, keepdim=True)
    var = data.var(ax, unbiased=False, keepdim=True)
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    return (data - mean) * _rsqrt(var + eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


@register_op("L2Normalization")
def _l2_normalization(data, *, eps=1e-10, mode="instance"):
    if mode == "instance":
        norm = torch.sqrt(data.reshape(data.shape[0], -1).square().sum(1) +
                          eps)
        return data / norm.reshape((-1,) + (1,) * (data.ndim - 1))
    if mode == "channel":
        return data / torch.sqrt(data.square().sum(1, keepdim=True) + eps)
    if mode == "spatial":
        # a 2-D input has no spatial axis: each element is its own group
        red = tuple(range(2, data.ndim))
        sq = data.square().sum(red, keepdim=True) if red else data.square()
        return data / torch.sqrt(sq + eps)
    raise ValueError(mode)


@register_op("LRN", aliases=("lrn",))
def _lrn(data, *, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalisation across channels (axis 1 of NCHW)."""
    half = nsize // 2
    sq = F.pad(data.square(), (0, 0, 0, 0, half, half))
    windows = sum(sq[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha * windows / nsize, beta)


# ------------------------------------------------------------- dropout
@register_op("Dropout", aliases=("dropout",), needs_rng=True)
def _dropout(generator, data, *, p=0.5, mode="training", axes=(),
             is_train=True):
    """Inverted dropout in training (identity otherwise): a keep mask
    drawn from the device's generator, shared along ``axes``.  The
    mask's bits differ from the JAX package's keys."""
    if not is_train or p <= 0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return data * mask.to(data.dtype) / keep


# ------------------------------------------------------------- Pad
def _pad_index(n, before, after, mode, device):
    """Source indices of a padded axis of length ``n``: numpy's
    ``edge`` (clamped) or ``reflect`` (mirrored without repeating the
    edge, periodic for any width)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register_op("Pad", aliases=("pad",))
def _pad(data, *, mode="constant", pad_width, constant_value=0.0):
    """Pad every axis by ``pad_width`` (before, after pairs, axis by
    axis): ``constant``, ``edge`` or ``reflect``, as ``jnp.pad``."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(data.ndim)]
    if mode == "constant":
        flat = [w for pair in reversed(pw) for w in pair]
        return F.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError(mode)
    out = data
    for ax, (before, after) in enumerate(pw):
        if before or after:
            out = torch.index_select(out, ax, _pad_index(
                data.shape[ax], before, after, mode, data.device))
    return out


@register_op("UpSampling")
def _upsampling(*args, scale, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest upsampling by ``scale`` on H and W of NCHW inputs (several
    inputs brought to the largest size, then concatenated on the
    channels or summed), or bilinear (half-pixel centres, the edge
    samples clamped: ``jax.image.resize``'s values when enlarging)."""
    if sample_type != "nearest":
        return F.interpolate(args[0], scale_factor=scale, mode="bilinear",
                             align_corners=False)

    def nearest(x, s):
        return x.repeat_interleave(s, 2).repeat_interleave(s, 3)

    outs = [nearest(d, scale) for d in args]
    if len(outs) == 1:
        return outs[0]
    h = max(o.shape[2] for o in outs)
    outs = [o if o.shape[2] == h else nearest(o, h // o.shape[2])
            for o in outs]
    if multi_input_mode == "sum":
        return sum(outs)
    return torch.cat(outs, 1)


# ------------------------------------------------------------- sequences
# data is (T, N, ...) on axis=0 or (N, T, ...) on axis=1; the lengths are
# (N,), float or integer
@register_op("SequenceMask")
def _sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                   value=0.0, axis=0):
    """``value`` at the steps at or past each sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    mask = pos[:, None] < sequence_length.long()[None, :]      # (T, N)
    if axis == 1:
        mask = mask.t()
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register_op("SequenceLast")
def _sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step (the last step without lengths)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = sequence_length.long() - 1
    if axis == 0:
        return data[idx, torch.arange(data.shape[1], device=data.device)]
    return data[torch.arange(data.shape[0], device=data.device), idx]


@register_op("SequenceReverse")
def _sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                      axis=0):
    """The steps reversed, each sequence within its own length (the steps
    past it stay in place); with lengths the time axis is 0, as in the
    JAX op."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    sl = sequence_length.long()[None, :]
    src = torch.where(pos < sl, sl - 1 - pos, pos)               # (T, N)
    src = src.reshape(src.shape + (1,) * (data.ndim - 2))
    return torch.take_along_dim(data, src.expand(data.shape), dim=0)


# ------------------------------------------------------------- output layers
def _class_onehot(label, depth, axis, dtype):
    """one_hot(label) with the classes on ``axis`` of the result; a label
    outside ``[0, depth)`` gives a row of zeros (``jax.nn.one_hot``)."""
    lbl = label.to(torch.int64).unsqueeze(axis)
    shape = [1] * lbl.dim()
    shape[axis] = depth
    classes = torch.arange(depth, device=label.device).view(shape)
    return (lbl == classes).to(dtype)


def _softmax_output_fwd(data, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """softmax forward; backward ``p - onehot(label)``, ignoring the head
    gradient (the JAX op's ``custom_vjp``, reference
    softmax_output-inl.h:Backward), scaled by ``grad_scale`` and the
    ``normalization``; the label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, preserve_shape, normalization):
        out = _softmax_output_fwd(data, multi_output, preserve_shape)
        ctx.cfg = (grad_scale, ignore_label, multi_output, use_ignore,
                   normalization)
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, multi_output, use_ignore, \
            normalization = ctx.cfg
        axis = 1 if multi_output else out.dim() - 1
        grad = out - _class_onehot(label, out.shape[axis], axis, out.dtype)
        keep = None
        if use_ignore:
            keep = (label.to(torch.int64) != int(ignore_label)).to(
                out.dtype)
            grad = grad * keep.unsqueeze(axis)
        grad = grad * grad_scale
        if normalization == "batch":
            grad = grad / label.shape[0]
        elif normalization == "valid" and keep is not None:
            grad = grad / torch.clamp(keep.sum(), min=1.0)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, dlabel, None, None, None, None, None, None


@register_op("SoftmaxOutput", aliases=("Softmax", "softmax_output"))
def _softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """softmax of ``data`` (over the flattened features, axis 1 with
    ``multi_output``, the last axis with ``preserve_shape``) whose
    gradient is ``p - onehot(label)`` (``_SoftmaxOutput``)."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(multi_output),
                                bool(use_ignore), bool(preserve_shape),
                                normalization)


class _RegressionOutput(torch.autograd.Function):
    """``fwd(pred)``; backward ``gradfn(fwd(pred), label) * grad_scale /
    pred.shape[1]`` (``shape[0]`` for 1-D), ignoring the head gradient,
    as the JAX op divides (``ops/nn.py`` ``_make_regression_output``)."""

    @staticmethod
    def forward(ctx, pred, label, fwd, gradfn, grad_scale):
        ctx.cfg = (fwd, gradfn, grad_scale)
        ctx.save_for_backward(pred, label)
        return fwd(pred)

    @staticmethod
    def backward(ctx, g):
        pred, label = ctx.saved_tensors
        fwd, gradfn, grad_scale = ctx.cfg
        n = pred.shape[1 if pred.dim() > 1 else 0]
        grad = gradfn(fwd(pred), label.reshape(pred.shape)) * grad_scale / n
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, dlabel, None, None, None


def _make_regression_output(name, fwd, gradfn):
    def op(data, label, *, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, fwd, gradfn,
                                       float(grad_scale))
    op.__name__ = name
    op.__doc__ = (f"{name}: the identity (sigmoid for the logistic "
                  "output) with the regression gradient "
                  "(``_RegressionOutput``).")
    register_op(name, op)


# reference src/operator/regression_output.cc: grad = out - label
# (linear), sigmoid(out) - label (logistic), sign(out - label) (MAE)
_make_regression_output("LinearRegressionOutput", lambda x: x,
                        lambda o, lbl: o - lbl)
_make_regression_output("LogisticRegressionOutput", torch.sigmoid,
                        lambda o, lbl: o - lbl)
_make_regression_output("MAERegressionOutput", lambda x: x,
                        lambda o, lbl: torch.sign(o - lbl))


class _SVMOutput(torch.autograd.Function):
    """The identity whose gradient is the (squared, or linear with
    ``use_linear``) hinge loss's, ignoring the head gradient (the JAX
    op's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.cfg = (margin, reg, use_linear)
        ctx.save_for_backward(data, label)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        lbl = label.to(torch.int64)
        onehot = _class_onehot(label, d.shape[1], 1, d.dtype)
        score_true = torch.gather(d, 1, lbl[:, None])
        slack = margin - (score_true - d)
        if use_linear:
            grad = (slack > 0).to(d.dtype) * reg
        else:
            grad = 2 * torch.clamp(slack, min=0) * reg
        grad = grad * (1 - onehot)
        grad = grad + onehot * -grad.sum(1, keepdim=True)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad.to(d.dtype), dlabel, None, None, None


@register_op("SVMOutput")
def _svm_output(data, label, *, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


class _KLSparseReg(torch.autograd.Function):
    """The identity whose backward adds ``penalty * dKL(rho ||
    rho_hat) / d act / n`` to the head gradient, ``rho_hat`` the current
    batch's mean activation clipped to ``[1e-6, 1 - 1e-6]`` (the JAX
    op's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, data, rho, penalty):
        ctx.cfg = (rho, penalty)
        ctx.save_for_backward(data)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        rho, penalty = ctx.cfg
        rho_hat = torch.clamp(data.mean(0), 1e-6, 1 - 1e-6)
        kl = penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + kl.unsqueeze(0) / data.shape[0], None, None


@register_op("IdentityAttachKLSparseReg")
def _identity_attach_kl_sparse_reg(data, *, sparseness_target=0.1,
                                   penalty=0.001, momentum=0.9):
    """Identity forward with a KL-sparsity gradient (reference
    identity_attach_KL_sparse_reg.cc).  As in the JAX op, ``rho_hat`` is
    the current batch's mean, not a moving average: ``momentum`` is
    accepted and ignored."""
    return _KLSparseReg.apply(data, float(sparseness_target),
                              float(penalty))


@register_op("_CrossDeviceCopy", aliases=("CrossDeviceCopy",))
def _cross_device_copy(data):
    """The identity (reference cross_device_copy.cc; the JAX op keeps
    old graph JSON loadable the same way)."""
    return data
