"""Image operators of the ``mx.nd.image`` namespace (counterpart of
``incubator_mxnet_tpu/ops/image_ops.py``; reference
src/operator/image/image_random.cc).

Every op of the JAX file, each under its ``_image_`` name and its short
alias: ``to_tensor``, ``normalize``, the flips and their random forms,
brightness, contrast, saturation, hue (the YIQ rotation), color jitter
and PCA lighting.  They run on the array's device.  A random op draws
from the device's generator (``needs_rng``), one factor (or one coin)
per call for the whole batch, as the JAX ops draw one per key, and
stays on the device: the coin picks the flipped or the plain image by
``torch.where``, with no host sync.

Layouts are HWC for one image and NHWC for a batch, channels last, as
the colour ops and the reference have them.  The flips follow MXNet's
rule: ``flip_left_right`` reverses the width (axis -2),
``flip_top_bottom`` the height (axis -3).  The JAX ops reverse the last
axis for left-right (the channels of an HWC image) and, on a 4-D batch,
the width for top-bottom (reference caveat, ROADMAP §C).
"""
from __future__ import annotations

import math

import torch

from .registry import register_op

__all__ = []

_YIQ = ((0.299, 0.587, 0.114),
        (0.596, -0.274, -0.321),
        (0.211, -0.523, 0.311))
_RGB = ((1.0, 0.956, 0.621),
        (1.0, -0.272, -0.647),
        (1.0, -1.107, 1.705))
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))


@register_op("_image_to_tensor", aliases=("to_tensor",))
def _to_tensor(data):
    """(H, W, C) or (B, H, W, C) in [0, 255] -> (C, H, W) or (B, C, H,
    W) float32 in [0, 1]."""
    # a true division (0-d tensor divisor): the card divides by a Python
    # scalar as a product with its reciprocal, a rounding off the CPU's
    x = data.to(torch.float32) / torch.full((), 255.0, device=data.device)
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register_op("_image_normalize", aliases=("image_normalize",))
def _normalize(data, *, mean=(0.0,), std=(1.0,)):
    """Channel-wise ``(x - mean) / std`` on (C, H, W) or (B, C, H, W)."""
    m = torch.tensor(mean, dtype=data.dtype, device=data.device)
    s = torch.tensor(std, dtype=data.dtype, device=data.device)
    return (data - m.reshape(-1, 1, 1)) / s.reshape(-1, 1, 1)


def _flip_lr(data):
    return data.flip(-2)


def _flip_tb(data):
    return data.flip(-3)


register_op("_image_flip_left_right", _flip_lr,
            aliases=("flip_left_right",))
register_op("_image_flip_top_bottom", _flip_tb,
            aliases=("flip_top_bottom",))


def _coin(gen):
    return torch.rand((), generator=gen, device=gen.device) < 0.5


@register_op("_image_random_flip_left_right",
             aliases=("random_flip_left_right",), needs_rng=True)
def _random_flip_lr(gen, data):
    return torch.where(_coin(gen), _flip_lr(data), data)


@register_op("_image_random_flip_top_bottom",
             aliases=("random_flip_top_bottom",), needs_rng=True)
def _random_flip_tb(gen, data):
    return torch.where(_coin(gen), _flip_tb(data), data)


def _factor(gen, lo, hi):
    """One uniform draw in ``[lo, hi)``: a 0-d float32 tensor."""
    u = torch.rand((), generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def _blend(a, b, alpha):
    return a * alpha + b * (1.0 - alpha)


def _grayscale(hwc):
    """The luma of the last axis (kept as an axis of 1) when it holds 3
    channels; otherwise the input."""
    if hwc.shape[-1] != 3:
        return hwc
    w = torch.tensor((0.299, 0.587, 0.114), dtype=hwc.dtype,
                     device=hwc.device)
    return (hwc * w).sum(-1, keepdim=True)


def _contrast(data, f):
    return _blend(data, _grayscale(data).mean().expand(data.shape), f)


def _saturation(data, f):
    return _blend(data, _grayscale(data).expand(data.shape), f)


def _hue(data, f):
    """The YIQ hue rotation by ``(f - 1) * pi``."""
    theta = (f - 1.0) * math.pi
    u, w = torch.cos(theta), torch.sin(theta)

    def mat(rows):
        return torch.tensor(rows, dtype=data.dtype, device=data.device)

    rot = mat(((1, 0, 0), (0, 0, 0), (0, 0, 0))) + \
        u * mat(((0, 0, 0), (0, 1, 0), (0, 0, 1))) + \
        w * mat(((0, 0, 0), (0, 0, -1), (0, 1, 0)))
    m = mat(_RGB) @ rot.to(data.dtype) @ mat(_YIQ)
    return torch.einsum("...c,dc->...d", data, m)


@register_op("_image_random_brightness", aliases=("random_brightness",),
             needs_rng=True)
def _random_brightness(gen, data, *, min_factor=0.5, max_factor=1.5):
    return data * _factor(gen, min_factor, max_factor)


@register_op("_image_random_contrast", aliases=("random_contrast",),
             needs_rng=True)
def _random_contrast(gen, data, *, min_factor=0.5, max_factor=1.5):
    return _contrast(data, _factor(gen, min_factor, max_factor))


@register_op("_image_random_saturation", aliases=("random_saturation",),
             needs_rng=True)
def _random_saturation(gen, data, *, min_factor=0.5, max_factor=1.5):
    return _saturation(data, _factor(gen, min_factor, max_factor))


@register_op("_image_random_hue", aliases=("random_hue",), needs_rng=True)
def _random_hue(gen, data, *, min_factor=0.9, max_factor=1.1):
    return _hue(data, _factor(gen, min_factor, max_factor))


@register_op("_image_random_color_jitter", aliases=("random_color_jitter",),
             needs_rng=True)
def _random_color_jitter(gen, data, *, brightness=0.0, contrast=0.0,
                         saturation=0.0, hue=0.0):
    """Brightness, contrast, saturation and hue, each with its own
    factor in ``[1 - x, 1 + x)``, in that order; an amount of 0 skips
    its step."""
    if brightness > 0:
        data = data * _factor(gen, 1 - brightness, 1 + brightness)
    if contrast > 0:
        data = _contrast(data, _factor(gen, 1 - contrast, 1 + contrast))
    if saturation > 0:
        data = _saturation(data, _factor(gen, 1 - saturation,
                                         1 + saturation))
    if hue > 0:
        data = _hue(data, _factor(gen, 1 - hue, 1 + hue))
    return data


@register_op("_image_random_lighting", aliases=("random_lighting",),
             needs_rng=True)
def _random_lighting(gen, data, *, alpha_std=0.05):
    """AlexNet's PCA lighting noise: one ``alpha ~ N(0, alpha_std)`` per
    eigenvector, the same RGB offset for the whole batch."""
    alpha = torch.randn(3, generator=gen, device=gen.device) * alpha_std
    eigval = torch.tensor(_EIGVAL, dtype=data.dtype, device=data.device)
    eigvec = torch.tensor(_EIGVEC, dtype=data.dtype, device=data.device)
    return data + (eigvec * alpha * eigval).sum(1)
