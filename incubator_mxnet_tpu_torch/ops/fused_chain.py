"""The whole bottleneck interior [BN1 -> ReLU -> conv2 3x3 -> BN2 -> ReLU
-> conv3 1x1] as one op: the two hand-written Hopper kernels of its two
passes, their plain versions, and the op.

Port of ``incubator_mxnet_tpu/ops/fused_chain.py``.  BN2's batch
statistics need all of conv2's output before any of it can be
normalised, so the chain runs as two passes over the saved conv1 output
``c1``, with conv2 computed in both:

* pass 1, ``chain_stats`` (TPU ``_chain_kernel`` with ``emit=False``,
  now ``csrc/chain_stats.cu``): BN1 affine + ReLU, conv2, and the
  per-channel sums of ``(c2 - s)`` and ``(c2 - s)^2`` with ``s`` BN2's
  moving mean.  Only those two ``(Cm,)`` vectors leave the kernel.
* glue (torch, as it is XLA there): mean2 / var2 from the sums, BN2's
  affine.
* pass 2, ``chain_emit`` (TPU ``_chain_kernel`` with ``emit=True``, now
  ``csrc/chain_emit.cu``): conv2 again, BN2 affine + ReLU on chip, the
  conv3 1x1 plus bias.  Only the block output is written.

In eval the statistics are the moving ones and pass 1 is skipped.

* Two forms, as in ``ops.fused_conv``: fp32, and bf16 c1, w2, w3 and
  output (the affines, the shift, b3 and the sums fp32).  The bf16 form
  is the Pallas kernel's arithmetic: conv2 of the bf16-rounded
  activation summed in fp32 and never rounded (pass 1 reduces it, pass
  2 applies BN2 to it in fp32), ``relu(c2*a2 + b2)`` rounded to bf16
  before conv3, conv3 summed in fp32 plus b3, rounded to bf16 once.
  The plain composition ``_chain_plain`` (the JAX ``xla_forward``, the
  backward's source) rounds c2 to bf16 instead; the two forms differ
  by that rounding.

* Layout as in ``ops.fused_conv``: NCHW-indexed tensors, channels-last
  in memory; w2 ``(Cm, C, 3, 3)`` channels-last (read as OHWI), w3
  ``(Co, Cm, 1, 1)`` (read as ``(Co, Cm)`` rows).
* A CUDA tensor goes to the kernel or raises; a CPU tensor to the plain
  version (``_chain_stats_plain``, ``_chain_emit_plain``), which keeps
  the shift as the kernel does.  ``chain_stats.launches`` and
  ``chain_emit.launches`` count launches.
* ``fused_bottleneck_chain`` is a ``torch.autograd.Function`` whose
  backward is autograd of the plain composition (``_chain_plain``, the
  JAX ``xla_forward``) re-run from the saved inputs, as the JAX op's
  ``custom_vjp`` backward is: the JAX package has no backward kernel.
* ``chain_supported`` is the kernels' envelope, decided from a layer's
  configuration.
* The registry op ``_FusedBottleneckChain`` (``nd.
  _FusedBottleneckChain``) takes the JAX op's arguments (NHWC data)
  and returns ``(out, mean1, var1, mean2, var2)`` in the data's dtype,
  the front end folding both pairs of moving statistics: NHWC data
  inside ``chain_supported`` goes to ``fused_bottleneck_chain`` on its
  NCHW-indexed view (the kernels on the card), anything else to the
  plain composition ``_chain_plain``, as the JAX op runs its XLA one.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..base import MXNetError
from .collective import dp_all_reduce_sum, dp_group, dp_sync
from .fused_conv import (_INDEX_LIMIT, _activate, _dispatch, bn_affine,
                         bn_coefficients, check_dtypes, count_launch, launch,
                         recompute_vjp)
from .registry import register_op

__all__ = ["CHAIN_MAX_CM", "CHAIN_MAX_CM_BF16", "chain_emit", "chain_stats",
           "chain_supported", "fused_bottleneck_chain"]

# the widest conv2 output whose y2 tile (48 rows of Cm elements, padded)
# fits chain_emit's 227 KB of shared memory beside its operand ring: in
# the fp32 form and in the bf16 one
CHAIN_MAX_CM, CHAIN_MAX_CM_BF16 = 768, 1536
_MAX_CM = {torch.float32: CHAIN_MAX_CM, torch.bfloat16: CHAIN_MAX_CM_BF16}


def chain_supported(mid_channels, layout="NHWC", dtype=torch.float32):
    """The chain kernels' envelope, decided from a layer's
    configuration: channels-last (``layout="NHWC"``), fp32 or bf16, and
    at most ``CHAIN_MAX_CM`` (fp32) or ``CHAIN_MAX_CM_BF16`` conv2
    output channels (ResNet-50's widest is 512).  The geometry (3x3 stride-1 pad-1 ungrouped conv2,
    1x1 conv3 with bias) is the layer's structure, checked where it is
    built."""
    return layout == "NHWC" and dtype in _MAX_CM and \
        0 < mid_channels <= _MAX_CM[dtype]


def _conv2(x, a1, b1, w2):
    """conv2 of relu(x*a1 + b1), zero padding after the activation, in
    x's dtype (the plain composition's form)."""
    return F.conv2d(_activate(x, a1, b1), w2.to(x.dtype), padding=1)


def _conv2_sums(x, a1, b1, w2):
    """conv2 as the kernels compute it: relu(x*a1 + b1) rounded to x's
    dtype, convolved with w2 in fp32 (a bf16 x bf16 product is exact in
    fp32); the fp32 sums, not rounded to x's dtype."""
    return F.conv2d(_activate(x, a1, b1).float(), w2.float(), padding=1)


def _chain_stats_plain(x, a1, b1, w2, shift):
    """Plain version of pass 1: ``(sum, sq)`` over (N, H, W) of
    ``c2 - shift`` and its square, fp32, c2 as the kernel computes it
    (``_conv2_sums``)."""
    d = _conv2_sums(x, a1, b1, w2) - shift.float().view(1, -1, 1, 1)
    return d.sum((0, 2, 3)), d.square().sum((0, 2, 3))


def _chain_emit_plain(x, a1, b1, w2, a2, b2, w3, b3):
    """Plain version of pass 2, in its arithmetic: ``relu(c2*a2 + b2)``
    of the fp32 c2 (``_conv2_sums``) rounded to x's dtype, then
    ``conv1x1(., w3) + b3`` in fp32, rounded to x's dtype once."""
    y2 = _activate(_conv2_sums(x, a1, b1, w2), a2, b2).to(x.dtype)
    return F.conv2d(y2.float(), w3.float(), b3.float()).to(x.dtype)


def _check(name, x, vectors, w2, w3=None):
    """The kernels' contract on CUDA tensors; raises on anything else.
    ``vectors``: ``{name: (tensor, length)}`` of the per-channel inputs."""
    if x.dim() != 4:
        raise MXNetError(f"{name}: c1 must be 4-D (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    cm = w2.shape[0]
    co = 0 if w3 is None else w3.shape[0]
    grids = {"c1": (x, (n, c, h, w)), "w2": (w2, (cm, c, 3, 3))}
    if w3 is not None:
        grids["w3"] = (w3, (co, cm, 1, 1))
    flat = {k: (t, (size,)) for k, (t, size) in vectors.items()}
    check_dtypes(name, x, {k: t for k, (t, _) in {**grids, **flat}.items()},
                 grids)
    for key, (t, shape) in {**grids, **flat}.items():
        if t.device != x.device:
            raise MXNetError(f"{name}: {key} is on {t.device}, c1 on "
                             f"{x.device}")
        if tuple(t.shape) != shape:
            raise MXNetError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        contiguous = t.is_contiguous() if key in flat else \
            t.is_contiguous(memory_format=torch.channels_last)
        if not contiguous:
            raise MXNetError(f"{name} kernel reads contiguous (channels-last"
                             f" for 4-D) storage: {key} is not")
    if not 0 < cm <= _MAX_CM[x.dtype]:
        raise MXNetError(f"{name} kernel takes 1..{_MAX_CM[x.dtype]} conv2 "
                         f"channels in {x.dtype}, got {cm}")
    if x.numel() >= _INDEX_LIMIT or n * h * w * max(cm, co) >= _INDEX_LIMIT:
        raise MXNetError(f"{name} kernel: tensor too large for 32-bit "
                         f"indices ({tuple(x.shape)} -> {cm} -> {co})")
    if min(n, c, h, w) == 0 or (w3 is not None and co == 0):
        raise MXNetError(f"{name}: empty tensor {tuple(x.shape)}")


def chain_stats(x, a1, b1, w2, shift):
    """Pass 1: ``(sum, sq)``, the fp32 sums over (N, H, W) of ``c2 -
    shift`` and of its square, with ``c2 = conv3x3(relu(x*a1 + b1), w2)``
    (pad 1 after the activation).  x: ``(N, C, H, W)`` channels-last,
    fp32 or bf16; w2: ``(Cm, C, 3, 3)`` channels-last in x's dtype; a1,
    b1: ``(C,)`` and shift: ``(Cm,)``, fp32.  On the card two launches
    (tiles, then the ordered sum of their partials): deterministic, no
    float atomics."""
    if not _dispatch("chain_stats", x):
        return _chain_stats_plain(x, a1, b1, w2, shift)
    cm = w2.shape[0]
    _check("chain_stats", x, {"a1": (a1, x.shape[1]), "b1": (b1, x.shape[1]),
                              "shift": (shift, cm)}, w2)
    n, c, h, w = x.shape
    part = torch.empty((_workspace(n * h * w, cm),), device=x.device,
                       dtype=torch.float32)
    sums = torch.empty((cm,), device=x.device, dtype=torch.float32)
    sqs = torch.empty_like(sums)
    launch("chain_stats", (x, a1, b1, w2, shift, part, sums, sqs),
           (n, h, w, c, cm), x.device, x.dtype)
    count_launch(chain_stats, x.dtype)
    return sums, sqs


def _workspace(m, cm):
    """Floats of chain_stats' per-tile partial sums (fp32 in both
    forms), as the kernel library sizes them
    (``mx_chain_stats_workspace``)."""
    fn = _build.load("chain_stats").mx_chain_stats_workspace
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(m, cm)


def chain_emit(x, a1, b1, w2, a2, b2, w3, b3):
    """Pass 2: ``conv1x1(relu(c2*a2 + b2), w3) + b3`` with c2 as in
    ``chain_stats``; neither c2 nor its activation reaches device
    memory on the card.  a2, b2: ``(Cm,)`` fp32; w3: ``(Co, Cm, 1, 1)``
    in x's dtype; b3: ``(Co,)`` fp32.  Returns ``(N, Co, H, W)``
    channels-last in x's dtype."""
    if not _dispatch("chain_emit", x):
        return _chain_emit_plain(x, a1, b1, w2, a2, b2, w3, b3)
    cm, co = w2.shape[0], w3.shape[0]
    c = x.shape[1]
    _check("chain_emit", x, {"a1": (a1, c), "b1": (b1, c), "a2": (a2, cm),
                             "b2": (b2, cm), "b3": (b3, co)}, w2, w3)
    n, _, h, w = x.shape
    out = torch.empty((n, co, h, w), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    launch("chain_emit", (x, a1, b1, w2, a2, b2, w3, b3, out),
           (n, h, w, c, cm, co), x.device, x.dtype)
    count_launch(chain_emit, x.dtype)
    return out


chain_stats.launches = chain_stats.launches_bf16 = 0
chain_emit.launches = chain_emit.launches_bf16 = 0


def _chain_plain(c1, g1, bt1, mm1, mv1, w2, g2, bt2, mm2, mv2, w3, b3, eps,
                 fix_gamma, train_stats):
    """The plain composition (the JAX op's ``xla_forward``): BN1, ReLU,
    conv2, BN2 (batch statistics by ``bn_stats``, unshifted, or the
    moving ones), ReLU, conv3 plus bias; the BNs in fp32, the convs in
    c1's dtype.  Returns ``(out, mean1, var1, mean2, var2)``, the
    statistics fp32."""
    a1, b1, mean1, var1 = bn_coefficients(c1, g1, bt1, mm1, mv1, eps,
                                          fix_gamma, train_stats)
    c2 = _conv2(c1, a1, b1, w2)
    a2, b2, mean2, var2 = bn_coefficients(c2, g2, bt2, mm2, mv2, eps,
                                          fix_gamma, train_stats)
    out = F.conv2d(_activate(c2, a2, b2), w3.to(c1.dtype), b3.to(c1.dtype))
    return out, mean1, var1, mean2, var2


class _Chain(torch.autograd.Function):
    """Forward: BN1's statistics, pass 1 (train form only), the glue,
    pass 2.  Inside a data-parallel mesh step BN1's statistics and pass
    1's sums are summed over the ``dp`` group (``ops.collective``)
    between the two launches.  Backward: ``recompute_vjp`` of
    ``_chain_plain``, under the group the forward saw, so its
    statistics and their cotangents are the global batch's too.  The
    moving statistics get no gradient and are saved only in eval form,
    where the forward reads them (in train form the caller updates them
    in place after the forward)."""

    @staticmethod
    def forward(ctx, c1, g1, bt1, mm1, mv1, w2, g2, bt2, mm2, mv2, w3, b3,
                eps, fix_gamma, train_stats):
        a1, b1, mean1, var1 = bn_coefficients(c1, g1, bt1, mm1, mv1, eps,
                                              fix_gamma, train_stats)
        if c1.device.type == "cuda":
            w2 = w2.contiguous(memory_format=torch.channels_last)
            w3 = w3.contiguous(memory_format=torch.channels_last)
        if train_stats:
            # BN2's moving mean as the shift: exact for any value, and
            # within an EMA step of the batch mean once training settles
            shift = mm2.float().contiguous()
            sums, sqs = chain_stats(c1, a1, b1, w2, shift)
            count = c1.shape[0] * c1.shape[2] * c1.shape[3]
            group = dp_group()
            if group is not None:
                # the shift is the same on every rank, so the shifted
                # sums of the ranks add up to the global batch's
                sums, sqs, count = dp_all_reduce_sum(
                    (sums, sqs, torch.full((1,), count, dtype=torch.float32,
                                           device=sums.device)), group)
            mean_d = sums / count
            var2 = torch.clamp(sqs / count - mean_d.square(), min=0.0)
            mean2 = mean_d + shift
        else:
            mean2, var2 = mm2.float(), mv2.float()
        a2, b2 = bn_affine(g2, bt2, mean2, var2, eps, fix_gamma)
        out = chain_emit(c1, a1, b1, w2, a2, b2, w3, b3)
        ctx.cfg = (eps, fix_gamma, train_stats)
        ctx.group = dp_group()
        stats = () if train_stats else (mm1, mv1, mm2, mv2)
        ctx.save_for_backward(c1, g1, bt1, w2, g2, bt2, w3, b3, *stats)
        return out, mean1, var1, mean2, var2

    @staticmethod
    def backward(ctx, *cts):
        eps, fix_gamma, train_stats = ctx.cfg
        c1, g1, bt1, w2, g2, bt2, w3, b3, *stats = ctx.saved_tensors
        mm1, mv1, mm2, mv2 = stats if stats else (None,) * 4
        need = ctx.needs_input_grad

        def plain(c1_, g1_, bt1_, w2_, g2_, bt2_, w3_, b3_):
            return _chain_plain(c1_, g1_, bt1_, mm1, mv1, w2_, g2_, bt2_,
                                mm2, mv2, w3_, b3_, eps, fix_gamma,
                                train_stats)

        with dp_sync(ctx.group):
            gc1, gg1, gbt1, gw2, gg2, gbt2, gw3, gb3 = recompute_vjp(
                plain, (c1, g1, bt1, w2, g2, bt2, w3, b3),
                tuple(need[i] for i in (0, 1, 2, 5, 6, 7, 10, 11)), cts)
        return (gc1, gg1, gbt1, None, None, gw2, gg2, gbt2, None, None, gw3,
                gb3, None, None, None)


def fused_bottleneck_chain(c1, g1, bt1, mm1, mv1, w2, g2, bt2, mm2, mv2, w3,
                           b3=None, eps=1e-5, fix_gamma=False,
                           train_stats=True):
    """[BN1 -> ReLU -> conv2 3x3 -> BN2 -> ReLU -> conv3 1x1 + b3] as one
    op, the JAX package's ``_FusedBottleneckChain``: returns ``(out,
    mean1, var1, mean2, var2)``, the statistics fp32, batch ones with
    ``train_stats`` (the caller updates both moving averages) and the
    moving ones otherwise.  c1: ``(N, C, H, W)``, channels-last on
    CUDA; w2: ``(Cm, C, 3, 3)``; w3: ``(Co, Cm, 1, 1)``; b3: ``(Co,)``
    or None (zeros).  Differentiable in every input but the moving
    statistics."""
    if tuple(w2.shape[2:]) != (3, 3) or tuple(w3.shape[2:]) != (1, 1):
        raise MXNetError(f"fused_bottleneck_chain needs a 3x3 then a 1x1 "
                         f"kernel; got {tuple(w2.shape)} / "
                         f"{tuple(w3.shape)}")
    if b3 is None:
        b3 = torch.zeros((w3.shape[0],), dtype=torch.float32,
                         device=w3.device)
    return _Chain.apply(c1, g1, bt1, mm1, mv1, w2, g2, bt2, mm2, mv2, w3,
                        b3.float(), float(eps), bool(fix_gamma),
                        bool(train_stats))


@register_op("_FusedBottleneckChain", num_outputs=5)
def _fused_bottleneck_chain_op(c1, gamma1, beta1, moving_mean1, moving_var1,
                               weight2, gamma2, beta2, moving_mean2,
                               moving_var2, weight3, bias3=None, *,
                               layout=None, eps=1e-5, momentum=0.9,
                               fix_gamma=False, use_global_stats=False,
                               impl="auto", is_train=True,
                               output_mean_var=False):
    """[BN -> ReLU -> conv3x3 -> BN -> ReLU -> conv1x1] as one op (the
    JAX package's ``_FusedBottleneckChain``): ``(out, mean1, var1,
    mean2, var2)`` in c1's dtype.  conv2 must be 3x3 and conv3 1x1
    (else ValueError, as in JAX).  NHWC data inside ``chain_supported``
    goes to ``fused_bottleneck_chain`` (the kernels on the card)
    through a permuted view; any other layout, or ``impl="xla"``, to
    the plain composition.  ``output_mean_var`` (an extension, as for
    ``_FusedBNReluConv``) returns the statistics too."""
    if tuple(weight2.shape[2:]) != (3, 3) or \
            tuple(weight3.shape[2:]) != (1, 1):
        raise ValueError(
            f"_FusedBottleneckChain needs a 3x3 then a 1x1 kernel; got "
            f"{tuple(weight2.shape)} / {tuple(weight3.shape)}")
    train_stats = bool(is_train) and not use_global_stats
    if bias3 is None:
        bias3 = torch.zeros((weight3.shape[0],), dtype=torch.float32,
                            device=weight3.device)
    fused = layout == "NHWC" and c1.dim() == 4 and chain_supported(
        weight2.shape[0], layout, c1.dtype)
    if impl in ("pallas", "pallas_interpret") and not fused:
        raise ValueError(
            f"_FusedBottleneckChain kernel path needs channels-last 4D data "
            f"inside the kernels' envelope; got shape={tuple(c1.shape)} "
            f"layout={layout}")
    nhwc = layout == "NHWC"
    x = c1.contiguous().permute(0, 3, 1, 2) if nhwc else c1
    args = (x, gamma1, beta1, moving_mean1, moving_var1,
            weight2.to(c1.dtype), gamma2, beta2, moving_mean2, moving_var2,
            weight3.to(c1.dtype), bias3)
    # meta tensors (shape inference) take the plain composition
    if fused and impl != "xla" and c1.device.type != "meta":
        outs = fused_bottleneck_chain(*args, eps=eps, fix_gamma=fix_gamma,
                                      train_stats=train_stats)
    else:
        outs = _chain_plain(*args, eps, fix_gamma, train_stats)
    out = outs[0].permute(0, 2, 3, 1) if nhwc else outs[0]
    return (out,) + tuple(s.to(c1.dtype) for s in outs[1:])
