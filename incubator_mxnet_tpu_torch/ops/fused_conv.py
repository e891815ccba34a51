"""Fused [BatchNorm-apply -> ReLU -> Conv]: the two hand-written Hopper
kernels, their plain versions, and the op in eval and train form.

Port of ``incubator_mxnet_tpu/ops/fused_conv.py``.  Its two TPU kernels,
``_sbr_matmul_kernel`` (a 1x1 conv as a GEMM with the BN affine and ReLU
as prologue) and ``_sbr_conv3x3_kernel`` (a 3x3 stride-1 pad-1 conv of
the activated image), become ``csrc/sbr_matmul.cu`` and
``csrc/sbr_conv3x3.cu``: the same functions, fp32 accumulation, the
activated tensor never written to device memory (each source's note says
how they are tiled for the card).

* Two forms, as the TPU kernels take the dtype they are given: fp32
  (x, weight and output fp32) and bf16 (x, weight and output bf16; the
  affine ``(a, b)`` and the bias fp32 in both).  The bf16 form is the
  Pallas kernel's arithmetic: ``relu(x*a + b)`` in fp32 rounded to bf16,
  bf16 products summed in fp32, ``+ bias`` in fp32, rounded to bf16
  once.  Any other mix (fp16, x and weight of different dtypes) raises.
* Tensors use the port's layout: NCHW-indexed, channels-last in memory
  (``torch.channels_last``), so a kernel reads the storage as
  ``(N*H*W, C)`` rows.  Weights are OIHW; the 3x3 kernel reads a
  channels-last OIHW weight's storage as OHWI.
* A CUDA tensor always goes to the kernel, or raises: no fallback to the
  plain version, and no silent copy of an input in another memory
  format.  A CPU tensor goes to the plain version (``_sbr_matmul_plain``,
  ``_sbr_conv3x3_plain``), which the CPU tests hold against the JAX
  package and ``chip_smoke.py`` holds the kernels against on the card.
* ``sbr_matmul.launches`` and ``sbr_conv3x3.launches`` count kernel
  launches of both forms, ``.launches_bf16`` those of the bf16 form, so
  a run can show that its main path went through them.
* ``fused_bn_relu_conv`` is the JAX op ``_FusedBNReluConv``: with
  ``train_stats`` the BN statistics are the batch's (``bn_stats``, the
  single-pass fp32 formula of the JAX ``_bn_stats``), else the running
  ones.  It is a ``torch.autograd.Function`` whose backward is autograd
  of the plain composition, re-run from the saved inputs, as the JAX
  op's ``custom_vjp`` backward is ``jax.vjp`` of its XLA composition:
  the JAX package has no backward kernel.
* The registry op ``_FusedBNReluConv`` (``nd._FusedBNReluConv``) takes
  the JAX op's arguments and layout (NHWC data, OIHW weight) and
  returns ``(out, mean, var)`` in the data's dtype, the front end
  folding the moving statistics.  Inside ``supported`` (JAX's
  ``_pallas_supported`` without its TPU tile check) it runs
  ``fused_bn_relu_conv`` on the data's NCHW-indexed view, which on a
  CUDA tensor is the kernel; any other configuration runs the plain
  composition (``_sbrc_plain``), as the JAX op runs its XLA one.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..base import MXNetError
from .collective import dp_all_reduce_sum, dp_group, dp_sync
from .registry import register_op

__all__ = ["bn_affine", "bn_stats", "fused_bn_relu_conv", "sbr_conv3x3",
           "sbr_matmul", "supported"]

_INDEX_LIMIT = 2 ** 31
# the operand dtypes of the kernels' two forms (the affine vectors and
# the bias are fp32 in both)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_bound = {}


def _lib(name, symbol, nptrs, nints):
    """The kernel library ``name``, built at first use, with its C
    function ``symbol`` bound: ``nptrs`` pointers, ``nints`` ints, the
    stream."""
    lib = _bound.get((name, symbol))
    if lib is None:
        lib = _build.load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p] * nptrs + [ctypes.c_int] * nints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        _bound[(name, symbol)] = lib
    return lib


def launch(name, tensors, ints, device, dtype=torch.float32):
    """Call the ``dtype`` form of kernel ``name`` (``mx_<name>``, or
    ``mx_<name>_bf16`` for bf16) with the tensors' pointers, the ints
    and the current stream of ``device``; raise MXNetError on a launch
    error."""
    symbol = f"mx_{name}" + ("_bf16" if dtype == torch.bfloat16 else "")
    lib = _lib(name, symbol, len(tensors), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, symbol)(
            *(t.data_ptr() for t in tensors), *ints, stream)
    if rc:
        raise MXNetError(f"{name} kernel launch failed: "
                         f"{lib.mx_cuda_error_string(rc).decode()} ({rc})")


def check_dtypes(name, x, tensors, data_keys):
    """The kernels' dtypes: x in ``KERNEL_DTYPES``, the tensors named in
    ``data_keys`` in x's dtype, every other one fp32; raises on anything
    else.  ``tensors``: ``{name: tensor}``."""
    if x.dtype not in KERNEL_DTYPES:
        raise MXNetError(f"{name} kernel takes float32 or bfloat16 data, "
                         f"got {x.dtype}")
    for key, t in tensors.items():
        want = x.dtype if key in data_keys else torch.float32
        if t.dtype != want:
            raise MXNetError(f"{name} kernel takes {key} in {want} with "
                             f"{x.dtype} data, got {t.dtype}")


def supported(kernel, stride=(1, 1), pad=(0, 0), groups=1, layout="NHWC",
              dtype=torch.float32):
    """The kernels' envelope, decided from a layer's configuration:
    channels-last (``layout="NHWC"``), fp32 or bf16, ungrouped, stride 1,
    and a 1x1 kernel with pad 0 or a 3x3 kernel with pad 1."""
    kernel, stride, pad = tuple(kernel), tuple(stride), tuple(pad)
    if layout != "NHWC" or dtype not in KERNEL_DTYPES or groups != 1:
        return False
    if stride != (1, 1):
        return False
    return (kernel, pad) in (((1, 1), (0, 0)), ((3, 3), (1, 1)))


def bn_stats(x):
    """Batch statistics over every axis but the channel axis (dim 1):
    fp32 ``(mean, var)`` by the single pass E[x^2] - mean^2, clamped at
    0 (the JAX package's ``_bn_stats``).  Raises on an empty batch, whose
    statistics do not exist.  Inside a data-parallel mesh step
    (``ops.collective.dp_sync``) they are the global batch's: ``(Σx,
    Σx², count)`` summed over the ``dp`` group, differentiably."""
    if x.numel() == 0:
        raise MXNetError(f"batch statistics (train mode) need a batch, got "
                         f"an empty one {tuple(x.shape)}")
    red = tuple(i for i in range(x.dim()) if i != 1)
    x32 = x.float()
    group = dp_group()
    if group is None:
        mean = x32.mean(red)
        var = torch.clamp(x32.square().mean(red) - mean.square(), min=0.0)
        return mean, var
    count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32,
                       device=x.device)
    s1, s2, count = dp_all_reduce_sum(
        (x32.sum(red), x32.square().sum(red), count), group)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean.square(), min=0.0)
    return mean, var


def bn_affine(gamma, beta, mean, var, eps=1e-5, fix_gamma=False):
    """fp32 per-channel ``(a, b)`` with ``x*a + b`` equal to BatchNorm
    with statistics ``(mean, var)``: ``a = gamma * rsqrt(var + eps)``,
    ``b = beta - mean * a`` (gamma taken as 1 when ``fix_gamma``), as
    the JAX op's ``affine`` folds it."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    a = g.float() * torch.rsqrt(var.float() + eps)
    b = beta.float() - mean.float() * a
    return a, b


def bn_coefficients(data, gamma, beta, running_mean, running_var, eps,
                    fix_gamma, train_stats):
    """``(a, b, mean, var)``, all fp32: the statistics are the batch's
    (``bn_stats`` of ``data``) with ``train_stats``, else the running
    ones, and ``(a, b)`` their affine (``bn_affine``)."""
    if train_stats:
        mean, var = bn_stats(data)
    else:
        mean, var = running_mean.float(), running_var.float()
    a, b = bn_affine(gamma, beta, mean, var, eps, fix_gamma)
    return a, b, mean, var


def _activate(x, a, b):
    """relu(x*a + b) over the channel axis (dim 1), computed in fp32 and
    returned in x's dtype, which the conv after it runs in (the JAX op
    rounds the activation to the data's dtype the same way: to nearest
    even for bf16, a no-op for fp32)."""
    shape = (1, -1, 1, 1)
    return torch.relu(x.float() * a.view(shape) + b.view(shape)).to(x.dtype)


def _sbr_matmul_plain(x, a, b, weight, bias):
    """Plain version of the 1x1 kernel, in its arithmetic: ``relu(x*a +
    b)`` rounded to x's dtype, as ``(N*H*W, C)`` rows times the ``(Cout,
    C)`` weight in fp32 (a bf16 x bf16 product is exact in fp32), plus
    the fp32 bias, rounded to x's dtype once."""
    n, c, h, w = x.shape
    y = _activate(x, a, b).float().permute(0, 2, 3, 1).reshape(-1, c)
    out = torch.matmul(y, weight.float().reshape(-1, c).t()) + bias.float()
    return out.to(x.dtype).reshape(n, h, w, -1).permute(0, 3, 1, 2)


def _sbr_conv3x3_plain(x, a, b, weight, bias):
    """Plain version of the 3x3 kernel, in its arithmetic: ``relu(x*a +
    b)`` rounded to x's dtype, then ``F.conv2d`` with padding 1 (zeros
    after the activation) in fp32 with the fp32 bias, rounded to x's
    dtype once."""
    return F.conv2d(_activate(x, a, b).float(), weight.float(),
                    bias.float(), padding=1).to(x.dtype)


def _check(name, x, a, b, weight, bias, kernel):
    """The kernels' contract on CUDA tensors; raises on anything else."""
    if x.dim() != 4:
        raise MXNetError(f"{name}: x must be 4-D (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    cout = weight.shape[0]
    want = {"x": (n, c, h, w), "a": (c,), "b": (c,),
            "weight": (cout, c) + kernel, "bias": (cout,)}
    tensors = {"x": x, "a": a, "b": b, "weight": weight, "bias": bias}
    check_dtypes(name, x, tensors, ("x", "weight"))
    for key, t in tensors.items():
        if t.device != x.device:
            raise MXNetError(f"{name}: {key} is on {t.device}, x on "
                             f"{x.device}")
        if tuple(t.shape) != want[key]:
            raise MXNetError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want[key]}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise MXNetError(f"{name} kernel reads channels-last storage: x "
                         f"is not channels_last-contiguous")
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise MXNetError(f"{name} kernel reads the weight's storage as "
                         f"OHWI: it must be channels_last-contiguous")
    if not (a.is_contiguous() and b.is_contiguous() and
            bias.is_contiguous()):
        raise MXNetError(f"{name}: a, b and bias must be contiguous")
    if x.numel() >= _INDEX_LIMIT or n * h * w * cout >= _INDEX_LIMIT:
        raise MXNetError(f"{name} kernel: tensor too large for 32-bit "
                         f"indices ({tuple(x.shape)} -> {cout} channels)")
    if min(n, c, h, w, cout) == 0:
        raise MXNetError(f"{name}: empty tensor {tuple(x.shape)} -> "
                         f"{cout} channels")


def _launch(name, ints, x, a, b, weight, bias):
    out = torch.empty((x.shape[0], weight.shape[0]) + tuple(x.shape[2:]),
                      device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    launch(name, (x, a, b, weight, bias, out), ints, x.device, x.dtype)
    return out


def count_launch(fn, dtype):
    """One launch of the kernel behind wrapper ``fn``, in ``dtype``'s
    form: ``fn.launches`` counts both forms, ``fn.launches_bf16`` the
    bf16 one."""
    fn.launches += 1
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1


def _dispatch(name, x):
    """True for a CUDA tensor (the kernel), False for a CPU one (the
    plain version); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise MXNetError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def sbr_matmul(x, a, b, weight, bias):
    """``relu(x*a + b)`` through a 1x1 stride-1 conv, plus ``bias``.
    x: ``(N, C, H, W)`` channels-last, fp32 or bf16; a, b: ``(C,)``
    fp32; weight: ``(Cout, C, 1, 1)`` in x's dtype; bias: ``(Cout,)``
    fp32.  Returns ``(N, Cout, H, W)`` channels-last in x's dtype."""
    if not _dispatch("sbr_matmul", x):
        return _sbr_matmul_plain(x, a, b, weight, bias)
    _check("sbr_matmul", x, a, b, weight, bias, (1, 1))
    n, c, h, w = x.shape
    out = _launch("sbr_matmul", (n * h * w, c, weight.shape[0]), x, a, b,
                  weight, bias)
    count_launch(sbr_matmul, x.dtype)
    return out


def sbr_conv3x3(x, a, b, weight, bias):
    """The 3x3 stride-1 pad-1 conv of ``relu(x*a + b)`` (zero padding
    after the activation), plus ``bias``.  x: ``(N, C, H, W)``
    channels-last, fp32 or bf16; weight: ``(Cout, C, 3, 3)`` in x's
    dtype, channels-last on CUDA (its storage is the OHWI order the
    kernel reads); a, b, bias fp32.  Returns ``(N, Cout, H, W)``
    channels-last in x's dtype."""
    if not _dispatch("sbr_conv3x3", x):
        return _sbr_conv3x3_plain(x, a, b, weight, bias)
    _check("sbr_conv3x3", x, a, b, weight, bias, (3, 3))
    n, c, h, w = x.shape
    out = _launch("sbr_conv3x3", (n, h, w, c, weight.shape[0]), x, a, b,
                  weight, bias)
    count_launch(sbr_conv3x3, x.dtype)
    return out


sbr_matmul.launches = sbr_matmul.launches_bf16 = 0
sbr_conv3x3.launches = sbr_conv3x3.launches_bf16 = 0


def recompute_vjp(plain, args, needs, cotangents):
    """The vector-Jacobian product of ``plain(*args)`` (a tuple of
    outputs) against ``cotangents``, for each arg flagged in ``needs``
    (None for the others): autograd of a re-run of ``plain`` from the
    saved args, the port's form of ``jax.vjp`` of an op's XLA
    composition in a ``custom_vjp`` backward."""
    if not any(needs):
        return (None,) * len(needs)
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(bool(n))
                  if isinstance(a, torch.Tensor) else a
                  for a, n in zip(args, needs)]
        outs = plain(*leaves)
        pairs = [(o, c) for o, c in zip(outs, cotangents)
                 if c is not None and o.requires_grad]
        wanted = [leaf for leaf, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [c for _, c in pairs],
            allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


def _fused_plain(x, gamma, beta, running_mean, running_var, weight, bias,
                 kernel, eps, fix_gamma, train_stats):
    """The plain composition of the fused op (the JAX op's
    ``xla_forward``): BN with the batch or running statistics, ReLU
    (both in fp32), ``F.conv2d`` plus bias in x's dtype.  Returns
    ``(out, mean, var)``, the statistics fp32."""
    a, b, mean, var = bn_coefficients(x, gamma, beta, running_mean,
                                      running_var, eps, fix_gamma,
                                      train_stats)
    out = F.conv2d(_activate(x, a, b), weight.to(x.dtype), bias.to(x.dtype),
                   padding=kernel[0] // 2)
    return out, mean, var


class _FusedBNReluConv(torch.autograd.Function):
    """Forward: the statistics, their affine, then one kernel launch
    (the plain version on a CPU tensor).  Backward: ``recompute_vjp``
    of ``_fused_plain``, under the ``dp_sync`` group its forward saw.
    The running statistics get no gradient and
    are saved only in eval form, where the forward reads them (in train
    form the caller updates them in place after the forward)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, weight,
                bias, kernel, eps, fix_gamma, train_stats):
        a, b, mean, var = bn_coefficients(x, gamma, beta, running_mean,
                                          running_var, eps, fix_gamma,
                                          train_stats)
        if x.device.type == "cuda":
            weight = weight.contiguous(memory_format=torch.channels_last)
        fn = sbr_matmul if kernel == (1, 1) else sbr_conv3x3
        out = fn(x, a, b, weight, bias)
        ctx.cfg = (kernel, eps, fix_gamma, train_stats)
        ctx.group = dp_group()
        stats = () if train_stats else (running_mean, running_var)
        ctx.save_for_backward(x, gamma, beta, weight, bias, *stats)
        return out, mean, var

    @staticmethod
    def backward(ctx, d_out, d_mean, d_var):
        kernel, eps, fix_gamma, train_stats = ctx.cfg
        x, gamma, beta, weight, bias, *stats = ctx.saved_tensors
        rm, rv = stats if stats else (None, None)
        need = ctx.needs_input_grad
        with dp_sync(ctx.group):
            grads = recompute_vjp(
                lambda x_, g_, b_, w_, c_: _fused_plain(
                    x_, g_, b_, rm, rv, w_, c_, kernel, eps, fix_gamma,
                    train_stats),
                (x, gamma, beta, weight, bias),
                (need[0], need[1], need[2], need[5], need[6]),
                (d_out, d_mean, d_var))
        gx, gg, gb, gw, gc = grads
        return gx, gg, gb, None, None, gw, gc, None, None, None, None


def fused_bn_relu_conv(x, gamma, beta, running_mean, running_var, weight,
                       bias=None, kernel=(1, 1), eps=1e-5, fix_gamma=False,
                       train_stats=False, output_mean_var=False):
    """``conv(relu(BatchNorm(x)), weight) + bias`` as one op, the JAX
    package's ``_FusedBNReluConv``: the BN statistics are the batch's
    (``bn_stats``) with ``train_stats``, else the running ones; they
    fold into fp32 ``(a, b)`` (``bn_affine``), then a 1x1 kernel (pad 0)
    goes to ``sbr_matmul`` and a 3x3 kernel (pad 1) to ``sbr_conv3x3``;
    stride 1, ungrouped.  x: ``(N, C, H, W)``, channels-last on CUDA.
    A weight that is not channels-last is converted for the CUDA kernel
    (a copy per call; layers keep theirs channels-last).  Returns the
    output, or ``(out, mean, var)`` (the fp32 statistics used) with
    ``output_mean_var``.  Differentiable in every input but the running
    statistics (``_FusedBNReluConv``)."""
    kernel = tuple(kernel)
    if kernel not in ((1, 1), (3, 3)):
        raise MXNetError(f"fused_bn_relu_conv takes a 1x1 or 3x3 kernel, "
                         f"got {kernel}")
    if bias is None:
        bias = torch.zeros((weight.shape[0],), dtype=torch.float32,
                           device=weight.device)
    out, mean, var = _FusedBNReluConv.apply(
        x, gamma, beta, running_mean, running_var, weight, bias.float(),
        kernel, float(eps), bool(fix_gamma), bool(train_stats))
    return (out, mean, var) if output_mean_var else out


def _sbrc_plain(data, gamma, beta, running_mean, running_var, weight, bias,
                kernel, stride, pad, groups, layout, eps, fix_gamma,
                train_stats):
    """The JAX op's ``xla_forward`` for any configuration: BN (batch or
    running statistics) and ReLU in fp32 over the layout's channel
    axis, rounded to data's dtype, then ``nn.convolution`` plus bias.
    Returns ``(out, mean, var)``, the statistics fp32."""
    from .nn import _back, _first, convolution
    x = _first(data, layout)
    a, b, mean, var = bn_coefficients(x, gamma, beta, running_mean,
                                      running_var, eps, fix_gamma,
                                      train_stats)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = torch.relu(x.float() * a.view(shape) + b.view(shape)).to(x.dtype)
    out = convolution(y, weight, bias.to(x.dtype), kernel=kernel,
                      stride=stride, pad=pad, num_group=groups)
    return _back(out, layout), mean, var


@register_op("_FusedBNReluConv", num_outputs=3)
def _fused_bn_relu_conv_op(data, gamma, beta, moving_mean, moving_var,
                           weight, bias=None, *, kernel, stride=None,
                           pad=None, num_filter=None, num_group=1,
                           layout=None, eps=1e-5, momentum=0.9,
                           fix_gamma=False, use_global_stats=False,
                           no_bias=False, impl="auto", is_train=True,
                           output_mean_var=False):
    """BatchNorm -> ReLU -> Convolution as one op (the JAX package's
    ``_FusedBNReluConv``): ``(out, mean, var)``, the statistics the
    batch's with ``is_train`` (and not ``use_global_stats``).  NHWC
    data, one group, stride 1 and a 1x1 pad-0 or 3x3 pad-1 kernel go to
    ``fused_bn_relu_conv`` (the kernel on the card), through a permuted
    view of the data and back; anything else, or ``impl="xla"``, to the
    plain composition.  ``impl="pallas"`` / ``"pallas_interpret"``
    raise outside the kernels' envelope, as the JAX op does.
    ``output_mean_var`` (an extension: the JAX op has no such attribute)
    makes the front end return the statistics too, as for BatchNorm."""
    kernel = tuple(kernel)
    n = len(kernel)
    stride = tuple(stride) if stride is not None else (1,) * n
    pad = tuple(pad) if pad is not None else (0,) * n
    train_stats = bool(is_train) and not use_global_stats
    if bias is None or no_bias:
        bias = torch.zeros((weight.shape[0],), dtype=torch.float32,
                           device=weight.device)
    fused = data.dim() == 4 and supported(kernel, stride, pad, num_group,
                                          layout, data.dtype)
    if impl in ("pallas", "pallas_interpret") and not fused:
        raise ValueError(
            f"_FusedBNReluConv kernel path needs channels-last 4D data and "
            f"a stride-1 1x1 pad=0 / 3x3 pad=1 ungrouped kernel; got "
            f"kernel={kernel} stride={stride} pad={pad} groups={num_group} "
            f"layout={layout}")
    # meta tensors (shape inference) take the plain composition: the
    # kernel wrappers run on cuda or cpu only
    if fused and impl != "xla" and data.device.type != "meta":
        x = data.contiguous().permute(0, 3, 1, 2)
        out, mean, var = fused_bn_relu_conv(
            x, gamma, beta, moving_mean, moving_var, weight.to(data.dtype),
            bias, kernel, eps, fix_gamma, train_stats, output_mean_var=True)
        out = out.permute(0, 2, 3, 1)
    else:
        out, mean, var = _sbrc_plain(
            data, gamma, beta, moving_mean, moving_var, weight, bias, kernel,
            stride, pad, num_group, layout, eps, fix_gamma, train_stats)
    return out, mean.to(data.dtype), var.to(data.dtype)
