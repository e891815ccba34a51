"""The fused BN -> ReLU -> conv op and layer of the PyTorch port against
the JAX package, and the kernels' wrapper contract.

On the CPU the port's ``fused_bn_relu_conv`` runs the kernels' plain
versions (``_sbr_matmul_plain``, ``_sbr_conv3x3_plain``); the reference
is the JAX op ``_fused_bn_relu_conv`` in eval form, both through its
Pallas kernels in interpret mode and through its exact XLA composition,
as the JAX package's own tests run it on the CPU.  Inputs come from a
seeded numpy stream and go to both sides, NHWC on the JAX side and as
the channels-last NCHW view of the same array on the port's.
Tolerance: atol = rtol = 2e-5 — both sides compute in fp32 and differ
only in summation order over at most 9*16 = 144 products of O(1)
values (observed ~1e-6)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import nn as jax_nn
from incubator_mxnet_tpu.ops.fused_conv import _fused_bn_relu_conv
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    BatchNorm, Conv2D, Dense, FusedBNReLUConv2D, MaxPool2D)
from incubator_mxnet_tpu_torch.ops import fused_conv
from incubator_mxnet_tpu_torch.ops.fused_conv import (
    _check, fused_bn_relu_conv, sbr_conv3x3, sbr_matmul, supported)
from torch_port_helpers import split_tf32, tf32_rna

TOL = dict(atol=2e-5, rtol=2e-5)
CL = torch.channels_last


def _nchw(a):
    """The channels-last NCHW view of an NHWC numpy array (no copy)."""
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _op_args(seed, n, h, w, c, cout, kern, bias):
    rs = np.random.RandomState(seed)
    f = np.float32
    args = [rs.randn(n, h, w, c).astype(f), (rs.rand(c) + 0.5).astype(f),
            (rs.randn(c) * 0.1).astype(f), (rs.randn(c) * 0.1).astype(f),
            (rs.rand(c) + 0.5).astype(f),
            (rs.randn(cout, c, *kern) * 0.1).astype(f)]
    args.append(rs.randn(cout).astype(f) if bias else None)
    return args


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("kern,shape", [((1, 1), (2, 8, 8, 16, 32)),
                                        ((3, 3), (2, 9, 10, 16, 24))])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_op_matches_jax_op(impl, kern, shape, bias, fix_gamma):
    args = _op_args(sum(shape) + bias, *shape, kern, bias)
    ref, _, _ = _fused_bn_relu_conv(
        *[None if a is None else jnp.asarray(a) for a in args],
        kernel=kern, stride=(1, 1), pad=(kern[0] // 2,) * 2, layout="NHWC",
        eps=1e-5, fix_gamma=fix_gamma, impl=impl, is_train=False)
    before = (sbr_matmul.launches, sbr_conv3x3.launches)
    x, rest = _nchw(args[0]), [None if a is None else torch.from_numpy(a)
                               for a in args[1:]]
    got = fused_bn_relu_conv(x, *rest, kernel=kern, eps=1e-5,
                             fix_gamma=fix_gamma)
    assert got.is_contiguous(memory_format=CL)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (sbr_matmul.launches, sbr_conv3x3.launches) == before


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_matches_jax_op_in_eval(fix_gamma):
    """The port's BatchNorm (``scale=False`` is the reference's
    fix_gamma) against the JAX BatchNorm op with the moving statistics,
    over the channel axis of NCHW data."""
    from incubator_mxnet_tpu.ops.nn import _batch_norm
    rs = np.random.RandomState(7)
    f = np.float32
    x = rs.randn(2, 6, 5, 4).astype(f)
    params = [(rs.rand(6) + 0.5).astype(f), rs.randn(6).astype(f),
              rs.randn(6).astype(f), (rs.rand(6) + 0.5).astype(f)]
    ref, _, _ = _batch_norm(jnp.asarray(x), *map(jnp.asarray, params),
                            eps=1e-5, fix_gamma=fix_gamma, axis=1,
                            is_train=False)
    bn = BatchNorm(6, epsilon=1e-5, scale=not fix_gamma, device="cpu")
    bn.load_state_dict(dict(zip(
        ("gamma", "beta", "running_mean", "running_var"),
        map(torch.from_numpy, params))))
    with torch.inference_mode():
        got = bn.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_zero_padding_comes_after_the_activation():
    """At out-of-image taps the 3x3 reads 0, not relu(0*a + b): with a
    large positive shift b the border outputs differ from a conv that
    pads the raw input."""
    x = _nchw(np.ones((1, 4, 5, 2), np.float32))
    a, b = torch.zeros(2), torch.full((2,), 3.0)
    w = torch.ones((1, 2, 3, 3))
    out = sbr_conv3x3(x, a, b, w, torch.zeros(1))[0, 0]
    # y = relu(0*1 + 3) = 3 inside; a corner sees 4 of 9 taps
    assert out[0, 0].item() == pytest.approx(2 * 3 * 4)
    assert out[1, 1].item() == pytest.approx(2 * 3 * 9)


def _jax_layer(kern, pad, use_bias, rs, c, cout):
    layer = jax_nn.FusedBNReLUConv2D(cout, kern, 1, pad, layout="NHWC",
                                     in_channels=c, use_bias=use_bias,
                                     prefix="f_")
    layer.initialize()
    for name, p in layer.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            arr = rs.rand(*p.shape) + 0.5
        else:
            arr = rs.randn(*p.shape) * 0.2
        p.set_data(mx.nd.array(arr.astype(np.float32)))
    return layer


@pytest.mark.parametrize("kern,pad,use_bias", [(1, 0, True), (3, 1, False)])
def test_layer_matches_jax_layer(kern, pad, use_bias):
    """The port's FusedBNReLUConv2D in eval, with the JAX layer's
    weights moved by name (bn.* and conv.*), gives the JAX layer's
    inference output."""
    rs = np.random.RandomState(kern)
    c, cout = 8, 12
    jl = _jax_layer(kern, pad, use_bias, rs, c, cout)
    x = rs.randn(2, 6, 7, c).astype(np.float32)
    ref = jl(mx.nd.array(x)).asnumpy()
    layer = FusedBNReLUConv2D(cout, kern, 1, pad, layout="NHWC",
                              in_channels=c, use_bias=use_bias, device="cpu")
    assert layer.fused
    sd = {}
    for name, p in jl.collect_params().items():
        leaf = name[len("f_"):]
        child = "bn" if leaf.startswith("batchnorm") else "conv"
        sd[f"{child}.{leaf.split('_', 1)[1]}"] = torch.tensor(
            p.data().asnumpy())
    layer.load_state_dict(sd)
    with torch.inference_mode():
        got = layer.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


def test_layer_outside_the_envelope_runs_the_plain_composition():
    """Stride 2 is outside the kernels' envelope: the layer is built
    unfused and computes BN, ReLU, conv exactly as the fused one would
    at stride 1 on the strided pixels (1x1 kernel)."""
    torch.manual_seed(0)
    fused = FusedBNReLUConv2D(6, 1, 1, 0, layout="NHWC", in_channels=4,
                              device="cpu")
    strided = FusedBNReLUConv2D(6, 1, 2, 0, layout="NHWC", in_channels=4,
                                device="cpu")
    assert fused.fused and not strided.fused
    for t in list(fused.parameters()) + list(fused.buffers()):
        t.data.uniform_(0.5, 1.5)
    strided.load_state_dict(fused.state_dict())
    x = torch.randn(2, 4, 6, 6).contiguous(memory_format=CL)
    with torch.inference_mode():
        a = fused.eval()(x[:, :, ::2, ::2].contiguous(memory_format=CL))
        b = strided.eval()(x)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cfg,ok", [
    (dict(kernel=(1, 1), pad=(0, 0)), True),
    (dict(kernel=(3, 3), pad=(1, 1)), True),
    (dict(kernel=(3, 3), pad=(0, 0)), False),
    (dict(kernel=(1, 1), pad=(0, 0), stride=(2, 2)), False),
    (dict(kernel=(3, 3), pad=(1, 1), groups=2), False),
    (dict(kernel=(3, 3), pad=(1, 1), layout="NCHW"), False),
    (dict(kernel=(1, 1), pad=(0, 0), dtype=torch.float16), False),
    (dict(kernel=(5, 5), pad=(2, 2)), False)])
def test_supported_envelope(cfg, ok):
    assert supported(**cfg) is ok


def _kernel_args(x_fmt=CL, w_fmt=CL, dtype=torch.float32, device="cpu"):
    x = torch.zeros((2, 8, 5, 7), dtype=dtype,
                    device=device).contiguous(memory_format=x_fmt)
    w = torch.zeros((4, 8, 3, 3), device=device).contiguous(
        memory_format=w_fmt)
    return [x, torch.zeros(8, device=device), torch.zeros(8, device=device),
            w, torch.zeros(4, device=device)]


@pytest.mark.parametrize("bad,match", [
    (dict(x_fmt=torch.contiguous_format), "channels-last"),
    (dict(w_fmt=torch.contiguous_format), "OHWI"),
    (dict(dtype=torch.float64), "float32")])
def test_wrapper_contract_refuses_what_the_kernel_does_not_take(bad, match):
    """The checks a CUDA tensor meets before a launch: the kernels read
    channels-last fp32 storage and never copy silently."""
    _check("sbr_conv3x3", *_kernel_args(), (3, 3))       # the good case
    with pytest.raises(MXNetError, match=match):
        _check("sbr_conv3x3", *_kernel_args(**bad), (3, 3))
    with pytest.raises(MXNetError, match="shape"):
        _check("sbr_matmul", *_kernel_args(), (1, 1))   # 3x3 weight


def test_wrapper_refuses_past_32_bit_indices_and_other_devices():
    x = torch.empty((2 ** 16, 8, 64, 64), device="meta").contiguous(
        memory_format=CL)
    args = [x] + _kernel_args(device="meta")[1:]
    with pytest.raises(MXNetError, match="32-bit"):
        _check("sbr_conv3x3", *args, (3, 3))
    with pytest.raises(MXNetError, match="cuda or cpu"):
        sbr_conv3x3(*args)


def test_layers_keep_channels_last_on_cpu():
    """F.conv2d, max_pool2d, the BN affine and the fused layers keep the
    channels-last format of their input (checked once on the CPU; the
    kernels' wrappers raise rather than copy when it is lost)."""
    x = torch.randn(2, 8, 9, 10).contiguous(memory_format=CL)
    layers = [Conv2D(8, 3, 1, 1, layout="NHWC", in_channels=8,
                     device="cpu"),
              Conv2D(8, 1, 2, layout="NHWC", in_channels=8, device="cpu"),
              MaxPool2D(3, 2, 1),
              BatchNorm(8, device="cpu"),
              FusedBNReLUConv2D(8, 3, 1, 1, layout="NHWC", in_channels=8,
                                device="cpu"),
              FusedBNReLUConv2D(8, 1, 1, 0, layout="NHWC", in_channels=8,
                                device="cpu")]
    for layer in layers:
        for t in list(layer.parameters()) + list(layer.buffers()):
            t.data.uniform_(0.5, 1.5)
        with torch.inference_mode():
            out = layer.eval()(x)
        assert out.is_contiguous(memory_format=CL), type(layer).__name__
    assert F.conv2d(x, torch.randn(3, 8, 1, 1)).is_contiguous(
        memory_format=CL)


def test_train_mode_raises():
    """Train mode takes batch statistics (held against the JAX package in
    tests/test_torch_train.py), so it raises where there are none: an
    empty batch, in BN and in the fused layer fused or not.  The same
    empty batch passes in eval, where the statistics are the running
    ones."""
    x = torch.randn(0, 4, 3, 3).contiguous(memory_format=CL)
    for layer in (BatchNorm(4, device="cpu"),
                  FusedBNReLUConv2D(4, 3, 1, 1, layout="NHWC", in_channels=4,
                                    device="cpu"),
                  FusedBNReLUConv2D(4, 3, 2, 1, layout="NHWC", in_channels=4,
                                    device="cpu")):
        for t in list(layer.parameters()) + list(layer.buffers()):
            t.data.uniform_(0.5, 1.5)
        with pytest.raises(MXNetError, match="train mode"):
            layer.train()(x)
        with torch.inference_mode():
            assert layer.eval()(x).shape[0] == 0


@pytest.mark.parametrize("make", [
    lambda **kw: Dense(4, 3, **kw), lambda **kw: BatchNorm(3, **kw),
    lambda **kw: Conv2D(4, 3, in_channels=3, **kw),
    lambda **kw: FusedBNReLUConv2D(4, 1, in_channels=3, layout="NHWC",
                                   **kw)])
def test_layers_resolve_device_none_to_the_card(make, monkeypatch):
    """device=None means cuda:0: without a GPU it raises MXNetError; the
    CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        make()
    layer = make(device="cpu")
    assert {p.device.type for p in layer.parameters()} == {"cpu"}


def test_kernel_library_binding_is_lazy():
    """Nothing is built or loaded at import: the CPU tests import every
    module on a machine without nvcc."""
    assert fused_conv._bound == {}


# B2 on the card multiplies in TF32 on the tensor cores, each operand
# split into two TF32 parts and three products summed (the 3x3 main loop
# of csrc/tc_gemm.cuh).  Here the plain version runs in that arithmetic
# on the CPU (a CPU computation, not the card's: fp32 accumulation
# rounding to nearest) against fp64, at K = 9C up to 4608: the split
# must hold chip_smoke.py's kernel gate (CONV_RTOL, 1e-4 of max |out|)
# with a margin of SPLIT_MARGIN, and one TF32 pass must not hold it.
CONV_RTOL = 1e-4
SPLIT_MARGIN = 20.0


def _conv3x3(y, w, product):
    """F.conv2d(y, w, padding=1) with the multiplications of ``product``:
    "fp32", "tf32" (one pass) or "3xtf32"."""
    def conv(a, b):
        return F.conv2d(a, b, padding=1)
    if product == "tf32":
        return conv(tf32_rna(y), tf32_rna(w))
    if product == "3xtf32":
        (yb, ys), (wb, ws) = split_tf32(y), split_tf32(w)
        return conv(ys, wb) + conv(yb, ws) + conv(yb, wb)
    return conv(y, w)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 64), (1, 8, 8, 256, 256),
                                   (1, 7, 7, 512, 512)],
                         ids=["K576", "K2304", "K4608"])
def test_3xtf32_split_holds_the_conv3x3_gate_and_one_pass_does_not(shape):
    n, h, w, c, cout = shape
    rs = np.random.RandomState(13)
    f32 = np.float32
    args = [rs.randn(n, c, h, w).astype(f32),
            rs.uniform(0.5, 1.5, c).astype(f32),
            rs.uniform(-0.1, 0.1, c).astype(f32),
            (rs.randn(cout, c, 3, 3) * np.sqrt(2.0 / (9 * c))).astype(f32),
            rs.uniform(-0.1, 0.1, cout).astype(f32)]
    x, a, b, wt, bias = [torch.from_numpy(v) for v in args]

    def out(product, dtype):
        y = fused_conv._activate(x.to(dtype), a.to(dtype), b.to(dtype))
        return _conv3x3(y, wt.to(dtype), product) + \
            bias.to(dtype).view(1, -1, 1, 1)
    ref = out("fp32", torch.float64)
    scale = ref.abs().max().item()

    def err(product):
        return (out(product, torch.float32).double() - ref).abs().max() \
            .item() / scale
    split, once = err("3xtf32"), err("tf32")
    assert split * SPLIT_MARGIN <= CONV_RTOL, (split, once)
    assert once > CONV_RTOL, (split, once)


# B1 on the card runs the same 3xTF32 arithmetic as B2 (tc_gemm.cuh's
# 1x1 walker, the operands split once per CTA): its plain version in that
# arithmetic on the CPU against fp64, at the four reduction lengths K of
# ResNet-50's fused 1x1 boundaries, must hold the same gate with the same
# margin, and one TF32 pass must not hold it.
@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 256), (2, 8, 8, 128, 512),
                                   (1, 8, 8, 256, 1024),
                                   (1, 7, 7, 512, 2048)],
                         ids=["K64", "K128", "K256", "K512"])
def test_3xtf32_split_holds_the_conv1x1_gate_and_one_pass_does_not(shape):
    n, h, w, c, cout = shape
    rs = np.random.RandomState(13)
    f32 = np.float32
    args = [rs.randn(n, c, h, w).astype(f32),
            rs.uniform(0.5, 1.5, c).astype(f32),
            rs.uniform(-0.1, 0.1, c).astype(f32),
            (rs.randn(cout, c, 1, 1) * np.sqrt(2.0 / c)).astype(f32),
            rs.uniform(-0.1, 0.1, cout).astype(f32)]
    x, a, b, wt, bias = [torch.from_numpy(v) for v in args]

    def out(product, dtype):
        y = fused_conv._activate(x.to(dtype), a.to(dtype), b.to(dtype))
        y = y.permute(0, 2, 3, 1).reshape(-1, c)
        wm = wt.to(dtype).reshape(cout, c).t()
        if product == "tf32":
            z = tf32_rna(y) @ tf32_rna(wm)
        elif product == "3xtf32":
            (yb, ys), (wb, ws) = split_tf32(y), split_tf32(wm)
            z = ys @ wb + yb @ ws + yb @ wb
        else:
            z = y @ wm
        return z + bias.to(dtype)
    ref = out("fp32", torch.float64)
    scale = ref.abs().max().item()

    def err(product):
        return (out(product, torch.float32).double() - ref).abs().max() \
            .item() / scale
    split, once = err("3xtf32"), err("tf32")
    assert split * SPLIT_MARGIN <= CONV_RTOL, (split, once)
    assert once > CONV_RTOL, (split, once)


# ---- the bf16 form.  On the CPU the op runs the kernels' plain
# versions in their bf16 arithmetic (the Pallas kernels': relu(x*a + b)
# in fp32 rounded to bf16, bf16 products summed in fp32, plus the fp32
# bias, rounded to bf16 once); the reference is the JAX op on the same
# bf16 inputs.  Tolerances, in bf16 ulps of max |out| (BF16_ULPS): against
# ``pallas_interpret`` observed 0 (1x1) and <= 0.125 (3x3: fp32 sums in
# another order); against ``xla`` 0 without a bias and 1.0 with one (the
# XLA composition rounds the conv to bf16, then adds the bf16 bias and
# rounds again).  The statistics, rounded to bf16 as the JAX op returns
# them, are equal.  Gradients (autograd of the plain composition, as the
# JAX op's custom_vjp is jax.vjp of its XLA composition) within
# BF16_GRAD_RTOL of each gradient's max |value|: against
# ``pallas_interpret`` every gradient is equal but the bias's (1.2-1.9%:
# the two frameworks reduce the bf16 cotangent over N*H*W in other
# precisions), against ``xla`` (whose forward, and so its cotangent,
# differs by the bias rounding) <= 1.6%.
BF16_ULPS, BF16_GRAD_RTOL = 2, 4e-2
BF16_CASES = [((1, 1), (2, 8, 8, 16, 32)), ((3, 3), (2, 9, 10, 16, 24))]


def bf16_ulp(v):
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _jbf(a):
    return None if a is None else jnp.asarray(a, jnp.bfloat16)


def _tbf(a):
    return None if a is None else torch.from_numpy(a).bfloat16()


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _jax_bf16(args, kern, impl, train):
    return _fused_bn_relu_conv(
        *args, kernel=kern, stride=(1, 1), pad=(kern[0] // 2,) * 2,
        layout="NHWC", eps=1e-5, impl=impl, is_train=train)


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("kern,shape", BF16_CASES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_op_matches_jax_op(impl, kern, shape, bias, train):
    args = _op_args(sum(shape) + bias, *shape, kern, bias)
    ref = _jax_bf16([_jbf(a) for a in args], kern, impl, train)
    before = (sbr_matmul.launches, sbr_conv3x3.launches)
    t = [_tbf(a) for a in args]
    got = fused_bn_relu_conv(t[0].permute(0, 3, 1, 2), *t[1:], kernel=kern,
                             eps=1e-5, train_stats=train,
                             output_mean_var=True)
    assert got[0].dtype == torch.bfloat16
    assert got[0].is_contiguous(memory_format=CL)
    r = _f32(ref[0])
    err = np.abs(_nhwc(got[0].float()) - r).max()
    assert err <= BF16_ULPS * bf16_ulp(np.abs(r).max()), err
    for g, r in zip(got[1:], ref[1:]):       # the statistics
        np.testing.assert_array_equal(g.bfloat16().float().numpy(), _f32(r))
    assert (sbr_matmul.launches, sbr_conv3x3.launches) == before


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("kern,shape", BF16_CASES)
@pytest.mark.parametrize("train", [False, True])
def test_bf16_gradients_match_jax(impl, kern, shape, train):
    """Gradients of x, gamma, beta, the weight and the bias under a loss
    of the output and both statistics, against jax.grad of the JAX op,
    all in bf16."""
    args = _op_args(7 + sum(shape), *shape, kern, True)
    jargs = [_jbf(a) for a in args]
    diff = (0, 1, 2, 5, 6)

    def loss(out, mean, var):
        return (out.astype(jnp.float32) ** 2).sum() + \
            mean.astype(jnp.float32).sum() + 2 * var.astype(jnp.float32).sum()

    def jloss(*d):
        a = list(jargs)
        for i, v in zip(diff, d):
            a[i] = v
        return loss(*_jax_bf16(a, kern, impl, train))

    ref = jax.grad(jloss, argnums=tuple(range(len(diff))))(
        *[jargs[i] for i in diff])
    t = [_tbf(a) for a in args]
    t[0] = t[0].permute(0, 3, 1, 2)
    for i in diff:
        t[i].requires_grad_(True)
    out, mean, var = fused_bn_relu_conv(*t, kernel=kern, eps=1e-5,
                                        train_stats=train,
                                        output_mean_var=True)
    ((out.float() ** 2).sum() + mean.sum() + 2 * var.sum()).backward()
    for i, r in zip(diff, ref):
        g = t[i].grad.float()
        got = _nhwc(g) if i == 0 else g.numpy()
        r = _f32(r)
        err = np.abs(got - r).max()
        assert err <= BF16_GRAD_RTOL * np.abs(r).max(), (i, err)
