"""The bottleneck-chain op and layer of the PyTorch port against the JAX
package, and the chain kernels' wrapper contract.

On the CPU the port's ``fused_bottleneck_chain`` runs the kernels' plain
versions (``_chain_stats_plain``, ``_chain_emit_plain``); the reference
is the JAX op ``_fused_bottleneck_chain``, through its Pallas kernels in
interpret mode and through its exact XLA composition, as the JAX
package's own tests (tests/test_fused_chain.py) run it on the CPU.
Inputs come from a seeded numpy stream and go to both sides, NHWC on the
JAX side and as the channels-last NCHW view of the same array on the
port's.  Tolerances are those of the JAX package's own chain tests:
outputs atol = rtol = 3e-5 (two fp32 convolutions summed in other
orders), statistics 1e-5, gradients 2e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mx  # noqa: F401  (op registry)
from incubator_mxnet_tpu.ops.fused_chain import _fused_bottleneck_chain
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    FusedBNReLUConv2D, FusedBottleneckChain)
from incubator_mxnet_tpu_torch.ops import fused_chain
from incubator_mxnet_tpu_torch.ops.fused_chain import (
    CHAIN_MAX_CM, _check, chain_emit, chain_stats, chain_supported,
    fused_bottleneck_chain)
from torch_port_helpers import split_tf32, tf32_rna

CL = torch.channels_last
OUT_TOL = dict(atol=3e-5, rtol=3e-5)
STAT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)
# the shapes of the JAX package's chain tests: (N, H, W, C, Cm, Co)
SHAPES = [(2, 6, 8, 16, 8, 32), (2, 5, 7, 12, 8, 16)]
DIFF = (0, 1, 2, 5, 6, 7, 10, 11)   # c1, g1, b1, w2, g2, b2, w3, b3


def _args(seed, n, h, w, c, cm, co):
    """NHWC c1, the two BNs' (gamma, beta, mean, var), w2, w3 and b3, as
    the JAX package's chain tests draw them."""
    rs = np.random.RandomState(seed)
    f = np.float32

    def vec(k, scale):
        return (rs.randn(k) * scale).astype(f)

    return [rs.randn(n, h, w, c).astype(f), (rs.rand(c) + 0.5).astype(f),
            vec(c, 0.1), vec(c, 0.1), (rs.rand(c) + 0.5).astype(f),
            (rs.randn(cm, c, 3, 3) * 0.1).astype(f),
            (rs.rand(cm) + 0.5).astype(f), vec(cm, 0.1), vec(cm, 0.1),
            (rs.rand(cm) + 0.5).astype(f),
            (rs.randn(co, cm, 1, 1) * 0.1).astype(f), vec(co, 0.1)]


def _torch(args):
    """The port's view: c1 as channels-last NCHW, the rest as is."""
    out = [torch.from_numpy(a) for a in args]
    out[0] = out[0].permute(0, 3, 1, 2)
    return out


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_op_matches_jax_op(impl, train, shape):
    args = _args(sum(shape), *shape)
    ref = _fused_bottleneck_chain(*map(jnp.asarray, args), layout="NHWC",
                                  eps=1e-5, impl=impl, is_train=train)
    before = (chain_stats.launches, chain_emit.launches)
    got = fused_bottleneck_chain(*_torch(args), eps=1e-5, train_stats=train)
    assert got[0].is_contiguous(memory_format=CL)
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(ref[0]),
                               **OUT_TOL)
    for g, r in zip(got[1:], ref[1:]):      # both BNs' statistics
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **STAT_TOL)
    # a CPU tensor takes the plain versions: no kernel launch is counted
    assert (chain_stats.launches, chain_emit.launches) == before


def _loss(o):
    """The JAX package's chain-gradient loss (test_fused_chain.py)."""
    return (o[0] * o[0]).sum() + o[1].sum() + o[2].sum() + o[3].sum() \
        + 2 * o[4].sum()


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax(impl, shape):
    """The autograd.Function's gradients of c1, both BNs' gamma and
    beta, w2, w3 and b3 under that loss against jax.grad."""
    args = _args(100 + sum(shape), *shape)
    jargs = [jnp.asarray(a) for a in args]

    def jloss(*a):
        return _loss(_fused_bottleneck_chain(*a, layout="NHWC", eps=1e-5,
                                             impl=impl))

    ref = jax.grad(jloss, argnums=DIFF)(*jargs)
    targs = _torch(args)
    for i in DIFF:
        targs[i] = targs[i].detach().clone().requires_grad_(True)
    _loss(fused_bottleneck_chain(*targs, eps=1e-5)).backward()
    for i, r in zip(DIFF, ref):
        g = targs[i].grad
        got = _nhwc(g) if i == 0 else g.numpy()
        np.testing.assert_allclose(got, np.asarray(r), err_msg=str(i),
                                   **GRAD_TOL)


def test_moving_statistics_get_no_gradient():
    args = _torch(_args(3, *SHAPES[1]))
    for i in (3, 4, 8, 9):
        args[i].requires_grad_(True)
    args[0].requires_grad_(True)
    _loss(fused_bottleneck_chain(*args)).backward()
    assert args[0].grad is not None
    assert all(args[i].grad is None for i in (3, 4, 8, 9))


def test_shifted_variance_survives_large_mean():
    """The JAX package's stress case for pass 1 (test_fused_chain.py):
    BN2's batch mean ~4e3 standard deviations from 0 (BN1 beta 1000 and
    a center-tap-only conv2).  The plain B3 keeps the shift by BN2's
    moving mean, so var2 tracks an fp64 reference within 2e-2 where the
    raw single-pass fp32 form is off by more than the variance itself."""
    rs = np.random.RandomState(7)
    n, h, w, c, cm, co = 4, 16, 16, 16, 8, 16
    eps = 1e-5
    c1 = rs.randn(n, h, w, c).astype("float32")
    g1, beta1 = np.ones(c, "float32"), np.full(c, 1000.0, "float32")
    mm1, mv1 = np.zeros(c, "float32"), np.ones(c, "float32")
    w2 = np.zeros((cm, c, 3, 3), "float32")
    w2[:, :, 1, 1] = (0.1 + 0.001 * rs.randn(cm, c)).astype("float32")
    g2, beta2 = np.ones(cm, "float32"), np.zeros(cm, "float32")
    mv2 = np.ones(cm, "float32")
    w3 = (0.1 * rs.randn(co, cm, 1, 1)).astype("float32")
    c64 = c1.astype(np.float64)
    mean1, var1 = c64.mean((0, 1, 2)), c64.var((0, 1, 2))
    a1 = g1 / np.sqrt(var1 + eps)
    y1 = np.maximum(c64 * a1 + (beta1 - mean1 * a1), 0)
    c2 = np.einsum("nhwc,mc->nhwm", y1, w2[:, :, 1, 1].astype(np.float64))
    mean2_ref, var2_ref = c2.mean((0, 1, 2)), c2.var((0, 1, 2))
    assert float(np.min(mean2_ref / np.sqrt(var2_ref))) > 1e3  # stressed
    mm2 = (mean2_ref * 1.003).astype("float32")   # an EMA step off
    out = fused_bottleneck_chain(*_torch(
        [c1, g1, beta1, mm1, mv1, w2, g2, beta2, mm2, mv2, w3,
         np.zeros(co, "float32")]), eps=eps, train_stats=True)
    np.testing.assert_allclose(out[3].double().numpy(), mean2_ref,
                               rtol=1e-5)
    np.testing.assert_allclose(out[4].double().numpy(), var2_ref, rtol=2e-2)
    c2_32 = c2.astype(np.float32)
    raw = np.maximum(np.square(c2_32).mean((0, 1, 2), dtype=np.float32)
                     - np.square(c2_32.mean((0, 1, 2), dtype=np.float32)),
                     0.0)
    assert float(np.max(np.abs(raw - var2_ref) / var2_ref)) > 0.05


def test_eval_skips_pass_one(monkeypatch):
    """Train form: pass 1 once, then pass 2; eval: pass 2 only, on the
    moving statistics (returned as the op's BN2 statistics)."""
    calls = []
    for name in ("chain_stats", "chain_emit"):
        real = getattr(fused_chain, name)
        monkeypatch.setattr(fused_chain, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    args = _torch(_args(5, *SHAPES[1]))
    fused_bottleneck_chain(*args, train_stats=True)
    assert calls == ["chain_stats", "chain_emit"]
    calls.clear()
    out = fused_bottleneck_chain(*args, train_stats=False)
    assert calls == ["chain_emit"]
    assert torch.equal(out[3], args[8]) and torch.equal(out[4], args[9])


def test_gates_raise_on_other_kernels():
    args = _torch(_args(6, *SHAPES[1]))
    args[5] = args[5][:, :, :1, :1]        # a 1x1 where the 3x3 belongs
    with pytest.raises(MXNetError, match="3x3 then a 1x1"):
        fused_bottleneck_chain(*args)


@pytest.mark.parametrize("cfg,ok", [
    (dict(mid_channels=64), True), (dict(mid_channels=512), True),
    (dict(mid_channels=CHAIN_MAX_CM), True),
    (dict(mid_channels=CHAIN_MAX_CM + 1), False),
    (dict(mid_channels=0), False),
    (dict(mid_channels=64, layout="NCHW"), False),
    (dict(mid_channels=64, dtype=torch.float16), False)])
def test_chain_supported_envelope(cfg, ok):
    assert chain_supported(**cfg) is ok


def _kernel_args(device="cpu", c1_fmt=CL, w2_fmt=CL, dtype=torch.float32,
                 cm=8):
    def z(*shape, fmt=None):
        t = torch.zeros(shape, device=device)
        return t.contiguous(memory_format=fmt) if fmt else t
    c1 = torch.zeros((2, 6, 5, 7), dtype=dtype,
                     device=device).contiguous(memory_format=c1_fmt)
    return (c1, z(6), z(6), z(cm, 6, 3, 3, fmt=w2_fmt), z(cm), z(cm),
            z(16, cm, 1, 1, fmt=CL), z(16))


@pytest.mark.parametrize("bad,match", [
    (dict(c1_fmt=torch.contiguous_format), "channels-last"),
    (dict(w2_fmt=torch.contiguous_format), "channels-last"),
    (dict(dtype=torch.float64), "float32"),
    (dict(cm=CHAIN_MAX_CM + 1), "conv2 channels")])
def test_wrapper_contract_refuses_what_the_kernels_do_not_take(bad, match):
    """The checks a CUDA tensor meets before a launch: channels-last fp32
    storage, Cm within the shared-memory budget, no silent copies."""
    def check(c1, a1, b1, w2, a2, b2, w3, b3):
        vec = {"a1": (a1, 6), "b1": (b1, 6), "a2": (a2, w2.shape[0]),
               "b2": (b2, w2.shape[0]), "b3": (b3, 16)}
        _check("chain_emit", c1, vec, w2, w3)
    check(*_kernel_args())                          # the good case
    with pytest.raises(MXNetError, match=match):
        check(*_kernel_args(**bad))
    a = _kernel_args()
    with pytest.raises(MXNetError, match="shape"):    # w3 over other Cm
        check(*a[:6], torch.zeros(16, 9, 1, 1), a[7])


def test_wrappers_refuse_past_32_bit_indices_and_other_devices():
    c1 = torch.empty((2 ** 16, 8, 64, 64), device="meta").contiguous(
        memory_format=CL)
    w2 = torch.empty((8, 8, 3, 3), device="meta").contiguous(
        memory_format=CL)
    vec = torch.empty((8,), device="meta")
    with pytest.raises(MXNetError, match="32-bit"):
        _check("chain_stats", c1, {"a1": (vec, 8), "b1": (vec, 8),
                                   "shift": (vec, 8)}, w2)
    with pytest.raises(MXNetError, match="cuda or cpu"):
        chain_stats(c1, vec, vec, w2, vec)
    with pytest.raises(MXNetError, match="cuda or cpu"):
        chain_emit(c1, vec, vec, w2, vec, vec, w2[:, :, :1, :1], vec)


def _layers(layout="NHWC", c=8, cm=8, co=16, seed=0):
    first = FusedBNReLUConv2D(cm, 3, 1, 1, layout=layout, in_channels=c,
                              fuse=False, device="cpu")
    second = FusedBNReLUConv2D(co, 1, 1, 0, layout=layout, in_channels=cm,
                               use_bias=True, fuse=False, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for layer in (first, second):
        for t in list(layer.parameters()) + list(layer.buffers()):
            t.data.copy_(torch.rand(t.shape, generator=gen) * 0.5 + 0.5)
    return first, second


@pytest.mark.parametrize("train", [True, False])
def test_layer_matches_its_two_layers_and_updates_both_bns(train):
    """FusedBottleneckChain over two FusedBNReLUConv2D layers gives what
    they give one after the other, and in train mode moves both BNs'
    running statistics towards the batch's exactly as they do."""
    first, second = _layers()
    ref1, ref2 = _layers()
    chain = FusedBottleneckChain(first, second)
    assert chain.fused and not list(chain.parameters())
    x = torch.randn(2, 8, 5, 6).contiguous(memory_format=CL)
    chain.train(train)
    ref1.train(train)
    ref2.train(train)
    with torch.no_grad():
        got = chain(x)
        ref = ref2(ref1(x))
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=3e-5)
    for mine, theirs in ((first.bn, ref1.bn), (second.bn, ref2.bn)):
        # BN2's variance: the kernels' shifted sums vs the layers'
        # unshifted ones, both single-pass fp32
        torch.testing.assert_close(mine.running_mean, theirs.running_mean,
                                   **STAT_TOL)
        torch.testing.assert_close(mine.running_var, theirs.running_var,
                                   **STAT_TOL)


def test_layer_outside_the_envelope_runs_its_layers():
    first, second = _layers(layout="NCHW")
    chain = FusedBottleneckChain(first, second)
    assert not chain.fused
    x = torch.randn(2, 8, 5, 6)
    chain.eval()
    assert not first.training and not second.training
    with torch.no_grad():
        torch.testing.assert_close(chain(x), second(first(x)))


@pytest.mark.parametrize("swap", ["order", "stride", "bias"])
def test_layer_refuses_another_structure(swap):
    first, second = _layers()
    if swap == "order":
        first, second = second, first
    elif swap == "stride":
        first = FusedBNReLUConv2D(8, 3, 2, 1, layout="NHWC", in_channels=8,
                                  device="cpu")
    else:
        second = FusedBNReLUConv2D(16, 1, 1, 0, layout="NHWC",
                                   in_channels=8, device="cpu")
    with pytest.raises(MXNetError, match="FusedBottleneckChain needs"):
        FusedBottleneckChain(first, second)


# ------------------------------------------------------------- 3xTF32
# B4 on the card multiplies in TF32 on the tensor cores, each operand
# split into two TF32 parts and three products summed (csrc/tc_gemm.cuh).
# Here both GEMMs of the plain version run in that arithmetic (fp32
# accumulation) at the bench shapes of ResNet-50's chain, K = 9C up to
# 4608, against fp64: the split must hold chip_smoke.py's kernel gate
# (CONV_RTOL, 1e-4 of max |out|) with a margin of SPLIT_MARGIN, and one
# TF32 pass must not hold it.
CONV_RTOL = 1e-4
SPLIT_MARGIN = 20.0


def _gemms(x, a1, b1, w2, a2, b2, w3, b3, product):
    """The two GEMMs of ``_chain_emit_plain`` with each convolution given
    by ``product(y, w, padding)``."""
    c2 = product(fused_chain._activate(x, a1, b1), w2, 1)
    return product(fused_chain._activate(c2, a2, b2), w3, 0) + \
        b3.view(1, -1, 1, 1)


def _conv(y, w, padding):
    return torch.nn.functional.conv2d(y, w, padding=padding)


def _tf32_once(y, w, padding):
    return _conv(tf32_rna(y), tf32_rna(w), padding)


def _tf32_split(y, w, padding):
    (yb, ys), (wb, ws) = split_tf32(y), split_tf32(w)
    return _conv(ys, wb, padding) + _conv(yb, ws, padding) + \
        _conv(yb, wb, padding)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 64, 256),
                                   (1, 8, 8, 256, 256, 1024),
                                   (1, 7, 7, 512, 512, 2048)],
                         ids=["K576", "K2304", "K4608"])
def test_3xtf32_split_holds_the_kernel_gate_and_one_pass_does_not(shape):
    n, h, w, c, cm, co = shape
    rs = np.random.RandomState(11)
    f32 = np.float32
    args = [rs.randn(n, c, h, w).astype(f32),
            rs.uniform(0.5, 1.5, c).astype(f32),
            rs.uniform(-0.1, 0.1, c).astype(f32),
            (rs.randn(cm, c, 3, 3) * np.sqrt(2.0 / (9 * c))).astype(f32),
            rs.uniform(0.5, 1.5, cm).astype(f32),
            rs.uniform(-0.1, 0.1, cm).astype(f32),
            (rs.randn(co, cm, 1, 1) * np.sqrt(2.0 / cm)).astype(f32),
            rs.uniform(-0.1, 0.1, co).astype(f32)]
    t32 = [torch.from_numpy(a) for a in args]
    ref = _gemms(*[t.double() for t in t32], product=_conv)
    scale = ref.abs().max().item()

    def err(product):
        return (_gemms(*t32, product=product).double() - ref).abs().max() \
            .item() / scale
    split, once = err(_tf32_split), err(_tf32_once)
    assert split * SPLIT_MARGIN <= CONV_RTOL, (split, once)
    assert once > CONV_RTOL, (split, once)


# B3 on the card runs conv2 in the same 3xTF32 arithmetic (the 3x3 main
# loop of csrc/tc_gemm.cuh) and sums c2 - s per channel in fp32.  Here
# the plain version of pass 1 runs in that arithmetic on the CPU (a CPU
# computation, not the card's: fp32 accumulation rounding to nearest)
# against fp64, at the same three K = 9C: the shifted sums must hold
# chip_smoke.py's gate (CHAIN_STATS_RTOL of each channel's mass for the
# sum, of the sum itself for the squares) with a margin of SPLIT_MARGIN,
# and one TF32 pass must not hold it; and the stress case's shifted var2
# must hold STRESS_VAR_RTOL.
CHAIN_STATS_RTOL = 1e-5
STRESS_VAR_RTOL = 2e-2


def _shifted_sums(x, a1, b1, w2, shift, product):
    """``(sum, sq)`` of ``c2 - shift`` over (N, H, W), c2 by
    ``product``."""
    d = product(fused_chain._activate(x, a1, b1), w2, 1) - \
        shift.view(1, -1, 1, 1)
    return d.sum((0, 2, 3)), d.square().sum((0, 2, 3))


@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 64), (1, 8, 8, 256, 256),
                                   (1, 7, 7, 512, 512)],
                         ids=["K576", "K2304", "K4608"])
def test_3xtf32_split_holds_the_chain_stats_gate_and_one_pass_does_not(
        shape):
    n, h, w, c, cm = shape
    rs = np.random.RandomState(12)
    f32 = np.float32
    args = [rs.randn(n, c, h, w).astype(f32),
            rs.uniform(0.5, 1.5, c).astype(f32),
            rs.uniform(-0.1, 0.1, c).astype(f32),
            (rs.randn(cm, c, 3, 3) * np.sqrt(2.0 / (9 * c))).astype(f32),
            rs.uniform(-0.5, 0.5, cm).astype(f32)]
    t32 = [torch.from_numpy(a) for a in args]
    t64 = [t.double() for t in t32]
    ref_sum, ref_sq = _shifted_sums(*t64, product=_conv)
    d = _conv(fused_chain._activate(*t64[:3]), t64[3], 1) - \
        t64[4].view(1, -1, 1, 1)
    mass = d.abs().sum((0, 2, 3))

    def err(product):
        got_sum, got_sq = _shifted_sums(*t32, product=product)
        return max(((got_sum.double() - ref_sum).abs() / mass).max().item(),
                   ((got_sq.double() - ref_sq).abs() / ref_sq).max().item())
    split, once = err(_tf32_split), err(_tf32_once)
    assert split * SPLIT_MARGIN <= CHAIN_STATS_RTOL, (split, once)
    assert once > CHAIN_STATS_RTOL, (split, once)


def test_3xtf32_split_keeps_the_stress_case_shifted_variance():
    """chip_smoke.py's stress case (BN2's mean ~4e3 standard deviations
    from 0) with conv2 in 3xTF32 arithmetic: var2 from the sums shifted
    by an EMA step off the mean holds STRESS_VAR_RTOL of fp64; from the
    unshifted sums it does not."""
    rs = np.random.RandomState(7)
    n, h, w, c, cm = 4, 16, 16, 16, 8

    def fp32(a):            # the values the kernel sees, kept in fp64
        return np.asarray(a, np.float32).astype(np.float64)
    c1 = fp32(rs.randn(n, h, w, c))
    mean1, var1 = c1.mean((0, 1, 2)), c1.var((0, 1, 2))
    a1 = fp32(1.0 / np.sqrt(var1 + 1e-5))
    b1 = fp32(1000.0 - mean1 * a1)
    w2 = np.zeros((cm, c, 3, 3))
    w2[:, :, 1, 1] = fp32(0.1 + 0.001 * rs.randn(cm, c))
    c2 = np.einsum("nhwc,mc->nhwm", np.maximum(c1 * a1 + b1, 0),
                   w2[:, :, 1, 1])
    mean_ref, var_ref = c2.mean((0, 1, 2)), c2.var((0, 1, 2))
    assert float(np.min(mean_ref / np.sqrt(var_ref))) > 1e3  # stressed
    x, a, b, wt = (torch.from_numpy(v.astype(np.float32))
                   for v in (c1.transpose(0, 3, 1, 2), a1, b1, w2))
    errs = []
    for shift in (mean_ref * 1.003, np.zeros(cm)):
        s = torch.from_numpy(shift.astype(np.float32))
        sums, sqs = _shifted_sums(x, a, b, wt, s, product=_tf32_split)
        count = n * h * w
        mean_d = sums.double() / count
        var2 = torch.clamp(sqs.double() / count - mean_d.square(), min=0)
        errs.append(float(np.max(np.abs(var2.numpy() - var_ref) / var_ref)))
    shifted, raw = errs
    assert shifted <= STRESS_VAR_RTOL, errs
    assert raw > 0.05, errs


# ---- the bf16 form.  On the CPU the op runs the kernels' plain versions
# in the Pallas kernel's bf16 arithmetic: conv2 of the bf16-rounded
# activation summed in fp32 and never rounded (pass 1 reduces it, pass 2
# applies BN2 to it), relu(c2*a2 + b2) rounded to bf16 before conv3,
# conv3 summed in fp32 plus b3, rounded once.  The JAX op's XLA
# composition (impl="xla", and the port's ``_chain_plain``, the
# backward's source) rounds c2 to bf16 instead.  Tolerances, in bf16
# ulps of max |out| (BF16_ULPS): against ``pallas_interpret`` observed 0;
# the statistics, rounded to bf16 as the JAX op returns them, equal.
# The kernel form and the XLA form differ by that c2 rounding: 1 bf16
# ulp of max, 0.40-0.56% of max at these shapes (BF16_FORMS_APART is
# the least of it that ``test_bf16_kernel_form_is_not_the_xla_form``
# asks for).  Gradients within BF16_GRAD_RTOL of each gradient's max:
# against ``pallas_interpret`` every one equal but b3's (1.0-2.1%: the
# frameworks reduce the bf16 cotangent in other precisions); against
# ``xla``, whose forward and so its cotangent differs, <= 2.1%.
BF16_ULPS, BF16_GRAD_RTOL, BF16_FORMS_APART = 2, 4e-2, 2.5e-3


def bf16_ulp(v):
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _bf16_args(seed, shape):
    """``_args`` rounded to bf16: (JAX arrays, the port's tensors)."""
    args = _args(seed, *shape)
    t = [torch.from_numpy(a).bfloat16() for a in args]
    t[0] = t[0].permute(0, 3, 1, 2)
    return [jnp.asarray(a, jnp.bfloat16) for a in args], t


def _err_ulps(got, ref):
    """max |got - ref| in bf16 ulps of max |ref| (NHWC ref)."""
    r = _f32(ref)
    return np.abs(_nhwc(got.float()) - r).max() / bf16_ulp(np.abs(r).max())


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_op_matches_jax_kernel(train, shape):
    """The op's bf16 output and its four statistics against the JAX op
    through its Pallas kernels in interpret mode."""
    jargs, targs = _bf16_args(sum(shape), shape)
    ref = _fused_bottleneck_chain(*jargs, layout="NHWC", eps=1e-5,
                                  impl="pallas_interpret", is_train=train)
    before = (chain_stats.launches, chain_emit.launches)
    got = fused_bottleneck_chain(*targs, eps=1e-5, train_stats=train)
    assert got[0].dtype == torch.bfloat16
    assert got[0].is_contiguous(memory_format=CL)
    assert _err_ulps(got[0], ref[0]) <= BF16_ULPS
    for g, r in zip(got[1:], ref[1:]):
        r = _f32(r)
        err = np.abs(g.bfloat16().float().numpy() - r).max()
        assert err <= bf16_ulp(np.abs(r).max()), err
    assert (chain_stats.launches, chain_emit.launches) == before


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_plain_versions_match_pallas_kernels(shape):
    """``_chain_stats_plain`` and ``_chain_emit_plain`` against the JAX
    package's two Pallas kernels in interpret mode on the same bf16 c1
    and weights and fp32 affines: BN2's mean and variance from the sums
    (fp32, other summation orders: STAT_TOL), and pass 2's bf16 output."""
    from incubator_mxnet_tpu.ops import fused_chain as jfc
    n, h, w, c, cm, co = shape
    jargs, targs = _bf16_args(200 + sum(shape), shape)
    rs = np.random.RandomState(sum(shape))
    vec = [(rs.rand(k) + 0.5).astype(np.float32) if i % 2 == 0 else
           (rs.randn(k) * 0.1).astype(np.float32)
           for i, k in enumerate((c, c, cm, cm))]
    shift = (rs.randn(cm) * 0.1).astype(np.float32)
    a1, b1, a2, b2 = vec
    b3 = _f32(jargs[11])
    mean2, var2 = jfc._pallas_chain_stats(
        jargs[0], jnp.asarray(a1), jnp.asarray(b1), jfc._merge_w2(jargs[5]),
        jnp.asarray(shift), cm, co, True)
    out = jfc._pallas_chain_emit(
        jargs[0], jnp.asarray(a1), jnp.asarray(b1), jfc._merge_w2(jargs[5]),
        jnp.asarray(a2), jnp.asarray(b2),
        jargs[10].reshape(co, cm).T, jnp.asarray(b3), True)
    t = {k: torch.from_numpy(v) for k, v in
         dict(a1=a1, b1=b1, a2=a2, b2=b2, shift=shift, b3=b3).items()}
    x, w2, w3 = targs[0], targs[5], targs[10]
    sums, sqs = fused_chain._chain_stats_plain(x, t["a1"], t["b1"], w2,
                                               t["shift"])
    count = n * h * w
    mean_d = sums / count
    np.testing.assert_allclose((mean_d + t["shift"]).numpy(), _f32(mean2),
                               **STAT_TOL)
    np.testing.assert_allclose(
        torch.clamp(sqs / count - mean_d.square(), min=0).numpy(),
        _f32(var2), **STAT_TOL)
    got = fused_chain._chain_emit_plain(x, t["a1"], t["b1"], w2, t["a2"],
                                        t["b2"], w3, t["b3"])
    assert got.dtype == torch.bfloat16
    assert _err_ulps(got, out) <= BF16_ULPS


@pytest.mark.parametrize("train", [True, False])
def test_bf16_kernel_form_is_not_the_xla_form(train):
    """The op's forward (the kernels' form: c2 kept in fp32) equals the
    Pallas kernel's, and ``_chain_plain`` (the XLA composition: c2
    rounded to bf16) the JAX XLA form's, each within one bf16 ulp of max;
    the two forms lie BF16_FORMS_APART of max or more apart, so neither
    can quietly take the other's place."""
    jargs, targs = _bf16_args(sum(SHAPES[0]), SHAPES[0])
    ref = {impl: _fused_bottleneck_chain(*jargs, layout="NHWC", eps=1e-5,
                                         impl=impl, is_train=train)[0]
           for impl in ("pallas_interpret", "xla")}
    kernel_form = fused_bottleneck_chain(*targs, eps=1e-5,
                                         train_stats=train)[0]
    xla_form = fused_chain._chain_plain(*targs[:11], targs[11].float(),
                                        1e-5, False, train)[0]
    assert _err_ulps(kernel_form, ref["pallas_interpret"]) <= 1
    assert _err_ulps(xla_form, ref["xla"]) <= 1
    for got, other in ((kernel_form, ref["xla"]),
                       (xla_form, ref["pallas_interpret"])):
        r = _f32(other)
        apart = np.abs(_nhwc(got.float()) - r).max() / np.abs(r).max()
        assert apart >= BF16_FORMS_APART, apart


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_gradients_match_jax(impl, shape):
    """The autograd.Function's bf16 gradients of c1, both BNs' gamma and
    beta, w2, w3 and b3 under the chain-gradient loss (on the outputs
    cast to fp32) against jax.grad of the JAX op in bf16."""
    jargs, targs = _bf16_args(100 + sum(shape), shape)

    def jloss(*a):
        out = _fused_bottleneck_chain(*a, layout="NHWC", eps=1e-5,
                                      impl=impl)
        return _loss([o.astype(jnp.float32) for o in out])

    ref = jax.grad(jloss, argnums=DIFF)(*jargs)
    for i in DIFF:
        targs[i] = targs[i].detach().requires_grad_(True)
    out = fused_bottleneck_chain(*targs, eps=1e-5)
    _loss([o.float() for o in out]).backward()
    for i, r in zip(DIFF, ref):
        g = targs[i].grad.float()
        got = _nhwc(g) if i == 0 else g.numpy()
        r = _f32(r)
        err = np.abs(got - r).max()
        assert err <= BF16_GRAD_RTOL * np.abs(r).max(), (i, err)
