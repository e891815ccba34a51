"""The ``nd`` ops the port's Gluon layers call (``Convolution``,
``Deconvolution``, ``Pooling``, ``BatchNorm``, ``Dropout``, ``LeakyReLU``,
``LayerNorm``, ``InstanceNorm``, ``Embedding``, ``Pad``,
``_FusedBatchNormRelu``, ``_FusedBNReluConv``, ``_FusedBottleneckChain``,
``L2Normalization``, ``LRN``, ``UpSampling``) against the JAX package's
ops on the CPU: the output and the gradient of every float input under
a seeded head gradient, within 1e-5 of each array's max |value|; the JAX
fused ops both as ``impl="pallas_interpret"`` (their Pallas kernels,
interpreted) and ``"xla"``.  The moving-statistic fold of ``invoke`` is
held exactly against the fold computed by hand from the op's own batch
statistics, and against the JAX front end's within 1e-6."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops.fused_chain import chain_emit, chain_stats
from incubator_mxnet_tpu_torch.ops.fused_conv import sbr_conv3x3, sbr_matmul

REL = 1e-5


def _rand(rs, *shape, scale=1.0, shift=0.0):
    return (rs.randn(*shape) * scale + shift).astype(np.float32)


def _pos(rs, *shape):
    return (rs.rand(*shape) + 0.5).astype(np.float32)


def _run(mx, op, arrays, attrs, diff, train=True, head=None):
    """``nd.<op>`` on the CPU under ``record(train_mode=train)``; returns
    the first output, the gradients of the inputs ``diff`` under the
    head gradient ``head`` (default: seeded normal), and the input
    NDArrays."""
    with mx.cpu():
        nds = [None if a is None else mx.nd.array(a, dtype=a.dtype)
               for a in arrays]
        for i in diff:
            nds[i].attach_grad()
        with mx.autograd.record(train_mode=train):
            out = getattr(mx.nd, op)(*nds, **attrs)
        o = out[0] if isinstance(out, list) else out
        if head is None:
            head = np.random.RandomState(99).randn(*o.shape)
        o.backward(mx.nd.array(head.astype(np.float32)))
        return o.asnumpy(), [nds[i].grad.asnumpy() for i in diff], nds


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= REL * scale, (what, err, scale)


def _check(op, arrays, attrs, diff, train=True, jax_attrs=None):
    ref = _run(jmx, op, arrays, dict(attrs, **(jax_attrs or {})), diff,
               train)
    got = _run(tmx, op, arrays, attrs, diff, train)
    _close(got[0], ref[0], "out")
    for i, g, r in zip(diff, got[1], ref[1]):
        _close(g, r, f"grad {i}")
    return got, ref


# ------------------------------------------------------------- convolution
CONV_CASES = {
    "2d": ((2, 4, 7, 7), (6, 2, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                           pad=(1, 1), num_group=2)),
    "2d_dilate": ((2, 3, 8, 8), (5, 3, 3, 3), dict(kernel=(3, 3),
                                                  dilate=(2, 2))),
    "2d_nhwc": ((2, 7, 7, 3), (5, 3, 3, 3), dict(kernel=(3, 3), pad=(1, 1),
                                                layout="NHWC")),
    "1d": ((2, 3, 9), (4, 3, 3), dict(kernel=(3,), stride=(2,))),
    "3d": ((1, 2, 4, 5, 5), (3, 2, 2, 3, 3), dict(kernel=(2, 3, 3),
                                                 pad=(0, 1, 1))),
    "1x1_strided": ((2, 4, 6, 6), (3, 4, 1, 1), dict(kernel=(1, 1),
                                                    stride=(2, 2))),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("bias", [False, True])
def test_convolution(case, bias):
    dshape, wshape, attrs = CONV_CASES[case]
    rs = np.random.RandomState(len(case) + bias)
    cout = wshape[0]
    arrays = [_rand(rs, *dshape), _rand(rs, *wshape, scale=0.3),
              _rand(rs, cout) if bias else None]
    _check("Convolution", arrays, dict(attrs, num_filter=cout,
                                       no_bias=not bias),
           [0, 1, 2] if bias else [0, 1])


DECONV_CASES = {
    "2d": ((2, 4, 5, 5), (4, 3, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                           pad=(1, 1), adj=(1, 1))),
    "2d_group": ((2, 4, 4, 4), (4, 2, 2, 2), dict(kernel=(2, 2),
                                                 stride=(2, 2),
                                                 num_group=2)),
    "2d_nhwc": ((2, 5, 5, 3), (3, 4, 3, 3), dict(kernel=(3, 3),
                                                stride=(2, 2),
                                                layout="NHWC")),
    "1d": ((2, 3, 6), (3, 2, 4), dict(kernel=(4,), stride=(2,), pad=(1,))),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution(case):
    dshape, wshape, attrs = DECONV_CASES[case]
    rs = np.random.RandomState(len(case))
    cout = wshape[1] * attrs.get("num_group", 1)
    arrays = [_rand(rs, *dshape), _rand(rs, *wshape, scale=0.3),
              _rand(rs, cout)]
    _check("Deconvolution", arrays, dict(attrs, num_filter=cout,
                                         no_bias=False), [0, 1, 2])


# ------------------------------------------------------------- pooling
POOL_CASES = {
    "max": ((2, 3, 7, 7), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    "max_full": ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                    pooling_convention="full")),
    "avg": ((2, 3, 7, 7), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               pool_type="avg")),
    "avg_exclude_pad": ((2, 3, 7, 7), dict(kernel=(3, 3), stride=(2, 2),
                                           pad=(1, 1), pool_type="avg",
                                           count_include_pad=False)),
    "avg_full": ((2, 3, 8, 8), dict(kernel=(2, 2), stride=(3, 3),
                                    pool_type="avg",
                                    pooling_convention="full")),
    "sum": ((2, 3, 6, 6), dict(kernel=(2, 2), stride=(2, 2),
                               pool_type="sum")),
    "max_nhwc": ((2, 7, 7, 3), dict(kernel=(3, 3), stride=(2, 2),
                                    pad=(1, 1), layout="NHWC")),
    "global_avg": ((2, 3, 5, 5), dict(global_pool=True, pool_type="avg")),
    "global_max_nhwc": ((2, 5, 5, 3), dict(global_pool=True,
                                           layout="NHWC")),
    "max_1d": ((2, 3, 9), dict(kernel=(3,), stride=(2,))),
    "avg_3d": ((1, 2, 4, 6, 6), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                     pool_type="avg")),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling(case):
    shape, attrs = POOL_CASES[case]
    rs = np.random.RandomState(len(case))
    _check("Pooling", [_rand(rs, *shape)], attrs, [0])


# ------------------------------------------------------------- activations
@pytest.mark.parametrize("act", ["leaky", "prelu", "elu", "selu", "rrelu"])
def test_leaky_relu(act):
    rs = np.random.RandomState(3)
    arrays = [_rand(rs, 2, 4, 3, 3)]
    diff = [0]
    if act == "prelu":
        arrays.append(_pos(rs, 4) * 0.3)
        diff = [0, 1]
    _check("LeakyReLU", arrays, dict(act_type=act, slope=0.2), diff)


# ------------------------------------------------------------- normalization
def _bn_arrays(rs, shape, axis):
    c = shape[axis]
    return [_rand(rs, *shape, scale=2.0, shift=0.5), _pos(rs, c),
            _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1), _pos(rs, c)]


BN_OPS = ["BatchNorm", "_FusedBatchNormRelu"]


@pytest.mark.parametrize("op", BN_OPS)
@pytest.mark.parametrize("axis", [1, 3])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_ops(op, axis, train, fix_gamma):
    rs = np.random.RandomState(axis + 2 * train)
    arrays = _bn_arrays(rs, (2, 5, 4, 6), axis)
    attrs = dict(axis=axis, eps=1e-3, momentum=0.8, fix_gamma=fix_gamma)
    diff = [0, 2] if fix_gamma else [0, 1, 2]
    got, ref = _check(op, arrays, attrs, diff, train)
    for i in (3, 4):        # the moving statistics after the fold
        _close(got[2][i].asnumpy(), ref[2][i].asnumpy(), f"moving {i}")


@pytest.mark.parametrize("op", BN_OPS + ["_FusedBNReluConv"])
def test_moving_stat_fold_is_exact(op):
    """The fold equals ``momentum * moving + (1 - momentum) * batch``
    computed by hand from the op's own batch statistics
    (``output_mean_var``), bit for bit; in eval, or with
    ``use_global_stats``, nothing moves; without ``output_mean_var``
    the op returns the output alone."""
    rs = np.random.RandomState(5)
    arrays = _bn_arrays(rs, (2, 4, 5, 3), 3 if op == "_FusedBNReluConv"
                        else 1)
    attrs = dict(momentum=0.7)
    if op == "_FusedBNReluConv":
        arrays.append(_rand(rs, 6, 3, 1, 1))
        attrs.update(kernel=(1, 1), layout="NHWC")
    with tmx.cpu():
        nds = [tmx.nd.array(a) for a in arrays]
        before = [nds[i].asnumpy() for i in (3, 4)]
        with tmx.autograd.train_mode():
            out = getattr(tmx.nd, op)(*nds, output_mean_var=True, **attrs)
        assert isinstance(out, list) and len(out) == 3
        for i, stat in zip((3, 4), out[1:]):
            m = np.float32(0.7)
            want = m * before[i - 3] + np.float32(1 - 0.7) * stat.asnumpy()
            np.testing.assert_array_equal(nds[i].asnumpy(), want)
        moved = [nds[i].asnumpy() for i in (3, 4)]
        y = getattr(tmx.nd, op)(*nds, **attrs)          # eval: no fold
        assert isinstance(y, tmx.nd.NDArray)
        with tmx.autograd.train_mode():
            getattr(tmx.nd, op)(*nds, use_global_stats=True, **attrs)
        for i in (3, 4):
            np.testing.assert_array_equal(nds[i].asnumpy(), moved[i - 3])


def test_chain_fold_moves_both_pairs():
    """``_FusedBottleneckChain`` folds (mean1, var1) into inputs 3-4 and
    (mean2, var2) into inputs 8-9."""
    args = _chain_args(np.random.RandomState(2), (2, 5, 5, 6), 4, 8)
    with tmx.cpu():
        nds = [tmx.nd.array(a) for a in args]
        before = [nds[i].asnumpy() for i in (3, 4, 8, 9)]
        with tmx.autograd.train_mode():
            out = tmx.nd._FusedBottleneckChain(*nds, layout="NHWC",
                                               momentum=0.6,
                                               output_mean_var=True)
        assert len(out) == 5
        for i, b, stat in zip((3, 4, 8, 9), before, out[1:]):
            want = np.float32(0.6) * b + np.float32(1 - 0.6) * \
                stat.asnumpy()
            np.testing.assert_array_equal(nds[i].asnumpy(), want)


@pytest.mark.parametrize("op,attrs", [
    ("LayerNorm", dict(axis=-1, eps=1e-5)),
    ("LayerNorm", dict(axis=1, eps=1e-5)),
    ("InstanceNorm", dict(eps=1e-3))])
def test_layer_and_instance_norm(op, attrs):
    rs = np.random.RandomState(7)
    shape = (2, 4, 3, 5)
    c = shape[attrs.get("axis", 1)]
    _check(op, [_rand(rs, *shape, shift=0.3), _pos(rs, c),
                _rand(rs, c, scale=0.1)], attrs, [0, 1, 2])


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    rs = np.random.RandomState(8)
    _check("L2Normalization", [_rand(rs, 2, 3, 4, 4)], dict(mode=mode), [0])


def test_lrn():
    rs = np.random.RandomState(9)
    _check("LRN", [_rand(rs, 2, 6, 4, 4)], dict(nsize=3, alpha=1e-2,
                                                beta=0.75, knorm=2.0), [0])


# ------------------------------------------------------------- indexing
def test_embedding():
    rs = np.random.RandomState(10)
    idx = np.array([[0, 3, 5], [5, 1, -1]], np.float32)
    _check("Embedding", [idx, _rand(rs, 6, 4)],
           dict(input_dim=6, output_dim=4), [1])


def test_embedding_out_of_range_is_nan():
    with tmx.cpu():
        w = tmx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
        got = tmx.nd.Embedding(tmx.nd.array([1, 4, -5]), w).asnumpy()
    assert np.array_equal(got[0], [3, 4, 5])
    assert np.isnan(got[1:]).all()


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad(mode):
    rs = np.random.RandomState(11)
    attrs = dict(mode=mode, pad_width=(0, 0, 0, 0, 2, 1, 1, 3))
    if mode == "constant":
        attrs["constant_value"] = 0.5
    _check("Pad", [_rand(rs, 2, 3, 4, 5)], attrs, [0])


@pytest.mark.parametrize("case", ["nearest", "nearest_concat",
                                  "nearest_sum", "bilinear"])
def test_upsampling(case):
    rs = np.random.RandomState(12)
    a = _rand(rs, 2, 3, 4, 4)
    if case == "nearest":
        _check("UpSampling", [a], dict(scale=2, sample_type="nearest"), [0])
    elif case == "bilinear":
        _check("UpSampling", [a], dict(scale=2, sample_type="bilinear"),
               [0])
    else:
        b = _rand(rs, 2, 3, 8, 8)
        _check("UpSampling", [a, b], dict(
            scale=2, sample_type="nearest", num_args=2,
            multi_input_mode=case.split("_")[1]), [0, 1])


# ------------------------------------------------------------- dropout
def test_dropout_train_and_eval():
    """Dropout keeps each element with probability 1 - p, scaled by
    1 / (1 - p), and its gradient is the same mask; the identity in eval
    and at p=0.  The mask's bits come from the port's generator, so the
    JAX op is matched by these properties, not bit for bit."""
    x = np.random.RandomState(13).rand(64, 64).astype(np.float32) + 1
    with tmx.cpu():
        tmx.random.seed(3)
        a = tmx.nd.array(x)
        a.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.Dropout(a, p=0.25)
        y.backward()
        out, g = y.asnumpy(), a.grad.asnumpy()
        kept = out != 0
        assert 0.70 < kept.mean() < 0.80
        np.testing.assert_allclose(out[kept], x[kept] / 0.75, rtol=1e-6)
        np.testing.assert_array_equal(g, kept / np.float32(0.75))
        np.testing.assert_array_equal(
            tmx.nd.Dropout(tmx.nd.array(x), p=0.25).asnumpy(), x)
        with tmx.autograd.record():
            same = tmx.nd.Dropout(tmx.nd.array(x), p=0.0)
        np.testing.assert_array_equal(same.asnumpy(), x)
        with tmx.autograd.record():
            rows = tmx.nd.Dropout(tmx.nd.array(x), p=0.5, axes=(1,))
        r = rows.asnumpy() != 0
        assert (r.all(1) | ~r.any(1)).all()     # one mask per row


# ------------------------------------------------------------- fused ops
def _fused_args(rs, shape, cout, kern, bias):
    c = shape[-1]
    return [_rand(rs, *shape), _pos(rs, c), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.1), _pos(rs, c),
            _rand(rs, cout, c, *kern, scale=0.2),
            _rand(rs, cout) if bias else None]


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("kern", [(1, 1), (3, 3)])
@pytest.mark.parametrize("train", [True, False])
def test_fused_bn_relu_conv_kernel_path(impl, kern, train):
    """NHWC, stride 1, 1x1 pad 0 / 3x3 pad 1: the port's kernel path (the
    plain versions of B1 / B2 on the CPU, no launch counted), with
    non-square channel counts so a wrong weight permutation shows."""
    rs = np.random.RandomState(14 + kern[0])
    shape = (2, 8, 8, 16) if kern == (1, 1) else (2, 9, 10, 16)
    arrays = _fused_args(rs, shape, 24, kern, True)
    before = (sbr_matmul.launches, sbr_conv3x3.launches)
    got, ref = _check("_FusedBNReluConv", arrays, dict(
        kernel=kern, pad=(kern[0] // 2,) * 2, layout="NHWC", eps=1e-5,
        momentum=0.9), [0, 1, 2, 5, 6], train, jax_attrs=dict(impl=impl))
    for i in (3, 4):
        _close(got[2][i].asnumpy(), ref[2][i].asnumpy(), f"moving {i}")
    assert (sbr_matmul.launches, sbr_conv3x3.launches) == before


@pytest.mark.parametrize("case", ["strided", "nchw", "grouped", "5x5"])
def test_fused_bn_relu_conv_plain_path(case):
    """Configurations outside the kernels' envelope take the plain
    composition, as the JAX op takes its XLA one."""
    rs = np.random.RandomState(15)
    kern, attrs = (3, 3), dict(layout="NHWC", pad=(1, 1))
    shape, cin = (2, 7, 7, 4), 4
    if case == "strided":
        attrs["stride"] = (2, 2)
    elif case == "nchw":
        attrs["layout"] = "NCHW"
        shape = (2, 4, 7, 7)
    elif case == "grouped":
        attrs["num_group"] = 2
        cin = 2
    else:
        kern, attrs["pad"] = (5, 5), (2, 2)
    arrays = _fused_args(rs, shape, 6, kern, True)
    arrays[5] = _rand(rs, 6, cin, *kern, scale=0.2)
    if case == "nchw":
        c = shape[1]
        arrays[1:5] = [_pos(rs, c), _rand(rs, c, scale=0.1),
                       _rand(rs, c, scale=0.1), _pos(rs, c)]
    _check("_FusedBNReluConv", arrays, dict(attrs, kernel=kern),
           [0, 1, 2, 5, 6])


def _chain_args(rs, shape, cm, co):
    c = shape[-1]

    def bn(n):
        return [_pos(rs, n), _rand(rs, n, scale=0.1), _rand(rs, n, scale=0.1),
                _pos(rs, n)]
    return [_rand(rs, *shape)] + bn(c) + [_rand(rs, cm, c, 3, 3, scale=0.2)] \
        + bn(cm) + [_rand(rs, co, cm, 1, 1, scale=0.2), _rand(rs, co)]


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("train", [True, False])
def test_fused_bottleneck_chain(impl, train):
    rs = np.random.RandomState(16)
    arrays = _chain_args(rs, (2, 8, 8, 16), 8, 24)
    before = (chain_stats.launches, chain_emit.launches)
    got, ref = _check("_FusedBottleneckChain", arrays, dict(
        layout="NHWC", eps=1e-5, momentum=0.9),
        [0, 1, 2, 5, 6, 7, 10, 11], train, jax_attrs=dict(impl=impl))
    for i in (3, 4, 8, 9):
        _close(got[2][i].asnumpy(), ref[2][i].asnumpy(), f"moving {i}")
    assert (chain_stats.launches, chain_emit.launches) == before


def test_fused_bottleneck_chain_nchw_plain():
    """NCHW data takes the plain composition (the JAX op gates the chain
    to NHWC): the same values as the JAX op on the NHWC data."""
    rs = np.random.RandomState(17)
    arrays = _chain_args(rs, (2, 5, 5, 4), 4, 6)
    head = rs.randn(2, 5, 5, 6)
    ref = _run(jmx, "_FusedBottleneckChain", arrays,
               dict(layout="NHWC", impl="xla"), [0, 1, 5, 10], head=head)
    nchw = [np.ascontiguousarray(arrays[0].transpose(0, 3, 1, 2))] + \
        arrays[1:]
    got = _run(tmx, "_FusedBottleneckChain", nchw, dict(layout="NCHW"),
               [0, 1, 5, 10], head=head.transpose(0, 3, 1, 2))
    _close(got[0].transpose(0, 2, 3, 1), ref[0], "out")
    _close(got[1][0].transpose(0, 2, 3, 1), ref[1][0], "grad 0")
    for i, (g, r) in enumerate(zip(got[1][1:], ref[1][1:])):
        _close(g, r, f"grad {i + 1}")


def test_fused_ops_reject_what_jax_rejects():
    rs = np.random.RandomState(18)
    args = _chain_args(rs, (1, 4, 4, 4), 4, 4)
    args[5] = _rand(rs, 4, 4, 1, 1)
    with tmx.cpu():
        with pytest.raises(ValueError, match="3x3 then a 1x1"):
            tmx.nd._FusedBottleneckChain(*[tmx.nd.array(a) for a in args],
                                         layout="NHWC")
        fused = [tmx.nd.array(a) for a in _fused_args(
            rs, (1, 4, 4, 4), 4, (3, 3), False)[:6]]
        with pytest.raises(ValueError, match="kernel path"):
            tmx.nd._FusedBNReluConv(*fused, kernel=(3, 3), pad=(1, 1),
                                    stride=(2, 2), layout="NHWC",
                                    impl="pallas")
