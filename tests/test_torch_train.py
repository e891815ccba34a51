"""ResNet V1 training in the PyTorch port against the JAX package: the
BatchNorm train form and its moving averages (fp32 and bf16), the train
form of the fused BN -> ReLU -> conv op, the softmax cross-entropy loss,
the SGD update and its multi-precision form, and three steps of
``parallel.TrainStep`` on a small ResNet V1 in every ``fuse_block``
mode; and what the step refuses.

Both sides get the same inputs and weights from a seeded numpy stream
(the weights through ``convert.resnet_params_from_numpy``).  The JAX
side runs as its own tests run it on the CPU: its ops and layers on
their XLA path, its ``TrainStep`` compiled.  The JAX nets are built and
stepped once per module (fixture): their first forward and step compile
(~20 s for the first mode, a few seconds for the others).

Tolerances.  Single ops: fp32 on both sides, other summation orders,
atol = rtol = 1e-5 (gradients 2e-5).  Three training steps: every
final parameter and moving statistic within 1e-4 of that tensor's
largest magnitude, plus 1e-6: the two frameworks round the ~50 fp32
convolutions of a step (and their gradients) in other orders and the
differences compound over three updates at lr 0.1 (observed up to
7e-6 of max); the absolute floor is for the conv biases that feed a
BatchNorm, which cancels them, so their true gradient is 0 and what
they carry is rounding noise of ~1e-9.  Losses within 1e-4 relative,
for the same reason (observed up to 1.3e-5 at the third step, where
the loss is ~0.19)."""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.gluon.model_zoo.vision import (
    BottleneckV1 as JaxBottleneckV1, ResNetV1 as JaxResNetV1)
from incubator_mxnet_tpu.ops.fused_conv import _fused_bn_relu_conv
from incubator_mxnet_tpu.ops.nn import _batch_norm
from incubator_mxnet_tpu.ops.optimizer_ops import (_mp_sgd_mom_update,
                                                   _mp_sgd_update,
                                                   _sgd_mom_update,
                                                   _sgd_update)
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import resnet_params_from_numpy
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    BatchNorm, SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.lr_scheduler import FactorScheduler
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                              ResNetV1)
from incubator_mxnet_tpu_torch.ops.fused_chain import (chain_emit,
                                                       chain_stats)
from incubator_mxnet_tpu_torch.ops.fused_conv import (fused_bn_relu_conv,
                                                      sbr_conv3x3,
                                                      sbr_matmul)
from incubator_mxnet_tpu_torch.optimizer import (SGD, mp_sgd_mom_update,
                                                 mp_sgd_update,
                                                 sgd_mom_update, sgd_update)
from incubator_mxnet_tpu_torch.parallel import EvalStep, TrainStep
from torch_port_helpers import seeded_fill

TOL = dict(atol=1e-5, rtol=1e-5)
CL = torch.channels_last
MODES = ["chain", True, False]
NET = dict(classes=10, thumbnail=True, layout="NHWC")
SPEC = ([1, 2, 1, 1], [16, 32, 64, 128, 256])
BATCH = (4, 16, 16, 3)
STEPS = 3
SGD_KW = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-4


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


# ------------------------------------------------------------ single ops
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_train_matches_jax_with_moving_average(fix_gamma):
    """Train-mode BatchNorm: output and gradients against the JAX op with
    ``is_train=True``, and the running statistics after the update
    against the JAX frontend's EMA of the op's batch statistics (momentum 0.9,
    the biased variance)."""
    import jax
    rs = np.random.RandomState(11)
    f = np.float32
    x = (rs.randn(4, 6, 5, 3) * 2 + 1).astype(f)
    gamma, beta = (rs.rand(6) + 0.5).astype(f), rs.randn(6).astype(f)
    rmean, rvar = rs.randn(6).astype(f), (rs.rand(6) + 0.5).astype(f)

    def jfwd(x_, g_, b_):
        return _batch_norm(x_, g_, b_, jnp.asarray(rmean), jnp.asarray(rvar),
                           eps=1e-5, fix_gamma=fix_gamma, axis=1,
                           is_train=True)

    ref, bmean, bvar = jfwd(*map(jnp.asarray, (x, gamma, beta)))
    jgrads = jax.grad(lambda *a: jnp.sum(jfwd(*a)[0] ** 3),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (x, gamma, beta)))
    bn = BatchNorm(6, epsilon=1e-5, scale=not fix_gamma, device="cpu")
    bn.load_state_dict(dict(zip(
        ("gamma", "beta", "running_mean", "running_var"),
        map(torch.from_numpy, (gamma, beta, rmean, rvar)))))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = bn.train()(tx)
    (got ** 3).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    for g, r in zip((tx.grad, bn.gamma.grad, bn.beta.grad), jgrads):
        if fix_gamma and g is bn.gamma.grad:
            continue        # gamma is fixed at 1: no gradient on either side
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=2e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.9 * rmean + 0.1 * np.asarray(bmean), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * rvar + 0.1 * np.asarray(bvar), **TOL)


@pytest.mark.parametrize("kern", [(1, 1), (3, 3)])
def test_fused_op_train_form_matches_jax(kern):
    """``fused_bn_relu_conv`` with ``train_stats``: output, batch
    statistics and gradients against the JAX op with ``is_train=True``
    on its XLA path."""
    import jax
    rs = np.random.RandomState(kern[0])
    f = np.float32
    c, cout = 8, 12
    args = [rs.randn(2, 6, 7, c).astype(f), (rs.rand(c) + 0.5).astype(f),
            (rs.randn(c) * 0.1).astype(f), (rs.randn(c) * 0.1).astype(f),
            (rs.rand(c) + 0.5).astype(f),
            (rs.randn(cout, c, *kern) * 0.1).astype(f),
            (rs.randn(cout) * 0.1).astype(f)]
    pad = (kern[0] // 2,) * 2
    diff = (0, 1, 2, 5, 6)

    def jfwd(*a):
        return _fused_bn_relu_conv(*a, kernel=kern, stride=(1, 1), pad=pad,
                                   layout="NHWC", eps=1e-5, impl="xla",
                                   is_train=True)

    jargs = [jnp.asarray(a) for a in args]
    ref = jfwd(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jfwd(*a)[0] ** 2)
                      + jnp.sum(jfwd(*a)[2]), argnums=diff)(*jargs)
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = _nchw(args[0])
    for i in diff:
        targs[i] = targs[i].detach().clone().requires_grad_(True)
    out, mean, var = fused_bn_relu_conv(*targs, kernel=kern, eps=1e-5,
                                        train_stats=True,
                                        output_mean_var=True)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref[0]), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(ref[1]),
                               **TOL)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(ref[2]),
                               **TOL)
    ((out ** 2).sum() + var.sum()).backward()
    for i, r in zip(diff, jgrads):
        g = targs[i].grad
        got = g.permute(0, 2, 3, 1).numpy() if i == 0 else g.numpy()
        np.testing.assert_allclose(got, np.asarray(r), atol=2e-5, rtol=2e-5,
                                   err_msg=str(i))


@pytest.mark.parametrize("kw", [dict(), dict(sparse_label=False),
                                dict(weight=0.5), dict(sample_weight=True),
                                dict(from_logits=True)])
def test_softmax_cross_entropy_matches_jax(kw):
    kw = dict(kw)
    rs = np.random.RandomState(4)
    pred = rs.randn(5, 7).astype(np.float32)
    label = rs.randint(0, 7, 5).astype(np.float32)
    if kw.get("sparse_label") is False:
        label = np.eye(7, dtype=np.float32)[label.astype(int)]
    sw = rs.rand(5, 1).astype(np.float32) if kw.pop("sample_weight", None) \
        else None
    ref = jax_gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        mx.nd.array(pred), mx.nd.array(label),
        None if sw is None else mx.nd.array(sw)).asnumpy()
    got = SoftmaxCrossEntropyLoss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(label),
        None if sw is None else torch.from_numpy(sw))
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("extra", [dict(), dict(rescale_grad=0.5,
                                                clip_gradient=0.3)])
def test_sgd_update_matches_jax(momentum, extra):
    """One update, weight and momentum, against the JAX package's
    ``sgd_mom_update`` / ``sgd_update`` ops (the exact order: rescale,
    clip, ``mom = momentum*mom - lr*(g + wd*w)``, ``w += mom``)."""
    rs = np.random.RandomState(5)
    w, g, m = (rs.randn(3, 4).astype(np.float32) for _ in range(3))
    lr, wd = 0.1, 1e-2
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    if momentum:
        rw, rm = _sgd_mom_update(jnp.asarray(w), jnp.asarray(g),
                                 jnp.asarray(m), lr=lr, momentum=momentum,
                                 wd=wd, **extra)
        sgd_mom_update(tw, torch.from_numpy(g), tm, lr, momentum, wd,
                       **extra)
        np.testing.assert_allclose(tm.numpy(), np.asarray(rm), **TOL)
    else:
        rw = _sgd_update(jnp.asarray(w), jnp.asarray(g), lr=lr, wd=wd,
                         **extra)
        sgd_update(tw, torch.from_numpy(g), lr, wd, **extra)
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), **TOL)
    # the optimizer object: lr_mult / wd_mult, and its state
    opt = SGD(learning_rate=lr, momentum=momentum, wd=wd, **extra)
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    p.lr_mult, p.wd_mult = 2.0, 0.0
    opt.param_dict = {0: p}
    state = opt.create_state(0, p)
    opt.update(0, p, torch.from_numpy(g), state)
    q, qm = torch.from_numpy(w.copy()), torch.zeros(3, 4)
    if momentum:
        sgd_mom_update(q, torch.from_numpy(g), qm, 2 * lr, momentum, 0.0,
                       **extra)
    else:
        sgd_update(q, torch.from_numpy(g), 2 * lr, 0.0, **extra)
    torch.testing.assert_close(p.data, q)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_bf16_matches_jax(train):
    """BatchNorm on a bf16 x (the TrainStep bf16_compute form, with bf16
    parameters) against the JAX op in bf16: the output within 2^-8 of
    its max (one bf16 rounding step; the same formula in the same
    dtype), the running statistics after the update on bf16 buffers
    likewise."""
    rs = np.random.RandomState(12)
    f = np.float32
    x = (rs.randn(4, 6, 5, 3) * 2 + 1).astype(f)
    vecs = [(rs.rand(6) + 0.5).astype(f), rs.randn(6).astype(f),
            rs.randn(6).astype(f), (rs.rand(6) + 0.5).astype(f)]
    bf = jnp.bfloat16
    ref, bmean, bvar = _batch_norm(
        *(jnp.asarray(a).astype(bf) for a in [x] + vecs), eps=1e-5,
        fix_gamma=False, axis=1, is_train=train)
    bn = BatchNorm(6, epsilon=1e-5, device="cpu", dtype=torch.bfloat16)
    bn.load_state_dict(dict(zip(
        ("gamma", "beta", "running_mean", "running_var"),
        (torch.from_numpy(a).bfloat16() for a in vecs))))
    with torch.no_grad():
        got = bn.train(train)(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref).astype(f)
    assert np.abs(got.float().numpy() - ref).max() <= \
        2 ** -8 * np.abs(ref).max()
    if train:
        for run, init, b in ((bn.running_mean, vecs[2], bmean),
                             (bn.running_var, vecs[3], bvar)):
            want = (0.9 * jnp.asarray(init).astype(bf) +
                    0.1 * b).astype(jnp.float32)
            np.testing.assert_allclose(run.float().numpy(),
                                       np.asarray(want), rtol=2 ** -8)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("extra", [dict(), dict(rescale_grad=0.5,
                                                clip_gradient=0.3)])
def test_mp_sgd_update_matches_jax(momentum, extra):
    """``mp_sgd_mom_update`` / ``mp_sgd_update`` on a bf16 weight with its
    fp32 master, as functions, as ``mx.nd`` ops and through
    ``SGD(multi_precision=True)``, against the JAX ops: the fp32 master
    and momentum to 1e-6, the bf16 weight exactly (rounded from the same
    master)."""
    rs = np.random.RandomState(6)
    w32, g, m = (rs.randn(3, 4).astype(np.float32) for _ in range(3))
    lr, wd = 0.1, 1e-2
    bf = jnp.bfloat16
    jw = jnp.asarray(w32).astype(bf)
    if momentum:
        refs = _mp_sgd_mom_update(jw, jnp.asarray(g).astype(bf),
                                  jnp.asarray(m), jnp.asarray(w32), lr=lr,
                                  momentum=momentum, wd=wd, **extra)
    else:
        refs = _mp_sgd_update(jw, jnp.asarray(g).astype(bf),
                              jnp.asarray(w32), lr=lr, wd=wd, **extra)
    refs = [np.asarray(r).astype(np.float32) for r in refs]

    def check(outs):
        assert outs[0].dtype == torch.bfloat16
        np.testing.assert_array_equal(outs[0].float().numpy(), refs[0])
        for got, ref in zip(outs[1:], refs[1:]):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       atol=1e-6)

    tw = torch.from_numpy(w32).bfloat16()
    tg = torch.from_numpy(g).bfloat16()
    args = [tw.clone(), tg] + ([torch.from_numpy(m.copy())] if momentum
                               else []) + [torch.from_numpy(w32.copy())]
    kw = dict(rescale_grad=extra.get("rescale_grad", 1.0),
              clip_gradient=extra.get("clip_gradient"))
    if momentum:
        mp_sgd_mom_update(*args, lr, momentum, wd, **kw)
    else:
        mp_sgd_update(*args, lr, wd, **kw)
    check([args[0]] + args[2:])
    # the optimizer object keeps the master in its state
    opt = SGD(learning_rate=lr, momentum=momentum, wd=wd,
              multi_precision=True, **extra)
    p = torch.nn.Parameter(tw.clone())
    state = opt.create_state_multi_precision(0, p)
    assert state[1].dtype == torch.float32 and \
        (state[0] is None) == (not momentum)
    state[1].copy_(torch.from_numpy(w32))
    if momentum:
        state[0].copy_(torch.from_numpy(m))
    opt.update_multi_precision(0, p, tg, state)
    check([p.data] + ([state[0]] if momentum else []) + [state[1]])
    assert SGD(multi_precision=True).create_state_multi_precision(
        0, torch.zeros(2)) is None


# ------------------------------------------------------------- TrainStep
def _batch():
    rs = np.random.RandomState(1)
    return rs.rand(*BATCH).astype(np.float32), \
        rs.randint(0, NET["classes"], BATCH[0]).astype(np.float32)


def _port_net(mode, state):
    net = ResNetV1(BottleneckV1, *SPEC, fuse_block=mode, device="cpu",
                   **NET)
    net.load_state_dict(state)
    return net


@pytest.fixture(scope="module")
def jax_runs():
    """Per fuse_block mode: (initial port state_dict, JAX losses, JAX
    final port state_dict) of STEPS JAX TrainStep steps on the seeded
    small ResNet V1."""
    x, y = _batch()
    runs = {}
    for mode in MODES:
        mx.random.seed(0)
        jnet = seeded_fill(JaxResNetV1(JaxBottleneckV1, *SPEC,
                                       fuse_block=mode, prefix="resnet_",
                                       **NET), seed=3, input_shape=BATCH)
        named = {n: p.data().asnumpy()
                 for n, p in jnet.collect_params().items()}
        init = resnet_params_from_numpy(named)
        step = jax_parallel.TrainStep(
            jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.optimizer.SGD(**SGD_KW))
        losses = [float(step(mx.nd.array(x), mx.nd.array(y)).asscalar())
                  for _ in range(STEPS)]
        step.sync_params()
        final = resnet_params_from_numpy(
            {n: p.data().asnumpy()
             for n, p in jnet.collect_params().items()})
        runs[mode] = (init, losses, final)
    return runs


def _close_state(got, ref):
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        g = got[key].detach()
        err = (g - r).abs().max().item()
        bound = STEP_RTOL * r.abs().max().item() + STEP_ATOL
        assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(jax_runs, mode):
    """Three TrainStep steps (SGD 0.1 / 0.9 / 1e-4, b=4 at 16x16): the
    losses, every updated parameter and every moving statistic against
    the JAX TrainStep's, in each fuse_block mode."""
    init, ref_losses, ref_final = jax_runs[mode]
    net = _port_net(mode, init)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
                     device="cpu")
    x, y = _batch()
    losses = [step(x, y) for _ in range(STEPS)]
    assert all(t.shape == () and t.dtype == torch.float32 for t in losses)
    np.testing.assert_allclose([t.item() for t in losses], ref_losses,
                               rtol=LOSS_RTOL)
    _close_state(net.state_dict(), ref_final)


def test_run_steps_equals_calls(jax_runs):
    """run_steps(num_steps=3) is three __call__s: the same losses and the
    same final state, bit for bit."""
    init = jax_runs["chain"][0]
    x, y = _batch()
    a, b = _port_net("chain", init), _port_net("chain", init)
    sa = TrainStep(a, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW), device="cpu")
    sb = TrainStep(b, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW), device="cpu")
    window = sa.run_steps(x, y, num_steps=STEPS)
    calls = torch.stack([sb(x, y) for _ in range(STEPS)])
    assert window.shape == (STEPS,)
    assert torch.equal(window, calls)
    for key, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[key]), key


def test_cpu_training_counts_no_kernel_launches(jax_runs):
    net = _port_net("chain", jax_runs["chain"][0])
    counts = (chain_stats.launches, chain_emit.launches,
              sbr_matmul.launches, sbr_conv3x3.launches)
    TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
              device="cpu")(*_batch())
    assert (chain_stats.launches, chain_emit.launches, sbr_matmul.launches,
            sbr_conv3x3.launches) == counts


def test_chain_state_dict_interchanges_with_fused(jax_runs):
    """A chain net and its fuse_block=True / False twins have the same
    state_dict keys (those the converter gives from the JAX chain net),
    and one state gives the same eval logits in all three."""
    init = jax_runs["chain"][0]
    nets = {m: _port_net(m, init).eval() for m in MODES}
    for m in MODES:
        assert nets[m].state_dict().keys() == init.keys()
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        ref = nets[False](x)
        for m in ("chain", True):
            torch.testing.assert_close(nets[m](x), ref, atol=1e-5,
                                       rtol=1e-5)
    chain = nets["chain"]
    assert sum(blk.chain is not None and blk.chain.fused
               for stage in chain.features if isinstance(stage,
                                                         torch.nn.Sequential)
               for blk in stage) == sum(SPEC[0])
    # a trained chain net's state loads into the fused twin and back
    twin = copy.deepcopy(nets[True])
    twin.load_state_dict(chain.state_dict())
    chain.load_state_dict(twin.state_dict())


@pytest.mark.parametrize("kw,match", [
    # a mesh is ported (data parallel): anything else is refused
    pytest.param(dict(mesh=object()), "DeviceMesh", id="kw0-mesh"),
    (dict(mirror=True), "mirror"),
    # input_prep is ported: the step runs it on the data input only
    pytest.param(dict(input_prep=abs), "input_prep", id="kw2-input_prep"),
    (dict(autotune=True), "autotune"), (dict(batch_axis=1), "axis 0")])
def test_train_step_refuses_what_is_not_ported(kw, match):
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
    if "input_prep" in kw:
        seen = []
        step = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(), device="cpu",
                         input_prep=lambda x: seen.append(x.dtype) or x.abs())
        y = np.zeros(BATCH[0], np.float32)
        assert torch.isfinite(step(-np.ones(BATCH, np.float32), y))
        assert seen == [torch.float32]
        return
    with pytest.raises(MXNetError, match=match):
        TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(), device="cpu", **kw)


def test_train_step_on_a_one_rank_mesh_equals_the_plain_step(jax_runs):
    """TrainStep(mesh=make_mesh(dp=1)) in one process (no process group):
    the whole batch is the rank's, nothing is reduced, and three steps
    equal the plain step's bit for bit; EvalStep(mesh=) likewise."""
    from incubator_mxnet_tpu_torch.parallel import make_mesh
    init = jax_runs[True][0]
    x, y = _batch()
    a, b = _port_net(True, init), _port_net(True, init)
    mesh = make_mesh(dp=1, device="cpu")
    sa = TrainStep(a, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW), mesh=mesh)
    sb = TrainStep(b, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
                   device="cpu")
    assert sa.mesh is mesh and sa.device == torch.device("cpu")
    assert torch.equal(sa.run_steps(x, y, num_steps=STEPS),
                       sb.run_steps(x, y, num_steps=STEPS))
    for key, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[key]), key
    assert torch.equal(EvalStep(a, mesh=mesh)(x), EvalStep(b, device="cpu")(x))


def _wrapper_args(name, dtype=torch.bfloat16, weight_dtype=None):
    """Tiny arguments of kernel wrapper ``name``'s contract check: data
    and weights in ``dtype`` (the weights in ``weight_dtype`` if
    given), the per-channel vectors fp32."""
    from incubator_mxnet_tpu_torch.ops import fused_chain as fch
    from incubator_mxnet_tpu_torch.ops import fused_conv as fcv
    wd = dtype if weight_dtype is None else weight_dtype

    def grid(*shape, dt):
        return torch.zeros(shape, dtype=dt).contiguous(memory_format=CL)
    x, v = grid(2, 8, 5, 7, dt=dtype), torch.zeros(8)
    if name in ("sbr_matmul", "sbr_conv3x3"):
        k = (1, 1) if name == "sbr_matmul" else (3, 3)
        return lambda: fcv._check(name, x, v, v, grid(4, 8, *k, dt=wd),
                                  torch.zeros(4), k)
    w2, w3 = grid(6, 8, 3, 3, dt=wd), grid(16, 6, 1, 1, dt=wd)
    vec = {"a1": (v, 8), "b1": (v, 8)}
    if name == "chain_stats":
        return lambda: fch._check(name, x, dict(vec, shift=(
            torch.zeros(6), 6)), w2)
    return lambda: fch._check(name, x, dict(
        vec, a2=(torch.zeros(6), 6), b2=(torch.zeros(6), 6),
        b3=(torch.zeros(16), 16)), w2, w3)


@pytest.mark.parametrize("name", ["sbr_matmul", "sbr_conv3x3",
                                  "chain_stats", "chain_emit"])
def test_bf16_kernel_contract(name):
    """The wrappers of B1-B4 take bf16 data and weights with fp32
    per-channel vectors (the bf16 form) as they take fp32 ones, and
    refuse fp16, and bf16 data with fp32 weights (no silent cast)."""
    _wrapper_args(name)()
    _wrapper_args(name, torch.float32)()
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        _wrapper_args(name, torch.float16)()
    with pytest.raises(MXNetError, match="in torch.bfloat16"):
        _wrapper_args(name, weight_dtype=torch.float32)()


@pytest.mark.parametrize("mode", ["chain", True, "1x1", "chain34"])
def test_bf16_steps_build_a_live_kernel_net_on_the_card(monkeypatch, mode):
    """bf16_compute on a CUDA device with a net whose fused layers
    launch the kernels B1-B4: TrainStep and EvalStep build (their bf16
    forms run there; the device is mocked, and so is the placement check
    the CPU parameters would fail), the net's fused layers are live, and
    on the CPU the plain versions run bf16."""
    import incubator_mxnet_tpu_torch.parallel.step as step_mod
    from incubator_mxnet_tpu_torch.gluon.nn._modules import (
        FusedBNReLUConv2D, FusedBottleneckChain)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spec = ([1, 1, 1, 1], [16, 32, 64, 128, 1024])
    net = ResNetV1(BottleneckV1, *spec, fuse_block=mode, device="cpu",
                   **NET)
    live = [m for m in net.modules()
            if isinstance(m, (FusedBNReLUConv2D, FusedBottleneckChain))
            and m.fused]
    assert live
    with pytest.raises(MXNetError, match="parameters are on"):
        TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(), bf16_compute=True,
                  device="cuda:0")
    monkeypatch.setattr(step_mod, "_check_placement", lambda *a: None)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(),
                     bf16_compute=True, device="cuda:0")
    evaluate = EvalStep(net, bf16_compute=True, device="cuda:0")
    assert step.device == evaluate.device == torch.device("cuda:0")
    out = EvalStep(net, bf16_compute=True, device="cpu")(_batch()[0])
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


def test_bf16_layers_are_fused():
    """A fused layer or chain built in bf16 is inside the kernels'
    envelope (``fused``) as in fp32; the chain's envelope is twice as
    wide in bf16 (its y2 tile takes half the shared memory); fp16 is
    outside both."""
    from incubator_mxnet_tpu_torch.gluon.nn._modules import (
        FusedBNReLUConv2D, FusedBottleneckChain)
    from incubator_mxnet_tpu_torch.ops.fused_chain import (
        CHAIN_MAX_CM, CHAIN_MAX_CM_BF16)

    def layers(dtype, cm=8):
        first = FusedBNReLUConv2D(cm, 3, 1, 1, layout="NHWC", in_channels=8,
                                  device="cpu", dtype=dtype)
        second = FusedBNReLUConv2D(16, 1, 1, 0, layout="NHWC",
                                   in_channels=cm, use_bias=True,
                                   device="cpu", dtype=dtype)
        return first, second, FusedBottleneckChain(first, second)

    for dtype in (torch.float32, torch.bfloat16):
        assert all(m.fused for m in layers(dtype))
    assert not any(m.fused for m in layers(torch.float16))
    assert CHAIN_MAX_CM_BF16 == 2 * CHAIN_MAX_CM
    assert layers(torch.bfloat16, CHAIN_MAX_CM_BF16)[2].fused
    assert not layers(torch.bfloat16, CHAIN_MAX_CM_BF16 + 1)[2].fused
    assert not layers(torch.float32, CHAIN_MAX_CM + 1)[2].fused


def test_train_step_device_rules(monkeypatch):
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(), device="cpu")
    with pytest.raises(MXNetError, match="stacked"):
        step.run_steps(*_batch(), num_steps=2, stacked=True)
    with pytest.raises(MXNetError, match="num_steps"):
        step.run_steps(*_batch())
    with pytest.raises(MXNetError, match="parameters are on"):
        TrainStep(net.to("meta"), SoftmaxCrossEntropyLoss(), SGD(),
                  device="cpu")
    # SGD takes an lr_scheduler since the Gluon slice: it drives the
    # learning rate from the update count
    opt = SGD(learning_rate=1.0,
              lr_scheduler=FactorScheduler(step=1, factor=0.5))
    opt.num_update = 3
    assert opt.learning_rate == 0.25
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        TrainStep(net, SoftmaxCrossEntropyLoss(), SGD())
