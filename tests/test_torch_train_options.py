"""The options of the port's ``parallel.TrainStep`` and its
``parallel.EvalStep`` against the JAX package's, on a small ResNet V1
with ``fuse_bn_relu=True`` (the network of ``bench.py:main``'s
accelerator configuration, at test size): ``bf16_compute``,
``grad_accum``, the ``numerics.LossScaler`` and ``EvalStep`` in fp32 and
bf16.

Both sides start from the same seeded numpy weights and step on the same
batches (SGD: lr 0.1, momentum 0.9, wd 1e-4).

Tolerances.  fp32 as in ``test_torch_train.py``: losses within 1e-4
relative, every parameter and moving statistic within 1e-4 of that
tensor's largest magnitude plus 1e-6, logits within 1e-4 of the largest.

bf16, measured.  One bf16 step of this net is dominated by bf16's own
rounding, amplified through 11 BatchNorms of a 4-image batch, so the
bf16 step is held per leaf, on what the step moved: each parameter's
change against JAX's change of it, as ``|d_port - d_jax| / |d_jax|``
(L2 norms).  At 32x32 two bf16 formulations inside the port (``BNReLU``
against ``BatchNorm`` then ReLU) differ by a median 0.32 of that over
the leaves (at most 0.53), about as much as bf16 differs from fp32 in
JAX (median 0.37); the port against JAX measures at most 0.62, 1.93x
that median.  So every leaf must lie within BF16_STEP_FACTOR = 2.5 of
the median spread (0.80).  A plainly wrong step fails it: a conv weight
left unmoved is 1.0 off, a step on half the batch 1.3 (median over the
leaves); the test checks both.  Leaves whose gradient is 0 to within
rounding carry bf16 noise only and are left out, by a rule on JAX's
gradient: the gradient part of the change (``d + lr * wd * w``) of
JAX's fp32 step is at most 2^-8 of its bf16 step's (measured 2e-4 for
the biases of the bottlenecks' first and last convs, which feed a
BatchNorm and so have a true gradient of 0; >= 0.78 for every other
leaf).  The moving statistics (worst leaf, in units of its largest
magnitude) lie within BF16_SPREAD_FACTOR = 2 of the port's own spread
(measured 1.3x), the loss within 3e-2 relative (observed 1.1%, two bf16
steps at 2.75) and the bf16 logits within 1e-2 of the largest (observed
6e-3; bf16 against fp32 9e-3 to 1.2e-2).  What only a bf16 computation
gives is checked exactly: the loss and the moving statistics lie on the
bf16 grid (the bf16 mean, the bf16 fold cast back), the updated fp32
masters do not, and the bf16 logits are bf16.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.gluon.model_zoo.vision import (
    BottleneckV1 as JaxBottleneckV1)
from incubator_mxnet_tpu.numerics import LossScaler as JaxLossScaler
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.nn._modules import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                              ResNetV1)
from incubator_mxnet_tpu_torch.numerics import LossScaler, program_overflow
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import EvalStep, TrainStep
from torch_port_helpers import (change_errs as _change_errs, jax_resnet_of,
                                jax_train, port_state)

SPEC = ([1, 2, 1, 1], [16, 32, 64, 128, 256])
NET = dict(classes=10, thumbnail=True, layout="NHWC", fuse_bn_relu=True)
BATCH = (4, 16, 16, 3)
SGD_KW = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
STEP_RTOL, STEP_ATOL, LOSS_RTOL, LOGITS_RTOL = 1e-4, 1e-6, 1e-4, 1e-4
BF16_SPREAD_FACTOR, BF16_LOSS_RTOL, BF16_LOGITS_RTOL = 2.0, 3e-2, 1e-2
# the bf16 step: 4 images at 32x32, each leaf's change within
# BF16_STEP_FACTOR of the median spread, leaves whose fp32 gradient is
# at most NOISE_GRAD of their bf16 one left out
BF16_BATCH, BF16_STEP_FACTOR, NOISE_GRAD = (4, 32, 32, 3), 2.5, 2.0 ** -8
FROZEN = "features.2.0.body.1.conv.weight"
SCALER = dict(init_scale=1024.0, growth_interval=2)
# the loss scaler's run: clean, clean (the scale grows), an inf in the
# batch (no update, the scale backs off), clean
SCALED_RUN = (False, False, True, False)
STATS = ("running_mean", "running_var")


def _batch(poison=False, shape=BATCH):
    rs = np.random.RandomState(1)
    x = rs.rand(*shape).astype(np.float32)
    if poison:
        x[1, 3, 5, 0] = np.inf
    return x, rs.randint(0, NET["classes"], shape[0]).astype(np.float32)


def _jax_net(shape=BATCH):
    return jax_resnet_of(JaxBottleneckV1, SPEC, 3, shape, **NET)


def _port_net(state, **kw):
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **dict(NET, **kw))
    net.load_state_dict(state)
    return net


def _step(net, **kw):
    return TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
                     device="cpu", **kw)


def _worst(got, ref, keys):
    """The largest |got - ref| over ``keys`` in units of the tensor's
    largest magnitude (plus STEP_ATOL)."""
    return max((got[k] - ref[k]).abs().max().item() /
               (ref[k].abs().max().item() + STEP_ATOL) for k in keys)


def _close_state(got, ref):
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        err = (got[key] - r).abs().max().item()
        assert err <= STEP_RTOL * r.abs().max().item() + STEP_ATOL, \
            (key, err)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX runs: the initial port state, then per option (losses,
    final port state, the loss scales after each step)."""
    x, y = _batch()
    init = port_state(_jax_net())
    runs = {"init": init}
    losses, final, _ = jax_train(_jax_net(), x, y, 1, SGD_KW, grad_accum=2)
    runs["accum"] = (losses, final, None)
    xb, yb = _batch(shape=BF16_BATCH)
    for name, kw in (("bf16", dict(bf16_compute=True)), ("fp32", {})):
        losses, final, _ = jax_train(_jax_net(BF16_BATCH), xb, yb, 1,
                                     SGD_KW, **kw)
        runs[name] = (losses, final, None)
    jnet = _jax_net()
    step = jax_parallel.TrainStep(
        jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        mx.optimizer.SGD(**SGD_KW), loss_scaler=JaxLossScaler(**SCALER))
    losses, scales = [], []
    for poison in SCALED_RUN:
        xs, ys = _batch(poison)
        losses.append(float(step(mx.nd.array(xs), mx.nd.array(ys))
                            .asscalar()))
        scales.append(float(np.asarray(step._scaler_state)[0]))
    step.sync_params()
    runs["scaler"] = (losses, port_state(jnet), scales)
    jnet = _jax_net()
    runs["eval"] = {bf16: jax_parallel.EvalStep(jnet, bf16_compute=bf16)(
        mx.nd.array(x)).asnumpy().astype(np.float32)
        for bf16 in (False, True)}
    return runs


def test_bf16_step_matches_jax(jax_runs):
    """One bf16 step against JAX's (see the module's note): the bf16 grid
    of the loss and the moving statistics, the statistics against the
    port's own spread, and each parameter's change against JAX's; then
    the same check fails a conv weight left unmoved and a step on half
    the batch."""
    init = jax_runs["init"]
    (ref_loss,), ref, _ = jax_runs["bf16"]
    ref32 = jax_runs["fp32"][1]
    x, y = _batch(shape=BF16_BATCH)

    def bf16_step(xs, ys, frozen=None, **kw):
        net = _port_net(init, **kw)
        if frozen:
            net.get_parameter(frozen).requires_grad_(False)
        loss = _step(net, bf16_compute=True)(xs, ys)
        return loss, net.state_dict()

    loss, state = bf16_step(x, y)
    alt = bf16_step(x, y, fuse_bn_relu=False)[1]
    assert loss.dtype == torch.float32 and \
        loss.item() == loss.bfloat16().float().item()
    assert abs(loss.item() - ref_loss) <= BF16_LOSS_RTOL * abs(ref_loss)
    stats = [k for k in ref if k.endswith(STATS)]
    params = [k for k in ref if k not in stats]
    for key in stats:
        assert torch.equal(state[key], state[key].bfloat16().float()), key
    assert state[params[0]].dtype == torch.float32 and \
        not torch.equal(state[params[0]],
                        state[params[0]].bfloat16().float())
    spread = _worst(alt, state, stats)
    assert _worst(state, ref, stats) <= BF16_SPREAD_FACTOR * spread
    # the leaves JAX's bf16 step moves by rounding alone: the biases of
    # the bottlenecks' first and last convs, which feed a BatchNorm
    lr_wd = SGD_KW["learning_rate"] * SGD_KW["wd"]
    noise = {k for k in params if
             (ref32[k] - init[k] + lr_wd * init[k]).norm() <= NOISE_GRAD *
             (ref[k] - init[k] + lr_wd * init[k]).norm()}
    assert noise == {k for k in params if k.endswith(
        ("body.0.bias", "body.2.conv.bias"))}, sorted(noise)
    kept = [k for k in params if k not in noise]
    bound = BF16_STEP_FACTOR * float(np.median(list(
        _change_errs(alt, state, init, kept).values())))
    errs = _change_errs(state, ref, init, kept)
    assert max(errs.values()) <= bound, (max(errs, key=errs.get), bound)
    frozen = _change_errs(bf16_step(x, y, frozen=FROZEN)[1], ref, init, kept)
    assert frozen[FROZEN] > bound
    half = _change_errs(bf16_step(x[:2], y[:2])[1], ref, init, kept)
    assert np.median(list(half.values())) > bound


def test_grad_accum_matches_jax(jax_runs):
    """grad_accum=2: two microbatches of 2, the second one's forward on
    the moving statistics the first one moved, one update."""
    (ref_loss,), ref, _ = jax_runs["accum"]
    net = _port_net(jax_runs["init"])
    loss = _step(net, grad_accum=2)(*_batch())
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)
    _close_state(net.state_dict(), ref)
    # the stats compounded: not what one batch of 4 gives
    whole = _port_net(jax_runs["init"])
    _step(whole)(*_batch())
    key = "features.1.0.body.1.bn.running_mean"
    assert not torch.allclose(whole.state_dict()[key],
                              net.state_dict()[key], rtol=1e-3)


def test_grad_accum_needs_an_even_split():
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
    step = _step(net, grad_accum=3)
    with pytest.raises(MXNetError, match="grad_accum=3"):
        step(*_batch())
    for bad in (0, 1.5):
        with pytest.raises(MXNetError, match="grad_accum"):
            _step(net, grad_accum=bad)


def test_loss_scaler_matches_jax(jax_runs):
    """Clean, clean (the scale doubles after growth_interval=2 clean
    steps), an inf in the batch (no update at all, the scale halves),
    clean: the losses, the scale after each step and the final state
    against JAX; the skipped step leaves every parameter, momentum and
    moving statistic bit-identical."""
    ref_losses, ref, ref_scales = jax_runs["scaler"]
    assert ref_scales == [1024.0, 2048.0, 1024.0, 1024.0]
    net = _port_net(jax_runs["init"])
    step = _step(net, loss_scaler=LossScaler(**SCALER))
    losses, scales = [], []
    for poison in SCALED_RUN:
        before = [t.clone() for t in step._carry()]
        losses.append(step(*_batch(poison)).item())
        scales.append(step.loss_scale())
        if poison:
            after = step._carry()
            assert len(after) == len(before) > len(step._params)
            assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert scales == ref_scales
    assert np.isnan(losses[2]) and np.isnan(ref_losses[2])
    np.testing.assert_allclose(losses[:2] + losses[3:],
                               ref_losses[:2] + ref_losses[3:],
                               rtol=LOSS_RTOL)
    _close_state(net.state_dict(), ref)


def test_loss_scaler_policy_matches_jax(monkeypatch):
    """The scaler's knobs, their env defaults and checks, its device
    state and back-off floor (a scale never drops below 1)."""
    monkeypatch.setenv("MXNET_LOSS_SCALE_WINDOW", "7")
    ours, theirs = LossScaler(), JaxLossScaler()
    assert ours.describe() == theirs.describe()
    state = LossScaler(init_scale=1.5).state_init("cpu")
    assert state.dtype == torch.float32 and state.tolist() == [1.5, 0.0]
    backed = ours.next_state(state, torch.tensor(True))
    assert backed.tolist() == [1.0, 0.0]
    assert program_overflow([torch.ones(3), torch.tensor([3e38])])
    assert not program_overflow([torch.ones(3, 2)])
    for bad in (dict(init_scale=0), dict(backoff_factor=1.0),
                dict(growth_factor=1.0), dict(growth_interval=0)):
        with pytest.raises(MXNetError):
            LossScaler(**bad)
    for raw, on in (("", False), ("0", False), ("512", True)):
        monkeypatch.setenv("MXNET_LOSS_SCALE", raw)
        assert (LossScaler.from_env() is None) == \
            (JaxLossScaler.from_env() is None) == (not on)
    monkeypatch.setenv("MXNET_LOSS_SCALE", "x")
    with pytest.raises(MXNetError, match="MXNET_LOSS_SCALE"):
        LossScaler.from_env()


def test_env_loss_scale_opts_bf16_steps_in(monkeypatch):
    """With bf16_compute, MXNET_LOSS_SCALE gives the step the env
    scaler, as the JAX step does; an fp32 step takes none."""
    monkeypatch.setenv("MXNET_LOSS_SCALE", "256")
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
    assert _step(net, bf16_compute=True).loss_scale() == 256.0
    assert _step(net).loss_scale() is None


@pytest.mark.parametrize("bf16", [False, True])
def test_eval_step_matches_jax(jax_runs, bf16):
    """EvalStep in fp32 and bf16 against the JAX EvalStep: the logits;
    the call leaves the block's mode and its moving statistics as they
    were."""
    ref = jax_runs["eval"][bf16]
    net = _port_net(jax_runs["init"]).train()
    out = EvalStep(net, bf16_compute=bf16, device="cpu")(_batch()[0])
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    err = np.abs(out.float().numpy() - ref).max()
    rtol = BF16_LOGITS_RTOL if bf16 else LOGITS_RTOL
    assert err <= rtol * np.abs(ref).max(), err
    assert net.training
    for key, t in net.state_dict().items():
        assert torch.equal(t, jax_runs["init"][key]), key


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=object()), "mesh"),
    # input_prep is ported: EvalStep runs it on every input
    pytest.param(dict(input_prep=abs), "input_prep", id="kw1-input_prep"),
    (dict(autotune=True), "autotune")])
def test_eval_step_refuses_what_is_not_ported(kw, match):
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
    if "input_prep" in kw:
        x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
        got = EvalStep(net, device="cpu", input_prep=torch.abs)(x)
        torch.testing.assert_close(got, EvalStep(net, device="cpu")(
            np.abs(x)), rtol=0, atol=0)
        return
    with pytest.raises(MXNetError, match=match):
        EvalStep(net, device="cpu", **kw)


def test_eval_step_device_rules(monkeypatch):
    """device=None means the card (raising without one); the block's
    parameters must be on the step's device."""
    net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
    with pytest.raises(MXNetError, match="parameters are on"):
        EvalStep(net.to("meta"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        EvalStep(net)
