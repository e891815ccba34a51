"""One ``parallel.TrainStep`` step of the PyTorch port against the JAX
package's in each ResNet V1 mode this port slice adds:
``fuse_bn_relu=True`` (``BNReLU`` throughout), ``fuse_block="1x1"``,
``"chain34"`` (a net whose last stage holds a 256-channel chain block,
the stages before it ``BNReLU`` bottlenecks) and ``"chain"`` on basic
blocks (which is ``fuse_bn_relu=True`` there).

Both sides start from the same seeded numpy weights (through
``convert.resnet_params_from_numpy``) and step on the same batch, fp32,
SGD (lr 0.1, momentum 0.9, wd 1e-4).  The JAX steps run once per module.

Tolerances as in ``test_torch_train.py``: the loss within 1e-4
relative; every updated parameter and moving statistic within 1e-4 of
that tensor's largest magnitude, plus 1e-6 (the two frameworks round the
convolutions and their gradients in other orders; observed <= 3e-5).

bf16: one ``TrainStep(bf16_compute=True)`` step in each ``fuse_block``
mode of ``bench.py:main`` (True, "1x1", "chain", "chain34", all with
``fuse_bn_relu=True``) against JAX's compiled bf16 step on the CPU, 4
images at 32x32, held per leaf as ``test_torch_train_options.py`` holds
the bench net: each parameter's change against JAX's change of it
(``change_errs``) within BF16_STEP_FACTOR = 2.5 of the median over the
leaves of the same measure between two bf16 formulations inside the
port (the mode against the same net unfused and without ``BNReLU``:
``fuse_block=False, fuse_bn_relu=False``, which differs from every mode
in every block);
the leaves whose gradient is 0 to within rounding (the biases that feed
a BatchNorm, found by the port's fp32 step) left out; a conv weight
left unmoved and a step on half the batch must fail it.  Two forms
meet here: JAX's fused layers run their XLA composition on the CPU
(``impl="xla"``: c2 and the conv outputs rounded to bf16 before BN2 and
the bias), the port's forward the kernels' form (the Pallas kernels'
arithmetic, as on the card).
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.gluon.model_zoo.vision import (
    BasicBlockV1 as JaxBasicBlockV1, BottleneckV1 as JaxBottleneckV1)
from incubator_mxnet_tpu_torch.gluon.nn._modules import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (BasicBlockV1,
                                                              BottleneckV1,
                                                              ResNetV1)
from incubator_mxnet_tpu_torch.gluon.nn._modules import BNReLU
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import TrainStep
from torch_port_helpers import (change_errs, jax_resnet_of, jax_train,
                                port_state)

NET = dict(classes=10, thumbnail=True, layout="NHWC")
BATCH = (4, 16, 16, 3)
SGD_KW = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-4
# (JAX block, port block, (layers, channels), mode)
MODES = {
    "fuse_bn_relu": (JaxBottleneckV1, BottleneckV1,
                     ([1, 2, 1, 1], [16, 32, 64, 128, 256]),
                     dict(fuse_bn_relu=True)),
    "1x1": (JaxBottleneckV1, BottleneckV1,
            ([1, 2, 1, 1], [16, 32, 64, 128, 256]), dict(fuse_block="1x1")),
    "chain34": (JaxBottleneckV1, BottleneckV1,
                ([1, 1, 1, 1], [16, 32, 64, 128, 1024]),
                dict(fuse_block="chain34")),
    "basic_chain": (JaxBasicBlockV1, BasicBlockV1,
                    ([1, 1, 1, 1], [16, 16, 32, 64, 128]),
                    dict(fuse_block="chain")),
}


def _batch():
    rs = np.random.RandomState(1)
    return rs.rand(*BATCH).astype(np.float32), \
        rs.randint(0, NET["classes"], BATCH[0]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """Per mode: (initial port state_dict, JAX loss, JAX final port
    state_dict) of one JAX TrainStep step."""
    runs = {}
    x, y = _batch()
    for mode, (jblock, _, spec, kw) in MODES.items():
        jnet = jax_resnet_of(jblock, spec, 3, BATCH, **NET, **kw)
        init = port_state(jnet)
        losses, final, _ = jax_train(jnet, x, y, 1, SGD_KW)
        runs[mode] = (init, losses[0], final)
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_step_matches_jax(jax_runs, mode):
    _, block, spec, kw = MODES[mode]
    init, ref_loss, ref = jax_runs[mode]
    net = ResNetV1(block, *spec, device="cpu", **NET, **kw)
    net.load_state_dict(init)
    assert any(isinstance(m, BNReLU) for m in net.modules())
    loss = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
                     device="cpu")(*_batch())
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)
    got = net.state_dict()
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        err = (got[key] - r).abs().max().item()
        assert err <= STEP_RTOL * r.abs().max().item() + STEP_ATOL, \
            (key, err)


# ---- bf16 (see the module's note)
BF16_BATCH, BF16_STEP_FACTOR, BF16_LOSS_RTOL = (4, 32, 32, 3), 2.5, 3e-2
NOISE_GRAD = 2.0 ** -8
FROZEN = "features.2.0.body.1.conv.weight"
SPEC = ([1, 2, 1, 1], [16, 32, 64, 128, 256])
SPEC34 = ([1, 1, 1, 1], [16, 32, 64, 128, 1024])
BF16_MODES = {True: SPEC, "1x1": SPEC, "chain": SPEC, "chain34": SPEC34}
BF16_NET = dict(NET, fuse_bn_relu=True)
STATS = ("running_mean", "running_var")


def _bf16_batch():
    rs = np.random.RandomState(2)
    return rs.rand(*BF16_BATCH).astype(np.float32), \
        rs.randint(0, NET["classes"], BF16_BATCH[0]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_bf16_runs():
    """Per mode: (initial port state_dict, JAX loss, JAX final port
    state_dict) of one JAX bf16 TrainStep step."""
    runs = {}
    x, y = _bf16_batch()
    for mode, spec in BF16_MODES.items():
        jnet = jax_resnet_of(JaxBottleneckV1, spec, 3, BF16_BATCH,
                             fuse_block=mode, **BF16_NET)
        init = port_state(jnet)
        losses, final, _ = jax_train(jnet, x, y, 1, SGD_KW,
                                     bf16_compute=True)
        runs[mode] = (init, losses[0], final)
    return runs


@pytest.mark.parametrize("mode", list(BF16_MODES), ids=str)
def test_bf16_step_matches_jax(jax_bf16_runs, mode):
    init, ref_loss, ref = jax_bf16_runs[mode]
    x, y = _bf16_batch()

    def stepped(frozen=None, n=BF16_BATCH[0], bf16=True, **kw):
        net = ResNetV1(BottleneckV1, *BF16_MODES[mode], device="cpu",
                       **{**BF16_NET, "fuse_block": mode, **kw})
        net.load_state_dict(init)
        if frozen:
            net.get_parameter(frozen).requires_grad_(False)
        loss = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**SGD_KW),
                         bf16_compute=bf16, device="cpu")(x[:n], y[:n])
        return loss.item(), net.state_dict()

    loss, got = stepped()
    alt = stepped(fuse_block=False, fuse_bn_relu=False)[1]
    ref32 = stepped(bf16=False)[1]
    assert abs(loss - ref_loss) <= BF16_LOSS_RTOL * abs(ref_loss)
    params = [k for k in ref if not k.endswith(STATS)]
    lr_wd = SGD_KW["learning_rate"] * SGD_KW["wd"]
    noise = {k for k in params if
             (ref32[k] - init[k] + lr_wd * init[k]).norm() <= NOISE_GRAD *
             (ref[k] - init[k] + lr_wd * init[k]).norm()}
    assert noise == {k for k in params if k.endswith(
        ("body.0.bias", "body.2.conv.bias"))}, sorted(noise)
    kept = [k for k in params if k not in noise]
    spread = float(np.median(list(change_errs(alt, got, init,
                                              kept).values())))
    bound = BF16_STEP_FACTOR * spread
    errs = change_errs(got, ref, init, kept)
    worst = max(errs, key=errs.get)
    print(f"bf16 {mode!r}: worst leaf {errs[worst]:.3f} ({worst}), "
          f"median spread {spread:.3f}, ratio {errs[worst] / spread:.2f}")
    assert errs[worst] <= bound, (worst, errs[worst], spread)
    frozen = change_errs(stepped(frozen=FROZEN)[1], ref, init, kept)
    assert frozen[FROZEN] > bound
    half = change_errs(stepped(n=2)[1], ref, init, kept)
    assert np.median(list(half.values())) > bound
