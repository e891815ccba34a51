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
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.gluon.model_zoo.vision import (
    BasicBlockV1 as JaxBasicBlockV1, BottleneckV1 as JaxBottleneckV1)
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (BasicBlockV1,
                                                              BottleneckV1,
                                                              ResNetV1)
from incubator_mxnet_tpu_torch.gluon.nn import BNReLU
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import TrainStep
from torch_port_helpers import jax_resnet_of, jax_train, port_state

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
