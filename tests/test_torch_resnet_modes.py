"""ResNet V1's ``fuse_bn_relu`` and ``fuse_block`` modes in the PyTorch
port against the JAX package, in inference, and the weight conversion
both ways for every mode.

Each mode's JAX net (``fuse_bn_relu=True`` on bottlenecks; ``"1x1"``;
``"chain34"`` on a net whose last stage has a 256-channel 3x3, so it
holds both chain and ``BNReLU`` bottlenecks; ``"chain"`` on basic blocks
with the 7x7 stem, where it means ``fuse_bn_relu=True`` and the stem's
BN + ReLU is a ``BNReLU`` too; ``mxu_stem=True``, whose JAX stem is the
space-to-depth ``MXUStemConv2D`` and the port's the plain strided conv
with the same parameters and names) gets seeded numpy weights and BN
statistics, which move to the port through
``convert.resnet_params_from_numpy``.  The JAX nets are built once per
module (their first forward compiles their ops, ~10-25 s each).

Tolerance: logits within 1e-4 of max |logit| (fp32 on both sides
through up to 53 layers summed in other orders; observed ~1e-6).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon.model_zoo.vision import (
    BottleneckV1 as JaxBottleneckV1, ResNetV1 as JaxResNetV1)
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import (resnet_params_from_numpy,
                                               resnet_params_to_numpy)
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    BNReLU, FusedBNReLUConv2D, FusedBottleneckChain)
from torch_port_helpers import jax_resnet, seeded_fill

REL_TOL = 1e-4
SHAPE = (2, 16, 16, 3)
THUMB = dict(classes=10, layout="NHWC", thumbnail=True)
# stage 4's 3x3 has 1024 // 4 = 256 channels: a chain block under
# "chain34"; the three stages before it have BNReLU bottlenecks
SPEC34 = ([1, 1, 1, 1], [16, 32, 64, 128, 1024])
MODES = {
    "fuse_bn_relu": (50, dict(THUMB, fuse_bn_relu=True), SHAPE),
    "1x1": (50, dict(THUMB, fuse_block="1x1"), SHAPE),
    "chain34": (SPEC34, dict(THUMB, fuse_block="chain34"), SHAPE),
    "basic_chain": (18, dict(THUMB, thumbnail=False, fuse_block="chain",
                             fuse_bn_relu=True), (2, 32, 32, 3)),
    "mxu_stem": (18, dict(THUMB, thumbnail=False, mxu_stem=True),
                 (2, 32, 32, 3)),
}


def _port_net(depth, kw):
    if isinstance(depth, tuple):
        return vision.ResNetV1(vision.BottleneckV1, *depth, device="cpu",
                               **kw)
    return vision.get_resnet(1, depth, device="cpu", **kw)


@pytest.fixture(scope="module")
def nets():
    """Per mode: (JAX net, its named numpy weights, port twin in eval,
    images, JAX logits), built at first use."""
    built = {}

    def get(mode):
        if mode not in built:
            depth, kw, shape = MODES[mode]
            if isinstance(depth, tuple):
                mx.random.seed(0)
                jnet = seeded_fill(JaxResNetV1(JaxBottleneckV1, *depth,
                                               prefix="resnet_", **kw),
                                   seed=4, input_shape=shape)
            else:
                jnet = jax_resnet(seed=4, num_layers=depth,
                                  input_shape=shape, **kw)
            named = {n: p.data().asnumpy()
                     for n, p in jnet.collect_params().items()}
            net = _port_net(depth, kw)
            net.load_state_dict(resnet_params_from_numpy(named))
            x = np.random.RandomState(5).rand(*shape).astype(np.float32)
            built[mode] = (jnet, named, net.eval(), x,
                           jnet(mx.nd.array(x)).asnumpy())
        return built[mode]
    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_logits_match_jax(nets, mode):
    _, _, net, x, ref = nets(mode)
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_converts_to_the_port_and_back(nets, mode):
    """A JAX net of the mode -> the port's state_dict -> JAX names: the
    same names, every array bit for bit, and the port's keys are those
    of the unfused net."""
    _, named, net, _, _ = nets(mode)
    back = resnet_params_to_numpy(net.state_dict(), prefix="resnet_")
    assert back.keys() == named.keys()
    for name, arr in named.items():
        assert back[name].dtype == arr.dtype and \
            np.array_equal(back[name], arr), name
    depth, kw, _ = MODES[mode]
    plain = _port_net(depth, dict(kw, fuse_block=False, fuse_bn_relu=False))
    assert plain.state_dict().keys() == net.state_dict().keys()


def _layers(net, kind):
    return [m for m in net.modules() if isinstance(m, kind)]


def test_modes_build_the_reference_layers(nets):
    """What each mode puts where, counted on ResNet-50 (16 bottlenecks;
    stages 3 and 4, 9 blocks, have 3x3s of 256 and 512 channels) and
    ResNet-18 (8 basic blocks), as the JAX zoo builds them."""
    cases = {
        (50, False, True): (33, 0, 0),
        (50, "1x1", False): (16, 16, 0),
        (50, "1x1", True): (17, 16, 0),
        (50, "chain34", False): (14, 0, 9),
        (50, "chain", True): (1, 0, 16),
        (50, True, True): (1, 32, 0),
        (18, "chain", False): (8, 0, 0),
        (18, "1x1", True): (9, 0, 0),
    }
    for (depth, mode, fbr), (n_bnrelu, n_fused, n_chain) in cases.items():
        net = vision.get_resnet(1, depth, classes=10, layout="NHWC",
                                fuse_block=mode, fuse_bn_relu=fbr,
                                device="cpu")
        chains = [c for c in _layers(net, FusedBottleneckChain) if c.fused]
        fused = [f for f in _layers(net, FusedBNReLUConv2D) if f.fused]
        assert (len(_layers(net, BNReLU)), len(fused), len(chains)) == \
            (n_bnrelu, n_fused, n_chain), (depth, mode, fbr)
        if mode == "1x1":
            assert all(f.conv.kernel_size == (1, 1) for f in fused)
        if n_chain == 9:
            assert all(c._layers[0].conv.weight.shape[0] >= 256
                       for c in chains)



def test_back_conversion_raises_on_a_key_it_cannot_place():
    net = vision.get_resnet(1, 18, classes=10, device="cpu")
    state = dict(net.state_dict(), **{"features.9.extra": torch.zeros(1)})
    with pytest.raises(MXNetError, match="cannot place"):
        resnet_params_to_numpy(state)
    names = resnet_params_to_numpy(net.state_dict())
    assert all(n.startswith("resnetv10_") for n in names)
    assert resnet_params_from_numpy(names).keys() == net.state_dict().keys()
