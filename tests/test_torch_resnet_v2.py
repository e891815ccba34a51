"""ResNet V2 of the PyTorch port against the JAX package's, on the CPU:
the logits of ResNet-18 and ResNet-50 v2 (NHWC, 32x32) in every
``fuse_block`` mode the JAX package accepts (with its downgrades:
``"chain"``/``"chain34"`` -> ``"1x1"`` in a bottleneck, the bottleneck
modes -> ``fuse_bn_relu`` in a basic block), the weight conversion both
ways (``convert.resnet_params_from_numpy`` / ``resnet_param_names``), the
Gluon surface (``collect_params`` names, ``save_params`` read by the JAX
package's ``load_params``), the layers each mode fuses, and
``BlockPredictor(bf16_compute=True)`` against the JAX package's.

Tolerances.  fp32 logits: within 1e-4 of max |logit| (~50 convolutions
summed in other orders on both sides; observed ~1e-6).  bf16 logits: the
port rounds op by op as eager JAX does, while the JAX predictor's
compiled program fuses its elementwise chains without rounding between
ops, so the two bf16 forwards agree only to bf16's own error.  That
error is measured, not assumed: the JAX bf16 predictor against its fp32
logits (max |difference| over max |fp32 logit|; 1.4e-2 for ResNet-18 v2
and 1.1e-2 for ResNet-50 v2 here, where the random nets' logits are
small).  The port's bf16 logits must lie within BF16_SPREAD (2) times
that of the JAX bf16 logits (observed 1.1x and 0.4x) and of the fp32
logits (1.4x and 1.2x).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import predict as jpredict
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import (resnet_param_names,
                                               resnet_params_from_numpy,
                                               resnet_params_to_numpy)
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.nn._modules import (BNReLU,
                                                         FusedBNReLUConv2D)
from incubator_mxnet_tpu_torch.predict import BlockPredictor
from torch_port_helpers import seeded_fill

REL_TOL, BF16_SPREAD = 1e-4, 2.0
SHAPE = (2, 32, 32, 3)
MODES = [dict(fuse_block=False), dict(fuse_block=False, fuse_bn_relu=True),
         dict(fuse_block=True), dict(fuse_block="1x1"),
         dict(fuse_block="chain"), dict(fuse_block="chain34")]
DEPTHS = {18: dict(classes=10, layout="NHWC"),
          50: dict(classes=10, layout="NHWC", thumbnail=True)}


def _images(seed, shape=SHAPE):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _named(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


@pytest.fixture(scope="module", params=sorted(DEPTHS))
def v2(request):
    """(depth, seeded JAX weights by name, images, JAX fp32 logits of
    each mode)."""
    depth = request.param
    kw = DEPTHS[depth]
    jmx.random.seed(0)
    base = seeded_fill(jvision.get_resnet(2, depth, prefix="resnet_", **kw),
                       depth, SHAPE)
    named = _named(base)
    x = _images(depth + 1)
    logits = []
    for mode in MODES:
        jmx.random.seed(0)
        jnet = jvision.get_resnet(2, depth, prefix="resnet_", **kw, **mode)
        jnet.initialize()
        jnet(jmx.nd.zeros(SHAPE))
        for n, p in jnet.collect_params().items():
            p.set_data(jmx.nd.array(named[n]))
        logits.append(jnet(jmx.nd.array(x)).asnumpy())
    return depth, named, x, logits


def _port(depth, named, **mode):
    net = vision.get_resnet(2, depth, device="cpu", **DEPTHS[depth], **mode)
    net.load_state_dict(resnet_params_from_numpy(named))
    return net.eval()


def _close(got, ref, rtol=REL_TOL):
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[str(m) for m in MODES])
def test_v2_logits_match_jax_in_every_mode(v2, i):
    depth, named, x, logits = v2
    net = _port(depth, named, **MODES[i])
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    _close(got, logits[i])


def test_v2_conversion_places_every_name_both_ways(v2):
    depth, named, _, _ = v2
    sd = resnet_params_from_numpy(named)
    net = _port(depth, named)
    assert sd.keys() == net.state_dict().keys() and len(sd) == len(named)
    back = resnet_params_to_numpy(net.state_dict(), prefix="resnet_")
    assert back.keys() == named.keys()
    for n, a in named.items():
        np.testing.assert_array_equal(back[n], a)
    names = resnet_param_names(net.state_dict(), "resnet_")
    assert set(names) == set(named)


@pytest.mark.parametrize("edit,match", [
    (lambda d: d.update({"resnet_stage1_pool0_weight": np.zeros(1)}),
     "cannot place"),
    (lambda d: d.update({"resnet_stage2_batchnorm1_gamma": np.zeros(3)}),
     "shape"),
    (lambda d: d.update({"resnet_batchnorm0_gamma": np.zeros(4)}), "shape"),
    (lambda d: d.pop("resnet_stage3_batchnorm2_beta"), "BatchNorm"),
    (lambda d: d.pop("resnet_stage4_conv2d1_weight"), "indices"),
    (lambda d: d.update({"resnet_dense0_weight": np.zeros((10, 7))}),
     "closing")])
def test_v2_conversion_raises_on_what_it_cannot_place(v2, edit, match):
    depth, named, _, _ = v2
    named = dict(named)
    edit(named)
    with pytest.raises(MXNetError, match=match):
        resnet_params_from_numpy(named)


def test_v2_fused_layers_by_mode():
    """ResNet-50 v2 in NHWC: fuse_block=True fuses fused3 in all 16
    bottlenecks and fused2 in the 13 whose 3x3 has stride 1 (the first
    block of stages 2-4 is strided and runs the plain composition, as
    JAX gives it its exact XLA form); "1x1" fuses fused3 only, with a
    BNReLU before the plain 3x3; every mode keeps the same names."""
    nets = {str(m): vision.resnet50_v2(device="cpu", classes=10,
                                       layout="NHWC", **m) for m in MODES}
    keys = {tuple(n.state_dict()) for n in nets.values()}
    assert len(keys) == 1

    def fused(net, kernel):
        return sum(m.fused for m in net.modules()
                   if isinstance(m, FusedBNReLUConv2D) and
                   m.conv.kernel_size == kernel)
    full = nets[str(dict(fuse_block=True))]
    assert (fused(full, (1, 1)), fused(full, (3, 3))) == (16, 13)
    for m in ("1x1", "chain", "chain34"):
        net = nets[str(dict(fuse_block=m))]
        assert (fused(net, (1, 1)), fused(net, (3, 3))) == (16, 0)
        assert all(isinstance(blk.fused2.bn, BNReLU)
                   for stage in net.features[5:9] for blk in stage)
    plain = nets[str(dict(fuse_block=False))]
    assert fused(plain, (1, 1)) == fused(plain, (3, 3)) == 0
    nchw = vision.resnet50_v2(device="cpu", classes=10, fuse_block=True)
    assert fused(nchw, (1, 1)) == 0           # outside the envelope
    r18 = vision.resnet18_v2(device="cpu", classes=10, layout="NHWC",
                             fuse_block=True)
    assert (fused(r18, (1, 1)), fused(r18, (3, 3))) == (0, 8)
    with pytest.raises(MXNetError, match="version"):
        vision.get_resnet(3, 18, device="cpu")
    with pytest.raises(MXNetError, match="unknown fuse_block"):
        vision.get_resnet(2, 50, device="cpu", fuse_block="chain2")


def test_v2_gluon_surface_matches_jax_names(v2, tmp_path):
    depth, named, x, logits = v2
    net = _port(depth, named)
    params = net.collect_params()
    assert sorted(params.keys()) == sorted(
        "resnetv20_" + n[len("resnet_"):] for n in named)
    stem = params["resnetv20_batchnorm0_gamma"]
    assert stem.grad_req == "null"
    assert params["resnetv20_batchnorm0_beta"].grad_req == "null"
    path = str(tmp_path / "v2.params")
    net.save_params(path)
    jmx.random.seed(0)
    jnet = jvision.get_resnet(2, depth, prefix="resnetv20_", **DEPTHS[depth])
    jnet.initialize()
    jnet(jmx.nd.zeros(SHAPE))
    jnet.collect_params().load(path)
    _close(jnet(jmx.nd.array(x)).asnumpy(), logits[0])
    twin = vision.get_resnet(2, depth, device="cpu", seed=5,
                             **DEPTHS[depth]).eval()
    twin.load_params(path)
    with torch.inference_mode():
        _close(twin(torch.from_numpy(x)).numpy(), logits[0])


def test_v2_seeded_stem_norm_is_the_identity_affine():
    net = vision.resnet18_v2(device="cpu", classes=10, seed=3)
    stem = net.features[0]
    assert stem.fix_gamma and not stem.beta.requires_grad
    assert torch.equal(stem.gamma, torch.ones(3))
    assert torch.equal(stem.beta, torch.zeros(3))


@pytest.mark.parametrize("mode", [dict(fuse_block=True), dict(
    fuse_block=False)], ids=["fused", "plain"])
def test_v2_bf16_predictor_matches_jax(v2, mode):
    depth, named, x, logits = v2
    jmx.random.seed(0)
    jnet = jvision.get_resnet(2, depth, prefix="resnet_", **DEPTHS[depth],
                              **mode)
    jnet.initialize()
    jnet(jmx.nd.zeros(SHAPE))
    for n, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(named[n]))
    want = jpredict.BlockPredictor(jnet, bf16_compute=True)(
        jmx.nd.array(x)).astype("float32").asnumpy()
    fp32_ref = logits[MODES.index(mode)]
    spread = np.abs(want - fp32_ref).max() / np.abs(fp32_ref).max()
    assert 0 < spread < 0.1, spread
    net = _port(depth, named, **mode)
    pred = BlockPredictor(net, device="cpu", bf16_compute=True)
    assert pred.bf16_compute
    got = pred(x)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for ref in (want, fp32_ref):
        err = np.abs(got - ref).max() / np.abs(fp32_ref).max()
        assert err <= BF16_SPREAD * spread, (err, spread)
    # the CPU default stays fp32, as in JAX off its accelerator
    assert not BlockPredictor(net, device="cpu").bf16_compute
    with torch.inference_mode():
        fp32 = BlockPredictor(net, device="cpu")(x).numpy()
    _close(fp32, logits[MODES.index(mode)])
