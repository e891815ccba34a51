"""ResNet V1 of the PyTorch port against the JAX package, the weight
conversion, and the ResNet path through ModelServer on the CPU.

The reference is the JAX model zoo's ResNet V1 with ``fuse_block=True``
and ``layout="NHWC"`` in inference (its fused op runs the exact XLA
composition on the CPU); the port's twin holds the same weights, drawn
by numpy from a seed and moved through ``resnet_params_from_numpy``, BN
running statistics included.  One JAX forward is built per model in a
module-scoped fixture: its first call compiles every op (~25 s each on
a CPU), later calls at the same shape are cheap.

Tolerance: logits within 1e-4 of max |logit|.  Both sides compute in
fp32, but through ~50 convolutions summed in different orders (XLA vs
the port's plain versions and oneDNN), so rounding differences of
~1e-7 relative compound over depth; observed ~1e-6."""
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import resnet_params_from_numpy
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.nn._modules import FusedBNReLUConv2D
from incubator_mxnet_tpu_torch.ops.fused_conv import sbr_conv3x3, sbr_matmul
from incubator_mxnet_tpu_torch.predict import BlockPredictor
from incubator_mxnet_tpu_torch.serving import ModelServer
from torch_port_helpers import (fresh_port_telemetry,  # noqa: F401
                                jax_resnet, torch_twin_resnet)

REL_TOL = 1e-4
SHAPE = (2, 16, 16, 3)
R50 = dict(classes=10, layout="NHWC", thumbnail=True, fuse_block=True)
R18 = dict(classes=10, layout="NHWC", thumbnail=False, fuse_block=True)


def _images(seed, shape=SHAPE):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def r50():
    """(jax net, port twin, images, JAX logits) for ResNet-50 v1."""
    jnet = jax_resnet(seed=0, num_layers=50, input_shape=SHAPE, **R50)
    x = _images(1)
    return jnet, torch_twin_resnet(jnet, 50, **R50), x, \
        jnet(mx.nd.array(x)).asnumpy()


def _close(got, ref):
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_resnet50_logits_match_jax(r50):
    _, net, x, ref = r50
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    _close(got, ref)


def test_resnet18_logits_match_jax():
    """BasicBlockV1 (only the fused 3x3 boundary) with the 7x7 stem,
    its BN and the max pool."""
    shape = (2, 32, 32, 3)
    jnet = jax_resnet(seed=3, num_layers=18, input_shape=shape, **R18)
    x = _images(4, shape)
    ref = jnet(mx.nd.array(x)).asnumpy()
    net = torch_twin_resnet(jnet, 18, **R18)
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    _close(got, ref)


def test_fused_layers_on_the_path(r50):
    """fuse_block=True in NHWC gives ResNet-50 16 fused 3x3 and 16 fused
    1x1 boundaries inside the kernels' envelope (one launch each per
    forward on the card); NCHW, or fuse_block=False, keeps the same
    layers and names but runs them plain."""
    _, net, _, _ = r50
    fused = [m for m in net.modules() if isinstance(m, FusedBNReLUConv2D)]
    assert len(fused) == 32 and all(m.fused for m in fused)
    assert sorted(m.conv.kernel_size for m in fused).count((3, 3)) == 16
    for kw in (dict(R50, layout="NCHW"), dict(R50, fuse_block=False)):
        other = vision.resnet50_v1(device="cpu", **kw)
        assert not any(m.fused for m in other.modules()
                       if isinstance(m, FusedBNReLUConv2D))
        assert other.state_dict().keys() == net.state_dict().keys()


def test_layouts_and_fusion_agree(r50):
    """The same weights through NCHW input and through fuse_block=False
    give the NHWC fused logits."""
    _, net, x, _ = r50
    with torch.inference_mode():
        ref = net(torch.from_numpy(x))
        for kw, inp in ((dict(R50, layout="NCHW"),
                         torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()),
                        (dict(R50, fuse_block=False), torch.from_numpy(x))):
            other = vision.resnet50_v1(device="cpu", **kw).eval()
            other.load_state_dict(net.state_dict())
            torch.testing.assert_close(other(inp), ref, atol=1e-5,
                                       rtol=1e-5)


def test_conversion_places_every_name_exactly_once(r50):
    jnet, net, _, _ = r50
    named = {n: p.data().asnumpy() for n, p in
             jnet.collect_params().items()}
    sd = resnet_params_from_numpy(named)
    assert len(sd) == len(named)
    assert sd.keys() == net.state_dict().keys()
    for key, t in net.state_dict().items():
        assert tuple(sd[key].shape) == tuple(t.shape), key
    # the prefix is read from the names, whatever it is
    renamed = {"other_" + n[len("resnet_"):]: a for n, a in named.items()}
    assert resnet_params_from_numpy(renamed).keys() == sd.keys()


@pytest.mark.parametrize("edit,match", [
    (lambda d: d.update({"resnet_stage1_pool0_weight": np.zeros(1)}),
     "cannot place"),
    (lambda d: d.update({"resnet_stage2_batchnorm0_gamma": np.zeros(3)}),
     "shape"),
    (lambda d: d.update({"resnet_dense0_bias": np.zeros(11)}), "shape"),
    (lambda d: d.pop("resnet_stage3_batchnorm2_beta"), "BatchNorm"),
    (lambda d: d.pop("resnet_stage4_conv2d1_weight"), "indices"),
    (lambda d: d.pop("resnet_stage4_batchnorm4_gamma"), "BatchNorm")])
def test_conversion_raises_on_what_it_cannot_place(r50, edit, match):
    named = {n: p.data().asnumpy() for n, p in
             r50[0].collect_params().items()}
    edit(named)
    with pytest.raises(MXNetError, match=match):
        resnet_params_from_numpy(named)


def test_served_logits_match_jax(r50):
    """The slice end to end on the CPU: two single-image submits from
    two threads and one submit_batch of both images through ModelServer
    over BlockPredictor give the JAX logits."""
    _, net, x, ref = r50
    server = ModelServer(BlockPredictor(net, device="cpu"), device="cpu",
                         max_batch=4, linger_us=20_000,
                         input_shapes=[SHAPE[1:]])
    futs = [None, None]

    def client(i):
        futs[i] = server.submit(x[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    both = server.submit_batch(x)
    singles = [f.result(timeout=120) for f in futs]
    batched = both.result(timeout=120)
    server.close()
    _close(np.stack(singles), ref)
    _close(batched, ref)
    stats = server.stats()
    assert server._counters()["examples"] == 4
    assert stats["serving.error.count"] == 0


def test_cpu_path_counts_no_kernel_launches(r50):
    _, net, x, _ = r50
    before = (sbr_matmul.launches, sbr_conv3x3.launches)
    with torch.inference_mode():
        net(torch.from_numpy(x))
    assert (sbr_matmul.launches, sbr_conv3x3.launches) == before


def test_seeded_init_is_deterministic_and_order_one():
    """initialize(seed) draws the same weights for the same seed, and
    its BN draw keeps ResNet-50's logits O(1) through 16 blocks."""
    a = vision.resnet50_v1(classes=10, layout="NHWC", fuse_block=True,
                           device="cpu", seed=7).eval()
    b = vision.resnet50_v1(classes=10, layout="NHWC", fuse_block=True,
                           device="cpu", seed=7).eval()
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb), ka
    x = torch.from_numpy(_images(2, (2, 64, 64, 3)))
    with torch.inference_mode():
        out = a(x)
    assert torch.isfinite(out).all() and 0.05 < out.abs().max() < 50


@pytest.mark.parametrize("kw,match", [
    (dict(fuse_block="chain2"), "unknown fuse_block"),
    # ResNet V2 is ported: version 2 builds a ResNetV2, version 3 raises
    pytest.param(dict(version=2), "version 2", id="kw1-version 2"),
    (dict(pretrained=True), "pretrained")])
def test_unported_options_raise(kw, match):
    version = kw.pop("version", 1)
    if version == 2:
        net = vision.get_resnet(version, 18, device="cpu", classes=10, **kw)
        assert isinstance(net, vision.ResNetV2)
        assert "features.0.gamma" in net.state_dict()   # the stem norm
        with pytest.raises(MXNetError, match="version: 3"):
            vision.get_resnet(3, 18, device="cpu", **kw)
        return
    with pytest.raises(MXNetError, match=match):
        vision.get_resnet(version, 18, device="cpu", **kw)


def test_device_none_means_the_card(monkeypatch):
    """get_resnet, BlockPredictor and ModelServer with no device resolve
    to cuda:0 and raise without a GPU; the CPU runs only when asked for,
    train mode included (it moves the running statistics towards the
    batch's)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        vision.resnet18_v1(classes=4)
    net = vision.resnet18_v1(classes=4, thumbnail=True, device="cpu")
    with pytest.raises(MXNetError, match="no CUDA device"):
        BlockPredictor(net)
    with pytest.raises(MXNetError, match="no CUDA device"):
        ModelServer(BlockPredictor(net, device="cpu"))
    bn = net.features[1][0].body[2]
    before = bn.running_mean.clone()
    out = net.train()(torch.rand(2, 3, 8, 8))
    assert out.shape == (2, 4) and torch.isfinite(out).all()
    assert not torch.equal(bn.running_mean, before)
