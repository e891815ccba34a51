"""The port's model zoo beyond ResNet (VGG, AlexNet, SqueezeNet,
MobileNet here; DenseNet, Inception-BN and Inception V3 in
``test_torch_zoo_deep.py``) and ``gluon.contrib.nn``, held to the JAX
package on the CPU.

Each family's smallest model at ``classes=10``, b=1, at the smallest
input its architecture takes (b=2 for the gradients, recorded in
predict mode); the JAX net's Xavier weights (seed 0) go to the port by
name (``convert.gluon_params_from_numpy``).  Tolerances:
outputs 1e-5 and gradients 1e-4 of the reference's max (other fp32
summation orders); names, shapes and the model list exactly.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.contrib import nn as jcnn
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch import convert
from incubator_mxnet_tpu_torch.gluon.contrib import nn as tcnn
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from _zoo_parity import assert_close_of_max, forward_pair

TOL = 1e-5
ALL_NAMES = sorted([
    "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
    "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
    "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
    "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "squeezenet1.0", "squeezenet1.1", "inceptionv3", "inceptionbn",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25"])


@pytest.mark.parametrize("name,size,prefix", [
    ("vgg11", 32, "vgg0_"), ("vgg11_bn", 32, "vgg1_"),
    ("alexnet", 67, "alexnet0_"), ("squeezenet1.1", 32, "squeezenet0_"),
    ("squeezenet1.0", 35, "squeezenet1_")])
def test_zoo_forward_matches_jax(name, size, prefix):
    x = np.random.RandomState(1).rand(1, 3, size, size).astype(np.float32)
    jy, ty, _, _, (jnet, tnet) = forward_pair(name, prefix, x)
    assert ty.shape == jy.shape == (1, 10)
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert_close_of_max(ty, jy, TOL, name)


def test_zoo_gradients_match_jax():
    """MobileNet's forward, recorded at b=2, and its backward: every
    parameter's gradient, through the grouped depthwise convolutions."""
    x = np.random.RandomState(2).rand(2, 3, 32, 32).astype(np.float32)
    jy, ty, jg, tg, (jnet, tnet) = forward_pair(
        "mobilenet0.25", "mobilenet0_", x, grad=True)
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert_close_of_max(ty, jy, TOL, "output")
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert_close_of_max(tg[k], jg[k], 1e-4, k)


def test_get_model_knows_the_jax_names():
    assert sorted(tvision._MODELS) == ALL_NAMES
    with pytest.raises(ValueError):
        tvision.get_model("vgg10")
    with pytest.raises(IOError):
        tvision.get_model("alexnet", pretrained=True)


@pytest.mark.parametrize("name,prefix", [
    ("vgg16", "vgg3_"), ("densenet121", "densenet3_"),
    ("inceptionv3", "inception33_"), ("inceptionbn", "inceptionbn3_"),
    ("mobilenet1.0", "mobilenet3_"), ("squeezenet1.0", "squeezenet3_")])
def test_zoo_parameter_names_and_shapes_match_jax(name, prefix):
    """The full-width nets' names, in order, and their declared shapes
    (deferred input dims are 0 on both sides) before any forward."""
    jnet = jvision.get_model(name, prefix=prefix)
    with tmx.cpu():
        tnet = tvision.get_model(name, prefix=prefix)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    for k in jp.keys():
        assert tuple(tp[k].shape or ()) == tuple(jp[k].shape or ()), k


def test_zoo_weights_travel_both_ways(tmp_path):
    """Port -> JAX through the port's ``save_params`` names: the JAX net
    loads the port's file and gives the port's output."""
    x = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    rs = np.random.RandomState(4)
    with tmx.cpu():
        tnet = tvision.get_model("squeezenet1.1", classes=10,
                                 prefix="squeezenet7_")
        tnet.initialize(tmx.init.Xavier())
        tnet(tmx.nd.array(x))
        arrays = {k: rs.normal(0, 0.05, v.shape).astype(np.float32)
                  for k, v in convert.gluon_params_to_numpy(tnet).items()}
        convert.gluon_params_from_numpy(tnet, arrays)
        ty = tnet(tmx.nd.array(x)).asnumpy()
        tnet.collect_params().save(str(tmp_path / "sq.params"))
    jnet = jvision.get_model("squeezenet1.1", classes=10,
                             prefix="squeezenet7_")
    jnet.collect_params().load(str(tmp_path / "sq.params"))
    jy = jnet(jmx.nd.array(x)).asnumpy()
    assert_close_of_max(ty, jy, TOL, "port weights in JAX")
    with pytest.raises(tmx.MXNetError):
        convert.gluon_params_from_numpy(tnet, {"nope": arrays[next(
            iter(arrays))]})


def _branches(m, cls, axis, prefix):
    net = cls(axis=axis, prefix=prefix)
    with net.name_scope():
        net.add(m.gluon.nn.Dense(3, in_units=4))
        net.add(m.gluon.contrib.nn.Identity())
        net.add(m.gluon.nn.Dense(2, in_units=4, activation="tanh"))
    return net


@pytest.mark.parametrize("kind", ["Concurrent", "HybridConcurrent"])
def test_contrib_concurrent_matches_jax(kind):
    x = np.random.RandomState(5).randn(2, 4).astype(np.float32)
    jnet = _branches(jmx, getattr(jcnn, kind), 1, "cc_")
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.record():
        jy = jnet(jmx.nd.array(x))
    jy.backward()
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    with tmx.cpu():
        tnet = _branches(tmx, getattr(tcnn, kind), 1, "cc_")
        convert.gluon_params_from_numpy(tnet, arrays)
        tx = tmx.nd.array(x)
        with tmx.autograd.record():
            ty = tnet(tx)
        ty.backward()
    assert ty.shape == (2, 9)
    assert_close_of_max(ty.asnumpy(), jy.asnumpy(), TOL, kind)
    for k, p in jnet.collect_params().items():
        assert_close_of_max(tnet.collect_params()[k].grad().asnumpy(),
                            p.grad().asnumpy(), TOL, k)


def test_contrib_identity_and_namespace():
    with tmx.cpu():
        x = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        np.testing.assert_array_equal(tcnn.Identity()(x).asnumpy(),
                                      x.asnumpy())
    assert tmx.gluon.contrib.nn.HybridConcurrent is tcnn.HybridConcurrent
    assert sorted(tcnn.__all__) == sorted(jcnn.__all__)
