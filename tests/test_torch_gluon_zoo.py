"""The model zoo's Gluon surface: the port's ResNet V1 (``resnet18_v1``
at 32x32, b=2) against the JAX package's.  ``collect_params`` names
every parameter and moving statistic as JAX does and views the net's
own tensors; ``save_params`` from the port, loaded by JAX's
``load_params``, gives equal logits (and JAX's full-name file loaded by
the port's); one ``gluon.Trainer``
step over ``collect_params`` equals one ``TrainStep`` step; the
BatchNorm mode of an NDArray call follows ``autograd`` (not the
module's ``.training``), and a tensor in still gives a tensor out."""
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jax_vision
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.ops.fused_conv import sbr_conv3x3, sbr_matmul
from incubator_mxnet_tpu_torch.parallel import TrainStep

NET = dict(classes=10, layout="NHWC", fuse_block=True)
SGD_KW = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(2, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, 2).astype(np.float32))


def _net(seed=3):
    return vision.resnet18_v1(device="cpu", seed=seed, **NET)


@pytest.fixture(scope="module")
def jax_net():
    with jmx.cpu():
        net = jax_vision.resnet18_v1(prefix="resnetv10_", **NET)
        net.initialize()
        with jmx.autograd.pause():
            net(jmx.nd.array(_batch()[0]))
    return net


def test_collect_params_names_and_views(jax_net):
    net = _net()
    params = net.collect_params()
    assert sorted(params.keys()) == sorted(jax_net.collect_params().keys())
    tensors = dict(net.named_parameters())
    tensors.update(net.named_buffers())
    ids = {id(t) for t in tensors.values()}
    for name, p in params.items():
        assert id(p.data()._data) in ids, name       # a view, not a copy
        stat = name.endswith(("running_mean", "running_var"))
        assert (p.grad_req == "null") == stat and p._is_aux == stat, name
    assert net.collect_params() is not params
    assert all(net.collect_params()[n] is p for n, p in params.items())
    assert list(net.collect_params(".*stage1_.*gamma").keys()) == \
        [n for n in params.keys() if n.startswith("resnetv10_stage1_")
         and n.endswith("gamma")]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_params_interchange_with_jax(jax_net, direction, tmp_path):
    x = _batch()[0]
    net = _net()
    path = os.path.join(tmp_path, "r18.params")
    if direction == "port_to_jax":
        net.save_params(path)
        with jmx.cpu():
            jax_net.load_params(path, ctx=jmx.cpu())
    else:
        with jmx.cpu():
            jax_net.collect_params().save(path)
        with tmx.cpu():
            net.load_params(path)
        for name, p in jax_net.collect_params().items():
            np.testing.assert_array_equal(
                net.collect_params()[name].data().asnumpy(),
                p.data().asnumpy())
    with jmx.cpu():
        ref = jax_net(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        got = net(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_trainer_step_equals_train_step():
    """A Gluon step (the loss's per-sample values, ``backward``,
    ``trainer.step(2)``) and a ``TrainStep`` step (the mean loss) on the
    same weights and batch: every parameter and moving statistic bit for
    bit on the CPU (the two differ by a power of two in the loss)."""
    x, y = _batch(1)
    a, b = _net(5), _net(5)
    with tmx.cpu():
        trainer = tmx.gluon.Trainer(a.collect_params(), "sgd", SGD_KW)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        before = (sbr_matmul.launches, sbr_conv3x3.launches)
        with tmx.autograd.record():
            loss = loss_fn(a(tmx.nd.array(x)), tmx.nd.array(y))
        loss.backward()
        trainer.step(2)
    assert (sbr_matmul.launches, sbr_conv3x3.launches) == before
    TrainStep(b, SoftmaxCrossEntropyLoss(), tmx.optimizer.SGD(**SGD_KW),
              device="cpu")(x, y)
    sa, sb = a.state_dict(), b.state_dict()
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k


def test_nd_call_follows_autograd_mode():
    """Under ``record()`` the BatchNorms take batch statistics and move
    the running ones (in place, seen through the views); a paused call
    is eval; the module's own mode is put back."""
    x = _batch(2)[0]
    net = _net()
    net.eval()
    stat = "features.1.running_mean"
    with tmx.cpu():
        before = net.state_dict()[stat].clone()
        view = net.collect_params()["resnetv10_batchnorm0_running_mean"]
        out = net(tmx.nd.array(x))
        assert isinstance(out, tmx.nd.NDArray) and out.shape == (2, 10)
        assert torch.equal(net.state_dict()[stat], before)
        with tmx.autograd.record():
            train_out = net(tmx.nd.array(x))
        assert train_out._data.grad_fn is not None
        assert not torch.equal(net.state_dict()[stat], before)
        np.testing.assert_array_equal(view.data().asnumpy(),
                                      net.state_dict()[stat].numpy())
        with tmx.autograd.pause():
            paused = net(tmx.nd.array(x))
    assert not net.training
    with torch.inference_mode():
        t = net(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), paused.asnumpy())


def test_gluon_initialize_fills_by_name():
    """``initialize(seed)`` keeps the seeded draw; an Initializer fills
    every Parameter in place by its name's suffix (gamma 1, beta 0,
    running_var 1, biases 0)."""
    net = _net(7)
    again = _net(7)
    for k, v in net.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    with tmx.cpu():
        net.initialize(tmx.init.Xavier())
    sd = net.state_dict()
    assert torch.equal(sd["features.1.gamma"],
                       torch.ones_like(sd["features.1.gamma"]))
    assert torch.equal(sd["features.1.running_var"],
                       torch.ones_like(sd["features.1.running_var"]))
    assert torch.equal(sd["output.bias"], torch.zeros_like(sd["output.bias"]))
    w = sd["features.0.weight"]
    bound = np.sqrt(3.0 / ((w.shape[1] + w.shape[0]) * 49 / 2.0))
    assert 0 < w.abs().max().item() <= bound
