"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
a tiny decoder and a small ResNet V1 with seeded numpy weights, each
built on both sides — the JAX package's model (the reference) and the
port's, the weights moved through ``convert.params_from_numpy`` /
``convert.resnet_params_from_numpy``."""
import numpy as np
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.gluon.decoder import TransformerDecoder as JaxDecoder
from incubator_mxnet_tpu.gluon.model_zoo import vision as jax_vision
from incubator_mxnet_tpu_torch.convert import (params_from_numpy,
                                               resnet_params_from_numpy)
from incubator_mxnet_tpu_torch.gluon.decoder import \
    TransformerDecoder as TorchDecoder
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet

VOCAB = 32


@pytest.fixture(autouse=True)
def fresh_port_telemetry():
    """The port's telemetry registry zeroed and its switch read from
    ``MXNET_TELEMETRY`` before each test of a module that imports this
    fixture: the registry is process-wide (the JAX conftest resets only
    the JAX package's), so ``stats()`` counts would leak from one test
    into the next in a worker."""
    from incubator_mxnet_tpu_torch import telemetry
    telemetry.reset()
    telemetry.enabled = telemetry._default_enabled()
    yield telemetry
SMALL = dict(vocab=VOCAB, dim=32, heads=2, depth=2, max_len=64)


def jax_decoder(seed=0, **kw):
    """The reference decoder with weights drawn by numpy from ``seed``:
    weights ~ N(0, 0.2), biases and LayerNorm beta ~ N(0, 0.1),
    gamma ~ 1 + N(0, 0.1)."""
    cfg = dict(SMALL, **kw)
    mx.random.seed(0)
    net = JaxDecoder(prefix="lm_", **cfg)
    net.initialize()
    rs = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        noise = rs.randn(*p.shape).astype(np.float32)
        if name.endswith("gamma"):
            arr = 1.0 + 0.1 * noise
        elif name.endswith(("beta", "bias")):
            arr = 0.1 * noise
        else:
            arr = 0.2 * noise
        p.set_data(mx.nd.array(arr))
    return net


def torch_twin(jax_net, **kw):
    """The port's decoder on the CPU holding ``jax_net``'s weights."""
    named = {n: p.data().asnumpy()
             for n, p in jax_net.collect_params().items()}
    net = TorchDecoder(device="cpu", **dict(SMALL, **kw))
    net.load_state_dict(params_from_numpy(named))
    return net.eval()


def prompts(n, seed=1, lengths=None):
    rs = np.random.RandomState(seed)
    lengths = lengths or [int(rs.randint(2, 14)) for _ in range(n)]
    return [rs.randint(1, VOCAB, size=L).tolist() for L in lengths]


def jax_resnet(seed=0, num_layers=50, input_shape=(2, 16, 16, 3), **kw):
    """The reference ResNet V1 (``prefix="resnet_"``) with weights and
    BN statistics drawn by numpy from ``seed`` (``seeded_fill``).  One
    forward on zeros of ``input_shape`` first fixes the deferred shapes
    (and compiles the ops for that shape, so later forwards of it are
    cheap)."""
    mx.random.seed(0)
    net = jax_vision.get_resnet(1, num_layers, prefix="resnet_", **kw)
    return seeded_fill(net, seed, input_shape)


def seeded_fill(net, seed, input_shape):
    """Initialise the JAX ``net``, run one forward on zeros of
    ``input_shape`` to fix its deferred shapes, then draw every
    parameter by numpy from ``seed``, in parameter order: conv weights
    N(0, 2 / fan_in), conv and Dense biases N(0, 0.1^2), Dense weight
    N(0, 2 / in_units), BN gamma U(0.5, 1), beta and running_mean
    N(0, 0.1^2), running_var U(0.5, 1.5).  Returns ``net``."""
    net.initialize()
    net(mx.nd.zeros(input_shape)).asnumpy()
    rs = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        shape = p.shape
        if name.endswith("gamma"):
            arr = rs.uniform(0.5, 1.0, shape)
        elif name.endswith("running_var"):
            arr = rs.uniform(0.5, 1.5, shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            arr = 0.1 * rs.randn(*shape)
        else:
            arr = rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        p.set_data(mx.nd.array(arr.astype(np.float32)))
    return net


def jax_resnet_of(block, spec, seed, input_shape, **kw):
    """The reference ``ResNetV1(block, *spec)`` (``prefix="resnet_"``),
    seeded as ``jax_resnet`` does."""
    mx.random.seed(0)
    return seeded_fill(jax_vision.ResNetV1(block, *spec, prefix="resnet_",
                                           **kw), seed, input_shape)


def port_state(jax_net):
    """The port's ResNet V1 state_dict holding ``jax_net``'s values."""
    return resnet_params_from_numpy({n: p.data().asnumpy() for n, p in
                                     jax_net.collect_params().items()})


def jax_train(jax_net, x, y, steps, sgd_kw, **step_kw):
    """``steps`` steps of the reference ``TrainStep`` (softmax
    cross-entropy, SGD with ``sgd_kw``, ``step_kw`` for the step) on the
    batch ``(x, y)``: (the losses, the port's state_dict of the final
    values, the step)."""
    step = jax_parallel.TrainStep(
        jax_net, jax_gluon.loss.SoftmaxCrossEntropyLoss(),
        mx.optimizer.SGD(**sgd_kw), **step_kw)
    losses = [float(step(mx.nd.array(x), mx.nd.array(y)).asscalar())
              for _ in range(steps)]
    step.sync_params()
    return losses, port_state(jax_net), step


def torch_twin_resnet(jax_net, num_layers=50, **kw):
    """The port's ResNet V1 on the CPU, in eval mode, holding
    ``jax_net``'s weights (``kw``: the same model options)."""
    named = {n: p.data().asnumpy()
             for n, p in jax_net.collect_params().items()}
    net = get_resnet(1, num_layers, device="cpu", **kw)
    net.load_state_dict(resnet_params_from_numpy(named))
    return net.eval()


def tf32_rna(t):
    """fp32 values rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as the card's ``cvt.rna.tf32.f32`` rounds them: on
    the bit pattern, ``(bits + 0x1000) & ~0x1FFF``."""
    import torch
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(t):
    """``(big, small)``, both TF32, with big + small = t to ~2^-22."""
    big = tf32_rna(t)
    return big, tf32_rna(t - big)


def change_errs(got, ref, init, keys):
    """Per key, how far ``got`` moved from ``init`` other than ``ref``
    did: ``|d_got - d_ref| / |d_ref|`` over the changes ``d`` (L2) —
    the per-leaf measure of a bf16 training step against a reference
    step (tests/test_torch_train_options.py, test_torch_train_modes.py)."""
    errs = {}
    for k in keys:
        d_got, d_ref = got[k] - init[k], ref[k] - init[k]
        errs[k] = ((d_got - d_ref).double().norm() /
                   d_ref.double().norm()).item()
    return errs
