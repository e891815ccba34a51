"""The port's MoE and pipeline modules in one process, against the JAX
package: ``_dispatch_tensors`` (capacity overflow included),
``moe_ffn`` and its Switch loss with their gradients, ``MoELayer``,
``split_microbatches``, ``PipelineStack``'s sequential unroll (the
semantics the GPipe schedule must match; the schedule itself is held to
JAX in the four-rank world of ``tests/test_torch_model_parallel.py``),
``pipeline_spmd`` on a mesh without ``pp``, and ``Pipeline`` with its
``shard_over`` refusal.  Inputs are seeded numpy arrays."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.parallel.moe import (
    _dispatch_tensors as jax_dispatch, moe_ffn as jax_moe_ffn)
from incubator_mxnet_tpu.parallel.pipeline import (
    split_microbatches as jax_split)
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, parallel
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.parallel.moe import _dispatch_tensors
from incubator_mxnet_tpu_torch.parallel.pipeline import split_microbatches

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max() + 1e-7)


def _moe_arrays(rs, n=24, d=8, h=16, e=4):
    f = np.float32
    return [rs.randn(n, d).astype(f), rs.randn(d, e).astype(f),
            (0.3 * rs.randn(e, d, h)).astype(f),
            (0.1 * rs.randn(e, h)).astype(f),
            (0.3 * rs.randn(e, h, d)).astype(f),
            (0.1 * rs.randn(e, d)).astype(f)]


@pytest.mark.parametrize("top_k,capacity,normalize", [
    (2, 12, True), (2, 3, True), (1, 2, False), (3, 5, True)])
def test_dispatch_tensors_match_jax(top_k, capacity, normalize):
    """Dispatch and combine, with capacities that drop tokens (3, 2, 5
    slots for 24 tokens) in the JAX slot order."""
    import jax.numpy as jnp
    rs = np.random.RandomState(top_k * 10 + capacity)
    logits = rs.randn(24, 4).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    d, c = _dispatch_tensors(torch.from_numpy(probs), top_k, capacity,
                             normalize)
    jd, jc = jax_dispatch(jnp.asarray(probs), top_k, capacity, normalize)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _close(c, jc)
    if capacity < 24 * top_k / 4:
        assert d.sum() < 24 * top_k      # some token was dropped


@pytest.mark.parametrize("activation,capacity_factor", [
    ("relu", 1.25), ("gelu", 2.0), (None, 0.5)])
def test_moe_ffn_and_aux_loss_with_gradients_match_jax(activation,
                                                       capacity_factor):
    import jax
    import jax.numpy as jnp
    rs = np.random.RandomState(1)
    arrays = _moe_arrays(rs)
    cot = rs.randn(24, 8).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=capacity_factor,
              activation=activation)

    def jloss(*a):
        y, aux = jax_moe_ffn(*a, **kw)
        return (y * cot).sum() + aux, (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    y, aux = parallel.moe_ffn(*ts, **kw)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    for t, g in zip(ts, jgrads):
        _close(t.grad, g)


def test_moe_ffn_sharded_without_the_axis_is_moe_ffn():
    rs = np.random.RandomState(2)
    ts = [torch.from_numpy(a) for a in _moe_arrays(rs)]
    mesh = parallel.make_mesh(dp=1, device="cpu")
    y, aux = parallel.moe_ffn_sharded(*ts, mesh)
    y2, aux2 = parallel.moe_ffn(*ts)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


def test_moe_layer_matches_jax_and_keeps_its_aux_loss():
    rs = np.random.RandomState(4)
    x = rs.randn(10, 8).astype(np.float32)
    with mx.cpu():
        layer = parallel.MoELayer(8, 16, 4, capacity_factor=2.0,
                                  aux_loss_weight=0.5, prefix="moe_")
        layer.initialize(init=mx.init.Xavier(), ctx=mx.cpu())
    jlayer = jax_parallel.MoELayer(8, 16, 4, capacity_factor=2.0,
                                   aux_loss_weight=0.5, prefix="moe_")
    jlayer.initialize()
    for n, p in layer.collect_params().items():
        jlayer.collect_params()[n].set_data(jmx.nd.array(
            p.data().asnumpy()))
    assert layer.w1.sharding == ("ep", None, None) == jlayer.w1.sharding
    assert layer.b2.sharding == ("ep", None) == jlayer.b2.sharding
    with autograd.record():
        y = layer(mx.nd.array(x, ctx=mx.cpu()))
    jy = jlayer(jmx.nd.array(x))
    _close(y.asnumpy(), jy.asnumpy())
    np.testing.assert_allclose(layer.aux_loss.asnumpy(),
                               jlayer.aux_loss.asnumpy(), rtol=1e-6)
    y.backward()
    assert layer.gate_w.grad().asnumpy().any()


@pytest.mark.parametrize("axis", [0, 1])
def test_split_microbatches_matches_jax(axis):
    import jax.numpy as jnp
    a = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    np.testing.assert_array_equal(
        split_microbatches(torch.from_numpy(a), 2, axis).numpy(),
        np.asarray(jax_split(jnp.asarray(a), 2, axis)))


def _stage(pkg, d=8):
    nn = pkg.gluon.nn
    blk = nn.HybridSequential(prefix="blk_")
    with blk.name_scope():
        blk.add(nn.LayerNorm(in_channels=d),
                nn.Dense(2 * d, activation="relu", in_units=d,
                         flatten=False),
                nn.Dense(d, in_units=2 * d, flatten=False))
    return blk


def test_pipeline_stack_unroll_matches_jax():
    """The stacked parameters' names, shapes and shardings are JAX's;
    with no pp mesh the stack runs its stages in turn, as JAX's does;
    gradients reach every stacked parameter."""
    rs = np.random.RandomState(6)
    x = rs.randn(4, 3, 8).astype(np.float32)
    with mx.cpu():
        stack = parallel.PipelineStack(_stage(mx), num_stages=3,
                                       prefix="stack_")
        stack.initialize(init=mx.init.Xavier(), ctx=mx.cpu())
    jstack = jax_parallel.PipelineStack(_stage(jmx), num_stages=3,
                                        prefix="stack_")
    jstack.initialize()
    jparams = jstack.collect_params()
    assert list(stack.collect_params()) == list(jparams)
    for n, p in stack.collect_params().items():
        assert p.shape == jparams[n].shape
        assert p.sharding == jparams[n].sharding
        vals = (0.5 * rs.randn(*p.shape)).astype(np.float32)
        p.set_data(mx.nd.array(vals, ctx=mx.cpu()))
        jparams[n].set_data(jmx.nd.array(vals))
    assert stack.num_stages == 3
    with autograd.record():
        y = stack(mx.nd.array(x, ctx=mx.cpu()))
    _close(y.asnumpy(), jstack(jmx.nd.array(x)).asnumpy())
    y.backward()
    for p in stack.collect_params().values():
        assert p.grad().asnumpy().any(), p.name


def test_pipeline_spmd_without_pp_runs_each_microbatch():
    rs = np.random.RandomState(8)
    w = torch.from_numpy(rs.randn(1, 5, 5).astype(np.float32))
    mbs = torch.from_numpy(rs.randn(3, 2, 5).astype(np.float32))
    mesh = parallel.make_mesh(dp=1, device="cpu")

    def stage(params, x):
        return torch.tanh(x @ params[0])

    out = parallel.pipeline_spmd(stage, [w], mbs, mesh)
    assert torch.equal(out, torch.stack([stage([w[0]], m) for m in mbs]))
    x = torch.from_numpy(rs.randn(6, 5).astype(np.float32))
    np.testing.assert_allclose(
        parallel.pipeline_forward(stage, [w], x, 3, mesh).numpy(),
        torch.tanh(x @ w[0]).numpy(), rtol=1e-6)
    with pytest.raises(MXNetError, match="stages but the mesh"):
        parallel.pipeline_spmd(stage, [torch.zeros(2, 5, 5)], mbs, mesh)
    with pytest.raises(MXNetError, match="not divisible"):
        parallel.pipeline_forward(stage, [w], x, 4, mesh)


def test_pipeline_stack_refuses_aux_state_and_unknown_shapes():
    nn = mx.gluon.nn
    with mx.cpu():
        with pytest.raises(MXNetError, match="grad_req='null'"):
            parallel.PipelineStack(nn.BatchNorm(in_channels=4),
                                   num_stages=2)
        with pytest.raises(MXNetError, match="static shapes"):
            parallel.PipelineStack(nn.Dense(4), num_stages=2)


def test_pipeline_container_and_shard_over_refusal():
    nn = mx.gluon.nn
    rs = np.random.RandomState(9)
    x = rs.randn(2, 4).astype(np.float32)
    with mx.cpu():
        pipe = parallel.Pipeline(nn.Dense(6, in_units=4),
                                 parallel.PipelineStage(
                                     nn.Dense(3, in_units=6), 1))
        pipe.initialize(ctx=mx.cpu())
    assert pipe.num_stages == 2
    stages = list(pipe._children.values())
    want = stages[1](stages[0](mx.nd.array(x, ctx=mx.cpu())))
    assert np.array_equal(pipe(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
                          want.asnumpy())
    with pytest.raises(MXNetError, match="heterogeneous"):
        pipe.shard_over(parallel.make_mesh(dp=1, device="cpu"))
    jpipe = jax_parallel.Pipeline(jgluon.nn.Dense(6, in_units=4))
    with pytest.raises(Exception, match="heterogeneous"):
        jpipe.shard_over(None)
