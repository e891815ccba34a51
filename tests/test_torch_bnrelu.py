"""The fused BatchNorm + ReLU of the PyTorch port against the JAX package:
``ops.nn.fused_batch_norm_relu`` against the JAX op
``_FusedBatchNormRelu`` (its ``_bn_relu_core`` custom VJP), and the
``gluon.nn.BNReLU`` layer against the JAX ``BNReLU`` layer, moving
statistics included.

Both sides get the same seeded numpy inputs (cast to bf16 on both sides
for the bf16 cases).  The JAX op runs eagerly on the CPU, one XLA call
per ``jnp`` operation, as the port runs one PyTorch call per operation.

Tolerances, relative to each tensor's largest magnitude: fp32 1e-5
(other summation orders in the reductions; observed <= 4e-7); bf16
2^-8, one rounding step of bf16's 8-bit significand (the port computes
in the reference's order with the same casts; observed 0, bit-equal).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import nn as jax_nn
from incubator_mxnet_tpu.ops.nn import _fused_batch_norm_relu
from incubator_mxnet_tpu_torch.gluon.nn._modules import (
    Activation, BatchNorm, BNReLU)
from incubator_mxnet_tpu_torch.ops.nn import fused_batch_norm_relu

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)}
BN_NAMES = ("gamma", "beta", "running_mean", "running_var")


def _inputs(seed, shape, axis):
    rs = np.random.RandomState(seed)
    f = np.float32
    c = shape[axis]
    return dict(
        x=(rs.randn(*shape) * 2 + 0.5).astype(f),
        gamma=(rs.rand(c) + 0.5).astype(f),
        beta=(rs.randn(c) * 0.5).astype(f),
        mmean=(rs.randn(c) * 0.3).astype(f),
        mvar=(rs.rand(c) + 0.5).astype(f),
        dy=rs.randn(*shape).astype(f),
        dmean=rs.randn(c).astype(f),
        dvar=rs.randn(c).astype(f))


def _close(got, ref, rtol, what):
    got = got.detach().float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max() + 1e-30, (what, err)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("train_stats", [True, False])
def test_op_matches_jax(train_stats, fix_gamma, axis, dtype):
    """y, mean, var and the gradients of x, gamma and beta (and of the
    moving statistics in the global-stats form, where mean and var pass
    them through) against the JAX op under ``jax.vjp``, with cotangents
    on all three outputs: the train form's dx then carries the
    ``ct_mean`` / ``ct_var`` terms too.  The port's channel axis is dim
    1: for the axis-last case x and dy are moved there and y back."""
    jdt, tdt, rtol = DTYPES[dtype]
    a = _inputs(7, (4, 6, 5, 7), axis)
    names = ("x", "gamma", "beta", "mmean", "mvar")

    def jfwd(*args):
        return _fused_batch_norm_relu(*args, eps=1e-5, fix_gamma=fix_gamma,
                                      use_global_stats=not train_stats,
                                      axis=axis)

    cast = [jnp.asarray(a[n]).astype(jdt) for n in names]
    refs, vjp = jax.vjp(jfwd, *cast)
    rgrads = vjp(tuple(jnp.asarray(a[n]).astype(jdt)
                       for n in ("dy", "dmean", "dvar")))
    targs = [torch.from_numpy(a[n]).to(tdt).requires_grad_(True)
             for n in names]
    y, mean, var = fused_batch_norm_relu(
        targs[0].movedim(axis, 1), *targs[1:], eps=1e-5,
        fix_gamma=fix_gamma, train_stats=train_stats)
    outs = (y.movedim(1, axis), mean, var)
    assert [o.dtype for o in outs] == [tdt] * 3
    for what, got, ref in zip(("y", "mean", "var"), outs, refs):
        _close(got, ref, rtol, what)
    torch.autograd.backward(outs, [torch.from_numpy(a[n]).to(tdt)
                                   for n in ("dy", "dmean", "dvar")])
    checked = names if not train_stats else names[:3]
    for what, t, ref in zip(names, targs, rgrads):
        if what in checked:
            _close(t.grad, ref, rtol, "d" + what)
        else:   # the train form gives the moving statistics no gradient
            assert t.grad is None and not np.asarray(ref).any()


def test_backward_saves_one_activation():
    """The op's backward keeps one activation-sized tensor (xhat), and
    the per-channel vectors: ``saved_tensors_hooks`` sees every tensor
    that ``save_for_backward`` packs."""
    a = _inputs(3, (4, 8, 6, 6), 1)
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    gamma = torch.from_numpy(a["gamma"]).requires_grad_(True)
    beta = torch.from_numpy(a["beta"]).requires_grad_(True)
    packed = []

    def pack(t):
        packed.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _, _ = fused_batch_norm_relu(
            x, gamma, beta, torch.from_numpy(a["mmean"]),
            torch.from_numpy(a["mvar"]), train_stats=True)
    assert packed.count(tuple(x.shape)) == 1
    assert all(s == (8,) for s in packed if s != tuple(x.shape))
    y.sum().backward()
    assert x.grad is not None and gamma.grad is not None


@pytest.mark.parametrize("train", [True, False])
def test_layer_forward_matches_batchnorm_then_relu(train):
    """BNReLU and the port's BatchNorm + Activation("relu") with one
    state: the outputs within 1e-6 of max |y| (the same statistics; the
    normalisation as the xhat form against the folded ``x*a + b``), the
    running statistics equal after a train-mode call."""
    a = _inputs(5, (4, 8, 6, 6), 1)
    state = {n: torch.from_numpy(a[k]) for n, k in
             zip(BN_NAMES, ("gamma", "beta", "mmean", "mvar"))}
    fused, plain = BNReLU(8, device="cpu"), BatchNorm(8, device="cpu")
    fused.load_state_dict(state)
    plain.load_state_dict(state)
    fused.train(train)
    plain.train(train)
    x = torch.from_numpy(a["x"]).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = fused(x)
        ref = Activation("relu")(plain(x))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert (y - ref).abs().max() <= 1e-6 * ref.abs().max()
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(fused, name), getattr(plain, name))


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_layer_matches_jax_layer(fix_gamma):
    """A train-mode call of BNReLU against the JAX BNReLU layer under
    ``autograd.record()``: the output, the gradients of x, gamma and beta
    of ``sum(y^2)``, and the moving statistics the JAX front end folds;
    then an eval-mode call on the moved statistics.  fp32, 1e-5 of each
    tensor's max."""
    a = _inputs(11, (4, 8, 6, 6), 1)
    jl = jax_nn.BNReLU(scale=not fix_gamma, in_channels=8, epsilon=1e-5)
    jl.initialize()
    for n, k in zip(BN_NAMES, ("gamma", "beta", "mmean", "mvar")):
        getattr(jl, n).set_data(mx.nd.array(a[k]))
    jx = mx.nd.array(a["x"])
    jx.attach_grad()
    with mx.autograd.record():
        jy = jl(jx)
        jloss = (jy ** 2).sum()
    jloss.backward()
    layer = BNReLU(8, epsilon=1e-5, scale=not fix_gamma, device="cpu")
    layer.load_state_dict({n: torch.from_numpy(a[k]) for n, k in zip(
        BN_NAMES, ("gamma", "beta", "mmean", "mvar"))})
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    y = layer.train()(x)
    (y ** 2).sum().backward()
    _close(y, jy.asnumpy(), 1e-5, "y")
    _close(x.grad, jx.grad.asnumpy(), 1e-5, "dx")
    _close(layer.beta.grad, jl.beta.grad().asnumpy(), 1e-5, "dbeta")
    if not fix_gamma:
        _close(layer.gamma.grad, jl.gamma.grad().asnumpy(), 1e-5, "dgamma")
    for n in ("running_mean", "running_var"):
        _close(getattr(layer, n), getattr(jl, n).data().asnumpy(), 1e-5, n)
    with mx.autograd.predict_mode():
        jeval = jl(mx.nd.array(a["x"])).asnumpy()
    with torch.no_grad():
        _close(layer.eval()(torch.from_numpy(a["x"])), jeval, 1e-5, "eval")
