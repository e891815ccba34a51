"""Shared helper of the zoo parity tests (``test_torch_zoo*.py``): one
zoo model built by name in both packages under the same prefix, the
JAX package's initialised weights carried to the port by name."""
import numpy as np

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch import convert
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision


def forward_pair(name, prefix, x, classes=10, grad=False, **kwargs):
    """Run ``x`` through the JAX net (Xavier weights from seed 0), then
    through the port's (on the CPU) with the JAX net's weights carried
    across by name.  Returns ``(jax_out, port_out, jax_grads,
    port_grads, (jax_net, port_net))``, the grads of ``out.backward()``
    by name when ``grad`` (a recorded forward in predict mode: BatchNorm
    on its running statistics and Dropout off, so that a small batch
    does not make the comparison chaotic)."""
    jmx.random.seed(0)
    jnet = jvision.get_model(name, classes=classes, prefix=prefix, **kwargs)
    jnet.initialize(jmx.init.Xavier(magnitude=2))
    jx = jmx.nd.array(x)
    if grad:
        with jmx.autograd.record(train_mode=False):
            jy = jnet(jx)
        jy.backward()
    else:
        jy = jnet(jx)
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    with tmx.cpu():
        tnet = tvision.get_model(name, classes=classes, prefix=prefix,
                                 **kwargs)
        convert.gluon_params_from_numpy(tnet, arrays)
        tx = tmx.nd.array(x)
        if grad:
            with tmx.autograd.record(train_mode=False):
                ty = tnet(tx)
            ty.backward()
        else:
            ty = tnet(tx)
    jg = tg = None
    if grad:
        jg = {k: p.grad().asnumpy() for k, p in jnet.collect_params().items()
              if p.grad_req != "null"}
        tg = {k: p.grad().asnumpy() for k, p in tnet.collect_params().items()
              if p.grad_req != "null"}
    return jy.asnumpy(), ty.asnumpy(), jg, tg, (jnet, tnet)


def assert_close_of_max(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of max > {tol}"
