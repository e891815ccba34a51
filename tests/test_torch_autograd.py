"""The port's ``mx.autograd`` (over ``torch.autograd``) against the JAX
package's tape, scenario by scenario (the JAX package's
tests/test_autograd.py, run on both sides on the same seeded inputs),
plus what only the port has to show: an in-place update of a variable
outside ``record()``, and that torch's own ``.grad`` never fills.

Gradients are compared at relative 1e-5 plus absolute 1e-6 (fp32, the
same math in other orders); scenarios with exact arithmetic are held
exactly."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


def _both(scenario):
    """The scenario's arrays from the JAX package and from the port (on
    the CPU)."""
    want = scenario(jmx)
    with tmx.cpu():
        got = scenario(tmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.asnumpy() if hasattr(g, "asnumpy") else np.asarray(g)
        w = w.asnumpy() if hasattr(w, "asnumpy") else np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return got


def simple_grad(mx):
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x + 2 * x
    y.backward()
    return [x.grad]


def chain(mx):
    x = mx.nd.array([[0.5, -0.5], [0.3, 0.9]])
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.exp(mx.nd.sin(x)).sum()
    y.backward()
    return [x.grad, y]


def multi_input(mx):
    a, b = mx.nd.array([1.0, 2.0]), mx.nd.array([3.0, 4.0])
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        c = (a * b).sum()
    c.backward()
    return [a.grad, b.grad]


def head_grad(mx):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = 3 * x
    y.backward(mx.nd.array([10.0, 100.0]))
    return [x.grad]


def grad_req_add(mx):
    x = mx.nd.array([2.0])
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with mx.autograd.record():
            y = x * x
        y.backward()
    return [x.grad]


def grad_req_write(mx):
    x = mx.nd.array([2.0, -1.0])
    x.attach_grad(grad_req="write")
    for k in range(3):
        with mx.autograd.record():
            y = (x * x * (k + 1)).sum()
        y.backward()
    return [x.grad]


def grad_req_null(mx):
    x, z = mx.nd.array([2.0]), mx.nd.array([5.0])
    x.attach_grad(grad_req="null")
    z.attach_grad()
    with mx.autograd.record():
        y = x * z
    y.backward()
    return [x.grad, z.grad]


def detach_and_stop_gradient(mx):
    x = mx.nd.array([2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
        z = y.detach() * x + mx.nd.BlockGrad(y) * x
    z.backward()
    return [x.grad]


def fc_grad(mx):
    rs = np.random.RandomState(0)
    data = mx.nd.array(rs.rand(4, 10).astype(np.float32))
    w = mx.nd.array(rs.rand(3, 10).astype(np.float32))
    b = mx.nd.array(rs.rand(3).astype(np.float32))
    for v in (data, w, b):
        v.attach_grad()
    with mx.autograd.record():
        out = mx.nd.FullyConnected(data, w, b, num_hidden=3)
        loss = (out * out).sum()
    loss.backward()
    return [data.grad, w.grad, b.grad, loss]


def train_mode_flags(mx):
    ag = mx.autograd
    flags = [ag.is_recording(), ag.is_training()]
    with ag.record():
        flags += [ag.is_recording(), ag.is_training()]
        with ag.predict_mode():
            flags.append(ag.is_training())
        with ag.pause():
            flags += [ag.is_recording(), ag.is_training()]
            with ag.train_mode():
                flags.append(ag.is_training())
    with ag.record(train_mode=False):
        flags += [ag.is_recording(), ag.is_training()]
    flags += [ag.is_recording(), ag.is_training()]
    return [np.array(flags)]


def pause(mx):
    x = mx.nd.array([1.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2
        with mx.autograd.pause():
            z = x * 3      # not recorded
        w = y + z
    w.backward()
    return [x.grad, w]


def grad_api(mx):
    x = mx.nd.array([3.0, -1.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
    (g,) = mx.autograd.grad([y], [x])
    return [g, x.grad]


def custom_function(mx):
    nd = mx.nd

    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = nd.array([0.0, 1.0, -1.0])
    x.attach_grad()
    with mx.autograd.record():
        y = Sigmoid()(x)
        loss = (y * nd.array([1.0, 2.0, 3.0])).sum()
    loss.backward()
    return [x.grad, y]


def multi_output(mx):
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    x.attach_grad()
    with mx.autograd.record():
        parts = mx.nd.split(x, num_outputs=3, axis=1)
        loss = parts[0].sum() + 2 * parts[2].sum()
    loss.backward()
    return [x.grad]


def retain_graph(mx):
    x = mx.nd.array([1.5, -2.0])
    x.attach_grad(grad_req="add")
    with mx.autograd.record():
        y = (x * x * x).sum()
    y.backward(retain_graph=True)
    y.backward(retain_graph=True)
    return [x.grad]


def attach_after_forward_inplace_update(mx):
    """SGD outside record(): an in-place update of a variable, then
    another recorded step."""
    w = mx.nd.array([0.5, -1.5, 2.0])
    w.attach_grad()
    x = mx.nd.array([1.0, 2.0, 3.0])
    for _ in range(3):
        with mx.autograd.record():
            loss = ((w * x).sum() - 1.0) ** 2
        loss.backward()
        w -= 0.01 * w.grad
    w[:] = w - 0.01 * w.grad
    return [w, w.grad]


@pytest.mark.parametrize("scenario", [
    simple_grad, chain, multi_input, head_grad, grad_req_add,
    grad_req_write, grad_req_null, detach_and_stop_gradient, fc_grad,
    train_mode_flags, pause, grad_api, custom_function, multi_output,
    retain_graph, attach_after_forward_inplace_update],
    ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    _both(scenario)


def test_torch_grad_field_never_fills_and_no_graph_outside_record():
    with tmx.cpu():
        w = tmx.nd.array([1.0, 2.0])
        w.attach_grad()
        with tmx.autograd.record():
            y = (w * w).sum()
        y.backward()
        assert w._data.grad is None
        z = w * 3                       # outside record(): no graph
        assert z._data.grad_fn is None and not z._data.requires_grad
        w += 1.0                        # in place on a leaf: allowed
        np.testing.assert_array_equal(w.asnumpy(), [2.0, 3.0])
        np.testing.assert_array_equal(w.grad.asnumpy(), [2.0, 4.0])


def test_backward_twice_without_retain_graph_raises():
    """Like the reference (and unlike the JAX tape, which keeps every
    closure), the graph is freed by a backward without retain_graph."""
    with tmx.cpu():
        x = tmx.nd.array([1.0, 2.0])
        x.attach_grad()
        with tmx.autograd.record():
            y = (x * x).sum()
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()


def test_head_not_recorded_raises():
    with tmx.cpu():
        x = tmx.nd.array([1.0])
        x.attach_grad()
        y = x * 2
        with pytest.raises(MXNetError, match="not connected"):
            y.backward()
        with pytest.raises(MXNetError, match="grad_req"):
            x.attach_grad(grad_req="sometimes")
