"""The port's Executor against the JAX package's, on the CPU: the eight
scenarios of the JAX package's own tests/test_executor.py (bind /
forward / backward, grad_req add and null, simple_bind, SoftmaxOutput's
p - label, reshape, the BatchNorm aux update, the monitor callback),
each run on both packages with the same numpy inputs and held to the
JAX result within 1e-5 of each array's max |value|; then the gradient
of every output layer (SoftmaxOutput in each of its modes, the three
regression outputs, SVMOutput in both forms) through ``backward``, and
the recorded graph's second ``backward``."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-5


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= REL * scale, (what, err, scale)


def _both(fn):
    """fn(mx) on each package (the port's on the CPU): (jax, port)."""
    with tmx.cpu():
        port = fn(tmx)
    return fn(jmx), port


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def test_bind_forward_backward():
    def run(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        c = a * b + a
        ex = c.bind(args={"a": mx.nd.array([2.0, 3.0]),
                          "b": mx.nd.array([4.0, 5.0])},
                    args_grad={"a": mx.nd.zeros((2,)),
                               "b": mx.nd.zeros((2,))})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(mx.nd.array([1.0, 1.0]))
        return out, _np(ex.grad_dict)
    (jo, jg), (to, tg) = _both(run)
    _close(to, jo)
    for k in jg:
        _close(tg[k], jg[k], k)
    np.testing.assert_allclose(tg["a"], [5.0, 6.0])


def test_grad_req_add():
    def run(mx):
        a = mx.sym.var("a")
        ex = (a * a).bind(args={"a": mx.nd.array([3.0])},
                          args_grad={"a": mx.nd.zeros((1,))}, grad_req="add")
        seen = []
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward(mx.nd.array([1.0]))
            seen.append(ex.grad_dict["a"].asnumpy())
        # a second backward of one forward adds the same gradient again
        ex.backward(mx.nd.array([1.0]))
        seen.append(ex.grad_dict["a"].asnumpy())
        return seen
    jax, port = _both(run)
    for j, t in zip(jax, port):
        _close(t, j)
    np.testing.assert_allclose(np.concatenate(port), [6.0, 12.0, 18.0])


def test_grad_req_null():
    def run(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        ex = (a * b).bind(args={"a": mx.nd.array([2.0]),
                                "b": mx.nd.array([3.0])},
                          args_grad={"a": mx.nd.zeros((1,))},
                          grad_req={"a": "write", "b": "null"})
        ex.forward(is_train=True)
        ex.backward(mx.nd.array([1.0]))
        return _np(ex.grad_dict)
    jax, port = _both(run)
    assert set(port) == set(jax) == {"a"}
    _close(port["a"], jax["a"])


def test_simple_bind_and_update_args():
    w = np.random.RandomState(0).rand(4, 3).astype("float32")
    x = np.random.RandomState(1).rand(2, 3).astype("float32")

    def run(mx):
        fc = mx.sym.FullyConnected(mx.sym.var("data"), name="fc",
                                   num_hidden=4)
        ex = fc.simple_bind(data=(2, 3))
        shapes = {k: v.shape for k, v in ex.arg_dict.items()}
        ex.arg_dict["fc_weight"][:] = w
        ex.arg_dict["fc_bias"][:] = 0
        out = ex.forward(is_train=False, data=mx.nd.array(x))
        return shapes, sorted(ex.grad_dict), out[0].asnumpy()
    (js, jg, jo), (ts, tg, to) = _both(run)
    assert ts == js and tg == jg
    _close(to, jo)
    _close(to, x @ w.T)


def test_softmax_output_backward_is_p_minus_label():
    x = np.random.RandomState(0).rand(3, 4).astype("float32")
    y = np.array([0, 2, 1], "float32")

    def run(mx):
        smo = mx.sym.SoftmaxOutput(mx.sym.var("data"),
                                   mx.sym.var("softmax_label"),
                                   name="softmax")
        ex = smo.bind(args={"data": mx.nd.array(x),
                            "softmax_label": mx.nd.array(y)},
                      args_grad={"data": mx.nd.zeros((3, 4))},
                      grad_req={"data": "write", "softmax_label": "null"})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return out, ex.grad_dict["data"].asnumpy()
    (jo, jg), (to, tg) = _both(run)
    _close(to, jo, "out")
    _close(tg, jg, "grad")
    p = np.exp(x) / np.exp(x).sum(1, keepdims=True)
    np.testing.assert_allclose(tg, p - np.eye(4, dtype="float32")[
        y.astype(int)], rtol=1e-4, atol=1e-6)


def test_executor_reshape():
    def run(mx):
        fc = mx.sym.FullyConnected(mx.sym.var("data"), name="fc",
                                   num_hidden=4)
        ex = fc.simple_bind(data=(2, 3))
        ex.arg_dict["fc_weight"][:] = 1.0
        ex2 = ex.reshape(data=(5, 3))
        out = ex2.forward(data=mx.nd.ones((5, 3)))[0].asnumpy()
        return (ex2.arg_dict["data"].shape,
                ex2.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"], out)
    (js, jsame, jo), (ts, tsame, to) = _both(run)
    assert ts == js == (5, 3) and tsame == jsame is True
    _close(to, jo)


def test_bn_aux_states_update():
    x = np.random.RandomState(0).rand(4, 3).astype("float32") * 3

    def run(mx):
        bn = mx.sym.BatchNorm(mx.sym.var("data"), name="bn", momentum=0.5)
        ex = bn.simple_bind(data=(4, 3))
        ex.aux_dict["bn_moving_var"][:] = 1.0
        ex.arg_dict["bn_gamma"][:] = 1.0
        out = ex.forward(is_train=True, data=mx.nd.array(x))[0].asnumpy()
        return out, _np(ex.aux_dict)
    (jo, ja), (to, ta) = _both(run)
    _close(to, jo, "out")
    assert set(ta) == set(ja) == {"bn_moving_mean", "bn_moving_var"}
    for k in ja:
        _close(ta[k], ja[k], k)
    assert np.abs(ta["bn_moving_mean"]).sum() > 0


def test_monitor_callback():
    def run(mx):
        a = mx.sym.var("a")
        ex = (a * 2).bind(args={"a": mx.nd.array([1.0])})
        seen = []
        ex.set_monitor_callback(
            lambda name, arr: seen.append((name, arr.asnumpy())))
        ex.forward()
        mon = mx.monitor.Monitor(interval=1)
        mon.install_exec(ex)
        mon.tic()
        ex.forward()
        return seen, [(n, s) for _, n, s in mon.toc()]
    (js, jm), (ts, tm) = _both(run)
    assert [n for n, _ in ts] == [n for n, _ in js]
    for (_, t), (_, j) in zip(ts, js):
        _close(t, j)
    assert [n for n, _ in tm] == [n for n, _ in jm]
    _close([s for _, s in tm], [s for _, s in jm])


# ---------------------------------------------------------- output layers
_RS = np.random.RandomState(3)
_X2 = _RS.randn(5, 6).astype("float32")
_X4 = _RS.randn(2, 3, 4, 5).astype("float32")
_X3 = _RS.randn(2, 4, 6).astype("float32")
_Y2 = np.array([0, 5, 2, -1, 3], "float32")

# name -> (op, attrs, data, label)
_OUTPUT_CASES = {
    "softmax": ("SoftmaxOutput", {}, _X2, np.array([0, 5, 2, 1, 3],
                                                   "float32")),
    "softmax_batch_scale": ("SoftmaxOutput",
                            dict(normalization="batch", grad_scale=0.5),
                            _X2, np.array([0, 5, 2, 1, 3], "float32")),
    "softmax_ignore_valid": ("SoftmaxOutput",
                             dict(use_ignore=True, ignore_label=-1,
                                  normalization="valid"), _X2, _Y2),
    "softmax_ignore_null": ("SoftmaxOutput",
                            dict(use_ignore=True, ignore_label=2), _X2,
                            np.array([0, 5, 2, 2, 3], "float32")),
    "softmax_multi_output": ("SoftmaxOutput", dict(multi_output=True),
                             _X4, _RS.randint(0, 3, (2, 4, 5)).astype(
                                 "float32")),
    "softmax_preserve_shape": ("SoftmaxOutput", dict(preserve_shape=True),
                               _X3, _RS.randint(0, 6, (2, 4)).astype(
                                   "float32")),
    "linear": ("LinearRegressionOutput", dict(grad_scale=2.0), _X2,
               _RS.randn(5, 6).astype("float32")),
    "logistic": ("LogisticRegressionOutput", {}, _X2,
                 _RS.rand(5, 6).astype("float32")),
    "mae": ("MAERegressionOutput", {}, _X2,
            _RS.randn(5, 6).astype("float32")),
    "svm_squared": ("SVMOutput", dict(margin=1.5), _X2,
                    np.array([0, 5, 2, 1, 3], "float32")),
    "svm_linear": ("SVMOutput", dict(use_linear=True,
                                     regularization_coefficient=0.5), _X2,
                   np.array([0, 5, 2, 1, 3], "float32")),
}


@pytest.mark.parametrize("case", sorted(_OUTPUT_CASES))
def test_output_layer_gradients(case):
    """Each output layer bound with data and label: the forward, and the
    data gradient of ``backward()`` (head gradients of ones, which the
    layers ignore), against the JAX package's.  The label's shape is
    inferred by the layer's shape rule on both sides."""
    opname, attrs, x, y = _OUTPUT_CASES[case]

    def run(mx):
        out = getattr(mx.sym, opname)(mx.sym.var("data"), name="out",
                                      **attrs)
        arg_shapes, _, _ = out.infer_shape(data=x.shape)
        ex = out.bind(args={"data": mx.nd.array(x),
                            "out_label": mx.nd.array(y)},
                      args_grad={"data": mx.nd.zeros(x.shape)},
                      grad_req={"data": "write", "out_label": "null"})
        fwd = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return arg_shapes, fwd, ex.grad_dict["data"].asnumpy()
    (js, jo, jg), (ts, to, tg) = _both(run)
    assert ts == js
    _close(to, jo, "forward")
    _close(tg, jg, "gradient")
    assert np.abs(tg).sum() > 0


def test_backward_before_forward_and_after_eval_forward_raise():
    with tmx.cpu():
        a = tmx.sym.var("a")
        ex = (a * a).bind(args={"a": tmx.nd.array([3.0])},
                          args_grad={"a": tmx.nd.zeros((1,))})
        with pytest.raises(MXNetError, match="before forward"):
            ex.backward()
        ex.forward(is_train=True)
        ex.forward(is_train=False)
        with pytest.raises(MXNetError, match="before forward"):
            ex.backward()


def test_group2ctx_on_one_device():
    """A ctx_group mapped to the executor's own context places its
    arguments there; a card that does not exist (no GPU here) raises."""
    with tmx.cpu():
        with tmx.AttrScope(ctx_group="dev1"):
            a = tmx.sym.var("a")
        ex = (a + 1).bind(args={"a": tmx.nd.array([1.0])},
                          group2ctx={"dev1": tmx.cpu()})
        np.testing.assert_allclose(ex.forward()[0].asnumpy(), [2.0])
        if tmx.num_gpus() == 0:
            with pytest.raises(MXNetError):
                (a + 1).bind(args={"a": tmx.nd.array([1.0])},
                             group2ctx={"dev1": tmx.gpu(0)})


def _two_group_mlp(mx):
    """x, w1 in group dev1; w2 in group dev2."""
    with mx.AttrScope(ctx_group="dev1"):
        x, w1 = mx.sym.var("x"), mx.sym.var("w1")
        h = mx.sym.FullyConnected(x, weight=w1, no_bias=True, num_hidden=4)
    with mx.AttrScope(ctx_group="dev2"):
        w2 = mx.sym.var("w2")
        y = mx.sym.FullyConnected(mx.sym.relu(h), weight=w2, no_bias=True,
                                  num_hidden=3)
    return y


@pytest.mark.parametrize("placed", [False, True])
def test_group2ctx_places_groups_on_their_contexts(placed):
    """group2ctx with two groups on two contexts (cpu(0) and cpu(1)):
    each group's argument and gradient arrays live on its context, and
    the outputs and gradients equal the JAX executor's one-context bind
    within 1e-5 of max.  (The JAX executor itself refuses this map: its
    jitted forward gets arrays on two virtual devices.)"""
    rs = np.random.RandomState(3)
    vals = {"x": rs.randn(2, 5), "w1": rs.randn(4, 5), "w2": rs.randn(3, 4)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    cot = rs.randn(2, 3).astype(np.float32)

    def run(mx, placed):
        g2c = {"dev1": mx.cpu(0), "dev2": mx.cpu(1)} if placed else None
        ex = _two_group_mlp(mx).bind(
            ctx=mx.cpu(0), args={k: mx.nd.array(v) for k, v in vals.items()},
            args_grad={k: mx.nd.zeros(v.shape) for k, v in vals.items()},
            group2ctx=g2c)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(mx.nd.array(cot))
        ctxs = {k: (ex.arg_dict[k].context, ex.grad_dict[k].context)
                for k in vals}
        return out, _np(ex.grad_dict), ctxs
    jo, jg, _ = run(jmx, False)
    with tmx.cpu():
        to, tg, tctx = run(tmx, placed)
    _close(to, jo, "out")
    for k in jg:
        _close(tg[k], jg[k], k)
    if placed:
        assert tctx["w2"] == (tmx.cpu(1), tmx.cpu(1))
        assert tctx["x"] == tctx["w1"] == (tmx.cpu(0), tmx.cpu(0))
