"""The port's custom operators (``mx.operator``) against the JAX
package's, on the CPU: the same CustomOp / CustomOpProp classes,
registered in both packages, run through ``nd.Custom`` under
``autograd.record`` and through ``sym.Custom`` in an executor and a
Module; the forward, the user's backward (a deliberately wrong gradient
shows that it is the user's, not autograd's), two inputs, an auxiliary
state (zero gradient), a Gluon block, string kwargs and the errors.
Values within 1e-5 of each array's max |value|."""
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
    assert float(np.abs(got - ref).max()) <= REL * scale, what


def _register(mx):
    """The test ops, registered in package ``mx`` under ``tc_`` names."""
    op = mx.operator

    class Sqr(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @op.register("tc_sqr")
    class SqrProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class WrongGrad(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 3)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            # not the analytic gradient (3): the user's backward rules
            self.assign(in_grad[0], req[0], out_grad[0] * 7)

    @op.register("tc_wrong_grad")
    class WrongGradProp(op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return WrongGrad()

    class TwoIn(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * in_data[1])
            self.assign(in_grad[1], req[1], out_grad[0] * in_data[0])

    @op.register("tc_twoin")
    class TwoInProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def infer_shape(self, in_shape):
            assert in_shape[0] == in_shape[1]
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return TwoIn()

    class Scaled(op.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] * self.scale + aux[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.scale)

    @op.register("tc_scaled")
    class ScaledProp(op.CustomOpProp):
        """A string kwarg and an auxiliary state."""

        def __init__(self, scale="1"):
            super().__init__()
            self.scale = float(scale)

        def list_auxiliary_states(self):
            return ["shift"]

        def create_operator(self, ctx, shapes, dtypes):
            return Scaled(self.scale)

    class SoftmaxLoss(op.CustomOp):
        """The reference's custom softmax example: forward softmax,
        backward p - onehot(label), ignoring the head gradient."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = mx.nd.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            onehot = mx.nd.one_hot(in_data[1], depth=y.shape[1])
            self.assign(in_grad[0], req[0], y - onehot)

    @op.register("tc_softmax")
    class SoftmaxLossProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxLoss()


_register(jmx)
_register(tmx)


def _imperative(mx, op_type, arrays, head, **kw):
    """nd.Custom on ``arrays`` under record(); (out, input grads)."""
    xs = [mx.nd.array(a, ctx=mx.cpu()) for a in arrays]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(*xs, op_type=op_type, **kw)
    y.backward(mx.nd.array(head, ctx=mx.cpu()))
    return y.asnumpy(), [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("case", ["tc_sqr", "tc_wrong_grad", "tc_twoin"])
def test_custom_imperative(case):
    rs = np.random.RandomState(0)
    n_in = 2 if case == "tc_twoin" else 1
    arrays = [rs.randn(3, 4).astype("float32") for _ in range(n_in)]
    head = rs.randn(3, 4).astype("float32")
    jo, jg = _imperative(jmx, case, arrays, head)
    with tmx.cpu():
        to, tg = _imperative(tmx, case, arrays, head)
    _close(to, jo, "forward")
    for a, b in zip(tg, jg):
        _close(a, b, "gradient")
    if case == "tc_wrong_grad":
        _close(tg[0], head * 7, "user gradient")


def test_custom_string_kwargs_and_aux_state():
    """The prop gets its kwargs as strings; the aux state is read by the
    forward and gets a zero gradient through the executor."""
    x = np.random.RandomState(1).randn(2, 3).astype("float32")
    shift = np.full((2, 3), 0.5, "float32")
    res = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            out = mx.sym.Custom(data=mx.sym.var("data"),
                                shift=mx.sym.var("shift"),
                                op_type="tc_scaled", scale=2.5, name="sc")
            ex = out.bind(mx.cpu(), {"data": mx.nd.array(x, ctx=mx.cpu()),
                                     "shift": mx.nd.array(shift,
                                                          ctx=mx.cpu())},
                          args_grad={"data": mx.nd.zeros((2, 3)),
                                     "shift": mx.nd.zeros((2, 3))})
            y = ex.forward(is_train=True)[0].asnumpy()
            ex.backward(mx.nd.ones((2, 3)))
            res.append((out.list_arguments(), y,
                        {k: v.asnumpy() for k, v in ex.grad_dict.items()}))
    (jl, jy, jg), (tl, ty, tg) = res
    assert tl == jl == ["data", "shift"]
    _close(ty, jy, "forward")
    _close(ty, x * 2.5 + 0.5, "forward value")
    for k in jg:
        _close(tg[k], jg[k], k)
    np.testing.assert_array_equal(tg["shift"], 0.0)


def test_custom_loss_trains_a_module():
    """The custom softmax as a Module's loss: two steps, the same
    parameters as the JAX Module's."""
    rs = np.random.RandomState(2)
    x = rs.randn(8, 5).astype("float32")
    y = rs.randint(0, 3, 8).astype("float32")
    w = (0.3 * rs.randn(3, 5)).astype("float32")
    res = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            fc = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=3,
                                       no_bias=True, name="fc")
            net = mx.sym.Custom(data=fc, label=mx.sym.var("softmax_label"),
                                op_type="tc_softmax", name="loss")
            mod = mx.mod.Module(net, context=mx.cpu())
            mod.bind(data_shapes=[("data", (8, 5))],
                     label_shapes=[("softmax_label", (8,))])
            mod.init_params(arg_params={"fc_weight": mx.nd.array(
                w, ctx=mx.cpu())})
            mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
            batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                                    label=[mx.nd.array(y, ctx=mx.cpu())])
            for _ in range(2):
                mod.forward_backward(batch)
                mod.update()
            res.append((mod.get_outputs()[0].asnumpy(),
                        mod.get_params()[0]["fc_weight"].asnumpy()))
    (jo, jw), (to, tw) = res
    _close(to, jo, "probabilities")
    _close(tw, jw, "weight")
    assert np.abs(tw - w).max() > 0


def test_custom_in_gluon_block():
    res = []
    for mx in (jmx, tmx):
        class Net(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return mx.nd.Custom(x, op_type="tc_sqr") + 1

        with tmx.cpu():
            net = Net(prefix="custom_")
            net.hybridize()
            x = mx.nd.array(np.array([2.0, 3.0], "float32"), ctx=mx.cpu())
            x.attach_grad()
            with mx.autograd.record():
                out = net(x)
            out.backward(mx.nd.ones((2,), ctx=mx.cpu()))
            res.append((out.asnumpy(), x.grad.asnumpy()))
    (jo, jg), (to, tg) = res
    _close(to, jo)
    _close(tg, jg)
    np.testing.assert_allclose(tg, [4.0, 6.0])


def test_custom_errors():
    with tmx.cpu():
        with pytest.raises(MXNetError, match="not registered"):
            tmx.nd.Custom(tmx.nd.ones((2,)), op_type="tc_nope")
        with pytest.raises(MXNetError, match="takes 2 args"):
            tmx.nd.Custom(tmx.nd.ones((2,)), op_type="tc_twoin")
        with pytest.raises(MXNetError, match="must subclass"):
            tmx.operator.register("tc_bad")(object)
