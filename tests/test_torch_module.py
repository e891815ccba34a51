"""The port's Module family against the JAX package's, on the CPU, with
the same seeded numpy weights and batches on both sides: three
``forward_backward`` + ``update`` steps of the JAX tests' MLP and of a
small conv net with BatchNorm (SGD with momentum and weight decay), the
parameters and moving statistics within 1e-5 of each tensor's max
|value|; ``fit`` from given ``arg_params``; ``score`` and ``predict``
over a padded last batch; checkpoints written by either package loaded
by the other (symbol JSON, params, optimizer states); a batch-size
change; input gradients; fixed parameters; ``BucketingModule``,
``SequentialModule`` and ``FeedForward``; the callbacks and the
monitor."""
import logging

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-5
# a gradient that is 0 in exact arithmetic (a conv bias feeding a
# BatchNorm) moves its parameter by rounding noise: held to this floor
ATOL_ZERO_GRAD = 1e-6


def _close(got, ref, what="", atol=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= REL * scale + atol, (what, err, scale)


def _mlp(mx, hidden=32, classes=4, prefix=""):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, name=prefix + "fc1", num_hidden=hidden)
    h = mx.sym.Activation(h, name=prefix + "relu1", act_type="relu")
    h = mx.sym.FullyConnected(h, name=prefix + "fc2", num_hidden=classes)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _convnet(mx, classes=4):
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="c1")
    h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = mx.sym.Activation(h, act_type="relu", name="a1")
    h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p1")
    h = mx.sym.Convolution(h, kernel=(3, 3), num_filter=16, name="c2")
    h = mx.sym.Activation(h, act_type="relu", name="a2")
    h = mx.sym.Pooling(h, global_pool=True, kernel=(1, 1), pool_type="avg",
                       name="p2")
    h = mx.sym.Flatten(h, name="flat")
    h = mx.sym.FullyConnected(h, num_hidden=classes, name="f2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _blobs(n=256, d=16, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.rand(classes, d) * 4
    y = rs.randint(0, classes, n)
    x = centers[y] + rs.randn(n, d) * 0.3
    return x.astype("float32"), y.astype("float32")


def _images(n=24, seed=5, classes=4):
    rs = np.random.RandomState(seed)
    y = (np.arange(n) % classes).astype("float32")
    x = rs.rand(n, 1, 12, 12).astype("float32")
    return x, y


def _params(sym, shapes, seed=1):
    """Seeded (arg_params, aux_params) as numpy: N(0, 0.3) weights,
    N(0, 0.1) biases and betas, 1 + N(0, 0.1) gammas, the moving
    statistics 0 and 1."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes or name.endswith("label"):
            continue
        noise = rs.randn(*shape).astype("float32")
        args[name] = 1 + 0.1 * noise if name.endswith("gamma") else \
            (0.1 if name.endswith(("bias", "beta")) else 0.3) * noise
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, "float32")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _nd(mx, arrays):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arrays.items()}


def _module(mx, sym, batch, label_shape, params, **kw):
    mod = mx.mod.Module(sym, context=mx.cpu(), **kw)
    mod.bind(data_shapes=[("data", batch)],
             label_shapes=[("softmax_label", label_shape)])
    args, aux = params
    mod.init_params(arg_params=_nd(mx, args), aux_params=_nd(mx, aux))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    return mod


def _batch(mx, x, y, **kw):
    return mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                           label=[mx.nd.array(y, ctx=mx.cpu())], **kw)


def _steps(mx, build, x, y, params, steps=3, **kw):
    sym = build(mx)
    mod = _module(mx, sym, x.shape, y.shape, params, **kw)
    outs = []
    for _ in range(steps):
        mod.forward_backward(_batch(mx, x, y))
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.update()
    args, aux = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in args.items()}, \
        {k: v.asnumpy() for k, v in aux.items()}, mod


@pytest.mark.parametrize("net", ["mlp", "convnet"])
def test_three_module_steps(net):
    build = _mlp if net == "mlp" else _convnet
    x, y = _blobs(n=16) if net == "mlp" else _images(n=8)
    params = _params(build(jmx), {"data": x.shape})
    jo, ja, jx, _ = _steps(jmx, build, x, y, params)
    with tmx.cpu():
        to, ta, tx, mod = _steps(tmx, build, x, y, params)
    for a, b in zip(to, jo):
        _close(a, b, "outputs")
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ja:
        _close(ta[k], ja[k], k, ATOL_ZERO_GRAD if k == "c1_bias" else 0.0)
        assert np.abs(ta[k] - params[0][k]).max() > 0, k
    for k in jx:
        _close(tx[k], jx[k], k)
    # rescale_grad defaults to 1/batch (reference module.py:505)
    assert mod._optimizer.rescale_grad == 1.0 / x.shape[0]


def test_fit_with_arg_params_score_predict():
    x, y = _blobs(n=96)
    params = _params(_mlp(jmx), {"data": (32, 16)})
    res = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        train = mx.io.NDArrayIter(x[:64], y[:64], batch_size=32)
        val = mx.io.NDArrayIter(x[64:], y[64:], batch_size=20)  # pads
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        speed = mx.callback.Speedometer(32, 1)
        epochs = []
        mod.fit(train, eval_data=val, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1}, num_epoch=2,
                arg_params=_nd(mx, params[0]), aux_params={},
                batch_end_callback=[speed,
                                    mx.callback.log_train_metric(1)],
                epoch_end_callback=lambda e, *a: epochs.append(e))
        preds = mod.predict(val)
        score = dict(mod.score(val, ["acc", "ce"]))
        rows = [outs[0].shape[0] for outs, _, _ in mod.iter_predict(val)]
        args, _ = mod.get_params()
        res[name] = (preds.asnumpy(), score,
                     {k: v.asnumpy() for k, v in args.items()}, epochs,
                     rows)
    (jp, js, ja, je, jr), (tp, ts, ta, te, tr) = res["jax"], res["port"]
    assert tr == jr == [20, 12]
    assert tp.shape == jp.shape == (32, 4)
    _close(tp, jp, "predict")
    assert set(ts) == set(js) == {"accuracy", "cross-entropy"}
    assert abs(ts["accuracy"] - js["accuracy"]) < 1e-6
    assert abs(ts["cross-entropy"] - js["cross-entropy"]) <= \
        REL * abs(js["cross-entropy"])
    for k in ja:
        _close(ta[k], ja[k], k)
    assert te == je == [0, 1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross(writer, tmp_path):
    """A checkpoint written by one package's Module (symbol JSON, params,
    optimizer states) loads into the other's Module.load, and both give
    the same outputs; the reader's Predictor too."""
    x, y = _blobs(n=8)
    params = _params(_mlp(jmx), {"data": x.shape})
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    prefix = str(tmp_path / "mlp")
    with tmx.cpu():
        mod = _module(src, _mlp(src), x.shape, y.shape, params)
        mod.forward_backward(_batch(src, x, y))
        mod.update()
        mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
        mod.forward(_batch(src, x, y), is_train=False)
        want = mod.get_outputs()[0].asnumpy()
        back = dst.mod.Module.load(prefix, 3, context=dst.cpu())
        back.bind(data_shapes=[("data", x.shape)],
                  label_shapes=[("softmax_label", y.shape)])
        back.forward(_batch(dst, x, y), is_train=False)
        _close(back.get_outputs()[0].asnumpy(), want, "Module.load")
        back.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
        if writer == "port":
            back.load_optimizer_states(prefix + "-0003.states")
        pred = dst.predict.load_checkpoint_predictor(
            prefix, 3, {"data": x.shape}, ctx=dst.cpu())
        _close(pred.forward(data=x)[0].asnumpy(), want, "Predictor")
    if writer == "port":
        # the port's optimizer states reload into a port Module
        with tmx.cpu():
            again = tmx.mod.Module.load(prefix, 3, context=tmx.cpu())
            again.bind(data_shapes=[("data", x.shape)],
                       label_shapes=[("softmax_label", y.shape)])
            again.init_optimizer(optimizer="sgd")
            again.load_optimizer_states(prefix + "-0003.states")
            assert len(again._updater.states) == 4


def test_batch_size_change_and_input_grads():
    x, y = _blobs(n=16)
    params = _params(_mlp(jmx), {"data": (16, 16)})
    res = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
            mod.bind(data_shapes=[("data", (16, 16))],
                     label_shapes=[("softmax_label", (16,))],
                     inputs_need_grad=True)
            mod.init_params(arg_params=_nd(mx, params[0]))
            mod.forward(_batch(mx, x[:8], y[:8]), is_train=False)
            small = mod.get_outputs()[0].asnumpy()
            mod.forward_backward(_batch(mx, x[:8], y[:8]))
            (dgrad,) = mod.get_input_grads()
            res.append((small, dgrad.asnumpy(), mod.output_shapes))
    (js, jg, jsh), (ts, tg, tsh) = res
    assert ts.shape == (8, 4)
    _close(ts, js, "small batch")
    _close(tg, jg, "input grads")
    assert tsh == jsh and np.abs(tg).sum() > 0


def test_fixed_params():
    x, y = _blobs(n=8)
    params = _params(_mlp(jmx), {"data": x.shape})
    with tmx.cpu():
        mod = _module(tmx, _mlp(tmx), x.shape, y.shape, params,
                      fixed_param_names=["fc1_weight", "fc1_bias"])
        mod.forward_backward(_batch(tmx, x, y))
        mod.update()
        args, _ = mod.get_params()
    np.testing.assert_array_equal(args["fc1_weight"].asnumpy(),
                                  params[0]["fc1_weight"])
    assert np.abs(args["fc2_weight"].asnumpy() -
                  params[0]["fc2_weight"]).sum() > 0
    assert "fc1_weight" not in mod._exec.grad_dict
    # a dist_sync store is ported: in one process it takes the update
    # (the module's optimizer on the store) and steps as the local
    # updater does
    with tmx.cpu():
        dist = _module(tmx, _mlp(tmx), x.shape, y.shape, params)
        dist.init_optimizer(kvstore="dist_sync", force_init=True,
                            optimizer="sgd", optimizer_params={
                                "learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4})
        local = _module(tmx, _mlp(tmx), x.shape, y.shape, params)
        for m in (dist, local):
            m.forward_backward(_batch(tmx, x, y))
            m.update()
    assert type(dist._kvstore).__name__ == "KVStoreDist"
    assert dist._update_on_kvstore and local._kvstore is None
    for name, v in local.get_params()[0].items():
        np.testing.assert_array_equal(dist.get_params()[0][name].asnumpy(),
                                      v.asnumpy())
    # the optimizer states live on the store, and save / load go there
    import pickle
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        fname = f"{tmp}/dist.states"
        dist.save_optimizer_states(fname)
        dist.load_optimizer_states(fname)
        with open(fname, "rb") as f:
            saved = pickle.loads(f.read())
    want = pickle.loads(local._updater.get_states())
    assert saved.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(saved[k].asnumpy(), want[k].asnumpy())


def _bucket_sym(mx):
    def sym_gen(seq_len):
        h = mx.sym.FullyConnected(mx.sym.var("data"), name="fc1",
                                  num_hidden=8)
        h = mx.sym.Activation(h, act_type="relu", name="act")
        h = mx.sym.FullyConnected(h, name="fc2", num_hidden=2)
        return mx.sym.SoftmaxOutput(h, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def test_bucketing_module():
    """Buckets of one parameter set (the keys are the feature width of
    a shared-weight graph: fc1's weight is bound per key, so here only
    the default key is fed after a switch back and forth)."""
    rs = np.random.RandomState(0)
    batches = [(rs.rand(4, 16).astype("float32"),
                rs.randint(0, 2, 4).astype("float32")) for _ in range(3)]
    params = _params(_bucket_sym(jmx)(16)[0], {"data": (4, 16)})
    res = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            mod = mx.mod.BucketingModule(_bucket_sym(mx),
                                         default_bucket_key=16,
                                         context=mx.cpu())
            mod.bind(data_shapes=[("data", (4, 16))],
                     label_shapes=[("softmax_label", (4,))])
            mod.init_params(arg_params=_nd(mx, params[0]))
            mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
            for xb, yb in batches:
                mod.forward(mx.io.DataBatch(
                    data=[mx.nd.array(xb, ctx=mx.cpu())],
                    label=[mx.nd.array(yb, ctx=mx.cpu())], bucket_key=16,
                    provide_data=[("data", (4, 16))],
                    provide_label=[("softmax_label", (4,))]), is_train=True)
                mod.backward()
                mod.update()
            args, _ = mod.get_params()
            res.append(({k: v.asnumpy() for k, v in args.items()},
                        mod.symbol.list_arguments()))
    (ja, jl), (ta, tl) = res
    assert tl == jl
    for k in ja:
        _close(ta[k], ja[k], k)


def test_sequential_module():
    x = np.random.RandomState(0).rand(4, 6).astype("float32")
    y = np.array([0, 1, 0, 1], "float32")

    def build(mx):
        net1 = mx.sym.FullyConnected(mx.sym.var("data"), name="fc1",
                                     num_hidden=8)
        net1 = mx.sym.Activation(net1, name="a1", act_type="relu")
        net2 = mx.sym.FullyConnected(mx.sym.var("fc1_out"), name="fc2",
                                     num_hidden=2)
        return net1, mx.sym.SoftmaxOutput(net2, name="softmax")
    n1, n2 = build(jmx)
    p1, _ = _params(n1, {"data": (4, 6)})
    p2, _ = _params(n2, {"fc1_out": (4, 8)}, seed=2)
    params = dict(p1, **{k: v for k, v in p2.items() if k != "fc1_out"})
    res = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            net1, net2 = build(mx)
            mod = mx.mod.SequentialModule()
            mod.add(mx.mod.Module(net1, label_names=None, context=mx.cpu()),
                    auto_wiring=True)
            mod.add(mx.mod.Module(net2, data_names=("fc1_out",),
                                  context=mx.cpu()),
                    take_labels=True, auto_wiring=True)
            mod.bind(data_shapes=[("data", (4, 6))],
                     label_shapes=[("softmax_label", (4,))])
            mod.init_params(arg_params=_nd(mx, params))
            mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
            mod.forward(_batch(mx, x, y), is_train=True)
            out = mod.get_outputs()[0].asnumpy()
            mod.backward()
            mod.update()
            args, _ = mod.get_params()
            res.append((out, {k: v.asnumpy() for k, v in args.items()}))
    (jo, ja), (to, ta) = res
    _close(to, jo, "out")
    assert set(ta) == set(ja) >= {"fc1_weight", "fc2_weight"}
    for k in ja:
        _close(ta[k], ja[k], k)


def test_feedforward(tmp_path):
    """FeedForward from given weights on numpy data: fit (no shuffle:
    one batch), predict, score, save/load, create; both packages."""
    rs = np.random.RandomState(0)
    X = rs.rand(32, 6).astype("float32")
    y = (X[:, 0] + X[:, 1] > 1.0).astype("float32")

    def build(mx):
        net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=16,
                                    name="ff_fc1")
        net = mx.sym.Activation(net, act_type="relu", name="ff_relu")
        return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            net, num_hidden=2, name="ff_fc2"), name="softmax")
    params, _ = _params(build(jmx), {"data": (32, 6)})
    res = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            model = mx.model.FeedForward(
                build(mx), ctx=mx.cpu(), num_epoch=3, optimizer="sgd",
                learning_rate=0.5, numpy_batch_size=32,
                arg_params=_nd(mx, params), aux_params={})
            model.fit(X, y)
            probs = model.predict(X)
            acc = model.score(X, y)
            prefix = str(tmp_path / f"ff_{mx.__name__}")
            model.save(prefix, 7)
            loaded = mx.model.FeedForward.load(prefix, 7, ctx=mx.cpu())
            np.testing.assert_allclose(loaded.predict(X), probs, rtol=1e-5,
                                       atol=1e-6)
            res.append((probs, acc))
    (jp, ja), (tp, ta) = res
    _close(tp, jp, "predict")
    assert ta == ja
    with tmx.cpu():
        made = tmx.model.FeedForward.create(build(tmx), X, y, ctx=tmx.cpu(),
                                            num_epoch=2, learning_rate=0.5)
    assert made.predict(X).shape == (32, 2)


def test_callbacks_and_monitor(tmp_path, caplog):
    """do_checkpoint / module_checkpoint write the checkpoint pair, the
    Speedometer logs a rate, and a Monitor installed on a Module sees
    the outputs."""
    x, y = _blobs(n=64)
    prefix = str(tmp_path / "cb")
    with tmx.cpu(), caplog.at_level(logging.INFO):
        it = tmx.io.NDArrayIter(x, y, batch_size=16)
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mon = tmx.monitor.Monitor(interval=1, pattern="softmax.*")
        speed = tmx.callback.Speedometer(16, 2)
        mod.fit(it, num_epoch=1, monitor=mon, initializer=tmx.init.Xavier(),
                batch_end_callback=[speed, tmx.callback.ProgressBar(4)],
                epoch_end_callback=[
                    tmx.callback.do_checkpoint(prefix),
                    tmx.callback.module_checkpoint(mod, prefix + "m")])
    assert speed.speeds and all(s > 0 for s in speed.speeds)
    assert "Speed" in caplog.text
    sym, args, aux = tmx.model.load_checkpoint(prefix, 1)
    assert sym.list_arguments() == _mlp(tmx).list_arguments()
    assert set(args) == {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"}
    assert tmx.model.load_checkpoint(prefix + "m", 1)[1].keys() == \
        args.keys()
    assert mon.step == 4
