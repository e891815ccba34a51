"""The symbolic ResNet v2 of examples/train_imagenet.py (the builder
copied into chip_smoke.py, built here by both packages) at a small
size: units [1, 1], filters [8, 16, 32], 10 classes, 32x32 images, a
batch of 4.  Against the JAX package on the CPU, with the same seeded
numpy weights:

* the logits, then two ``Module`` steps (SGD lr 0.05, momentum 0.9, wd
  1e-4, the example's settings): loss, outputs, parameters and moving
  statistics within 1e-4 of each tensor's max |value|;
* the NHWC form with ``_FusedBNReluConv`` nodes (``sym_resnet_fused``)
  against the JAX package's same symbol with the nodes'
  ``impl="pallas_interpret"`` and ``impl="xla"``, and against the NCHW
  logits (1e-4 of max);
* checkpoints crossing both ways into ``Module`` and ``Predictor``;
  ``ModelServer`` over the symbol ``Predictor``: served equal to direct,
  one executor per bucket, concurrent ``Predictor.forward`` from
  threads each getting its own outputs;
* ``SymbolBlock``, ``HybridBlock.export`` and ``Parameter.var``.
"""
import threading

import numpy as np
import pytest

import chip_smoke as cs
import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from torch_port_helpers import fresh_port_telemetry  # noqa: F401

UNITS, FILTERS, CLASSES, IMAGE, BATCH = [1, 1], [8, 16, 32], 10, \
    (3, 32, 32), 4
REL = 1e-4
# conv biases are absent (no_bias) here; the moving statistics and
# parameters are held at REL of their max
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def _close(got, ref, what="", rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (what, err, scale)


def _sym(mx):
    return cs.sym_resnet(mx, UNITS, FILTERS, CLASSES, IMAGE)


def _params(seed=0):
    """Seeded numpy (arg, aux): He-scaled conv / fc weights, gammas
    1 + N(0, 0.1), betas and the fc bias N(0, 0.1), moving means
    N(0, 0.1) and variances in [0.5, 1.5)."""
    sym = _sym(tmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH,) + IMAGE)
    rs = np.random.RandomState(seed)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        noise = rs.randn(*shape).astype("float32")
        if name.endswith("gamma"):
            args[name] = 1 + 0.1 * noise
        elif name.endswith(("beta", "bias")):
            args[name] = 0.1 * noise
        else:
            args[name] = noise * np.sqrt(2.0 / np.prod(shape[1:]))
    aux = {}
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = (0.1 * rs.randn(*shape) if name.endswith("mean")
                     else 0.5 + rs.rand(*shape)).astype("float32")
    return args, aux


def _batch_np(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.rand(BATCH, *IMAGE).astype("float32"),
            rs.randint(0, CLASSES, BATCH).astype("float32"))


def _nd(mx, d):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in d.items()}


def _logits(mx, sym, params, x, layout_x=None):
    """Eval-mode forward of ``sym`` (every argument and aux bound) on
    ``x``: the first output as numpy."""
    args, aux = params
    bound = {n: mx.nd.array(args[n], ctx=mx.cpu())
             for n in sym.list_arguments() if n != "data"}
    bound["data"] = mx.nd.array(x if layout_x is None else layout_x,
                                ctx=mx.cpu())
    ex = sym.bind(mx.cpu(), bound, aux_states=_nd(mx, {
        n: aux[n] for n in sym.list_auxiliary_states()}), grad_req="null")
    return ex.forward(is_train=False)[0].asnumpy()


def _train(mx, params, x, y, steps=2):
    mod = mx.mod.Module(_sym(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params=_nd(mx, params[0]),
                    aux_params=_nd(mx, params[1]))
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y, ctx=mx.cpu())])
    outs, losses = [], []
    for _ in range(steps):
        mod.forward_backward(batch)
        p = mod.get_outputs()[0].asnumpy()
        outs.append(p)
        losses.append(float(-np.log(p[np.arange(len(y)),
                                      y.astype(int)]).mean()))
        mod.update()
    args, aux = mod.get_params()
    return mod, outs, losses, {k: v.asnumpy() for k, v in args.items()}, \
        {k: v.asnumpy() for k, v in aux.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's logits, two Module steps and its checkpoint,
    computed once."""
    params = _params()
    x, y = _batch_np()
    logits = _logits(jmx, _sym(jmx).get_internals()["fc1_output"], params,
                     x)
    mod, outs, losses, args, aux = _train(jmx, params, x, y)
    return dict(params=params, x=x, y=y, logits=logits, mod=mod, outs=outs,
                losses=losses, args=args, aux=aux)


def test_logits_and_two_module_steps(jax_side):
    j = jax_side
    with tmx.cpu():
        logits = _logits(tmx, _sym(tmx).get_internals()["fc1_output"],
                         j["params"], j["x"])
        _, outs, losses, args, aux = _train(tmx, j["params"], j["x"],
                                            j["y"])
    _close(logits, j["logits"], "logits")
    for a, b in zip(outs, j["outs"]):
        _close(a, b, "outputs")
    _close(losses, j["losses"], "losses")
    assert sorted(args) == sorted(j["args"]) and \
        sorted(aux) == sorted(j["aux"])
    for k in j["args"]:
        _close(args[k], j["args"][k], k)
    for k in j["aux"]:
        _close(aux[k], j["aux"][k], k)


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_fused_nhwc_form(jax_side, impl):
    """The NHWC graph with _FusedBNReluConv nodes: the port's (the kernel
    wrappers' plain versions on the CPU) against the JAX package's same
    graph with ``impl``, and against the NCHW logits.  The checkpoint's
    aux entries for the moving statistics only the fused nodes read are
    re-keyed to arguments, by name."""
    j = jax_side
    xh = np.ascontiguousarray(j["x"].transpose(0, 2, 3, 1))
    res = {}
    for name, mx, node_impl in (("jax", jmx, impl), ("port", tmx, None)):
        fused, n1, n3 = cs.sym_resnet_fused(mx, UNITS, FILTERS, CLASSES,
                                            IMAGE, impl=node_impl)
        args, aux, moved = cs.sym_fused_params(fused, *j["params"])
        res[name] = (_logits(mx, fused, (args, aux), xh), n1, n3, moved,
                     fused.tojson())
    (jl, j1, j3, jm, jjson), (tl, t1, t3, tm, tjson) = res["jax"], \
        res["port"]
    # conv1 and conv3 of both units and stage 1's shortcut; conv2 of the
    # stride-1 unit
    assert (t1, t3) == (j1, j3) == (5, 1)
    assert tm == jm and len(tm) == 2 * (t1 + t3) - 4
    _close(tl, jl, f"fused vs JAX {impl}")
    _close(tl, j["logits"], "fused vs NCHW")
    # the JAX graph's JSON, impl attribute and all, runs in the port
    with tmx.cpu():
        loaded = tmx.sym.load_json(jjson)
        args, aux, _ = cs.sym_fused_params(loaded, *j["params"])
        _close(_logits(tmx, loaded, (args, aux), xh), jl, "loaded JSON")
    assert tmx.sym.load_json(jjson).tojson() == jjson


def test_checkpoints_cross_into_module_and_predictor(jax_side, tmp_path):
    """The JAX Module's checkpoint (after its two steps) loads into the
    port's Module and Predictor; the port's own checkpoint of the same
    weights loads into the JAX Predictor; all give the same outputs."""
    j = jax_side
    prefix = str(tmp_path / "jax")
    j["mod"].save_checkpoint(prefix, 2)
    jpred = jmx.predict.load_checkpoint_predictor(
        prefix, 2, {"data": j["x"].shape})
    want = jpred.forward(data=j["x"])[0].asnumpy()
    with tmx.cpu():
        mod = tmx.mod.Module.load(prefix, 2, context=tmx.cpu())
        mod.bind(data_shapes=[("data", j["x"].shape)],
                 label_shapes=[("softmax_label", j["y"].shape)],
                 for_training=False)
        mod.forward(tmx.io.DataBatch(data=[tmx.nd.array(j["x"])]),
                    is_train=False)
        _close(mod.get_outputs()[0].asnumpy(), want, "port Module")
        pred = tmx.predict.load_checkpoint_predictor(
            prefix, 2, {"data": j["x"].shape}, ctx=tmx.cpu())
        _close(pred.forward(data=j["x"])[0].asnumpy(), want,
               "port Predictor")
        back = str(tmp_path / "port")
        mod.save_checkpoint(back, 5)
    jback = jmx.predict.load_checkpoint_predictor(
        back, 5, {"data": j["x"].shape})
    _close(jback.forward(data=j["x"])[0].asnumpy(), want, "JAX Predictor")


def test_model_server_over_symbol_predictor(jax_side, tmp_path):
    j = jax_side
    prefix = str(tmp_path / "srv")
    tmx.model.save_checkpoint(prefix, 1, _sym(tmx), _nd(tmx, j["params"][0]),
                              _nd(tmx, j["params"][1]))
    images = np.random.RandomState(7).rand(14, *IMAGE).astype("float32")
    with tmx.cpu():
        pred = tmx.predict.load_checkpoint_predictor(
            prefix, 1, {"data": (BATCH,) + IMAGE}, ctx=tmx.cpu())
        direct = np.concatenate([
            pred.forward(data=images[i:i + BATCH])[0].asnumpy()
            for i in range(0, 12, BATCH)] + [
            pred.reshape({"data": (2,) + IMAGE}).forward(
                data=images[12:])[0].asnumpy()])
        server = tmx.serving.ModelServer(pred, max_batch=BATCH,
                                         device="cpu")
        futs = [None] * 3

        def client(i):
            futs[i] = [server.submit(images[4 * i + k]) for k in range(4)]
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tail = server.submit_batch(images[12:])
        got = np.stack([f.result(timeout=60) for g in futs for f in g])
        got = np.concatenate([got, tail.result(timeout=60)])
        stats = server.stats()
        buckets = sorted(server._runner.by_bucket)
        server.close()
    assert got.shape == (14, CLASSES)
    _close(got, direct, "served vs direct", rel=1e-5)
    assert server._counters()["examples"] == 14
    assert stats["serving.error.count"] == 0
    assert set(buckets) <= set(server._cfg.buckets) | {BATCH}
    # concurrent forwards: each thread's get_output is its own
    seen = {}

    def worker(i):
        x = images[i:i + BATCH]
        out = pred.forward(data=x)[0].asnumpy()
        seen[i] = (out, pred.get_output(0).asnumpy())
    with tmx.cpu():
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for i, (out, mine) in seen.items():
        np.testing.assert_array_equal(out, mine)
        _close(out, direct[i:i + BATCH], f"thread {i}", rel=1e-5)


def test_symbol_block_export_and_var(jax_side, tmp_path):
    """SymbolBlock over the logits graph gives the JAX graph's logits
    (its Parameters under the graph's own names, their shapes inferred
    at the first call); a HybridBlock's export loads in the JAX package
    with arg:/aux: keys; Parameter.var gives the JAX variable."""
    j = jax_side
    args, aux = j["params"]
    with tmx.cpu():
        logits_sym = _sym(tmx).get_internals()["fc1_output"]
        block = tmx.gluon.SymbolBlock(logits_sym, tmx.sym.var("data"))
        assert sorted(block.collect_params()) == sorted(
            [n for n in logits_sym.list_arguments() if n != "data"] +
            logits_sym.list_auxiliary_states())
        block.collect_params().initialize(ctx=tmx.cpu())
        for name, p in block.collect_params().items():
            p.set_data(tmx.nd.array(args.get(name, aux.get(name))))
        got = block(tmx.nd.array(j["x"])).asnumpy()
    _close(got, j["logits"], "SymbolBlock")

    def net(mx):
        seq = mx.gluon.nn.HybridSequential(prefix="exp_")
        with seq.name_scope():
            seq.add(mx.gluon.nn.Dense(4, in_units=3))
            seq.add(mx.gluon.nn.BatchNorm(in_channels=4))
        seq.initialize(ctx=mx.cpu())
        return seq
    jnet = net(jmx)
    with tmx.cpu():
        tnet = net(tmx)
        for name, p in tnet.collect_params().items():
            p.set_data(tmx.nd.array(
                jnet.collect_params()[name].data().asnumpy()))
        tnet.export(str(tmp_path / "t"), 3)
    jnet.export(str(tmp_path / "j"), 3)
    tsaved = jmx.nd.load(str(tmp_path / "t-0003.params"))
    jsaved = jmx.nd.load(str(tmp_path / "j-0003.params"))
    assert sorted(tsaved) == sorted(jsaved)
    assert {k.split(":")[0] for k in tsaved} == {"arg", "aux"}
    for k in jsaved:
        np.testing.assert_array_equal(tsaved[k].asnumpy(),
                                      jsaved[k].asnumpy())
    jw = jnet.collect_params()["exp_dense0_weight"]
    with tmx.cpu():
        tw = tnet.collect_params()["exp_dense0_weight"]
    tw.lr_mult, jw.lr_mult = 2.0, 2.0
    assert tw.var() is tw.var()
    assert tw.var().name == jw.var().name
    assert tw.var().list_attr() == jw.var().list_attr()
    assert tmx.sym.FullyConnected(tmx.sym.var("data"), weight=tw.var(),
                                  num_hidden=4, no_bias=True,
                                  name="fcv").tojson() == \
        jmx.sym.FullyConnected(jmx.sym.var("data"), weight=jw.var(),
                               num_hidden=4, no_bias=True,
                               name="fcv").tojson()
