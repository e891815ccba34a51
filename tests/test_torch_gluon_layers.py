"""The port's Gluon layers and losses against the JAX package's, on the
CPU: each layer built on both sides under the same prefix, the JAX
layer's parameters copied into the port's by full name, then the
forward and the gradients of the input and of every trainable parameter
under ``autograd.record`` in train and in eval mode, within 1e-5 of
each array's max |value|.  Also the parameter names of a nested net
(``collect_params`` with and without ``select``), the deferred shapes,
and ``save_params`` from each side loaded by the other, bit for bit."""
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-5


def _close(got, ref, what):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= REL * scale, (what, err, scale)


# name -> (builder(mx) -> layer, input shape, integer input)
def _layers():
    L = {}

    def add(name, build, shape, ints=False):
        L[name] = (build, shape, ints)

    add("dense_relu", lambda mx: mx.gluon.nn.Dense(5, activation="relu",
                                                   prefix="l_"), (3, 2, 4))
    add("dense_noflat", lambda mx: mx.gluon.nn.Dense(
        5, flatten=False, prefix="l_"), (3, 2, 4))
    add("dense_nobias", lambda mx: mx.gluon.nn.Dense(
        5, use_bias=False, in_units=8, prefix="l_"), (3, 8))
    add("batchnorm", lambda mx: mx.gluon.nn.BatchNorm(prefix="l_"),
        (3, 4, 3, 3))
    add("batchnorm_nhwc_noscale", lambda mx: mx.gluon.nn.BatchNorm(
        axis=3, scale=False, prefix="l_"), (3, 3, 3, 4))
    add("bnrelu", lambda mx: mx.gluon.nn.BNReLU(prefix="l_"), (3, 4, 3, 3))
    add("instancenorm", lambda mx: mx.gluon.nn.InstanceNorm(
        scale=True, prefix="l_"), (2, 4, 3, 3))
    add("layernorm", lambda mx: mx.gluon.nn.LayerNorm(prefix="l_"), (3, 6))
    add("embedding", lambda mx: mx.gluon.nn.Embedding(7, 3, prefix="l_"),
        (2, 5), True)
    add("flatten", lambda mx: mx.gluon.nn.Flatten(prefix="l_"), (2, 3, 4))
    add("hybridlambda", lambda mx: mx.gluon.nn.HybridLambda(
        "tanh", prefix="l_"), (2, 5))
    add("lambda", lambda mx: mx.gluon.nn.Lambda(
        lambda x: x * 2 + 1, prefix="l_"), (2, 5))
    for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
        add(f"activation_{act}", lambda mx, a=act: mx.gluon.nn.Activation(
            a, prefix="l_"), (2, 6))
    add("leakyrelu", lambda mx: mx.gluon.nn.LeakyReLU(0.1, prefix="l_"),
        (2, 6))
    add("prelu", lambda mx: mx.gluon.nn.PReLU(prefix="l_"), (2, 3, 4))
    add("elu", lambda mx: mx.gluon.nn.ELU(0.7, prefix="l_"), (2, 6))
    add("selu", lambda mx: mx.gluon.nn.SELU(prefix="l_"), (2, 6))
    add("swish", lambda mx: mx.gluon.nn.Swish(1.5, prefix="l_"), (2, 6))
    add("conv1d", lambda mx: mx.gluon.nn.Conv1D(4, 3, strides=2,
                                                prefix="l_"), (2, 3, 9))
    add("conv2d_act", lambda mx: mx.gluon.nn.Conv2D(
        5, 3, padding=1, groups=1, activation="relu", prefix="l_"),
        (2, 3, 6, 6))
    add("conv2d_nhwc", lambda mx: mx.gluon.nn.Conv2D(
        5, (3, 2), strides=(2, 1), padding=(1, 0), layout="NHWC",
        prefix="l_"), (2, 6, 6, 3))
    add("conv2d_grouped", lambda mx: mx.gluon.nn.Conv2D(
        6, 3, dilation=2, groups=2, prefix="l_"), (2, 4, 7, 7))
    add("conv3d", lambda mx: mx.gluon.nn.Conv3D(3, 2, prefix="l_"),
        (1, 2, 4, 4, 4))
    add("conv1d_transpose", lambda mx: mx.gluon.nn.Conv1DTranspose(
        4, 3, strides=2, prefix="l_"), (2, 3, 5))
    add("conv2d_transpose", lambda mx: mx.gluon.nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
        (2, 3, 4, 4))
    add("conv3d_transpose", lambda mx: mx.gluon.nn.Conv3DTranspose(
        2, 2, strides=2, prefix="l_"), (1, 2, 2, 3, 3))
    add("maxpool1d", lambda mx: mx.gluon.nn.MaxPool1D(3, 2, prefix="l_"),
        (2, 3, 9))
    add("maxpool2d_ceil", lambda mx: mx.gluon.nn.MaxPool2D(
        3, 2, ceil_mode=True, prefix="l_"), (2, 3, 8, 8))
    add("maxpool3d", lambda mx: mx.gluon.nn.MaxPool3D(prefix="l_"),
        (1, 2, 4, 4, 4))
    add("avgpool1d", lambda mx: mx.gluon.nn.AvgPool1D(prefix="l_"),
        (2, 3, 8))
    add("avgpool2d_nhwc", lambda mx: mx.gluon.nn.AvgPool2D(
        3, 2, 1, layout="NHWC", count_include_pad=False, prefix="l_"),
        (2, 7, 7, 3))
    add("avgpool3d", lambda mx: mx.gluon.nn.AvgPool3D(prefix="l_"),
        (1, 2, 4, 4, 4))
    for n, shape in ((1, (2, 3, 5)), (2, (2, 3, 4, 4)),
                     (3, (1, 2, 3, 3, 3))):
        for kind in ("Max", "Avg"):
            add(f"global{kind.lower()}pool{n}d",
                lambda mx, c=f"Global{kind}Pool{n}D": getattr(
                    mx.gluon.nn, c)(prefix="l_"), shape)
    add("reflectionpad2d", lambda mx: mx.gluon.nn.ReflectionPad2D(
        2, prefix="l_"), (2, 3, 5, 5))
    add("mxustem", lambda mx: mx.gluon.nn.MXUStemConv2D(
        8, 7, 2, 3, layout="NHWC", use_bias=False, prefix="l_"),
        (2, 16, 16, 3))
    add("fused_1x1", lambda mx: mx.gluon.nn.FusedBNReLUConv2D(
        6, 1, layout="NHWC", use_bias=True, prefix="l_"), (2, 5, 5, 4))
    add("fused_3x3", lambda mx: mx.gluon.nn.FusedBNReLUConv2D(
        6, 3, 1, 1, layout="NHWC", prefix="l_"), (2, 5, 6, 4))
    add("fused_strided_nchw", lambda mx: mx.gluon.nn.FusedBNReLUConv2D(
        6, 3, 2, 1, prefix="l_"), (2, 4, 7, 7))
    add("fused_chain", lambda mx: mx.gluon.nn.FusedBottleneckChain(
        4, 6, layout="NHWC", prefix="l_"), (2, 5, 5, 3))
    add("hybridsequential", lambda mx: _seq(mx, True), (2, 3, 6, 6))
    add("sequential", lambda mx: _seq(mx, False), (2, 3, 6, 6))
    return L


def _seq(mx, hybrid):
    nn = mx.gluon.nn
    net = (nn.HybridSequential if hybrid else nn.Sequential)(prefix="s_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten(),
                nn.Dense(3))
    return net


LAYERS = _layers()


def _inputs(shape, ints, seed):
    rs = np.random.RandomState(seed)
    if ints:
        return rs.randint(0, 7, shape).astype(np.float32)
    return (rs.randn(*shape) * 1.5 + 0.2).astype(np.float32)


def _build(mx, name, x):
    """The layer initialised, its deferred shapes resolved by one paused
    forward in predict mode."""
    build, _, _ = LAYERS[name]
    with mx.cpu():
        layer = build(mx)
        layer.initialize(mx.init.Uniform(0.5), ctx=mx.cpu())
        with mx.autograd.pause():
            layer(mx.nd.array(x))
    return layer


def _copy(src, dst, seed):
    """``src``'s values into ``dst`` by name; moving variances drawn
    positive (the same on both sides)."""
    rs = np.random.RandomState(seed)
    sp, dp = src.collect_params(), dst.collect_params()
    assert list(sp.keys()) == list(dp.keys())
    for name, p in sp.items():
        value = p.data().asnumpy()
        if name.endswith(("running_var", "moving_var")):
            value = (rs.rand(*value.shape) + 0.5).astype(np.float32)
            p.set_data(jmx.nd.array(value))
        with tmx.cpu():
            dp[name].set_data(tmx.nd.array(value))


def _forward_backward(mx, layer, x, train, ints):
    with mx.cpu():
        a = mx.nd.array(x)
        if not ints:
            a.attach_grad()
        with mx.autograd.record(train_mode=train):
            out = layer(a)
        head = np.random.RandomState(3).randn(*out.shape)
        out.backward(mx.nd.array(head.astype(np.float32)))
        grads = {n: p.grad().asnumpy()
                 for n, p in layer.collect_params().items()
                 if p.grad_req != "null"}
        stats = {n: p.data().asnumpy()
                 for n, p in layer.collect_params().items()
                 if p.grad_req == "null"}
        return (out.asnumpy(), None if ints else a.grad.asnumpy(), grads,
                stats)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name, train):
    _, shape, ints = LAYERS[name]
    x = _inputs(shape, ints, len(name))
    jl, tl = _build(jmx, name, x), _build(tmx, name, x)
    _copy(jl, tl, len(name) + 1)
    ref = _forward_backward(jmx, jl, x, train, ints)
    got = _forward_backward(tmx, tl, x, train, ints)
    _close(got[0], ref[0], "out")
    if not ints:
        _close(got[1], ref[1], "input grad")
    assert got[2].keys() == ref[2].keys()
    for n in ref[2]:
        if "conv2d" in n and n.endswith("bias") and name == "sequential":
            continue
        _close(got[2][n], ref[2][n], n)
    for n in ref[3]:        # the moving statistics after the forward
        _close(got[3][n], ref[3][n], n)


def test_dropout_layer_modes():
    """``nn.Dropout``: identity in predict mode, a scaled keep mask in
    train mode (the JAX layer's semantics; the mask's bits are the
    port's)."""
    x = np.ones((50, 40), np.float32)
    with tmx.cpu():
        layer = tmx.gluon.nn.Dropout(0.5)
        np.testing.assert_array_equal(layer(tmx.nd.array(x)).asnumpy(), x)
        with tmx.autograd.record():
            y = layer(tmx.nd.array(x)).asnumpy()
    assert set(np.unique(y)) <= {0.0, 2.0} and 0.4 < (y > 0).mean() < 0.6


def _nested(mx):
    nn = mx.gluon.nn

    class Block(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.conv = nn.Conv2D(4, 3, padding=1)
                self.body = nn.HybridSequential()
                with self.body.name_scope():
                    self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                                  nn.Conv2D(4, 1), nn.Dense(3),
                                  nn.Dense(2, use_bias=False))
                self.fused = nn.FusedBNReLUConv2D(
                    4, 3, 1, 1, bn_prefix="bnx_", conv_prefix="convx_")

        def hybrid_forward(self, F, x):
            return self.body(self.fused(self.conv(x)))

    return Block(prefix="net_")


def test_names_and_select_match_jax():
    jn, tn = _nested(jmx), _nested(tmx)
    assert tn.name == jn.name == "net"
    assert list(tn.collect_params().keys()) == \
        list(jn.collect_params().keys())
    for select in (".*weight", "net_hybridsequential0_dense",
                   ".*(gamma|beta)$", "net_fusedbnreluconv2d0_bnx_"):
        assert list(tn.collect_params(select).keys()) == \
            list(jn.collect_params(select).keys()), select
    assert [c.name for c in tn._children.values()] == \
        [c.name for c in jn._children.values()]
    # the children are torch submodules too
    assert len(list(tn.children())) == 3


def test_unnamed_blocks_count_per_scope():
    """Blocks without a prefix take ``<hint><count>_`` from the scope
    they are created in: each scope counts afresh, as in JAX."""
    def build(mx):
        outer = mx.gluon.nn.HybridSequential(prefix="o_")
        with outer.name_scope():
            a, b = mx.gluon.nn.Dense(2), mx.gluon.nn.Dense(2)
            inner = mx.gluon.nn.HybridSequential()
            with inner.name_scope():
                c = mx.gluon.nn.Dense(2)
        return [blk.prefix for blk in (a, b, inner, c)]
    assert build(tmx) == build(jmx) == \
        ["o_dense0_", "o_dense1_", "o_hybridsequential0_",
         "o_hybridsequential0_dense0_"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_params_load_params_bit_for_bit(direction, tmp_path):
    x = _inputs((2, 3, 6, 6), False, 4)
    nets = {}
    for side, mx in (("jax", jmx), ("port", tmx)):
        with mx.cpu():
            net = _nested(mx)
            net.initialize(mx.init.Normal(0.3), ctx=mx.cpu())
            with mx.autograd.pause():
                net(mx.nd.array(x))
        nets[side] = net
    src, dst = ("jax", "port") if direction == "jax_to_port" \
        else ("port", "jax")
    path = os.path.join(tmp_path, "net.params")
    nets[src].save_params(path)
    mx = tmx if dst == "port" else jmx
    with mx.cpu():
        nets[dst].load_params(path, ctx=mx.cpu())
    for name, p in nets[src].collect_params().items():
        np.testing.assert_array_equal(
            nets[dst].collect_params()[name].data().asnumpy(),
            p.data().asnumpy())
    # the full-name form (ParameterDict.save) loads the same way
    full = os.path.join(tmp_path, "full.params")
    nets[src].collect_params().save(full)
    with mx.cpu():
        nets[dst].collect_params().load(full, ctx=mx.cpu())
        nets[dst].load_params(full, ctx=mx.cpu())


def test_deferred_shapes_and_errors(tmp_path):
    with tmx.cpu():
        dense = tmx.gluon.nn.Dense(3, prefix="d_")
        dense.initialize()
        with pytest.raises(tmx.gluon.DeferredInitializationError):
            dense.weight.data()
        x = tmx.nd.ones((2, 5, 2))
        want = dense(x).asnumpy()
        assert dense.weight.shape == (3, 10)
        assert dense.weight.data().shape == (3, 10)
        # several contexts: the first is taken, as in the JAX package
        lists = []
        for m in (jmx, tmx):
            several = m.gluon.nn.Dense(2, in_units=2, prefix="several_")
            several.initialize(ctx=[m.cpu(1), m.cpu(0)])
            lists.append([c.device_id for c in several.weight.list_ctx()])
        assert lists[0] == lists[1] == [1]
        # export writes the params in the checkpoint format, which the
        # JAX package loads with its arg: keys
        dense.export(str(tmp_path / "d"))
        saved = jmx.nd.load(str(tmp_path / "d-0000.params"))
        assert sorted(saved) == ["arg:d_bias", "arg:d_weight"]
        np.testing.assert_array_equal(saved["arg:d_weight"].asnumpy(),
                                      dense.weight.data().asnumpy())
        # a SymbolBlock over the same graph gives the layer's outputs,
        # and the JAX graph's on the same weights
        def graph(mx):
            return mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=3,
                                         name="d")
        block = tmx.gluon.SymbolBlock(graph(tmx), tmx.sym.var("data"))
        block.collect_params().initialize(ctx=tmx.cpu())
        for name, p in block.collect_params().items():
            p.set_data(saved["arg:" + name].asnumpy())
        _close(block(x).asnumpy(), want, "SymbolBlock")
        ref = graph(jmx).eval(ctx=jmx.cpu(), data=jmx.nd.ones((2, 5, 2)),
                              **{k[4:]: v for k, v in saved.items()})
        _close(block(x).asnumpy(), ref[0].asnumpy(), "SymbolBlock vs JAX")
        with pytest.raises(TypeError):
            tmx.gluon.SymbolBlock(None, None)
        # Embedding(sparse_grad=True): the same lookup as the JAX layer,
        # its weight's gradient marked row_sparse
        ids = np.array([[3, 0], [1, 3]], np.float32)
        w = np.arange(8, dtype=np.float32).reshape(4, 2)
        outs = []
        for mx in (jmx, tmx):
            emb = mx.gluon.nn.Embedding(4, 2, sparse_grad=True,
                                        prefix="e_")
            emb.initialize(ctx=mx.cpu())
            emb.weight.set_data(mx.nd.array(w, ctx=mx.cpu()))
            assert emb.weight._grad_stype == "row_sparse"
            outs.append(emb(mx.nd.array(ids, ctx=mx.cpu())).asnumpy())
        np.testing.assert_array_equal(outs[1], outs[0])


def test_block_is_a_torch_module():
    """Children are submodules; ``.parameters()`` yields the initialised
    Parameters' tensors; ``.to(dtype)`` converts the Gluon parameters;
    hooks run and detach; ``hybridize`` changes no output."""
    with tmx.cpu():
        net = _seq(tmx, True)
        net.initialize(tmx.init.Xavier())
        x = tmx.nd.array(_inputs((2, 3, 6, 6), False, 5))
        ref = net(x).asnumpy()
        assert len(list(net.parameters())) == 7
        seen = []
        h = net.register_forward_hook(lambda b, a, o: seen.append(o.shape))
        net.hybridize()
        np.testing.assert_array_equal(net(x).asnumpy(), ref)
        h.detach()
        net(x)
        assert seen == [(2, 3)] and net._active
        net.to(dtype=tmx.base.torch_dtype("float64"))
        assert net.collect_params()["s_dense0_weight"].data().dtype == \
            np.float64


# ------------------------------------------------------------- losses
def _losses():
    L = {}
    L["l2"] = (lambda g: g.L2Loss(), "reg")
    L["l1_weighted"] = (lambda g: g.L1Loss(weight=0.5), "reg")
    L["sigmoid_bce"] = (lambda g: g.SigmoidBinaryCrossEntropyLoss(), "bin")
    L["sigmoid_bce_from_sigmoid"] = (
        lambda g: g.SigmoidBCELoss(from_sigmoid=True), "prob")
    L["softmax_ce"] = (lambda g: g.SoftmaxCrossEntropyLoss(), "cls")
    L["softmax_ce_dense"] = (lambda g: g.SoftmaxCELoss(sparse_label=False),
                             "dist")
    L["softmax_ce_from_logits"] = (
        lambda g: g.SoftmaxCELoss(from_logits=True), "logp")
    L["kldiv"] = (lambda g: g.KLDivLoss(), "kl")
    L["kldiv_logits"] = (lambda g: g.KLDivLoss(from_logits=False), "dist")
    L["huber"] = (lambda g: g.HuberLoss(rho=0.5), "reg")
    L["hinge"] = (lambda g: g.HingeLoss(), "sign")
    L["squared_hinge"] = (lambda g: g.SquaredHingeLoss(margin=2), "sign")
    L["logistic"] = (lambda g: g.LogisticLoss(), "sign")
    L["logistic_binary"] = (lambda g: g.LogisticLoss(label_format="binary"),
                            "bin")
    L["triplet"] = (lambda g: g.TripletLoss(margin=0.5), "triplet")
    return L


LOSSES = _losses()


def _loss_inputs(kind, rs):
    pred = rs.randn(4, 5).astype(np.float32)
    if kind == "cls":
        return [pred, rs.randint(0, 5, 4).astype(np.float32)]
    if kind == "dist":
        p = rs.rand(4, 5).astype(np.float32)
        return [pred, p / p.sum(1, keepdims=True)]
    if kind == "logp":
        return [pred - np.log(np.exp(pred).sum(1, keepdims=True)),
                rs.randint(0, 5, 4).astype(np.float32)]
    if kind == "kl":
        p = rs.rand(4, 5).astype(np.float32)
        return [np.log(p / p.sum(1, keepdims=True)),
                rs.dirichlet(np.ones(5), 4).astype(np.float32)]
    if kind == "prob":
        return [rs.uniform(0.05, 0.95, (4, 5)).astype(np.float32),
                rs.randint(0, 2, (4, 5)).astype(np.float32)]
    if kind == "bin":
        return [pred, rs.randint(0, 2, (4, 5)).astype(np.float32)]
    if kind == "sign":
        return [pred, (rs.randint(0, 2, (4, 5)) * 2 - 1).astype(np.float32)]
    if kind == "triplet":
        return [pred, rs.randn(4, 5).astype(np.float32),
                rs.randn(4, 5).astype(np.float32)]
    return [pred, rs.randn(4, 5).astype(np.float32)]


def _loss_run(mx, name, inputs, weight):
    build, _ = LOSSES[name]
    with mx.cpu():
        loss = build(mx.gluon.loss)
        arrays = [mx.nd.array(a) for a in inputs]
        arrays[0].attach_grad()
        extra = [mx.nd.array(weight)] if weight is not None else []
        with mx.autograd.record():
            out = loss(*arrays, *extra)
        out.backward()
        return out.asnumpy(), arrays[0].grad.asnumpy()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name, weighted):
    rs = np.random.RandomState(len(name))
    inputs = _loss_inputs(LOSSES[name][1], rs)
    weight = rs.rand(4, 1).astype(np.float32) if weighted else None
    ref = _loss_run(jmx, name, inputs, weight)
    got = _loss_run(tmx, name, inputs, weight)
    _close(got[0], ref[0], "loss")
    _close(got[1], ref[1], "grad")


@pytest.mark.parametrize("where", ["parameter", "dict", "reset_ctx",
                                   "deferred"])
def test_several_contexts_take_the_first(where):
    """``initialize(ctx=[a, b])`` (a Parameter, a ParameterDict, a
    deferred shape) and ``reset_ctx([a, b])`` place the value on the
    first context, as the JAX package's ``initialize`` does (its
    ``reset_ctx`` takes one context); ``list_ctx`` names it, and the
    values equal JAX's from the same seed."""
    def run(m):
        m.random.seed(4)
        net = m.gluon.nn.Dense(3, in_units=0 if where == "deferred" else 4,
                               prefix="ctxs_")
        ctxs = [m.cpu(1), m.cpu(0)]
        if where == "parameter":
            for p in net.collect_params().values():
                p.initialize(ctx=ctxs)
        elif where == "reset_ctx":
            # the JAX reset_ctx takes one context (a list raises there)
            net.initialize(ctx=m.cpu(0))
            net.collect_params().reset_ctx(ctxs if m is tmx else ctxs[0])
        else:
            net.collect_params().initialize(ctx=ctxs)
        if where == "deferred":
            assert [c.device_id for c in net.weight.list_ctx()] == [1]
            net(m.nd.ones((2, 4), ctx=m.cpu(1)))
        return ({n: [c.device_id for c in p.list_ctx()]
                 for n, p in net.collect_params().items()},
                {n: p.data().asnumpy()
                 for n, p in net.collect_params().items()})
    jctx, jvals = run(jmx)
    with tmx.cpu():
        tctx, tvals = run(tmx)
    assert tctx == jctx == {"ctxs_weight": [1], "ctxs_bias": [1]}
    for n in jvals:
        np.testing.assert_allclose(tvals[n], jvals[n], rtol=0, atol=1e-6)
