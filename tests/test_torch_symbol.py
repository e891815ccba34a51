"""The port's symbolic API against the JAX package's, on the CPU: the
same graphs composed on both sides (explicit names, so no auto-naming
counter matters) must list the same arguments, outputs, auxiliary
states, internals and attributes (``AttrScope`` too), infer the same
shapes and types, evaluate to the same values (1e-5 of each array's max
|value|), and serialize to the same JSON string, in both directions (a
file written by either package loads in the other and writes back the
same string).  Each graph pass is held to the JAX pass: InferShape,
InferType and InferStorageType exactly, Gradient's gradients at 1e-5,
PlanMemory's argument and output bytes exactly, FuseBatchNormRelu's
count and its fused graph's outputs.  Shape inference never reaches a
kernel wrapper."""

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-5


# a gradient that is 0 in exact arithmetic (a conv bias feeding a
# BatchNorm) is rounding noise on both sides: held to this floor
ATOL_ZERO_GRAD = 1e-6


def _close(got, ref, what="", atol=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= REL * scale + atol, (what, err, scale)


def _full_shapes(graph):
    """The input shapes of ``graph`` with every parameter's: the JAX
    package has no shape rule for _FusedBNReluConv, so its infer_shape
    is given the shapes the port infers."""
    build, shapes = _GRAPHS[graph]
    if graph != "fused":
        return shapes
    sym = build(tmx)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return dict(zip(sym.list_arguments(), arg_shapes))


def _mlp(mx):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _convnet(mx):
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                           name="c1")
    h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = mx.sym.Activation(h, act_type="relu", name="r1")
    h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p1")
    h = mx.sym.Flatten(h, name="flat")
    h = mx.sym.FullyConnected(h, num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _fused(mx, impl=None):
    """An NHWC BN -> ReLU -> conv as _FusedBNReluConv (first output) then
    a 3x3 one: the op's moving statistics are arguments."""
    kw = {} if impl is None else {"impl": impl}
    data = mx.sym.var("data")
    h = mx.sym._FusedBNReluConv(data, kernel=(1, 1), num_filter=6,
                                layout="NHWC", eps=2e-5, name="f1",
                                no_bias=True, **kw)[0]
    h = mx.sym._FusedBNReluConv(h, kernel=(3, 3), pad=(1, 1), num_filter=4,
                                layout="NHWC", eps=2e-5, name="f2", **kw)[0]
    return h


def _misc(mx):
    """Multi-output, variadic and parameterised ops in one group."""
    a, b = mx.sym.var("a"), mx.sym.var("b")
    parts = mx.sym.SliceChannel(a, num_outputs=2, axis=1, name="split")
    cat = mx.sym.Concat(parts[1], parts[0], b, dim=1, name="cat")
    ln = mx.sym.LayerNorm(cat, name="ln")
    emb = mx.sym.Embedding(mx.sym.var("idx"), input_dim=7, output_dim=3,
                           name="emb")
    dec = mx.sym.Deconvolution(mx.sym.var("img"), kernel=(2, 2),
                               stride=(2, 2), num_filter=3, no_bias=True,
                               name="dec")
    mso = mx.sym.SoftmaxOutput(dec, multi_output=True, name="mso")
    return mx.sym.Group([ln, emb, mso, parts[1]])


_GRAPHS = {"mlp": (_mlp, dict(data=(4, 6))),
           "convnet": (_convnet, dict(data=(2, 3, 8, 8))),
           "fused": (_fused, dict(data=(2, 5, 5, 3))),
           "misc": (_misc, dict(a=(2, 4), b=(2, 3), idx=(2, 5),
                                img=(2, 2, 3, 3)))}


def _inputs(sym, shapes, seed=0):
    """Seeded arrays for every argument and aux state: integers below 7
    for ``idx`` and labels, positive for variances."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in list(zip(sym.list_arguments(), arg_shapes)) + \
            list(zip(sym.list_auxiliary_states(), aux_shapes)):
        if name == "idx" or name.endswith("label"):
            out[name] = rs.randint(0, 3, shape).astype("float32")
        elif name.endswith("var"):
            out[name] = (0.5 + rs.rand(*shape)).astype("float32")
        else:
            out[name] = rs.randn(*shape).astype("float32")
    return out


@pytest.mark.parametrize("graph", sorted(_GRAPHS))
def test_listing_and_infer(graph):
    build, shapes = _GRAPHS[graph]
    j, t = build(jmx), build(tmx)
    for what in ("list_arguments", "list_outputs", "list_auxiliary_states",
                 "list_inputs"):
        assert getattr(t, what)() == getattr(j, what)(), what
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    full = _full_shapes(graph)
    assert t.infer_shape(**shapes) == j.infer_shape(**full)
    assert t.infer_type(**shapes) == j.infer_type(**full)
    assert len(t) == len(j)
    if graph == "fused":
        with pytest.raises(Exception, match="cannot infer shape"):
            j.infer_shape(**shapes)


@pytest.mark.parametrize("graph", sorted(_GRAPHS))
def test_json_both_ways(graph, tmp_path):
    """The same graph serializes to the same string on both sides; a
    file written by either loads in the other and writes back the same
    string."""
    build, _ = _GRAPHS[graph]
    j, t = build(jmx), build(tmx)
    assert t.tojson() == j.tojson()
    path = str(tmp_path / "g-symbol.json")
    j.save(path)
    assert tmx.sym.load(path).tojson() == j.tojson()
    t.save(path)
    assert jmx.sym.load(path).tojson() == t.tojson()
    assert tmx.sym.load_json(t.tojson()).tojson() == t.tojson()


@pytest.mark.parametrize("graph", sorted(_GRAPHS))
def test_eval_and_simple_bind(graph):
    """bind + forward in train and eval mode (eval() for graphs without
    auxiliary states, which it cannot take), and simple_bind's arrays."""
    build, shapes = _GRAPHS[graph]
    j, t = build(jmx), build(tmx)
    vals = _inputs(t, shapes)
    outs = []
    for mx, sym, ctx in ((jmx, j, jmx.cpu()), (tmx, t, tmx.cpu())):
        args = {n: mx.nd.array(vals[n], ctx=ctx)
                for n in sym.list_arguments()}
        aux = {n: mx.nd.array(vals[n], ctx=ctx)
               for n in sym.list_auxiliary_states()}
        got = []
        for is_train in (True, False):
            ex = sym.bind(ctx, dict(args), aux_states=dict(aux),
                          grad_req="null")
            got += [o.asnumpy() for o in ex.forward(is_train=is_train)]
        if not aux:
            got += [o.asnumpy() for o in sym.eval(ctx=ctx, **args)]
        outs.append(got)
    assert len(outs[1]) == len(outs[0])
    for a, b in zip(outs[1], outs[0]):
        _close(a, b, graph)
    ex_t = t.simple_bind(tmx.cpu(), **shapes)
    ex_j = j.simple_bind(jmx.cpu(), **_full_shapes(graph))
    assert sorted(ex_t.grad_dict) == sorted(ex_j.grad_dict)
    assert {k: v.shape for k, v in ex_t.arg_dict.items()} == \
        {k: v.shape for k, v in ex_j.arg_dict.items()}


def test_arithmetic_getitem_and_fluent():
    def build(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        with mx.name.NameManager():
            outs = [a * b + 1, a - b, 2.0 / a, 3 - a, -a, a ** 2, a / b,
                    a == b, a != 1.0, a.exp(), a.sum(axis=1)]
        return mx.sym.Group(outs)
    j, t = build(jmx), build(tmx)
    assert t.list_outputs() == j.list_outputs()
    assert t.tojson() == j.tojson()
    rs = np.random.RandomState(1)
    av = rs.rand(2, 3).astype("float32") + 0.5
    bv = np.where(rs.rand(2, 3) > 0.5, av, av + 1).astype("float32")
    jo = j.eval(ctx=jmx.cpu(), a=jmx.nd.array(av), b=jmx.nd.array(bv))
    to = t.eval(ctx=tmx.cpu(), a=tmx.nd.array(av, ctx=tmx.cpu()),
                b=tmx.nd.array(bv, ctx=tmx.cpu()))
    for x, y in zip(to, jo):
        _close(x.asnumpy(), y.asnumpy())
    # __getitem__ by position and by name, internals by name
    for mx, g in ((jmx, j), (tmx, t)):
        assert g[0].name == g.list_outputs()[0].rsplit("_output", 1)[0]
    jc, tc = _convnet(jmx), _convnet(tmx)
    assert tc.get_internals()["fc_output"].name == \
        jc.get_internals()["fc_output"].name == "fc"
    assert tc["bn1"].list_arguments() == jc["bn1"].list_arguments()
    with pytest.raises(MXNetError):
        tc.get_internals()["nope_output"]


def test_attributes_and_attrscope():
    # a fresh name scope on each side: ``a + b`` is auto-named from the
    # package's process-global counter, which earlier tests in the same
    # worker may have advanced on one side only
    def build(mx):
        with mx.name.NameManager(), \
                mx.AttrScope(ctx_group="dev1", __mood__="calm"):
            a = mx.sym.var("a", lr_mult=2.0)
            with mx.AttrScope(ctx_group="dev2"):
                b = mx.sym.var("b", wd_mult=0.5, shape=(2, 3))
                c = mx.sym.FullyConnected(a + b, num_hidden=2, name="fc")
        return a, b, c
    (ja, jb, jc), (ta, tb, tc) = build(jmx), build(tmx)
    assert ta.list_attr() == ja.list_attr()
    assert tb.list_attr() == jb.list_attr()
    assert tc.attr_dict() == jc.attr_dict()
    assert tc.attr("ctx_group") == "dev2" and ta.attr("ctx_group") == "dev1"
    back = tmx.sym.load_json(jc.tojson())
    assert back.attr_dict() == jc.attr_dict()
    assert jmx.sym.load_json(tc.tojson()).attr_dict() == tc.attr_dict()


def test_sub_namespaces():
    with tmx.cpu():
        s = tmx.sym.random.uniform(low=0.0, high=1.0, shape=(50,))
        vals = s.simple_bind(tmx.cpu()).forward()[0].asnumpy()
    assert vals.shape == (50,) and (vals >= 0).all() and (vals <= 1).all()
    assert tmx.sym.zeros((2, 3)).eval(ctx=tmx.cpu())[0].shape == (2, 3)
    np.testing.assert_array_equal(
        tmx.sym.ones((2,)).eval(ctx=tmx.cpu())[0].asnumpy(), [1.0, 1.0])
    # sym.sparse lowers to dense ops, as the JAX namespace does
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    sq = [mx.sym.sparse.square_sum(mx.sym.var("a"), axis=1, name="ss")
          .eval(ctx=mx.cpu(), a=mx.nd.array(a, ctx=mx.cpu()))[0].asnumpy()
          for mx in (jmx, tmx)]
    np.testing.assert_array_equal(sq[1], sq[0])
    assert callable(tmx.sym.linalg.gemm2)
    with pytest.raises(AttributeError, match="no linalg op"):
        tmx.sym.linalg.not_a_linalg_op
    with pytest.raises(AttributeError):
        tmx.sym.not_an_op


# ------------------------------------------------------------------ passes
def test_infer_passes_equal_jax():
    for graph, (build, shapes) in _GRAPHS.items():
        stypes = {build(jmx).list_arguments()[-1]: "row_sparse"}
        names = ["InferShape", "InferType", "InferStorageType"]
        jg = jmx.sym.passes.apply_passes(build(jmx), names,
                                         shapes=_full_shapes(graph),
                                         stypes=stypes)
        tg = tmx.sym.passes.apply_passes(build(tmx), names, shapes=shapes,
                                         stypes=stypes)
        for key in ("arg_shapes", "out_shapes", "aux_shapes", "arg_types",
                    "aux_types", "out_types", "arg_stypes",
                    "dispatch_modes", "out_stypes"):
            assert tg.attrs[key] == jg.attrs[key], key
    with pytest.raises(MXNetError, match="InferShape first"):
        tmx.sym.passes.apply_pass(_mlp(tmx), "InferType")
    with pytest.raises(MXNetError, match="unknown graph pass"):
        tmx.sym.passes.apply_pass(_mlp(tmx), "FuseEverything")
    assert set(tmx.sym.passes.list_passes()) >= {
        "InferShape", "InferType", "InferStorageType", "Gradient",
        "PlanMemory", "FuseBatchNormRelu"}


def test_gradient_and_plan_memory_passes():
    build, shapes = _GRAPHS["convnet"]
    names = ["InferShape", "Gradient", "PlanMemory"]
    jg = jmx.sym.passes.apply_passes(build(jmx), names, shapes=shapes)
    tg = tmx.sym.passes.apply_passes(build(tmx), names, shapes=shapes)
    sym = build(tmx)
    vals = _inputs(sym, shapes, seed=2)
    arrays = [vals[n] for n in sym.list_arguments() +
              sym.list_auxiliary_states()]
    jouts, jgrads = jg.attrs["grad_fn"](arrays)
    touts, tgrads = tg.attrs["grad_fn"](arrays)
    for a, b in zip(touts, jouts):
        _close(a, np.asarray(b), "out")
    assert len(tgrads) == len(jgrads) == len(arrays)
    for name, a, b in zip(sym.list_arguments(), tgrads, jgrads):
        _close(a, np.asarray(b), name,
               ATOL_ZERO_GRAD if name == "c1_bias" else 0.0)
    assert tg.attrs["backward_op_count"] > 5
    # the arguments' and outputs' bytes, as the avals account them
    nbytes = 4 * sum(int(np.prod(s)) for s in
                     tg.attrs["arg_shapes"] + tg.attrs["aux_shapes"])
    assert tg.attrs["memory"]["argument_size"] == nbytes
    assert tg.attrs["memory"]["output_size"] == 4 * 2 * 5
    assert jg.attrs["memory"]["argument_size"] >= nbytes

    @tmx.sym.passes.register_pass("CountNodes")
    def _count(graph):
        graph.attrs["n_nodes"] = sum(1 for n in graph.symbol._topo()
                                     if not n.is_var)
    assert tmx.sym.passes.apply_pass(_mlp(tmx), "CountNodes").attrs[
        "n_nodes"] == 4


def _bn_relu_graph(mx):
    S = mx.sym
    data = S.var("data")
    c1 = S.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                       name="c1")
    bn1 = S.BatchNorm(c1, fix_gamma=False, name="bn1")
    a1 = S.Activation(bn1, act_type="relu", name="a1")      # fuses
    bn2 = S.BatchNorm(a1, fix_gamma=False, name="bn2")
    a2 = S.Activation(bn2, act_type="tanh", name="a2")      # not relu
    bn3 = S.BatchNorm(a2, fix_gamma=False, name="bn3")
    both = S.broadcast_add(bn3, S.Activation(bn3, act_type="relu",
                                             name="a3"), name="both")
    return S.FullyConnected(S.Flatten(both, name="flat"), num_hidden=3,
                            name="fc")


@pytest.mark.parametrize("is_train", [True, False])
def test_fuse_batchnorm_relu_pass(is_train):
    """One pair fuses on both sides; the fused graph's outputs, moving
    statistics (train) and JSON equal the JAX fused graph's."""
    jg = jmx.sym.passes.apply_pass(_bn_relu_graph(jmx), "FuseBatchNormRelu")
    tg = tmx.sym.passes.apply_pass(_bn_relu_graph(tmx), "FuseBatchNormRelu")
    assert tg.attrs["num_fused_bn_relu"] == jg.attrs["num_fused_bn_relu"] \
        == 1
    assert tg.symbol.tojson() == jg.symbol.tojson()
    assert tg.symbol.list_auxiliary_states() == \
        _bn_relu_graph(tmx).list_auxiliary_states()
    vals = _inputs(_bn_relu_graph(tmx), dict(data=(2, 3, 6, 6)), seed=4)
    res = []
    for mx, g, ctx in ((jmx, jg, jmx.cpu()), (tmx, tg, tmx.cpu())):
        sym = g.symbol
        aux = {n: mx.nd.array(vals[n], ctx=ctx)
               for n in sym.list_auxiliary_states()}
        ex = sym.bind(ctx, {n: mx.nd.array(vals[n], ctx=ctx)
                            for n in sym.list_arguments()}, aux_states=aux,
                      grad_req="null")
        out = ex.forward(is_train=is_train)[0].asnumpy()
        res.append((out, {k: v.asnumpy() for k, v in ex.aux_dict.items()}))
    (jo, ja), (to, ta) = res
    _close(to, jo, "out")
    for k in ja:
        _close(ta[k], ja[k], k)


def test_infer_shape_reaches_no_kernel(monkeypatch):
    """Shape inference of the fused ops runs their plain composition on
    meta tensors: the kernel wrappers are never called, and no launch is
    counted."""
    from incubator_mxnet_tpu_torch.ops import fused_conv

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")
    before = (fused_conv.sbr_matmul.launches, fused_conv.sbr_conv3x3.launches)
    monkeypatch.setattr(fused_conv, "sbr_matmul", refuse)
    monkeypatch.setattr(fused_conv, "sbr_conv3x3", refuse)
    sym = _fused(tmx)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=(32, 56, 56, 64))
    assert out_shapes == [(32, 56, 56, 4)]
    assert dict(zip(sym.list_arguments(), arg_shapes))["f2_weight"] == \
        (4, 6, 3, 3)
    tmx.sym.passes.apply_passes(sym, ["InferShape", "InferType",
                                      "PlanMemory"],
                                shapes=dict(data=(32, 56, 56, 64)))
    # on the CPU the op runs the wrapper's plain version, which the
    # patch refuses: the meta path above never got there
    with pytest.raises(AssertionError, match="kernel wrapper"):
        sym.eval(ctx=tmx.cpu(), **{k: tmx.nd.array(v, ctx=tmx.cpu())
                                   for k, v in _inputs(
                                       sym, dict(data=(1, 2, 2, 3))).items()})
    monkeypatch.undo()
    assert (fused_conv.sbr_matmul.launches,
            fused_conv.sbr_conv3x3.launches) == before
