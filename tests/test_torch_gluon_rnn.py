"""The port's ``gluon.rnn`` (the fused RNN / LSTM / GRU layers and the
eleven cells) and ``gluon.contrib.rnn`` (VariationalDropoutCell, the nine
convolutional cells) against the JAX package's on the CPU: each block
built on both sides under the same prefix, the JAX block's parameters
(Xavier, drawn by JAX) copied into the port's by full name, then the
outputs, the final states and the gradients of the input and of every
parameter under ``autograd.record(train_mode=False)`` (dropout and
zoneout are the identity there, so both sides compute the same
function) within 1e-5 of each array's max |value|.  Also the fused LSTM
against the port's own unfused LSTMCell stack, and the parameters
crossing between the packages through ``ParameterDict.save`` / ``load``
in both directions."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

REL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_names():
    """The port's auto-named symbols and blocks count in its process-global
    NameManager (the conftest resets only the JAX package's): each test
    here names in a fresh one, so later test files see the counters as
    they were."""
    with tmx.name.NameManager():
        yield


def _rel(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _grad_run(mx, net, run, arrays, grads):
    """run(mx, net, NDArrays) recorded in eval mode: its outputs, then
    (with ``grads``) the gradients of the first input and of every
    parameter (by sorted name) of the sum of the outputs' squares, as
    numpy."""
    with mx.cpu():
        nds = [mx.nd.array(a) for a in arrays]
        if not grads:
            return [o.asnumpy() for o in _flat(run(mx, net, nds))]
        nds[0].attach_grad()
        with mx.autograd.record(train_mode=False):
            outs = _flat(run(mx, net, nds))
            loss = sum((o * o).sum() for o in outs)
        loss.backward()
        params = net.collect_params()
        return ([o.asnumpy() for o in outs] + [nds[0].grad.asnumpy()]
                + [params[k].grad().asnumpy() for k in sorted(params)])


def _compare(build, run, arrays, grads=True):
    """Build on both sides, fix deferred shapes with one forward, copy the
    JAX parameters into the port's by name, compare the runs (JAX
    compiles each op at its shapes, so the tests share widths and take
    gradients where the cell's arithmetic first appears)."""
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    with jmx.cpu():
        run(jmx, jnet, [jmx.nd.array(a) for a in arrays])
    tnet = build(tmx)
    with tmx.cpu():
        tnet.initialize(tmx.init.Xavier())
        run(tmx, tnet, [tmx.nd.array(a) for a in arrays])
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert sorted(jparams) == sorted(tparams)
    for name, p in tparams.items():
        assert tuple(p.shape) == tuple(jparams[name].shape), name
        p.set_data(tmx.nd.array(jparams[name].data().asnumpy(),
                                ctx=tmx.cpu()))
    ref = _grad_run(jmx, jnet, run, arrays, grads)
    got = _grad_run(tmx, tnet, run, arrays, grads)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g, r) <= REL, i
    return tnet


def _seq(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ----------------------------------------------------------- fused layers
# name -> (builder, layout, begin states given); the op's every mode is
# held to JAX's in test_torch_rnn_ops.py, these hold the layers' names,
# flat vector, layouts and states
LAYERS = {
    "lstm_2l_bi": (lambda mx: mx.gluon.rnn.LSTM(
        6, num_layers=2, bidirectional=True, prefix="r_"), "TNC", True),
    "gru_bi_ntc": (lambda mx: mx.gluon.rnn.GRU(
        4, bidirectional=True, layout="NTC", prefix="r_"), "NTC", True),
    "rnn_relu_2l_input_size": (lambda mx: mx.gluon.rnn.RNN(
        6, num_layers=2, input_size=4, prefix="r_"), "TNC", False),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fused_layer_matches_jax(name):
    """Outputs (and final states, when begin states are given) and the
    gradients of the input and of every parameter."""
    build, layout, with_states = LAYERS[name]
    shape = (5, 3, 4) if layout == "TNC" else (3, 5, 4)

    def run(mx, net, nds):
        if not with_states:
            return net(nds[0])
        states = net.begin_state(batch_size=3, ctx=mx.cpu())
        states = [s + 0.5 for s in states]
        return net(nds[0], states)
    _compare(build, run, [_seq(shape)])


def test_fused_layer_names_and_deferred_shape():
    with tmx.cpu():
        net = tmx.gluon.rnn.LSTM(6, num_layers=2, bidirectional=True,
                                 prefix="r_")
        net.initialize()
        assert net.l0_i2h_weight.shape[1] == 0
        net(tmx.nd.zeros((5, 3, 4)))
    assert sorted(net.collect_params()) == sorted(
        f"r_{d}{i}_{g}_{t}" for d in "lr" for i in range(2)
        for g in ("i2h", "h2h") for t in ("weight", "bias"))
    assert net.l0_i2h_weight.shape == (24, 4)
    assert net.l1_i2h_weight.shape == (24, 12)
    assert net.r1_h2h_weight.shape == (24, 6)


# ----------------------------------------------------------- cells
def _stack(mx, kinds, prefix="s_"):
    stack = mx.gluon.rnn.SequentialRNNCell(prefix=prefix)
    with stack.name_scope():
        for kind in kinds:
            stack.add(kind(mx))
    return stack


# every cell 4 wide over inputs 4 wide
CELLS = {
    "rnn": lambda mx: mx.gluon.rnn.RNNCell(4, prefix="c_"),
    "rnn_relu": lambda mx: mx.gluon.rnn.RNNCell(4, activation="relu",
                                                prefix="c_"),
    "lstm": lambda mx: mx.gluon.rnn.LSTMCell(4, prefix="c_"),
    "gru": lambda mx: mx.gluon.rnn.GRUCell(4, prefix="c_"),
    "sequential": lambda mx: _stack(mx, [
        lambda m: m.gluon.rnn.LSTMCell(4),
        lambda m: m.gluon.rnn.DropoutCell(0.5),
        lambda m: m.gluon.rnn.GRUCell(4)]),
    "zoneout": lambda mx: mx.gluon.rnn.ZoneoutCell(
        mx.gluon.rnn.LSTMCell(4, prefix="c_"), zoneout_outputs=0.3,
        zoneout_states=0.2),
    "residual": lambda mx: mx.gluon.rnn.ResidualCell(
        mx.gluon.rnn.GRUCell(4, prefix="c_")),
    "bidirectional": lambda mx: mx.gluon.rnn.BidirectionalCell(
        mx.gluon.rnn.LSTMCell(4, prefix="l_"),
        mx.gluon.rnn.GRUCell(4, prefix="r_")),
    "variational": lambda mx: mx.gluon.contrib.rnn.VariationalDropoutCell(
        mx.gluon.rnn.LSTMCell(4, prefix="c_"), drop_inputs=0.3,
        drop_states=0.2, drop_outputs=0.1),
}
UNROLLS = [(name, mode) for name in sorted(CELLS)
           for mode in ("merge", "valid_length")] + [
    ("lstm", "list_tnc"), ("bidirectional", "list_tnc")]


@pytest.mark.parametrize("name,mode", UNROLLS)
def test_cell_unroll_matches_jax(name, mode):
    """unroll over 5 steps (input width 4, batch 3): merged NTC outputs
    with the gradients, per-step TNC outputs, or merged with
    per-sequence valid lengths (masked outputs, the states at each
    sequence's last step)."""
    layout = "TNC" if mode == "list_tnc" else "NTC"
    shape = (5, 3, 4) if layout == "TNC" else (3, 5, 4)
    arrays = [_seq(shape, 1)]
    if mode == "valid_length":
        arrays.append(np.array([2, 5, 3], np.float32))

    def run(mx, net, nds):
        kw = {}
        if mode == "valid_length":
            kw["valid_length"] = nds[1]
        return net.unroll(5, nds[0], layout=layout,
                          merge_outputs=mode != "list_tnc", **kw)
    _compare(CELLS[name], run, arrays, grads=mode == "merge")


def test_cell_step_and_begin_state():
    """One step called directly, with begin_state's zeros: outputs and
    states equal JAX's."""
    def run(mx, net, nds):
        states = net.begin_state(batch_size=3, ctx=mx.cpu())
        out, states = net(nds[0], states)
        return [out] + states
    _compare(CELLS["lstm"], run, [_seq((3, 4), 2)])


CONV_CELLS = [(mode, dims) for mode in ("RNN", "LSTM", "GRU")
              for dims in (1, 2, 3)]


@pytest.mark.parametrize("mode,dims", CONV_CELLS)
def test_conv_cell_matches_jax(mode, dims):
    """Conv{1,2,3}D{RNN,LSTM,GRU}Cell unrolled 3 steps: 2 input channels
    of side 5, 3 hidden channels, i2h 3 (pad 1), h2h 3; the outputs (the
    convolutions' gradients are the nn tests')."""
    spatial = (5,) * dims
    build = lambda mx: getattr(  # noqa: E731
        mx.gluon.contrib.rnn, f"Conv{dims}D{mode}Cell")(
        (2,) + spatial, 3, 3, 3, i2h_pad=1, prefix="cc_")

    def run(mx, net, nds):
        return net.unroll(3, nds[0], layout="NTC", merge_outputs=True)
    _compare(build, run, [_seq((2, 3, 2) + spatial, 3)], grads=False)


# ----------------------------------------------------------- fused vs cells
def test_fused_lstm_equals_unfused_cells():
    """Within the port: the fused 2-layer LSTM and a SequentialRNNCell of
    two LSTMCells holding the same weights give the same outputs and
    final states."""
    x = _seq((6, 3, 4), 4)
    with tmx.cpu():
        fused = tmx.gluon.rnn.LSTM(5, num_layers=2, prefix="f_")
        fused.initialize(tmx.init.Xavier())
        cells = tmx.gluon.rnn.SequentialRNNCell(prefix="u_")
        for i in range(2):
            cells.add(tmx.gluon.rnn.LSTMCell(5, prefix=f"u_l{i}_"))
        cells.initialize()
        xs = tmx.nd.array(x)
        states = fused.begin_state(batch_size=3, ctx=tmx.cpu())
        out_f, st_f = fused(xs, states)
        cp = cells.collect_params()
        for name, p in fused.collect_params().items():
            cp["u_" + name[len("f_"):]].set_data(p.data())
        out_c, st_c = cells.unroll(6, xs, layout="TNC", merge_outputs=True)
    assert _rel(out_c.asnumpy(), out_f.asnumpy()) <= REL
    h_c = np.stack([st_c[0].asnumpy(), st_c[2].asnumpy()])
    c_c = np.stack([st_c[1].asnumpy(), st_c[3].asnumpy()])
    assert _rel(h_c, st_f[0].asnumpy()) <= REL
    assert _rel(c_c, st_f[1].asnumpy()) <= REL


# ----------------------------------------------------------- weights across
CROSSING = {
    "lstm_layer": (lambda mx: mx.gluon.rnn.LSTM(
        5, num_layers=2, bidirectional=True, prefix="x_"),
        lambda net, x: net(x)),
    "cell_stack": (CELLS["sequential"],
                   lambda net, x: net.unroll(5, x, layout="TNC",
                                             merge_outputs=True)[0]),
}


@pytest.mark.parametrize("name", sorted(CROSSING))
def test_parameters_cross_both_ways(tmp_path, name):
    """A JAX LSTM layer's or cell stack's ParameterDict.save loads into
    the port bit for bit, and the port's save (of other values) loads
    into JAX, which then gives the port's outputs."""
    build, run = CROSSING[name]
    x = _seq((5, 3, 4), 5)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    with jmx.cpu():
        run(jnet, jmx.nd.array(x))
    jfile = str(tmp_path / "jax.params")
    jnet.collect_params().save(jfile)
    with tmx.cpu():
        tnet = build(tmx)
        tnet.collect_params().load(jfile, ctx=tmx.cpu())
        for pname, p in tnet.collect_params().items():
            np.testing.assert_array_equal(
                p.data().asnumpy(),
                jnet.collect_params()[pname].data().asnumpy())
            p.set_data(p.data() * 2)
        tfile = str(tmp_path / "port.params")
        tnet.collect_params().save(tfile)
        out = run(tnet, tmx.nd.array(x)).asnumpy()
    jnet.collect_params().load(tfile, ctx=jmx.cpu())
    with jmx.cpu():
        ref = run(jnet, jmx.nd.array(x)).asnumpy()
    assert _rel(out, ref) <= REL
