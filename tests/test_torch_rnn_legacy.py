"""The port's legacy ``mx.rnn`` against the JAX package's on the CPU: the
symbolic cells' graphs (argument and output listings, JSON) equal to
JAX's, their bound forwards equal to within 1e-5 of max;
``FusedRNNCell``'s ``parameters`` moved between the packages and to the
``unfuse()`` stack by ``unpack_weights`` / ``pack_weights`` (round trips
exact, fused == unfused within the port); ``encode_sentences`` and
``BucketSentenceIter``'s batches equal to JAX's; two ``BucketingModule``
steps with Adam from the same weights within 1e-5 of max; and a JAX
checkpoint of a cell graph loading into the port.  Every graph is built
under a fresh ``NameManager`` on each side, so the auto-named nodes
agree."""
import json
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
import chip_smoke

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


def _graph(mx, build):
    with mx.name.NameManager():
        outs, states = build(mx)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return mx.sym.Group(list(outs) + list(states))


def _lstm_stack(mx):
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(5, prefix="l0_"))
    stack.add(mx.rnn.DropoutCell(0.5, prefix="d0_"))
    stack.add(mx.rnn.GRUCell(4, prefix="l1_"))
    return stack


GRAPHS = {
    "rnn_cell": lambda mx: mx.rnn.RNNCell(6, prefix="r_").unroll(
        4, mx.sym.var("data"), begin_state=[mx.sym.var("h0")],
        merge_outputs=True),
    "lstm_cell_default_state": lambda mx: mx.rnn.LSTMCell(
        6, prefix="l_").unroll(4, mx.sym.var("data"), merge_outputs=True),
    "gru_cell_list": lambda mx: mx.rnn.GRUCell(5, prefix="g_").unroll(
        3, [mx.sym.var(f"x{i}") for i in range(3)],
        begin_state=[mx.sym.var("h0")]),
    "stack": lambda mx: _lstm_stack(mx).unroll(
        4, mx.sym.var("data"), merge_outputs=True),
    "bidirectional": lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(4, prefix="bl_"), mx.rnn.GRUCell(4, prefix="br_")
    ).unroll(3, mx.sym.var("data"), merge_outputs=True),
    "zoneout": lambda mx: mx.rnn.ZoneoutCell(
        mx.rnn.LSTMCell(4, prefix="z_"), zoneout_outputs=0.2,
        zoneout_states=0.1).unroll(3, mx.sym.var("data"),
                                   merge_outputs=True),
    "residual": lambda mx: mx.rnn.ResidualCell(
        mx.rnn.GRUCell(4, prefix="res_")).unroll(
        3, mx.sym.var("data"), merge_outputs=True),
    "fused_lstm_bi_states": lambda mx: mx.rnn.FusedRNNCell(
        5, num_layers=2, mode="lstm", bidirectional=True,
        get_next_state=True, prefix="f_").unroll(4, mx.sym.var("data")),
    "fused_gru_tnc_split": lambda mx: mx.rnn.FusedRNNCell(
        5, num_layers=1, mode="gru", prefix="fg_").unroll(
        4, mx.sym.var("data"), layout="TNC", merge_outputs=False),
    "fused_relu_dropout": lambda mx: mx.rnn.FusedRNNCell(
        5, num_layers=2, mode="rnn_relu", dropout=0.3, prefix="fr_").unroll(
        4, mx.sym.var("data"), merge_outputs=True),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cell_graph_matches_jax(name):
    jsym = _graph(jmx, GRAPHS[name])
    tsym = _graph(tmx, GRAPHS[name])
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())


def _feed(sym, shapes, seed):
    """Seeded arrays for every argument: ``shapes`` for the inputs, the
    port's inferred shapes for the rest."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: (0.5 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}


def _forward(mx, build, feed):
    sym = _graph(mx, build)
    with mx.cpu():
        ex = sym.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in feed.items()})
        return [o.asnumpy() for o in ex.forward(is_train=False)]


@pytest.mark.parametrize("name,shapes", [
    ("stack", {"data": (3, 4, 6)}),
    ("bidirectional", {"data": (3, 3, 5)}),
    ("fused_lstm_bi_states", {"data": (3, 4, 6)}),
    ("fused_gru_tnc_split", {"data": (4, 3, 6)}),
])
def test_cell_graph_forward_matches_jax(name, shapes):
    feed = _feed(_graph(tmx, GRAPHS[name]), shapes, seed=5)
    ref = _forward(jmx, GRAPHS[name], feed)
    got = _forward(tmx, GRAPHS[name], feed)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= REL


FUSED = [("lstm", False), ("gru", True), ("rnn_tanh", False)]


def _fused(mx, mode, bi, prefix="f_"):
    return mx.rnn.FusedRNNCell(5, num_layers=2, mode=mode, bidirectional=bi,
                               prefix=prefix)


@pytest.mark.parametrize("mode,bi", FUSED)
def test_fused_unpack_matches_jax_and_round_trips(mode, bi):
    """unpack_weights of the same flat vector gives JAX's per-layer arrays
    (JAX needs ``_input_size``; the port also infers it from the length),
    and pack_weights gives the vector back exactly."""
    size = tmx.ops.rnn.rnn_param_size(2, 3, 5, bi, mode)
    blob = np.random.RandomState(1).randn(size).astype(np.float32)
    jcell = _fused(jmx, mode, bi)
    jcell._input_size = 3
    with jmx.cpu():
        ref = jcell.unpack_weights({"f_parameters": jmx.nd.array(blob),
                                    "other": jmx.nd.array([1.0])})
    tcell = _fused(tmx, mode, bi)
    got = tcell.unpack_weights({"f_parameters": tmx.nd.array(
        blob, ctx=tmx.cpu()), "other": tmx.nd.array([1.0], ctx=tmx.cpu())})
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].asnumpy(), ref[k].asnumpy())
    packed = tcell.pack_weights(got)
    assert sorted(packed) == ["f_parameters", "other"]
    np.testing.assert_array_equal(packed["f_parameters"].asnumpy(), blob)
    with pytest.raises(tmx.MXNetError):
        tcell.unpack_weights({"f_parameters": tmx.nd.array(
            blob[:-1], ctx=tmx.cpu())})


@pytest.mark.parametrize("mode,bi", FUSED)
def test_fused_equals_unfused_and_crosses_packages(mode, bi):
    """Within the port, the fused cell's graph equals its unfuse() stack
    fed the unpacked weights; a JAX-fused graph fed the same flat
    vector gives the same outputs (the vector crossing JAX -> port), and
    the port's packed vector fed to JAX gives them too (port -> JAX)."""
    t, n, i = 4, 3, 3
    rs = np.random.RandomState(2)
    x = rs.randn(n, t, i).astype(np.float32)
    size = tmx.ops.rnn.rnn_param_size(2, i, 5, bi, mode)
    blob = (0.4 * rs.randn(size)).astype(np.float32)

    def fused_out(mx, vec):
        cell = _fused(mx, mode, bi)
        with mx.name.NameManager():
            out, _ = cell.unroll(t, mx.sym.var("data"), merge_outputs=True)
        with mx.cpu():
            ex = out.bind(mx.cpu(), {"data": mx.nd.array(x),
                                     "f_parameters": mx.nd.array(vec)})
            return ex.forward()[0].asnumpy()
    port = fused_out(tmx, blob)
    assert _rel(port, fused_out(jmx, blob)) <= REL
    cell = _fused(tmx, mode, bi)
    args = cell.unpack_weights({"f_parameters": tmx.nd.array(
        blob, ctx=tmx.cpu())})
    stack = cell.unfuse()
    with tmx.name.NameManager():
        out, _ = stack.unroll(t, tmx.sym.var("data"), merge_outputs=True)
    with tmx.cpu():
        feed = {"data": tmx.nd.array(x)}
        feed.update(args)
        unfused = out.bind(tmx.cpu(), feed).forward()[0].asnumpy()
    assert _rel(unfused, port) <= REL
    repacked = cell.pack_weights(args)["f_parameters"].asnumpy()
    assert _rel(fused_out(jmx, repacked), port) <= REL


def test_lstm_cell_gate_pack_round_trip():
    """The unfused cell's per-gate unpack / pack, equal to JAX's."""
    rs = np.random.RandomState(3)
    arrays = {"p_i2h_weight": rs.randn(12, 5), "p_i2h_bias": rs.randn(12),
              "p_h2h_weight": rs.randn(12, 3), "p_h2h_bias": rs.randn(12)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    with jmx.cpu():
        ref = jmx.rnn.LSTMCell(3, prefix="p_").unpack_weights(
            {k: jmx.nd.array(v) for k, v in arrays.items()})
    cell = tmx.rnn.LSTMCell(3, prefix="p_")
    got = cell.unpack_weights({k: tmx.nd.array(v, ctx=tmx.cpu())
                               for k, v in arrays.items()})
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].asnumpy(), ref[k].asnumpy())
    back = cell.pack_weights(got)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)


def _sentences(seed=4, n=120):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 30, rs.randint(1, 13)).tolist() for _ in range(n)]


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    batches = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        it = mx.rnn.BucketSentenceIter(_sentences(), 8, buckets=[4, 8, 12],
                                       invalid_label=-1, layout=layout)
        got = []
        for _ in range(2):          # the epoch, then again after reset
            for b in it:
                got.append((b.bucket_key, b.data[0].asnumpy(),
                            b.label[0].asnumpy(), b.provide_data[0].shape))
            it.reset()
        batches[name] = (got, it.default_bucket_key, it.ndiscard,
                         it.provide_data[0].shape)
    (got, *rest), (ref, *ref_rest) = batches["port"], batches["jax"]
    assert rest == ref_rest and len(got) == len(ref) > 4
    for (gk, gd, gl, gs), (rk, rd, rl, rsh) in zip(got, ref):
        assert (gk, gs) == (rk, rsh)
        np.testing.assert_array_equal(gd, rd)
        np.testing.assert_array_equal(gl, rl)


def test_bucket_sentence_iter_default_buckets_and_encode():
    words = [["a", "b"], ["b", "c", "a"], ["d"] * 5, ["a", "e"]] * 5
    ref, ref_vocab = jmx.rnn.encode_sentences(words, start_label=1)
    got, vocab = tmx.rnn.encode_sentences(words, start_label=1)
    assert (got, vocab) == (ref, ref_vocab)
    ref2, _ = jmx.rnn.encode_sentences([["a", "zzz"]], vocab=ref_vocab,
                                       unknown_token="a")
    got2, _ = tmx.rnn.encode_sentences([["a", "zzz"]], vocab=vocab,
                                       unknown_token="a")
    assert got2 == ref2
    it_j = jmx.rnn.BucketSentenceIter(ref, 4)
    it_t = tmx.rnn.BucketSentenceIter(got, 4)
    assert it_t.buckets == it_j.buckets
    assert it_t.idx == it_j.idx


BUCKET = dict(vocab=20, embed=6, hidden=5)
# Adam at its default learning rate (0.001).  Its update m / sqrt(v)
# amplifies the gradients' rounding (JAX's compiled step and torch sum in
# other orders) where m is small, in proportion to lr: the parameters
# are 2.4e-5 of max apart at lr 0.01 and 9e-5 at 0.05, while SGD at 0.01
# holds them within 1e-5 (the gradients agree that closely)
ADAM = {"learning_rate": 0.001}


def _bucketing_steps(mx, fused, arg_params, batches):
    """A BucketingModule over the bucketing example's sym_gen, Adam, two
    forward_backward + update steps on batches of different buckets: the
    outputs of each step and the parameters after them."""
    stack = chip_smoke.bucket_stack(mx, BUCKET["hidden"], 2, fused)
    with mx.cpu():
        mod = mx.mod.BucketingModule(
            chip_smoke.bucket_sym_gen(mx, stack, BUCKET["vocab"],
                                      BUCKET["embed"], BUCKET["hidden"]),
            default_bucket_key=8, context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4, 8))])
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in arg_params.items()})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params=dict(ADAM))
        outs = []
        for key, data, label in batches:
            batch = mx.io.DataBatch(
                [mx.nd.array(data)], [mx.nd.array(label)], bucket_key=key,
                provide_data=[mx.io.DataDesc("data", data.shape)],
                provide_label=[mx.io.DataDesc("softmax_label", label.shape)])
            mod.forward_backward(batch)
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        args, _ = mod.get_params()
        return outs, {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("fused", [False, True])
def test_bucketing_module_two_steps_match_jax(fused):
    rs = np.random.RandomState(6)
    h, e, v = BUCKET["hidden"], BUCKET["embed"], BUCKET["vocab"]
    params = {"embed_weight": rs.randn(v, e), "pred_weight": rs.randn(v, h),
              "pred_bias": rs.randn(v)}
    for i, width in enumerate((e, h)):
        params.update({f"lstm_l{i}_i2h_weight": rs.randn(4 * h, width),
                       f"lstm_l{i}_h2h_weight": rs.randn(4 * h, h),
                       f"lstm_l{i}_i2h_bias": rs.randn(4 * h),
                       f"lstm_l{i}_h2h_bias": rs.randn(4 * h)})
    params = {k: (0.3 * a).astype(np.float32) for k, a in params.items()}
    if fused:
        with tmx.cpu():
            packed = chip_smoke.bucket_stack(tmx, h, 2, True).pack_weights(
                {k: tmx.nd.array(a) for k, a in params.items()})
        params = {k: a.asnumpy() for k, a in packed.items()}
    batches = []
    for key in (8, 5):
        data = rs.randint(0, v, (4, key)).astype(np.float32)
        label = np.full(data.shape, -1.0, np.float32)
        label[:, :-2] = data[:, 1:-1]
        batches.append((key, data, label))
    ref_outs, ref = _bucketing_steps(jmx, fused, params, batches)
    got_outs, got = _bucketing_steps(tmx, fused, params, batches)
    for g, r in zip(got_outs, ref_outs):
        assert _rel(g, r) <= REL
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= REL, k


@pytest.mark.parametrize("name,shapes", [
    ("stack", {"data": (3, 4, 6)}),
    ("fused_lstm_bi_states", {"data": (3, 4, 6)})])
def test_checkpoint_of_a_cell_graph_crosses(tmp_path, name, shapes):
    """A checkpoint (symbol JSON + arg_params: the cells' weights, or a
    FusedRNNCell's flat ``parameters``) written by the JAX package loads
    into the port, binds and gives JAX's outputs; the port's checkpoint
    of the same graph holds the same JSON, and its arg_params bound to
    JAX's graph give them too (the JAX package cannot run a loaded graph
    whose SliceChannel feeds another op, its own checkpoints included)."""
    build = GRAPHS[name]
    feed = _feed(_graph(tmx, build), shapes, seed=8)
    ref = _forward(jmx, build, feed)
    files = {}
    for mx in (jmx, tmx):
        files[mx] = os.path.join(str(tmp_path), mx.__name__)
        with mx.cpu():
            args = {k: mx.nd.array(v) for k, v in feed.items()
                    if k != "data"}
            mx.model.save_checkpoint(files[mx], 3, _graph(mx, build), args,
                                     {})
    with open(files[jmx] + "-symbol.json") as f, \
            open(files[tmx] + "-symbol.json") as g:
        assert json.load(f) == json.load(g)
    with tmx.cpu():
        sym, arg_params, aux_params = tmx.model.load_checkpoint(files[jmx],
                                                                3)
        assert not aux_params
        values = dict(arg_params)
        values["data"] = tmx.nd.array(feed["data"])
        got = [o.asnumpy() for o in sym.bind(tmx.cpu(), values).forward()]
    for g, r in zip(got, ref):
        assert _rel(g, r) <= REL
    with jmx.cpu():
        loaded = jmx.nd.load(files[tmx] + "-0003.params")
    crossed = {k.split(":", 1)[1]: v.asnumpy() for k, v in loaded.items()}
    assert sorted(crossed) == sorted(k for k in feed if k != "data")
    for g, r in zip(_forward(jmx, build, dict(crossed, data=feed["data"])),
                    ref):
        np.testing.assert_array_equal(g, r)
