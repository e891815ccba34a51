"""The port's fused ``RNN`` op and the ops the recurrent cells call
(``SequenceMask`` / ``SequenceLast`` / ``SequenceReverse``, ``softmin``,
``SoftmaxActivation``) against the JAX package's on the CPU: the same
seeded numpy inputs through ``mx.nd`` of both packages under
``autograd.record``, the outputs and the gradients of every input within
1e-5 of each array's max |value|.  On the CPU the op takes its plain
composition (the cuDNN route runs only on the card: ``chip_smoke.py``
phase ``rnn_op``).  Also ``rnn_param_size`` exactly, ``mx.sym.RNN``'s
inferred shapes and bound forward, and a planted fault (the LSTM's gate
blocks read in another order) that the tolerance catches."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.rnn import rnn_param_size as jax_param_size
from incubator_mxnet_tpu_torch.ops import rnn as rnn_mod

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


def _run(mx, arrays, fn):
    """fn(*NDArrays) under record on the CPU, the sum of its outputs'
    squares' gradient taken: (outputs, gradients) as numpy."""
    with mx.cpu():
        nds = [mx.nd.array(a) for a in arrays]
        for a in nds:
            a.attach_grad()
        with mx.autograd.record():
            outs = fn(*nds)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            loss = sum((o * o).sum() for o in outs)
        loss.backward()
        return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in nds]


def _rnn_inputs(mode, t, n, i, h, layers, bi, seed):
    rs = np.random.RandomState(seed)
    d = 2 if bi else 1
    size = rnn_mod.rnn_param_size(layers, i, h, bi, mode)
    arrays = [rs.randn(t, n, i).astype(np.float32),
              (0.4 * rs.randn(size)).astype(np.float32),
              rs.randn(layers * d, n, h).astype(np.float32)]
    if mode == "lstm":
        arrays.append(rs.randn(layers * d, n, h).astype(np.float32))
    return arrays


CASES = [(mode, layers, bi)
         for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu")
         for layers, bi in ((1, False), (2, True))] + [("lstm", 2, False)]


@pytest.mark.parametrize("mode,layers,bi", CASES)
def test_rnn_op_matches_jax(mode, layers, bi):
    """Forward, final states (``state_outputs``) and the gradients of
    data, parameters and states, T=6, N=3, 5 -> 7; without
    ``state_outputs`` the op returns the same output alone."""
    arrays = _rnn_inputs(mode, 6, 3, 5, 7, layers, bi, seed=layers + 3 * bi)
    attrs = dict(state_size=7, num_layers=layers, mode=mode,
                 bidirectional=bi, state_outputs=True)
    ref = _run(jmx, arrays, lambda *a: jmx.nd.RNN(*a, **attrs))
    got = _run(tmx, arrays, lambda *a: tmx.nd.RNN(*a, **attrs))
    assert len(got[0]) == len(ref[0]) == (3 if mode == "lstm" else 2)
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        assert _rel(g, r) <= REL
    with tmx.cpu():
        alone = tmx.nd.RNN(*[tmx.nd.array(a) for a in arrays],
                           **dict(attrs, state_outputs=False))
    assert not isinstance(alone, (list, tuple))
    np.testing.assert_array_equal(alone.asnumpy(), got[0][0])


def test_rnn_op_dropout_train_and_eval():
    """Inter-layer dropout: in eval (no record) p changes nothing and
    equals JAX; in training it drops whole values of the second layer's
    input only (a 1-layer net is unchanged) and keeps the shapes."""
    arrays = _rnn_inputs("lstm", 4, 3, 5, 6, 2, False, seed=9)
    attrs = dict(state_size=6, num_layers=2, mode="lstm", p=0.5)
    with jmx.cpu():
        ref = jmx.nd.RNN(*[jmx.nd.array(a) for a in arrays],
                         **attrs).asnumpy()
    with tmx.cpu():
        nds = [tmx.nd.array(a) for a in arrays]
        got = tmx.nd.RNN(*nds, **attrs).asnumpy()
        plain = tmx.nd.RNN(*nds, **dict(attrs, p=0.0)).asnumpy()
        with tmx.autograd.record():
            train = tmx.nd.RNN(*nds, **attrs).asnumpy()
        one = _rnn_inputs("lstm", 4, 3, 5, 6, 1, False, seed=9)
        one_nds = [tmx.nd.array(a) for a in one]
        with tmx.autograd.record():
            one_train = tmx.nd.RNN(*one_nds, **dict(
                attrs, num_layers=1)).asnumpy()
        one_eval = tmx.nd.RNN(*one_nds, **dict(attrs,
                                                num_layers=1)).asnumpy()
    assert _rel(got, ref) <= REL
    np.testing.assert_array_equal(got, plain)
    assert train.shape == plain.shape and not np.allclose(train, plain)
    np.testing.assert_array_equal(one_train, one_eval)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_param_size_exact(mode):
    for layers in (1, 2, 3):
        for bi in (False, True):
            for i, h in ((1, 1), (5, 7), (650, 650), (200, 33)):
                assert rnn_mod.rnn_param_size(layers, i, h, bi, mode) == \
                    jax_param_size(layers, i, h, bi, mode)


def test_slice_rnn_weights_layout():
    """Views of the flat vector in the JAX layout: every element once, in
    order, for a tensor and a numpy array alike."""
    size = rnn_mod.rnn_param_size(2, 3, 4, True, "gru")
    flat = np.arange(size, dtype=np.float32)
    views = rnn_mod.slice_rnn_weights(flat, 2, 3, 4, True, "gru")
    weights = [v for layer in views for d in layer for v in d[:2]]
    biases = [v for layer in views for d in layer for v in d[2:]]
    np.testing.assert_array_equal(
        np.concatenate([v.reshape(-1) for v in weights + biases]), flat)
    import torch
    tviews = rnn_mod.slice_rnn_weights(torch.from_numpy(flat), 2, 3, 4,
                                       True, "gru")
    for a, b in zip([v for layer in tviews for d in layer for v in d],
                    [v for layer in views for d in layer for v in d]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert views[1][0][0].shape == (12, 8)


def test_planted_gate_order_fault_fails():
    """A port that read the LSTM's gates as [f, i, c, o] equals the true
    op on weights whose i and f blocks are swapped: that output is far
    outside the tolerance, so the parity tests would catch the fault."""
    arrays = _rnn_inputs("lstm", 6, 3, 5, 7, 1, False, seed=1)
    attrs = dict(state_size=7, num_layers=1, mode="lstm")
    ref = _run(jmx, arrays, lambda *a: jmx.nd.RNN(*a, **attrs))[0][0]
    h = 7
    swapped = arrays[1].copy()
    w = rnn_mod.slice_rnn_weights(swapped, 1, 5, h, False, "lstm")[0][0]
    for blob in w:
        blob[:h], blob[h:2 * h] = blob[h:2 * h].copy(), blob[:h].copy()
    faulty = _run(tmx, [arrays[0], swapped] + arrays[2:],
                  lambda *a: tmx.nd.RNN(*a, **attrs))[0][0]
    assert _rel(faulty, ref) > 100 * REL
    good = _run(tmx, arrays, lambda *a: tmx.nd.RNN(*a, **attrs))[0][0]
    assert _rel(good, ref) <= REL


def test_cudnn_calls_stay_zero_on_the_cpu():
    before = rnn_mod.cudnn_calls
    arrays = _rnn_inputs("gru", 3, 2, 4, 5, 1, False, seed=2)
    _run(tmx, arrays, lambda *a: tmx.nd.RNN(*a, state_size=5, num_layers=1,
                                            mode="gru"))
    assert rnn_mod.cudnn_calls == before


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True),
                                     ("rnn_relu", False)])
def test_sym_rnn_infers_and_binds(mode, bi):
    """mx.sym.RNN: the argument listing, the parameter and state shapes
    inferred from the data's, the output count, and a bound forward equal
    to JAX's."""
    t, n, i, h, layers = 4, 3, 5, 6, 2
    outs = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        data = mx.sym.var("data")
        net = mx.sym.RNN(data, state_size=h, num_layers=layers, mode=mode,
                         bidirectional=bi, state_outputs=True, name="rnn")
        arg_shapes, out_shapes, _ = net.infer_shape(data=(t, n, i))
        outs[name] = (net.list_arguments(), net.list_outputs(), arg_shapes,
                      out_shapes)
    assert outs["port"][:3] == outs["jax"][:3]
    assert [tuple(s) for s in outs["port"][3]] == \
        [tuple(s) for s in outs["jax"][3]]
    arrays = _rnn_inputs(mode, t, n, i, h, layers, bi, seed=4)
    names = outs["port"][0]
    got = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        data = mx.sym.var("data")
        net = mx.sym.RNN(data, state_size=h, num_layers=layers, mode=mode,
                         bidirectional=bi, state_outputs=True, name="rnn")
        with mx.cpu():
            ex = net.bind(mx.cpu(), {k: mx.nd.array(a)
                                     for k, a in zip(names, arrays)})
            got[name] = [o.asnumpy() for o in ex.forward()]
    for g, r in zip(got["port"], got["jax"]):
        assert _rel(g, r) <= REL


def _seq_inputs(seed, axis):
    rs = np.random.RandomState(seed)
    shape = (5, 3, 4) if axis == 0 else (3, 5, 4)
    return [rs.randn(*shape).astype(np.float32),
            np.array([2, 5, 1], np.float32)]


# SequenceReverse reverses with lengths on the time axis 0 only, as the
# JAX op does
@pytest.mark.parametrize("op,axis", [("SequenceMask", 0), ("SequenceMask", 1),
                                     ("SequenceLast", 0), ("SequenceLast", 1),
                                     ("SequenceReverse", 0)])
@pytest.mark.parametrize("use_len", [True, False])
def test_sequence_ops(op, use_len, axis):
    data, lengths = _seq_inputs(7, axis)
    kw = dict(use_sequence_length=use_len, axis=axis)
    if op == "SequenceMask":
        kw["value"] = -2.5

    def call(mx):
        def fn(x):
            ln = mx.nd.array(lengths)
            return getattr(mx.nd, op)(x, ln, **kw)
        return _run(mx, [data], fn)
    ref, got = call(jmx), call(tmx)
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        assert _rel(g, r) <= REL


@pytest.mark.parametrize("case", ["softmin", "softmin_temperature",
                                  "softmin_axis0", "softmax_instance",
                                  "softmax_channel"])
def test_softmin_and_softmax_activation(case):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 4).astype(np.float32)
    op, kw = {"softmin": ("softmin", {}),
              "softmin_temperature": ("softmin", {"temperature": 2.0}),
              "softmin_axis0": ("softmin", {"axis": 0}),
              "softmax_instance": ("SoftmaxActivation", {}),
              "softmax_channel": ("SoftmaxActivation",
                                  {"mode": "channel"})}[case]
    rng = np.random.RandomState(4).randn(2, 3, 4).astype(np.float32)

    def call(mx):
        # a weighted sum, so the softmax's gradient is not zero
        return _run(mx, [x], lambda a: getattr(mx.nd, op)(a, **kw)
                    * mx.nd.array(rng))
    ref, got = call(jmx), call(tmx)
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        assert _rel(g, r) <= REL
