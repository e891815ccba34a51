"""The port's optimizers and update ops against the JAX package's on the
CPU: the same seeded numpy weights and gradient sequences through each
side, the weights (and states) after several steps within 1e-6 of each
array's max |value|.  ``mx.optimizer.create`` resolves every name the
JAX package registers; SGLD, whose noise comes from each package's own
generator, is held by its moments; a sparse gradient raises."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.optimizer import _REG as JAX_REGISTRY
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_names():
    """The port's auto-named symbols and blocks count in its process-global
    NameManager (the conftest resets only the JAX package's): each test
    here names in a fresh one, so later test files see the counters as
    they were."""
    with tmx.name.NameManager():
        yield


STEPS = 4
SHAPE = (5, 7)


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _grads(seed, n=STEPS, shape=SHAPE):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _weight(seed, shape=SHAPE):
    return np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)


# name -> the updates' keyword attributes and the states' count
UPDATE_OPS = {
    "adam_update": (dict(lr=0.05, beta1=0.8, beta2=0.99, epsilon=1e-6,
                         wd=0.01, rescale_grad=0.5, clip_gradient=1.2), 2),
    "rmsprop_update": (dict(lr=0.05, gamma1=0.9, epsilon=1e-6, wd=0.01,
                            rescale_grad=0.5, clip_gradient=1.2,
                            clip_weights=0.9), 1),
    "rmspropalex_update": (dict(lr=0.05, gamma1=0.9, gamma2=0.8,
                                epsilon=1e-6, wd=0.01, rescale_grad=0.5,
                                clip_gradient=1.2, clip_weights=0.9), 3),
    "ftrl_update": (dict(lr=0.1, lamda1=0.05, beta=1.5, wd=0.01,
                         rescale_grad=0.5, clip_gradient=1.2), 2),
    "signsgd_update": (dict(lr=0.05, wd=0.01, rescale_grad=0.5,
                            clip_gradient=1.2), 0),
    "signum_update": (dict(lr=0.05, momentum=0.8, wd=0.01, rescale_grad=0.5,
                           clip_gradient=1.2, wd_lh=0.02), 1),
    "adagrad_update": (dict(lr=0.05, epsilon=1e-6, wd=0.01,
                            rescale_grad=0.5, clip_gradient=1.2), 1),
    "adadelta_update": (dict(rho=0.8, epsilon=1e-4, wd=0.01,
                             rescale_grad=0.5, clip_gradient=1.2), 2),
    "ftml_update": (dict(lr=0.05, beta1=0.6, beta2=0.99, epsilon=1e-6,
                         wd=0.01, rescale_grad=0.5, clip_grad=1.2), 3),
}


def _op_steps(mx, name, attrs, n_states, seed):
    """STEPS calls of ``nd.<name>`` with ``out=`` the weight and states
    (FTML's count ``t`` advancing): every array after them."""
    with mx.cpu():
        w = mx.nd.array(_weight(seed))
        states = [mx.nd.zeros(SHAPE) for _ in range(n_states)]
        for t, g in enumerate(_grads(seed), 1):
            kw = dict(attrs, t=t) if name == "ftml_update" else attrs
            getattr(mx.nd, name)(w, mx.nd.array(g), *states,
                                 out=[w] + states, **kw)
        return [a.asnumpy() for a in [w] + states]


@pytest.mark.parametrize("name", sorted(UPDATE_OPS))
def test_update_op_matches_jax(name):
    attrs, n_states = UPDATE_OPS[name]
    ref = _op_steps(jmx, name, attrs, n_states, seed=1)
    got = _op_steps(tmx, name, attrs, n_states, seed=1)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= REL


def test_update_op_leaves_its_inputs_without_out():
    with tmx.cpu():
        w, g = tmx.nd.array(_weight(2)), tmx.nd.array(_grads(2)[0])
        m, v = tmx.nd.zeros(SHAPE), tmx.nd.zeros(SHAPE)
        before = w.asnumpy().copy()
        nw, nm, nv = tmx.nd.adam_update(w, g, m, v, lr=0.1)
    np.testing.assert_array_equal(w.asnumpy(), before)
    assert float(np.abs(m.asnumpy()).max()) == 0.0
    assert not np.array_equal(nw.asnumpy(), before)
    assert float(np.abs(nm.asnumpy()).max()) > 0


def test_create_resolves_every_jax_name():
    names = sorted(JAX_REGISTRY.names())
    assert len(names) == 16
    for name in names:
        got = type(tmx.optimizer.create(name)).__name__
        assert got == type(jmx.optimizer.create(name)).__name__, name


# (name, constructor keywords): every optimizer class of the JAX file,
# in more than one configuration where its update branches
CONFIGS = [
    ("sgd", dict(momentum=0.9)), ("sgd", {}), ("ccsgd", dict(momentum=0.5)),
    ("signum", {}), ("signum", dict(momentum=0.0)),
    ("nag", dict(momentum=0.9)), ("nag", {}),
    ("dcasgd", dict(momentum=0.9)), ("dcasgd", dict(lamda=0.1)),
    ("adam", {}), ("adam", dict(beta1=0.7, epsilon=1e-6)),
    ("adagrad", dict(eps=1e-6)),
    ("rmsprop", {}), ("rmsprop", dict(centered=True, clip_weights=0.9)),
    ("ftrl", {}), ("ftrl", dict(lamda1=0.2, beta=2.0)),
    ("adamax", {}), ("nadam", {}), ("nadam", dict(schedule_decay=0.01)),
    ("lbsgd", dict(momentum=0.9, batch_scale=4, warmup_epochs=1,
                   updates_per_epoch=2)),
    ("lbsgd", dict(warmup_strategy="sqrt", batch_scale=3, warmup_epochs=2,
                   updates_per_epoch=1)),
    ("test", {}), ("adadelta", {}), ("ftml", {}),
    ("ftml", dict(beta1=0.7)),
]


def _updater_steps(mx, name, kw, seed, clip):
    """Two weights through one Updater, STEPS steps: the weights after."""
    with mx.cpu():
        opt = mx.optimizer.create(name, learning_rate=0.05, wd=0.01,
                                  rescale_grad=0.5, clip_gradient=clip, **kw)
        upd = mx.optimizer.get_updater(opt)
        ws = [mx.nd.array(_weight(seed + i)) for i in range(2)]
        grads = [_grads(seed + i) for i in range(2)]
        for step in range(STEPS):
            for i, w in enumerate(ws):
                upd(i, mx.nd.array(grads[i][step]), w)
        return [w.asnumpy() for w in ws]


@pytest.mark.parametrize("clip", [None, 1.2])
@pytest.mark.parametrize("name,kw", CONFIGS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONFIGS)])
def test_optimizer_matches_jax(name, kw, clip):
    ref = _updater_steps(jmx, name, kw, seed=3, clip=clip)
    got = _updater_steps(tmx, name, kw, seed=3, clip=clip)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= REL, name


def test_optimizer_on_tensors_equals_ndarrays():
    """update() takes torch tensors (the TrainStep path) as it takes
    NDArrays, with the same result."""
    import torch
    opt_nd = tmx.optimizer.create("adam", learning_rate=0.05, wd=0.01)
    opt_t = tmx.optimizer.create("adam", learning_rate=0.05, wd=0.01)
    with tmx.cpu():
        w_nd = tmx.nd.array(_weight(4))
        s_nd = opt_nd.create_state(0, w_nd)
        w_t = torch.from_numpy(_weight(4))
        s_t = opt_t.create_state(0, w_t)
        for g in _grads(4):
            opt_nd.update(0, w_nd, tmx.nd.array(g), s_nd)
            opt_t.update(0, w_t, torch.from_numpy(g), s_t)
    np.testing.assert_array_equal(w_nd.asnumpy(), w_t.numpy())


def test_multi_precision_adam_keeps_an_fp32_master():
    import torch
    opt = tmx.optimizer.create("adam", learning_rate=0.01,
                               multi_precision=True)
    w = torch.from_numpy(_weight(5)).to(torch.bfloat16)
    state = opt.create_state_multi_precision(0, w)
    master = state[0]
    assert master.dtype == torch.float32
    for g in _grads(5):
        opt.update_multi_precision(0, w, torch.from_numpy(g), state)
    np.testing.assert_array_equal(w.float().numpy(),
                                  master.to(torch.bfloat16).float().numpy())


def test_sgld_moments():
    """SGLD = half an SGD step plus N(0, lr) noise; the noise's bits are
    each package's own, so both sides are held to the same moments over
    a large weight: the deterministic part removed, mean ~0 and variance
    ~lr."""
    lr, n = 0.04, 200_000
    w0 = np.random.RandomState(6).randn(n).astype(np.float32)
    g = np.random.RandomState(7).randn(n).astype(np.float32)
    drift = -lr / 2 * (g * 0.5 + 0.01 * w0)
    for mx in (jmx, tmx):
        with mx.cpu():
            mx.random.seed(11)
            opt = mx.optimizer.create("sgld", learning_rate=lr, wd=0.01,
                                      rescale_grad=0.5)
            w = mx.nd.array(w0)
            opt.update(0, w, mx.nd.array(g), None)
            noise = w.asnumpy() - w0 - drift
        assert abs(noise.mean()) < 5 * np.sqrt(lr / n)
        assert abs(noise.var() / lr - 1) < 0.02


def test_sparse_gradient_raises():
    """A row_sparse gradient takes Adam's lazy update, as in the JAX
    package (the stored rows only, the same values); a gradient of
    another sparse kind still raises."""
    w0, g = _weight(8), _weight(9)
    rows = [0, 2]
    res = []
    for mx in (jmx, tmx):
        with mx.cpu():
            opt = mx.optimizer.create("adam", learning_rate=0.01)
            w = mx.nd.array(w0)
            st = opt.create_state(0, w)
            grad = mx.nd.sparse.row_sparse_array((g[rows], rows),
                                                 shape=w0.shape)
            opt.update(0, w, grad, st)
            res.append(w.asnumpy())
    np.testing.assert_allclose(res[1], res[0], rtol=REL, atol=REL)
    np.testing.assert_array_equal(res[1][1], w0[1])
    opt = tmx.optimizer.create("adam")
    with tmx.cpu():
        w = tmx.nd.array(w0)
        with pytest.raises(MXNetError, match="csr"):
            opt.update(0, w, w.tostype("csr"), opt.create_state(0, w))


def test_module_fit_by_name_with_adam():
    """Module.fit takes the new optimizers by name: two epochs of a small
    regression move its loss down."""
    rs = np.random.RandomState(9)
    x = rs.randn(64, 4).astype(np.float32)
    y = (x @ rs.randn(4, 1)).astype(np.float32)
    with tmx.cpu():
        data = tmx.sym.var("data")
        net = tmx.sym.LinearRegressionOutput(
            tmx.sym.FullyConnected(data, num_hidden=1, name="fc"),
            name="lro")
        it = tmx.io.NDArrayIter(x, y, batch_size=16,
                                label_name="lro_label")
        mod = tmx.mod.Module(net, label_names=("lro_label",),
                             context=tmx.cpu())
        metric = tmx.metric.MSE()
        mod.fit(it, eval_metric=metric, optimizer="adam",
                optimizer_params={"learning_rate": 0.1}, num_epoch=1)
        first = metric.get()[1]
        it.reset()
        mod.fit(it, eval_metric=metric, optimizer="adam",
                optimizer_params={"learning_rate": 0.1}, num_epoch=3,
                begin_epoch=1)
        assert metric.get()[1] < first
