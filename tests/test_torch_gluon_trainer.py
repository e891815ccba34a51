"""``gluon.Trainer``, the ``Optimizer`` base, ``lr_scheduler``,
``metric``, ``initializer``, ``gluon.utils`` and NDArray pickling of the
port against the JAX package on the CPU.  The training runs hold every
parameter within 1e-5 of its max |value| after each step; schedulers
are exact, metrics within 1e-6 relative; deterministic initializers
exact, random ones by their bounds, moments and JAX's scale formula
(their bits differ, as any sampling's do)."""
import hashlib
import math
import os
import pickle

import numpy as np
import pytest

import chip_smoke
import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-5


def _close(got, ref, what, rel=REL, atol=0.0):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale + atol, (what, err, scale)


def _mlp(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(8, activation="tanh"), nn.BatchNorm(),
                nn.Dense(5))
    return net


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(6, 4).astype(np.float32),
            rs.randint(0, 5, 6).astype(np.float32))


def _init_like(jnet, tnet, x):
    """Initialise both nets, resolve their shapes, copy JAX's values."""
    with jmx.cpu():
        jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
        with jmx.autograd.pause():
            jnet(jmx.nd.array(x))
    with tmx.cpu():
        tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        with tmx.autograd.pause():
            tnet(tmx.nd.array(x))
        for name, p in jnet.collect_params().items():
            tnet.collect_params()[name].set_data(
                tmx.nd.array(p.data().asnumpy()))


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _train(mx, net, x, y, steps, optimizer_params, reqs=None,
           ignore_stale=False, skip=None):
    """``steps`` Trainer steps; ``reqs`` sets grad_req by name;
    ``skip``: parameter names whose layer is left out of the loss after
    the first step (their gradient goes stale).  Returns the parameters
    after each step."""
    out = []
    with mx.cpu():
        params = net.collect_params()
        for name, req in (reqs or {}).items():
            params[name].grad_req = req
        trainer = mx.gluon.Trainer(params, "sgd", dict(optimizer_params))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        xx, yy = mx.nd.array(x), mx.nd.array(y)
        for step in range(steps):
            with mx.autograd.record():
                h = net[0](xx)
                if skip is None or step == 0:
                    h = net[1](h)
                loss = loss_fn(net[2](h), yy)
            loss.backward()
            trainer.step(x.shape[0], ignore_stale_grad=ignore_stale)
            out.append(_params(net))
    return out, trainer


def _compare_runs(got, ref):
    for step, (g, r) in enumerate(zip(got, ref)):
        for name in r:
            _close(g[name], r[name], f"step {step} {name}")


OPTS = {
    "momentum_wd_factor": dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                               lr_scheduler="factor"),
    "plain": dict(learning_rate=0.05),
    "clip_rescale": dict(learning_rate=0.1, momentum=0.5,
                         clip_gradient=0.05, rescale_grad=2.0),
}


def _opt(mx, name):
    kw = dict(OPTS[name])
    if kw.get("lr_scheduler") == "factor":
        kw["lr_scheduler"] = mx.lr_scheduler.FactorScheduler(
            step=1, factor=0.5)
    return kw


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_trainer_sgd_matches_jax(opt):
    x, y = _data()
    jnet, tnet = _mlp(jmx), _mlp(tmx)
    _init_like(jnet, tnet, x)
    ref, jt = _train(jmx, jnet, x, y, 3, _opt(jmx, opt))
    got, tt = _train(tmx, tnet, x, y, 3, _opt(tmx, opt))
    _compare_runs(got, ref)
    assert tt.learning_rate == jt.learning_rate


def test_trainer_grad_req_add_and_null():
    """``add`` accumulates the gradient across steps (nothing zeroes
    it), ``null`` freezes the parameter; both as in JAX."""
    x, y = _data(1)
    jnet, tnet = _mlp(jmx), _mlp(tmx)
    _init_like(jnet, tnet, x)
    reqs = {"mlp_dense0_weight": "add", "mlp_dense1_bias": "null"}
    kw = dict(learning_rate=0.1, momentum=0.9)
    ref, _ = _train(jmx, jnet, x, y, 3, kw, reqs)
    got, _ = _train(tmx, tnet, x, y, 3, kw, reqs)
    _compare_runs(got, ref)
    np.testing.assert_array_equal(got[-1]["mlp_dense1_bias"],
                                  got[0]["mlp_dense1_bias"])


def test_trainer_stale_gradients():
    """A parameter no backward reached since the last step raises, or is
    skipped with ``ignore_stale_grad``, as in JAX."""
    x, y = _data(2)
    jnet, tnet = _mlp(jmx), _mlp(tmx)
    _init_like(jnet, tnet, x)
    with pytest.raises(UserWarning, match="has not been updated"):
        _train(tmx, tnet, x, y, 2, dict(learning_rate=0.1), skip=True)
    jnet, tnet = _mlp(jmx), _mlp(tmx)
    _init_like(jnet, tnet, x)
    kw = dict(learning_rate=0.1, momentum=0.9)
    ref, _ = _train(jmx, jnet, x, y, 3, kw, ignore_stale=True, skip=True)
    got, _ = _train(tmx, tnet, x, y, 3, kw, ignore_stale=True, skip=True)
    _compare_runs(got, ref)
    assert np.array_equal(got[2]["mlp_batchnorm0_gamma"],
                          got[0]["mlp_batchnorm0_gamma"])


def test_trainer_states_round_trip(tmp_path):
    """``save_states`` / ``load_states``: a trainer restored from a file
    continues exactly as the one that wrote it (momentum, update count
    and schedule included)."""
    x, y = _data(3)
    kw = _opt(tmx, "momentum_wd_factor")
    with tmx.cpu():
        a = _mlp(tmx)
        b = _mlp(tmx)
        for net in (a, b):
            net.initialize(tmx.init.One())
            with tmx.autograd.pause():
                net(tmx.nd.array(x))
        _, ta = _train(tmx, a, x, y, 2, kw)
        path = os.path.join(tmp_path, "trainer.states")
        ta.save_states(path)
        for name, p in a.collect_params().items():
            b.collect_params()[name].set_data(p.data())
        tb = tmx.gluon.Trainer(b.collect_params(), "sgd",
                               dict(learning_rate=0.7))
        tb.load_states(path)
        assert tb.learning_rate == ta.learning_rate
        assert tb._optimizer.num_update == ta._optimizer.num_update
        for i, s in ta._updaters.states.items():
            np.testing.assert_array_equal(
                tb._updaters.states[i].asnumpy(), s.asnumpy())
        xx, yy = tmx.nd.array(x), tmx.nd.array(y)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        for net, tr in ((a, ta), (b, tb)):
            with tmx.autograd.record():
                loss = loss_fn(net(xx), yy)
            loss.backward()
            tr.step(6)
        for name, v in _params(a).items():
            np.testing.assert_array_equal(_params(b)[name], v)


def test_trainer_refuses_what_needs_a6():
    """The stores of ROADMAP A6 are ported: each kvstore the Trainer once
    refused now steps, with the JAX Trainer's routing (which store is
    kept, whether it updates); an unknown store type is refused at the
    first step, where the store is made."""
    with tmx.cpu():
        net = _mlp(tmx)
        net.initialize()
        params = net.collect_params()
        x = tmx.nd.ones((2, 20))
        routes = {"nccl": (None, False), "dist_sync": ("KVStoreDist", True),
                  "tpu": ("KVStoreTPU", True)}
        for kv, (store, on_kv) in routes.items():
            tr = tmx.gluon.Trainer(params, "sgd", kvstore=kv)
            with tmx.autograd.record():
                loss = net(x).sum()
            loss.backward()
            tr.step(2)
            assert (type(tr._kvstore).__name__ if tr._kvstore else None,
                    tr._update_on_kvstore) == (store, on_kv), kv
        tr = tmx.gluon.Trainer(params, "sgd", update_on_kvstore=True)
        with tmx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
        assert tr._kvstore.type == "device" and tr._update_on_kvstore
        bad = tmx.gluon.Trainer(params, "sgd", kvstore="parameter_server")
        with tmx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        with pytest.raises(MXNetError, match="unknown kvstore"):
            bad.step(2)
        for kv in ("device", "local", None):
            tmx.gluon.Trainer(params, "sgd", kvstore=kv)


def test_multi_precision_sgd_matches_jax():
    """``SGD(multi_precision=True)`` on a bf16 weight through the
    Updater: the fp32 master and momentum as in JAX."""
    rs = np.random.RandomState(4)
    w = rs.randn(5, 3).astype(np.float32)
    grads = [rs.randn(5, 3).astype(np.float32) for _ in range(3)]
    out = {}
    for side, mx in (("jax", jmx), ("port", tmx)):
        with mx.cpu():
            opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                   multi_precision=True)
            up = mx.optimizer.get_updater(opt)
            weight = mx.nd.array(w).astype("bfloat16")
            for g in grads:
                up(0, mx.nd.array(g).astype("bfloat16"), weight)
            mom, master = up.states[0]
            out[side] = (weight.astype("float32").asnumpy(),
                         mom.asnumpy(), master.asnumpy())
    for g, r in zip(out["port"], out["jax"]):
        _close(g, r, "multi-precision", rel=1e-6)


# ------------------------------------------------------------- schedulers
def _schedulers(mx):
    ls = mx.lr_scheduler
    return {
        "factor": ls.FactorScheduler(step=3, factor=0.7, stop_factor_lr=0.01,
                                     base_lr=1.0),
        "multifactor": ls.MultiFactorScheduler(step=[2, 5, 9], factor=0.5,
                                               base_lr=0.8),
        "poly": ls.PolyScheduler(max_update=20, base_lr=0.3, pwr=2),
        "cosine": ls.CosineScheduler(max_update=15, base_lr=0.5,
                                     final_lr=0.01),
        "warmup": ls.WarmupScheduler(4, ls.FactorScheduler(
            step=2, factor=0.9, base_lr=0.2), begin_lr=0.01)}


@pytest.mark.parametrize("name", ["factor", "multifactor", "poly", "cosine",
                                  "warmup"])
def test_lr_scheduler_exact(name):
    j, t = _schedulers(jmx)[name], _schedulers(tmx)[name]
    assert [t(n) for n in range(30)] == [j(n) for n in range(30)]


def test_optimizer_registry_and_multipliers():
    opt = tmx.optimizer.create("sgd", learning_rate=0.2, wd=0.1,
                               param_idx2name={0: "a_weight", 1: "a_bias"})
    assert isinstance(opt, tmx.optimizer.SGD)
    assert opt._get_wd(0) == pytest.approx(0.1) and opt._get_wd(1) == 0.0
    opt.set_lr_mult({"a_weight": 3.0})
    assert opt._get_lr(0) == pytest.approx(0.6)
    with pytest.raises(UserWarning):
        tmx.optimizer.SGD(lr_scheduler=tmx.lr_scheduler.FactorScheduler(
            1)).set_learning_rate(0.1)


# ------------------------------------------------------------- metrics
def _metric_cases(rs):
    probs = rs.dirichlet(np.ones(4), 6).astype(np.float32)
    labels = rs.randint(0, 4, 6).astype(np.float32)
    binary = rs.dirichlet(np.ones(2), 6).astype(np.float32)
    blabels = rs.randint(0, 2, 6).astype(np.float32)
    reg = rs.randn(6).astype(np.float32)
    target = (reg + rs.randn(6) * 0.3).astype(np.float32)
    return {
        "acc": (lambda m: m.Accuracy(), labels, probs),
        "topk": (lambda m: m.TopKAccuracy(top_k=2), labels, probs),
        "f1": (lambda m: m.F1(), blabels, binary),
        "perplexity": (lambda m: m.Perplexity(ignore_label=None), labels,
                       probs),
        "perplexity_ignore": (lambda m: m.Perplexity(ignore_label=1),
                              labels, probs),
        "mae": (lambda m: m.MAE(), target, reg),
        "mse": (lambda m: m.MSE(), target, reg),
        "rmse": (lambda m: m.RMSE(), target, reg),
        "ce": (lambda m: m.CrossEntropy(), labels, probs),
        "nll": (lambda m: m.NegativeLogLikelihood(), labels, probs),
        "pearson": (lambda m: m.PearsonCorrelation(), target, reg),
        "loss": (lambda m: m.Loss(), labels, probs),
        "composite": (lambda m: m.create(["acc", "ce"]), labels, probs),
        "custom": (lambda m: m.np(lambda l, p: float(np.abs(l - p.argmax(
            1)).sum())), labels, probs),
    }


@pytest.mark.parametrize("name", ["acc", "topk", "f1", "perplexity",
                                  "perplexity_ignore", "mae", "mse", "rmse",
                                  "ce", "nll", "pearson", "loss",
                                  "composite", "custom"])
def test_metric_matches_jax(name):
    got_ref = []
    for mx in (tmx, jmx):
        build, labels, preds = _metric_cases(np.random.RandomState(5))[name]
        metric = build(mx.metric)
        with mx.cpu():
            for _ in range(2):
                metric.update([mx.nd.array(labels)], [mx.nd.array(preds)])
        got_ref.append(metric.get())
    (gn, gv), (rn, rv) = got_ref
    assert gn == rn
    np.testing.assert_allclose(np.asarray(gv, np.float64),
                               np.asarray(rv, np.float64), rtol=1e-6)


def test_metric_reset_and_create():
    m = tmx.metric.create("acc")
    with tmx.cpu():
        m.update([tmx.nd.array([1, 0])], [tmx.nd.array([[0.2, 0.8],
                                                        [0.9, 0.1]])])
    assert m.get() == ("accuracy", 1.0)
    m.reset()
    assert math.isnan(m.get()[1])


# ------------------------------------------------------------- initializers
DETERMINISTIC = {
    "zero": lambda i: i.Zero(), "one": lambda i: i.One(),
    "constant": lambda i: i.Constant(0.3), "bilinear": lambda i: i.Bilinear(),
    "lstmbias": lambda i: i.LSTMBias(forget_bias=2.0)}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_initializers_exact(name):
    shape = (8, 3) if name == "lstmbias" else (2, 3, 4, 4)
    out = []
    for mx in (tmx, jmx):
        arr = np.full(shape, 7.0, np.float32)
        DETERMINISTIC[name](mx.initializer)(
            mx.initializer.InitDesc("x_weight"), arr)
        out.append(arr)
    np.testing.assert_array_equal(*out)


@pytest.mark.parametrize("suffix", ["bias", "gamma", "beta", "running_mean",
                                    "moving_var", "min"])
def test_initializer_dispatch_by_suffix(suffix):
    out = []
    for mx in (tmx, jmx):
        arr = np.full((5,), 3.0, np.float32)
        mx.initializer.Xavier()(f"layer_{suffix}", arr)
        out.append(arr)
    np.testing.assert_array_equal(*out)


def test_mixed_and_load_initializers():
    rs = np.random.RandomState(6)
    saved = {"arg:a_weight": rs.randn(3, 2).astype(np.float32)}
    out = []
    for mx in (tmx, jmx):
        mixed = mx.initializer.Mixed([".*a_weight", ".*"],
                                     [mx.initializer.One(),
                                      mx.initializer.Constant(2.0)])
        arrays = [np.zeros((2, 2), np.float32) for _ in range(3)]
        for name, arr in zip(("x_a_weight", "x_b_weight", "x_bias"),
                             arrays):
            mixed(name, arr)
        load = mx.initializer.Load(saved, default_init=mx.initializer.Zero())
        a, c = np.ones((3, 2), np.float32), np.ones((4, 2), np.float32)
        load("a_weight", a)
        load("c_weight", c)
        out.append(arrays + [a, c])
    for g, r in zip(*out):
        np.testing.assert_array_equal(g, r)
    assert (out[0][0] == 1).all() and (out[0][1] == 2).all()
    np.testing.assert_array_equal(out[0][3], saved["arg:a_weight"])


@pytest.mark.parametrize("kind", ["uniform", "normal", "xavier_avg",
                                  "xavier_in_gaussian", "msra", "orthogonal"])
def test_random_initializers_by_their_law(kind):
    """Bounds and moments from JAX's own scale formulas; the draw is
    reproducible per name and seed, and independent of creation order."""
    I = tmx.initializer
    shape = (64, 32, 3, 3) if kind != "orthogonal" else (16, 40)
    fan_in, fan_out = shape[1] * 9, shape[0] * 9
    arr = np.zeros(shape, np.float32)
    tmx.random.seed(11)
    if kind == "uniform":
        I.Uniform(0.2)("w_weight", arr)
        assert np.abs(arr).max() <= 0.2
        assert abs(arr.std() - 0.2 / math.sqrt(3)) < 0.01
    elif kind == "normal":
        I.Normal(0.05)("w_weight", arr)
        assert abs(arr.std() - 0.05) < 0.002 and abs(arr.mean()) < 0.002
    elif kind == "xavier_avg":
        I.Xavier()("w_weight", arr)
        bound = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        assert np.abs(arr).max() <= bound
        assert abs(arr.std() - bound / math.sqrt(3)) < 0.02 * bound
    elif kind == "xavier_in_gaussian":
        I.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)(
            "w_weight", arr)
        assert abs(arr.std() - math.sqrt(2.0 / fan_in)) < \
            0.02 * math.sqrt(2.0 / fan_in)
    elif kind == "msra":
        I.MSRAPrelu(slope=0.25)("w_weight", arr)
        want = math.sqrt(2.0 / (1 + 0.25 ** 2) / ((fan_in + fan_out) / 2))
        assert abs(arr.std() - want) < 0.02 * want
    else:
        I.Orthogonal(scale=1.5)("w_weight", arr)
        np.testing.assert_allclose(arr @ arr.T, 2.25 * np.eye(16),
                                   atol=1e-4)
    again = np.zeros(shape, np.float32)
    tmx.random.seed(11)
    I.Normal(1.0)("other_weight", np.zeros(3, np.float32))
    {"uniform": I.Uniform(0.2), "normal": I.Normal(0.05),
     "xavier_avg": I.Xavier(),
     "xavier_in_gaussian": I.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2),
     "msra": I.MSRAPrelu(slope=0.25),
     "orthogonal": I.Orthogonal(scale=1.5)}[kind]("w_weight", again)
    np.testing.assert_array_equal(again, arr)


def test_initializer_create_and_dumps():
    for mx in (tmx, jmx):
        x = mx.initializer.create("xavier", magnitude=2)
        assert isinstance(x, mx.initializer.Xavier) and x.magnitude == 2.0
        y = mx.initializer.create(x.dumps())
        assert isinstance(y, mx.initializer.Xavier) and y.magnitude == 2.0


# ------------------------------------------------------------- utils, pickle
def test_gluon_utils_match_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(7, 3).astype(np.float32)
    arrays = [rs.randn(4).astype(np.float32) * 3 for _ in range(3)]
    out = {}
    for side, mx in (("port", tmx), ("jax", jmx)):
        with mx.cpu():
            parts = mx.gluon.utils.split_data(mx.nd.array(x), 3,
                                              even_split=False)
            loaded = mx.gluon.utils.split_and_load(x, [mx.cpu()])
            nds = [mx.nd.array(a) for a in arrays]
            norm = mx.gluon.utils.clip_global_norm(nds, 1.0)
            out[side] = ([p.asnumpy() for p in parts], loaded[0].asnumpy(),
                         norm, [a.asnumpy() for a in nds])
    for g, r in zip(out["port"][0], out["jax"][0]):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert out["port"][2] == pytest.approx(out["jax"][2], rel=1e-6)
    for g, r in zip(out["port"][3], out["jax"][3]):
        _close(g, r, "clipped", rel=1e-6)
    with pytest.raises(ValueError):
        with tmx.cpu():
            tmx.gluon.utils.split_data(tmx.nd.array(x), 3)


def test_check_sha1_and_download(tmp_path):
    path = os.path.join(tmp_path, "f.bin")
    with open(path, "wb") as f:
        f.write(b"gluon")
    sha = hashlib.sha1(b"gluon").hexdigest()
    assert tmx.gluon.utils.check_sha1(path, sha)
    assert tmx.gluon.utils.download("http://h/f.bin", path=path,
                                    sha1_hash=sha) == path
    with pytest.raises(MXNetError, match="fetches nothing"):
        tmx.gluon.utils.download("http://h/g.bin", path=str(tmp_path))


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_ndarray_pickles(dtype):
    x = np.arange(12, dtype=np.float32).reshape(3, 4) - 5
    with tmx.cpu():
        a = tmx.nd.array(x).astype(dtype)
        b = pickle.loads(pickle.dumps(a))
    assert b.context == a.context and b.shape == a.shape
    assert b._data.dtype == a._data.dtype
    np.testing.assert_array_equal(b.astype("float32").asnumpy(),
                                  a.astype("float32").asnumpy())
    assert b.stype == "default" and b.tostype("default") is b
    # the unpickled array casts to row_sparse as the JAX package's does
    rsp = b.tostype("row_sparse")
    want = jmx.nd.cast_storage(jmx.nd.array(x).astype(dtype), "row_sparse")
    assert rsp.stype == "row_sparse" and rsp.shape == want.shape
    np.testing.assert_array_equal(rsp.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_array_equal(
        rsp.todense().astype("float32").asnumpy(),
        want.asnumpy().astype(np.float32))


# ------------------------------------------------------------- Gluon code
def test_jax_gluon_code_runs_unchanged():
    """The smoke's ``gluon_layers`` net and loop (JAX Gluon code as a
    user writes it, ``chip_smoke.gluon_bottleneck`` / ``gluon_loop``: a HybridBlock with hybrid_forward, a deferred Dense,
    Xavier init, Trainer with a FactorScheduler, metrics) run with only
    the package changed, at a small width, and agree with the JAX
    package after 3 steps."""
    shape, widths = (2, 6, 6, 16), dict(cin=16, mid=8, classes=10)
    rs = np.random.RandomState(8)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 10, 2).astype(np.float32)
    jnet = chip_smoke.gluon_bottleneck(jmx, **widths)
    tnet = chip_smoke.gluon_bottleneck(tmx, **widths)
    _init_like(jnet, tnet, x)
    ref = chip_smoke.gluon_loop(jmx, jnet, x, y, jmx.cpu(), steps=3)
    got = chip_smoke.gluon_loop(tmx, tnet, x, y, tmx.cpu(), steps=3)
    # the conv biases that feed a BatchNorm have a gradient that is 0 in
    # exact arithmetic: their values are rounding noise, held to the
    # smoke's absolute floor (chip_smoke.STEP_ATOL)
    for name, v in _params(jnet).items():
        _close(_params(tnet)[name], v, name, atol=chip_smoke.STEP_ATOL)
    for g, r in zip(got["metrics"], ref["metrics"]):
        assert g[0] == r[0]
        np.testing.assert_allclose(g[1], r[1], rtol=1e-5)
