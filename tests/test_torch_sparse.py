"""The port's sparse storage held to the JAX package's on the CPU:
``nd.sparse`` (``CSRNDArray``, ``RowSparseNDArray``, their constructors,
slicing, ``retain``, ``todense`` / ``from_dense``, ``dot`` in both
forms, ``add``), ``cast_storage`` / ``sparse_retain`` / ``square_sum``
and ``NDArray.tostype``; the lazy row_sparse updates of SGD (with and
without momentum), Adam and AdaGrad; ``Parameter(grad_stype=...)``,
``Embedding(sparse_grad=True)`` and ``gluon.Trainer``'s row_sparse
route; ``parallel.TrainStep``'s dense update of such parameters;
``io.LibSVMIter``; sparse ``.params`` records; ``sym.sparse``; and
``convert``'s sparse helpers.

Tolerances: storage, slicing and retain exactly (they move values);
``dot``, ``add``, ``square_sum`` and the updates within 1e-6 of the
reference's max (the same float32 operations, other summation orders);
the rows an update must not touch, and their optimizer states, bit for
bit.
"""
import struct

import numpy as np
import pytest
import scipy.sparse

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert

TOL = 1e-6


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _dense(seed, shape=(6, 5), density=0.4):
    rs = np.random.RandomState(seed)
    a = rs.randn(*shape).astype(np.float32)
    a[rs.rand(*shape) > density] = 0
    return a


def _parts(arr):
    """A sparse array's components as numpy, either package."""
    if hasattr(arr._data, "cpu"):
        return {k: v for k, v in convert.sparse_to_numpy(arr).items()}
    parts = {"stype": arr.stype, "shape": arr.shape,
             "data": np.asarray(arr._data),
             "indices": np.asarray(arr._indices)}
    if arr.stype == "csr":
        parts["indptr"] = np.asarray(arr._indptr)
    return parts


def _same_sparse(t, j):
    pt, pj = _parts(t), _parts(j)
    assert pt["stype"] == pj["stype"] and tuple(pt["shape"]) == \
        tuple(pj["shape"])
    for k in ("data", "indices", "indptr"):
        if k in pj:
            np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


# -------------------------------------------------------------- storage
@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_cast_storage_round_trip(stype):
    a = _dense(0)
    a[2] = 0                       # an empty row
    j = jmx.nd.cast_storage(jmx.nd.array(a), stype)
    with tmx.cpu():
        t = tmx.nd.cast_storage(tmx.nd.array(a), stype)
        assert t.stype == stype and t.context == tmx.cpu()
        _same_sparse(t, j)
        _same_sparse(tmx.nd.array(a).tostype(stype), j)
        back = tmx.nd.cast_storage(t, "default")
        assert back.stype == "default"
        np.testing.assert_array_equal(back.asnumpy(), a)
        np.testing.assert_array_equal(t.tostype("default").asnumpy(), a)
        assert t.tostype(stype) is t
        other = "csr" if stype == "row_sparse" else "row_sparse"
        _same_sparse(t.tostype(other), jmx.nd.cast_storage(
            jmx.nd.array(a), other))
        assert t.astype("float16").dtype == np.float16
        assert t.dtype == j.dtype and t.shape == j.shape
        assert len(t) == len(j) and t.size == j.size


def test_constructors_match():
    a = _dense(1)
    sp = scipy.sparse.csr_matrix(a)
    with tmx.cpu():
        pairs = [
            (tmx.nd.sparse.csr_matrix((sp.data, sp.indices, sp.indptr),
                                      shape=a.shape),
             jmx.nd.sparse.csr_matrix((sp.data, sp.indices, sp.indptr),
                                      shape=a.shape)),
            (tmx.nd.sparse.csr_matrix(a), jmx.nd.sparse.csr_matrix(a)),
            (tmx.nd.sparse.array(sp), jmx.nd.sparse.array(sp)),
            (tmx.nd.sparse.row_sparse_array(a),
             jmx.nd.sparse.row_sparse_array(a)),
            (tmx.nd.sparse.row_sparse_array(
                (a[[4, 0]], [4, 0]), shape=a.shape),
             jmx.nd.sparse.row_sparse_array(
                 (a[[4, 0]], [4, 0]), shape=a.shape)),
            (tmx.nd.sparse.zeros("csr", (3, 4)),
             jmx.nd.sparse.zeros("csr", (3, 4))),
            (tmx.nd.sparse.empty("row_sparse", (3, 4, 2)),
             jmx.nd.sparse.empty("row_sparse", (3, 4, 2)))]
        for t, j in pairs:
            assert type(t).__name__ == type(j).__name__
            _same_sparse(t, j)
        assert tmx.nd.sparse.zeros("default", (2, 2)).stype == "default"
        d = tmx.nd.sparse.array(a)
        assert d.stype == "default"
        t = pairs[0][0]
        assert t.nnz == pairs[0][1].nnz
        for prop in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(t, prop).asnumpy(),
                                          getattr(pairs[0][1],
                                                  prop).asnumpy())
        r = pairs[4][0]
        assert r.num_stored == 2
        np.testing.assert_array_equal(r.indices.asnumpy(), [0, 4])
        with pytest.raises(NotImplementedError):
            r.reshape((5, 6))
        with pytest.raises(tmx.MXNetError):
            tmx.nd.sparse.CSRNDArray([1.0], [0], [0, 1], (3, 2))


def test_csr_slicing_and_retain():
    """Slices against the JAX package's; ``retain`` against the rule in
    numpy (the JAX ``CSRNDArray.retain`` writes into a read-only array
    and raises)."""
    a = _dense(2, (7, 4))
    j = jmx.nd.sparse.csr_matrix(a)
    with tmx.cpu():
        t = tmx.nd.sparse.csr_matrix(a)
        for key in (slice(1, 5), slice(None, 3), slice(4, None), 2):
            _same_sparse(t[key], j[key])
        for rows, got in (([0, 3, 6], t.retain(tmx.nd.array([0, 3, 6]))),
                          ([1, 2], tmx.nd.sparse_retain(t, [1, 2]))):
            want = np.zeros_like(a)
            want[rows] = a[rows]
            _same_sparse(got, jmx.nd.sparse.csr_matrix(want))


def test_row_sparse_retain_and_update_rows():
    a = _dense(3, (8, 3, 2))
    j = jmx.nd.sparse.row_sparse_array(a)
    with tmx.cpu():
        t = tmx.nd.sparse.row_sparse_array(a)
        _same_sparse(t, j)
        _same_sparse(t.retain([0, 2, 5, 7]), j.retain([0, 2, 5, 7]))
        assert t[:] is t
        vals = np.random.RandomState(4).randn(3, 3, 2).astype(np.float32)
        t._update_rows([6, 1, 6, 3], vals)
        j._update_rows([6, 1, 6, 3], vals)
        _same_sparse(t, j)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot(transpose_a):
    a = _dense(5, (9, 7), density=0.3)
    rhs = np.random.RandomState(6).randn(9 if transpose_a else 7,
                                         3).astype(np.float32)
    want = jmx.nd.sparse.dot(jmx.nd.sparse.csr_matrix(a), jmx.nd.array(rhs),
                             transpose_a=transpose_a).asnumpy()
    with tmx.cpu():
        csr = tmx.nd.sparse.csr_matrix(a)
        got = tmx.nd.sparse.dot(csr, tmx.nd.array(rhs),
                                transpose_a=transpose_a)
        if not transpose_a:
            _close(csr.dot(tmx.nd.array(rhs)).asnumpy(), want)
    _close(got.asnumpy(), want)
    _close(got.asnumpy(), (a.T if transpose_a else a) @ rhs)


def test_dense_fallbacks_and_add():
    a, b = _dense(7, (6, 4)), _dense(8, (6, 4))
    with tmx.cpu():
        ra = tmx.nd.sparse.row_sparse_array(a)
        rb = tmx.nd.sparse.row_sparse_array(b)
        s = tmx.nd.sparse.add(ra, rb)
        _same_sparse(s, jmx.nd.sparse.add(jmx.nd.sparse.row_sparse_array(a),
                                          jmx.nd.sparse.row_sparse_array(b)))
        mixed = tmx.nd.sparse.add(ra, tmx.nd.array(b))
        np.testing.assert_array_equal(mixed.asnumpy(), a + b)
        d = tmx.nd.sparse.dot(ra, tmx.nd.array(b.T))
        _close(d.asnumpy(), a @ b.T)
        out = tmx.nd.zeros((6, 4))
        ra.copyto(out)
        np.testing.assert_array_equal(out.asnumpy(), a)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (1, False),
                                           (1, True), (0, False)])
def test_square_sum(axis, keepdims):
    a = _dense(9, (7, 5))
    for stype in ("row_sparse", "csr", "default"):
        want = jmx.nd.square_sum(jmx.nd.cast_storage(jmx.nd.array(a), stype),
                                 axis=axis, keepdims=keepdims).asnumpy()
        with tmx.cpu():
            got = tmx.nd.square_sum(
                tmx.nd.cast_storage(tmx.nd.array(a), stype), axis=axis,
                keepdims=keepdims).asnumpy()
        _close(got, want, what=(stype, axis))


def test_convert_carries_jax_sparse_arrays():
    a = _dense(10)
    for j in (jmx.nd.sparse.csr_matrix(a),
              jmx.nd.sparse.row_sparse_array(a)):
        with tmx.cpu():
            t = convert.sparse_from_numpy(_parts(j), ctx=tmx.cpu())
        _same_sparse(t, j)
        back = convert.sparse_to_numpy(t)
        t2 = convert.sparse_from_numpy(back, ctx=tmx.cpu())
        _same_sparse(t2, j)


# -------------------------------------------------------- lazy updates
_OPTS = [("sgd", dict(learning_rate=0.1, wd=0.01)),
         ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
         ("adam", dict(learning_rate=0.01, wd=0.01)),
         ("adagrad", dict(learning_rate=0.1, wd=0.01))]


def _states(s):
    if s is None:
        return []
    return [x.asnumpy() for x in (s if isinstance(s, tuple) else (s,))
            if x is not None]


@pytest.mark.parametrize("name,kw", _OPTS,
                         ids=["sgd", "sgd_mom", "adam", "adagrad"])
def test_lazy_update_matches_jax(name, kw):
    """Three steps with different row sets, rescale and clip: the weight
    and states equal the JAX package's; the rows a step's gradient does
    not store keep their weight and states bit for bit."""
    rs = np.random.RandomState(11)
    w0 = rs.randn(10, 4).astype(np.float32)
    steps = [([1, 4, 7], 3), ([4, 0], 4), ([9, 1, 2, 4], 5)]
    res = {}
    for pkg in (jmx, tmx):
        with (tmx.cpu() if pkg is tmx else jmx.cpu()):
            opt = pkg.optimizer.create(name, rescale_grad=0.5,
                                       clip_gradient=2.0, **kw)
            w = pkg.nd.array(w0)
            st = opt.create_state(0, w)
            hist = []
            for rows, seed in steps:
                g = np.random.RandomState(seed).randn(
                    len(rows), 4).astype(np.float32) * 3
                before = [w.asnumpy()] + _states(st)
                grad = pkg.nd.sparse.row_sparse_array((g, rows),
                                                      shape=(10, 4))
                opt.update(0, w, grad, st)
                after = [w.asnumpy()] + _states(st)
                untouched = [r for r in range(10) if r not in rows]
                for x, y in zip(before, after):
                    np.testing.assert_array_equal(x[untouched],
                                                  y[untouched])
                hist.append(after)
            res[pkg] = hist
    for got, want in zip(res[tmx], res[jmx]):
        for a, b in zip(got, want):
            _close(a, b)


def test_sparse_gradient_needs_a_lazy_update():
    """A row_sparse gradient for an optimizer without a lazy form, and a
    csr gradient for any, raise."""
    with tmx.cpu():
        w = tmx.nd.ones((4, 2))
        g = tmx.nd.sparse.row_sparse_array((np.ones((1, 2), np.float32),
                                            [1]), shape=(4, 2))
        opt = tmx.optimizer.create("rmsprop")
        with pytest.raises(tmx.MXNetError, match="lazy update"):
            opt.update(0, w, g, opt.create_state(0, w))
        opt = tmx.optimizer.create("adam")
        with pytest.raises(tmx.MXNetError, match="csr"):
            opt.update(0, w, tmx.nd.ones((4, 2)).tostype("csr"),
                       opt.create_state(0, w))


# ---------------------------------------------------------- Gluon route
class _MF:
    """examples/matrix_factorization.py's MFBlock, for either package."""

    @staticmethod
    def build(mx, users=12, items=9, factor=4):
        class MFBlock(mx.gluon.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.user_embed = mx.gluon.nn.Embedding(
                        users, factor, sparse_grad=True)
                    self.item_embed = mx.gluon.nn.Embedding(
                        items, factor, sparse_grad=True)

            def hybrid_forward(self, F, u, i):
                return F.sum(self.user_embed(u) * self.item_embed(i),
                             axis=-1)
        return MFBlock(prefix="mf_")


@pytest.mark.parametrize("optimizer,kw", [
    ("adam", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2}),
    ("adagrad", {"learning_rate": 0.1})])
def test_trainer_row_sparse_route_matches_jax(optimizer, kw):
    """Embedding(sparse_grad=True) through gluon.Trainer: four steps of
    the MF example's loop equal the JAX package's; rows no batch touched
    keep their initial values; a touched row whose gradient is exactly 0
    (user 5 and item 2, rated only together, at exactly their dot
    product) is not updated, neither by weight decay nor by momentum."""
    rs = np.random.RandomState(12)
    u0 = rs.randn(12, 4).astype(np.float32) * 0.3
    i0 = rs.randn(9, 4).astype(np.float32) * 0.3
    # dyadic rows: their dot product, 0.375, is exact in float32
    u0[5], i0[2] = [0.5, 0.25, 0.0, 0.0], [0.5, 0.5, 0.0, 0.0]
    batches = [(np.array([1, 5, 3, 1]), np.array([0, 2, 0, 7])),
               (np.array([5, 5, 8, 0]), np.array([2, 2, 1, 1])),
               (np.array([3, 5, 1, 1]), np.array([0, 2, 6, 7])),
               (np.array([10, 5, 3, 8]), np.array([4, 2, 4, 1]))]
    ratings = rs.randn(4, 4).astype(np.float32)
    for (u, i), r in zip(batches, ratings):
        r[(u == 5) & (i == 2)] = 0.375
    res = {}
    for mx in (jmx, tmx):
        with mx.cpu():
            net = _MF.build(mx)
            net.initialize()
            params = net.collect_params()
            params["mf_embedding0_weight"].set_data(mx.nd.array(u0))
            params["mf_embedding1_weight"].set_data(mx.nd.array(i0))
            assert params["mf_embedding0_weight"]._grad_stype == \
                "row_sparse"
            trainer = mx.gluon.Trainer(params, optimizer, dict(kw))
            loss_fn = mx.gluon.loss.L2Loss()
            for (u, i), r in zip(batches, ratings):
                with mx.autograd.record():
                    loss = loss_fn(net(mx.nd.array(u), mx.nd.array(i)),
                                   mx.nd.array(r))
                loss.backward()
                trainer.step(4)
            res[mx] = [params[n].data().asnumpy() for n in
                       ("mf_embedding0_weight", "mf_embedding1_weight")]
    for a, b in zip(res[tmx], res[jmx]):
        _close(a, b)
    users, items = res[tmx]
    np.testing.assert_array_equal(users[[2, 4, 6, 7, 9, 11]],
                                  u0[[2, 4, 6, 7, 9, 11]])
    np.testing.assert_array_equal(items[[3, 5, 8]], i0[[3, 5, 8]])
    np.testing.assert_array_equal(items[2], i0[2])
    np.testing.assert_array_equal(users[5], u0[5])


def test_parameter_stypes():
    with tmx.cpu():
        p = tmx.gluon.Parameter("w", shape=(3, 2), stype="row_sparse",
                                grad_stype="csr")
        assert p._stype == "row_sparse" and p._grad_stype == "csr"
        with pytest.raises(ValueError, match="invalid grad_stype"):
            tmx.gluon.Parameter("w", grad_stype="dense")


def test_train_step_updates_sparse_grad_parameters_densely():
    """parallel.TrainStep on a Gluon block with sparse_grad embeddings
    (examples/wide_deep.py's use): a dense update, as the JAX step's,
    with the same losses and weights after five Adam steps."""
    rs = np.random.RandomState(13)
    init = {"ts_embedding0_weight": rs.randn(20, 3).astype(np.float32) * 0.2,
            "ts_dense0_weight": rs.randn(1, 6).astype(np.float32) * 0.5,
            "ts_dense0_bias": np.zeros(1, np.float32)}
    w0 = init["ts_embedding0_weight"]
    res = {}
    for mx in (jmx, tmx):
        with mx.cpu():
            class Net(mx.gluon.Block):
                def __init__(self, **kw):
                    super().__init__(**kw)
                    with self.name_scope():
                        self.emb = mx.gluon.nn.Embedding(20, 3,
                                                         sparse_grad=True)
                        self.out = mx.gluon.nn.Dense(1, in_units=6)

                def forward(self, x):
                    e = self.emb(x)
                    return self.out(e.reshape((e.shape[0], -1))).reshape(
                        (-1,))
            net = Net(prefix="ts_")
            net.initialize(init=mx.init.Xavier())
            for n, p in net.collect_params().items():
                p.set_data(mx.nd.array(init[n]))
            bce = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
            kw = {"device": "cpu"} if mx is tmx else {}
            par = mx.parallel
            step = par.TrainStep(net, lambda o, l: bce(o, l).mean(),
                                 mx.optimizer.Adam(learning_rate=0.05,
                                                   wd=0.01), **kw)
            data = np.random.RandomState(14)
            losses = []
            for _ in range(5):
                x = data.randint(0, 10, (8, 2)).astype(np.float32)
                y = data.randint(0, 2, 8).astype(np.float32)
                losses.append(float(step(mx.nd.array(x),
                                         mx.nd.array(y)).asscalar()))
            step.sync_params()
            res[mx] = (losses, {n: p.data().asnumpy() for n, p in
                                net.collect_params().items()})
    _close(res[tmx][0], res[jmx][0], 1e-5)
    for n in res[jmx][1]:
        _close(res[tmx][1][n], res[jmx][1][n], 1e-5, n)
    # the dense update moves the rows no batch used (weight decay)
    w = res[tmx][1]["ts_embedding0_weight"]
    assert not np.array_equal(w[15:], w0[15:])


# ------------------------------------------------------------- LibSVMIter
def _libsvm(tmp_path):
    rs = np.random.RandomState(15)
    lines, labels = [], []
    for r in range(11):
        nnz = rs.randint(0, 4)
        idx = np.sort(rs.choice(30, nnz, replace=False))
        feats = " ".join(f"{i}:{rs.rand():.4f}" for i in idx)
        lines.append(f"{r % 2} {feats}".strip())
        labels.append(f"{(r * 7) % 3} extra")
    (tmp_path / "d.libsvm").write_text("\n".join(lines) + "\n\n")
    (tmp_path / "l.txt").write_text("\n".join(labels) + "\n")
    return str(tmp_path / "d.libsvm"), str(tmp_path / "l.txt")


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("labels", [False, True])
def test_libsvm_iter_matches_jax(tmp_path, round_batch, labels):
    path, lpath = _libsvm(tmp_path)
    kw = dict(data_shape=(30,), batch_size=4, round_batch=round_batch,
              label_libsvm=lpath if labels else None)
    got, want = [], []
    for mod, out in ((tmx.io, got), (jmx.io, want)):
        it = mod.LibSVMIter(path, **kw)
        for _ in range(2):
            it.reset()
            for b in it:
                out.append((b.data[0], b.label[0].asnumpy(), b.pad))
    assert len(got) == len(want) == (6 if round_batch else 4)
    for (td, tl, tp), (jd, jl, jp) in zip(got, want):
        assert td.stype == "csr" and td.context == tmx.cpu()
        _same_sparse(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp
    it = tmx.io.LibSVMIter(path, **kw)
    assert it.provide_data[0].shape == (4, 30)
    assert it.provide_label[0].shape == (4,)


# ------------------------------------------------------------ .params
def _shape_bytes(shape):
    return struct.pack("<I", len(shape)) + struct.pack(f"<{len(shape)}q",
                                                       *shape)


def _sparse_record(stype, shape, values, aux):
    """A V2 NDArray record of storage type 1 (row_sparse) or 2 (csr)."""
    out = struct.pack("<I", 0xF993FAC9) + struct.pack("<i", stype)
    out += _shape_bytes(values.shape) + _shape_bytes(shape)
    out += struct.pack("<iii", 1, 0, 0)            # cpu(0), float32
    out += b"".join(struct.pack("<i", 6) for _ in aux)     # int64 aux
    out += b"".join(_shape_bytes(a.shape) for a in aux)
    out += values.astype(np.float32).tobytes()
    out += b"".join(a.astype(np.int64).tobytes() for a in aux)
    return out


def test_sparse_params_records_load_in_both(tmp_path):
    a = _dense(16, (5, 3))
    rows = np.nonzero(a.any(1))[0]
    sp = scipy.sparse.csr_matrix(a)
    blob = struct.pack("<QQQ", 0x112, 0, 2)
    blob += _sparse_record(1, a.shape, a[rows], [rows])
    blob += _sparse_record(2, a.shape, sp.data, [sp.indptr, sp.indices])
    names = [b"rsp", b"csr"]
    blob += struct.pack("<Q", len(names)) + b"".join(
        struct.pack("<Q", len(n)) + n for n in names)
    path = str(tmp_path / "sparse.params")
    with open(path, "wb") as f:
        f.write(blob)
    want = jmx.nd.load(path)
    with tmx.cpu():
        got = tmx.nd.load(path)
    assert got["rsp"].stype == "row_sparse" and got["csr"].stype == "csr"
    for k in ("rsp", "csr"):
        _same_sparse(got[k], want[k])
        np.testing.assert_array_equal(got[k].asnumpy(), a)


# -------------------------------------------------------------- sym.sparse
def test_sym_sparse_matches_jax():
    rs = np.random.RandomState(17)
    a = rs.randn(5, 4).astype(np.float32)
    b = rs.randn(4, 3).astype(np.float32)
    idx = np.array([0, 3], np.float32)

    def graphs(mx):
        x, y, i = mx.sym.var("x"), mx.sym.var("y"), mx.sym.var("i")
        sp = mx.sym.sparse
        return {"dot": sp.dot(x, y, name="d"),
                "zeros_like": sp.zeros_like(x, name="z"),
                "cast_storage": sp.cast_storage(x, stype="csr", name="c"),
                "retain": sp.retain(x, i, num_rows=5, name="r"),
                "square_sum": sp.square_sum(x, axis=1, name="s")}
    tg, jg = graphs(tmx), graphs(jmx)
    assert set(tg) == set(tmx.sym.sparse.__all__)
    feeds = {"x": a, "y": b, "i": idx}
    for name in tg:
        args = {k: v for k, v in feeds.items()
                if k in jg[name].list_arguments()}
        want = jg[name].eval(ctx=jmx.cpu(), **{
            k: jmx.nd.array(v) for k, v in args.items()})[0].asnumpy()
        got = tg[name].eval(ctx=tmx.cpu(), **{
            k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in args.items()}
        )[0].asnumpy()
        _close(got, want, 1e-6, name)
    with pytest.raises(tmx.MXNetError, match="num_rows"):
        tmx.sym.sparse.retain(tmx.sym.var("x"), tmx.sym.var("i"))
    with pytest.raises(tmx.MXNetError, match="stype"):
        tmx.sym.sparse.cast_storage(tmx.sym.var("x"), stype="coo")
