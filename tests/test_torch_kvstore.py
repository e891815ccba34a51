"""The port's kvstore, gradient compression, mesh layout and the Gluon
Trainer's store routes against the JAX package, in one process on the
CPU (the two-rank world is tests/test_torch_dist.py's).

* ``kvstore.create`` parses every type as the JAX package does; the
  single-process stores (``local``, ``device``, ``nccl``) push and pull
  lists of keys and of values, run the updater on the merged push,
  ``row_sparse_pull`` into row_sparse and dense outs, and round-trip
  their optimizer states, each against the JAX ``KVStore`` on the same
  seeded numpy values (fp32, atol = rtol = 1e-6: sums of a few values and
  one SGD update, other summation orders at most).
* ``GradientCompression``: the packed 2-bit bytes, the fp8 wire and the
  error-feedback residuals equal the JAX codec's exactly over three
  compressions of seeded gradients (values on the thresholds, sizes not
  a multiple of 4, fp8 values past its range).
* ``make_mesh``: the axis order and shapes of JAX's ``make_mesh``, and
  the same refusals (a mesh that does not cover the world, an unknown
  axis in a sharding spec).
* ``gluon.Trainer``: ``update_on_kvstore``'s default per store type, the
  store route with ``compression_params``, and ``save_states`` /
  ``load_states`` through the store, against the JAX Trainer.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.parallel.compression import (
    GradientCompression as JaxGC, create as jax_gc_create)
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.parallel.compression import (
    GradientCompression, create as gc_create)
from incubator_mxnet_tpu_torch.parallel.mesh import mesh_layout

TOL = dict(atol=1e-6, rtol=1e-6)
TYPES = ["local", "device", "nccl", "local_allreduce_cpu",
         "local_allreduce_device", "tpu", "dist_sync", "dist_device_sync",
         "dist_async"]


@pytest.mark.parametrize("name", TYPES)
def test_create_parses_types_like_jax(name):
    j = jmx.kv.create(name)
    with tmx.cpu():
        t = tmx.kv.create(name)
    assert type(t).__name__ == type(j).__name__
    assert (t.type, t.rank, t.num_workers) == (j.type, j.rank, j.num_workers)
    assert tmx.kvstore is tmx.kv


def test_create_refuses_what_jax_refuses():
    for mod, err in ((jmx, jmx.base.MXNetError), (tmx, MXNetError)):
        with pytest.raises(err):
            mod.kv.create("parameter_server")
        with pytest.raises(TypeError):
            mod.kv.create(3)


def _values(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(3, 4).astype(np.float32) for _ in range(6)]


def _drive(mx, name, vals, ctx):
    """init two keys, push lists of values (two devices each), pull;
    then SGD on the store and two more pushes."""
    kv = mx.kv.create(name)
    nd = lambda a: mx.nd.array(a, ctx=ctx)  # noqa: E731
    kv.init([3, "w"], [nd(vals[0]), nd(vals[1])])
    outs = [nd(np.zeros((3, 4), np.float32)) for _ in range(2)]
    kv.push([3, "w"], [[nd(vals[2]), nd(vals[3])], [nd(vals[4]),
                                                     nd(vals[5])]])
    kv.pull([3, "w"], out=outs)
    got = [o.asnumpy() for o in outs]
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                      wd=1e-4))
    for v in vals[2:4]:
        kv.push(3, nd(v))
    kv.pull(3, out=outs[0])
    return got + [outs[0].asnumpy()]


@pytest.mark.parametrize("name", ["local", "device", "nccl"])
def test_push_pull_and_updater_match_jax(name):
    vals = _values()
    ref = _drive(jmx, name, vals, jmx.cpu())
    with tmx.cpu():
        got = _drive(tmx, name, vals, tmx.cpu())
    np.testing.assert_allclose(got[0], vals[2] + vals[3], **TOL)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


def test_row_sparse_pull_matches_jax():
    rs = np.random.RandomState(4)
    table = rs.randn(6, 3).astype(np.float32)
    rows = np.array([5, 0, 2, 2], np.int64)
    results = []
    for mx in (jmx, tmx):
        ctx = mx.cpu()
        kv = mx.kv.create("local")
        kv.init("emb", mx.nd.array(table, ctx=ctx))
        rsp = mx.nd.sparse.zeros("row_sparse", (6, 3), ctx=ctx)
        dense = mx.nd.zeros((4, 3), ctx=ctx)
        ids = mx.nd.array(rows, ctx=ctx, dtype="int64")
        # one key's outs as a list (JAX iterates a bare sparse out)
        kv.row_sparse_pull("emb", out=[rsp], row_ids=ids)
        kv.row_sparse_pull("emb", out=[dense], row_ids=ids)
        results.append((rsp.indices.asnumpy(), rsp.data.asnumpy(),
                        rsp.asnumpy(), dense.asnumpy()))
    for g, r in zip(results[1], results[0]):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(results[1][0], [0, 2, 5])


def test_optimizer_states_round_trip_like_jax(tmp_path):
    """Two updates, states saved, a fresh store loads them and takes a
    third: the same values as JAX's store, and as one store that took all
    three."""
    vals = _values(1)
    finals = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        fname = str(tmp_path / f"{mx.__name__}.states")

        def store():
            kv = mx.kv.create("local")
            kv.init(0, mx.nd.array(vals[0], ctx=ctx))
            kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1,
                                              momentum=0.9))
            return kv

        kv = store()
        for v in vals[1:3]:
            kv.push(0, mx.nd.array(v, ctx=ctx))
        kv.save_optimizer_states(fname)
        w = mx.nd.zeros((3, 4), ctx=ctx)
        kv.pull(0, out=w)
        fresh = store()
        fresh._data["0"] = w
        fresh.load_optimizer_states(fname)
        for k in (kv, fresh):
            k.push(0, mx.nd.array(vals[3], ctx=ctx))
        a, b = mx.nd.zeros((3, 4), ctx=ctx), mx.nd.zeros((3, 4), ctx=ctx)
        kv.pull(0, out=a)
        fresh.pull(0, out=b)
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        finals.append(a.asnumpy())
    np.testing.assert_allclose(finals[1], finals[0], **TOL)


def _grads(n, seed):
    rs = np.random.RandomState(seed)
    g = (rs.randn(3, n) * 0.6).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 0.49999997, -0.50000006]   # on the thresholds
    return g


@pytest.mark.parametrize("n", [37, 64])
def test_2bit_codes_and_residuals_equal_jax(n):
    import jax.numpy as jnp
    j, t = JaxGC("2bit", 0.5), GradientCompression("2bit", 0.5)
    for g in _grads(n, n):
        wj = np.asarray(j.compress("k", jnp.asarray(g)))
        wt = t.compress("k", torch.from_numpy(g))
        assert wt.dtype == torch.uint8 and wt.shape == ((n + 3) // 4,)
        np.testing.assert_array_equal(wt.numpy(), wj)
        np.testing.assert_array_equal(t._residuals["k"].numpy(),
                                      np.asarray(j._residuals["k"]))
        np.testing.assert_array_equal(
            t.decompress(wt, (n,)).numpy(),
            np.asarray(j.decompress(jnp.asarray(wj), (n,))))


def test_fp8_wire_and_residuals_equal_jax():
    import jax.numpy as jnp
    j, t = JaxGC("fp8", 0.5), GradientCompression("fp8", 0.5)
    rs = np.random.RandomState(9)
    for step in range(3):
        g = (rs.randn(50) * 100).astype(np.float32)
        if step == 2:
            g[:4] = [448.0, 464.0, 465.0, -1e4]   # past fp8's range: NaN
        wj = np.asarray(j.compress("k", jnp.asarray(g)).astype(jnp.float32))
        wt = t.compress("k", torch.from_numpy(g))
        assert wt.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(wt.float().numpy(), wj)
        np.testing.assert_array_equal(t._residuals["k"].numpy(),
                                      np.asarray(j._residuals["k"]))


@pytest.mark.parametrize("params", [
    None, {"type": "none"}, {"type": "2bit", "threshold": 0.25},
    {"type": "fp8"}, {"type": "1bit"}, {"type": "2bit", "threshold": 0}])
def test_compression_create_like_jax(params):
    try:
        ref = jax_gc_create(params)
    except jmx.base.MXNetError:
        with pytest.raises(MXNetError):
            gc_create(params)
        return
    got = gc_create(params)
    if ref is None:
        assert got is None
    else:
        assert (got.type, got.threshold) == (ref.type, ref.threshold)


@pytest.mark.parametrize("kw", [
    dict(dp=8), dict(dp=2, tp=4), dict(dp=2, sp=4), dict(tp=2, pp=2, dp=2),
    dict(ep=4, dp=2), dict(sp=2, ep=2, tp=2), dict()])
def test_make_mesh_axis_order_matches_jax(kw):
    import jax
    names, shape = mesh_layout(**kw)
    n = int(np.prod(shape))
    ref = jmx.parallel.make_mesh(devices=jax.devices()[:n], **kw)
    assert names == ref.axis_names
    assert dict(zip(names, shape)) == ref.shape


def test_mesh_refusals_match_jax():
    import jax
    with pytest.raises(jmx.base.MXNetError, match="does not cover"):
        jmx.parallel.make_mesh(dp=3, devices=jax.devices())
    # one process, no process group: a world of 1
    with pytest.raises(MXNetError, match="does not cover 1 devices"):
        tmx.parallel.make_mesh(dp=2, device="cpu")
    with pytest.raises(MXNetError, match="covers the world"):
        tmx.parallel.DeviceMesh(("dp",), devices=[0, 1], shape=(2,),
                                device="cpu")
    jmesh = jmx.parallel.make_mesh(dp=1, devices=jax.devices()[:1])
    tmesh = tmx.parallel.make_mesh(dp=1, device="cpu")
    for mesh, err in ((jmesh, jmx.base.MXNetError), (tmesh, MXNetError)):
        with pytest.raises(err, match="unknown mesh axis"):
            mesh.sharding("tpp")
    # a portable axis the mesh lacks replicates
    assert tmesh.sharding(None, "tp").spec == ()
    assert tmesh.sharding("dp").spec == ("dp",)
    with tmesh:
        assert tmx.parallel.current_mesh() is tmesh
        assert tmx.kv.create("tpu").mesh is tmesh
    assert tmx.parallel.current_mesh() is None


def _mlp(mx, p):
    net = mx.gluon.nn.HybridSequential(prefix="kvmlp_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(5, activation="relu", in_units=4))
        net.add(mx.gluon.nn.Dense(3, in_units=5))
    net.initialize()
    for name, prm in net.collect_params().items():
        prm.set_data(mx.nd.array(p[name]))
    return net


def _trainer_run(mx, p, x, y, kvstore, steps=2, fname=None, **kw):
    net = _mlp(mx, p)
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9},
                               kvstore=kvstore, **kw)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        if fname is not None and i == 0:
            trainer.save_states(fname)
            trainer.load_states(fname)
    return ({n: prm.data().asnumpy() for n, prm in params.items()},
            trainer._update_on_kvstore,
            type(trainer._kvstore).__name__ if trainer._kvstore else None)


@pytest.mark.parametrize("kvstore,kw", [
    ("device", {}), ("local", {"update_on_kvstore": True}), ("nccl", {}),
    ("dist_sync", {}), ("tpu", {"update_on_kvstore": False}),
    ("local", {"update_on_kvstore": True,
               "compression_params": {"type": "2bit", "threshold": 0.05}}),
    ("dist_sync", {"compression_params": {"type": "fp8"}}), (None, {})])
def test_trainer_store_routes_match_jax(kvstore, kw, tmp_path):
    """Two steps through each store route (and the states saved and
    loaded through it after the first), against the JAX Trainer: the
    parameters, whether the store updates, and which store is kept."""
    rs = np.random.RandomState(2)
    p = {"kvmlp_dense0_weight": rs.randn(5, 4).astype(np.float32),
         "kvmlp_dense0_bias": rs.randn(5).astype(np.float32),
         "kvmlp_dense1_weight": rs.randn(3, 5).astype(np.float32),
         "kvmlp_dense1_bias": rs.randn(3).astype(np.float32)}
    x, y = rs.randn(6, 4).astype(np.float32), \
        rs.randint(0, 3, 6).astype(np.float32)
    ref = _trainer_run(jmx, p, x, y, kvstore,
                       fname=str(tmp_path / "j.states"), **kw)
    with tmx.cpu():
        got = _trainer_run(tmx, p, x, y, kvstore,
                           fname=str(tmp_path / "t.states"), **kw)
    assert got[1:] == ref[1:]
    for name, want in ref[0].items():
        np.testing.assert_allclose(got[0][name], want, atol=1e-5, rtol=1e-5)
