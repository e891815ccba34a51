"""The port's model parallelism against the JAX package: the
tensor-parallel layers, ring and Ulysses attention, and a four-rank gloo
world on the CPU in which the small transformer LMs of
``tests/torch_mp_models.py`` train on tp, sp, ep and pp meshes.

A module fixture starts the world once: ``tools/launch.py -n 4`` runs
``tests/torch_mp_worker.py`` on a free port, while this process runs
the JAX side on conftest's virtual devices.  On each of the meshes
``dp2 x tp2``, ``dp2 x sp2`` (Ulysses, then ring attention),
``dp2 x ep2`` (the MoE LM) and ``tp2 x pp2`` (the pipelined LM with its
embedding and head split over ``pp``), the LM (d=32, 4 heads, vocab 64,
T=16, depth 2, b=4) takes 2 steps of SGD (lr 0.1, momentum 0.9) from
the same weights (moved through ``convert``) against the JAX
``TrainStep`` on the same mesh: parameters and momenta within 1e-5 of
each tensor's max |value| plus 1e-6 after the steps, the losses within
1e-5 relative.  The ranks are bit-equal on every replicated parameter,
and each holds its 1/axis block of each sharded one.  ``moe_ffn_alltoall``
on ``ep=4`` is held to the JAX function forward and to ``jax.grad`` of
JAX's ``moe_ffn`` (with no token dropped the two are one function)
backward.  The world takes ~10 s; the JAX side ~30 s.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.ndarray.ndarray import _invoke_fn
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import parallel
from incubator_mxnet_tpu_torch.convert import gluon_params_to_numpy
from incubator_mxnet_tpu_torch.ops import collective
from incubator_mxnet_tpu_torch.predict import BlockPredictor
import torch_mp_worker as worker
from torch_mp_models import lm_classes, markov_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-5, 1e-6, 1e-5
MESHES = list(worker.MESHES)
WORLD_TIMEOUT_S = 240
AXIS_OF = {"dp2_tp2": "tp", "dp2_ep2": "ep"}


def _japply(fn, x):
    return _invoke_fn(fn, [x], name="attention")


def _jattend(kind, mesh):
    if kind == "flash":
        return lambda q, k, v: jax_parallel.attention(q, k, v, causal=True)
    if kind == "ulysses":
        return lambda q, k, v: jax_parallel.ulysses_attention_sharded(
            q, k, v, mesh, causal=True)
    return lambda q, k, v: jax_parallel.ring_attention_sharded(
        q, k, v, mesh, causal=True)


def _inputs():
    rs = np.random.RandomState(0)
    mx.random.seed(7)
    init = {}
    for kind in ("mlp", "moe", "pp"):
        with mx.cpu():
            net = worker.build_lm(mx, worker.port_apply, None, kind)
            net.initialize(init=mx.init.Xavier(), ctx=mx.cpu())
        init[kind] = gluon_params_to_numpy(net)
    x, y = markov_batch(rs, worker.BATCH, worker.SIZES["seq_len"],
                        worker.SIZES["vocab"])
    u = worker.UNEVEN
    with mx.cpu():
        net = worker.build_uneven(mx)
        net.initialize(init=mx.init.Xavier(), ctx=mx.cpu())
        net(mx.nd.zeros((1, u["tokens"])))
    uneven = {"init": gluon_params_to_numpy(net),
              "ids": rs.randint(0, u["vocab"], (2, u["tokens"])).astype(
                  np.float32),
              "y": rs.randn(2, u["tokens"], 3).astype(np.float32)}
    a = worker.A2A
    f = np.float32
    a2a = {"x": rs.randn(a["tokens"], a["dim"]).astype(f),
           "gate_w": rs.randn(a["dim"], a["experts"]).astype(f),
           "w1": (0.3 * rs.randn(a["experts"], a["dim"], a["hidden"])
                  ).astype(f),
           "b1": (0.1 * rs.randn(a["experts"], a["hidden"])).astype(f),
           "w2": (0.3 * rs.randn(a["experts"], a["hidden"], a["dim"])
                  ).astype(f),
           "b2": (0.1 * rs.randn(a["experts"], a["dim"])).astype(f),
           "cot": rs.randn(a["tokens"], a["dim"]).astype(f)}
    return {"init": init, "x": x, "y": y, "a2a": a2a, "uneven": uneven}


def _jax_train(name, inputs):
    """2 steps of the JAX TrainStep on the mesh of ``name`` over four
    virtual devices: (losses, final params, momenta) by name."""
    import jax
    axes, attn, kind = worker.MESHES[name]
    mesh = jax_parallel.make_mesh(**axes, devices=jax.devices()[:4])
    with mesh:
        net = worker.build_lm(jmx, _japply, _jattend(attn, mesh), kind)
        net.initialize()
        for n, p in net.collect_params().items():
            p.set_data(jmx.nd.array(inputs["init"][kind][n]))
        step = jax_parallel.TrainStep(
            net, lm_classes(jmx, _japply)["FlatLoss"](worker.SIZES["vocab"]),
            jmx.optimizer.SGD(**worker.SGD_KW), mesh=mesh)
        losses = [float(step(jmx.nd.array(inputs["x"]),
                             jmx.nd.array(inputs["y"])).asscalar())
                  for _ in range(worker.STEPS)]
        step.sync_params()
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    moms = {n: np.asarray(s) for n, s in zip(step._pnames, step._carry[1])}
    return losses, params, moms


def _jax_alltoall(inputs):
    """JAX's moe_ffn_alltoall on ep=4 (forward), and the gradients of
    (y * cot).sum() + aux through JAX's moe_ffn with room for every
    token (the same function)."""
    import jax
    import jax.numpy as jnp
    from incubator_mxnet_tpu.parallel.moe import moe_ffn
    a = {k: jnp.asarray(v) for k, v in inputs["a2a"].items()}
    names = ("x", "gate_w", "w1", "b1", "w2", "b2")
    mesh = jax_parallel.make_mesh(ep=4, devices=jax.devices()[:4])
    y, aux = jax_parallel.moe_ffn_alltoall(*[a[k] for k in names], mesh,
                                           top_k=2)

    def loss(*args):
        yy, au = moe_ffn(*args, top_k=2,
                         capacity=worker.A2A["tokens"])
        return (yy * a["cot"]).sum() + au

    grads = jax.grad(loss, argnums=tuple(range(6)))(*[a[k] for k in names])
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results and the JAX side's, from one launch."""
    outdir = str(tmp_path_factory.mktemp("mp_world"))
    inputs = _inputs()
    torch.save(inputs, os.path.join(outdir, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         "4", "--", sys.executable,
         os.path.join(ROOT, "tests", "torch_mp_worker.py"), outdir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        ref = {name: _jax_train(name, inputs) for name in MESHES}
        ref["alltoall"] = _jax_alltoall(inputs)
        log, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    return inputs, ranks, ref, outdir


def _worst(got, ref):
    """The worst |got - ref| in units of STEP_RTOL of the tensor's max
    |value| plus STEP_ATOL, and its name."""
    return max((float(np.abs(np.asarray(got[k]) - r).max()) /
                (STEP_RTOL * float(np.abs(r).max()) + STEP_ATOL), k)
               for k, r in ref.items())


# ------------------------------------------------------ the mesh steps
@pytest.mark.parametrize("name", MESHES)
def test_mesh_train_step_matches_jax(world, name):
    """Losses, parameters and momenta after 2 steps against the JAX
    step on the same mesh."""
    _, ranks, ref, _ = world
    losses, params, moms = ref[name]
    run = ranks[0][name]
    np.testing.assert_allclose(run["losses"], losses, rtol=LOSS_RTOL)
    assert set(run["params"]) == set(params)
    worst = _worst(run["params"], params)
    assert worst[0] <= 1.0, worst
    worst = _worst(run["states"], moms)
    assert worst[0] <= 1.0, worst


@pytest.mark.parametrize("name", MESHES)
def test_mesh_ranks_bit_equal_on_replicated_params(world, name):
    """Every rank holds the same value of every parameter no axis
    splits, and the same losses."""
    _, ranks, _, _ = world
    first = ranks[0][name]
    replicated = [n for n, cut in first["cut"].items() if not cut]
    assert replicated
    for other in ranks[1:]:
        run = other[name]
        assert run["losses"] == first["losses"]
        for n in replicated:
            assert np.array_equal(run["local"][n], first["local"][n]), n


@pytest.mark.parametrize("name", ["dp2_tp2", "dp2_ep2"])
def test_mesh_sharded_params_hold_their_block(world, name):
    """Each cut parameter holds 1/axis of its bytes on each rank: its
    block of the global value; the layers' declared axis is cut."""
    _, ranks, _, _ = world
    run0 = ranks[0][name]
    cut = sorted(n for n, c in run0["cut"].items() if c)
    assert cut
    axis = AXIS_OF[name]
    if axis == "tp":
        assert any("columnparalleldense" in n for n in cut)
        assert any("shardedembedding" in n for n in cut)
    else:
        assert all("moelayer" in n and "expert" in n for n in cut)
    for n in cut:
        full = run0["params"][n]
        blocks = [r[name]["local"][n] for r in ranks]
        for b in blocks:
            assert b.nbytes * 2 == full.nbytes, (n, b.shape, full.shape)
        assert any(np.array_equal(b, full[:b.shape[0]]) or
                   np.array_equal(b, full[..., :b.shape[-1]])
                   for b in blocks), n


def test_sp_meshes_cut_nothing(world):
    """On a dp x sp mesh nothing is split (the layers declare tp and
    ep, which the mesh lacks, so they replicate)."""
    _, ranks, _, _ = world
    for name in ("dp2_sp2_ulysses", "dp2_sp2_ring"):
        assert not any(ranks[0][name]["cut"].values())


def test_pp_mesh_splits_embedding_head_and_stages(world):
    """tp2 x pp2: the embedding and head are split over pp, each stacked
    stage parameter over pp (and its tp dim over tp)."""
    _, ranks, _, _ = world
    run = ranks[0]["tp2_pp2"]
    cut = {n for n, c in run["cut"].items() if c}
    assert "lm_shardedembedding0_weight" in cut
    assert "lm_columnparalleldense0_weight" in cut
    stacked = [n for n in run["params"] if "pipelinestack" in n]
    assert stacked and set(stacked) <= cut
    sizes = worker.MESHES["tp2_pp2"][0]
    for n in stacked:
        full = run["params"][n]
        local = run["local"][n]
        parts = int(np.prod([sizes.get(a, 1) for a in run["sharding"][n]
                             if a is not None]))
        assert run["sharding"][n][0] == "pp" and local.shape[0] == 1, n
        assert local.nbytes * parts == full.nbytes, n
    # the column/row FFN's weights are split over tp too: 1/4 a rank
    assert any(local.nbytes * 4 == run["params"][n].nbytes
               for n, local in run["local"].items() if n in stacked)


def test_cut_parameters_save_predict_and_set_global_arrays(world):
    """On dp2 x tp2: ``save_parameters`` on every rank writes the global
    arrays (loaded by a net with no mesh, they are the trained values),
    ``BlockPredictor(mesh=)`` gives every rank the global batch's logits,
    and ``set_data`` of a global array keeps the rank's block."""
    inputs, ranks, _, outdir = world
    run = ranks[0]["dp2_tp2"]
    with mx.cpu():
        net = worker.build_lm(mx, worker.port_apply,
                              worker.port_attend("flash", None), "mlp")
    for r in range(4):
        net.load_parameters(os.path.join(outdir, f"saved{r}.params"),
                            ctx=mx.cpu())
        for n, p in net.collect_params().items():
            assert np.array_equal(p.data().asnumpy(), run["params"][n]), n
    # BlockPredictor(mesh=) on every rank: the whole batch's logits of
    # the trained net, as one process's predictor gives them
    want = BlockPredictor(net, device="cpu")(inputs["x"]).numpy()
    for rk in ranks:
        got = rk["dp2_tp2"]["predicted"]
        assert got.shape == want.shape == (4, 16, 64)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    for r, rk in enumerate(ranks):
        local, doubled = rk["dp2_tp2"]["set_data"]
        rows = local.shape[0]
        tp_rank = r % 2
        assert rows * 2 == doubled.shape[0]
        np.testing.assert_array_equal(
            local, doubled[tp_rank * rows:(tp_rank + 1) * rows])


# ---------------------------------------------------------- alltoall
def test_moe_ffn_alltoall_matches_jax(world):
    _, ranks, ref, _ = world
    y, aux, grads = ref["alltoall"]
    for r in ranks:
        got = r["alltoall"]
        np.testing.assert_allclose(got["y"], y, rtol=0,
                                   atol=STEP_RTOL * np.abs(y).max())
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-6)
        for g, want in zip(got["grads"], grads):
            np.testing.assert_allclose(
                g, want, rtol=0,
                atol=STEP_RTOL * np.abs(want).max() + STEP_ATOL)


# ------------------------------------------- sizes tp=4 does not divide
def test_c19_empty_blocks_train_as_one_process(world):
    """C19: ShardedEmbedding(5) and ColumnParallelDense(5) over tp=4 cut
    in blocks of 2, 2, 1 and 0 rows; the rank with an empty block still
    joins every collective (before the repair its lookup raised while
    the others waited in the all-reduce).  After two SGD steps each
    rank's global parameters equal one process's steps."""
    inputs, ranks, _, _ = world
    u = inputs["uneven"]
    from incubator_mxnet_tpu_torch.convert import gluon_params_from_numpy
    with mx.cpu():
        net = worker.build_uneven(mx)
        gluon_params_from_numpy(net, u["init"], ctx=mx.cpu())
    step = parallel.TrainStep(net, mx.gluon.loss.L2Loss(),
                              mx.optimizer.SGD(**worker.SGD_KW),
                              device="cpu")
    for _ in range(worker.STEPS):
        step(u["ids"], u["y"])
    want = gluon_params_to_numpy(net)
    for r in ranks:
        got = r["uneven"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert not np.array_equal(w, u["init"][k]), k
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())


# --------------------------------------------------------- refusals
def test_hand_set_sharding_on_a_plain_layer_is_refused(world):
    _, ranks, _, _ = world
    for r in ranks:
        msg = r["refusals"]["hand_set"]
        assert msg and "plain_weight" in msg and "Dense" in msg, msg


def test_mesh_must_cover_the_world(world):
    _, ranks, _, _ = world
    for r in ranks:
        msg = r["refusals"]["tp_not_world"]
        assert msg and "does not cover 4 devices" in msg, msg


# ----------------------------------------------- one process, no mesh
def _jax_attention_case(rs, causal):
    q, k, v = (rs.randn(2, 4, 16, 8).astype(np.float32) for _ in range(3))
    import jax.numpy as jnp
    want = np.asarray(jax_parallel.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    return [torch.from_numpy(a) for a in (q, k, v)], want


@pytest.mark.parametrize("causal", [False, True])
def test_attention_and_degenerate_sharded_entry_points(causal):
    """``attention``, and the ring and Ulysses entry points on a mesh
    without ``sp`` (they run ``attention``), and the ring body on one
    shard, against JAX's ``attention``."""
    qkv, want = _jax_attention_case(np.random.RandomState(3), causal)
    mesh = parallel.make_mesh(dp=1, device="cpu")
    outs = [parallel.attention(*qkv, causal=causal),
            parallel.ring_attention_sharded(*qkv, mesh, causal=causal),
            parallel.make_ring_attention(mesh, causal=causal)(*qkv),
            parallel.ulysses_attention_sharded(*qkv, mesh, causal=causal),
            parallel.ulysses_attention_sharded(
                *qkv, mesh, causal=causal,
                attn_fn=parallel.flash_attention),
            parallel.ring_attention(*qkv, causal=causal)]
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ulysses_guards(world):
    """On an sp=2 mesh: 3 heads, or a sequence of 3, raise (JAX's
    guards)."""
    _, ranks, _, _ = world
    for r in ranks:
        heads, seq = r["refusals"]["ulysses"]
        assert "heads (3) divisible" in heads, heads
        assert "seq (3) not divisible" in seq, seq


def test_layers_without_a_mesh_are_the_plain_layers_bit_for_bit():
    """ColumnParallelDense, RowParallelDense and ShardedEmbedding with no
    mesh: the outputs and gradients of Dense and Embedding with the same
    weights, bit for bit; their sharding tuples are JAX's."""
    from incubator_mxnet_tpu_torch import autograd
    nn = mx.gluon.nn
    rs = np.random.RandomState(5)
    x = rs.randn(3, 5, 8).astype(np.float32)
    ids = rs.randint(0, 10, (3, 5)).astype(np.float32)
    pairs = [(parallel.ColumnParallelDense(6, in_units=8, flatten=False,
                                           activation="relu"),
              nn.Dense(6, in_units=8, flatten=False, activation="relu"), x),
             (parallel.RowParallelDense(6, in_units=8, flatten=False),
              nn.Dense(6, in_units=8, flatten=False), x),
             (parallel.RowParallelDense(6, in_units=40), nn.Dense(6,
                                                               in_units=40),
              x),
             (parallel.ShardedEmbedding(10, 4), nn.Embedding(10, 4), ids)]
    for par, plain, inp in pairs:
        with mx.cpu():
            par.initialize(ctx=mx.cpu())
            plain.initialize(ctx=mx.cpu())
        for p, q in zip(par.collect_params().values(),
                        plain.collect_params().values()):
            q.set_data(p.data())
        got = []
        for blk in (par, plain):
            xin = mx.nd.array(inp, ctx=mx.cpu())
            with autograd.record():
                out = blk(xin)
            out.backward()
            got.append([out.asnumpy()] + [p.grad().asnumpy() for p in
                                          blk.collect_params().values()])
        for a, b in zip(*got):
            assert np.array_equal(a, b)
    assert pairs[0][0].weight.sharding == ("tp", None)
    assert pairs[0][0].bias.sharding == ("tp",)
    assert pairs[1][0].weight.sharding == (None, "tp")
    assert pairs[3][0].weight.sharding == ("tp", None)
    assert parallel.ShardedEmbedding(10, 4, axis="pp").weight.sharding == \
        ("pp", None)


def test_the_jax_model_parallel_names_are_exported():
    names = ("ColumnParallelDense", "RowParallelDense", "ShardedEmbedding",
             "MoELayer", "moe_ffn", "moe_ffn_sharded", "moe_ffn_alltoall",
             "Pipeline", "PipelineStage", "PipelineStack", "pipeline_spmd",
             "pipeline_forward", "ulysses_attention",
             "ulysses_attention_sharded", "ring_attention",
             "ring_attention_sharded", "make_ring_attention")
    for name in names:
        assert name in jax_parallel.__all__
        assert name in parallel.__all__ and hasattr(parallel, name), name


def test_collective_routes_cover_each_backend_and_device():
    """The route table: NCCL and gloo on CPU tensors natively, gloo on
    CUDA tensors by the zeroed-buffer SUM form."""
    assert set(collective.ROUTES) == {("nccl", "cuda"), ("gloo", "cpu"),
                                      ("gloo", "cuda")}
    for routes in collective.ROUTES.values():
        assert set(routes) == {"all_gather", "all_to_all", "ppermute"}
    assert set(collective.ROUTES[("gloo", "cuda")].values()) == {"sum"}
    assert collective.block_range(50257, 2, 0) == (0, 25129)
    assert collective.block_range(50257, 2, 1) == (25129, 50257)


def test_parameter_sharding_defaults_and_jax_names():
    """Every parameter has ``sharding`` (None unless a layer sets it),
    as the JAX package's; the names the parallel layers give are
    JAX's."""
    with mx.cpu():
        net = worker.build_lm(mx, worker.port_apply, None, "moe")
    jnet = worker.build_lm(jmx, _japply, None, "moe")
    ours = {n: p.sharding for n, p in net.collect_params().items()}
    theirs = {n: p.sharding for n, p in jnet.collect_params().items()}
    assert ours == theirs
    assert ours["lm_pos"] is None
