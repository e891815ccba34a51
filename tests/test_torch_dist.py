"""The port's data parallelism in a two-rank gloo world on the CPU,
against the JAX package and numpy's rules.

A module fixture starts the world once: ``tools/launch.py -n 2`` runs
``tests/torch_dist_worker.py`` on a free port, while this process runs
the JAX side.  In that world:

* the ``dist_sync`` invariants of ``tests/dist/dist_sync_kvstore.py``
  (init from rank 0, the push's mean over the ranks, the updater on the
  merged value, a list push summed first) against numpy's mean rule;
  ``dist_device_sync`` and ``dist_async``; the compressed push (2-bit
  and fp8, two pushes, so the residual carries) against the mean of the
  JAX ``GradientCompression.roundtrip`` of each rank's gradient, and its
  wire bytes; the heartbeats and ``get_num_dead_node``;
* ``TrainStep(mesh=make_mesh(dp=2))`` for 3 steps (SGD 0.1 / 0.9 / 1e-4)
  on a small ResNet V1 (``tests/test_torch_train.py``'s, b=4 at 16x16:
  2 a rank) in the plain mode (``fuse_block=False``), the
  ``fuse_bn_relu`` mode (``fuse_bn_relu=True`` with ``fuse_block=True``:
  ``BNReLU`` and the fused BN -> ReLU -> conv op) and the ``chain``
  mode, against the JAX ``TrainStep(mesh=make_mesh(dp=2))`` on two of
  conftest's virtual devices: parameters, momenta and moving statistics
  within 1e-5 of each tensor's max |value| plus 1e-6 (the floor for the
  conv biases that feed a BatchNorm, whose gradient is 0 in exact
  arithmetic), the losses within 1e-5 relative; the ranks bit-equal to
  each other after every step.  Rank 1 starts from other weights: the
  step's broadcast must replace them.  The same plain run with the BN
  statistics left per rank misses that gate (the gate can fail);
* ``gluon.Trainer(kvstore="dist_sync")`` against numpy's SGD on the
  mean of the ranks' gradients; with 2-bit compression on the mean of
  numpy's 2-bit roundtrips of them, and its wire bytes 1/16 of the
  fp32 bytes; the ``"tpu"`` store's ``allreduce_grads`` against numpy's mean;
  ``Module.fit(kvstore="dist_sync")`` against the JAX Module on the
  global batches; ``DevicePrefetchIter(sharding=...)`` staging each
  rank's slice for a mesh step.

The worker runs each rank single-threaded (~10 s for the whole world).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.gluon.model_zoo.vision import (
    BottleneckV1 as JaxBottleneckV1, ResNetV1 as JaxResNetV1)
from incubator_mxnet_tpu.parallel.compression import (
    GradientCompression as JaxGC)
from incubator_mxnet_tpu_torch.convert import (resnet_params_from_numpy,
                                               resnet_params_to_numpy)
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                              ResNetV1)
import torch_dist_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = (4, 16, 16, 3)
SGD_KW = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-5, 1e-6, 1e-5
MODES = list(worker.MODES)
WORLD_TIMEOUT_S = 240


def _inputs():
    rs = np.random.RandomState(1)
    f = np.float32
    return {
        "x": rs.rand(*BATCH).astype(f),
        "y": rs.randint(0, worker.NET["classes"], BATCH[0]).astype(f),
        "compress_grads": [[rs.randn(37).astype(f) for _ in range(2)]
                           for _ in range(2)],
        "mlp_params": {
            "mlp_dense0_weight": (0.3 * rs.randn(16, 8)).astype(f),
            "mlp_dense0_bias": (0.1 * rs.randn(16)).astype(f),
            "mlp_dense1_weight": (0.3 * rs.randn(4, 16)).astype(f),
            "mlp_dense1_bias": (0.1 * rs.randn(4)).astype(f)},
        "mlp_x": rs.randn(8, 8).astype(f),
        "mlp_y": rs.randint(0, 4, 8).astype(f),
        "mod_x": rs.randn(32, 8).astype(f),
        "mod_y": rs.randint(0, 4, 32).astype(f),
        "mod_batch": 8,
        "mod_params": {"fc1_weight": (0.3 * rs.randn(16, 8)).astype(f),
                       "fc1_bias": np.zeros(16, f),
                       "fc2_weight": (0.3 * rs.randn(4, 16)).astype(f),
                       "fc2_bias": np.zeros(4, f)}}


def _nets(mode):
    """The port's seeded small ResNet V1 in ``mode`` (its state_dict) and
    the JAX net of the same structure holding the same values (set by
    name: no eager forward to fix the deferred shapes)."""
    net = ResNetV1(BottleneckV1, *worker.SPEC, device="cpu", seed=3,
                   **worker.MODES[mode], **worker.NET)
    named = resnet_params_to_numpy(net.state_dict(), prefix="resnet_")
    jmx.random.seed(0)
    jnet = JaxResNetV1(JaxBottleneckV1, *worker.SPEC, prefix="resnet_",
                       **worker.MODES[mode], **worker.NET)
    jnet.initialize()
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(named[name]))
    return net.state_dict(), jnet


def _named(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


def _jax_train(jnet, x, y, grad_accum=1):
    """3 steps of the JAX TrainStep on a dp=2 mesh of two virtual
    devices: (losses, final port state, momenta by port name)."""
    import jax
    mesh = jax_parallel.make_mesh(dp=2, devices=jax.devices()[:2])
    step = jax_parallel.TrainStep(
        jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(),
        jmx.optimizer.SGD(**SGD_KW), mesh=mesh, grad_accum=grad_accum)
    losses = [float(step(jmx.nd.array(x), jmx.nd.array(y)).asscalar())
              for _ in range(3)]
    step.sync_params()
    named = _named(jnet)
    final = resnet_params_from_numpy(named)
    # a momentum in each parameter's place (the statistics keep theirs,
    # and are not compared)
    moms = dict(named)
    for name, states in zip(step._pnames, step._carry[1]):
        if states:
            moms[name] = np.asarray(states[0])
    return losses, final, resnet_params_from_numpy(moms)


def _jax_module(inputs):
    """The JAX Module's fit over the global batches (one epoch)."""
    data = jmx.sym.var("data")
    h = jmx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    h = jmx.sym.Activation(h, name="relu1", act_type="relu")
    h = jmx.sym.FullyConnected(h, name="fc2", num_hidden=4)
    sym = jmx.sym.SoftmaxOutput(h, name="softmax")
    it = jmx.io.NDArrayIter(inputs["mod_x"], inputs["mod_y"],
                            batch_size=inputs["mod_batch"])
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.fit(it, num_epoch=1, kvstore="local", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: jmx.nd.array(v)
                        for k, v in inputs["mod_params"].items()},
            aux_params={}, eval_metric="acc")
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' results and the JAX side's, from one launch."""
    outdir = str(tmp_path_factory.mktemp("dist_world"))
    inputs = _inputs()
    inputs["init"], jnets = {}, {}
    for m in MODES:
        inputs["init"][m], jnets[m] = _nets(m)
    torch.save(inputs, os.path.join(outdir, "inputs.pt"))
    env = dict(os.environ, MXNET_KVSTORE_HEARTBEAT_INTERVAL="0.2",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         "2", "--", sys.executable,
         os.path.join(ROOT, "tests", "torch_dist_worker.py"), outdir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        ref = {"train": {m: _jax_train(jnets[m], inputs["x"], inputs["y"])
                         for m in MODES},
               "module": _jax_module(inputs)}
        ref["train"]["plain_accum2"] = _jax_train(
            _nets("plain")[1], inputs["x"], inputs["y"], grad_accum=2)
        log, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    return inputs, ranks, ref


def _close_state(got, ref, keys=None):
    """The worst ``|got - ref|`` in units of STEP_RTOL of the tensor's
    max |value| plus STEP_ATOL, and its key."""
    worst = (0.0, None)
    for key in (ref.keys() if keys is None else keys):
        r = ref[key].detach().numpy() if isinstance(ref[key], torch.Tensor) \
            else np.asarray(ref[key])
        err = float(np.abs(np.asarray(got[key]) - r).max())
        ratio = err / (STEP_RTOL * float(np.abs(r).max()) + STEP_ATOL)
        worst = max(worst, (ratio, key))
    return worst


# ------------------------------------------------------------- kvstore
def test_dist_sync_identity_and_init_from_rank0(world):
    _, ranks, _ = world
    for r, out in enumerate(ranks):
        kv = out["kvstore"]
        assert kv["rank_world"] == (r, 2, "dist_sync")
        np.testing.assert_array_equal(kv["init"], np.full((3, 4), 7.0))


@pytest.mark.parametrize("key,shape,value", [
    ("w", (3, 4), lambda r: np.ones((3, 4)) * (r + 1)),
    ("big", (1000,), lambda r: np.arange(1000) * (r + 1)),
    ("g", (2,), lambda r: 2 * np.ones(2) * (r + 1))])
def test_dist_sync_push_is_the_mean_over_ranks(world, key, shape, value):
    """A push replaces the value by the mean over the ranks of each
    rank's (locally summed) push: numpy's mean rule."""
    _, ranks, _ = world
    want = np.mean([value(r) for r in range(2)], axis=0)
    for out in ranks:
        np.testing.assert_allclose(out["kvstore"][key], want, rtol=1e-6)


def test_dist_sync_updater_runs_on_the_merged_push(world):
    _, ranks, _ = world
    for out in ranks:
        np.testing.assert_allclose(out["kvstore"]["u"],
                                   np.full(5, 10 - 0.1 * 1.5), rtol=1e-6)


def test_dist_types_and_wire_bytes(world):
    _, ranks, _ = world
    for out in ranks:
        kv = out["kvstore"]
        assert kv["types"] == [("dist_device_sync", 2), ("dist_async", 2)]
        # fp32 bytes of w, big, u and g
        assert kv["wire_plain"] == 4 * (12 + 1000 + 5 + 2)
        # 37 values a push, two pushes: 2-bit packs 4 to a byte, fp8 is 1
        assert kv["wire_2bit"] == 2 * 10 and kv["wire_fp8"] == 2 * 37


@pytest.mark.parametrize("ctype", ["2bit", "fp8"])
def test_compressed_push_is_the_mean_of_jax_roundtrips(world, ctype):
    """Each rank's codec (its own residual) as the JAX package's: the
    pulled value after each push is the mean over the ranks of JAX's
    ``roundtrip`` of that rank's gradient."""
    inputs, ranks, _ = world
    import jax.numpy as jnp
    codecs = [JaxGC(ctype, 0.5) for _ in range(2)]
    for i in range(2):
        parts = [np.asarray(codecs[r].roundtrip(
            "c", jnp.asarray(inputs["compress_grads"][r][i])))
            for r in range(2)]
        want = np.mean(parts, axis=0)
        for out in ranks:
            got = out["kvstore"][f"compressed_{ctype}"][i]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_heartbeats_and_dead_nodes(world):
    _, ranks, _ = world
    for r, out in enumerate(ranks):
        kv = out["kvstore"]
        assert kv["ages"][r] == 0.0
        assert 0.0 < kv["ages"][1 - r] < 30.0
        assert kv["live"] == [0, 1]
        assert kv["dead_60"] == 0
        assert kv["dead_0"] == 1


# ------------------------------------------------------- TrainStep(mesh)
@pytest.mark.parametrize("mode", MODES + ["plain_accum2"])
def test_mesh_train_step_matches_jax_dp2(world, mode):
    """Parameters and moving statistics after 3 steps, the losses, and
    the momenta against the JAX step on a dp=2 mesh."""
    _, ranks, ref = world
    ref_losses, ref_final, ref_moms = ref["train"][mode]
    run = ranks[0]["train"][mode]
    np.testing.assert_allclose(run["losses"], ref_losses, rtol=LOSS_RTOL)
    worst = _close_state(run["state"][-1], ref_final)
    assert worst[0] <= 1.0, worst
    worst = _close_state(run["momenta"], ref_moms, keys=run["momenta"])
    assert worst[0] <= 1.0, worst


@pytest.mark.parametrize("mode", MODES + ["plain_accum2", "plain_nosync"])
def test_mesh_ranks_bit_equal_after_every_step(world, mode):
    """The ranks hold the same parameters after every step (the momenta
    too); with per-rank BN statistics the moving statistics part."""
    _, ranks, _ = world
    a, b = ranks[0]["train"][mode], ranks[1]["train"][mode]
    assert a["losses"] == b["losses"] or mode == "plain_nosync"
    for sa, sb in zip(a["state"], b["state"]):
        for key in sa:
            same = np.array_equal(sa[key], sb[key])
            if mode == "plain_nosync" and key.endswith(("running_mean",
                                                        "running_var")):
                continue
            assert same, (mode, key)
    if mode == "plain_nosync":
        assert not all(np.array_equal(a["state"][0][k], b["state"][0][k])
                       for k in a["state"][0] if k.endswith("running_mean"))
    for key in a["momenta"]:
        assert np.array_equal(a["momenta"][key], b["momenta"][key]), key


def test_per_rank_bn_statistics_miss_the_gate(world):
    """The fault the BN all-reduce prevents: the plain run with each
    rank's own statistics is far outside the gate the synced run meets."""
    _, ranks, ref = world
    worst = _close_state(ranks[0]["train"]["plain_nosync"]["state"][-1],
                         ref["train"]["plain"][1])
    assert worst[0] > 100.0, worst


def test_mesh_grad_accum_takes_the_global_microbatches(world):
    """With grad_accum=2 a rank's slice is its half of each global
    microbatch (rows 0-1, then 2-3), as JAX's split_microbatches cuts
    the global batch: rank r holds rows r and 2 + r."""
    inputs, ranks, _ = world
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["train"]["accum_slice"],
                                      inputs["x"][[r, 2 + r]])


def test_mesh_eval_step_returns_the_global_output(world):
    """EvalStep(mesh=) on each rank: the whole batch's output (both
    ranks' slices gathered), equal to one process's EvalStep of the
    same net within 1e-6 of max |logit|."""
    _, ranks, _ = world
    for out in ranks:
        got, want = out["train"]["eval"]
        assert got.shape == want.shape == (4, worker.NET["classes"])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(ranks[0]["train"]["eval"][0],
                                  ranks[1]["train"]["eval"][0])


def test_mesh_refuses_a_tensor_parallel_axis(world):
    """A tp mesh of 4 in a world of 2 ranks: a mesh covers the world."""
    _, ranks, _ = world
    for out in ranks:
        assert "mesh shape (4,) does not cover 2 devices" in \
            out["train"]["tp_refusal"]


# ------------------------------------------- Trainer, Module, prefetch
@pytest.mark.parametrize("key", ["plain", "tpu_update"])
def test_trainer_dist_sync_is_sgd_on_the_mean_gradient(world, key):
    """Two ranks, each stepping on its half: SGD (numpy) on the mean of
    the ranks' gradients scaled by 1/half, which is the global batch's
    scaled by 1/8, step after step; the store updates
    (``update_on_kvstore`` defaults to True for a dist store, and for
    the ``"tpu"`` store of a dp=2 mesh, ``tpu_update``)."""
    inputs, ranks, _ = world
    half = inputs["mlp_x"].shape[0] // 2
    w = dict(inputs["mlp_params"])
    for t in range(2):
        for name in w:
            g = np.mean([o["trainer"][key]["grads"][t][name]
                         for o in ranks], axis=0)
            w[name] = w[name] - 0.1 * (g / half)
        for out in ranks:
            assert out["trainer"][key]["update_on_kvstore"] is True
            for name in w:
                np.testing.assert_allclose(
                    out["trainer"][key]["steps"][t][name], w[name],
                    rtol=1e-6, atol=1e-7)


class _TwoBit:
    """numpy's 2-bit rule with error feedback: r = residual + g maps to
    +t (r >= t), -t (r <= -t) or 0, and r minus that is kept."""

    def __init__(self, t=0.5):
        self.t, self.res = t, {}

    def roundtrip(self, key, g):
        r = self.res.get(key, 0) + g
        q = np.where(r >= self.t, self.t,
                     np.where(r <= -self.t, -self.t, 0.0)).astype(g.dtype)
        self.res[key] = r - q
        return q


def test_trainer_2bit_follows_the_codec_and_sends_a_sixteenth(world):
    """SGD on the mean of the ranks' 2-bit roundtrips (numpy's rule,
    each rank its own residual), step after step; 1/16 of the fp32
    bytes on the wire."""
    inputs, ranks, _ = world
    half = inputs["mlp_x"].shape[0] // 2
    codecs = [_TwoBit() for _ in range(2)]
    w = dict(inputs["mlp_params"])
    for t in range(2):
        for name in w:
            q = [codecs[r].roundtrip(
                name, ranks[r]["trainer"]["2bit"]["grads"][t][name])
                for r in range(2)]
            w[name] = w[name] - 0.1 * (np.mean(q, axis=0) / half)
        for out in ranks:
            for name in w:
                np.testing.assert_allclose(
                    out["trainer"]["2bit"]["steps"][t][name], w[name],
                    rtol=1e-6, atol=1e-7)
    fp32 = ranks[0]["trainer"]["plain"]["wire"]
    assert fp32 == 2 * 4 * sum(v.size for v in inputs["mlp_params"].values())
    for out in ranks:
        assert out["trainer"]["2bit"]["wire"] * 16 == fp32


def test_trainer_tpu_store_allreduce_grads_averages(world):
    _, ranks, _ = world
    for out in ranks:
        tpu = out["trainer"]["tpu"]
        assert tpu["workers"] == 2
        for name in tpu["after"]:
            want = np.mean([o["trainer"]["tpu"]["before"][name]
                            for o in ranks], axis=0)
            np.testing.assert_allclose(tpu["after"][name], want, rtol=1e-6)


def test_tpu_store_without_a_mesh_refuses_a_world_of_two(world):
    """With no mesh each rank would keep its own gradient: refused."""
    _, ranks, _ = world
    for out in ranks:
        assert "world of 2 ranks needs a mesh" in out["trainer"]["tpu_no_mesh"]


def test_module_fit_dist_sync_matches_jax_global_batches(world):
    _, ranks, ref = world
    for out in ranks:
        for name, want in ref["module"].items():
            np.testing.assert_allclose(out["module"][name], want,
                                       rtol=1e-5, atol=1e-6)


def test_sharded_prefetch_feeds_the_rank_slice(world):
    inputs, ranks, _ = world
    for r, out in enumerate(ranks):
        pf = out["prefetch"]
        np.testing.assert_array_equal(pf["slice"],
                                      inputs["x"][2 * r:2 * r + 2])
        assert pf["fastpath"] == 1
        assert pf["losses"][0] == pf["losses"][1]
        assert pf["same_state"]


def test_prefetch_from_a_source_cut_per_rank(world):
    """A source that reads only the rank's part (num_parts=2,
    part_index=rank) is staged as it is and steps as the global batch
    does; a step that cuts another way (grad_accum=2) refuses the slice,
    and a source reading another rank's part is refused."""
    inputs, ranks, _ = world
    for r, out in enumerate(ranks):
        src = out["prefetch"]["source"]
        np.testing.assert_array_equal(src["slice"],
                                      inputs["x"][2 * r:2 * r + 2])
        assert src["fastpath"] == 1
        assert src["loss"] == out["prefetch"]["losses"][1]
        assert src["same_state"]
        refusal, wrong_part = out["prefetch"]["refusals"]
        assert "step.sharding" in refusal
        assert f"part {1 - r} of 2" in wrong_part
