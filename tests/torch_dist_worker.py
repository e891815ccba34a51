"""One rank of the port's two-rank CPU world, for tests/test_torch_dist.py.

Run under the launcher, which sets the ``DMLC_*`` rank variables:

    python tools/launch.py -n 2 -- python tests/torch_dist_worker.py DIR

It reads ``DIR/inputs.pt`` (written by the test: the seeded initial
states and batches) and writes what this rank computed to
``DIR/rank<r>.pt``; the test holds those against the JAX package and
numpy's rules.  It imports the port only (gloo, on the CPU).
"""
import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (  # noqa: E402
    BottleneckV1, ResNetV1)
from incubator_mxnet_tpu_torch.gluon.nn._modules import (  # noqa: E402
    SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.optimizer import SGD  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import (  # noqa: E402
    TrainStep, dist, make_mesh)


def _np(t):
    return t.detach().cpu().numpy().copy()


def kvstore_jobs(rank, world, inputs):
    """The dist_sync invariants of tests/dist/dist_sync_kvstore.py, the
    compressed pushes, the other dist types and the liveness queries."""
    out = {}
    kv = mx.kv.create("dist_sync")
    out["rank_world"] = (kv.rank, kv.num_workers, kv.type)
    with mx.cpu():
        nd = mx.nd
        # init takes rank 0's value
        kv.init("w", nd.ones((3, 4)) * (rank + 7))
        w = nd.zeros((3, 4))
        kv.pull("w", out=w)
        out["init"] = w.asnumpy()
        kv.barrier()
        kv.push("w", nd.ones((3, 4)) * (rank + 1))
        kv.pull("w", out=w)
        out["w"] = w.asnumpy()
        kv.init("big", nd.zeros((1000,)))
        kv.push("big", nd.arange(1000) * (rank + 1))
        big = nd.zeros((1000,))
        kv.pull("big", out=big)
        out["big"] = big.asnumpy()
        kv.init("u", nd.ones((5,)) * 10)
        kv.set_updater(lambda key, grad, weight: weight._write(
            (weight - 0.1 * grad)._data))
        kv.push("u", nd.ones((5,)) * (rank + 1))
        u = nd.zeros((5,))
        kv.pull("u", out=u)
        out["u"] = u.asnumpy()
        kv.set_updater(None)
        kv.init("g", nd.zeros((2,)))
        kv.push("g", [nd.ones((2,)) * (rank + 1), nd.ones((2,)) * (rank + 1)])
        g = nd.zeros((2,))
        kv.pull("g", out=g)
        out["g"] = g.asnumpy()
        out["wire_plain"] = kv.wire_bytes_pushed
        # compressed pushes of each rank's seeded gradients, twice (the
        # second carries the first's residual)
        for ctype in ("2bit", "fp8"):
            ckv = mx.kv.create("dist_sync")
            ckv.set_gradient_compression({"type": ctype, "threshold": 0.5})
            ckv.init("c", nd.zeros((37,)))
            got = []
            for grad in inputs["compress_grads"][rank]:
                ckv.push("c", nd.array(grad))
                c = nd.zeros((37,))
                ckv.pull("c", out=c)
                got.append(c.asnumpy())
            out[f"compressed_{ctype}"] = np.stack(got)
            out[f"wire_{ctype}"] = ckv.wire_bytes_pushed
    out["types"] = [(t, mx.kv.create(t).num_workers)
                    for t in ("dist_device_sync", "dist_async")]
    # liveness: both ranks posted at create; the thread beats every 0.2 s
    kv.barrier()
    time.sleep(0.5)
    ages = kv.last_heartbeats()
    out["ages"] = ages
    out["live"] = kv.live_workers(timeout=60.0)
    out["dead_60"] = kv.get_num_dead_node(timeout=60.0)
    out["dead_0"] = kv.get_num_dead_node(timeout=0.0)
    kv.barrier()
    return out


NET = dict(classes=10, thumbnail=True, layout="NHWC")
SPEC = ([1, 2, 1, 1], [16, 32, 64, 128, 256])
MODES = {"plain": dict(fuse_block=False),
         "fuse_bn_relu": dict(fuse_block=True, fuse_bn_relu=True),
         "chain": dict(fuse_block="chain")}


def _momenta(net, step):
    names = {id(p): n for n, p in net.named_parameters()}
    return {names[id(p)]: _np(s) for p, s in zip(step._params, step._states)
            if s is not None}


def train_jobs(rank, inputs):
    """TrainStep(mesh=make_mesh(dp=2)) for 3 steps in each mode on the
    global batch; the plain mode again with grad_accum=2, and with the
    BN sync taken out; EvalStep(mesh=) after the plain run; the refusal
    of a tp mesh whose size is not the world's."""
    from incubator_mxnet_tpu_torch.parallel import EvalStep
    out = {}
    mesh = make_mesh(dp=2, device="cpu")
    x, y = inputs["x"], inputs["y"]
    runs = [(m, m, True, 1) for m in MODES] + [
        ("plain_accum2", "plain", True, 2),
        ("plain_nosync", "plain", False, 1)]
    for key, mode, sync, accum in runs:
        net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **MODES[mode],
                       **NET)
        # rank 1 starts from other weights: the step's broadcast must
        # give it rank 0's
        state = inputs["init"][mode]
        if rank:
            state = {k: v + 1 for k, v in state.items()}
        net.load_state_dict(state)
        step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                         SGD(learning_rate=0.1, momentum=0.9, wd=1e-4),
                         mesh=mesh, grad_accum=accum)
        if not sync:
            step._bn_group = None
        losses, per_step = [], []
        for _ in range(3):
            losses.append(float(step(x, y)))
            per_step.append({k: _np(v) for k, v in net.state_dict().items()})
        out[key] = {"losses": losses, "state": per_step,
                    "momenta": _momenta(net, step)}
        if key == "plain":
            # every rank returns the global batch's output
            out["eval"] = (_np(EvalStep(net, mesh=mesh)(x)),
                           _np(EvalStep(net, device="cpu")(x)))
        if key == "plain_accum2":
            out["accum_slice"] = _np(step.sharding.local(torch.as_tensor(
                x)))
    try:
        TrainStep(ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET),
                  SoftmaxCrossEntropyLoss(), SGD(),
                  mesh=make_mesh(tp=4, device="cpu"))
        out["tp_refusal"] = None
    except mx.MXNetError as e:
        out["tp_refusal"] = str(e)
    return out


def _gluon_mlp(params):
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8))
            net.add(mx.gluon.nn.Dense(4, in_units=16))
        net.initialize()
        for name, p in net.collect_params().items():
            p.set_data(mx.nd.array(params[name]))
    return net


def trainer_jobs(rank, inputs):
    """gluon.Trainer over dist_sync, plain and 2-bit compressed, over the
    'tpu' store of a dp=2 mesh (updating on the store, its default), and
    the 'tpu' store's allreduce_grads; each rank steps on its half of
    the global batch."""
    out = {}
    x, y = inputs["mlp_x"], inputs["mlp_y"]
    half = x.shape[0] // 2
    xs, ys = x[rank * half:(rank + 1) * half], y[rank * half:(rank + 1) *
                                                  half]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for key, kw in (("plain", {}),
                    ("2bit", {"compression_params": {"type": "2bit",
                                                     "threshold": 0.5}}),
                    ("tpu_update", {"kvstore": "tpu"})):
        net = _gluon_mlp(inputs["mlp_params"])
        params = net.collect_params()
        kw = dict({"kvstore": "dist_sync"}, **kw)
        mesh = make_mesh(dp=2, device="cpu") if kw["kvstore"] == "tpu" \
            else contextlib.nullcontext()
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                                   **kw)
        grads, steps = [], []
        # the store is made at the first step, under the mesh
        with mx.cpu(), mesh:
            for _ in range(2):
                with mx.autograd.record():
                    loss = loss_fn(net(mx.nd.array(xs)), mx.nd.array(ys))
                loss.backward()
                grads.append({n: p.grad().asnumpy()
                              for n, p in params.items()})
                trainer.step(half)
                steps.append({n: p.data().asnumpy()
                              for n, p in params.items()})
        out[key] = {"grads": grads, "steps": steps,
                    "wire": getattr(trainer._kvstore, "wire_bytes_pushed",
                                    None),
                    "update_on_kvstore": trainer._update_on_kvstore}
    # the mesh store: gradients averaged in place
    net = _gluon_mlp(inputs["mlp_params"])
    params = net.collect_params()
    with make_mesh(dp=2, device="cpu"):
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                                   kvstore="tpu", update_on_kvstore=False)
        with mx.cpu():
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(xs)), mx.nd.array(ys))
            loss.backward()
            before = {n: p.grad().asnumpy() for n, p in params.items()}
            trainer.allreduce_grads()
            after = {n: p.grad().asnumpy() for n, p in params.items()}
    out["tpu"] = {"before": before, "after": after,
                  "workers": trainer._kvstore.num_workers}
    try:
        mx.kv.create("tpu")
        out["tpu_no_mesh"] = None
    except mx.MXNetError as e:
        out["tpu_no_mesh"] = str(e)
    return out


def _sym_mlp():
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    h = mx.sym.Activation(h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(h, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def module_jobs(rank, inputs):
    """Module.fit(kvstore='dist_sync') for one epoch over this rank's half
    of each global batch, from rank-dependent weights."""
    x, y = inputs["mod_x"], inputs["mod_y"]
    batch = inputs["mod_batch"]
    with mx.cpu():
        # rank r takes the r-th half of every global batch
        idx = np.concatenate([np.arange(i + rank * batch // 2,
                                        i + (rank + 1) * batch // 2)
                              for i in range(0, x.shape[0], batch)])
        it = mx.io.NDArrayIter(x[idx], y[idx], batch_size=batch // 2)
        mod = mx.mod.Module(_sym_mlp(), context=mx.cpu())
        args = {k: mx.nd.array(v + rank) for k, v in
                inputs["mod_params"].items()}
        mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params=args, aux_params={}, eval_metric="acc")
        got, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in got.items()}


def prefetch_jobs(rank, inputs):
    """DevicePrefetchIter(sharding=...) stages this rank's slice; a mesh
    step takes it as it is and steps as on the global batch."""
    from incubator_mxnet_tpu_torch.pipeline_io import DevicePrefetchIter
    mesh = make_mesh(dp=2, device="cpu")
    x, y = inputs["x"], inputs["y"]
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=x.shape[0])
        pf = DevicePrefetchIter(it, sharding=mesh.sharding("dp"), depth=1)
        b = pf.next()
        slice_x = b.data[0].asnumpy()
        nets, steps = [], []
        for _ in range(2):
            net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
            net.load_state_dict(inputs["init"]["plain"])
            nets.append(net)
            steps.append(TrainStep(net, SoftmaxCrossEntropyLoss(),
                                   SGD(learning_rate=0.1), mesh=mesh))
        fed = float(steps[0](b.data[0], b.label[0]))
        whole = float(steps[1](x, y))
        pf.close()
    same = all(torch.equal(a, b) for a, b in
               zip(nets[0].state_dict().values(),
                   nets[1].state_dict().values()))
    # a source that reads only this rank's part: staged as it is
    with mx.cpu():
        part = mx.io.NDArrayIter(x[2 * rank:2 * rank + 2],
                                 y[2 * rank:2 * rank + 2], batch_size=2)
        part.num_parts, part.part_index = 2, rank
        pf = DevicePrefetchIter(part, sharding=mesh.sharding("dp"), depth=1)
        b = pf.next()
        net = ResNetV1(BottleneckV1, *SPEC, device="cpu", **NET)
        net.load_state_dict(inputs["init"]["plain"])
        step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                         SGD(learning_rate=0.1), mesh=mesh)
        source_loss = float(step(b.data[0], b.label[0]))
        source_same = all(torch.equal(a, c) for a, c in zip(
            net.state_dict().values(), nets[1].state_dict().values()))
        source_fastpath = step.resident_fastpath
        # a slice fed to a step that cuts another way is refused
        accum = TrainStep(net, SoftmaxCrossEntropyLoss(),
                          SGD(learning_rate=0.1), mesh=mesh, grad_accum=2)
        try:
            accum(b.data[0], b.label[0])
            refusal = None
        except mx.MXNetError as e:
            refusal = str(e)
        pf.close()
        part.part_index = 1 - rank
        try:
            DevicePrefetchIter(part, sharding=mesh.sharding("dp"), depth=1)
            wrong_part = None
        except mx.MXNetError as e:
            wrong_part = str(e)
    return {"slice": slice_x, "fastpath": steps[0].resident_fastpath,
            "losses": (fed, whole), "same_state": same,
            "source": {"slice": b.data[0].asnumpy(), "loss": source_loss,
                       "same_state": source_same,
                       "fastpath": source_fastpath},
            "refusals": (refusal, wrong_part)}


def main():
    outdir = sys.argv[1]
    torch.set_num_threads(1)
    dist.init_process_group(backend="gloo")
    rank = int(os.environ["DMLC_WORKER_ID"])
    world = int(os.environ["DMLC_NUM_WORKER"])
    inputs = torch.load(os.path.join(outdir, "inputs.pt"),
                        weights_only=False)
    out = {"kvstore": kvstore_jobs(rank, world, inputs),
           "train": train_jobs(rank, inputs),
           "trainer": trainer_jobs(rank, inputs),
           "module": module_jobs(rank, inputs),
           "prefetch": prefetch_jobs(rank, inputs)}
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
