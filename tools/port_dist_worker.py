#!/usr/bin/env python
"""One rank of chip_smoke.py's two-rank data-parallel phases
(``dist_two_ranks``, ``dist_trainer``), run under the launcher:

    python tools/launch.py -n 2 -- python tools/port_dist_worker.py \\
        --out DIR [--seed 0]

Both ranks share the one card (``cuda:0``) over the ``gloo`` backend,
asked for explicitly: NCCL refuses two ranks on one card.  Each rank
writes ``DIR/rank<r>.json`` (its measurements and checks); rank 0 also
writes ``DIR/<config>.pt``, the final state of each data-parallel run,
which ``chip_smoke.py`` holds against a single process on the global
batch.

* ``dist_two_ranks``: ResNet-50 v1 at full width and depth in
  ``bench.py:main``'s protocol split over the ranks (b=64 a rank, global
  128, 224x224, SGD 0.1 / 0.9 / 1e-4, ``bf16_compute``) through
  ``TrainStep(mesh=make_mesh(dp=2))`` for STEPS steps, with
  ``fuse_bn_relu=True`` and ``fuse_block=True`` (B1/B2), then
  ``fuse_block="chain"`` (B3/B4); after every step rank 1's parameters
  are sent to rank 0 and compared bit for bit; each rank's kernel
  launches, ms a step, the collectives' ms, bytes and calls a step, and
  peak memory.
* ``dist_trainer``: ``gluon.Trainer(kvstore="dist_sync",
  compression_params=2-bit)`` for 2 steps on ResNet-50 (its wire bytes
  against the fp32 bytes, and the bytes of the buffers that gather
  them), ``Module.fit(kvstore="dist_sync")`` for one
  batch of the symbolic ResNet-50 v2, and a ``TrainCheckpoint`` round
  trip: saved after step 3, restored into a fresh step, step 4 equal bit
  for bit to step 4 of an uninterrupted run.

The script imports the port only.  The device time of the two ranks is
shared: these are not scaling numbers.
"""
import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (  # noqa: E402
    get_resnet)
from incubator_mxnet_tpu_torch.parallel import (  # noqa: E402
    TrainCheckpoint, dist, make_mesh)

GLOBAL_BATCH, STEPS = cs.DIST_GLOBAL_BATCH, cs.DIST_STEPS
# the last steps of a run time their collectives (a device sync around
# each); the steps between the first and those give the clean ms a step
INSTRUMENTED = 2
TRAINER_BATCH, TRAINER_STEPS = 16, 2          # a rank
MODULE_BATCH = 8                              # a rank
CKPT_BATCH = 32                               # a rank


class Collectives:
    """Counts the ``all_reduce`` / ``broadcast`` calls of this process,
    their bytes and their host seconds (each timed between two device
    synchronizations)."""

    def __init__(self):
        import torch.distributed as tdist
        self.calls = self.bytes = 0
        self.seconds = 0.0
        self.paused = False
        for name in ("all_reduce", "broadcast"):
            setattr(tdist, name, self._wrap(getattr(tdist, name)))

    def _wrap(self, fn):
        def timed(tensor, *args, **kwargs):
            if self.paused:
                return fn(tensor, *args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tensor, *args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            return out
        return timed

    def take(self):
        out = (self.calls, self.bytes, self.seconds)
        self.calls = self.bytes = 0
        self.seconds = 0.0
        return out


def same_as_rank1(tensors, coll):
    """Rank 1's copy of ``tensors`` sent to every rank: are they this
    rank's, bit for bit?"""
    import torch.distributed as tdist
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    other = flat.clone()
    paused, coll.paused = coll.paused, True
    tdist.broadcast(other, src=1)
    coll.paused = paused
    return bool(torch.equal(flat.view(torch.int32), other.view(torch.int32)))


def run_mesh(name, seed, rank, mesh, coll, outdir):
    from incubator_mxnet_tpu_torch.gluon.nn._modules import (
        SoftmaxCrossEntropyLoss)
    from incubator_mxnet_tpu_torch.optimizer import SGD
    from incubator_mxnet_tpu_torch.parallel import TrainStep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = get_resnet(1, 50, device="cuda:0", seed=seed,
                     **cs.DIST_CONFIGS[name])
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**cs.SGD_KW),
                     bf16_compute=True, mesh=mesh)
    xd, yd = cs._resident(seed, GLOBAL_BATCH)       # the global batch
    params = [p for p in net.parameters()]
    cs._zero_counts()
    losses, step_ms, equal, per_step = [], [], [], []
    for i in range(STEPS):
        # the last INSTRUMENTED steps time their collectives, the others
        # run as they are (their step_ms is the clean figure)
        coll.paused = i < STEPS - INSTRUMENTED
        coll.take()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(xd, yd)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(coll.take())
        losses.append(loss.item())
        equal.append(same_as_rank1(params, coll))
    coll.paused = True
    launches = cs._counts()
    want = dict.fromkeys(launches, 0)
    want.update({k: v * STEPS for k, v in cs.DIST_PER_STEP[name].items()})
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
                   os.path.join(outdir, f"{name}.pt"))
    calls, nbytes, secs = (np.median([s[i] for s in per_step[-INSTRUMENTED:]])
                           for i in range(3))
    clean = step_ms[1:STEPS - INSTRUMENTED]
    return {"config": name, "local_batch": GLOBAL_BATCH // 2,
            "global_batch": GLOBAL_BATCH, "steps": STEPS, "losses": losses,
            "step_ms": step_ms, "ms_per_step": float(np.median(clean)),
            "collective_calls_per_step": float(calls),
            "collective_bytes_per_step": float(nbytes),
            "collective_ms_per_step": float(secs) * 1e3,
            "ranks_bit_equal_each_step": equal, "launches": launches,
            "launches_expected": want, "launches_ok": launches == want,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def run_trainer(seed, rank, world):
    """gluon.Trainer over dist_sync with 2-bit compression."""
    net = get_resnet(1, 50, device="cuda:0", seed=seed + 41, **cs.RESNET50)
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", dict(cs.SGD_KW),
                               kvstore="dist_sync", compression_params={
                                   "type": "2bit", "threshold": 0.5})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = cs._train_batch(seed + 42, 2 * TRAINER_BATCH)
    sl = slice(rank * TRAINER_BATCH, (rank + 1) * TRAINER_BATCH)
    gpu = mx.gpu(0)
    xx, yy = mx.nd.array(x[sl], ctx=gpu), mx.nd.array(y[sl], ctx=gpu)
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAINER_STEPS):
        with mx.autograd.record():
            loss = loss_fn(net(xx), yy)
        loss.backward()
        trainer.step(TRAINER_BATCH)
        losses.append(float(loss.mean().asscalar()))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    trained = [p for p in params.values() if p.grad_req != "null"]
    sizes = [int(np.prod(p.shape)) for p in trained]
    wire = trainer._kvstore.wire_bytes_pushed
    fp32 = 4 * sum(sizes) * TRAINER_STEPS
    # each array's codes are padded to a whole byte: 4 codes a byte
    padding = sum(4 * math.ceil(n / 4) - n for n in sizes) * \
        TRAINER_STEPS / 4
    # the gather of the wires all-reduces a (world, wire bytes) buffer
    return {"local_batch": TRAINER_BATCH, "steps": TRAINER_STEPS,
            "losses": losses, "wire_bytes_pushed": wire,
            "gather_buffer_bytes": world * wire,
            "fp32_bytes": fp32, "padding_bytes": padding,
            "wire_ok": wire == fp32 / 16 + padding,
            "ms_per_step": secs / TRAINER_STEPS * 1e3,
            "_params": [p.data()._data for p in trained]}


def run_module(seed, rank):
    """Module.fit(kvstore="dist_sync") for one batch of the symbolic
    ResNet-50 v2 (NCHW, fp32), each rank on its half."""
    sym = cs.sym_get_resnet(mx, 50, 1000, (3, 224, 224))
    x, y = cs._train_batch(seed + 7, 2 * MODULE_BATCH)
    sl = slice(rank * MODULE_BATCH, (rank + 1) * MODULE_BATCH)
    it = mx.io.NDArrayIter(x[sl].transpose(0, 3, 1, 2).copy(), y[sl],
                           batch_size=MODULE_BATCH)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mx.random.seed(seed)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
            optimizer_params=dict(cs.SYM_OPT),
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
    torch.cuda.synchronize()
    args, _ = mod.get_params()
    vals = [torch.from_numpy(v.asnumpy()) for _, v in sorted(args.items())]
    return {"local_batch": MODULE_BATCH,
            "fit_s": time.perf_counter() - t0,
            "store": type(mod._kvstore).__name__,
            "finite": all(bool(torch.isfinite(v).all()) for v in vals),
            "_params": vals}


def run_checkpoint(seed, mesh, tmpdir):
    """Saved after step 3, restored into a fresh step (other weights),
    step 4: bit for bit the uninterrupted run's step 4."""
    from incubator_mxnet_tpu_torch.gluon.nn._modules import (
        SoftmaxCrossEntropyLoss)
    from incubator_mxnet_tpu_torch.optimizer import SGD
    from incubator_mxnet_tpu_torch.parallel import TrainStep
    cfg = cs.DIST_CONFIGS["fused"]
    xd, yd = cs._resident(seed + 3, 2 * CKPT_BATCH)

    def fresh(s):
        net = get_resnet(1, 50, device="cuda:0", seed=s, **cfg)
        return net, TrainStep(net, SoftmaxCrossEntropyLoss(),
                              SGD(**cs.SGD_KW), bf16_compute=True,
                              mesh=mesh)

    # two runs compared bit for bit: cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    net, step = fresh(seed)
    losses = [step(xd, yd).item() for _ in range(4)]
    want = {k: v.detach().clone() for k, v in net.state_dict().items()}
    del net, step
    net, step = fresh(seed)
    for _ in range(3):
        step(xd, yd)
    ckpt = TrainCheckpoint(os.path.join(tmpdir, "ckpt"))
    t0 = time.perf_counter()
    ckpt.save(step, 3)
    save_s = time.perf_counter() - t0
    del net, step
    net, step = fresh(seed + 1)
    t0 = time.perf_counter()
    epoch = ckpt.restore(step)
    restore_s = time.perf_counter() - t0
    loss4 = step(xd, yd).item()
    torch.backends.cudnn.deterministic = False
    equal = all(torch.equal(v, want[k]) for k, v in net.state_dict().items())
    return {"local_batch": CKPT_BATCH, "restored_epoch": epoch,
            "loss4": loss4, "loss4_uninterrupted": losses[3],
            "bit_equal": equal and loss4 == losses[3] and epoch == 3,
            "save_s": save_s, "restore_s": restore_s}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-only", action="store_true",
                    help="run dist_two_ranks only")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dist.init_process_group(backend="gloo")
    import torch.distributed as tdist
    rank, world = tdist.get_rank(), tdist.get_world_size()
    mesh = make_mesh(dp=world)
    coll = Collectives()
    out = {"rank": rank, "world": world, "backend": tdist.get_backend(),
           "device": str(mesh.device), "setup_s": time.perf_counter() - t0}
    out["dist_two_ranks"] = [run_mesh(name, args.seed, rank, mesh, coll,
                                      args.out) for name in cs.DIST_CONFIGS]
    if args.mesh_only:
        return finish(out, args.out, rank, t0)
    trainer = run_trainer(args.seed, rank, world)
    module = run_module(args.seed, rank)
    for part in (trainer, module):
        part["ranks_bit_equal"] = same_as_rank1(part.pop("_params"), coll)
    with tempfile.TemporaryDirectory(prefix="port_dist_") as tmpdir:
        # rank 0 writes, every rank reads: one directory for both
        shared = [tmpdir]
        tdist.broadcast_object_list(shared, src=0)
        ckpt = run_checkpoint(args.seed, mesh, shared[0])
        tdist.barrier()
    out["dist_trainer"] = {"trainer": trainer, "module": module,
                           "checkpoint": ckpt}
    finish(out, args.out, rank, t0)


def finish(out, outdir, rank, t0):
    import torch.distributed as tdist
    out["total_s"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
