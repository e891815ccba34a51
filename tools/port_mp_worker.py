#!/usr/bin/env python
"""One rank of chip_smoke.py's model-parallel phases (``mp_two_ranks``,
``mp_four_ranks``), run under the launcher:

    python tools/launch.py -n 2 -- python tools/port_mp_worker.py \\
        --out DIR --world tp [--seed 0]

The ranks share the one card (``cuda:0``) over the ``gloo`` backend,
asked for explicitly: NCCL refuses two ranks on one card.  ``--world``
names an entry of ``chip_smoke.MP_WORLDS``: its mesh (``tp=2``,
``sp=2``, ``ep=2``, ``pp=2`` on two ranks, ``tp=2 x pp=2`` on four) and
its runs, each the GPT-2-small-width LM of ``chip_smoke.mp_build`` at
depth 2 trained ``MP_STEPS`` Adam steps on the global batch through
``TrainStep(mesh=)``: the plain LM with flash attention (tp), with
Ulysses through B5 and with ring attention (sp), the MoE LM (ep), the
pipelined LM (pp, tp x pp).  The tp world also runs
``BlockPredictor(mesh=)`` on the trained net.  Each rank writes
``DIR/rank<r>.json``: per run its losses, ms a step (the first step
left out), the collectives of the last step (calls, bytes and seconds,
each timed between two device synchronizations), peak memory, the
flash launches, the route each collective took, a hash of each
replicated parameter and the bytes of each sharded one; rank 0 also
writes ``DIR/<run>.pt``, the final global parameters and Adam's first
moments (gathered), and ``DIR/logits.pt``.  The script imports the port only; the two ranks
share the card's time: these are not scaling numbers.
"""
import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import collective  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import (  # noqa: E402
    dist, flash_attention, make_mesh)
from incubator_mxnet_tpu_torch.predict import BlockPredictor  # noqa: E402

# the calls the collectives' routes make (gloo takes no point-to-point
# op of CUDA tensors: on the card every route is one of these)
COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "all_gather_single", "all_to_all_single")


class Collectives:
    """Counts this process's collective calls, their bytes and their
    host seconds (each timed between two device synchronizations) while
    ``on``."""

    def __init__(self):
        import torch.distributed as tdist
        self.calls = self.bytes = 0
        self.seconds = 0.0
        self.on = False
        for name in COLLECTIVES:
            if hasattr(tdist, name):
                setattr(tdist, name, self._wrap(getattr(tdist, name)))

    def _wrap(self, fn):
        def timed(tensor, *args, **kwargs):
            if not self.on:
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


def _sha(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:20]


def _block_bytes(p):
    """The bytes this rank's block of ``p`` must hold, from the mesh's
    axis sizes and this rank's coordinates (blocks of ceil(n/size))."""
    cut = p._cut
    shape = list(p.shape)
    for dim in range(len(shape)):
        axis = cut._axis_of(dim)
        if axis is not None:
            start, stop = collective.block_range(
                shape[dim], cut.mesh.axis_size(axis), cut.mesh.axis_rank(axis))
            shape[dim] = stop - start
    return int(np.prod(shape)) * p.local_data()._data.element_size()


def run(name, kind, attend, mesh, seed, rank, coll, outdir):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = cs.mp_build(mx, seed, kind, cs.mp_attend(attend, mesh))
    step = cs._mp_step(mx, net, mesh)
    x, y = cs.mp_batch(seed)
    flash_attention.launches = 0
    collective.routes_taken.clear()
    losses, step_ms, per_step = [], [], []
    for i in range(cs.MP_STEPS):
        coll.on = i == cs.MP_STEPS - 1
        coll.take()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(x, y).asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(coll.take())
    coll.on = False
    launches = {"flash_attention_fwd": flash_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = net.collect_params()
    final = {n: p.data()._data.detach().cpu() for n, p in params.items()}
    moments = cs.mp_moments(net, step)
    if rank == 0:
        torch.save({"params": final, "moments": moments},
                   os.path.join(outdir, f"{name}.pt"))
    logits = None
    if name == "tp":
        pred = BlockPredictor(net, mesh=mesh, bf16_compute=False)
        logits = pred(x[:1]).cpu()
    calls, nbytes, secs = per_step[-1]
    row = {"losses": losses, "step_ms": step_ms,
           "ms_per_step": float(np.median(step_ms[1:])),
           "collective_calls_per_step": calls,
           "collective_bytes_per_step": nbytes,
           "collective_ms_per_step": secs * 1e3,
           "peak_mem_gb": peak, "launches": launches,
           "routes": {op: list(r) for op, r in
                      collective.routes_taken.items()},
           "replicated_sha": {n: _sha(p.local_data()._data)
                              for n, p in params.items() if p._cut is None},
           "sharded_bytes": {n: [p.local_data()._data.nbytes,
                                 final[n].nbytes, _block_bytes(p)]
                             for n, p in params.items()
                             if p._cut is not None}}
    del net, step
    return row, logits


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", required=True, choices=sorted(cs.MP_WORLDS))
    args = ap.parse_args()
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend="gloo")
    rank = int(os.environ["DMLC_WORKER_ID"])
    torch.cuda.set_device(0)
    _, axes, runs = cs.MP_WORLDS[args.world]
    mesh = make_mesh(**axes)
    if rank == 0:       # built by the smoke already: a cache hit
        _build.build(["flash_attention"])
    torch.distributed.barrier()
    coll = Collectives()
    setup_s = time.perf_counter() - t0
    out = {"rank": rank, "world": args.world, "setup_s": setup_s,
           "device": torch.cuda.get_device_name(0), "runs": {}}
    for name, kind, attend in runs:
        out["runs"][name], logits = run(name, kind, attend, mesh, args.seed,
                                        rank, coll, args.out)
        if logits is not None and rank == 0:
            torch.save(logits, os.path.join(args.out, "logits.pt"))
    out["total_s"] = time.perf_counter() - t0
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
