"""ResNet-50 v1 training at b=32 (``fuse_block=True``, NHWC, 224x224,
fp32) for several checkouts, in turns, on one GPU: the ``TrainStep``
step of ``chip_smoke.py``'s phase ``fused_train`` and, where the
checkout has Gluon, the ``gluon.Trainer`` loop of phase ``gluon_train``.

    python3 tools/port_train_turns.py --trees OLD NEW NEW OLD \
        [--windows 3] [--steps 5] [--seed 0]

Each tree is a checkout that holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch``.  For each, in the order given, a fresh
Python process with the tree as its working directory builds that
tree's conv kernels and builds the net from ``--seed``; then, for each
path, one warm-up step and ``--windows`` windows of ``--steps`` steps
on one resident batch, each window timed on the host clock after a
sync.  The Gluon loop is the JAX Gluon code of ``gluon_train``:
``record``, the Gluon softmax cross-entropy, ``backward``,
``trainer.step(32)`` and ``metric.Accuracy`` (which syncs each step);
``TrainStep`` runs ``run_steps``.

It prints one JSON line per tree run: ms a step of each window and their
median for each path, and the median host ms inside ``trainer.step``;
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BATCH = 32


def _windows(step, windows, steps):
    import torch
    step()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    return out


def _median(values):
    return sorted(values)[len(values) // 2]


def child(windows, steps, seed):
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _build
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    _build.build(["sbr_matmul", "sbr_conv3x3"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = {"tree": os.getcwd()}
    x, y = cs._train_batch(seed + 3, BATCH)
    xd, yd = (torch.from_numpy(v).cuda() for v in (x, y))
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **cs.RESNET50)
    train_step = cs._train_step(net)
    ms = _windows(lambda: train_step.run_steps(xd, yd, num_steps=1),
                  windows, steps)
    row["train_step_ms"] = ms
    row["train_step_median_ms"] = _median(ms)
    if hasattr(mx.gluon, "Trainer"):
        net = get_resnet(1, 50, device="cuda:0", seed=seed, **cs.RESNET50)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(cs.SGD_KW))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        acc = mx.metric.Accuracy()
        xx, yy = mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(y, ctx=mx.gpu(0))
        host = []

        def gluon_step():
            with mx.autograd.record():
                out = net(xx)
                loss = loss_fn(out, yy)
            loss.backward()
            t = time.perf_counter()
            trainer.step(BATCH)
            host.append((time.perf_counter() - t) * 1e3)
            acc.update([yy], [out])

        ms = _windows(gluon_step, windows, steps)
        row["gluon_ms"] = ms
        row["gluon_median_ms"] = _median(ms)
        row["trainer_step_host_median_ms"] = _median(host)
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.windows, args.steps, args.seed)
    script = os.path.abspath(__file__)
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, script, "--child", "--windows",
             str(args.windows), "--steps", str(args.steps), "--seed",
             str(args.seed)], cwd=os.path.abspath(tree),
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        if proc.returncode or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            sys.exit(f"tree {tree} failed ({proc.returncode})")
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
