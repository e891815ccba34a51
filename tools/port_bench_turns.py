"""Phase ``resnet_train_bench`` of ``chip_smoke.py`` for several
checkouts, in turns, on one GPU.

    python3 tools/port_bench_turns.py --trees OLD NEW NEW OLD [--seed 0]

Each tree is a checkout that holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch``.  For each, in the order given, a fresh
Python process with the tree as its working directory runs that tree's
``phase_resnet_train_bench``: ``bench.py:main``'s configuration
(ResNet-50 v1, ``fuse_bn_relu=True``, ``TrainStep(bf16_compute=True)``,
b=128 at 224x224, a resident batch), windows of run_steps in turns with
the ``fuse_bn_relu=False`` net.  The phase prints its own JSON line
(ms a step of the best window, every window's seconds); this script
adds one line per tree with the tree and those ms, then the card's name
and power limit.  No hand-written kernel runs on this path, so nothing
is built.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout


def child(seed):
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = io.StringIO()
    with redirect_stdout(out):
        cs.phase_resnet_train_bench(seed)
    text = out.getvalue()
    sys.stdout.write(text)
    row = next(json.loads(line) for line in text.splitlines()
               if '"phase": "resnet_train_bench"' in line)
    print(json.dumps({
        "tree": os.getcwd(), "ms_per_step": row["ms_per_step"],
        "window_s": row["window_s"],
        "fuse_bn_relu_false_ms_per_step":
            row["fuse_bn_relu_false"]["ms_per_step"]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.seed)
    me = os.path.abspath(__file__)
    for tree in args.trees:
        subprocess.run([sys.executable, me, "--child", "--seed",
                        str(args.seed)], cwd=os.path.abspath(tree),
                       check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
