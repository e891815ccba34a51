"""Time the port's imperative path (``chip_smoke`` phases ``nd_imperative``
and ``nd_imperative_profile``: ResNet-50's classifier, 20 SGD steps with
the rtc ``axpy`` update) of two checkouts on one GPU, in turns A, B, B, A.

    python3 tools/port_imperative_ab.py PARENT_TREE CHANGED_TREE

Each turn runs the two phases of that checkout in a fresh process from
its own root, and the script prints one JSON line: per turn, the ms per
step of the loop and of the profiled steps and the device idle share.
The loop is host-bound, so compare the two versions only within one
such run, on one machine.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CODE = ("import torch, chip_smoke as c\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "row, axpy = c.phase_kernels_rtc(0)\n"
        "c.phase_nd_imperative(0, axpy)\n")


def run(tree):
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        sys.exit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"nd_imperative' in line:
            row = json.loads(line)
            out[row["phase"]] = {k: row[k] for k in
                                 ("ms_per_step", "device_idle_share")
                                 if k in row}
    return out


def main():
    a, b = (os.path.abspath(p) for p in sys.argv[1:3])
    turns = [("A", a), ("B", b), ("B", b), ("A", a)]
    print(json.dumps({"ab": {"A": a, "B": b},
                      "turns": [(name, run(tree)) for name, tree in turns]}),
          flush=True)


if __name__ == "__main__":
    main()
