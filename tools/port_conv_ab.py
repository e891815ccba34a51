"""Time the port's fused conv kernels (B1 sbr_matmul, B2 sbr_conv3x3) of
two checkouts on one GPU, in turns A, B, B, A.

    python3 tools/port_conv_ab.py PARENT_TREE CHANGED_TREE

Each turn runs ``chip_smoke.phase_kernels_conv`` of that checkout in a
fresh process from its own root (its kernels built from its own
``csrc/``), and the script prints one JSON line: per kernel and shape,
the kernel times of the four turns.  Compare the two versions only
within one such run, on one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CODE = ("import torch, chip_smoke as c\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "c.phase_build(['sbr_matmul', 'sbr_conv3x3'])\n"
        "c.phase_kernels_conv()\n")


def run(tree):
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        sys.exit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    times = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"kernels_conv"' in line:
            row = json.loads(line)
            times[row["kernel"]] = {str(r["shape"]): r["kernel_ms"]
                                    for r in row["rows"] if "kernel_ms" in r}
    return times


def main():
    a, b = (os.path.abspath(p) for p in sys.argv[1:3])
    turns = [("A", a), ("B", b), ("B", b), ("A", a)]
    results = [(name, run(tree)) for name, tree in turns]
    out = {}
    for kernel in results[0][1]:
        out[kernel] = {shape: [(name, t[kernel][shape]) for name, t in results]
                       for shape in results[0][1][kernel]}
    print(json.dumps({"ab": {"A": a, "B": b}, "kernel_ms": out}), flush=True)


if __name__ == "__main__":
    main()
