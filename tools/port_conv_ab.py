"""Time the port's kernels B1 (sbr_matmul), B2 (sbr_conv3x3) and B5
(flash attention) of two checkouts on one GPU, in turns A, B, B, A.

    python3 tools/port_conv_ab.py PARENT_TREE CHANGED_TREE

Each turn runs in a fresh process from that checkout's root, with its
kernels built from its own ``csrc/``: ``chip_smoke.phase_kernels_conv``
of that checkout for B1 and B2, and this script's flash timing (the
checkout's ``flash_attention`` at every prefill bucket of the smoke's
generation run, B=1, H=12, D=64, causal, CUDA events by the checkout's
``chip_smoke.time_ms``).  It prints one JSON line: per kernel and shape,
the kernel times of the four turns.  Compare the two versions only
within one such run, on one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

FLASH = ("def flash(buckets):\n"
         "    from incubator_mxnet_tpu_torch.parallel.flash_attention "
         "import flash_attention\n"
         "    gen = torch.Generator(device='cuda').manual_seed(0)\n"
         "    rows = []\n"
         "    for t in buckets:\n"
         "        q, k, v = (torch.randn((1, 12, t, 64), device='cuda',\n"
         "                               generator=gen) for _ in range(3))\n"
         "        rows.append({'shape': [1, 12, t, 64], 'kernel_ms':\n"
         "                     c.time_ms(lambda: flash_attention(\n"
         "                         q, k, v, causal=True))})\n"
         "    c.emit({'phase': 'kernels_flash_ab', 'kernel':\n"
         "            'flash_attention_fwd', 'rows': rows})\n")
CODE = ("import torch, chip_smoke as c\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "c.phase_build(['flash_attention', 'sbr_matmul', 'sbr_conv3x3'])\n"
        + FLASH +
        "flash(@BUCKETS@)\n"
        "c.phase_kernels_conv()\n")


def run(tree, buckets):
    proc = subprocess.run(
        [sys.executable, "-c",
         CODE.replace("@BUCKETS@", str(list(buckets)))],
        cwd=tree, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        sys.exit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    times = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{") and ('"kernels_conv"' in line
                                     or '"kernels_flash_ab"' in line):
            row = json.loads(line)
            times[row["kernel"]] = {str(r["shape"]): r["kernel_ms"]
                                    for r in row["rows"] if "kernel_ms" in r}
    return times


def main():
    a, b = (os.path.abspath(p) for p in sys.argv[1:3])
    buckets = chip_smoke.prefill_buckets()
    turns = [("A", a), ("B", b), ("B", b), ("A", a)]
    results = [(name, run(tree, buckets)) for name, tree in turns]
    out = {}
    for kernel in results[0][1]:
        out[kernel] = {shape: [(name, t[kernel][shape]) for name, t in results]
                       for shape in results[0][1][kernel]}
    print(json.dumps({"ab": {"A": a, "B": b}, "prefill_buckets": buckets,
                      "kernel_ms": out}), flush=True)


if __name__ == "__main__":
    main()
