"""The zoo and detection phases of ``chip_smoke.py`` alone, on one GPU:

    python3 tools/port_detection_phases.py [--seed 0] [--phases zoo_models,ssd_train,contrib_ops]

``zoo_models`` (the 21 zoo models beyond ResNet at full width, the
first of each family against the CPU, Inception V3 behind
``ModelServer``), ``ssd_train`` (SSD-300 on VGG16-reduced trained at
b=32, one step against the CPU, ``MultiBoxDetection`` against the CPU
and the plain NMS scan, then examples/train_ssd.py's compact SSD with
its asserts) and ``contrib_ops`` (the contrib and linalg ops against the
CPU, forward and gradient), with the same checks and JSON lines as in
the whole smoke, after the ``device`` line, and each phase's launch
counts of the hand-written kernels (all 0: none lies on these paths).
None of them needs a hand-written kernel, so nothing is built.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

PHASES = {"zoo_models": cs.phase_zoo_models, "ssd_train": cs.phase_ssd_train,
          "contrib_ops": cs.phase_contrib_ops}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    smi = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    for name in phases:
        cs._zero_counts()
        PHASES[name](args.seed)
        launches[name] = cs._counts()
        torch.cuda.empty_cache()
    print(json.dumps({"launches_detection": launches}), flush=True)
    print(smi or "nvidia-smi: not available", flush=True)


if __name__ == "__main__":
    main()
