"""The margin of ``chip_smoke.py``'s two-rank parameter gate over several
seeds, on one GPU:

    python3 tools/port_dist_margin.py [--seeds 0,1,2,3]

For each seed: the ``dist_two_ranks`` runs (``tools/port_dist_worker.py
--mesh-only`` under ``tools/launch.py -n 2``, both ranks on the one card
over gloo) and the single-process reference on the global batch, held
by the same gate as in the smoke (``chip_smoke._dist_rows``).  Prints
one JSON line a seed and config with the worst leaf's error as a share
of the bound, the median leaf, the formulations' spread, the planted
half-batch fault, the moving statistics and the losses against theirs,
and the gate's failures; then a summary line, then the card's name and
power limit.  Exits 1 when a seed failed a gate.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

KEYS = ("change_err_worst", "change_err_worst_of_bound",
        "change_err_median", "spread_median", "spread_max", "step_bound",
        "planted_half_batch", "zero_gradient_leaves", "stats_worst_of_max",
        "stats_spread_of_max", "loss_err_of_bound")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args()
    smi = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build(["sbr_matmul", "sbr_conv3x3", "chain_stats",
                    "chain_emit"])
    worst, failed = {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        ranks, finals, _ = cs._dist_run_ranks(seed, mesh_only=True)
        rows, _, failures = cs._dist_rows(seed, ranks, finals)
        for name, row in rows.items():
            print(json.dumps(dict({"seed": seed, "config": name},
                                  **{k: row[k] for k in KEYS})), flush=True)
            worst[name] = max(worst.get(name, 0.0),
                              row["change_err_worst_of_bound"])
        failed += [f"seed {seed}: {f}" for f in failures]
    print(json.dumps({"worst_change_err_of_bound": worst,
                      "failures": failed}), flush=True)
    print(smi or "nvidia-smi: not available", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
