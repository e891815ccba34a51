"""The margin of ``chip_smoke.py``'s model-parallel gates over several
seeds, on one GPU:

    python3 tools/port_mp_margin.py [--seeds 0,1,2,3] [--worlds tp,sp,ep,pp,tp_pp]

For each seed: the worlds of ``chip_smoke.MP_WORLDS`` (each a
``tools/launch.py`` of ``tools/port_mp_worker.py``, the ranks sharing
the one card over gloo) and the single-process references, held by the
smoke's gates (``chip_smoke._mp_rows``).  Prints one JSON line a seed
and run with the worst leaf's change error and Adam first-moment
error, each with its share of its bound (``MP_STEP_BOUND``,
``MP_MOMENT_BOUND``), the median leaves, the losses' relative error and
the ranks' bit-equality; then a summary line with the worst share a run,
then the card's name and power limit.  Exits 1 when a seed failed a
gate.
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
        "change_err_median", "moment_err_worst", "moment_err_worst_of_bound",
        "moment_err_median", "loss_rel_err", "loss_err_of_bound",
        "ranks_bit_equal_replicated", "sharded_bytes_are_blocks")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--worlds", default=",".join(cs.MP_WORLDS))
    args = ap.parse_args()
    smi = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build(["flash_attention"])
    worst, failed = {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        out, _, failures = cs._mp_rows(seed, args.worlds.split(","))
        for world, res in out.items():
            for run, row in res["runs"].items():
                print(json.dumps(dict({"seed": seed, "run": run},
                                      **{k: row[k] for k in KEYS})),
                      flush=True)
                worst[run] = [max(a, row[k]) for a, k in zip(
                    worst.get(run, (0.0, 0.0, 0.0)),
                    ("change_err_worst_of_bound",
                     "moment_err_worst_of_bound", "loss_err_of_bound"))]
        failed += [f"seed {seed}: {f}" for f in failures]
    print(json.dumps({"worst_of_bound_change_moment_loss": worst,
                      "step_bound": cs.MP_STEP_BOUND,
                      "moment_bound": cs.MP_MOMENT_BOUND,
                      "loss_rtol": cs.MP_LOSS_RTOL, "failures": failed}),
          flush=True)
    print(smi or "nvidia-smi: not available", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
