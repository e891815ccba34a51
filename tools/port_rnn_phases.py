"""The recurrent phases of ``chip_smoke.py`` alone, on one GPU:

    python3 tools/port_rnn_phases.py [--seed 0] [--phases rnn_op,rnn_lm_train,rnn_bucketing]

``rnn_op`` (the fused RNN op's cuDNN route against its plain
composition, both routes timed), ``rnn_lm_train`` (the 650-wide tied
LSTM language model through ``gluon.Trainer("adam")``) and
``rnn_bucketing`` (``BucketingModule.fit`` over LSTMCells and over a
FusedRNNCell), with the same checks and JSON lines as in the whole
smoke, after the ``device`` line.  None of them needs a hand-written
kernel, so nothing is built; it takes ~45 s on an H100.
"""
import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

PHASES = ("rnn_op", "rnn_lm_train", "rnn_bucketing")


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
    if "rnn_op" in phases:
        cs.phase_rnn_op(args.seed)
    if "rnn_lm_train" in phases:
        with tempfile.TemporaryDirectory(prefix="rnn_lm_") as tmpdir:
            cs.phase_rnn_lm_train(args.seed, tmpdir)
    if "rnn_bucketing" in phases:
        cs.phase_rnn_bucketing(args.seed)
    print(smi or "nvidia-smi: not available", flush=True)


if __name__ == "__main__":
    main()
