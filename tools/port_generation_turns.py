"""Phase ``generation`` of ``chip_smoke.py`` for several checkouts, in
turns, on one GPU.

    python3 tools/port_generation_turns.py --trees OLD NEW NEW OLD \
        [--reps 5] [--seed 0]

Each tree is a checkout that holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch``.  For each, in the order given, a fresh
Python process with the tree as its working directory builds that
tree's flash kernel, makes the smoke's GPT-2-small decoder and engine
(``chip_smoke._engine``: paged, prefix cache off) and serves the
smoke's traffic (``chip_smoke._serve``: 8 greedy prompts of 9 to 1000
tokens and one sampled prompt twice, 16 new tokens each) ``--reps`` + 1
times.  The first burst is the smoke's own reading (an engine fresh
from warm-up); the others give a median.

It prints one JSON line per tree run: tokens per second of the first
burst and the median of the rest, and for the median burst the decode
iterations and the engine's host seconds in prefill and in decode
(per decode iteration too); then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _counts(eng):
    """The engine's own decodes, prefills and busy seconds: ``_counters``
    (``stats()`` is the process's gen.* telemetry slice), or in a
    checkout older than the telemetry port, ``stats()``, which held
    them under the same keys."""
    own = getattr(eng, "_counters", None)
    return own() if own is not None else eng.stats()


def child(reps, seed):
    import numpy as np
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch import _build
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    _build.build(["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    net = TransformerDecoder(device="cuda:0", seed=seed, **cs.GPT2_SMALL)
    eng = cs._engine(net)
    rs = np.random.RandomState(seed)
    vocab = cs.GPT2_SMALL["vocab"]
    greedy = [rs.randint(0, vocab, size=n).tolist()
              for n in cs.PROMPT_LENGTHS]
    sampled = rs.randint(0, vocab, size=cs.SAMPLED_LEN).tolist()
    runs = []
    try:
        for _ in range(reps + 1):
            before = _counts(eng)
            outs, wall = cs._serve(eng, greedy, sampled)
            after = _counts(eng)
            diff = {k: after[k] - before[k]
                    for k in ("decodes", "prefills", "prefill_s",
                              "decode_s")}
            runs.append(dict(diff, wall_s=wall, tokens_per_s=sum(
                o.size for o in outs) / wall))
    finally:
        eng.close()
    rest = sorted(runs[1:], key=lambda r: r["tokens_per_s"])
    med = rest[len(rest) // 2]
    print(json.dumps({
        "tree": os.getcwd(),
        "first_tokens_per_s": runs[0]["tokens_per_s"],
        "median_tokens_per_s": med["tokens_per_s"],
        "all_tokens_per_s": [r["tokens_per_s"] for r in runs],
        "median_burst": med,
        "decode_ms_per_iteration": 1e3 * med["decode_s"] / med["decodes"],
        "first_burst": runs[0]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.reps, args.seed)
    me = os.path.abspath(__file__)
    for tree in args.trees:
        subprocess.run([sys.executable, me, "--child", "--reps",
                        str(args.reps), "--seed", str(args.seed)],
                       cwd=os.path.abspath(tree), check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
