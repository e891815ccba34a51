"""What the port's telemetry hooks cost on the card's host, two ways.

    python3 tools/port_telemetry_cost.py [--turns 15] [--calls 200000]

1. Each hook alone, in host microseconds a call over ``--calls`` calls
   with telemetry on and off: a counter increment as the call sites
   write it (``if telemetry.enabled: telemetry.counter(name).inc()``),
   a gauge set, a histogram observation, an ``NDArray`` wrapped around
   a CUDA tensor and dropped (the live-array gauges), and an ``nd`` op
   on a 16-element CUDA tensor (``op.dispatch.count`` and the output's
   gauges; the card's queue drained at the end).
2. ``chip_smoke.phase_telemetry_cost`` with ``--turns`` turns each (on,
   off, on, off, ...): the imperative step with the rtc ``axpy`` update
   and the GPT-2-small engine's decode iteration, each turn's ms and
   the medians' ratio.  ``decode_ms_per_iteration`` times only the
   decode step itself, which holds no hook: its ratio shows the host's
   turn-to-turn spread.

It prints one JSON line per part, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _per_call_us(fn, calls):
    t0 = time.perf_counter()
    fn(calls)
    return (time.perf_counter() - t0) / calls * 1e6


def hooks(calls):
    """Host us a call of each hook, telemetry on and off (the best of
    two rounds of each), and their difference."""
    import torch
    from incubator_mxnet_tpu_torch import telemetry
    from incubator_mxnet_tpu_torch.ndarray.ndarray import NDArray
    t = torch.zeros(16, device="cuda:0")
    x = NDArray(t)

    def counter(n):
        for _ in range(n):
            if telemetry.enabled:
                telemetry.counter("cost.counter").inc()

    def gauge(n):
        for i in range(n):
            if telemetry.enabled:
                telemetry.gauge("cost.gauge").set(i)

    def histogram(n):
        for i in range(n):
            if telemetry.enabled:
                telemetry.histogram("cost.histogram").observe(i)

    def ndarray(n):
        for _ in range(n):
            NDArray(t)

    def nd_op(n):
        for _ in range(n):
            x + 1
        torch.cuda.synchronize()

    out = {}
    for name, fn, n in (("counter", counter, calls),
                        ("gauge", gauge, calls),
                        ("histogram", histogram, calls),
                        ("ndarray", ndarray, calls),
                        ("nd_op", nd_op, calls // 20)):
        row = {"on": [], "off": []}
        for mode in ("on", "off", "on", "off"):
            (telemetry.enable if mode == "on" else telemetry.disable)()
            fn(min(n, 1000))                       # warm
            row[mode].append(_per_call_us(fn, n))
        telemetry.enable()
        row = {m: min(v) for m, v in row.items()}
        row["added_us"] = row["on"] - row["off"]
        out[name + "_us_per_call"] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=15)
    ap.add_argument("--calls", type=int, default=200000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"part": "hooks", **hooks(args.calls)}), flush=True)
    cs.phase_build(["flash_attention"])
    _, axpy = cs.phase_kernels_rtc(args.seed)
    net = TransformerDecoder(device="cuda:0", seed=args.seed,
                             **cs.GPT2_SMALL)
    cs.TEL_TURNS = args.turns
    cs.phase_telemetry_cost(args.seed, axpy, net)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
