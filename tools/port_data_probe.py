"""Where the time of the port's data-fed ResNet-50 training step goes, on
one GPU: the JPEG decode of ``io.ImageRecordIter`` alone, and how it and
the eager training step slow each other down through the interpreter
lock.

    python3 tools/port_data_probe.py [--seed 0] [--threads 1 2 4 8]

It writes ``chip_smoke.py``'s data_train records (1536 seeded 256x256
JPEGs, with an ``.idx``) into a temporary directory and measures, each
on the host clock:

* ``imdecode_ms``: OpenCV's ``imdecode`` of one record, serially, and
  ``imdecode_pool_ms``: the same in a pool of each thread count (the
  time per image; it falls with the threads only where ``imdecode``
  runs without the interpreter lock);
* ``reader_ms_per_batch``: ``ImageRecordIter`` (b=128, 224x224 random
  crops and mirrors, uint8 NHWC) at each ``preprocess_threads``, in the
  steady state (the first batch, which pays the set-up, left out), with
  no step running;
* ``resident_ms``: the data_train step (bench.py's net with
  ``BENCH_FUSE_BLOCK=chain``, ``TrainStep(bf16_compute=True)``,
  ``uint8_input_prep``) on one resident batch, and ``contended_ms``: the
  same while a reader at each thread count decodes into a sink on
  another thread (the interpreter lock shared, the batches unused);
* ``fed_ms``: the step fed by the reader through ``DevicePrefetchIter``
  at each thread count (one epoch of 12 batches each), and
  ``fed_drain_ms``: the same at the largest thread count with the
  losses through ``run_steps(drain=MetricDrain(depth))`` for each
  ``--drain-depths`` (a drain of depth d lets the host run at most d
  steps ahead of the card);
* ``contended_switch_ms``: ``contended_ms`` at the largest thread count
  under each ``--switch-intervals`` (``sys.setswitchinterval``: how long
  a thread may keep the interpreter lock while another waits for it).

It prints one JSON object, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _median(values):
    return sorted(values)[len(values) // 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--drain-depths", type=int, nargs="+",
                    default=[1, 3, 12])
    ap.add_argument("--switch-intervals", type=float, nargs="+",
                    default=[0.005, 0.0005])
    args = ap.parse_args()
    import cv2
    import torch
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch import _build, io as mio, recordio
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.parallel import uint8_input_prep
    from incubator_mxnet_tpu_torch.pipeline_io import (DevicePrefetchIter,
                                                       MetricDrain)
    if not torch.cuda.is_available():
        raise SystemExit("port_data_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["chain_stats", "chain_emit"])
    out = {"cpu_count": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0)),
           "cv2": cv2.__version__, "cv2_threads": cv2.getNumThreads()}
    with tempfile.TemporaryDirectory(prefix="port_data_probe_") as tmp:
        prefix = os.path.join(tmp, "train")
        cs._write_records(prefix, args.seed + 20, cs._decoders())
        rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "r")
        raw = [np.frombuffer(recordio.unpack(rec.read_idx(i))[1], np.uint8)
               for i in range(256)]
        rec.close()

        def decode(buf):
            return cv2.imdecode(buf, cv2.IMREAD_COLOR)

        t0 = time.perf_counter()
        for buf in raw:
            decode(buf)
        out["imdecode_ms"] = (time.perf_counter() - t0) / len(raw) * 1e3
        out["imdecode_pool_ms"] = {}
        for n in args.threads:
            with concurrent.futures.ThreadPoolExecutor(n) as pool:
                list(pool.map(decode, raw[:32]))
                t0 = time.perf_counter()
                list(pool.map(decode, raw))
                out["imdecode_pool_ms"][n] = \
                    (time.perf_counter() - t0) / len(raw) * 1e3

        def reader(threads, seed):
            return mio.ImageRecordIter(
                path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
                data_shape=(3, 224, 224), batch_size=cs.TRAIN_BATCH,
                dtype="uint8", layout="NHWC", rand_crop=True,
                rand_mirror=True, shuffle=True, preprocess_threads=threads,
                seed=seed)

        out["reader_ms_per_batch"] = {}
        for n in args.threads:
            it = reader(n, args.seed)
            next(it)
            t0 = time.perf_counter()
            k = sum(1 for _ in it)
            out["reader_ms_per_batch"][n] = \
                (time.perf_counter() - t0) / k * 1e3
            it.close()

        net = get_resnet(1, 50, device="cuda:0", seed=args.seed,
                         **cs.BENCH_CHAIN_NET)
        prep = uint8_input_prep(cs.DATA_MEAN, 1.0 / np.asarray(cs.DATA_STD),
                                "NHWC")
        step = cs._train_step(net, bf16_compute=True, input_prep=prep)
        it = reader(1, args.seed)
        b = next(it)
        it.close()
        xd, yd = b.data[0]._data.cuda(), b.label[0]._data.cuda()

        def window(steps=6):
            step.run_steps(xd, yd, num_steps=1)
            torch.cuda.synchronize()
            times = []
            for _ in range(steps):
                t0 = time.perf_counter()
                step.run_steps(xd, yd, num_steps=1)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return _median(times)

        def contended(n):
            stop = threading.Event()

            def sink(it):
                while not stop.is_set():
                    try:
                        next(it)
                    except StopIteration:
                        it.reset()
            it = reader(n, args.seed + 1)
            t = threading.Thread(target=sink, args=(it,), daemon=True)
            t.start()
            time.sleep(0.5)
            ms = window()
            stop.set()
            t.join(30)
            it.close()
            return ms

        def fed(n, drain_depth=None):
            pf = DevicePrefetchIter(reader(n, args.seed + 2), depth=2)
            first = next(pf)
            step.run_steps(first.data[0], first.label[0], num_steps=1)
            torch.cuda.synchronize()
            drain = None if drain_depth is None else MetricDrain(drain_depth)
            t0 = time.perf_counter()
            k = 0
            for b in pf:
                step.run_steps(b.data[0], b.label[0], num_steps=1,
                               drain=drain)
                k += 1
            if drain is not None:
                drain.flush()
            torch.cuda.synchronize()
            pf.close()
            return (time.perf_counter() - t0) / k * 1e3

        out["resident_ms"] = window()
        out["contended_ms"], out["fed_ms"] = {}, {}
        for n in args.threads:
            out["contended_ms"][n] = contended(n)
            out["fed_ms"][n] = fed(n)
        most = max(args.threads)
        out["fed_drain_ms"] = {d: fed(most, d) for d in args.drain_depths}
        out["contended_switch_ms"] = {}
        default = sys.getswitchinterval()
        try:
            for interval in args.switch_intervals:
                sys.setswitchinterval(interval)
                out["contended_switch_ms"][interval] = contended(most)
        finally:
            sys.setswitchinterval(default)
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi or "nvidia-smi: not available", flush=True)


if __name__ == "__main__":
    main()
