"""On-card smoke test of the PyTorch port (incubator_mxnet_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

It builds every hand-written kernel from ``incubator_mxnet_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version
on the card, then drives the port's two main paths, each with the
kernels' launch counts set to 0 just before it and read just after:

* the continuous-batching generation server at GPT-2-small widths
  (vocab 50257, dim 768, 12 heads, 12 layers, max_len 1024), checked
  against the same weights on the CPU, then the same traffic under
  torch.profiler;
* ResNet-50 v1 inference (He et al. 2016, 224x224, 1000 classes;
  ``fuse_block=True``, channels-last) through ``ModelServer`` over
  ``BlockPredictor`` at ``max_batch=32``: a burst of 224 images from 8
  client threads and 4 batch requests, every result held against a
  direct forward, the logits against the same weights on the CPU, then
  the same burst under torch.profiler.

Weights are random from ``--seed``.  Each phase prints one JSON line;
any failed check exits non-zero.  The last three lines are the card's
name and power limit as nvidia-smi reports them, the kernel table, and
``{"ok": true, "device": {...}}``.

Timings: CUDA events around many back-to-back launches divided by the
count (flash inputs warm in L2, as a prefill finds them right after its
QKV projection; the conv kernels' stage-1 tensors exceed L2).
``bound_ms`` is the larger of the bytes the function must move (each
input read once, each output written once) over 3.35 TB/s and the
operations it needs on these inputs over the fp32 CUDA-core peak of
67 TFLOP/s (NVIDIA H100 SXM data sheet).  TF32 is off throughout.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
KERNEL_ATOL = 1e-4      # kernel vs plain, both fp32, other summation order
LOGITS_ATOL = 1e-3      # card vs CPU logits through 12 fp32 layers
# conv kernels vs plain (cuBLAS / cuDNN fp32), relative to max |out|:
# sums of up to 9*512 products in another order (~1e-6 expected)
CONV_RTOL = 1e-4
# ResNet-50 logits, relative to max |logit|: served vs direct forward
# (other batch sizes, so other cuDNN algorithms) and card vs CPU
# (cuDNN and the kernels vs oneDNN, 53 fp32 layers)
RESNET_RTOL = 1e-4
RESNET50 = dict(classes=1000, layout="NHWC", fuse_block=True)
IMAGE = (224, 224, 3)
MAX_BATCH = 32
CLIENTS, PER_CLIENT, BATCH_REQS, BATCH_SIZE = 8, 24, 4, 8
# ResNet-50 v1's fused boundaries at batch 32: (N, H, W, C, Cout), and
# how many bottlenecks of one forward run each shape
CONV1X1_SHAPES = [(32, 56, 56, 64, 256), (32, 28, 28, 128, 512),
                  (32, 14, 14, 256, 1024), (32, 7, 7, 512, 2048)]
CONV3X3_SHAPES = [(32, 56, 56, 64, 64), (32, 28, 28, 128, 128),
                  (32, 14, 14, 256, 256), (32, 7, 7, 512, 512)]
BLOCKS_PER_STAGE = (3, 4, 6, 3)
RAGGED_SHAPES = [(2, 9, 10, 16, 24), (3, 7, 7, 16, 40), (1, 5, 13, 8, 130),
                 (2, 7, 7, 20, 70)]
GPT2_SMALL = dict(vocab=50257, dim=768, heads=12, depth=12, max_len=1024)
PROMPT_LENGTHS = (9, 16, 33, 100, 250, 511, 700, 1000)
MAX_NEW = 16


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(b, h, t, d, causal):
    """Least time for attention forward on these shapes: q, k, v read
    and o written once (fp32); QK^T and PV at 2 flops per multiply-add
    over the (i, j) pairs the mask keeps."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * b * h * pairs * d
    nbytes = 4.0 * b * h * t * d * 4
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    smi = None
    if shutil.which("nvidia-smi"):
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        smi = proc.stdout.strip().splitlines()[0] if proc.stdout else None
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build(names):
    from incubator_mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build(names, verbose=True)
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3),
          "built": sorted(logs), "ptxas": ptxas})


def phase_kernels():
    """Flash-attention forward: kernel vs its plain version at the
    prefill shapes (B=1, H=12, D=64, T in the buckets), causal and
    full, plus small D=32/128 and ragged-tile cases."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.parallel.flash_attention import (
        _flash_plain, flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1, 12, 16, 64), (1, 12, 128, 64), (1, 12, 1024, 64),
              (2, 4, 64, 32), (1, 2, 96, 128), (3, 2, 80, 16)]
    rows, worst = [], 0.0
    for b, h, t, d in shapes:
        q, k, v = (torch.randn((b, h, t, d), device="cuda", generator=gen)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        blk = min(32, t) if t % 32 == 0 else 16
        for causal in (True, False):
            out = flash_attention(q, k, v, causal=causal, block_q=blk,
                                  block_k=blk)
            ref = _flash_plain(q, k, v, causal, scale)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"flash kernel gave non-finite values at "
                     f"{(b, h, t, d)} causal={causal}")
            err = (out - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            worst = max(worst, err)
            row = {"shape": [b, h, t, d], "causal": causal,
                   "max_abs_err": err, "max_rel_err": rel}
            if d == 64:
                row["kernel_ms"] = time_ms(lambda: flash_attention(
                    q, k, v, causal=causal, block_q=blk, block_k=blk))
                row["plain_ms"] = time_ms(
                    lambda: _flash_plain(q, k, v, causal, scale))
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, scale=scale))
                row["bound_ms"], row["bound_by"] = flash_bound_ms(
                    b, h, t, d, causal)
            rows.append(row)
            if err > KERNEL_ATOL:
                fail(f"flash kernel disagrees with its plain version at "
                     f"{(b, h, t, d)} causal={causal}: {err} > "
                     f"{KERNEL_ATOL}")
    emit({"phase": "kernels", "kernel": "flash_attention_fwd",
          "atol": KERNEL_ATOL, "rows": rows})
    ref = next(r for r in rows
               if r["shape"] == [1, 12, 1024, 64] and r["causal"])
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "incubator_mxnet_tpu/parallel/flash_attention.py:27",
            "max_abs_err": worst, "ms": ref["kernel_ms"],
            "plain_ms": ref["plain_ms"], "bound_ms": ref["bound_ms"],
            "bound_by": ref["bound_by"], "library_ms": ref["library_ms"]}


def conv_bound_ms(n, h, w, c, cout, taps):
    """Least time for relu(x*a + b) through a stride-1 conv with
    ``taps`` taps plus bias: x, a, b, the weight and the bias read and
    the output written once (fp32); 2 flops per multiply-add."""
    flops = 2.0 * n * h * w * cout * c * taps
    nbytes = 4.0 * (n * h * w * (c + cout) + cout * c * taps + 2 * c + cout)
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _conv_case(gen, n, h, w, c, cout, taps):
    cl = torch.channels_last
    k = 3 if taps == 9 else 1
    x = torch.randn((n, c, h, w), device="cuda", generator=gen).contiguous(
        memory_format=cl)
    a = torch.rand((c,), device="cuda", generator=gen) + 0.5
    b = torch.randn((c,), device="cuda", generator=gen) * 0.1
    wt = (torch.randn((cout, c, k, k), device="cuda", generator=gen)
          * math.sqrt(2.0 / (c * taps))).contiguous(memory_format=cl)
    bias = torch.randn((cout,), device="cuda", generator=gen) * 0.1
    return x, a, b, wt, bias


def phase_kernels_conv():
    """The fused BN -> ReLU -> conv kernels against their plain versions
    at ResNet-50 v1's eight fused shapes at batch 32 (timed, with the
    unfused cuDNN composition as yardstick) and at ragged shapes (H != W,
    W = 7, few channels, Cout not a multiple of the tiles)."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    gen = torch.Generator(device="cuda").manual_seed(1)
    kernels = {}
    for name, taps, shapes, plain in (
            ("sbr_matmul", 1, CONV1X1_SHAPES, fc._sbr_matmul_plain),
            ("sbr_conv3x3", 9, CONV3X3_SHAPES, fc._sbr_conv3x3_plain)):
        kern = getattr(fc, name)
        rows, worst = [], 0.0
        for shape in shapes + RAGGED_SHAPES:
            x, a, b, wt, bias = _conv_case(gen, *shape, taps)
            out = kern(x, a, b, wt, bias)
            ref = plain(x, a, b, wt, bias)
            torch.cuda.synchronize()
            if not out.is_contiguous(memory_format=torch.channels_last):
                fail(f"{name} output is not channels-last at {shape}")
            if not torch.isfinite(out).all():
                fail(f"{name} gave non-finite values at {shape}")
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            worst = max(worst, err)
            row = {"shape": list(shape), "max_abs_err": err,
                   "ref_abs_max": scale}
            if shape in shapes:
                pad = 1 if taps == 9 else 0

                def unfused():
                    y = torch.relu(x * a.view(1, -1, 1, 1)
                                   + b.view(1, -1, 1, 1))
                    return F.conv2d(y, wt, bias, padding=pad)

                row["kernel_ms"] = time_ms(lambda: kern(x, a, b, wt, bias))
                row["plain_ms"] = time_ms(lambda: plain(x, a, b, wt, bias))
                row["library_ms"] = time_ms(unfused)
                row["bound_ms"], row["bound_by"] = conv_bound_ms(
                    *shape, taps)
            rows.append(row)
            if err > CONV_RTOL * scale:
                fail(f"{name} disagrees with its plain version at {shape}: "
                     f"{err} > {CONV_RTOL} x {scale}")
        emit({"phase": "kernels_conv", "kernel": name, "rtol": CONV_RTOL,
              "library": "F.conv2d(relu(x*a+b), w, bias): unfused cuDNN "
                         "fp32", "rows": rows})
        # one b=32 forward runs each path shape once per bottleneck
        timed = rows[:len(shapes)]
        per_fwd = {key: sum(n * r[key] for n, r in
                            zip(BLOCKS_PER_STAGE, timed))
                   for key in ("kernel_ms", "plain_ms", "library_ms",
                               "bound_ms")}
        source = "3x3" if taps == 9 else "1x1"
        line = 58 if taps == 9 else 49
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/{name}.cu",
            "replaces": f"incubator_mxnet_tpu/ops/fused_conv.py:{line}",
            "max_abs_err": worst, "ms": per_fwd["kernel_ms"],
            "plain_ms": per_fwd["plain_ms"],
            "bound_ms": per_fwd["bound_ms"],
            "bound_by": timed[0]["bound_by"],
            "library_ms": per_fwd["library_ms"],
            "per": f"the 16 fused {source} boundaries of one b=32 "
                   "ResNet-50 forward"}
    torch.cuda.empty_cache()
    return kernels


def _burst(server, images):
    """The ResNet traffic: CLIENTS threads of PER_CLIENT single-image
    submits and BATCH_REQS submit_batch calls of BATCH_SIZE, all at
    once.  Returns (outputs in image order, end-to-end ms per request,
    wall seconds)."""
    import threading
    singles = CLIENTS * PER_CLIENT
    futs, lat = [None] * (CLIENTS + BATCH_REQS), []
    lock = threading.Lock()

    def watch(submit, *args):
        t_sub = time.perf_counter()
        fut = submit(*args)

        def done(_):
            with lock:
                lat.append((time.perf_counter() - t_sub) * 1e3)
        fut.add_done_callback(done)
        return fut

    def client(i):
        futs[i] = [watch(server.submit, images[i * PER_CLIENT + j])
                   for j in range(PER_CLIENT)]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for k in range(BATCH_REQS):
        lo = singles + k * BATCH_SIZE
        futs[CLIENTS + k] = [watch(server.submit_batch,
                                   images[lo:lo + BATCH_SIZE])]
    for t in threads:
        t.join()
    outs = [f.result(timeout=600) for group in futs for f in group]
    wall = time.perf_counter() - t0
    got = np.concatenate([np.stack(outs[:singles])] + outs[singles:])
    return got, lat, wall


def phase_resnet_serving(seed):
    """ResNet-50 v1 at full width and depth through ModelServer: warmup
    over every bucket, then the burst with the kernel counts set to 0
    just before it and read just after."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from incubator_mxnet_tpu_torch.ops import sbr_conv3x3, sbr_matmul
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    from incubator_mxnet_tpu_torch.predict import BlockPredictor
    from incubator_mxnet_tpu_torch.serving import ModelServer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = get_resnet(1, 50, device="cuda:0", seed=seed, **RESNET50)
    pred = BlockPredictor(net)
    server = ModelServer(pred, max_batch=MAX_BATCH, input_shapes=[IMAGE])
    server.warmup()
    setup_s = time.perf_counter() - t0
    n_images = CLIENTS * PER_CLIENT + BATCH_REQS * BATCH_SIZE
    images = np.random.RandomState(seed).rand(n_images, *IMAGE).astype(
        np.float32)
    flash_before = flash_attention.launches
    before = server.stats()
    sbr_matmul.launches = sbr_conv3x3.launches = 0
    got, lat, wall = _burst(server, images)
    launches = {"sbr_matmul": sbr_matmul.launches,
                "sbr_conv3x3": sbr_conv3x3.launches}
    stats = server.stats()
    forwards = stats["batches"] - before["batches"]
    if forwards < 1 or any(v != 16 * forwards for v in launches.values()):
        fail(f"ResNet path launched {launches} over {forwards} forwards; "
             f"expected 16 x forwards of each kernel")
    if flash_attention.launches != flash_before:
        fail("the ResNet path launched the flash kernel")
    if got.shape != (n_images, 1000) or not np.isfinite(got).all():
        fail(f"bad served logits: shape {got.shape}")
    direct = pred.predict(images, batch_size=MAX_BATCH).cpu().numpy()
    err = float(np.abs(got - direct).max())
    scale = float(np.abs(direct).max())
    if err > RESNET_RTOL * scale:
        fail(f"served logits differ from direct forwards by {err} > "
             f"{RESNET_RTOL} x {scale}")
    # per-bucket costs: host-to-device copy of a padded batch, and the
    # forward on device-resident input
    fwd_ms, h2d_ms = {}, {}
    with torch.inference_mode():
        for bsz in (1, MAX_BATCH):
            host = images[:bsz].copy()
            dev = torch.from_numpy(host).cuda()
            h2d_ms[bsz] = _host_ms(lambda: torch.from_numpy(host).cuda())
            fwd_ms[bsz] = time_ms(lambda: net(dev), iters=10, warmup=2)
    lat.sort()
    emit({"phase": "resnet_serving", "images": n_images,
          "requests": len(lat), "wall_s": wall,
          "images_per_s": n_images / wall, "batches": forwards,
          "mean_fill": (stats["examples"] - before["examples"])
          / (stats["padded"] - before["padded"]),
          "e2e_p50_ms": lat[len(lat) // 2],
          "e2e_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
          "exec_s": stats["exec_s"] - before["exec_s"],
          "forward_ms": fwd_ms, "h2d_copy_ms": h2d_ms,
          "launches": launches, "served_vs_direct_max_abs_err": err,
          "logits_abs_max": scale, "setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, net, server, images


def _host_ms(fn, iters=10):
    """Host clock around ``fn`` ending in a synchronise (a copy from
    pageable memory returns only when it is done)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_resnet_reference(net, images, seed):
    """The same weights on the CPU (the plain path), 2 images at 224x224:
    logits within RESNET_RTOL of max |logit|."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    cpu = get_resnet(1, 50, device="cpu", seed=seed, **RESNET50).eval()
    cpu.load_state_dict(net.state_dict())
    x = images[:2]
    with torch.inference_mode():
        lg_gpu = net(torch.from_numpy(x).cuda()).cpu()
        lg_cpu = cpu(torch.from_numpy(x))
    if not torch.isfinite(lg_gpu).all():
        fail("non-finite ResNet logits on the card")
    err = (lg_gpu - lg_cpu).abs().max().item()
    scale = lg_cpu.abs().max().item()
    emit({"phase": "resnet_reference", "logits_max_abs_err": err,
          "logits_abs_max": scale, "rtol": RESNET_RTOL,
          "argmax_equal": bool(torch.equal(lg_gpu.argmax(1),
                                           lg_cpu.argmax(1)))})
    if err > RESNET_RTOL * scale:
        fail(f"card vs CPU ResNet logits differ by {err} > {RESNET_RTOL} "
             f"x {scale}")


def _profile_summary(prof, wall):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    return {"wall_s": wall,
            "device_busy_s": busy_s if kernels else "not measured",
            "device_idle_share": 1 - busy_s / wall if kernels
            else "not measured",
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def phase_resnet_profile(server, images):
    """The same burst again under torch.profiler: the device's busy and
    idle share of the wall, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = _burst(server, images)
    emit(dict({"phase": "resnet_profile"}, **_profile_summary(prof, wall)))


def _engine(net):
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(net, slots=8, max_len=1024, kv_layout="paged",
                           block_size=16, prefix_cache=False)
    eng.warmup()
    return eng


def _serve(eng, greedy, sampled):
    """The smoke's traffic: every greedy prompt plus the sampled one
    twice, all submitted at once.  Returns (outputs, wall seconds)."""
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in greedy]
    futs += [eng.submit(sampled, max_new_tokens=MAX_NEW, temperature=0.8,
                        seed=123) for _ in range(2)]
    outs = [f.result(timeout=600) for f in futs]
    return outs, time.perf_counter() - t0


def phase_generation(seed):
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    t0 = time.perf_counter()
    net = TransformerDecoder(device="cuda:0", seed=seed, **GPT2_SMALL)
    eng = _engine(net)
    setup_s = time.perf_counter() - t0
    rs = np.random.RandomState(seed)
    vocab = GPT2_SMALL["vocab"]
    greedy = [rs.randint(0, vocab, size=L).tolist() for L in PROMPT_LENGTHS]
    sampled = rs.randint(0, vocab, size=40).tolist()
    try:
        flash_attention.launches = 0
        outs, wall = _serve(eng, greedy, sampled)
        launches = flash_attention.launches
        stats = eng.stats()
    finally:
        eng.close()
    prefills = stats["prefills"]
    if prefills != len(outs):
        fail(f"{prefills} prefills for {len(outs)} requests")
    if launches != GPT2_SMALL["depth"] * prefills:
        fail(f"flash kernel launched {launches} times on the main path, "
             f"expected {GPT2_SMALL['depth']} x {prefills} prefills")
    for o in outs:
        if o.shape != (MAX_NEW,) or o.min() < 0 or o.max() >= vocab:
            fail(f"bad generated tokens {o!r}")
    if not np.array_equal(outs[-1], outs[-2]):
        fail(f"sampled request (seed 123) differed between submissions: "
             f"{outs[-2].tolist()} vs {outs[-1].tolist()}")
    tokens = int(sum(o.size for o in outs))
    emit({"phase": "generation", "requests": len(outs),
          "generated_tokens": tokens, "wall_s": wall,
          "tokens_per_s": tokens / wall, "prefill_s": stats["prefill_s"],
          "decode_s": stats["decode_s"], "prefills": prefills,
          "decodes": stats["decodes"], "setup_s": setup_s,
          "flash_launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    phase_reference(net, greedy, outs)
    return launches, net, greedy, sampled


def phase_profile(net, greedy, sampled):
    """The same traffic again under torch.profiler —
    device time by kernel, and the device's busy share of the wall (the
    profiler's own host cost inflates the wall, so the busy share is a
    lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(net)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _serve(eng, greedy, sampled)
        stats = eng.stats()
    finally:
        eng.close()
    emit(dict({"phase": "profile", "prefill_s": stats["prefill_s"],
               "decode_s": stats["decode_s"], "decodes": stats["decodes"]},
              **_profile_summary(prof, wall)))


def phase_reference(net, greedy, outs):
    """The same weights on the CPU (plain path): last-position prefill
    logits within LOGITS_ATOL, and the greedy tokens of the two
    shortest requests identical."""
    from incubator_mxnet_tpu_torch.gluon.decoder import TransformerDecoder
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    cpu = TransformerDecoder(device="cpu", **GPT2_SMALL)
    cpu.load_state_dict(net.state_dict())
    prompt = greedy[3]                      # 100 tokens, bucket 128
    toks = np.zeros((1, 128), np.int64)
    toks[0, :len(prompt)] = prompt
    with torch.inference_mode():
        lg_gpu = net.prefill(torch.from_numpy(toks).cuda(), len(prompt))[0]
        lg_cpu = cpu.prefill(torch.from_numpy(toks), len(prompt))[0]
    lg_gpu = lg_gpu.cpu()
    if not torch.isfinite(lg_gpu).all():
        fail("non-finite prefill logits on the card")
    err = (lg_gpu - lg_cpu).abs().max().item()
    with GenerationEngine(cpu, device="cpu", slots=2, max_len=1024,
                          block_size=16) as ceng:
        futs = [ceng.submit(greedy[i], max_new_tokens=MAX_NEW)
                for i in (0, 1)]
        ref = [f.result(timeout=600) for f in futs]
    same = [bool(np.array_equal(r, outs[i])) for i, r in enumerate(ref)]
    emit({"phase": "reference", "logits_max_abs_err": err,
          "logits_atol": LOGITS_ATOL, "logits_abs_max":
          lg_cpu.abs().max().item(), "greedy_equal": same})
    if err > LOGITS_ATOL:
        fail(f"card vs CPU prefill logits differ by {err} > {LOGITS_ATOL}")
    if not all(same):
        fail(f"greedy tokens differ between card and CPU: "
             f"{[r.tolist() for r in ref]} vs "
             f"{[o.tolist() for o in outs[:2]]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # the port must be importable before anything is printed: alone in a
    # directory this script fails here, with no result
    import incubator_mxnet_tpu_torch  # noqa: F401
    smi = phase_device()
    # fp32 means fp32: no TF32 in cuBLAS or cuDNN on either side
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(["flash_attention", "sbr_matmul", "sbr_conv3x3"])
    kernels = [phase_kernels()]
    conv = phase_kernels_conv()
    launches, net, greedy, sampled = phase_generation(args.seed)
    kernels[0]["launches"] = launches
    phase_profile(net, greedy, sampled)
    del net
    torch.cuda.empty_cache()
    conv_launches, rnet, server, images = phase_resnet_serving(args.seed)
    try:
        phase_resnet_reference(rnet, images, args.seed)
        phase_resnet_profile(server, images)
    finally:
        server.close()
    for name, k in conv.items():
        k["launches"] = conv_launches[name]
        kernels.append(k)
    print(smi or "nvidia-smi: not available", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
