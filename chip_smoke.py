"""On-card smoke test of the PyTorch port (incubator_mxnet_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

It builds every hand-written kernel from ``incubator_mxnet_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version
on the card, then drives the port's main path — the continuous-batching
generation server at GPT-2-small widths (vocab 50257, dim 768, 12 heads,
12 layers, max_len 1024; random weights from ``--seed``) — and checks
its output against the same weights on the CPU, then serves the same
traffic once more under torch.profiler.  Each phase prints one
JSON line; any failed check exits non-zero.  The last three lines are
the card's name and power limit as nvidia-smi reports them, the kernel
table, and ``{"ok": true, "device": {...}}``.

Timings: CUDA events around many back-to-back launches (inputs warm in
L2, as a prefill finds them right after its QKV projection), divided
by the count.  ``bound_ms`` is the larger of the bytes the function
must move (each input read once, each output written once) over
3.35 TB/s and the operations it needs on these inputs over the fp32
CUDA-core peak of 67 TFLOP/s (NVIDIA H100 SXM data sheet).
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "profile", "wall_s": wall,
          "device_busy_s": busy_s if kernels else "not measured",
          "device_idle_share": 1 - busy_s / wall if kernels
          else "not measured",
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          "decodes": stats["decodes"],
          "top_kernels": [{"name": e.key[:90], "count": e.count,
                           "device_ms": e.self_device_time_total / 1e3}
                          for e in top]})


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
    phase_build(["flash_attention"])
    kernels = [phase_kernels()]
    launches, net, greedy, sampled = phase_generation(args.seed)
    kernels[0]["launches"] = launches
    phase_profile(net, greedy, sampled)
    print(smi or "nvidia-smi: not available", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
