"""Time the port's B4 kernel (csrc/chain_emit.cu) on one GPU at ResNet-50
v1's four chain shapes (b=128): the kernel as shipped, every tile it
could take, builds with one part of its work changed, a parent
checkout's kernel, and the unfused cuDNN composition; and the peak rate
of mma.sync tf32 on this card.

    python3 tools/port_chain_sweep.py [--parent PARENT_TREE]
        [--tiles "BM,BN,WGM,WGN ..."] [--diag "cvt nopro ..."]

Run from the repository root.  The tiles are built from this checkout's
``csrc/chain_emit.cu`` with one extra C entry that launches a given
``tc::Tile``; ``--diag`` builds also change ``csrc/tc_gemm.cuh``:

* ``cvt``: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of the
  integer add and mask;
* ``nopro``: no BN1 affine / ReLU / tap mask at A fragment load;
* ``onemma``: one TF32 product instead of the three of 3xTF32;
* ``noload``: no cp.async copies (the ring is never filled).

The last three compute wrong values: they only say what the removed
work costs.  With ``--parent``, the parent's ``chain_emit.cu`` (built
against its own ``csrc``) and this checkout's are timed in turns
(parent, change, change, parent).  Every row is one JSON line; times are
CUDA events over 20 launches after 3 warm-up launches, fp32 inputs as
``chip_smoke.py`` makes them, TF32 off for PyTorch's own calls.  Builds
go to ``incubator_mxnet_tpu_torch/_build/sweep``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import fused_chain as fc  # noqa: E402

CSRC = os.path.abspath(os.path.join("incubator_mxnet_tpu_torch", "csrc"))
OUT = os.path.join(_build.BUILD_DIR, "sweep")
TILES = ("64,64,2,2 128,128,2,4 96,128,2,4 64,128,2,4 48,128,1,4 "
         "64,64,2,4 32,64,2,4")
ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
DIAG = {
    "cvt": [(ROUND, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : '
                    '"=r"(r) : "f"(x));\n  return r;\n')],
    "nopro": [("const float y = fmaxf(\n"
               "            fmaf(__uint_as_float(r[q]), ca[kk][q / 2], "
               "cb[kk][q / 2]), 0.f);",
               "const float y = __uint_as_float(r[q]);"),
              ("split(in[i][q % 2] ? y : 0.f, ab[q], asm_[q]);",
               "split(y, ab[q], asm_[q]);")],
    "onemma": [("  mma(d, as, bb);\n  mma(d, ab, bs);\n", "")],
    "noload": [("    if (s < steps) load(s, s);\n", ""),
               ("    if (next < steps) load(next, next % STAGES);\n", "")],
}
TILE_ENTRY = r'''
extern "C" int mx_chain_emit_tile(const void* x, const void* a1,
    const void* b1, const void* w2, const void* a2, const void* b2,
    const void* w3, const void* b3, void* out, int n, int h, int w, int c,
    int cm, int co, void* stream, int tile) {
  const tc::Conv p{static_cast<const float*>(x),
                   static_cast<const float*>(a1),
                   static_cast<const float*>(b1),
                   static_cast<const float*>(w2), n * h * w, c, cm, h, w,
                   c % 4 == 0 && aligned16(x) && aligned16(w2)};
  const Emit e{static_cast<const float*>(a2), static_cast<const float*>(b2),
               static_cast<const float*>(w3), static_cast<const float*>(b3),
               static_cast<float*>(out), co, cm % 4 == 0 && aligned16(w3),
               co % 4 == 0 && aligned16(out) && aligned16(b3)};
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
@CASES@
  }
  return (int)cudaErrorInvalidValue;
}
'''
MMA_PEAK = r'''
#include <cuda_runtime.h>
#include <stdint.h>
// 8 independent m16n8k8 tf32 products a warp, repeated
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_run(void* out, int blocks, int iters, void* st) {
  mma_peak<<<blocks, 256, 0, (cudaStream_t)st>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
'''
PTRS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def emit(obj):
    print(json.dumps(obj), flush=True)


def write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def substitute(text, pairs):
    for old, new in pairs:
        if old not in text:
            sys.exit(f"diag substitution not found: {old!r}")
        text = text.replace(old, new)
    return text


def build(jobs):
    """``{name: (source, include dirs)}`` -> ``{name: CDLL}``, one nvcc
    each, all started together."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (src, incs) in jobs.items():
        lib = os.path.join(OUT, f"lib{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas=-v",
               *[f"-I{d}" for d in incs], "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc exit {proc.returncode}\n{log[-3000:]}")
        emit({"build": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                       if "registers" in ln or "spill" in ln]})
        libs[name] = ctypes.CDLL(lib)
    return libs


def mma_peak(lib):
    fn = lib.mma_peak_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 4 * 256, device="cuda")
    iters = 4096
    for per_sm in (1, 2, 4):
        blocks = sms * per_sm
        ms = cs.time_ms(lambda: fn(buf.data_ptr(), blocks, iters,
                                   torch.cuda.current_stream().cuda_stream),
                        iters=5)
        flops = 2.0 * 16 * 8 * 8 * 8 * iters * blocks * 8
        emit({"mma_sync_tf32_tflops": flops / ms / 1e9,
              "ctas_per_sm": per_sm, "ms": ms})


def unfused(x, a1, b1, w2, a2, b2, w3, b3):
    conv = torch.nn.functional.conv2d
    c2 = conv(torch.relu(x * a1.view(1, -1, 1, 1) + b1.view(1, -1, 1, 1)),
              w2, padding=1)
    return conv(torch.relu(c2 * a2.view(1, -1, 1, 1)
                           + b2.view(1, -1, 1, 1)), w3, b3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a parent checkout's root")
    ap.add_argument("--tiles", default=TILES)
    ap.add_argument("--diag", default="")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    tiles = args.tiles.split()
    diags = args.diag.split()
    cases = "\n".join(f"    case {i}: return fits<tc::Tile<{t}>>(cm, max_smem)"
                      f" ? launch_emit<tc::Tile<{t}>>(p, e, s)"
                      f" : (int)cudaErrorInvalidValue;"
                      for i, t in enumerate(tiles))
    with open(os.path.join(CSRC, "chain_emit.cu")) as f:
        src = f.read() + TILE_ENTRY.replace("@CASES@", cases)
    with open(os.path.join(CSRC, "tc_gemm.cuh")) as f:
        header = f.read()
    jobs = {"peak": (write(os.path.join(OUT, "peak.cu"), MMA_PEAK), []),
            "tiles": (write(os.path.join(OUT, "tiles.cu"), src), [CSRC])}
    for d in diags:
        write(os.path.join(OUT, d, "tc_gemm.cuh"),
              substitute(header, DIAG[d]))
        jobs[d] = (write(os.path.join(OUT, d, "tiles.cu"), src),
                   [os.path.join(OUT, d), CSRC])
    if args.parent:
        psrc = os.path.join(os.path.abspath(args.parent),
                            "incubator_mxnet_tpu_torch", "csrc")
        jobs["parent"] = (os.path.join(psrc, "chain_emit.cu"), [psrc])
    libs = build(jobs)
    mma_peak(libs["peak"])
    for name in ["tiles", *diags]:
        libs[name].mx_chain_emit_tile.argtypes = PTRS + [ctypes.c_int]
    if args.parent:
        libs["parent"].mx_chain_emit.argtypes = PTRS
    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape in cs.CHAIN_SHAPES:
        t = cs._chain_case(gen, *shape)
        ops = [t[k] for k in ("x", "a1", "b1", "w2", "a2", "b2", "w3", "b3")]
        ref = fc._chain_emit_plain(*ops)
        scale = ref.abs().max().item()
        out = torch.empty_like(ref)
        call = [o.data_ptr() for o in ops] + [out.data_ptr()]
        n, h, w, c, cm, co = shape
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib, tile=None):
            fn = lib.mx_chain_emit if tile is None else lib.mx_chain_emit_tile
            extra = () if tile is None else (tile,)
            return lambda: fn(*call, n, h, w, c, cm, co, stream, *extra)

        row = {"shape": list(shape), "ref_abs_max": scale,
               "bound_ms": cs.chain_bound_ms(*shape, emit=True)[0],
               "tiles": {}}
        for i, tile in enumerate(tiles):
            out.fill_(float("nan"))
            if launch(libs["tiles"], i)():
                row["tiles"][tile] = None      # does not fit
                continue
            torch.cuda.synchronize()
            entry = {"err": (out - ref).abs().max().item() / scale,
                     "ms": cs.time_ms(launch(libs["tiles"], i))}
            for d in diags:
                entry[d] = cs.time_ms(launch(libs[d], i))
            row["tiles"][tile] = entry
        kernel = lambda: fc.chain_emit(*ops)     # noqa: E731
        if args.parent:
            turns = [("parent", launch(libs["parent"])), ("change", kernel),
                     ("change", kernel), ("parent", launch(libs["parent"]))]
            row["turns_ms"] = [(who, cs.time_ms(fn)) for who, fn in turns]
        else:
            row["kernel_ms"] = cs.time_ms(kernel)
        row["library_ms"] = cs.time_ms(lambda: unfused(*ops))
        emit(row)
        del t, ops, ref, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
