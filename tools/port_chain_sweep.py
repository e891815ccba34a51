"""Time the port's kernels on the tensor-core main loops
(``csrc/tc_gemm.cuh``) on one GPU: B4 ``chain_emit`` and B3
``chain_stats`` at ResNet-50 v1's four chain shapes (b=128), B2
``sbr_conv3x3`` at its four fused 3x3 shapes and B1 ``sbr_matmul`` at its
four fused 1x1 shapes (b=32).  For each: the kernel as shipped, every
tile it could take, builds with one part of its work changed, a parent
checkout's kernel, and the unfused cuDNN composition; and the peak rate
of mma.sync tf32 on this card, with constant operands and as the 1x1
walker's inner loop feeds it (ldmatrix, 3xTF32).

    python3 tools/port_chain_sweep.py [--kernels "emit stats conv matmul"]
        [--parent PARENT_TREE] [--tiles "BM,BN,WGM,WGN ..."]
        [--matmul-tiles "BM,BN,WGM,WGN[,R] ..."] [--diag "cvt nopro ..."]

Run from the repository root.  The tiles are built from this checkout's
kernel source with one extra C entry that launches a given ``tc::Tile``
(a tile whose ring or y2 tile does not fit shows as null); a matmul tile
ending in ``,0`` streams A through the ring instead of keeping it
resident (``,1``, the default, keeps it when it fits).  ``--diag``
builds also change ``csrc/tc_gemm.cuh``:

* ``cvt``: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of the
  integer add and mask;
* ``nopro``: no BN affine / ReLU / tap mask at A fragment load;
* ``onemma``: one TF32 product instead of the three of 3xTF32;
* ``noload``: no cp.async copies (the ring is never filled);
* ``stages4``: a ring of 4 slots instead of 3 (a right result);
* ``noprep``: no split pass of the 1x1 walker (its operands unsplit);
* ``nopart``: products summed straight into the running sum, without
  the fresh fragment a slot (rounding toward zero over all of K);
* ``nostore``: the float4 stores of ``store_bias`` never taken (a
  run-time condition, so that the products stay);
* ``nosync``: no barrier in the 1x1 walker's ring;
* ``noldsm``: no ldmatrix in the 1x1 walker (fragments from registers).

Several joined by ``+`` (``noload+noprep``) make one build.  All but
``cvt`` and ``stages4`` compute wrong values: they only say what the removed
work costs.  With ``--parent``, the parent's kernel (built from its own
``csrc``) and this checkout's are timed in turns (parent, change,
change, parent).  Every row is one JSON line; ``err`` is the gate of
``chip_smoke.py`` against the plain version (of max |out| for emit and
conv, of the sums' mass for stats).  Times are CUDA events over 20
launches after 3 warm-up launches, fp32 inputs as ``chip_smoke.py``
makes them, TF32 off for PyTorch's own calls.  Builds go to
``incubator_mxnet_tpu_torch/_build/sweep``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import fused_chain as fc  # noqa: E402
from incubator_mxnet_tpu_torch.ops import fused_conv as fconv  # noqa: E402

CSRC = os.path.abspath(os.path.join("incubator_mxnet_tpu_torch", "csrc"))
OUT = os.path.join(_build.BUILD_DIR, "sweep")
TILES = ("64,64,2,2 128,64,2,2 128,128,2,4 96,128,2,4 64,128,2,4 "
         "48,128,1,4 32,128,1,4 64,64,2,4 32,64,2,4")
MATMUL_TILES = ("64,64,2,2 64,64,2,2,0 128,64,2,2 128,64,2,2,0 "
                "64,128,2,2 128,128,2,4 64,128,2,4 32,128,1,4 32,64,1,2 "
                "64,32,2,1")
ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
DIAG = {
    "cvt": [(ROUND, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : '
                    '"=r"(r) : "f"(x));\n  return r;\n')],
    "nopro": [("const float y = fmaxf(fmaf(__uint_as_float(r[q]), a[0], "
               "b[0]), 0.f);",
               "const float y = __uint_as_float(r[q]);"),
              ("split(in[i][q % 2] ? y : 0.f, ab[q], asm_[q]);",
               "split(y, ab[q], asm_[q]);")],
    "onemma": [("  mma(d, as, bb);\n  mma(d, ab, bs);\n", "")],
    "noload": [("    if (s < steps) load(s, s);\n", ""),
               ("    if (next < steps) load(next, next % STAGES);\n", "")],
    "noprep": [("  if (steps > 0) prep(0, 0);\n", ""),
               ("    if (s + 1 < steps) prep(s + 1, (s + 1) % STAGES);\n",
                "")],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "nopart": [("  Acc<T> part;\n  zero<T>(part);\n",
                "  Acc<T>& part = acc;\n"),
               ("      for (int q = 0; q < 4; ++q) acc[i][j][q] += "
                "part[i][j][q];\n", "        ;\n")],
    "nostore": [("        if (m < M && nc < N) {\n",
                 "        if (m < M && nc < N && M < 0) {\n")],
    "nosync": [("    __syncthreads();             // step s split; slot (s-1) "
                "free\n", "")],
    "noldsm": [("      ldsm4(abig, ab + off);\n"
                "      if constexpr (T::TF32) ldsm4(asml, as + off);\n",
                "      for (int q = 0; q < 4; ++q)\n"
                "        abig[q] = asml[q] = off + q;\n"),
               ("  ldsm4(r, big + off);\n  ldsm4(q, small + off);\n",
                "  for (int h = 0; h < 4; ++h) r[h] = q[h] = off + h;\n")],
}
P, I = ctypes.c_void_p, ctypes.c_int
# Per kernel: its source, C entry and signature (pointers, ints), the
# extra entry that launches tile @CASES@, and each case's launch.
KERNELS = {
    "emit": dict(
        source="chain_emit.cu", fn="mx_chain_emit", nptrs=9, nints=6,
        entry=r'''
extern "C" int mx_chain_emit_tile(const void* x, const void* a1,
    const void* b1, const void* w2, const void* a2, const void* b2,
    const void* w3, const void* b3, void* out, int n, int h, int w, int c,
    int cm, int co, void* stream, int tile) {
  const tc::Conv<float> p =
      tc::conv_operands<float>(x, a1, b1, w2, n, h, w, c, cm);
  const Emit<float> e{static_cast<const float*>(a2),
                      static_cast<const float*>(b2),
                      static_cast<const float*>(w3),
                      static_cast<const float*>(b3),
                      static_cast<float*>(out), co,
                      cm % 4 == 0 && aligned16(w3),
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
''',
        case="fits<T>(cm, max_smem) ? launch_emit<T>(p, e, s) "
             ": (int)cudaErrorInvalidValue"),
    "stats": dict(
        source="chain_stats.cu", fn="mx_chain_stats", nptrs=8, nints=5,
        entry=r'''
extern "C" int mx_chain_stats_tile(const void* x, const void* a1,
    const void* b1, const void* w2, const void* shift, void* part,
    void* sum, void* sq, int n, int h, int w, int c, int cm, void* stream,
    int tile) {
  const tc::Conv<float> p =
      tc::conv_operands<float>(x, a1, b1, w2, n, h, w, c, cm);
  const TileSums epi{static_cast<const float*>(shift),
                     static_cast<float*>(part)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
@CASES@
  }
  return (int)cudaErrorInvalidValue;
}
''',
        case="launch_stats<T>(p, epi, sum, sq, s)"),
    "conv": dict(
        source="sbr_conv3x3.cu", fn="mx_sbr_conv3x3", nptrs=6, nints=5,
        entry=r'''
extern "C" int mx_sbr_conv3x3_tile(const void* x, const void* a,
    const void* b, const void* w, const void* bias, void* out, int n, int h,
    int w_, int c, int cout, void* stream, int tile) {
  const tc::Conv<float> p =
      tc::conv_operands<float>(x, a, b, w, n, h, w_, c, cout);
  const StoreBias<float> epi = epilogue<float>(bias, out, cout);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
@CASES@
  }
  return (int)cudaErrorInvalidValue;
}
''',
        case="tc::launch_conv3x3<T>(p, epi, s)"),
    "matmul": dict(
        source="sbr_matmul.cu", fn="mx_sbr_matmul", nptrs=6, nints=3,
        entry=r'''
extern "C" int mx_sbr_matmul_tile(const void* x, const void* a,
    const void* b, const void* w, const void* bias, void* out, int m, int k,
    int cout, void* stream, int tile) {
  const tc::Gemm1x1<float> p = operands<float>(x, a, b, w, m, k, cout);
  const StoreBias<float> epi = epilogue<float>(bias, out, cout);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
@CASES@
  }
  return (int)cudaErrorInvalidValue;
}
''',
        case="tc::launch_gemm1x1<T>(p, epi, s, @RESIDENT@)"),
}
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
// The 1x1 walker's inner loop alone: 8 warps of 64 x 32, each k-step's
// big and small A and B fragments by ldmatrix from a shared tile, then
// the three product passes over the 4 x 4 mma tiles (no copies, no
// split, no barrier)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void mma1(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__global__ void __launch_bounds__(256) mma3_ldsm_peak(float* out,
                                                      int iters) {
  __shared__ __align__(16) float sm[2][128 * 36];
  for (int i = threadIdx.x; i < 2 * 128 * 36; i += 256)
    (&sm[0][0])[i] = 1.0f + i * 1e-6f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ab[4][4], as[4][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (wm * 64 + i * 16 + (lane & 7) + (lane & 8)) * 36 +
                        kk * 8 + (lane >> 4) * 4;
        ldsm4(ab[i], sm[0] + off);
        ldsm4(as[i], sm[1] + off);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4], q[4];
        const int off = (wn * 32 + jp * 16 + (lane & 7) + (lane >> 4) * 8) *
                            36 + kk * 8 + ((lane & 8) >> 1);
        ldsm4(r, sm[0] + off);
        ldsm4(q, sm[1] + off);
        for (int h = 0; h < 4; ++h) {
          bb[2 * jp + h / 2][h % 2] = r[h];
          bs[2 * jp + h / 2][h % 2] = q[h];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma1(acc[i][j], as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma1(acc[i][j], ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma1(acc[i][j], ab[i], bb[j]);
    }
  }
  float s = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      for (int q = 0; q < 4; ++q) s += acc[i][j][q];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
extern "C" int mma3_ldsm_peak_run(void* out, int blocks, int iters,
                                  void* st) {
  mma3_ldsm_peak<<<blocks, 256, 0, (cudaStream_t)st>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
'''


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


def ptxas_report(log):
    """ptxas's registers and spills per kernel, the kernel named by its
    tile (``BM,BN,WGM,WGN``) where it has one."""
    rows, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            tile = re.search(r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                             line)
            name = ",".join(tile.groups()) if tile else line.split()[-1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            rows.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return rows


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
        emit({"build": name, "ptxas": ptxas_report(log)})
        libs[name] = ctypes.CDLL(lib)
    return libs


def mma_peak(lib):
    fn = lib.mma_peak_run
    fn.argtypes = [P, I, I, P]
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
    # the 1x1 walker's inner loop: ldmatrix-fed 3xTF32 at a 64 x 32 warp
    # tile, 8 warps a CTA (48 products a k-step, 4 k-steps an iteration)
    fn = lib.mma3_ldsm_peak_run
    fn.argtypes = [P, I, I, P]
    iters = 1024
    for per_sm in (1, 2):
        blocks = sms * per_sm
        ms = cs.time_ms(lambda: fn(buf.data_ptr(), blocks, iters,
                                   torch.cuda.current_stream().cuda_stream),
                        iters=5)
        flops = 2.0 * 16 * 8 * 8 * 48 * 4 * iters * blocks * 8
        emit({"mma3_ldsm_tf32_tflops": flops / ms / 1e9,
              "ctas_per_sm": per_sm, "ms": ms})


def _activate(x, a, b):
    return torch.relu(x * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))


def emit_case(gen, shape, min_bm):
    """B4 at a chain shape: (tensors, ints, out, check, shipped, library,
    bound); check() reads the buffers the tile launches write, check(got)
    the shipped wrapper's result."""
    n, h, w, c, cm, co = shape
    t = cs._chain_case(gen, *shape)
    ops = [t[k] for k in ("x", "a1", "b1", "w2", "a2", "b2", "w3", "b3")]
    ref = fc._chain_emit_plain(*ops)
    scale = ref.abs().max().item()
    out = torch.empty_like(ref)

    def check(got=None):
        got = out if got is None else got
        return (got - ref).abs().max().item() / scale

    def library():
        c2 = F.conv2d(_activate(ops[0], ops[1], ops[2]), ops[3], padding=1)
        return F.conv2d(_activate(c2, ops[4], ops[5]), ops[6], ops[7])
    return (ops + [out], (n, h, w, c, cm, co), out, check,
            lambda: fc.chain_emit(*ops), library,
            cs.chain_bound_ms(*shape, emit=True)[0])


def stats_case(gen, shape, min_bm):
    """B3 at a chain shape; the partials sized for ``min_bm`` rows."""
    n, h, w, c, cm, co = shape
    t = cs._chain_case(gen, *shape)
    ops = [t[k] for k in ("x", "a1", "b1", "w2", "shift")]
    ref_sum, ref_sq = fc._chain_stats_plain(*ops)
    d = fc._conv2(*ops[:4]) - ops[4].view(1, -1, 1, 1)
    mass = d.abs().sum((0, 2, 3))
    del d
    m = n * h * w
    part = torch.empty(((m + min_bm - 1) // min_bm * 2 * cm,),
                       device="cuda")
    sums = torch.empty((cm,), device="cuda")
    sqs = torch.empty_like(sums)

    def check(got=None):
        got_sum, got_sq = (sums, sqs) if got is None else got
        return max(((got_sum - ref_sum).abs() / mass).max().item(),
                   ((got_sq - ref_sq).abs() / ref_sq).max().item())

    def library():
        dd = F.conv2d(_activate(ops[0], ops[1], ops[2]), ops[3],
                      padding=1) - ops[4].view(1, -1, 1, 1)
        return dd.sum((0, 2, 3)), dd.square().sum((0, 2, 3))
    return (ops + [part, sums, sqs], (n, h, w, c, cm), sums, check,
            lambda: fc.chain_stats(*ops), library,
            cs.chain_bound_ms(*shape, emit=False)[0])


def conv_case(gen, shape, min_bm):
    """B2 at a fused 3x3 shape."""
    n, h, w, c, cout = shape
    ops = list(cs._conv_case(gen, *shape, 9))
    ref = fconv._sbr_conv3x3_plain(*ops)
    scale = ref.abs().max().item()
    out = torch.empty_like(ref)

    def check(got=None):
        got = out if got is None else got
        return (got - ref).abs().max().item() / scale

    def library():
        return F.conv2d(_activate(*ops[:3]), ops[3], ops[4], padding=1)
    return (ops + [out], shape, out, check, lambda: fconv.sbr_conv3x3(*ops),
            library, cs.conv_bound_ms(*shape, 9)[0])


def matmul_case(gen, shape, min_bm):
    """B1 at a fused 1x1 shape."""
    n, h, w, c, cout = shape
    ops = list(cs._conv_case(gen, *shape, 1))
    ref = fconv._sbr_matmul_plain(*ops)
    scale = ref.abs().max().item()
    out = torch.empty_like(ref)

    def check(got=None):
        got = out if got is None else got
        return (got - ref).abs().max().item() / scale

    def library():
        return F.conv2d(_activate(*ops[:3]), ops[3], ops[4])
    return (ops + [out], (n * h * w, c, cout), out, check,
            lambda: fconv.sbr_matmul(*ops), library,
            cs.conv_bound_ms(*shape, 1)[0])


CASES = {"emit": (emit_case, cs.CHAIN_SHAPES),
         "stats": (stats_case, cs.CHAIN_SHAPES),
         "conv": (conv_case, cs.CONV3X3_SHAPES),
         "matmul": (matmul_case, cs.CONV1X1_SHAPES)}


def parent_workspace(lib, shape):
    """Floats of the parent's chain_stats partials at a chain shape."""
    fn = lib.mx_chain_stats_workspace
    fn.argtypes, fn.restype = [I, I], I
    n, h, w, _, cm, _ = shape
    return fn(n * h * w, cm)


def tile_case(spec, i, tile):
    """The C switch case that launches ``tile`` (``BM,BN,WGM,WGN`` and,
    for matmul, an optional ``,R``: 0 streams A)."""
    dims = tile.split(",")
    resident = "false" if dims[4:] == ["0"] else "true"
    case = spec["case"].replace("@RESIDENT@", resident)

    return (f"    case {i}: {{ using T = tc::Tile<{','.join(dims[:4])}>; "
            f"return {case}; }}")


def sweep(kernel, libs, tiles, diags, parent):
    spec = KERNELS[kernel]
    make, shapes = CASES[kernel]
    sig = [P] * spec["nptrs"] + [I] * spec["nints"] + [P]
    for name in [f"{kernel}-tiles"] + [f"{kernel}-{d}" for d in diags]:
        getattr(libs[name], spec["fn"] + "_tile").argtypes = sig + [I]
    if parent:
        getattr(libs[f"{kernel}-parent"], spec["fn"]).argtypes = sig
    min_bm = min(int(t.split(",")[0]) for t in tiles)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape in shapes:
        tensors, ints, out, check, shipped, library, bound = make(
            gen, shape, min_bm)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib, tile=None, ptrs=None):
            fn = getattr(lib, spec["fn"] + ("" if tile is None else "_tile"))
            call = ptrs or [t.data_ptr() for t in tensors]
            extra = () if tile is None else (tile,)
            return lambda: fn(*call, *ints, stream, *extra)

        row = {"kernel": kernel, "shape": list(shape), "bound_ms": bound,
               "tiles": {}}
        for i, tile in enumerate(tiles):
            out.fill_(float("nan"))
            if launch(libs[f"{kernel}-tiles"], i)():
                row["tiles"][tile] = None      # does not fit
                continue
            torch.cuda.synchronize()
            entry = {"err": check(),
                     "ms": cs.time_ms(launch(libs[f"{kernel}-tiles"], i))}
            for d in diags:
                entry[d] = cs.time_ms(launch(libs[f"{kernel}-{d}"], i))
            row["tiles"][tile] = entry
        if parent:
            plib = libs[f"{kernel}-parent"]
            ptrs = None
            if kernel == "stats":      # the parent sizes its own partials
                part = torch.empty((parent_workspace(plib, shape),),
                                   device="cuda")
                ptrs = [t.data_ptr() for t in tensors]
                ptrs[5] = part.data_ptr()
            old = launch(plib, ptrs=ptrs)
            out.fill_(float("nan"))
            old()
            torch.cuda.synchronize()
            row["parent_err"] = check()
            turns = [("parent", old), ("change", shipped),
                     ("change", shipped), ("parent", old)]
            row["turns_ms"] = [(who, cs.time_ms(fn)) for who, fn in turns]
        else:
            row["kernel_ms"] = cs.time_ms(shipped)
        got = shipped()
        torch.cuda.synchronize()
        row["kernel_err"] = check(got)   # the shipped wrapper's own output
        row["library_ms"] = cs.time_ms(library)
        emit(row)
        del tensors, out
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="emit stats conv")
    ap.add_argument("--parent", help="a parent checkout's root")
    ap.add_argument("--tiles", default=TILES)
    ap.add_argument("--matmul-tiles", default=MATMUL_TILES)
    ap.add_argument("--diag", default="")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    kernels, diags = args.kernels.split(), args.diag.split()
    tiles = {k: (args.matmul_tiles if k == "matmul" else args.tiles).split()
             for k in kernels}
    with open(os.path.join(CSRC, "tc_gemm.cuh")) as f:
        header = f.read()
    jobs = {"peak": (write(os.path.join(OUT, "peak.cu"), MMA_PEAK), [])}
    for kernel in kernels:
        spec = KERNELS[kernel]
        cases = "\n".join(tile_case(spec, i, t)
                          for i, t in enumerate(tiles[kernel]))
        with open(os.path.join(CSRC, spec["source"])) as f:
            src = f.read() + spec["entry"].replace("@CASES@", cases)
        jobs[f"{kernel}-tiles"] = (
            write(os.path.join(OUT, kernel, spec["source"]), src), [CSRC])
        for d in diags:
            write(os.path.join(OUT, kernel, d, "tc_gemm.cuh"),
                  substitute(header, [pair for part in d.split("+")
                                      for pair in DIAG[part]]))
            jobs[f"{kernel}-{d}"] = (
                write(os.path.join(OUT, kernel, d, spec["source"]), src),
                [os.path.join(OUT, kernel, d), CSRC])
        if args.parent:
            psrc = os.path.join(os.path.abspath(args.parent),
                                "incubator_mxnet_tpu_torch", "csrc")
            jobs[f"{kernel}-parent"] = (os.path.join(psrc, spec["source"]),
                                        [psrc])
    libs = build(jobs)
    mma_peak(libs["peak"])
    for kernel in kernels:
        sweep(kernel, libs, tiles[kernel], diags, args.parent)


if __name__ == "__main__":
    main()
