// The fp32 main loop of the fused [BN-apply -> ReLU -> 1x1 conv] kernel,
// sbr_matmul.cu (B1), on the CUDA cores; its note says which TPU kernel
// it replaces and why it is shaped so.  (The 3x3 kernels, B2 to B4, run
// on the tensor cores through tc_gemm.cuh.)
//
// It runs one GEMM over channels-last storage:
//
//   c[m, n] = sum_{c < C} relu(x[m, c] * a[c] + b[c]) * w[n, c]
//
// with m the flat pixel index n*H*W + h*W + w over the whole batch
// (M = N*H*W rows of C channels) and w the (N, C) rows of the OIHW
// weight; the epilogue stores the BM x BN tile of c plus a bias.
//
// Tiling.  One CTA of 256 threads owns a BM x BN tile.  The reduction
// runs in steps of BK = 8 channels: each thread fetches its share of the
// next A tile (applying the affine and the ReLU as it loads, so the
// activated tensor never reaches device memory) and of the next B tile
// into registers while the CTA computes on the current tiles in shared
// memory (double buffered, one barrier a step).  The threads
// form a TY x TX grid; each accumulates a TM x TN block of outputs in
// registers (rows and columns in groups of 4, read as float4 from the
// tiles); tile rows are padded by 4 floats so the transposing stores
// hit 32 distinct banks.

#pragma once

#include <cuda_runtime.h>

namespace sbr {

constexpr int BK = 8;            // channels per reduction step
constexpr int NTHREADS = 256;
constexpr int LANES = NTHREADS / BK;   // rows a load pass covers (32)

// Which outputs of a BM x BN tile each thread owns: a TY x TX thread
// grid, TM x TN outputs a thread, in groups of 4 rows and 4 columns
// spaced 4*TY rows and 4*TX columns apart.
template <int BM, int BN>
struct Layout {
  static constexpr int TY = 16;
  static constexpr int TX = NTHREADS / TY;
  static constexpr int TM = BM / TY;
  static constexpr int TN = BN / TX;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "tile too small for 256 threads");
  static_assert(BM % LANES == 0 && BN % LANES == 0, "tile not a load multiple");
  __device__ static int row(int ty, int i) {
    return (i / 4) * (4 * TY) + ty * 4 + (i % 4);
  }
  __device__ static int col(int tx, int j) {
    return (j / 4) * (4 * TX) + tx * 4 + (j % 4);
  }
};

template <int BM, int BN>
using Acc = float[Layout<BM, BN>::TM][Layout<BM, BN>::TN];

// the double-buffered operand tiles, k-major
template <int BM, int BN>
struct Tiles {
  float as[2][BK][BM + 4];
  float bs[2][BK][BN + 4];
};

// The operands of the GEMM: x (M rows of C), the per-channel affine
// (a, b), the weight w (N rows of C).  They are read-only for the
// kernel's whole life and read through the read-only data cache (__ldg).
struct Conv {
  const float* x;
  const float* a;
  const float* b;
  const float* w;
  int M, C, N;
};

// acc = the (m0, n0) tile of c.  Starts and ends with the tiles free: it
// writes them only after a barrier every thread has passed, and its last
// step ends in a barrier.
template <int BM, int BN>
__device__ __forceinline__ void mainloop(const Conv& p, int m0, int n0,
                                         Tiles<BM, BN>& t, Acc<BM, BN>& acc) {
  using L = Layout<BM, BN>;
  constexpr int AP = BM / LANES;   // A elements a thread loads per step
  constexpr int BP = BN / LANES;   // B elements a thread loads per step
  const int tid = threadIdx.x;
  const int kl = tid % BK;         // channel within a step, for loads
  const int rl = tid / BK;         // first row of this thread's loads
  const int C = p.C;

  // the rows this thread loads A for, fixed over the whole reduction
  long long mrow[AP];
  bool mok[AP];
#pragma unroll
  for (int i = 0; i < AP; ++i) {
    const int m = m0 + rl + LANES * i;
    mok[i] = m < p.M;
    mrow[i] = m;
  }

  const int steps = (C + BK - 1) / BK;
  float ra[AP], rb[BP];

  auto fetch = [&](int s) {
    const int c = s * BK + kl;
    const bool cok = c < C;
    const float av = cok ? __ldg(p.a + c) : 0.f;
    const float bv = cok ? __ldg(p.b + c) : 0.f;
#pragma unroll
    for (int i = 0; i < AP; ++i)
      ra[i] = cok && mok[i]
                  ? fmaxf(fmaf(__ldg(p.x + mrow[i] * C + c), av, bv), 0.f)
                  : 0.f;
#pragma unroll
    for (int j = 0; j < BP; ++j) {
      const int n = n0 + rl + LANES * j;
      rb[j] = (cok && n < p.N) ? __ldg(p.w + (long long)n * C + c) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < AP; ++i) t.as[buf][kl][rl + LANES * i] = ra[i];
#pragma unroll
    for (int j = 0; j < BP; ++j) t.bs[buf][kl][rl + LANES * j] = rb[j];
  };

  const int tx = tid % L::TX;
  const int ty = tid / L::TX;
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) fetch(s + 1);   // global loads in flight ...
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {  // ... while this step computes
      float af[L::TM], bf[L::TN];
#pragma unroll
      for (int i = 0; i < L::TM / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            &t.as[cur][kk][i * 4 * L::TY + ty * 4]);
        af[4 * i] = v.x; af[4 * i + 1] = v.y;
        af[4 * i + 2] = v.z; af[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < L::TN / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            &t.bs[cur][kk][j * 4 * L::TX + tx * 4]);
        bf[4 * j] = v.x; bf[4 * j + 1] = v.y;
        bf[4 * j + 2] = v.z; bf[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
#pragma unroll
        for (int j = 0; j < L::TN; ++j)
          acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < steps) stash(cur ^ 1);
    __syncthreads();
  }
}

// The epilogue: out[m, n] = acc + bias[n], rows of TX threads x 4
// columns, float4 stores where the row length allows.
struct StoreBias {
  const float* bias;
  float* out;

  template <int BM, int BN>
  __device__ void operator()(const Conv& p, int m0, int n0,
                             const Acc<BM, BN>& acc) const {
    using L = Layout<BM, BN>;
    const int tx = threadIdx.x % L::TX;
    const int ty = threadIdx.x / L::TX;
    const int N = p.N;
    const bool vec = (N & 3) == 0;
#pragma unroll
    for (int i = 0; i < L::TM; ++i) {
      const int m = m0 + L::row(ty, i);
      if (m >= p.M) continue;
      float* orow = out + (long long)m * N;
#pragma unroll
      for (int j = 0; j < L::TN / 4; ++j) {
        const int n = n0 + L::col(tx, 4 * j);
        if (vec && n + 3 < N) {
          float4 v;
          v.x = acc[i][4 * j] + bias[n];
          v.y = acc[i][4 * j + 1] + bias[n + 1];
          v.z = acc[i][4 * j + 2] + bias[n + 2];
          v.w = acc[i][4 * j + 3] + bias[n + 3];
          *reinterpret_cast<float4*>(orow + n) = v;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n + q < N) orow[n + q] = acc[i][4 * j + q] + bias[n + q];
        }
      }
    }
  }
};

// One CTA per BM x BN tile, tiles in row-major order over (m, n).  The
// operands are __restrict__ kernel parameters: measured on the H100
// (PERF.md), that runs this GEMM up to 7% faster than the same
// pointers passed in a struct, which carries no __restrict__.
template <int BM, int BN, class Epilogue>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const float* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ b, const float* __restrict__ w, int M,
            int C, int N, Epilogue epi, int n_tiles) {
  __shared__ __align__(16) Tiles<BM, BN> t;
  const Conv p{x, a, b, w, M, C, N};
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  Acc<BM, BN> acc;
  mainloop<BM, BN>(p, m0, n0, t, acc);
  epi.template operator()<BM, BN>(p, m0, n0, acc);
}

template <int BM, int BN, class Epilogue>
int launch_tiles(const Conv& p, const Epilogue& epi, cudaStream_t stream) {
  const int m_tiles = (p.M + BM - 1) / BM;
  const int n_tiles = (p.N + BN - 1) / BN;
  gemm_kernel<BM, BN, Epilogue><<<m_tiles * n_tiles, NTHREADS, 0, stream>>>(
      p.x, p.a, p.b, p.w, p.M, p.C, p.N, epi, n_tiles);
  return (int)cudaGetLastError();
}

inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Tile choice: 128 x 64 when the output has at most 64 channels; else
// 128 x 128 when that still gives every SM a CTA; else 64 x 64, so
// small grids fill the card.
template <class Epilogue>
int launch(const Conv& p, const Epilogue& epi, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.C <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const long long big = (long long)((p.M + 127) / 128) * ((p.N + 127) / 128);
  if (p.N <= 64) return launch_tiles<128, 64>(p, epi, stream);
  if (big >= sms) return launch_tiles<128, 128>(p, epi, stream);
  return launch_tiles<64, 64>(p, epi, stream);
}

}  // namespace sbr
