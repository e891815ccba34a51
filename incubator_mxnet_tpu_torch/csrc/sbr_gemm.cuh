// The fp32 main loop shared by the two fused [BN-apply -> ReLU -> conv]
// kernels, sbr_matmul.cu (1x1) and sbr_conv3x3.cu (3x3, pad 1); each
// source's note says which TPU kernel it replaces and why it is shaped
// so.
//
// Both are one GEMM over channels-last storage:
//
//   out[m, n] = sum_{t < TAPS, c < C} y(m, t, c) * w[n, t, c] + bias[n]
//   y(m, t, c) = relu(x[m + shift(t), c] * a[c] + b[c])  if tap t of
//                pixel m lies inside its image, else 0
//
// with m the flat pixel index n*H*W + h*W + w over the whole batch
// (M = N*H*W rows of C channels), w the weight in OHWI order (Cout rows
// of TAPS*C), TAPS = 1 for the 1x1 conv and 9 for the 3x3.  The padding
// zero comes after the BN affine and the ReLU, as the TPU kernel pads
// its activated image.
//
// Tiling.  One CTA of 256 threads owns a BM x BN output tile.  The
// reduction runs in steps of BK = 8 channels of one tap: each thread
// fetches its share of the next A tile (applying the affine and the
// ReLU as it loads, so the activated tensor never reaches device
// memory) and of the next B tile into registers while the CTA computes
// on the current tiles in shared memory (double buffered, one barrier a
// step).  Each thread accumulates a (BM/16) x (BN/16) block of outputs
// in registers from float4 reads of the tiles; tile rows are padded by
// 4 floats so the transposing stores hit 32 distinct banks.

#pragma once

#include <cuda_runtime.h>

namespace sbr {

constexpr int BK = 8;            // channels of one tap per reduction step
constexpr int NTHREADS = 256;    // 16 x 16 threads
constexpr int LANES = NTHREADS / BK;   // rows a load pass covers (32)

template <int TAPS, int BM, int BN>
__global__ void __launch_bounds__(NTHREADS)
sbr_gemm_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int C, int N, int H, int W, int n_tiles) {
  constexpr int AP = BM / LANES;   // A elements a thread loads per step
  constexpr int BP = BN / LANES;   // B elements a thread loads per step
  constexpr int TM = BM / 16;      // output rows a thread owns
  constexpr int TN = BN / 16;      // output columns a thread owns
  __shared__ __align__(16) float as[2][BK][BM + 4];
  __shared__ __align__(16) float bs[2][BK][BN + 4];

  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int kl = tid % BK;         // channel within a step, for loads
  const int rl = tid / BK;         // first row of this thread's loads

  // the pixels this thread loads A for, fixed over the whole reduction
  long long mrow[AP];
  int ph[AP], pw[AP];
  bool mok[AP];
#pragma unroll
  for (int i = 0; i < AP; ++i) {
    const int m = m0 + rl + LANES * i;
    mok[i] = m < M;
    mrow[i] = m;
    ph[i] = pw[i] = 0;
    if constexpr (TAPS == 9) {
      const int p = m % (H * W);
      ph[i] = p / W;
      pw[i] = p % W;
    }
  }

  const int csteps = (C + BK - 1) / BK;
  const int steps = TAPS * csteps;
  const long long ldw = (long long)TAPS * C;
  float ra[AP], rb[BP];

  auto fetch = [&](int s) {
    const int tap = s / csteps;
    const int c = (s - tap * csteps) * BK + kl;
    const bool cok = c < C;
    const float av = cok ? a[c] : 0.f;
    const float bv = cok ? b[c] : 0.f;
    const int dy = TAPS == 9 ? tap / 3 - 1 : 0;
    const int dx = TAPS == 9 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < AP; ++i) {
      bool ok = cok && mok[i];
      if constexpr (TAPS == 9)
        ok = ok && (unsigned)(ph[i] + dy) < (unsigned)H &&
             (unsigned)(pw[i] + dx) < (unsigned)W;
      ra[i] = ok ? fmaxf(fmaf(x[(mrow[i] + dy * W + dx) * C + c], av, bv),
                         0.f)
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BP; ++j) {
      const int n = n0 + rl + LANES * j;
      rb[j] = (cok && n < N) ? w[n * ldw + (long long)tap * C + c] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < AP; ++i) as[buf][kl][rl + LANES * i] = ra[i];
#pragma unroll
    for (int j = 0; j < BP; ++j) bs[buf][kl][rl + LANES * j] = rb[j];
  };

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) fetch(s + 1);   // global loads in flight ...
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {  // ... while this step computes
      float af[TM], bf[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(&as[cur][kk][i * 64 + ty * 4]);
        af[4 * i] = v.x; af[4 * i + 1] = v.y;
        af[4 * i + 2] = v.z; af[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(&bs[cur][kk][j * 64 + tx * 4]);
        bf[4 * j] = v.x; bf[4 * j + 1] = v.y;
        bf[4 * j + 2] = v.z; bf[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < steps) stash(cur ^ 1);
    __syncthreads();
  }

  // epilogue: bias, then rows of 16 threads x 4 columns, float4 stores
  // where the row length allows
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
    float* orow = out + (long long)m * N;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n = n0 + j * 64 + tx * 4;
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

template <int TAPS, int BM, int BN>
int launch_tiles(const float* x, const float* a, const float* b,
                 const float* w, const float* bias, float* out, int M, int C,
                 int N, int H, int W, cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  sbr_gemm_kernel<TAPS, BM, BN><<<m_tiles * n_tiles, NTHREADS, 0, stream>>>(
      x, a, b, w, bias, out, M, C, N, H, W, n_tiles);
  return (int)cudaGetLastError();
}

// Tile choice: 128 x 64 when the output has at most 64 channels; else
// 128 x 128 when that still gives every SM a CTA; else 64 x 64, so the
// small late-stage grids (ResNet-50 stage 3-4 at 14x14 and 7x7) fill
// the card.
template <int TAPS>
int launch(const float* x, const float* a, const float* b, const float* w,
           const float* bias, float* out, int M, int C, int N, int H, int W,
           cudaStream_t stream) {
  if (M <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (N <= 64)
    return launch_tiles<TAPS, 128, 64>(x, a, b, w, bias, out, M, C, N, H, W,
                                       stream);
  if (big >= sms)
    return launch_tiles<TAPS, 128, 128>(x, a, b, w, bias, out, M, C, N, H, W,
                                        stream);
  return launch_tiles<TAPS, 64, 64>(x, a, b, w, bias, out, M, C, N, H, W,
                                    stream);
}

}  // namespace sbr
