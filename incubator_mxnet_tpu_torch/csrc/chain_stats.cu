// Pass 1 of the bottleneck chain for Hopper (sm_90a): BN1-apply -> ReLU
// -> 3x3 conv2 -> per-channel shifted sums, fp32 on the CUDA cores.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/fused_chain.py
// `_chain_kernel` with emit=False (launched by `pl.pallas_call` in
// `_pallas_chain_stats`).  It computes the same function:
//
//   c2 = conv3x3(relu(c1 * a1 + b1)), stride 1, zero pad 1 after the
//        activation, over channels-last c1 (N, H, W, C) and the OHWI
//        weight w2 (Cm, 3, 3, C)
//   sum[n] = sum_m (c2[m, n] - s[n]),  sq[n] = sum_m (c2[m, n] - s[n])^2
//
// with s = BN2's moving mean: the shift keeps the single-pass variance
// E[(c2-s)^2] - E[c2-s]^2 out of catastrophic cancellation.  Only the
// two (Cm,) vectors leave the kernel; c2 never reaches device memory.
// The caller finalises mean2 and var2 from them.
//
// What bounds it on this card.  2 * 9C flops per element of c2 against
// one read of c1 and two (Cm,) writes: at ResNet-50's four chain shapes
// at batch 128 (56x56x64 -> 64 ... 7x7x512 -> 512, 29.6 GFLOP each) it
// is bound by operations, 0.442 ms a launch at the fp32 CUDA-core peak
// of 67 TFLOP/s.
//
// What the design does about it.  The main loop is B2's implicit GEMM
// (sbr_gemm.cuh): each CTA computes its BM x BN tile of c2 in registers.
// Its epilogue reduces each column over the tile's valid rows (a padded
// row would add s^2) in a fixed order through shared memory and writes
// one (sum, sq) partial per (row tile, channel) to a workspace.  A
// second launch sums the partials over the row tiles, again in a fixed
// order: the TPU grid runs sequentially and its sums are deterministic,
// and these are too (no float atomics; two runs are bit-identical).
// Dropped from the TPU version: the whole-image VMEM scratch and the
// dy-merged lanes for its MXU; the tiling over the batch's flat pixels
// keeps every CTA full at 7x7.
//
// C interface (ctypes): mx_chain_stats returns the CUDA error code of
// the launches (0 on success); mx_chain_stats_workspace gives the floats
// of scratch it needs.  It allocates nothing; the caller passes
// contiguous fp32 device pointers and the stream.

#include "sbr_gemm.cuh"

namespace {

// Epilogue: per-column (sum, sq) of (c2 - shift) over the tile's valid
// rows, written to part[row tile][0 | 1][n].
struct ColumnStats {
  const float* shift;
  float* part;

  template <int BM, int BN>
  __device__ void operator()(const sbr::Conv& p, int m0, int n0,
                             const sbr::Acc<BM, BN>& acc) const {
    using L = sbr::Layout<BM, BN>;
    __shared__ float red[2][L::TY][BN];
    const int tid = threadIdx.x;
    const int tx = tid % L::TX;
    const int ty = tid / L::TX;
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int c = L::col(tx, j);
      const float s = n0 + c < p.N ? shift[n0 + c] : 0.f;
      float su = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        if (m0 + L::row(ty, i) < p.M) {
          const float d = acc[i][j] - s;
          su += d;
          sq = fmaf(d, d, sq);
        }
      }
      red[0][ty][c] = su;
      red[1][ty][c] = sq;
    }
    __syncthreads();
    float* out = part + (long long)(m0 / BM) * 2 * p.N;
    for (int c = tid; c < BN; c += sbr::NTHREADS) {
      if (n0 + c >= p.N) continue;
      float su = 0.f, sq = 0.f;
      for (int y = 0; y < L::TY; ++y) {
        su += red[0][y][c];
        sq += red[1][y][c];
      }
      out[n0 + c] = su;
      out[p.N + n0 + c] = sq;
    }
  }
};

// sum[n], sq[n] = the partials summed over the row tiles: a CTA of 32 x
// 32 threads per 32 channels, each thread a fixed stride of tiles, then
// the 32 strided sums in order.
__global__ void __launch_bounds__(1024)
column_totals(const float* __restrict__ part, int tiles, int N,
              float* __restrict__ sum, float* __restrict__ sq) {
  __shared__ float red[2][32][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float su = 0.f, s2 = 0.f;
  if (n < N) {
    for (int t = threadIdx.y; t < tiles; t += 32) {
      su += part[(long long)t * 2 * N + n];
      s2 += part[(long long)t * 2 * N + N + n];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = su;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    su = s2 = 0.f;
    for (int y = 0; y < 32; ++y) {
      su += red[0][y][threadIdx.x];
      s2 += red[1][y][threadIdx.x];
    }
    sum[n] = su;
    sq[n] = s2;
  }
}

}  // namespace

extern "C" int mx_chain_stats_workspace(int m, int cm) {
  return (m + sbr::MIN_BM - 1) / sbr::MIN_BM * 2 * cm;
}

extern "C" int mx_chain_stats(const void* x, const void* a1, const void* b1,
                              const void* w2, const void* shift, void* part,
                              void* sum, void* sq, int n, int h, int w,
                              int c, int cm, void* stream) {
  const sbr::Conv p{static_cast<const float*>(x),
                    static_cast<const float*>(a1),
                    static_cast<const float*>(b1),
                    static_cast<const float*>(w2), n * h * w, c, cm, h, w};
  const ColumnStats epi{static_cast<const float*>(shift),
                        static_cast<float*>(part)};
  auto s = static_cast<cudaStream_t>(stream);
  int bm = 0;
  if (int err = sbr::launch<9>(p, epi, s, &bm)) return err;
  const int tiles = (p.M + bm - 1) / bm;
  column_totals<<<(cm + 31) / 32, dim3(32, 32), 0, s>>>(
      static_cast<const float*>(part), tiles, cm, static_cast<float*>(sum),
      static_cast<float*>(sq));
  return (int)cudaGetLastError();
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
