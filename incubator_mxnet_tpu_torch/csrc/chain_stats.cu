// Pass 1 of the bottleneck chain for Hopper (sm_90a): BN1-apply -> ReLU
// -> 3x3 conv2 -> per-channel shifted sums, on the tensor cores in two
// forms: fp32 (fp32-accurate, 3xTF32) and bf16.
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
// is bound by operations, 0.179 ms a launch at the 165 TFLOP/s of
// fp32-accurate (3xTF32) tensor-core work.
//
// What the design does about it.  The main loop is tc_gemm.cuh's 3x3
// implicit GEMM (3xTF32 mma.sync fed by a cp.async ring, the BN1 affine,
// the ReLU and the tap mask applied as each warp loads its A fragments),
// one CTA per BM x BN tile of c2 (tc::conv3x3_kernel).  Its epilogue
// reduces each column of the tile in registers over the tile's valid
// rows only (a row past M holds 0 after the tap mask, and 0 - s would
// add s^2), in a fixed order: inside the thread over its fragment rows,
// across the 8 lanes of a column by shuffles, across the warp rows
// through shared memory (the free ring), and writes one (sum, sq)
// partial per (row tile, channel) to a workspace.  A second launch sums
// the partials over the row tiles, again in a fixed order: the TPU grid
// runs sequentially and its sums are deterministic, and these are too
// (no float atomics; two runs are bit-identical).  Each 32-channel slot
// is summed into a fresh fragment (tc_gemm.cuh, Accumulation), so the
// tensor cores' rounding toward zero does not pile up into the column
// sums.  Dropped from the TPU version: the whole-image VMEM scratch and
// the dy-merged lanes for its MXU; the tiling over the batch's flat
// pixels keeps every CTA full at 7x7.
//
// Tile per shape (swept by tools/port_chain_sweep.py over nine tiles at
// the four shapes).  Without a y2 tile the ring alone sets shared
// memory, so 2-4 CTAs share an SM.  Warp tiles of 64 x 32 (4 x 4 mma
// tiles) share each fragment among the most products and measured
// fastest wherever the grid is large: mx_chain_stats takes 128 x 64
// (2 x 2 warps, 2 CTAs an SM) when Cm <= 64 or when it gives at least
// two full waves; else 96 x 128 (2 x 4 warps, 1 an SM) when that fills
// every SM; else 64 x 64 (2 x 2 warps, 4 an SM), for small grids.
// ResNet-50 at b = 128:
//   56x56 (Cm  64): 128 x 64, 3136 CTAs (0.69 ms; 64 x 64 0.78)
//   28x28 (Cm 128): 128 x 64, 1568 CTAs (0.67; 128 x 128 within 1%)
//   14x14 (Cm 256): 128 x 64,  784 CTAs (0.63; 128 x 128 the same)
//   7x7   (Cm 512): 96 x 128,  264 CTAs, two full waves (0.70; 128 x 64
//                   gives 1.5 waves, 0.82)
//
// The bf16 form (mx_chain_stats_bf16): c1 and w2 bf16, a1, b1, the shift
// and the sums fp32, the TPU kernel's arithmetic on bf16 data: the BN1
// activation rounded to bf16, bf16 products summed in fp32, and c2 kept
// in fp32 (never rounded) through the shifted sums, which stay fp32 and
// deterministic.  The same tiles, rule and partials on tc_gemm.cuh's
// bf16 path.  Bound at b = 128: 0.0299 ms a launch by operations (989
// TFLOP/s); it takes 0.325, 0.301, 0.289, 0.267 ms at the four shapes
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// C interface (ctypes): mx_chain_stats and mx_chain_stats_bf16 return
// the CUDA error code of the launches (0 on success);
// mx_chain_stats_workspace gives the floats of scratch they need (the
// same for both forms).  They allocate nothing; the caller passes
// contiguous device pointers (c1, w2 in the form's type, the rest fp32)
// and the stream.

#include "tc_gemm.cuh"

namespace {

// Epilogue: per-column (sum, sq) of (c2 - shift) over the tile's valid
// rows, written to part[row tile][0 | 1][n].
struct TileSums {
  const float* shift;
  float* part;

  template <class T>
  __device__ void operator()(const tc::Conv<typename T::E>& p,
                             const tc::Frag<T>& f,
                             const tc::Acc<T>& acc, int m0, int n0,
                             float* smem) const {
    // red[0 | 1][warp row][column of the tile]
    float* red = smem;
    static_assert(2 * T::WGM * T::BN * sizeof(float) <= T::RING_BYTES,
                  "the column sums do not fit in the ring");
    bool row_ok[T::MI][2];
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) row_ok[i][h] = m0 + f.row0(i) + 8 * h < p.M;
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = f.col0(j) + e;
        const float s = n0 + c < p.N ? __ldg(shift + n0 + c) : 0.f;
        float su = 0.f, sq = 0.f;
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row_ok[i][h]) {
              const float d = acc[i][j][2 * h + e] - s;
              su += d;
              sq = fmaf(d, d, sq);
            }
        // the 8 lanes of equal t hold the column's other rows
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          su += __shfl_xor_sync(0xffffffffu, su, off);
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        }
        if (f.g == 0) {
          red[f.wm * T::BN + c] = su;
          red[(T::WGM + f.wm) * T::BN + c] = sq;
        }
      }
    __syncthreads();
    float* out = part + (long long)(m0 / T::BM) * 2 * p.N;
    for (int c = threadIdx.x; c < T::BN; c += T::THREADS) {
      if (n0 + c >= p.N) continue;
      float su = 0.f, sq = 0.f;
      for (int w = 0; w < T::WGM; ++w) {
        su += red[w * T::BN + c];
        sq += red[(T::WGM + w) * T::BN + c];
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

// The tiles pass, then the ordered sum of its partials
template <class T>
int launch_stats(const tc::Conv<typename T::E>& p, const TileSums& epi, void* sum,
                 void* sq, cudaStream_t stream) {
  if (int err = tc::launch_conv3x3<T>(p, epi, stream)) return err;
  const int tiles = (p.M + T::BM - 1) / T::BM;
  column_totals<<<(p.N + 31) / 32, dim3(32, 32), 0, stream>>>(
      epi.part, tiles, p.N, static_cast<float*>(sum),
      static_cast<float*>(sq));
  return (int)cudaGetLastError();
}

// The tiles, chosen per shape by chain_stats (see the note)
template <class E>
using Wide = tc::Tile<128, 64, 2, 2, E>;
template <class E>
using Rows96 = tc::Tile<96, 128, 2, 4, E>;
template <class E>
using Small = tc::Tile<64, 64, 2, 2, E>;
// the fewest rows a tile of the rule has: it sizes the partials
constexpr int MIN_BM = 64;
static_assert(MIN_BM <= Wide<float>::BM && MIN_BM <= Rows96<float>::BM &&
                  MIN_BM <= Small<float>::BM,
              "MIN_BM must be the smallest BM of the tile rule");

template <class E>
int chain_stats(const void* x, const void* a1, const void* b1,
                const void* w2, const void* shift, void* part, void* sum,
                void* sq, int n, int h, int w, int c, int cm, void* stream) {
  const tc::Conv<E> p = tc::conv_operands<E>(x, a1, b1, w2, n, h, w, c, cm);
  if (p.M <= 0 || c <= 0 || cm <= 0) return (int)cudaErrorInvalidValue;
  const TileSums epi{static_cast<const float*>(shift),
                     static_cast<float*>(part)};
  int sms = 0;
  if (int err = tc::sm_count(&sms)) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (cm <= 64 || tc::ctas<Wide<E>>(p) >= 4LL * sms)
    return launch_stats<Wide<E>>(p, epi, sum, sq, s);
  if (tc::ctas<Rows96<E>>(p) >= sms)
    return launch_stats<Rows96<E>>(p, epi, sum, sq, s);
  return launch_stats<Small<E>>(p, epi, sum, sq, s);
}

}  // namespace

extern "C" int mx_chain_stats_workspace(int m, int cm) {
  return (m + MIN_BM - 1) / MIN_BM * 2 * cm;
}

extern "C" int mx_chain_stats(const void* x, const void* a1, const void* b1,
                              const void* w2, const void* shift, void* part,
                              void* sum, void* sq, int n, int h, int w,
                              int c, int cm, void* stream) {
  return chain_stats<float>(x, a1, b1, w2, shift, part, sum, sq, n, h, w, c,
                            cm, stream);
}

extern "C" int mx_chain_stats_bf16(const void* x, const void* a1,
                                   const void* b1, const void* w2,
                                   const void* shift, void* part, void* sum,
                                   void* sq, int n, int h, int w, int c,
                                   int cm, void* stream) {
  return chain_stats<tc::bf16>(x, a1, b1, w2, shift, part, sum, sq, n, h, w,
                               c, cm, stream);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
