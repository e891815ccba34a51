// Pass 2 of the bottleneck chain for Hopper (sm_90a): BN1-apply -> ReLU
// -> 3x3 conv2 -> BN2-apply -> ReLU -> 1x1 conv3 + bias, fp32 on the
// CUDA cores.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/fused_chain.py
// `_chain_kernel` with emit=True (launched by `pl.pallas_call` in
// `_pallas_chain_emit`).  It computes the same function:
//
//   c2  = conv3x3(relu(c1 * a1 + b1)), stride 1, zero pad 1 after the
//         activation (channels-last c1 (N, H, W, C), OHWI w2 (Cm, 3, 3, C))
//   y2  = relu(c2 * a2 + b2)
//   out = y2 @ w3^T + b3       (w3 the (Co, Cm) rows of the 1x1 weight)
//
// and writes only out: neither c2 nor y2 reaches device memory.
//
// What bounds it on this card.  2 * (9C + Co) flops per element of c2
// against one read of c1 and one write of out: at ResNet-50's four
// chain shapes at batch 128 (56x56x64 -> 64 -> 256 ... 7x7x512 -> 512 ->
// 2048, 42.8 GFLOP each) it is bound by operations, 0.638 ms a launch
// at the fp32 CUDA-core peak of 67 TFLOP/s.
//
// What the design does about it.  A CTA owns BM output pixels and all
// Cm channels of c2.  It runs B2's main loop (sbr_gemm.cuh) over Cm in
// BN-wide chunks, applies the BN2 affine and the ReLU to each chunk in
// registers and stores it k-major into a shared-memory y2 tile (Cm x BM
// fp32, up to 139 KB at BM = 64, Cm = 512, hence dynamic shared memory).
// Then it computes y2 @ w3^T over Co in BN-wide chunks with the same
// register blocking, A read from the resident y2 tile and w3 streamed
// through the main loop's double-buffered B tiles, adds b3 and writes
// out.  conv2 is computed once per CTA, not once per Co tile (that would
// multiply its work by Co/BN, 16x at Co = 2048).  Rows are flat pixels
// over the whole batch; BM = 32 (with 128-wide chunks) where 64-row
// tiles would leave SMs idle (ResNet-50 stage 4 at batch 128: 98 CTAs
// of 64 rows on 132 SMs).  Dropped from the TPU version: the whole-image
// VMEM scratch, the dy-merged lanes for its MXU, and its VMEM envelope;
// the port's envelope is Cm <= 768 (the y2 tile in 227 KB).
//
// C interface (ctypes): mx_chain_emit returns the CUDA error code of the
// launch (0 on success).  It allocates nothing; the caller passes
// contiguous fp32 device pointers and the stream.

#include "sbr_gemm.cuh"

namespace {

using sbr::BK;
using sbr::LANES;
using sbr::NTHREADS;

// the y2 tile: k-major rows of BM pixels, padded by 4 floats as the
// main loop's tiles are; its rows are Cm rounded up to whole BN-wide
// chunks
inline int y2_rows(int cm, int bn) { return (cm + bn - 1) / bn * bn; }

template <int BM, int BN>
__global__ void __launch_bounds__(NTHREADS)
chain_emit_kernel(sbr::Conv p, const float* __restrict__ a2,
                  const float* __restrict__ b2,
                  const float* __restrict__ w3,
                  const float* __restrict__ b3, float* __restrict__ out,
                  int Co) {
  using L = sbr::Layout<BM, BN>;
  constexpr int LD = BM + 4;
  constexpr int BP = BN / LANES;
  extern __shared__ __align__(16) float y2s[];   // [y2 rows][LD], k-major
  __shared__ __align__(16) sbr::Tiles<BM, BN> t;
  const int tid = threadIdx.x;
  const int tx = tid % L::TX;
  const int ty = tid / L::TX;
  const int m0 = blockIdx.x * BM;
  const int Cm = p.N;
  sbr::Acc<BM, BN> acc;

  // y2 = relu(conv2 * a2 + b2), chunk by chunk; columns past Cm hold 0
  for (int n0 = 0; n0 < Cm; n0 += BN) {
    sbr::mainloop<9, BM, BN>(p, m0, n0, t, acc);
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int k = n0 + L::col(tx, j);
      const bool ok = k < Cm;
      const float av = ok ? __ldg(a2 + k) : 0.f;
      const float bv = ok ? __ldg(b2 + k) : 0.f;
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
        y2s[k * LD + L::row(ty, i)] = ok ? fmaxf(fmaf(acc[i][j], av, bv), 0.f)
                                         : 0.f;
    }
  }
  __syncthreads();

  // out = y2 @ w3^T + b3, Co in BN-wide chunks
  const int steps = (Cm + BK - 1) / BK;
  const int kl = tid % BK;
  const int rl = tid / BK;
  float rb[BP];
  for (int o0 = 0; o0 < Co; o0 += BN) {
    auto fetch = [&](int s) {
      const int k = s * BK + kl;
#pragma unroll
      for (int j = 0; j < BP; ++j) {
        const int o = o0 + rl + LANES * j;
        rb[j] = (k < Cm && o < Co) ? __ldg(w3 + (long long)o * Cm + k) : 0.f;
      }
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int j = 0; j < BP; ++j) t.bs[buf][kl][rl + LANES * j] = rb[j];
    };
#pragma unroll
    for (int i = 0; i < L::TM; ++i)
#pragma unroll
      for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const int cur = s & 1;
      if (s + 1 < steps) fetch(s + 1);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float* arow = y2s + (s * BK + kk) * LD;
        float af[L::TM], bf[L::TN];
#pragma unroll
        for (int i = 0; i < L::TM / 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              arow + i * 4 * L::TY + ty * 4);
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
      if (s + 1 < steps) stash(cur ^ 1);
      __syncthreads();
    }
    const sbr::StoreBias epi{b3, out};
    const sbr::Conv po{nullptr, nullptr, nullptr, nullptr, p.M, Cm, Co, 1, 1};
    epi.template operator()<BM, BN>(po, m0, o0, acc);
  }
}

template <int BM, int BN>
int launch_emit(const sbr::Conv& p, const float* a2, const float* b2,
                const float* w3, const float* b3, float* out, int co,
                int max_smem, cudaStream_t stream) {
  const size_t dyn = (size_t)y2_rows(p.N, BN) * (BM + 4) * sizeof(float);
  if (dyn + sizeof(sbr::Tiles<BM, BN>) > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      chain_emit_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int m_tiles = (p.M + BM - 1) / BM;
  chain_emit_kernel<BM, BN><<<m_tiles, NTHREADS, dyn, stream>>>(
      p, a2, b2, w3, b3, out, co);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mx_chain_emit(const void* x, const void* a1, const void* b1,
                             const void* w2, const void* a2, const void* b2,
                             const void* w3, const void* b3, void* out,
                             int n, int h, int w, int c, int cm, int co,
                             void* stream) {
  const sbr::Conv p{static_cast<const float*>(x),
                    static_cast<const float*>(a1),
                    static_cast<const float*>(b1),
                    static_cast<const float*>(w2), n * h * w, c, cm, h, w};
  if (p.M <= 0 || c <= 0 || cm <= 0 || co <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const auto* a2f = static_cast<const float*>(a2);
  const auto* b2f = static_cast<const float*>(b2);
  const auto* w3f = static_cast<const float*>(w3);
  const auto* b3f = static_cast<const float*>(b3);
  auto* outf = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if ((p.M + 63) / 64 >= sms)
    return launch_emit<64, 64>(p, a2f, b2f, w3f, b3f, outf, co, max_smem, s);
  return launch_emit<32, 128>(p, a2f, b2f, w3f, b3f, outf, co, max_smem, s);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
