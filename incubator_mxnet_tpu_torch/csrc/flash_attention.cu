// Flash-attention forward for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel incubator_mxnet_tpu/parallel/flash_attention.py
// `_kernel` (launched by `pl.pallas_call` in `_flash_fwd_impl`).  It
// computes the same function: o = softmax(scale * q k^T [+ causal mask
// cols <= rows]) v over q, k, v of shape (B*H, T, D), with an fp32
// online softmax (running max m, normaliser l, fp32 accumulator) and
// the output divided by l at the end.
//
// What bounds it on this card.  Per (b, h) the kernel reads q, k, v and
// writes o once, 4*T*D*4 bytes, and does 4*T*T*D flops (half that when
// causal).  At D = 64 that is T/4 flops per byte: from T of a few
// hundred up it is bound by arithmetic, here the fp32 FMA rate of the
// CUDA cores (67 TFLOP/s on an H100 SXM) and the shared-memory loads
// that feed it, not by HBM.
//
// What the design does about it.
// * One CTA of 256 threads per (b*h, 64-row q tile); the T x T score
//   matrix never reaches device memory.  An in-CTA loop over 64-row K/V
//   tiles replaces the TPU kernel's sequential fori_loop; K and V are
//   staged in shared memory once per tile and reused by all 64 q rows.
// * Register tiling: each thread owns a 4 x 4 block of scores (q rows
//   ty + 16 i, keys tx + 16 j) and a 4 x D/16 block of the output, so
//   every shared-memory load feeds several FMAs.  Q/K rows are padded
//   to D + 1 floats so the 16 keys a half-warp reads sit in 16 banks.
// * Causal: K/V tiles wholly above the diagonal are never loaded, and
//   the heaviest q tiles (the last ones) are launched first so the
//   tail of the grid is short.  Ragged edges (T not a multiple of 64)
//   are masked in the kernel; padded rows are never stored.
// * A row that has seen no visible key yet keeps m = -inf; it subtracts
//   0 instead of m so exp gives 0, not exp(-inf - -inf) = NaN.
// Tensor cores (wgmma), TMA and bf16/TF32 inputs are left for later.
//
// C interface (ctypes): mx_flash_attention_fwd returns the CUDA error
// code of the launch (0 on success).  It allocates nothing; the caller
// passes contiguous fp32 device pointers and the stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;              // q rows per CTA
constexpr int BK = 64;              // keys per K/V tile
constexpr int TX = 16;              // threads along keys / head dim
constexpr int TY = 16;              // threads along q rows
constexpr int NTHREADS = TX * TY;   // 256
constexpr int RM = BQ / TY;         // q rows per thread (4)
constexpr int CN = BK / TX;         // keys per thread (4)
constexpr int PP = BK + 1;          // padded row stride of the P tile

template <int D>
constexpr size_t smem_bytes() {
  // Q [BQ][D+1], K [BK][D+1], V [BK][D], P [BQ][BK+1]
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PP);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int t,
                 float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DN = D / TX;        // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][DP], pre-scaled
  float* ks = qs + BQ * DP;         // [BK][DP]
  float* vs = ks + BK * DP;         // [BK][D]
  float* ps = vs + BK * D;          // [BQ][PP]

  const int bh = blockIdx.x;
  // heaviest causal tiles first: blockIdx.y = 0 takes the last q tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const size_t base = (size_t)bh * t * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    qs[r * DP + c] = row < t ? qb[(size_t)row * D + c] * scale : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  const int q_end = min(q0 + BQ, t);       // one past the last real row
  int nk = (t + BK - 1) / BK;
  if (causal) nk = min(nk, (q_end + BK - 1) / BK);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's P.V is done with ks/vs/ps
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      const bool ok = row < t;
      ks[r * DP + c] = ok ? kb[(size_t)row * D + c] : 0.f;
      vs[r * D + c] = ok ? vb[(size_t)row * D + c] : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty + TY * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = ks[(tx + TX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = k0 + tx + TX * j;
        if (col >= t || (causal && col > row)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are the lanes that differ in bits 0..3
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CN; ++j)
        ps[(ty + TY * i) * PP + tx + TX * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ps[(ty + TY * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = vs[c * D + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + base;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + TY * i;
    if (row < t) {
#pragma unroll
      for (int j = 0; j < DN; ++j)
        ob[(size_t)row * D + tx + TX * j] = acc[i][j] / l[i];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int t, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(q, k, v, o, t, scale,
                                                        causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int bh, int t,
                                      int d, float scale, int causal,
                                      void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(qf, kf, vf, of, bh, t, scale, causal, s);
    case 32: return launch<32>(qf, kf, vf, of, bh, t, scale, causal, s);
    case 64: return launch<64>(qf, kf, vf, of, bh, t, scale, causal, s);
    case 128: return launch<128>(qf, kf, vf, of, bh, t, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
