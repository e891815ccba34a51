// Flash-attention forward for Hopper (sm_90a), fp32-accurate on the
// tensor cores.
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
// hundred up it is bound by operations, at the 165 TFLOP/s of
// fp32-accurate (3xTF32) tensor-core products; below, by the latency of
// a few small CTAs.
//
// What the design does about it (FlashAttention-2's shape on mma.sync,
// with tc_gemm.cuh's PTX helpers and numerics).
// * One CTA of 4 warps per (b*h, 64-row q tile); each warp owns 16 q
//   rows, and an in-CTA loop over BKV-key tiles replaces the TPU
//   kernel's sequential fori_loop.  The T x T scores never leave the
//   registers.
// * Both products are 3xTF32 m16n8k8 (each operand split into TF32 big
//   and small halves, three products; see tc_gemm.cuh).  The splits are
//   made once per CTA in shared memory, not once per warp: q (scaled by
//   scale * log2 e) once, before the loop; each K/V tile, which arrives
//   raw through cp.async, by one pass of the CTA.  Every fragment is then
//   one ldmatrix.
// * S = q' k^T lands in the mma accumulators, where each row lives in
//   the 4 lanes of a quad: the online softmax takes its max and sum with
//   two __shfl_xor_sync each, in base 2 (ex2).  P then feeds P.V from
//   registers: the accumulator holds keys 2t, 2t+1 of row g, the A
//   fragment wants k slots t, t+4, so the k slots are taken as keys in
//   the order (2t, 2t+1) and V is stored transposed with its keys in the
//   same order within each group of 8 (0 2 4 6 1 3 5 7), so that its B
//   fragments are ldmatrix rows too.  A sum over keys does not depend on
//   their order.
// * Each key tile's P.V goes into a fresh fragment, added to the
//   rescaled O by an fp32 add (the tensor cores round toward zero).
// * Causal: K/V tiles wholly above the diagonal are never loaded (a
//   warp skips the products of a tile above its own rows), and the
//   heaviest q tiles (the last ones) are launched first so the tail of
//   the grid is short.  Ragged edges (T not a multiple of the tiles) are
//   masked; padded rows are never stored.
// * A row that has seen no visible key yet keeps m = -inf; it subtracts
//   0 instead of m, so ex2 gives 0, not 2^(-inf - -inf) = NaN.
//
// Tiles.  BKV = 64 keys up to D = 64, 32 at D = 128: shared memory
// 38.5 / 71 / 136 / 168 KiB at D = 16 / 32 / 64 / 128 (q halves, a raw
// K/V tile, K halves, V^T halves; rows padded to 4 mod 32 banks).  At
// D = 64 the 64-key tile (one CTA an SM) beat the 32-key one (two an SM)
// and a 64-key tile with q's fragments in registers (two an SM): 0.062
// ms at T = 1024 causal against 0.082 and 0.069 (PERF.md).
//
// C interface (ctypes): mx_flash_attention_fwd returns the CUDA error
// code of the launch (0 on success).  It allocates nothing; the caller
// passes contiguous fp32 device pointers and the stream.

#include <math.h>

#include "tc_gemm.cuh"

namespace {

using tc::ldsm4;
using tc::ldsm_pairs;
using tc::mma3;
using tc::split;
using tc::split4;

constexpr int BQ = 64;              // q rows per CTA
constexpr int WARPS = BQ / 16;      // 16 q rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory (floats): q halves [BQ][LDR]; one raw K and V tile
// [BKV][LDR] each; K halves [BKV][LDR]; V^T halves [D][LDV]
template <int D>
struct Cfg {
  static constexpr int BKV = D <= 64 ? 64 : 32;
  static constexpr int LDR = D + 4;
  static constexpr int LDV = BKV + 4;
  static constexpr int QB = 0, QS = BQ * LDR;
  static constexpr int RK = 2 * BQ * LDR, RV = RK + BKV * LDR;
  static constexpr int KB = RV + BKV * LDR, KS = KB + BKV * LDR;
  static constexpr int VB = KS + BKV * LDR, VS = VB + D * LDV;
  static constexpr int FLOATS = VS + D * LDV;
  static_assert(BKV % 32 == 0, "a warp's V pass covers 32 keys");
};

// the k slot of key r within its group of 8: 2t -> t, 2t + 1 -> t + 4
__device__ __forceinline__ int key_slot(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int t,
                 float scale, int causal) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV, LDR = C::LDR, LDV = C::LDV;
  constexpr int D4 = D / 4;
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.x;
  // heaviest causal tiles first: blockIdx.y = 0 takes the last q tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const size_t base = (size_t)bh * t * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  const int q_end = min(q0 + BQ, t);       // one past the last real row
  int nk = (t + BKV - 1) / BKV;
  if (causal) nk = min(nk, (q_end + BKV - 1) / BKV);

  auto load_kv = [&](int k0) {
    for (int c = tid; c < BKV * D4; c += THREADS) {
      const int r = c / D4, d = (c % D4) * 4;
      const bool ok = k0 + r < t;
      const size_t at = (size_t)(k0 + r) * D + d;
      tc::cp16(smem + C::RK + r * LDR + d, ok ? kb + at : kb, ok);
      tc::cp16(smem + C::RV + r * LDR + d, ok ? vb + at : vb, ok);
    }
    tc::commit();
  };
  load_kv(0);

  // q' = q * scale * log2 e, split once; rows past t are 0
  const float qscale = scale * LOG2E;
  for (int c = tid; c < BQ * D4; c += THREADS) {
    const int r = c / D4, d = (c % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < t)
      x = __ldg(reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * D +
                                                d));
    split4(make_float4(x.x * qscale, x.y * qscale, x.z * qscale,
                       x.w * qscale),
           smem + C::QB + r * LDR + d, smem + C::QS + r * LDR + d);
  }

  // this lane's ldmatrix rows and columns (see tc::Frag)
  const int a_row = warp * 16 + (lane & 7) + (lane & 8);
  const int a_col = (lane >> 4) * 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = (lane & 8) >> 1;
  const int row0 = q0 + warp * 16 + g;     // rows of c0, c1; +8: c2, c3

  float acc[D / 8][4], m[2], l[2];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BKV;
    tc::wait_groups<0>();
    __syncthreads();   // tile kt landed; the last tile's products done
    // the split pass: K into halves in place of rows; V transposed, its
    // keys in k-slot order
    for (int c = tid; c < BKV * D4; c += THREADS) {
      const int r = c / D4, d = (c % D4) * 4;
      split4(*reinterpret_cast<const float4*>(smem + C::RK + r * LDR + d),
             smem + C::KB + r * LDR + d, smem + C::KS + r * LDR + d);
    }
    for (int c = tid; c < BKV * D4; c += THREADS) {
      const int r = c % BKV, d = (c / BKV) * 4;
      const float4 x =
          *reinterpret_cast<const float4*>(smem + C::RV + r * LDR + d);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const int col = key_slot(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hb, hs;
        split(xs[e], hb, hs);
        smem[C::VB + (d + e) * LDV + col] = __uint_as_float(hb);
        smem[C::VS + (d + e) * LDV + col] = __uint_as_float(hs);
      }
    }
    __syncthreads();   // halves ready; the raw tile is free
    if (kt + 1 < nk) load_kv(k0 + BKV);
    // a warp whose rows all lie above the tile has nothing to add
    if (causal && k0 > q0 + warp * 16 + 15) continue;

    // S = q' k^T, 16 x BKV a warp
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 8; ++kd) {
      uint32_t qa[4], qs[4];
      ldsm4(qa, smem + C::QB + a_row * LDR + kd * 8 + a_col);
      ldsm4(qs, smem + C::QS + a_row * LDR + kd * 8 + a_col);
      uint32_t kb2[BKV / 8][2], ks2[BKV / 8][2];
#pragma unroll
      for (int jp = 0; jp < BKV / 16; ++jp)
        ldsm_pairs(kb2, ks2, jp, smem + C::KB, smem + C::KS,
                   (jp * 16 + b_row) * LDR + kd * 8 + b_col);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) mma3(s[j], qa, qs, kb2[j], ks2[j]);
    }

    // mask: keys past t, and (causal) keys past the row
    if (k0 + BKV > t || (causal && k0 + BKV - 1 > q0 + warp * 16)) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * tq + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= t || (causal && col > row)) s[j][e] = -INFINITY;
        }
    }

    // the online softmax, rows g (h = 0) and g + 8 (h = 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = tc::ex2(m[h] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][2 * h + e] = tc::ex2(s[j][2 * h + e] - m_use);
          rs += s[j][2 * h + e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[h] = l[h] * alpha[h] + rs;
      m[h] = m_new;
    }

    // O = O * alpha + P V, P from the accumulators: k slot t = key 2t,
    // slot t + 4 = key 2t + 1
    float part[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);   // (g, slot t)
      split(s[j][2], pb[1], ps[1]);   // (g + 8, slot t)
      split(s[j][1], pb[2], ps[2]);   // (g, slot t + 4)
      split(s[j][3], pb[3], ps[3]);   // (g + 8, slot t + 4)
      uint32_t vb2[D / 8][2], vs2[D / 8][2];
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp)
        ldsm_pairs(vb2, vs2, dp, smem + C::VB, smem + C::VS,
                   (dp * 16 + b_row) * LDV + j * 8 + b_col);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma3(part[dn], pb, ps, vb2[dn], vs2[dn]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = acc[j][e] * alpha[e >> 1] + part[j][e];
  }

  float* ob = o + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(ob + (size_t)row * D + j * 8 + 2 * tq) =
          make_float2(acc[j][2 * h] / l[h], acc[j][2 * h + 1] / l[h]);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int t, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, o, t, scale,
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
  // rows are read and written as 16-byte vectors
  if (!tc::aligned16(q) || !tc::aligned16(k) || !tc::aligned16(v) ||
      !tc::aligned16(o))
    return (int)cudaErrorMisalignedAddress;
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
