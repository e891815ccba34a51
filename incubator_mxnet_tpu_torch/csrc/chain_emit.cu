// Pass 2 of the bottleneck chain for Hopper (sm_90a): BN1-apply -> ReLU
// -> 3x3 conv2 -> BN2-apply -> ReLU -> 1x1 conv3 + bias, on the tensor
// cores in two forms: fp32 (fp32-accurate, 3xTF32) and bf16.
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
// against one read of c1 and one write of out: at ResNet-50's four chain
// shapes at batch 128 (56x56x64 -> 64 -> 256 ... 7x7x512 -> 512 -> 2048,
// 42.8 GFLOP each) it is bound by operations: 0.259 ms a launch at the
// 165 TFLOP/s of fp32-accurate (3xTF32) tensor-core work.
//
// Design (tc_gemm.cuh for the main loop and its numerics).  A CTA owns
// BM output pixels (flat over the batch) and all Cm channels of c2.
// conv2 runs as the 3x3 implicit GEMM over Cm in BN-wide chunks, in one
// cp.async ring (3 slots of 32 channels of one tap, one barrier a step)
// that runs on from one chunk into the next; raw c1 rows arrive as they
// are and the BN1 affine, the ReLU and the tap mask are applied as each
// warp loads its A fragments.  Each chunk's epilogue applies the BN2
// affine and the ReLU in registers and stores y2 into a resident
// shared-memory tile (BM rows of Cm rounded up to BN, plus 4 floats, so
// that the row stride is 4 mod 32 banks and conv3's A fragment loads are
// conflict-free).  conv3 then reads its A fragments from that tile while
// w3 streams through the same ring, Co in BN-wide chunks; the bias is
// added and out written channels-last by tc::store_bias, float4 stores
// (lane pairs swap halves by a shuffle) where the row allows.  conv2 is
// computed once per CTA, not once per Co tile.
//
// Tile per shape.  Larger BM shares each weight slot among more rows,
// which the measurements favour over more CTAs an SM; the y2 tile and
// the number of SMs bound it.  mx_chain_emit takes BN = 64 (2 x 2 warps)
// when Cm <= 64, so no chunk is half empty; else BN = 128 and the
// larger BM of 128 (Cm <= 128 only) and 96 whose CTAs fit in shared
// memory and are at least one per SM, else BM = 48 (1 x 4 warps).
// ResNet-50 at b = 128:
//   56x56 (Cm  64): 64 x 64,   6272 CTAs,  72 KB, up to 3 an SM
//   28x28 (Cm 128): 128 x 128,  784 CTAs, 175 KB, 1 an SM, 5.9 waves
//   14x14 (Cm 256): 96 x 128,   262 CTAs, 193 KB, 1 an SM, 2.0 waves
//   7x7   (Cm 512): 48 x 128,   131 CTAs, 172 KB, one wave (64-row
//                   tiles would give 98 CTAs and leave 34 SMs idle)
// Cm = 768, the envelope's edge, takes 48 x 128 (220 KB).
//
// What it reaches (PERF.md, measured by tools/port_chain_sweep.py).
// mma.sync tf32 peaks at about 320 TFLOP/s on the H100, not wgmma's 495,
// so 3xTF32 through it cannot go below ~0.4 ms at these shapes; the
// kernel takes 2.3-3.4x that.  The three products, the cp.async copies
// and the BN1 prologue each cost a share that the warps of a CTA, held
// in step by one barrier a step, do not hide behind one another.
//
// Left for later: wgmma with B from shared memory (this is mma.sync, A
// from registers, where the BN1 prologue runs anyway); TMA loads and
// multicast of w2 / w3 across a cluster; Co split across a cluster whose
// CTAs share one y2 tile through distributed shared memory.
//
// The bf16 form (mx_chain_emit_bf16): c1, w2, w3 and out bf16, the
// affines and b3 fp32, the TPU kernel's arithmetic on bf16 data: the BN1
// activation rounded to bf16, conv2 summed in fp32, relu(c2 * a2 + b2)
// in fp32 rounded to bf16 into the y2 tile, conv3 summed in fp32, + b3,
// rounded to bf16 once.  The y2 tile is bf16, half the fp32 one, so Cm
// reaches 1536 (the 48-row tile) where fp32 stops at 768.  The same
// tiles and rule on tc_gemm.cuh's bf16 path.  Bound at b = 128: 0.0767
// ms by bytes at 56x56, 0.0432 by operations (989 TFLOP/s) at the other
// three; it takes 0.491, 0.406, 0.385, 0.553 ms (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700 W).
//
// C interface (ctypes): mx_chain_emit and mx_chain_emit_bf16 return the
// CUDA error code of the launch (0 on success).  They allocate nothing;
// the caller passes contiguous device pointers (c1, w2, w3, out in the
// form's type, the rest fp32) and the stream.

#include "tc_gemm.cuh"

namespace {

using tc::aligned16;

// the y2 tile's row (elements): Cm rounded up to whole BN-wide chunks,
// plus 16 bytes (a row stride of 4 mod 32 banks)
template <class T>
__host__ __device__ int y2_ld(int cm) {
  return (cm + T::BN - 1) / T::BN * T::BN + T::PAD;
}

template <class T>
size_t smem_bytes(int cm) {
  return T::RING_BYTES +
         (size_t)T::BM * y2_ld<T>(cm) * sizeof(typename T::E);
}

template <class E>
struct Emit {
  const float* a2;
  const float* b2;
  const E* w3;
  const float* b3;
  E* out;
  int Co;
  bool vec3;     // Cm a multiple of a 16-byte copy, w3 16-byte aligned
  bool vec_out;  // Co % 4 == 0 and out, b3 16-byte aligned
};

template <class T>
__global__ void __launch_bounds__(T::THREADS)
chain_emit_kernel(tc::Conv<typename T::E> p, Emit<typename T::E> e) {
  using E = typename T::E;
  extern __shared__ __align__(16) float smem[];
  E* ring = reinterpret_cast<E*>(smem);
  E* y2s = ring + tc::STAGES * T::SLOT;
  const int m0 = blockIdx.x * T::BM;
  const int Cm = p.N;
  const int ld = y2_ld<T>(Cm);
  const tc::Conv3x3<T> conv(p, m0);
  const tc::Frag<T>& f = conv.f;
  tc::Acc<T> acc;
  tc::zero<T>(acc);

  // y2 = relu(conv2 * a2 + b2) (bf16: rounded to nearest even), chunk by
  // chunk; columns past Cm hold 0
  const int ks2 = p.steps();
  const int chunks2 = (Cm + T::BN - 1) / T::BN;
  tc::pipeline(
      chunks2 * ks2,
      [&](int s, int slot) {
        conv.load(s % ks2, (s / ks2) * T::BN, ring + slot * T::SLOT);
      },
      [&](int s, int slot) {
        const int ks = s % ks2;
        conv.compute(ks, ring + slot * T::SLOT, acc);
        if (ks != ks2 - 1) return;
        const int n0 = (s / ks2) * T::BN;
#pragma unroll
        for (int j = 0; j < T::NI; ++j) {
          const int n = n0 + f.col0(j);
          const bool ok0 = n < Cm, ok1 = n + 1 < Cm;
          const float a0 = ok0 ? __ldg(e.a2 + n) : 0.f;
          const float b0 = ok0 ? __ldg(e.b2 + n) : 0.f;
          const float a1 = ok1 ? __ldg(e.a2 + n + 1) : 0.f;
          const float b1 = ok1 ? __ldg(e.b2 + n + 1) : 0.f;
#pragma unroll
          for (int i = 0; i < T::MI; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* c = acc[i][j] + 2 * h;
              E* at = y2s + (f.row0(i) + 8 * h) * ld + n;
              if constexpr (T::TF32)
                *reinterpret_cast<float2*>(at) =
                    make_float2(fmaxf(fmaf(c[0], a0, b0), 0.f),
                                fmaxf(fmaf(c[1], a1, b1), 0.f));
              else
                *reinterpret_cast<uint32_t*>(at) = tc::pack_bf16(
                    tc::act(c[0], a0, b0), tc::act(c[1], a1, b1));
            }
        }
        tc::zero<T>(acc);
      });

  // out = y2 @ w3^T + b3, Co in BN-wide chunks, w3 through the same ring
  const int ks3 = (Cm + T::BK - 1) / T::BK;
  const int chunks3 = (e.Co + T::BN - 1) / T::BN;
  const int M = p.M, Co = e.Co;
  tc::pipeline(
      chunks3 * ks3,
      [&](int s, int slot) {
        const int o0 = (s / ks3) * T::BN;
        const E* w3 = e.w3;
        tc::copy_rows<T::BN, T::THREADS>(
            ring + slot * T::SLOT + T::B_OFF,
            [&](int r) { return w3 + (long long)(o0 + r) * Cm; },
            [&](int r) { return o0 + r < Co; }, (s % ks3) * T::BK, Cm,
            e.vec3, w3);
      },
      [&](int s, int slot) {
        const int ks = s % ks3;
        const E* a = y2s + ks * T::BK;
        auto a_frag = [&](int i, int kk, uint32_t (&ab)[4],
                          uint32_t (&as)[4]) {
          uint32_t r[4];
          tc::ldsm4(r, a + f.a_row(i) * ld + kk * T::KK + f.a_col());
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (T::TF32)
              tc::split(__uint_as_float(r[q]), ab[q], as[q]);
            else
              ab[q] = r[q];
          }
        };
        tc::mma_slot<T>(ring + slot * T::SLOT + T::B_OFF, f, a_frag, acc);
        if (ks != ks3 - 1) return;
        tc::store_bias<T>(acc, f, m0, (s / ks3) * T::BN, M, Co, e.b3, e.out,
                          e.vec_out);
        tc::zero<T>(acc);
      });
}

template <class T>
int launch_emit(const tc::Conv<typename T::E>& p,
                const Emit<typename T::E>& e, cudaStream_t stream) {
  const size_t dyn = smem_bytes<T>(p.N);
  cudaError_t err = cudaFuncSetAttribute(
      chain_emit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int m_tiles = (p.M + T::BM - 1) / T::BM;
  chain_emit_kernel<T><<<m_tiles, T::THREADS, dyn, stream>>>(p, e);
  return (int)cudaGetLastError();
}

// The tiles, chosen per shape by chain_emit (see the note)
template <class E>
using Cm64 = tc::Tile<64, 64, 2, 2, E>;
template <class E>
using Rows128 = tc::Tile<128, 128, 2, 4, E>;
template <class E>
using Rows96 = tc::Tile<96, 128, 2, 4, E>;
template <class E>
using Rows48 = tc::Tile<48, 128, 1, 4, E>;

template <class T>
bool fits(int cm, int max_smem) {
  return smem_bytes<T>(cm) <= (size_t)max_smem;
}

template <class T>
bool fills(int m, int sms) {
  return (m + T::BM - 1) / T::BM >= sms;
}

template <class E>
int chain_emit(const void* x, const void* a1, const void* b1, const void* w2,
               const void* a2, const void* b2, const void* w3,
               const void* b3, void* out, int n, int h, int w, int c, int cm,
               int co, void* stream) {
  const tc::Conv<E> p = tc::conv_operands<E>(x, a1, b1, w2, n, h, w, c, cm);
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
  const Emit<E> e{static_cast<const float*>(a2), static_cast<const float*>(b2),
                  static_cast<const E*>(w3), static_cast<const float*>(b3),
                  static_cast<E*>(out), co,
                  cm % tc::Geo<E>::VEC == 0 && aligned16(w3),
                  co % 4 == 0 && aligned16(out) && aligned16(b3)};
  auto s = static_cast<cudaStream_t>(stream);
  if (cm <= 64) return launch_emit<Cm64<E>>(p, e, s);
  if (cm <= 128 && fills<Rows128<E>>(p.M, sms))
    return launch_emit<Rows128<E>>(p, e, s);
  if (fits<Rows96<E>>(cm, max_smem) && fills<Rows96<E>>(p.M, sms))
    return launch_emit<Rows96<E>>(p, e, s);
  if (fits<Rows48<E>>(cm, max_smem)) return launch_emit<Rows48<E>>(p, e, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mx_chain_emit(const void* x, const void* a1, const void* b1,
                             const void* w2, const void* a2, const void* b2,
                             const void* w3, const void* b3, void* out,
                             int n, int h, int w, int c, int cm, int co,
                             void* stream) {
  return chain_emit<float>(x, a1, b1, w2, a2, b2, w3, b3, out, n, h, w, c,
                           cm, co, stream);
}

extern "C" int mx_chain_emit_bf16(const void* x, const void* a1,
                                  const void* b1, const void* w2,
                                  const void* a2, const void* b2,
                                  const void* w3, const void* b3, void* out,
                                  int n, int h, int w, int c, int cm, int co,
                                  void* stream) {
  return chain_emit<tc::bf16>(x, a1, b1, w2, a2, b2, w3, b3, out, n, h, w, c,
                              cm, co, stream);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
