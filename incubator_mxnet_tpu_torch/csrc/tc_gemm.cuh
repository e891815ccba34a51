// A warp-level tensor-core main loop for Hopper (sm_90a): mma.sync fed by
// a cp.async ring in dynamic shared memory, for fp32 operands (3xTF32,
// fp32-accurate) and bf16 operands (one bf16 product, fp32
// accumulation).  Every GEMM-shaped kernel of the port runs on it: the
// 1x1 walker (Gemm1x1, below) carries sbr_matmul.cu (B1); the 3x3
// implicit GEMM (Conv3x3) carries sbr_conv3x3.cu (B2), chain_stats.cu
// (B3) and chain_emit.cu (B4); flash_attention.cu (B5) uses its PTX
// helpers and numerics for both of its products.  Each kernel's note
// says which TPU kernel it replaces.
//
// Element types.  Everything below is a template on the operands'
// element type E, float or bf16 (the bit pattern; arithmetic only
// through the helpers here), set by the tile (Tile<..., E>).  The
// geometry is the same in bytes for both (Geo): a reduction step covers
// 128 bytes of a row (BK = 32 fp32 or 64 bf16 channels of one tap), and
// one mma k-step 32 bytes (KK = 8 or 16 channels), so a slot holds four
// k-steps of either type, ldmatrix reads the same byte offsets, and a
// 16-byte cp.async moves 4 or 8 channels.  The per-channel affine, the
// bias and the accumulators are fp32 for both.
//
// Products, fp32.  mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// multiplies a 16x8 A fragment by an 8x8 B fragment into a 16x8 fp32
// accumulator.  TF32 keeps 10 mantissa bits, so each operand x is split
// into big = tf32_rna(x) and small = tf32_rna(x - big) (rounded to
// nearest, ties away, as cvt.rna.tf32.f32 rounds), and three products
// are accumulated: a_s*b_b + a_b*b_s, then a_b*b_b (small*small, ~2^-22
// of the product, is dropped).  That is fp32's accuracy at three times
// the TF32 work: 495 / 3 = 165 TFLOP/s of fp32-accurate products on an
// H100 SXM through wgmma, against 67 TFLOP/s on the CUDA cores.
//
// Products, bf16.  mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// a 16x16 A fragment by a 16x8 B fragment, each 32-bit register two bf16
// of neighbouring channels (the lower channel in the lower half).  A
// bf16 x bf16 product is exact in fp32, so this is the JAX kernels'
// `dot(..., preferred_element_type=float32)` up to the order of the fp32
// sums (989 TFLOP/s dense bf16 through wgmma on an H100 SXM).
//
// Fragment layout (PTX ISA), g = lane / 4, t = lane % 4, in 32-bit words
// of a row (word w = channels w of fp32, 2w and 2w + 1 of bf16):
//   A (16 rows x 32 bytes): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//                           a3 (g+8, t+4)
//   B (8 columns x 32 bytes, rows of n): b0 (n g, t), b1 (n g, t+4)
//   C (16x8 fp32):          c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                           c3 (g+8, 2t+1)
//
// Tiling.  A CTA owns a BM x BN tile, its warps a WGM x WGN grid of WM x
// WN warp tiles (MI x NI mma tiles each).  The reduction runs in steps
// of BK channels of one tap.  Each step's operands are copied by
// cp.async into one slot of a STAGES-deep ring (one commit group a step,
// STAGES - 1 steps in flight) and there is one barrier a step.  A slot
// holds A as BM rows of BK elements, B as BN rows of BK elements (both
// k-contiguous, as channels-last rows are in device memory), and the
// step's per-channel fp32 affine (a, b).  Rows are padded by 16 bytes
// (LDS = BK + 4 floats or BK + 8 bf16: 144 bytes, 4 mod 32 banks), so
// the 8 rows of each 8x8 matrix that ldmatrix reads for a fragment start
// in banks 4r and cover all 32 banks once, and the 16-byte cp.async
// stores of 8 threads cover one row's 32 banks.
//
// Accumulation.  The tensor cores add into the accumulator rounding
// toward zero, so a running sum over thousands of products drifts (4e-5
// of max |out| over K = 4608 on the H100).  Each slot's channels are
// therefore summed into a fresh fragment and added to the running sum
// by an fp32 add, which rounds to nearest.
//
// Operand preparation.  The 3x3 loop applies the affine, the ReLU and the
// tap mask (and, for fp32, makes the TF32 split) as each warp loads a
// fragment (mma_slot): every warp column of a CTA repeats that work.
// The 1x1 walker instead runs one pass of the whole CTA per step over
// the landed slot (fp32: A activated and both operands split, big halves
// in place, small halves beside them; bf16: A activated in place, B as
// it landed), so a fragment is a plain ldmatrix (mma_ready).
//
// bf16 activation.  relu(x * a + b) is computed in fp32, the multiply
// and the add each rounded (as the plain versions' two ops round them),
// then rounded to bf16 to nearest even (cvt.rn.bf16x2.f32, as JAX's
// astype rounds), before the tap mask: the JAX kernels round the
// activated image to the data's dtype before their bf16 products.
//
// The 3x3 implicit GEMM (Conv, Conv3x3 below) is the main loop of the fused
// [BN-apply -> ReLU -> conv] kernels of the bottleneck chain:
//
//   c[m, n] = sum_{t < 9, c < C} y(m, t, c) * w[n, t, c]
//   y(m, t, c) = relu(x[m + shift(t), c] * a[c] + b[c])  if tap t of
//                pixel m lies inside its image, else 0
//
// with m the flat pixel n*H*W + h*W + w over the whole batch, x
// channels-last (M rows of C), w OHWI (N rows of 9*C).  Raw rows of x are
// copied as they are (a tap outside the image zero-filled by cp.async's
// src-size 0); the affine, the ReLU and then the tap mask are applied
// when a warp loads its A fragment, because relu(0*a + b) is not 0: the
// padding zero comes after the activation.  B4 walks all N columns of
// its rows in one CTA; B2 and B3 run one CTA per BM x BN tile of c
// (conv3x3_kernel below) and differ only in what their epilogue does
// with the tile: store it plus a bias, or reduce its columns.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int STAGES = 3;          // depth of the cp.async ring

// A bf16 value: its bit pattern
struct bf16 {
  uint16_t bits;
};

// The ring's geometry for element type E, the same in bytes for every E
template <class E>
struct Geo {
  static constexpr int BK = 128 / (int)sizeof(E);   // channels a step
  static constexpr int PAD = 16 / (int)sizeof(E);   // 16 bytes a row
  static constexpr int LDS = BK + PAD;              // padded slot row
  static constexpr int VEC = 16 / (int)sizeof(E);   // a 16-byte copy
  static constexpr int KK = 32 / (int)sizeof(E);    // an mma k-step
  static constexpr int EPW = 4 / (int)sizeof(E);    // elements a word
  static constexpr bool TF32 = sizeof(E) == 4;      // 3xTF32 products
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, global -> shared, bypassing L1; zero-filled when !pred.
// Both addresses 16-byte aligned.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes, for rows that are not 16-byte aligned; zero-filled when !pred
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// Four 8x8 matrices of b16 pairs (32-bit words) from shared memory:
// lane L gives the address of row L % 8 of matrix L / 8, and r[m] gets
// word L % 4 of row L / 4 of matrix m, which is where the mma fragments
// want them (g = L / 4, t = L % 4).  Rows 16-byte aligned.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 on the integer pipe: round the fp32 bit pattern to
// nearest, ties away, at 10 mantissa bits.  The same result for every
// finite x, in two integer instructions instead of one on the
// conversion unit, which does 16 lanes an SM a clock.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// 2^x (ex2.approx: ~2 ulp; 2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16(lo) in the low half, bf16(hi) in the high half, each rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the bf16 in the low / high half of a word, as fp32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// relu(x * a + b) in fp32, the product and the sum each rounded (no
// contraction), as the bf16 activation rounds them before bf16
__device__ __forceinline__ float act(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.f);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at fp32 accuracy: the two cross terms first, the big
// product last
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(d, as, bb);
  mma(d, ab, bs);
  mma(d, ab, bb);
}

// d += a * b, bf16 operands, fp32 accumulator (m16n8k16)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four fp32 values stored as E (bf16: rounded to nearest even), at an
// address aligned to their size
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  p->bits = (uint16_t)(pack_bf16(v, 0.f) & 0xFFFFu);
}

// ------------------------------------------------------------------ tile
// A CTA tile: BM x BN, warps WGM x WGN, operands of type E
template <int BM_, int BN_, int WGM_, int WGN_, class E_ = float>
struct Tile : Geo<E_> {
  using E = E_;
  using G = Geo<E_>;
  static constexpr int BM = BM_, BN = BN_, WGM = WGM_, WGN = WGN_;
  static constexpr int THREADS = 32 * WGM * WGN;
  static constexpr int WM = BM / WGM;
  static constexpr int WN = BN / WGN;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static_assert(MI >= 1 && NI >= 2 && WM % 16 == 0 && WN % 16 == 0,
                "warp tile is not whole mma tiles, B fragments in pairs");
  static_assert(THREADS >= 2 * G::BK, "the affine copy needs 2 * BK threads");
  // one ring slot, in elements of E: A rows, B rows, the step's fp32
  // affine (a, b)
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = BM * G::LDS;
  static constexpr int AB_OFF = (BM + BN) * G::LDS;
  static constexpr int SLOT =
      AB_OFF + 2 * G::BK * (int)(sizeof(float) / sizeof(E));
  static constexpr size_t RING_BYTES = (size_t)STAGES * SLOT * sizeof(E);
};

template <class T>
using Acc = float[T::MI][T::NI][4];

template <class T>
__device__ __forceinline__ void zero(Acc<T>& acc) {
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// Where this thread's accumulators sit in the BM x BN tile: acc[i][j][q]
// is at row row0(i) + 8 * (q / 2), column col0(j) + q % 2.
template <class T>
struct Frag {
  int wm, wn, lane, g, t;
  __device__ Frag() {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wm = warp / T::WGN;
    wn = warp % T::WGN;
    g = lane / 4;
    t = lane % 4;
  }
  __device__ int row0(int i) const { return wm * T::WM + i * 16 + g; }
  __device__ int col0(int j) const { return wn * T::WN + j * 8 + 2 * t; }
  // the row and column (in elements, within a k-step) this lane
  // addresses for ldsm4: A fragment i (rows 0-7 then 8-15, bytes 0-15
  // then 16-31), and B fragments 2jp and 2jp + 1 (bytes 0-15 then 16-31
  // of each)
  __device__ int a_row(int i) const {
    return wm * T::WM + i * 16 + (lane & 7) + (lane & 8);
  }
  __device__ int a_col() const { return (lane >> 4) * (T::KK / 2); }
  __device__ int b_row(int jp) const {
    return wn * T::WN + jp * 16 + (lane & 7) + (lane >> 4) * 8;
  }
  __device__ int b_col() const { return ((lane & 8) >> 3) * (T::KK / 2); }
};

// The ring.  steps reduction steps; load(s, slot) issues step s's
// cp.async copies into slot, compute(s, slot) runs on it once it has
// arrived.  Starts with the ring free (the caller's barrier) and ends
// with it free and every copy landed (a final barrier), so whatever
// compute wrote to shared memory outside the ring is visible after it.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int steps, const Load& load,
                                         const Compute& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    commit();
  }
  for (int s = 0; s < steps; ++s) {
    wait_groups<STAGES - 2>();   // step s has landed (this thread's part)
    __syncthreads();             // ... everyone's; slot (s-1) is free
    const int next = s + STAGES - 1;
    if (next < steps) load(next, next % STAGES);
    commit();
    compute(s, s % STAGES);
  }
  wait_groups<0>();
  __syncthreads();
}

// B fragments 2jp and 2jp + 1 of k-step kk from rows of n (k
// contiguous, LDS apart): fp32 as TF32 halves bb / bs, bf16 as they are
// (bb)
template <class T>
__device__ __forceinline__ void b_frags(uint32_t (&bb)[T::NI][2],
                                        uint32_t (&bs)[T::NI][2],
                                        const typename T::E* rows,
                                        const Frag<T>& f, int jp, int kk) {
  uint32_t r[4];
  ldsm4(r, rows + f.b_row(jp) * T::LDS + kk * T::KK + f.b_col());
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (T::TF32)
      split(__uint_as_float(r[q]), bb[2 * jp + q / 2][q % 2],
            bs[2 * jp + q / 2][q % 2]);
    else
      bb[2 * jp + q / 2][q % 2] = r[q];
  }
}

// d += a * b: 3xTF32 for fp32 (with the small halves as, bs), one bf16
// product for bf16
template <class T>
__device__ __forceinline__ void product(float (&d)[4],
                                        const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const uint32_t (&bb)[2],
                                        const uint32_t (&bs)[2]) {
  if constexpr (T::TF32)
    mma3(d, ab, as, bb, bs);
  else
    mma_bf16(d, ab, bb);
}

template <class T>
__device__ __forceinline__ void add_part(Acc<T>& acc, const Acc<T>& part) {
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
}

// acc += A * B over the BK channels of a slot: B from the slot's B rows,
// A fragments given by a_frag(i, kk, big, small) for k-step kk (small
// unused for bf16).  The slot's sum is taken in a fresh fragment and
// added to acc in fp32 (see Accumulation).
template <class T, class AFrag>
__device__ __forceinline__ void mma_slot(const typename T::E* bs,
                                         const Frag<T>& f,
                                         const AFrag& a_frag, Acc<T>& acc) {
  Acc<T> part;
  zero<T>(part);
#pragma unroll
  for (int kk = 0; kk < T::BK / T::KK; ++kk) {
    uint32_t bb[T::NI][2], bsm[T::NI][2];
#pragma unroll
    for (int jp = 0; jp < T::NI / 2; ++jp) b_frags<T>(bb, bsm, bs, f, jp, kk);
#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
      uint32_t ab[4], as[4];
      a_frag(i, kk, ab, as);
#pragma unroll
      for (int j = 0; j < T::NI; ++j)
        product<T>(part[i][j], ab, as, bb[j], bsm[j]);
    }
  }
  add_part<T>(acc, part);
}

// B fragments 2p and 2p + 1, big and small halves, by one ldmatrix of
// each (rows of n, k contiguous; this lane's address at off, as b_row
// and b_col give it)
template <int NI>
__device__ __forceinline__ void ldsm_pairs(uint32_t (&bb)[NI][2],
                                           uint32_t (&bs)[NI][2], int p,
                                           const float* big,
                                           const float* small, int off) {
  uint32_t r[4], q[4];
  ldsm4(r, big + off);
  ldsm4(q, small + off);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    bb[2 * p + h / 2][h % 2] = r[h];
    bs[2 * p + h / 2][h % 2] = q[h];
  }
}

// acc += A * B over the BK channels of a slot whose operands are ready:
// A at ab (rows lda elements apart), B at bb (rows LDS apart), and for
// fp32 their TF32 small halves at as / bs (the big ones at ab / bb), so
// every fragment is one ldmatrix (two for fp32).  Fresh fragment per
// slot, as mma_slot.
template <class T>
__device__ __forceinline__ void mma_ready(const typename T::E* ab,
                                          const typename T::E* as, int lda,
                                          const typename T::E* bb,
                                          const typename T::E* bs,
                                          const Frag<T>& f, Acc<T>& acc) {
  Acc<T> part;
  zero<T>(part);
#pragma unroll
  for (int kk = 0; kk < T::BK / T::KK; ++kk) {
    uint32_t bbig[T::NI][2], bsml[T::NI][2];
#pragma unroll
    for (int jp = 0; jp < T::NI / 2; ++jp) {
      const int off = f.b_row(jp) * T::LDS + kk * T::KK + f.b_col();
      if constexpr (T::TF32) {
        ldsm_pairs(bbig, bsml, jp, bb, bs, off);
      } else {
        uint32_t r[4];
        ldsm4(r, bb + off);
#pragma unroll
        for (int h = 0; h < 4; ++h) bbig[2 * jp + h / 2][h % 2] = r[h];
      }
    }
#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
      uint32_t abig[4], asml[4];
      const int off = f.a_row(i) * lda + kk * T::KK + f.a_col();
      ldsm4(abig, ab + off);
      if constexpr (T::TF32) ldsm4(asml, as + off);
#pragma unroll
      for (int j = 0; j < T::NI; ++j)
        product<T>(part[i][j], abig, asml, bbig[j], bsml[j]);
    }
  }
  add_part<T>(acc, part);
}

// Four floats into their TF32 halves: big over v (in place), small at sml
__device__ __forceinline__ void split4(float4 v, float* big, float* sml) {
  uint32_t b[4], s[4];
  split(v.x, b[0], s[0]);
  split(v.y, b[1], s[1]);
  split(v.z, b[2], s[2]);
  split(v.w, b[3], s[3]);
  *reinterpret_cast<uint4*>(big) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(sml) = make_uint4(s[0], s[1], s[2], s[3]);
}

// Copy rows [0, ROWS) x [k0, k0 + BK) of a row-major matrix of E into a
// slot's rows (ld elements apart), zero-filling rows for which ok(r) is
// false and columns at or past cols.  src(r) is row r's start.  vec:
// 16-byte copies (cols a multiple of VEC and every row 16-byte aligned);
// else one element at a time (fp32: 4-byte cp.async; bf16: a plain load
// and store, which lands before the barrier that precedes the slot's
// use).  any: a valid address for the zero-filling copies.
template <int ROWS, int THREADS, class E, class Src, class Ok>
__device__ __forceinline__ void copy_rows(E* dst, const Src& src,
                                          const Ok& ok, int k0, int cols,
                                          bool vec, const E* any,
                                          int ld = Geo<E>::LDS) {
  constexpr int BK = Geo<E>::BK, VEC = Geo<E>::VEC;
  if (vec) {
    constexpr int CHUNKS = ROWS * BK / VEC;
#pragma unroll
    for (int q = threadIdx.x; q < CHUNKS; q += THREADS) {
      const int r = q / (BK / VEC), k = k0 + (q % (BK / VEC)) * VEC;
      const bool p = ok(r) && k < cols;
      cp16(dst + r * ld + (k - k0), p ? src(r) + k : any, p);
    }
  } else {
    constexpr int ELEMS = ROWS * BK;
#pragma unroll 4
    for (int q = threadIdx.x; q < ELEMS; q += THREADS) {
      const int r = q / BK, k = k0 + q % BK;
      const bool p = ok(r) && k < cols;
      if constexpr (Geo<E>::TF32)
        cp4(dst + r * ld + (k - k0), p ? src(r) + k : any, p);
      else
        dst[r * ld + (k - k0)] = p ? src(r)[k] : E{0};
    }
  }
}

// ------------------------------------------------------------- epilogue
// out[m, n] = acc + bias[n] (fp32, then rounded to O) over the tile's
// rows m0 + ... below M and columns n0 + ... below N (out: rows of N).
// vec (N % 4 == 0, out and bias 16-byte aligned): 4-column stores, lanes
// t and t^1 swapping halves by a shuffle, so the even one stores row
// g's columns 2t..2t+3 and the odd one row g+8's 2t-2..2t+1.  Every
// lane of the warp calls it.
template <class T, class O>
__device__ __forceinline__ void store_bias(const Acc<T>& acc,
                                           const Frag<T>& f, int m0, int n0,
                                           int M, int N, const float* bias,
                                           O* out, bool vec) {
  const bool odd = f.t & 1;
#pragma unroll
  for (int j = 0; j < T::NI; ++j) {
    const int n = n0 + f.col0(j);
#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
      const float* c = acc[i][j];
      if (vec) {
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        const int m = m0 + f.row0(i) + (odd ? 8 : 0);
        const int nc = odd ? n - 2 : n;
        if (m < M && nc < N) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(bias + nc));
          float4 v = odd ? make_float4(r0, r1, c[2], c[3])
                         : make_float4(c[0], c[1], r0, r1);
          v.x += b.x;
          v.y += b.y;
          v.z += b.z;
          v.w += b.w;
          store4(out + (long long)m * N + nc, v);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + f.row0(i) + 8 * (q / 2);
          const int nq = n + q % 2;
          if (m < M && nq < N)
            store1(out + (long long)m * N + nq, c[q] + __ldg(bias + nq));
        }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------------ 3x3
// The operands of the implicit GEMM: x (M rows of C), the per-channel
// fp32 affine (a, b), the OHWI weight w (N rows of 9*C), the image
// geometry; vec when C is a multiple of a 16-byte copy and x and w are
// 16-byte aligned.
template <class E>
struct Conv {
  const E* x;
  const float* a;
  const float* b;
  const E* w;
  int M, C, N, H, W;
  bool vec;
  __device__ int csteps() const { return (C + Geo<E>::BK - 1) / Geo<E>::BK; }
  __device__ int steps() const { return 9 * csteps(); }
};

// The operands of a 3x3 kernel from the C interface's pointers (n images
// of h x w, c input and cout output channels)
template <class E>
Conv<E> conv_operands(const void* x, const void* a, const void* b,
                      const void* w, int n, int h, int w_, int c, int cout) {
  return Conv<E>{static_cast<const E*>(x), static_cast<const float*>(a),
                 static_cast<const float*>(b), static_cast<const E*>(w),
                 n * h * w_, c, cout, h, w_,
                 c % Geo<E>::VEC == 0 && aligned16(x) && aligned16(w)};
}

// One CTA's walk over the 3x3 implicit GEMM of its BM rows from m0:
// load(ks, n0, slot) copies k-step ks (tap ks / csteps, channels
// (ks % csteps) * BK ...) of A and of the BN weight rows from n0;
// compute(ks, slot, acc) accumulates it, applying the affine, the ReLU
// and the tap mask to A as its fragments load.
template <class T>
struct Conv3x3 {
  using E = typename T::E;
  const Conv<E>& p;
  const int m0;
  Frag<T> f;
  // image coordinates of this thread's fragment rows (rows past M get a
  // row outside every image, so every tap masks them) and of the rows
  // it copies on the 16-byte path: rows tid / 8 + i * THREADS / 8, VEC
  // channels at VEC * (tid % 8)
  static constexpr int LA = T::BM * (T::BK / T::VEC) / T::THREADS;
  static_assert(T::BK / T::VEC == 8, "a row step is 8 copies");
  static_assert(T::BM * 8 % T::THREADS == 0,
                "A rows are not whole copies a thread");
  int fh[T::MI][2], fw[T::MI][2];
  int lh[LA], lw[LA];

  __device__ void pixel(int m, int& h, int& w) const {
    const int q = m % (p.H * p.W);
    h = m < p.M ? q / p.W : -4;
    w = q % p.W;
  }

  __device__ Conv3x3(const Conv<E>& p_, int m0_) : p(p_), m0(m0_) {
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pixel(m0 + f.row0(i) + 8 * h, fh[i][h], fw[i][h]);
#pragma unroll
    for (int i = 0; i < LA; ++i)
      pixel(m0 + threadIdx.x / 8 + i * (T::THREADS / 8), lh[i], lw[i]);
  }

  __device__ void load(int ks, int n0, E* slot) const {
    const int cs = p.csteps();
    const int tap = ks / cs, c0 = (ks - tap * cs) * T::BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int C = p.C, H = p.H, W = p.W;
    const E* x = p.x;
    if (p.vec) {
      const int kl = (threadIdx.x % 8) * T::VEC;
      const bool kok = c0 + kl < C;
      const long long shift = (long long)(dy * W + dx) * C + c0 + kl;
#pragma unroll
      for (int i = 0; i < LA; ++i) {
        const int r = threadIdx.x / 8 + i * (T::THREADS / 8);
        const bool ok = kok && (unsigned)(lh[i] + dy) < (unsigned)H &&
                        (unsigned)(lw[i] + dx) < (unsigned)W;
        cp16(slot + T::A_OFF + r * T::LDS + kl,
             ok ? x + (long long)(m0 + r) * C + shift : x, ok);
      }
    } else {
      copy_rows<T::BM, T::THREADS>(
          slot + T::A_OFF,
          [&](int r) { return x + (long long)(m0 + r + dy * W + dx) * C; },
          [&](int r) {
            int h, w;
            pixel(m0 + r, h, w);
            return (unsigned)(h + dy) < (unsigned)H &&
                   (unsigned)(w + dx) < (unsigned)W;
          },
          c0, C, false, x);
    }
    const long long ldw = 9LL * C;
    const E* w = p.w + (long long)tap * C;
    copy_rows<T::BN, T::THREADS>(
        slot + T::B_OFF, [&](int r) { return w + (n0 + r) * ldw; },
        [&](int r) { return n0 + r < p.N; }, c0, C, p.vec, p.w);
    // the step's affine: a in the first BK floats past the rows, b in
    // the next BK
    const int tid = threadIdx.x;
    if (tid < 2 * T::BK) {
      const int c = c0 + tid % T::BK;
      const float* v = tid < T::BK ? p.a : p.b;
      cp4(reinterpret_cast<float*>(slot + T::AB_OFF) + tid,
          c < C ? v + c : p.a, c < C);
    }
  }

  __device__ void compute(int ks, const E* slot, Acc<T>& acc) const {
    const int tap = ks / p.csteps();
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bool in[T::MI][2];
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        in[i][h] = (unsigned)(fh[i][h] + dy) < (unsigned)p.H &&
                   (unsigned)(fw[i][h] + dx) < (unsigned)p.W;
    const E* as = slot + T::A_OFF;
    const float* aff = reinterpret_cast<const float*>(slot + T::AB_OFF);
    // the affine of this lane's channels of each k-step: word t, then
    // word t + 4, EPW channels each
    constexpr int KS = T::BK / T::KK, EPW = T::EPW;
    float ca[KS][2][EPW], cb[KS][2][EPW];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < EPW; ++e) {
          const int c = kk * T::KK + (f.t + 4 * h) * EPW + e;
          ca[kk][h][e] = aff[c];
          cb[kk][h][e] = aff[T::BK + c];
        }
    const Frag<T>& fr = f;
    auto a_frag = [&](int i, int kk, uint32_t (&ab)[4], uint32_t (&asm_)[4]) {
      uint32_t r[4];
      ldsm4(r, as + fr.a_row(i) * T::LDS + kk * T::KK + fr.a_col());
      // r: rows g, g+8, g, g+8; words t, t, t+4, t+4
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* a = ca[kk][q / 2];
        const float* b = cb[kk][q / 2];
        if constexpr (T::TF32) {
          const float y = fmaxf(fmaf(__uint_as_float(r[q]), a[0], b[0]), 0.f);
          split(in[i][q % 2] ? y : 0.f, ab[q], asm_[q]);
        } else {
          const uint32_t y = pack_bf16(act(bf16_lo(r[q]), a[0], b[0]),
                                       act(bf16_hi(r[q]), a[1], b[1]));
          ab[q] = in[i][q % 2] ? y : 0u;
        }
      }
    };
    mma_slot<T>(slot + T::B_OFF, f, a_frag, acc);
  }
};

// One CTA per BM x BN tile of c, the N tiles of a row tile next to each
// other in launch order (they read the same rows of x, through L2).  The
// tile's GEMM runs through the ring, then epi(p, f, acc, m0, n0, smem)
// gets the tile with the whole ring free for its own use (as floats).
template <class T, class Epilogue>
__global__ void __launch_bounds__(T::THREADS)
conv3x3_kernel(Conv<typename T::E> p, Epilogue epi, int n_tiles) {
  using E = typename T::E;
  extern __shared__ __align__(16) float smem[];
  E* ring = reinterpret_cast<E*>(smem);
  const int m0 = (blockIdx.x / n_tiles) * T::BM;
  const int n0 = (blockIdx.x % n_tiles) * T::BN;
  const Conv3x3<T> conv(p, m0);
  Acc<T> acc;
  zero<T>(acc);
  pipeline(
      p.steps(),
      [&](int s, int slot) { conv.load(s, n0, ring + slot * T::SLOT); },
      [&](int s, int slot) {
        conv.compute(s, ring + slot * T::SLOT, acc);
      });
  epi.template operator()<T>(p, conv.f, acc, m0, n0, smem);
}

// The CTAs of conv3x3_kernel with tile T
template <class T>
long long ctas(const Conv<typename T::E>& p) {
  return (long long)((p.M + T::BM - 1) / T::BM) * ((p.N + T::BN - 1) / T::BN);
}

// The current device's SM count in *sms; the CUDA error code
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Launch conv3x3_kernel with tile T on the stream; the CUDA error code
template <class T, class Epilogue>
int launch_conv3x3(const Conv<typename T::E>& p, const Epilogue& epi,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T, Epilogue>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::RING_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long m_tiles = (p.M + T::BM - 1) / T::BM;
  const int n_tiles = (p.N + T::BN - 1) / T::BN;
  conv3x3_kernel<T, Epilogue>
      <<<(unsigned)(m_tiles * n_tiles), T::THREADS, T::RING_BYTES, stream>>>(
          p, epi, n_tiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ 1x1
// The operands of the 1x1 GEMM, c[m, n] = sum_k relu(x[m, k] * a[k] +
// b[k]) * w[n, k]: x (M rows of K), the per-channel fp32 affine (a, b), w
// (N rows of K); vec when K is a multiple of a 16-byte copy and x and w
// are 16-byte aligned.
template <class E>
struct Gemm1x1 {
  const E* x;
  const float* a;
  const float* b;
  const E* w;
  int M, K, N;
  bool vec;
  __host__ __device__ int steps() const {
    return (K + Geo<E>::BK - 1) / Geo<E>::BK;
  }
};

// Shared memory of a 1x1 CTA, in elements of E.  With A resident: the
// CTA's BM rows of y = relu(x * a + b), all K channels (rows of lda = K
// rounded up to BK, plus 16 bytes: 4 mod 32 banks, as LDS), for fp32 as
// TF32 big then small halves, then the ring; else A goes through the
// ring with B.  A ring slot holds one step's raw rows (A's unless
// resident, then B's); for fp32 the step's split pass turns them into
// the big halves in place and the small halves go to one of two
// buffers, by the step's parity.
template <class T>
struct Plan1x1 {
  static constexpr int HALVES = T::TF32 ? 2 : 1;
  bool resident;
  int lda;      // A row stride
  int a_res;    // resident A (all its halves); 0 when streamed
  int slot;     // raw rows of one step
  int small;    // small halves of one step (fp32 only)
  __host__ __device__ Plan1x1(int K, bool res) : resident(res) {
    lda = res ? (K + T::BK - 1) / T::BK * T::BK + T::PAD : T::LDS;
    a_res = res ? HALVES * T::BM * lda : 0;
    slot = (res ? 0 : T::BM * T::LDS) + T::BN * T::LDS;
    small = T::TF32 ? slot : 0;
  }
  __host__ __device__ int b_off() const {
    return resident ? 0 : T::BM * T::LDS;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)(a_res + STAGES * slot + 2 * small) *
           sizeof(typename T::E);
  }
};

// The ring with the operand pass one step ahead of the products.  At step
// s the CTA computes on step s (prepared during step s - 1) while it
// prepares step s + 1, which has landed, and copies step s + STAGES - 1
// into the slot that step s - 1 freed: one barrier a step.  prep(s,
// slot) and compute(s, slot) as load; starts and ends as pipeline.
template <class Load, class Prep, class Compute>
__device__ __forceinline__ void pipeline_prep(int steps, const Load& load,
                                              const Prep& prep,
                                              const Compute& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    commit();
  }
  wait_groups<STAGES - 2>();     // step 0 has landed
  __syncthreads();
  if (steps > 0) prep(0, 0);
  for (int s = 0; s < steps; ++s) {
    wait_groups<STAGES - 3>();   // step s + 1 has landed
    __syncthreads();             // step s split; slot (s-1) free
    const int next = s + STAGES - 1;
    if (next < steps) load(next, next % STAGES);
    commit();
    if (s + 1 < steps) prep(s + 1, (s + 1) % STAGES);
    compute(s, s % STAGES);
  }
  wait_groups<0>();
  __syncthreads();
}
static_assert(STAGES >= 3, "pipeline_prep splits one step ahead");

// One CTA's walk over the 1x1 GEMM of its BM rows from m0 and the N
// columns of its chunks (BN wide).  Step s is k-step s % ks of chunk s /
// ks; A is copied and prepared in the first chunk's steps when
// resident, in every step otherwise.  The operand pass applies the
// affine and the ReLU to A once per element for the CTA (and for fp32
// splits A and B), so a warp's fragment loads are plain ldmatrix of
// ready operands.
template <class T>
struct Walk1x1 {
  using E = typename T::E;
  const Gemm1x1<E>& p;
  const Plan1x1<T> L;
  E* const smem;
  const int m0, ks;
  Frag<T> f;

  __device__ Walk1x1(const Gemm1x1<E>& p_, bool resident, E* smem_,
                     int m0_)
      : p(p_), L(p_.K, resident), smem(smem_), m0(m0_), ks(p_.steps()) {}

  __device__ bool with_a(int s) const { return !L.resident || s < ks; }
  __device__ E* raw(int slot) const { return smem + L.a_res + slot * L.slot; }
  __device__ E* sml(int s) const {
    return smem + L.a_res + STAGES * L.slot + (s & 1) * L.small;
  }
  // A's (big) and small halves at step s (ring slot), rows L.lda apart
  __device__ E* a_big(int s, int slot) const {
    return L.resident ? smem + (s % ks) * T::BK : raw(slot);
  }
  __device__ E* a_sml(int s) const {
    return L.resident ? smem + T::BM * L.lda + (s % ks) * T::BK : sml(s);
  }

  __device__ void load(int s, int n0, int slot) const {
    const int k0 = (s % ks) * T::BK, K = p.K;
    if (with_a(s)) {
      const E* x = p.x;
      const int m0_ = m0, M = p.M;
      copy_rows<T::BM, T::THREADS>(
          a_big(s, slot),
          [&](int r) { return x + (long long)(m0_ + r) * K; },
          [&](int r) { return m0_ + r < M; }, k0, K, p.vec, x, L.lda);
    }
    const E* w = p.w;
    const int N = p.N;
    copy_rows<T::BN, T::THREADS>(
        raw(slot) + L.b_off(),
        [&](int r) { return w + (long long)(n0 + r) * K; },
        [&](int r) { return n0 + r < N; }, k0, K, p.vec, w);
  }

  // the operand pass: thread tid takes channels VEC * (tid % 8) ... of
  // rows tid / 8, + THREADS / 8, ... (16 bytes a row)
  __device__ void prep(int s, int slot) const {
    static_assert(T::THREADS % 8 == 0, "rows of 8 16-byte chunks");
    constexpr int V = T::VEC;
    const int cv = (threadIdx.x % 8) * V;
    const int r0 = threadIdx.x / 8;
    constexpr int RS = T::THREADS / 8;
    if (with_a(s)) {
      const int k = (s % ks) * T::BK + cv;
      float ca[V], cb[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool ok = k + e < p.K;   // past K: y = relu(0) = 0
        ca[e] = ok ? __ldg(p.a + k + e) : 0.f;
        cb[e] = ok ? __ldg(p.b + k + e) : 0.f;
      }
      E* big = a_big(s, slot);
#pragma unroll 4
      for (int r = r0; r < T::BM; r += RS) {
        E* at = big + r * L.lda + cv;
        if constexpr (T::TF32) {
          const float4 v = *reinterpret_cast<const float4*>(at);
          split4(make_float4(fmaxf(fmaf(v.x, ca[0], cb[0]), 0.f),
                             fmaxf(fmaf(v.y, ca[1], cb[1]), 0.f),
                             fmaxf(fmaf(v.z, ca[2], cb[2]), 0.f),
                             fmaxf(fmaf(v.w, ca[3], cb[3]), 0.f)),
                 at, a_sml(s) + r * L.lda + cv);
        } else {
          uint4 v = *reinterpret_cast<const uint4*>(at);
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = pack_bf16(act(bf16_lo(w[q]), ca[2 * q], cb[2 * q]),
                             act(bf16_hi(w[q]), ca[2 * q + 1], cb[2 * q + 1]));
          *reinterpret_cast<uint4*>(at) = v;
        }
      }
    }
    if constexpr (T::TF32) {
      float* big = raw(slot) + L.b_off();
      float* small = sml(s) + L.b_off();
#pragma unroll 4
      for (int r = r0; r < T::BN; r += RS) {
        float* at = big + r * T::LDS + cv;
        split4(*reinterpret_cast<const float4*>(at), at,
               small + r * T::LDS + cv);
      }
    }
  }

  __device__ void compute(int s, int slot, Acc<T>& acc) const {
    mma_ready<T>(a_big(s, slot), a_sml(s), L.lda, raw(slot) + L.b_off(),
                 sml(s) + L.b_off(), f, acc);
  }
};

// One CTA per BM-row tile and group of `cpc` BN-wide chunks of N, the
// groups of a row tile next to each other in launch order.  Each
// chunk's tile goes to epi(p, f, acc, m0, n0) as it completes (the
// epilogue reads no shared memory: the ring is in use).
template <class T, class Epilogue>
__global__ void __launch_bounds__(T::THREADS)
gemm1x1_kernel(Gemm1x1<typename T::E> p, Epilogue epi, bool resident,
               int groups, int cpc) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = (blockIdx.x / groups) * T::BM;
  const int c0 = (blockIdx.x % groups) * cpc;
  const int chunks = min(cpc, (p.N + T::BN - 1) / T::BN - c0);
  const Walk1x1<T> walk(p, resident, reinterpret_cast<typename T::E*>(smem),
                        m0);
  const int ks = walk.ks;
  Acc<T> acc;
  zero<T>(acc);
  pipeline_prep(
      chunks * ks,
      [&](int s, int slot) { walk.load(s, (c0 + s / ks) * T::BN, slot); },
      [&](int s, int slot) { walk.prep(s, slot); },
      [&](int s, int slot) {
        walk.compute(s, slot, acc);
        if (s % ks != ks - 1) return;
        epi.template operator()<T>(p, walk.f, acc, m0,
                                   (c0 + s / ks) * T::BN);
        zero<T>(acc);
      });
}

// How gemm1x1_kernel with tile T splits N: into the groups of chunks
// that minimise waves x chunks a CTA (the grid's time if a chunk's time
// is fixed), fewer groups on a tie; slots: the CTAs the card holds at
// once.  Sets *groups and *cpc (chunks a group).
template <class T>
void split_n(const Gemm1x1<typename T::E>& p, long long slots, int* groups,
             int* cpc) {
  const long long m_tiles = (p.M + T::BM - 1) / T::BM;
  const int chunks = (p.N + T::BN - 1) / T::BN;
  long long best = -1;
  for (int g = 1; g <= chunks; ++g) {
    const int c = (chunks + g - 1) / g;
    if ((chunks + c - 1) / c != g) continue;   // a group would be empty
    const long long cost = (m_tiles * g + slots - 1) / slots * c;
    if (best < 0 || cost < best) {
      best = cost;
      *groups = g;
      *cpc = c;
    }
  }
}

// Launch gemm1x1_kernel with tile T on the stream, A resident when it
// fits in the shared memory a CTA may have (and `resident`); the CUDA
// error code
template <class T, class Epilogue>
int launch_gemm1x1(const Gemm1x1<typename T::E>& p, const Epilogue& epi,
                   cudaStream_t stream, bool resident = true) {
  auto kernel = gemm1x1_kernel<T, Epilogue>;
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  resident = resident && Plan1x1<T>(p.K, true).bytes() <= (size_t)max_smem;
  const size_t smem = Plan1x1<T>(p.K, resident).bytes();
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        T::THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;   // does not fit
  int groups = 1, cpc = 1;
  split_n<T>(p, (long long)sms * per_sm, &groups, &cpc);
  const long long ctas = (p.M + T::BM - 1) / T::BM * (long long)groups;
  kernel<<<(unsigned)ctas, T::THREADS, smem, stream>>>(p, epi, resident,
                                                        groups, cpc);
  return (int)cudaGetLastError();
}

}  // namespace tc
