// Fused [BN-apply -> ReLU -> 1x1 conv] for Hopper (sm_90a) on the tensor
// cores, in two forms: fp32 (fp32-accurate, 3xTF32) and bf16.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/fused_conv.py
// `_sbr_matmul_kernel` (launched by `pl.pallas_call` in
// `_pallas_sbr_matmul`).  It computes the same function,
//   out[M, Cout] = relu(x[M, K] * a + b) @ W^T + c,
// a stride-1 1x1 convolution of channels-last storage (M = N*H*W rows
// of K channels) with the BatchNorm folded into the per-channel fp32
// (a, b) as its prologue and the conv bias c in its epilogue.  W is the
// OIHW weight (Cout, K, 1, 1) read as (Cout, K) rows.
//
// What bounds it on this card.  2K flops per output element against one
// read of x and one write of out.  At ResNet-50's fused 1x1 shapes at
// batch 32 (56x56x64 -> 256 ... 7x7x512 -> 2048, 3.29 GFLOP each) the
// first writes four times what it reads and is bound by bytes (0.0384
// ms at 3.35 TB/s); the other three are bound by operations, 0.0199 ms
// each at the 165 TFLOP/s of fp32-accurate (3xTF32) tensor-core work.
// The CUDA cores (67 TFLOP/s fp32) cannot get under 0.049 ms a shape.
//
// What the design does about it.  tc_gemm.cuh's 1x1 walker: 3xTF32
// mma.sync fed by a cp.async ring, but with the operands prepared once
// per CTA instead of once per warp.  Each k-step (32 channels) lands raw
// in the ring, and one shared-memory pass of the whole CTA applies the
// affine and the ReLU to A and splits A and B into their TF32 big and
// small halves (the pass runs one step ahead of the products, so there
// is still one barrier a step); every fragment load is then a plain
// ldmatrix.  When the BM x K tile of A fits in shared memory it stays
// there, split, and the CTA walks its share of N in BN-wide chunks
// with only W streaming: x is read and activated once per CTA, not once
// per N tile.  When the row tiles alone do not fill the card, N is split
// into groups of chunks across CTAs (tc::split_n: the fewest waves x
// chunks a CTA).  The epilogue adds the bias and stores each chunk
// channels-last (tc::store_bias, float4 stores where the row allows).
// Dropped from the TPU version: the pixel-major (H, W, N) row reorder (an
// XLA-TPU layout bitcast; a 1x1 conv does not depend on row order) and
// the VMEM row-tile search.
//
// Tile (swept by tools/port_chain_sweep.py --kernels matmul over ten
// tiles, A resident or streamed, at the four shapes): 128 x 128, 2 x 4
// warps of 64 x 32 (255 registers, one CTA an SM), the fastest at all
// four.  ResNet-50 at b = 32:
//   56x56 (K  64, N  256): A resident (162 KB), 784 CTAs x 2 chunks
//                          (0.117 ms; 128 x 64 0.117, 64 x 64 0.133)
//   28x28 (K 128, N  512): A resident (227 KB), 392 CTAs x 2 chunks
//                          (0.100; 64 x 64 0.117)
//   14x14 (K 256, N 1024): A streamed, 392 CTAs x 1 chunk (0.098; 64 x
//                          128 0.121, 64 x 64 with A streamed 0.128)
//   7x7   (K 512, N 2048): A streamed, 104 CTAs x 2 chunks (0.117; 64 x
//                          64 0.161)
// What holds it at 2.5-6x its bound (the sweep's diagnostic builds):
// without the copies, the split pass and the stores the products alone
// take 0.046-0.057 ms a shape; one CTA an SM runs those phases one after
// the other instead of beside the products.
//
// The bf16 form (mx_sbr_matmul_bf16): x, W and out bf16, a, b and c
// fp32, the TPU kernel's arithmetic on bf16 data: relu(x * a + b) in fp32
// rounded to bf16, bf16 products summed in fp32, acc + c rounded to bf16
// once.  The same walker and tile on tc_gemm.cuh's bf16 path: one
// m16n8k16 mma a fragment, and the operand pass only activates A in
// place (B is used as it lands).  At b = 32 half the bytes make the
// first three shapes bound by bytes (0.0192, 0.0096, 0.0050 ms at 3.35
// TB/s), the last by operations (0.0033 ms at 989 TFLOP/s); it takes
// 0.075, 0.052, 0.055, 0.042 ms (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// C interface (ctypes): mx_sbr_matmul and mx_sbr_matmul_bf16 return the
// CUDA error code of the launch (0 on success).  They allocate nothing;
// the caller passes contiguous device pointers (x, W, out in the form's
// type, a, b, c fp32) and the stream.

#include "tc_gemm.cuh"

namespace {

// Epilogue: out[m, n] = acc + bias[n], channels-last, in the operands'
// type (bf16: the fp32 sum rounded to nearest even)
template <class E>
struct StoreBias {
  const float* bias;
  E* out;
  bool vec;   // Cout % 4 == 0, out and bias 16-byte aligned

  template <class T>
  __device__ void operator()(const tc::Gemm1x1<E>& p, const tc::Frag<T>& f,
                             const tc::Acc<T>& acc, int m0, int n0) const {
    tc::store_bias<T>(acc, f, m0, n0, p.M, p.N, bias, out, vec);
  }
};

template <class E>
tc::Gemm1x1<E> operands(const void* x, const void* a, const void* b,
                        const void* w, int m, int k, int cout) {
  return tc::Gemm1x1<E>{static_cast<const E*>(x),
                        static_cast<const float*>(a),
                        static_cast<const float*>(b),
                        static_cast<const E*>(w), m, k, cout,
                        k % tc::Geo<E>::VEC == 0 && tc::aligned16(x) &&
                            tc::aligned16(w)};
}

template <class E>
StoreBias<E> epilogue(const void* bias, void* out, int cout) {
  return StoreBias<E>{static_cast<const float*>(bias), static_cast<E*>(out),
                      cout % 4 == 0 && tc::aligned16(bias) &&
                          tc::aligned16(out)};
}

// The tile (see the note)
template <class E>
using Wide = tc::Tile<128, 128, 2, 4, E>;

template <class E>
int sbr_matmul(const void* x, const void* a, const void* b, const void* w,
               const void* bias, void* out, int m, int k, int cout,
               void* stream) {
  if (m <= 0 || k <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  return tc::launch_gemm1x1<Wide<E>>(operands<E>(x, a, b, w, m, k, cout),
                                     epilogue<E>(bias, out, cout),
                                     static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int mx_sbr_matmul(const void* x, const void* a, const void* b,
                             const void* w, const void* bias, void* out,
                             int m, int k, int cout, void* stream) {
  return sbr_matmul<float>(x, a, b, w, bias, out, m, k, cout, stream);
}

extern "C" int mx_sbr_matmul_bf16(const void* x, const void* a,
                                  const void* b, const void* w,
                                  const void* bias, void* out, int m, int k,
                                  int cout, void* stream) {
  return sbr_matmul<tc::bf16>(x, a, b, w, bias, out, m, k, cout, stream);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
