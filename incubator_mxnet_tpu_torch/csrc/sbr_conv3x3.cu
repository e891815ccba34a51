// Fused [BN-apply -> ReLU -> 3x3 stride-1 pad-1 conv] for Hopper
// (sm_90a) on the tensor cores, in two forms: fp32 (fp32-accurate,
// 3xTF32) and bf16.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/fused_conv.py
// `_sbr_conv3x3_kernel` (launched by `pl.pallas_call` in
// `_pallas_sbr_conv3x3`).  It computes the same function: the 3x3
// convolution, stride 1, of y = relu(x * a + b) zero-padded by one
// pixel (the zero comes after the affine and the ReLU, as the TPU
// kernel pads its activated image), plus the conv bias; x is
// channels-last (N, H, W, C) storage, a/b the eval BatchNorm folded into
// per-channel fp32 scale and shift, and the weight is read in OHWI order
// (Cout, 3, 3, C): the storage of a channels-last OIHW tensor.
//
// What bounds it on this card.  18*C flops per output element against
// one read of x and one write of out: at ResNet-50's fused 3x3 shapes
// at batch 32 (56x56x64 -> 64 ... 7x7x512 -> 512, 7.40 GFLOP each) that
// is hundreds of flops per byte, so it is bound by operations: 0.0448 ms
// each at the 165 TFLOP/s of fp32-accurate (3xTF32) tensor-core work.
//
// What the design does about it.  An implicit GEMM on tc_gemm.cuh's 3x3
// main loop (3xTF32 mma.sync fed by a cp.async ring), one CTA per
// BM x BN tile of the output (tc::conv3x3_kernel): the GEMM rows are the
// flat output pixels of the whole batch, the reduction runs over (tap,
// input channel) in steps of 32 channels of one tap, raw rows of x are
// copied into the ring as they are, and the affine, the ReLU and the
// tap mask are applied as each warp loads its A fragments, so the
// activated image never reaches device memory.  Rows flattened over
// images, rather than a spatial tile of one image with its halo, keep
// every CTA full at 7x7 (a 128-pixel tile of one 7x7 image would idle
// 62% of its rows); the cost is that each input element is read and
// activated once per tap that touches it, through L2.  The epilogue adds
// the bias and stores the tile channels-last (tc::store_bias, float4
// stores where the row allows).  Dropped from the TPU version: the
// dy-merged `zsc` scratch (a 128-lane MXU packing trick) and the
// whole-image VMEM budget: any stride-1 pad-1 channels-last fp32 shape
// runs.
//
// Tile per shape (swept by tools/port_chain_sweep.py over nine tiles at
// the four shapes).  Warp tiles of 64 x 32 share each fragment among the
// most products; at b = 32 the grids are small, so the rule weighs that
// against idle SMs: mx_sbr_conv3x3 takes 128 x 64 (2 x 2 warps, 2 CTAs
// an SM) when Cout <= 64 or when it gives at least one full wave, else
// 64 x 64 (2 x 2 warps, 4 an SM).  ResNet-50 at b = 32:
//   56x56 (Cout  64): 128 x 64, 784 CTAs (0.18 ms; 64 x 64 0.20)
//   28x28 (Cout 128): 128 x 64, 392 CTAs (0.18; 64 x 64 0.20)
//   14x14 (Cout 256): 64 x 64,  392 CTAs (0.20; 128 x 64's 196 CTAs
//                     leave SMs idle, 0.23)
//   7x7   (Cout 512): 64 x 64,  200 CTAs (0.29; no tile was faster by
//                     more than 1%)
//
// The bf16 form (mx_sbr_conv3x3_bf16): x, w and out bf16, a, b and the
// bias fp32, the TPU kernel's arithmetic on bf16 data: the activation
// rounded to bf16 before the tap mask, bf16 products summed in fp32, acc
// + bias rounded to bf16 once.  The same tiles and rule on
// tc_gemm.cuh's bf16 path (64 channels a step, one m16n8k16 mma a
// fragment).  Bound at b = 32: 0.0077 ms by bytes at 56x56, 0.0075 by
// operations (989 TFLOP/s) at the other three; it takes 0.081, 0.081,
// 0.083, 0.122 ms (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// C interface (ctypes): mx_sbr_conv3x3 and mx_sbr_conv3x3_bf16 return the
// CUDA error code of the launch (0 on success).  They allocate nothing;
// the caller passes contiguous device pointers (x, w, out in the form's
// type, a, b, bias fp32) and the stream.

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
  __device__ void operator()(const tc::Conv<E>& p, const tc::Frag<T>& f,
                             const tc::Acc<T>& acc, int m0, int n0,
                             float*) const {
    tc::store_bias<T>(acc, f, m0, n0, p.M, p.N, bias, out, vec);
  }
};

template <class E>
StoreBias<E> epilogue(const void* bias, void* out, int cout) {
  return StoreBias<E>{static_cast<const float*>(bias), static_cast<E*>(out),
                      cout % 4 == 0 && tc::aligned16(bias) &&
                          tc::aligned16(out)};
}

// The tiles, chosen per shape by sbr_conv3x3 (see the note)
template <class E>
using Wide = tc::Tile<128, 64, 2, 2, E>;
template <class E>
using Small = tc::Tile<64, 64, 2, 2, E>;

template <class E>
int sbr_conv3x3(const void* x, const void* a, const void* b, const void* w,
                const void* bias, void* out, int n, int h, int w_, int c,
                int cout, void* stream) {
  const tc::Conv<E> p = tc::conv_operands<E>(x, a, b, w, n, h, w_, c, cout);
  if (p.M <= 0 || c <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  const StoreBias<E> epi = epilogue<E>(bias, out, cout);
  int sms = 0;
  if (int err = tc::sm_count(&sms)) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (cout <= 64 || tc::ctas<Wide<E>>(p) >= 2LL * sms)
    return tc::launch_conv3x3<Wide<E>>(p, epi, s);
  return tc::launch_conv3x3<Small<E>>(p, epi, s);
}

}  // namespace

extern "C" int mx_sbr_conv3x3(const void* x, const void* a, const void* b,
                              const void* w, const void* bias, void* out,
                              int n, int h, int w_, int c, int cout,
                              void* stream) {
  return sbr_conv3x3<float>(x, a, b, w, bias, out, n, h, w_, c, cout,
                            stream);
}

extern "C" int mx_sbr_conv3x3_bf16(const void* x, const void* a,
                                   const void* b, const void* w,
                                   const void* bias, void* out, int n, int h,
                                   int w_, int c, int cout, void* stream) {
  return sbr_conv3x3<tc::bf16>(x, a, b, w, bias, out, n, h, w_, c, cout,
                               stream);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
