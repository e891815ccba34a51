// Fused [BN-apply -> ReLU -> 3x3 stride-1 pad-1 conv] for Hopper
// (sm_90a), fp32 on the CUDA cores.
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
// is hundreds of flops per byte, so it is bound by operations: ~0.110 ms
// each at the fp32 CUDA-core peak of 67 TFLOP/s.
//
// What the design does about it.  An implicit GEMM on the shared main
// loop (sbr_gemm.cuh): the GEMM rows are the flat output pixels of the
// whole batch, the reduction runs over (tap, input channel), and each
// A tile is the activated input gathered at the tap's shift, with the
// affine and ReLU applied and the out-of-image taps set to 0 as it is
// loaded into shared memory, so the activated image never reaches
// device memory.  Rows flattened over images, rather than a spatial
// tile of one image with its halo, keep every CTA full at 7x7 (a
// 128-pixel tile of one 7x7 image would idle 62% of its threads); the
// cost is that each input element is read and activated once per tap
// that touches it, through L1/L2, which at 2*Cout flops per load stays
// far below the arithmetic.  Explicit row and column bounds replace the
// flat-shift form's column-wrap masks.  Dropped from the TPU version:
// the dy-merged `zsc` scratch (a 128-lane MXU packing trick) and the
// whole-image VMEM budget: any stride-1 pad-1 channels-last fp32 shape
// runs.  Tensor cores (TF32 or bf16 wgmma) and TMA are later work.
//
// C interface (ctypes): mx_sbr_conv3x3 returns the CUDA error code of
// the launch (0 on success).  It allocates nothing; the caller passes
// contiguous fp32 device pointers and the stream.

#include "sbr_gemm.cuh"

extern "C" int mx_sbr_conv3x3(const void* x, const void* a, const void* b,
                              const void* w, const void* bias, void* out,
                              int n, int h, int w_, int c, int cout,
                              void* stream) {
  const sbr::Conv p{static_cast<const float*>(x), static_cast<const float*>(a),
                    static_cast<const float*>(b), static_cast<const float*>(w),
                    n * h * w_, c, cout, h, w_};
  const sbr::StoreBias epi{static_cast<const float*>(bias),
                           static_cast<float*>(out)};
  return sbr::launch<9>(p, epi, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
