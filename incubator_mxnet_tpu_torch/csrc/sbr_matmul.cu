// Fused [BN-apply -> ReLU -> 1x1 conv] for Hopper (sm_90a), fp32 on the
// CUDA cores.
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
// What bounds it on this card.  Per output element 2K flops against
// (K + Cout) * 4 bytes per row of input and output: at ResNet-50's
// shapes at batch 32 (M*K*Cout = 100352*64*256 ... 1568*512*2048,
// 3.29 GFLOP each) that is 30-200 flops per byte, far above the H100's
// fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by
// operations: ~0.049 ms each at the fp32 CUDA-core peak.
//
// What the design does about it.  The main loop (sbr_gemm.cuh) is a
// register-blocked SGEMM: 128 x 128 (or 128 x 64 / 64 x 64) output
// tiles, 8 x 8 accumulators a thread, operand tiles double-buffered in
// shared memory with the next tile's global loads in flight during the
// current tile's FMAs.  The affine and ReLU are applied to x as it is
// loaded, so relu(x*a + b) never reaches device memory, which is the
// point of the TPU kernel.  Dropped from the TPU version: the
// pixel-major (H, W, N) row reorder (an XLA-TPU layout bitcast; a 1x1
// conv does not depend on row order) and the VMEM row-tile search.
// Tensor cores (TF32 or bf16 wgmma), TMA and the residual add fused
// into the epilogue are later work.
//
// C interface (ctypes): mx_sbr_matmul returns the CUDA error code of
// the launch (0 on success).  It allocates nothing; the caller passes
// contiguous fp32 device pointers and the stream.

#include "sbr_gemm.cuh"

extern "C" int mx_sbr_matmul(const void* x, const void* a, const void* b,
                             const void* w, const void* bias, void* out,
                             int m, int k, int cout, void* stream) {
  const sbr::Conv p{static_cast<const float*>(x), static_cast<const float*>(a),
                    static_cast<const float*>(b), static_cast<const float*>(w),
                    m, k, cout};
  const sbr::StoreBias epi{static_cast<const float*>(bias),
                           static_cast<float*>(out)};
  return sbr::launch(p, epi, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
