// Fused-epilogue GEMM forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/matmul.py:200 `_fwd_kernel` (launched
// by `_fwd` at :252), the forward of `matmul_bias_act`, which BERT's FFN
// runs for fc1 + gelu under PADDLE_TPU_FUSED_FFN=1.  Computes
//
//   z = x w^T + bias   (f32 accumulation, f32 bias add)
//   y = act(z)         (none, relu, tanh, exact or tanh gelu)
//
// with x [M, K], w [N, K] (the port's nn.Linear layout) and y [M, N] in
// x's dtype, rounded once from the f32 value; when `z` is given (gelu in
// training: the backward's residual) z is written too, rounded to x's
// dtype.  The bias and activation run on the accumulator before the one
// writeback, so the [M, N] pre-activation never makes the round trip the
// unfused matmul -> add -> gelu chain gives it.
//
// What bounds it on this card: at the BERT FFN shape (M = 60 * 512 =
// 30720, K = 768, N = 3072, bf16) the product is 1.45e11 FLOP against
// ~0.43 GB of traffic (x, w, y and z), 0.147 ms at 989 TFLOP/s against
// 0.128 ms at 3.35 TB/s: compute-bound, on the tensor cores.  Design:
// gemm_common.cuh's kFwd mode; both operands are read K-major (x rows
// and w rows are contiguous along K), so ldmatrix loads them untransposed.
// f32 operands take the exact-FMA kernel.

#include "gemm_common.cuh"

using namespace ptt::gemm;

// y (and z when non-null) from x, w and the optional bias of dtype
// `bias_dtype`; `act` a ptt::gemm::Act code, `dtype` a ptt::DType.
extern "C" int matmul_bias_act_fwd(const void* x, const void* w,
                                   const void* bias, void* y, void* z, int M,
                                   int N, int K, int act, int dtype,
                                   int bias_dtype, void* stream) {
  Args p{};
  p.a = x;
  p.b = w;
  p.c = y;
  p.z = z;
  p.bias = bias;
  p.rows = M;
  p.cols = N;
  p.depth = K;
  p.lda = K;
  p.ldb = K;
  p.ldc = N;
  p.bias_dtype = bias_dtype;
  return launch<kFwd>(p, act, dtype, static_cast<cudaStream_t>(stream));
}
