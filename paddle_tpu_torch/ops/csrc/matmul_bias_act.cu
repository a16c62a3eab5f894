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
// 0.128 ms at 3.35 TB/s: compute-bound, on the tensor cores, with the
// activation on the CUDA cores and y and z's 0.38 GB of stores beside.
//
// Design.  bf16: gemm_tc.cuh's `fwd_tc`, wgmma m64n256k16 on x and w
// read K-major from a TMA ring by a producer warpgroup, two consumer
// warpgroups whose epilogue stages y and z in shared memory for TMA
// stores; `ctas` CTAs walk the 128 x 256 tiles (ops/matmul.py
// `fwd_schedule`: one an SM).  f32:
// gemm_common.cuh's exact-FMA kernel (`simt::gemm_f32`), any shape.

#include "gemm_tc.cuh"

using namespace ptt::gemm;
using ptt::hopper::encode_map_2d;

// y (and z when non-null) from x, w and the optional bias of dtype
// `bias_dtype`; `act` a ptt::gemm::Act code, `dtype` a ptt::DType; bf16
// on `ctas` CTAs (0: one a tile).
extern "C" int matmul_bias_act_fwd(const void* x, const void* w,
                                   const void* bias, void* y, void* z, int M,
                                   int N, int K, int act, int dtype,
                                   int bias_dtype, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) {
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
    return launch<kFwd>(p, act, s);
  }
  if (dtype != ptt::kBF16) return cudaErrorInvalidValue;
  CUtensorMap ta, tb, ty, tz;
  if (!encode_map_2d(&ta, x, M, K, K, wg::BM) ||
      !encode_map_2d(&tb, w, N, K, K, wg::BN) ||
      !encode_map_2d(&ty, y, M, N, N, 64) ||
      (z && !encode_map_2d(&tz, z, M, N, N, 64)))
    return cudaErrorInvalidValue;
  wg::FwdArgs p{};
  p.rows = M;
  p.cols = N;
  p.depth = K;
  p.bias = bias;
  p.bias_dtype = bias_dtype;
  p.emit_z = z != nullptr;
  return wg::launch_fwd(ta, tb, ty, z ? tz : ty, p, act, ctas, s);
}
