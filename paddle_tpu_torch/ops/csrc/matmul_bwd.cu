// Fused-epilogue GEMM backward for Hopper (sm_90a): dX, and dW + dbias.
//
// Replaces: paddle_tpu/ops/pallas/matmul.py:272 `_bwd_dx_kernel` (the
// dX pallas_call at :361) and :296 `_bwd_dw_kernel` (the dW + dbias
// pallas_call at :405), the custom VJP of `matmul_bias_act` (`_mba_core`
// :428).  With dZ = dY * act'(residual) (the residual is z for gelu, y
// for relu and tanh, none for none) and the port's w [N, K]:
//
//   dX [M, K] = dZ w           (`matmul_bwd_dx`, row-parallel)
//   dW [N, K] = dZ^T x         (`matmul_bwd_dw`, the transpose of the
//   dbias [N] = sum_M dZ        reference's X^T dZ; dbias optional)
//
// dZ is formed in f32 from the dY and residual tiles in shared memory and
// never written to device memory; on bf16 operands it is rounded to bf16
// for the tensor cores (one rounding the f32 reference lacks), while the
// dbias sum takes the f32 value.  dbias is summed by the CTAs of the
// first K tile alone, every M tile passing through the same CTA: no
// atomics, deterministic.
//
// What bounds it on this card: at the BERT FFN shape (M = 30720, K = 768,
// N = 3072, bf16) each product is 1.45e11 FLOP, 0.147 ms at 989 TFLOP/s,
// against ~0.43 GB of traffic (dY, z, w or x, and the output), 0.128 ms
// at 3.35 TB/s: compute-bound.  Design: gemm_common.cuh's kDx mode reads
// dZ K-major and w [N, K] along N with ldmatrix.trans; its kDw mode reads
// both dZ^T and x along M with ldmatrix.trans.  The dW grid is only
// N/128 x K/128 = 144 CTAs at that shape, each walking all of M (a split
// over M would fill the card better: later work).

#include "gemm_common.cuh"

using namespace ptt::gemm;

// dx from dY `g`, the residual `res` (null for act none) and w.
extern "C" int matmul_bwd_dx(const void* g, const void* res, const void* w,
                             void* dx, int M, int N, int K, int act,
                             int dtype, void* stream) {
  Args p{};
  p.a = g;
  p.res = res;
  p.b = w;
  p.c = dx;
  p.rows = M;
  p.cols = K;
  p.depth = N;
  p.lda = N;
  p.ldb = K;
  p.ldc = K;
  return launch<kDx>(p, act, dtype, static_cast<cudaStream_t>(stream));
}

// dw (and dbias of dtype `bias_dtype` when non-null) from x, dY `g` and
// the residual `res` (null for act none).
extern "C" int matmul_bwd_dw(const void* x, const void* g, const void* res,
                             void* dw, void* dbias, int M, int N, int K,
                             int act, int dtype, int bias_dtype,
                             void* stream) {
  Args p{};
  p.a = g;
  p.res = res;
  p.b = x;
  p.c = dw;
  p.dbias = dbias;
  p.rows = N;
  p.cols = K;
  p.depth = M;
  p.lda = N;
  p.ldb = K;
  p.ldc = K;
  p.bias_dtype = bias_dtype;
  return launch<kDw>(p, act, dtype, static_cast<cudaStream_t>(stream));
}
