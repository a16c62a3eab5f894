// Fused-epilogue GEMM backward for Hopper (sm_90a): dX, and dW + dbias.
//
// Replaces: paddle_tpu/ops/pallas/matmul.py:272 `_bwd_dx_kernel` (the
// dX pallas_call at :361) and :296 `_bwd_dw_kernel` (the dW + dbias
// pallas_call at :405), the custom VJP of `matmul_bias_act` (`_mba_core`
// :428).  With dZ = dY * act'(residual) (the residual is z for gelu, y
// for relu and tanh, none for none) and the port's w [N, K]:
//
//   dX [M, K] = dZ w           (`matmul_bwd_dx`)
//   dW [N, K] = dZ^T x         (`matmul_bwd_dw`, the transpose of the
//   dbias [N] = sum_M dZ        reference's X^T dZ; dbias optional)
//
// dZ is formed in f32 and never written to device memory; on bf16
// operands it is rounded to bf16 for the tensor cores (one rounding the
// f32 reference lacks), while the dbias sum takes the f32 value.  dbias
// is summed by the CTAs of the first K tile alone in a fixed order: no
// atomics, deterministic.
//
// What bounds it on this card: at the BERT FFN shape (M = 30720, K = 768,
// N = 3072, bf16) each product is 1.45e11 FLOP, 0.147 ms at 989 TFLOP/s,
// against ~0.43 GB of traffic (dY, z, w or x, and the output), 0.128 ms
// at 3.35 TB/s: compute-bound, on the tensor cores, with dZ's
// activation derivative on the CUDA cores beside them.
//
// Design.  bf16: gemm_tc.cuh's wgmma + TMA kernels, a producer warp and
// two consumer warpgroups, dZ formed in registers from the swizzled dY
// and residual tiles as the A operand; 128 x 256 outputs a CTA.  The
// dW grid may split M into chunks (`chunk` rows each, a multiple of 64,
// planned by the caller: ops/matmul.py `dw_split_plan`), whose f32
// partials, in a workspace the caller allocates, a second launch adds
// up in a fixed order.  f32: gemm_common.cuh's exact-FMA kernels
// (`simt::gemm_f32`), any shape, unsplit.

#include "gemm_tc.cuh"

using namespace ptt::gemm;
using ptt::hopper::encode_map_2d;

// dx from dY `g`, the residual `res` (null for act none) and w.
extern "C" int matmul_bwd_dx(const void* g, const void* res, const void* w,
                             void* dx, int M, int N, int K, int act, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) {
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
    return launch<kDx>(p, act, dtype, s);
  }
  if (dtype != ptt::kBF16 || (act != kNone) != (res != nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tg, tr, tb;
  if (!encode_map_2d(&tg, g, M, N, N, wg::BM) ||
      (res && !encode_map_2d(&tr, res, M, N, N, wg::BM)) ||
      !encode_map_2d(&tb, w, N, K, K, wg::BK))
    return cudaErrorInvalidValue;
  wg::BwdArgs p{};
  p.rows = M;
  p.cols = K;
  p.depth = N;
  p.chunk = N;
  p.out = dx;
  return wg::launch<kDx>(tg, res ? tr : tg, tb, p, act, 1, s);
}

// dw (and dbias of dtype `bias_dtype` when non-null) from x, dY `g` and
// the residual `res` (null for act none).  bf16: M cut into chunks of
// `chunk` rows (a multiple of 64); with more than one chunk, `ws` holds
// the f32 partials, [S][N][K] and then [S][N] for S = ceil(M / chunk).
// f32: `ws` and `chunk` unused.
extern "C" int matmul_bwd_dw(const void* x, const void* g, const void* res,
                             void* dw, void* dbias, void* ws, int M, int N,
                             int K, int chunk, int act, int dtype,
                             int bias_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) {
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
    return launch<kDw>(p, act, dtype, s);
  }
  if (dtype != ptt::kBF16 || (act != kNone) != (res != nullptr) ||
      chunk <= 0 || chunk % wg::BK)
    return cudaErrorInvalidValue;
  const int splits = (M + chunk - 1) / chunk;
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tg, tr, tb;
  if (!encode_map_2d(&tg, g, M, N, N, wg::BK) ||
      (res && !encode_map_2d(&tr, res, M, N, N, wg::BK)) ||
      !encode_map_2d(&tb, x, M, K, K, wg::BK))
    return cudaErrorInvalidValue;
  const long long elems = static_cast<long long>(N) * K;
  float* part = static_cast<float*>(ws);
  wg::BwdArgs p{};
  p.rows = N;
  p.cols = K;
  p.depth = M;
  p.chunk = chunk;
  p.split = splits > 1;
  p.out = splits > 1 ? ws : dw;
  p.dbias = dbias == nullptr ? nullptr
            : splits > 1     ? static_cast<void*>(part + splits * elems)
                             : dbias;
  p.bias_dtype = bias_dtype;
  cudaError_t err =
      wg::launch<kDw>(tg, res ? tr : tg, tb, p, act, splits, s);
  if (err != cudaSuccess || splits == 1) return err;
  const long long threads = elems / 4;  // >= N, as K >= 8
  wg::matmul_dw_merge<<<static_cast<unsigned>((threads + wg::MERGE_NT - 1) /
                                              wg::MERGE_NT),
                        wg::MERGE_NT, 0, s>>>(
      part, splits, elems, static_cast<__nv_bfloat16*>(dw),
      part + splits * elems, N, dbias, bias_dtype);
  return cudaGetLastError();
}
