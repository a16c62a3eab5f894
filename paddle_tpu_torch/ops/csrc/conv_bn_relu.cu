// 1x1 convolution + eval-mode BatchNorm + relu for Hopper (sm_90a).
//
// Replaces: benchmarks/fused_conv_bn_relu_experiment.py:32
// `fused_kernel` (launched by `pallas_fused` at :51), which computes
//
//   y = relu(x w * scale + shift)   (f32 accumulation, f32 affine)
//
// over a 1x1 convolution's channels-last rows: x [M = B*H*W, K = Cin],
// w [N = Cout, K] (the Conv2D weight [Cout, Cin, 1, 1] viewed as [N, K];
// the TPU kernel's w is [K, N]), per-channel f32 scale and shift (the
// folded eval BatchNorm, gamma / sqrt(var + eps) and beta - mean *
// scale), and y [M, N] in x's dtype, rounded once from the f32 value.
// It is what the ResNet's eval-mode 1x1 ConvBNLayer(act="relu") (every
// bottleneck block's conv0) computes.
//
// What bounds it on this card: in bf16, six of ResNet-50's eight conv0
// shapes at B = 128 are bytes-bound; the last two (K = 1024 and 2048, N
// = 512) are operation-bound, their products 0.027 and 0.013 ms at 989
// TFLOP/s against 0.023 and 0.010 ms of bytes at 3.35 TB/s.  A whole
// forward's 16 launches are bounded at 0.587 ms, 0.534 of it in the
// bytes-bound shapes.  The experiment's own shape (M = 401408, K = 64,
// N = 256, bf16) moves 257 MB, 0.077 ms.  In f32 (exact FMA, 67
// TFLOP/s) all but the first shape are operation-bound: 3.60 ms a
// forward.
//
// Design.  bf16: gemm_tc.cuh's forward body (`fwd_tc`, kernel 5's) with
// the kBnRelu epilogue: a producer warpgroup keeps x and w tiles in
// flight with TMA, two consumer warpgroups run wgmma on them and apply
// the affine and relu to the f32 accumulator, then stage y in shared
// memory for TMA stores; the [M, N] pre-activation never reaches device
// memory.  One CTA an SM walks the 128 x BN output tiles, so one tile's
// epilogue and stores overlap the next tile's loads.  f32: gemm_common.cuh's
// exact-FMA kernel (`simt::gemm_f32`), any shape.

#include "gemm_tc.cuh"

using namespace ptt::gemm;

// one name for every width, so a profile bills kernel 10 on its own
// (chip_smoke.py's KERNEL_CATEGORIES)
template <int TN>
__global__ void __launch_bounds__(wg::NT, 1)
    conv_bn_relu_tc(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap ty,
                    const __grid_constant__ CUtensorMap tz,
                    const wg::FwdArgs p) {
  wg::fwd_tc<kBnRelu, TN>(ta, tb, ty, tz, p);
}

template <int TN>
static cudaError_t launch_tc(const void* x, const void* w, void* y,
                             const wg::FwdArgs& p, int ctas,
                             cudaStream_t s) {
  return wg::launch_conv<kBnRelu, TN>(conv_bn_relu_tc<TN>, x, w, y, p, ctas,
                                      s);
}

// y from x, w and the f32 scale / shift; `dtype` a ptt::DType.  bf16 on
// 128 x `bn` tiles walked by `ctas` CTAs (0: one a tile).
extern "C" int conv_bn_relu_fwd(const void* x, const void* w,
                                const float* scale, const float* shift,
                                void* y, int M, int N, int K, int dtype,
                                int bn, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) {
    Args p{};
    p.a = x;
    p.b = w;
    p.c = y;
    p.scale = scale;
    p.shift = shift;
    p.rows = M;
    p.cols = N;
    p.depth = K;
    p.lda = K;
    p.ldb = K;
    p.ldc = N;
    return launch_act<kFwd, kBnRelu>(p, s);
  }
  if (dtype != ptt::kBF16) return cudaErrorInvalidValue;
  wg::FwdArgs p{};
  p.rows = M;
  p.cols = N;
  p.depth = K;
  p.scale = scale;
  p.shift = shift;
  switch (bn) {
    case 64: return launch_tc<64>(x, w, y, p, ctas, s);
    case 128: return launch_tc<128>(x, w, y, p, ctas, s);
    case 256: return launch_tc<256>(x, w, y, p, ctas, s);
  }
  return cudaErrorInvalidValue;
}
