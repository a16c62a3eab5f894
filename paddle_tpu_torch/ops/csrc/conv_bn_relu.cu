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
// Design: gemm_common.cuh's kFwd mode with the kBnRelu epilogue, so the
// affine and relu run on the f32 accumulator before the one writeback
// and the [M, N] pre-activation never reaches device memory; x and w
// are both read K-major.  f32 operands take the exact-FMA kernel.  The
// 128-wide column tile leaves half of each CTA masked at N = 64 (the
// first stage's conv0); a narrow-N tile, wgmma and TMA are later work.

#include "gemm_common.cuh"

using namespace ptt::gemm;

// y from x, w and the f32 scale / shift; `dtype` a ptt::DType.
extern "C" int conv_bn_relu_fwd(const void* x, const void* w,
                                const float* scale, const float* shift,
                                void* y, int M, int N, int K, int dtype,
                                void* stream) {
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
  return launch_act<kFwd, kBnRelu>(p, dtype,
                                   static_cast<cudaStream_t>(stream));
}
