// 1x1 convolution + the BatchNorm batch statistics for Hopper (sm_90a).
//
// Replaces: benchmarks/fused_conv_bn_relu_experiment.py:141
// `fused_stats_kernel` (launched by `pallas_mm_stats` at :170), which
// computes
//
//   y = x w                      (f32 accumulation, stored in x's dtype)
//   s1[c] = sum_r y[r][c],  s2[c] = sum_r y[r][c]^2   (of the f32 value)
//
// over a 1x1 convolution's channels-last rows: x [M = B*H*W, K = Cin],
// w [N = Cout, K] (the Conv2D weight [Cout, Cin, 1, 1] viewed as [N, K];
// the TPU kernel's w is [K, N]).  Its caller forms the batch mean and
// variance from s1 and s2.  This kernel returns them directly: y [M, N]
// in x's dtype, rounded once from the f32 accumulator, and the f32 mean
// and biased variance [N] of the unrounded accumulator.  It is the
// first half of the ResNet's train-mode 1x1, stride-1 ConvBNLayer; the
// normalisation, which needs every row's statistics, is a second pass
// (ops/nn_ops.py `batch_norm_train`).
//
// Two launches, in order on the caller's stream:
// 1. The forward GEMM with the kStats epilogue: each 128-row tile (64 in
//    f32) stores its y tile and writes its per-column (mean, M2), the
//    mean first and then the squares about it, to a partials buffer
//    [2][row tiles][N].  The TPU kernel carries s1 and s2 across the
//    sequential row-tile axis; CTAs here run in no order, so each tile
//    writes its own partial and nothing is carried.
// 2. `conv_bn_stats_reduce`: per column, Chan's merge of the (count,
//    mean, M2) partials, each thread over a fixed stride of row tiles and
//    then a fixed tree across the block's threads.  No float atomics: the
//    statistics are the same bits from run to run, and on any grid of
//    the first launch.  No sum of squares minus a squared mean: that form
//    cancels when |mean| >> std, and the reference op reduces about a
//    shift for that reason (paddle_tpu/fluid/ops/nn_ops.py:203-220).
//
// What bounds it on this card: in bf16, nine of the ResNet-50 train
// step's twelve shapes at B = 128 are bytes-bound; the two at M = 6272
// (K or N = 2048) and the one at K = 1024, N = 512 are operation-bound.
// A step's 33 launches are bounded at 1.203 ms (3.97 GB, 0.46 TFLOP),
// the experiment's own shape (M = 401408, K = 64, N = 256) at 0.077 ms.
// The partials add 8 bytes a (row tile, column), written once and read
// once: 6% of y's bytes in bf16 (128-row tiles), as much in f32 (64).
//
// Design.  bf16: gemm_tc.cuh's forward body (`fwd_tc`, kernel 5's) with
// the kStats epilogue: TMA loads from a producer warpgroup, wgmma in two
// consumer warpgroups, y staged in shared memory for TMA stores, then
// `tile_stats` on the f32 accumulator before anything is rounded (shuffle
// halvings within a warp, the eight warps' sums in shared memory), so y
// is written once and never read back.  One CTA an SM walks the 128 x BN
// tiles (BN from ops/conv_bn.py `conv_schedule`), so a tile's epilogue
// overlaps the next tile's loads.  f32: gemm_common.cuh's exact-FMA
// kernel (`simt::gemm_f32`) with the same statistics.

#include "gemm_tc.cuh"

using namespace ptt::gemm;

namespace {

constexpr int RX = 32, RY = 32;  // columns, row-tile strides of a block
constexpr int UNROLL = 4;        // partials loaded ahead of their merges

// (n, mu, m2) <- the merge with (nb, mub, m2b) (Chan et al.)
__device__ __forceinline__ void chan_merge(float& n, float& mu, float& m2,
                                           float nb, float mub, float m2b) {
  if (nb == 0.f) return;
  const float nt = n + nb;
  const float d = mub - mu;
  const float f = nb / nt;
  mu += d * f;
  m2 += m2b + d * d * n * f;
  n = nt;
}

__global__ void __launch_bounds__(RX * RY)
    conv_bn_stats_reduce(const float* part, int tiles, int tile_rows, int M,
                         int N, float* mean, float* var) {
  __shared__ float sn[RY][RX], smu[RY][RX], sm2[RY][RX];
  const int tx = threadIdx.x, ty = threadIdx.y, c = blockIdx.x * RX + tx;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  auto rows_of = [&](int t) {
    return static_cast<float>(min(tile_rows, M - t * tile_rows));
  };
  if (c < N) {  // tiles ty, ty + RY, ... in increasing order
    int t = ty;
    for (; t + (UNROLL - 1) * RY < tiles; t += UNROLL * RY) {
      float mb[UNROLL], m2b[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        mb[u] = part[static_cast<long long>(t + u * RY) * N + c];
        m2b[u] = part[(static_cast<long long>(tiles) + t + u * RY) * N + c];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        chan_merge(n, mu, m2, rows_of(t + u * RY), mb[u], m2b[u]);
    }
    for (; t < tiles; t += RY)
      chan_merge(n, mu, m2, rows_of(t), part[static_cast<long long>(t) * N + c],
                 part[(static_cast<long long>(tiles) + t) * N + c]);
  }
  sn[ty][tx] = n;
  smu[ty][tx] = mu;
  sm2[ty][tx] = m2;
  __syncthreads();
  for (int s = RY / 2; s > 0; s >>= 1) {
    if (ty < s) {
      chan_merge(n, mu, m2, sn[ty + s][tx], smu[ty + s][tx], sm2[ty + s][tx]);
      sn[ty][tx] = n;
      smu[ty][tx] = mu;
      sm2[ty][tx] = m2;
    }
    __syncthreads();
  }
  if (ty == 0 && c < N) {
    mean[c] = mu;
    var[c] = m2 / static_cast<float>(M);
  }
}

}  // namespace

// one name for every width, so a profile bills kernel 11 on its own
// (chip_smoke.py's KERNEL_CATEGORIES)
template <int TN>
__global__ void __launch_bounds__(wg::NT, 1)
    conv_bn_stats_tc(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap ty,
                     const __grid_constant__ CUtensorMap tz,
                     const wg::FwdArgs p) {
  wg::fwd_tc<kStats, TN>(ta, tb, ty, tz, p);
}

template <int TN>
static cudaError_t launch_tc(const void* x, const void* w, void* y,
                             const wg::FwdArgs& p, int ctas,
                             cudaStream_t s) {
  return wg::launch_conv<kStats, TN>(conv_bn_stats_tc<TN>, x, w, y, p, ctas,
                                     s);
}

// Rows of a tile of partials: a function of the dtype alone.
static int tile_rows_of(int dtype) {
  return dtype == ptt::kBF16 ? wg::BM : simt::BM;
}

// The row tiles of partials that conv_bn_stats_fwd needs for M rows of
// `dtype` (a ptt::DType); the wrapper sizes its partials buffer from this.
extern "C" int conv_bn_stats_part_tiles(int M, int dtype) {
  return (M + tile_rows_of(dtype) - 1) / tile_rows_of(dtype);
}

static cudaError_t launch_gemm(const void* x, const void* w, void* y,
                               float* part, int M, int N, int K, int dtype,
                               int bn, int ctas, cudaStream_t s) {
  if (dtype == ptt::kF32) {
    Args p{};
    p.a = x;
    p.b = w;
    p.c = y;
    p.stats = part;
    p.rows = M;
    p.cols = N;
    p.depth = K;
    p.lda = K;
    p.ldb = K;
    p.ldc = N;
    return launch_act<kStats>(p, s);
  }
  if (dtype != ptt::kBF16) return cudaErrorInvalidValue;
  wg::FwdArgs p{};
  p.rows = M;
  p.cols = N;
  p.depth = K;
  p.stats = part;
  switch (bn) {
    case 64: return launch_tc<64>(x, w, y, p, ctas, s);
    case 128: return launch_tc<128>(x, w, y, p, ctas, s);
    case 256: return launch_tc<256>(x, w, y, p, ctas, s);
  }
  return cudaErrorInvalidValue;
}

// y, mean and var from x and w; `part` holds `part_tiles` row tiles of
// partials [2][part_tiles][N], as conv_bn_stats_part_tiles gives them.
// bf16 on 128 x `bn` tiles walked by `ctas` CTAs (0: one a tile).
extern "C" int conv_bn_stats_fwd(const void* x, const void* w, void* y,
                                 float* part, int part_tiles, float* mean,
                                 float* var, int M, int N, int K, int dtype,
                                 int bn, int ctas, void* stream) {
  const int tiles = conv_bn_stats_part_tiles(M, dtype);
  if (part_tiles != tiles) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gemm(x, w, y, part, M, N, K, dtype, bn, ctas, s);
  if (err != cudaSuccess) return err;
  conv_bn_stats_reduce<<<(N + RX - 1) / RX, dim3(RX, RY), 0, s>>>(
      part, tiles, tile_rows_of(dtype), M, N, mean, var);
  return cudaGetLastError();
}
